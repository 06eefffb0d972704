"""One run of one cell: set-up, the measured window, the check, the line.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``; everything of
it is found by name under ``bench/`` (``byname.py``):

* ``configs/<config>.json``: the deployment (matrix family, solver
  settings), read by ``inputs.Draws`` and ``make_solver``;
* ``families/<family>.py``: the configuration's matrix family;
* ``traffic/<traffic>.json``: the mix: ``loop``, ``n``, ``batch``,
  ``ranks``;
* ``loops/<loop>.py``: how the mix drives the program (``repro_torch``)
  through its public API, and what its check compares;
* ``workloads/<cell>.json``: the check's sample and its limits;
* ``metrics/<metric>.py``: one reader a metric, ``read(view)`` -> a number
  or None (the metric is then left out of the line).

A run warms up the cell's own shapes (``loop.warm_up``) and runs the
loop's window, which ends with the call or permanent in flight at
``--seconds``.  Then the peak memory is read, the program's state is
freed, and the reference (``reference/ryser.py``) judges a sample of what
the window returned (``loop.judge``, through ``check.py``).  A cell whose
mix has ``ranks`` > 1 runs the loop on every rank of a gloo world, one
rank a card.
"""

from __future__ import annotations

import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from . import byname, check, tracing, yardstick

__all__ = ["ROOT", "FORBIDDEN", "Cell", "View", "Window", "load_cell",
           "main", "make_solver", "run_cell", "forbidden_modules", "sync"]

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole: ``repro_torch`` is not ``repro``."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    spec: dict
    metrics: dict          # "end_to_end" / "per_layer" -> [metric entries]
    root: Path

    @property
    def ranks(self) -> int:
        return int(self.traffic.get("ranks", 1))


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    bench = _json(root / "BENCHMARK.json")
    hits = [w for w in bench["workloads"] if w["name"] == name]
    if not hits:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = hits[0]
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in moved
                                  else [])]
    return Cell(name=name,
                config=_json(root / "bench" / "configs" / f"{w['config']}.json"),
                traffic=_json(root / "bench" / "traffic"
                              / f"{w['traffic']}.json"),
                chips=int(w["chips"]),
                spec=_json(root / "bench" / "workloads" / f"{name}.json"),
                metrics={"end_to_end": e2e, "per_layer": per_layer},
                root=root)


# ---------------------------------------------------------------------------
# What a window leaves behind
# ---------------------------------------------------------------------------

@dataclass
class View:
    """What the readers see of a run."""
    chips: int
    setup_s: float
    window_s: float = 0.0
    completed: int = 0              # permanents completed in the window
    calls: list = field(default_factory=list)   # (plan_s, exec_s) a call
    waves: list = field(default_factory=list)   # a rank: [(host, kernel, save)]
    traces: list = field(default_factory=list)  # a rank: Tracer.reduce()
    peak: float | None = None       # data-sheet FP64 FLOP/s of one card
    traced_calls: int = 0           # the calls in the traced window
    traced_flops: float = 0.0       # yardstick FLOPs of the traced work


@dataclass
class Window:
    """What a loop's window returns."""
    per_call: int = 1         # permanents a call
    seconds: float = 0.0
    attempted: int = 0
    failed: int = 0
    calls: list = field(default_factory=list)    # (plan_s, exec_s)
    tokens: list = field(default_factory=list)   # a call: its Draws token
    values: list = field(default_factory=list)   # a call / a permanent
    states: list = field(default_factory=list)   # a permanent: (hi, lo, done)
    waves: list = field(default_factory=list)    # (host_s, kernel_s, save_s)
    paused: float = 0.0       # seconds the window stood while the trace stopped
    traced: int = 0           # calls / permanents completed in the trace
    rank_values: list | None = None     # over a mesh: each rank's values
    rank_states: list | None = None     # ... and JobStates


def make_solver(config: dict, device: str, ctx=None):
    from repro_torch import PermanentSolver, SolverConfig
    cfg = SolverConfig(**config["solver"],
                       device=None if device == "cuda" else device)
    return PermanentSolver(cfg, distributed_ctx=ctx)


def sync(device: str) -> None:
    if device.startswith("cuda"):
        import torch
        torch.cuda.synchronize()


def _power() -> str:
    """The card's name, power limit and SM clock, as nvidia-smi reads
    them ('' where it cannot)."""
    try:
        q = subprocess.run(
            ["nvidia-smi", "--query-gpu=index,name,power.limit,clocks.sm",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return ""
    return q.stdout.strip() if q.returncode == 0 else ""


def _counters(solver) -> dict:
    from repro_torch.kernels import build, ryser_cuda
    st = solver.stats()
    return {"dispatches": st["device_dispatches"],
            "cache": st["cache"],
            "downgrades": sorted(set(st["downgrades"])),
            "launches": {k: v for k, v in ryser_cuda.counters.items() if v},
            "library_loads": build.load_stats()}


def _free(device: str) -> None:
    gc.collect()
    if device.startswith("cuda"):
        import torch
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# One process (one card, or the CPU in tests)
# ---------------------------------------------------------------------------

def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str, t0: float) -> dict:
    """One run in this process; returns the result's parts."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    workdir = tempfile.mkdtemp(prefix="bench-")
    try:
        parts = [time.time() - t0]               # imports
        solver = make_solver(cell.config, device)
        on_card = device.startswith("cuda")
        if on_card:
            torch.cuda.reset_peak_memory_stats()
            parts.append(time.time() - t0)       # the card's context
            from repro_torch.kernels import build
            build.load_library()
        parts.append(time.time() - t0)           # the kernels' library
        loop = byname.loop(cell)
        loop.warm_up(cell, solver, seed, device, workdir)
        setup_s = time.time() - t0
        tracer = tracing.Tracer(trace and on_card)
        w = loop.window(cell, solver, seed, seconds, tracer, device, workdir)
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        loaded = forbidden_modules()
        counters = _counters(solver)
        traced = tracer.reduce()
        del solver, tracer
        _free(device)
        return {"window": w, "setup_s": setup_s, "peak": peak,
                "forbidden": loaded, "counters": counters,
                "traces": [traced], "waves": [w.waves],
                "setup_parts": "(imports, context, library, warm-up end: "
                + ", ".join(f"{p:.3f}" for p in parts + [setup_s]) + " s)"}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


# ---------------------------------------------------------------------------
# A world of ranks, one a card
# ---------------------------------------------------------------------------

def _rank_main(rank: int, world: int, root: str, name: str, seed: int,
               seconds: float, trace: bool, device: str, t0: float,
               workdir: str) -> dict:
    """One rank of a mesh run: the same loop as every other rank over a
    ("step",) mesh of the world; rank 0 closes the window.  After it,
    each rank computes the reference for its share of the sample."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import build
    from repro_torch.launch import mesh as M
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = load_cell(Path(root), name)
    mesh = M.make_mesh((world,), ("step",),
                       device=None if device == "cuda" else device)
    dev = str(mesh.device)
    on_card = mesh.device.type == "cuda"
    if on_card:
        # one rank builds the kernels of a fresh checkout, then all load
        if rank == 0:
            build.load_library()
        dist.barrier()
        build.load_library()
        torch.cuda.reset_peak_memory_stats()
    mydir = os.path.join(workdir, f"rank{rank}")
    os.makedirs(mydir, exist_ok=True)
    solver = make_solver(cell.config, "cuda" if on_card else device, mesh)
    loop = byname.loop(cell)
    loop.warm_up(cell, solver, seed, dev, mydir)
    dist.barrier()
    setup_s = time.time() - t0

    def decide(stop: bool, stop_trace: bool) -> tuple[bool, bool]:
        flags = [stop, stop_trace]
        dist.broadcast_object_list(flags, src=0)
        return bool(flags[0]), bool(flags[1])

    tracer = tracing.Tracer(trace and on_card)
    w = loop.window(cell, solver, seed, seconds, tracer, dev, mydir, decide)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    loaded = forbidden_modules()
    counters = _counters(solver)
    traced = tracer.reduce()
    del solver, tracer
    _free(dev)
    refs = loop.references(cell, w, seed, dev, share=(rank, world))
    return {"window": w, "setup_s": setup_s, "peak": peak,
            "forbidden": loaded, "counters": counters, "traced": traced,
            "refs": refs, "device_name": torch.cuda.get_device_name()
            if on_card else device}


def run_world(cell: Cell, seed: int, seconds: float, trace: bool,
              device: str, t0: float, rank_main=_rank_main) -> dict:
    """A run over ``cell.ranks`` spawned ranks, each ``rank_main``."""
    from repro_torch.launch.mesh import run_world as spawn
    workdir = tempfile.mkdtemp(prefix="bench-world-")
    try:
        outs = spawn(rank_main, cell.ranks, workdir,
                     args=(str(cell.root), cell.name, seed, seconds, trace,
                           device, t0, workdir),
                     timeout_s=1100.0)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    w = outs[0]["window"]
    w.rank_values = [o["window"].values for o in outs]
    w.rank_states = [o["window"].states for o in outs]
    refs = None
    if outs[0]["refs"] is not None:
        refs = {}
        for o in outs:
            refs.update(o["refs"])
    return {"window": w, "setup_s": outs[0]["setup_s"],
            "peak": max(o["peak"] for o in outs),
            "forbidden": sorted({m for o in outs for m in o["forbidden"]}),
            "counters": outs[0]["counters"],
            "traces": [o["traced"] for o in outs],
            "waves": [o["window"].waves for o in outs], "refs": refs,
            "device_name": outs[0]["device_name"]}


# ---------------------------------------------------------------------------
# The result line
# ---------------------------------------------------------------------------

def _breakdown(traces: list) -> dict | None:
    """Device seconds by operation and idle seconds by host event, summed
    over the ranks, the ten largest of each."""
    if not traces or any(t is None for t in traces):
        return None
    out = {}
    for key in ("device_ops", "idle_gaps"):
        acc: dict[str, float] = {}
        for t in traces:
            for name, s in t[key]:
                acc[name] = acc.get(name, 0.0) + s
        out[key] = [[k, v] for k, v in
                    sorted(acc.items(), key=lambda kv: -kv[1])[:10]]
    return out


def result_line(cell: Cell, run: dict, checks: list, trace: bool,
                device: str, device_name: str, power: str) -> dict:
    w: Window = run["window"]
    # the yardstick's FLOPs of one permanent
    flops = byname.family(cell).flops(int(cell.traffic["n"]))
    completed = len(w.values) * w.per_call
    view = View(chips=cell.chips,
                setup_s=run["setup_s"], window_s=w.seconds - w.paused,
                completed=completed, calls=list(w.calls),
                waves=run["waves"], traces=run["traces"],
                peak=yardstick.fp64_peak(device_name)
                if device.startswith("cuda") else None,
                traced_calls=w.traced,
                traced_flops=w.traced * w.per_call * flops)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell.metrics[kind]:
        value = byname.reader(cell.root, m["name"])(view)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = (w.failed == 0 and completed > 0
               and all(c["value"] <= c["limit"] for c in checks))
    line = {"correct": bool(correct), "attempted": w.attempted,
            "failed": w.failed, "metrics": metrics,
            "device": {"platform": "gpu" if device.startswith("cuda")
                       else "cpu",
                       "kind": device_name, "count": cell.chips,
                       "memory_peak_bytes": int(run["peak"]),
                       "power": power}}
    traces = run["traces"]
    if trace and traces and all(t is not None for t in traces):
        line["device"]["busy_s"] = float(np.mean(
            [t["busy_s"] for t in traces]))
        line["device"]["window_s"] = float(np.mean(
            [t["window_s"] for t in traces]))
        line["breakdown"] = _breakdown(traces)
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                      for c in checks}
    return line


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
        t0: float, device_name: str | None, rank_main=_rank_main
        ) -> tuple[dict, list]:
    """One run of ``cell`` on ``device``: (the result line, the modules
    of FORBIDDEN that were loaded).  A mesh cell's ranks run
    ``rank_main`` and name the card (None here: this process leaves the
    cards to them)."""
    if cell.ranks > 1:
        out = run_world(cell, seed, seconds, trace, device, t0, rank_main)
    else:
        out = run_cell(cell, seed, seconds, trace, device, t0)
    power = _power() if device.startswith("cuda") else ""
    if power:
        print(f"card: {power}", file=sys.stderr)
    w = out["window"]
    print(f"window: {w.seconds:.6f} s ({w.paused:.6f} s of it stopping the "
          f"trace after {w.traced} calls), {w.attempted} attempted, "
          f"{w.failed} failed, {len(w.values)} completed; set-up "
          f"{out['setup_s']:.6f} s {out.get('setup_parts', '')}",
          file=sys.stderr)
    if w.calls:
        q = np.percentile(np.array(w.calls) * 1e3, [5, 50, 95, 100], axis=0)
        print("call ms p5/p50/p95/max: plan "
              + "/".join(f"{v:.3f}" for v in q[:, 0]) + ", execute "
              + "/".join(f"{v:.3f}" for v in q[:, 1]) + "; the first call "
              + "/".join(f"{v * 1e3:.3f}" for v in w.calls[0]),
              file=sys.stderr)
    print(f"counters: {json.dumps(out['counters'], default=str)}",
          file=sys.stderr)
    t = time.perf_counter()
    checks = check.judge(cell, w, seed, device, out.get("refs"))
    print(f"check: {time.perf_counter() - t:.3f} s", file=sys.stderr)
    line = result_line(cell, out, checks, trace, device,
                       out.get("device_name") or device_name, power)
    forbidden = sorted(set(out["forbidden"]) | set(forbidden_modules()))
    for c in checks:
        print(f"{c['name']} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return line, forbidden


def main(argv: list[str], t0: float, root: Path = ROOT) -> int:
    import argparse
    p = argparse.ArgumentParser(prog="bench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        cell = load_cell(root, args.workload)
    except (KeyError, OSError) as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("bench: no CUDA card; this benchmark runs only on one",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"bench: {cell.name} needs {cell.chips} cards, this host has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 3
    # a mesh cell's ranks own the cards: this process opens none
    name = torch.cuda.get_device_name(0) if cell.ranks == 1 else None
    line, forbidden = run(cell, args.seed, args.seconds, bool(args.trace),
                          "cuda", t0, name)
    if forbidden:
        print(f"bench: modules that must not load were loaded: "
              f"{', '.join(forbidden)}", file=sys.stderr)
        return 4
    print(json.dumps(line))
    return 0
