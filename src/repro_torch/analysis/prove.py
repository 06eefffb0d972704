"""torchprove: the port's counterpart of the reference's permprove.  It
runs every entry of the port on seeded inputs at every precision, checks
the PT1xx contracts (``contracts.py``) on the aten ops each run executed,
and gates drift on committed VALUE goldens:

    python -m repro_torch.analysis.prove --check [--device cpu|cuda]
                                         [--entries GLOB] [--json]
    python -m repro_torch.analysis.prove --bless

The entries are the reference's 20 (``repro/analysis/ir.py``) with the
port's names: dense and sparse x ``torch`` and ``cuda`` x f64 and c128 x
scalar and batch, and the four campaign wave bodies
(``kernels/ops.py::campaign_slice_sums`` for ``cuda``,
``core/distributed.py::slice_sums`` for ``torch``), each at the five
precisions, at N = 6 and NUM_CHUNKS = 16, the batch entries at B = 5 and
B = 7.  On the CPU the ``cuda`` entries run the kernels' plain versions;
on ``--device cuda`` they run kernels #1-#8, and every ``cuda`` entry's
f32 twin (f32 or complex64 input, the ``_f32`` C entries) runs twice for
PT103's second-run check.

The goldens (``tests/torch_goldens/<entry>.json``) hold each precision's
values as ``float.hex`` (both planes for complex) from the plain versions
on the CPU, with the inputs' recipe and the torch version that blessed
them.  They are not keyed by platform or torch version: the plain
versions use only IEEE-rounded elementwise ops in a fixed order and the
kernels equal them bit for bit, so the values depend on neither, and a
golden from another torch version is still held.  A golden that drifts or
is missing is a finding.  ``--bless`` rewrites them, for an intended
change to the numerics only (say so in ``CHANGES.md``).

PT104, the counterpart of the reference's collective audit PLI104, runs
the nine mesh entries (``MESH_ENTRIES``: ``core/distributed.py``'s
``permanent_on_mesh``, ``slice_sums_on_mesh``, ``run_campaign`` over a
mesh, ``batch_permanents_on_mesh`` and
``sparse_batch_permanents_on_mesh``, f64 and c128) at ``dq_acc`` on a
("step",) mesh of the current world (a world of one rank in this process
when none exists) under ``contracts.CollectiveRecorder``: only
``all_gather`` / ``broadcast_object_list`` / ``barrier``, one digest
gather and one partials gather a call (a wave for the campaign, plus one
broadcast of its state), and every value bit for bit the one-device
entry's (PT103).
"""

from __future__ import annotations

import argparse
import fnmatch
import json
import os
import sys
from dataclasses import dataclass

from . import contracts as K
from .rules import Finding

__all__ = ["ENTRIES", "Entry", "MESH_ENTRIES", "PRECISIONS", "GOLDEN_DIR",
           "run_check", "bless", "entry_values", "golden_path",
           "extent_invariance", "mesh_audit", "main"]

VERSION = "torchprove/1"
PRECISIONS = ("dd", "dq_fast", "dq_acc", "kahan", "qq")
N = 6
NUM_CHUNKS = 16
SPARSE_OFFSETS = (0, 1, 3, 7, 12, 18, 20)   # a column's rows, mod n
MAXDEG = 3                   # the sparse entries' column degree at N
CPS, CHUNK = 2, 4            # a wave: chunks per slice, steps per chunk
CANON_B, ALT_B = 5, 7        # two coprime batch extents
SEED = 20250226
MESH_FUNCTIONS = ("permanent_on_mesh", "slice_sums_on_mesh", "run_campaign",
                  "batch_permanents_on_mesh",
                  "sparse_batch_permanents_on_mesh")
MESH_ENTRIES = tuple(f"mesh_{fn}.{dt}" for fn in MESH_FUNCTIONS
                     for dt in ("f64", "c128")
                     if (fn, dt) != ("slice_sums_on_mesh", "c128"))

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))
GOLDEN_DIR = os.path.join(_REPO, "tests", "torch_goldens")
_ROUTE_IDS = {"dense": 0, "sparse": 1, "campaign": 2}


@dataclass(frozen=True)
class Entry:
    route: str     # dense | sparse | campaign
    engine: str    # torch | cuda
    dtype: str     # f64 | c128
    arity: str     # scalar | batch | wave

    @property
    def name(self) -> str:
        return f"{self.route}_{self.engine}.{self.dtype}.{self.arity}"

    @property
    def batched(self) -> bool:
        return self.arity == "batch"

    @property
    def cplx(self) -> bool:
        return self.dtype == "c128"


ENTRIES: tuple[Entry, ...] = tuple(
    Entry(route, engine, dtype, arity)
    for route in ("dense", "sparse") for engine in ("torch", "cuda")
    for dtype in ("f64", "c128") for arity in ("scalar", "batch")
) + tuple(Entry("campaign", engine, dtype, "wave")
          for engine in ("torch", "cuda") for dtype in ("f64", "c128"))


# ---------------------------------------------------------------------------
# Inputs and entry calls
# ---------------------------------------------------------------------------

def recipe(entry: Entry, n: int = N) -> str:
    rng = f"numpy default_rng([{SEED}, {n}, {_ROUTE_IDS[entry.route]}, " \
          f"{int(entry.cplx)}])"
    text = (f"{rng}: a stack of matrices uniform(-1, 1) (n x n each; "
            f"complex: re then im of each member); scalar and wave entries "
            f"take member 0, a batch of B its first B")
    if entry.route == "sparse":
        deg = sparse_degree(n)
        text += (f"; masked to the circulant band rows (j + o) mod n, "
                 f"o in {SPARSE_OFFSETS[:deg]} (column degree {deg})")
    if entry.route == "campaign":
        text += (f"; one wave of all {(1 << (n - 1)) // (CPS * CHUNK)} "
                 f"slices, {CPS} chunks of {CHUNK} steps each: the per-slice "
                 f"(hi, lo) sums, his then los")
    return text


def sparse_degree(n: int) -> int:
    return MAXDEG if n == N else 5


def inputs(entry: Entry, count: int, n: int = N, single: bool = False):
    """``count`` seeded matrices (count, n, n) for ``entry``."""
    import numpy as np
    rng = np.random.default_rng([SEED, n, _ROUTE_IDS[entry.route],
                                 int(entry.cplx)])
    mats = []
    for _ in range(count):
        A = rng.uniform(-1, 1, (n, n))
        if entry.cplx:
            A = A + 1j * rng.uniform(-1, 1, (n, n))
        mats.append(A)
    As = np.stack(mats)
    if entry.route == "sparse":
        mask = np.zeros((n, n), dtype=bool)
        for j in range(n):
            for o in SPARSE_OFFSETS[:sparse_degree(n)]:
                mask[(j + o) % n, j] = True
        As = As * mask
    if single:
        As = As.astype(np.complex64 if entry.cplx else np.float32)
    return As


def _call(entry: Entry, As, precision: str, device: str):
    """The entry's values for the stack ``As`` (member 0 for scalar and
    wave entries) as a 1-d complex128 or float64 numpy array."""
    import numpy as np
    import torch

    from ..core import distributed, ryser, sparyser
    from ..kernels import ops

    A = As[0]
    if entry.route == "dense" and entry.engine == "torch":
        out = ryser.perm_ryser_batched(As, NUM_CHUNKS, precision,
                                       device=device) if entry.batched \
            else ryser.perm_ryser_chunked(A, NUM_CHUNKS, precision,
                                          device=device)
    elif entry.route == "dense":
        out = ops.permanent_cuda_batched(As, precision=precision,
                                         device=device) if entry.batched \
            else ops.permanent_cuda(A, precision=precision, device=device)
    elif entry.route == "sparse" and entry.engine == "torch":
        stack = As if entry.batched else As[:1]
        out = sparyser.sparse_values(stack, *sparyser.padded_ccs(stack),
                                     NUM_CHUNKS, precision, device=device)
        out = out if entry.batched else out[0]
    elif entry.route == "sparse":
        if entry.batched:
            out = ops.sparse_batched_values_cuda(
                As, *sparyser.padded_ccs(As), precision=precision,
                device=device)
        else:
            out = ops.sparse_value_cuda(A, *sparyser.padded_ccs(A),
                                        precision=precision, device=device)
    else:
        slices = (1 << (A.shape[0] - 1)) // (CPS * CHUNK)
        if entry.engine == "cuda":
            hi, lo = ops.campaign_slice_sums(
                A, 0, slices, chunks_per_slice=CPS, chunk_size=CHUNK,
                precision=precision, backend="cuda", device=device)
            out = torch.cat([hi.reshape(-1), lo.reshape(-1)])
        else:
            his, los, _ = distributed.slice_sums(
                A, range(slices), chunks_per_slice=CPS, chunk_size=CHUNK,
                precision=precision, backend="torch", device=device)
            out = np.concatenate([his, los])
    if torch.is_tensor(out):
        out = out.detach().cpu().numpy()
    return np.atleast_1d(np.asarray(out))


def _hex(values) -> list:
    """float.hex of each value; a complex one as [re, im]."""
    import numpy as np
    if np.iscomplexobj(values):
        return [[float(v.real).hex(), float(v.imag).hex()] for v in values]
    return [float(v).hex() for v in values]


def _flat(hexes: list) -> list[str]:
    return [h if isinstance(h, str) else "+".join(h) for h in hexes]


def entry_values(entry: Entry, precision: str, B: int = ALT_B,
                 device: str = "cpu", n: int = N, single: bool = False):
    """The hex values of one entry at one precision (a batch entry's B
    members)."""
    count = B if entry.batched else 1
    return _hex(_call(entry, inputs(entry, count, n, single), precision,
                      device))


def _traced(entry: Entry, precision: str, B: int, device: str):
    """(hex values, op records) of one run under the recorder."""
    As = inputs(entry, B if entry.batched else 1)
    with K.OpRecorder() as rec:
        values = _call(entry, As, precision, device)
    return _hex(values), rec.records


def _entry_findings(entry: Entry, precision: str, device: str):
    """(findings, the B = ALT_B values) of one entry at one precision."""
    found: list[Finding] = []
    # an untraced first run: what a wrapper sets up once a process (a
    # schedule it caches on the card) is no op of the entry's program
    first = entry_values(entry, precision, ALT_B, device)
    vals, recs = _traced(entry, precision, ALT_B, device)
    found += K.pt102_dtype_flow(entry.name, precision, recs)
    found += K.pt103_bits(entry.name, precision, "a second run",
                          _flat(vals), _flat(first))
    if entry.batched:
        vals_a, recs_a = _traced(entry, precision, CANON_B, device)
        found += K.pt101_reductions(entry.name, precision, recs_a, recs,
                                    CANON_B, ALT_B)
        found += K.pt103_batch_invariance(entry.name, precision, recs_a,
                                          recs, CANON_B, ALT_B)
        found += K.pt103_bits(
            entry.name, precision,
            f"member i of the B={CANON_B} stack against B={ALT_B}",
            _flat(vals_a), _flat(vals[:CANON_B]))
    if entry.engine == "cuda" and entry.route != "campaign":
        # the f32 twin (the _f32 C entries on the card): the same bits
        # from a second run, and the same members at both extents
        one = entry_values(entry, precision, ALT_B, device, single=True)
        two = entry_values(entry, precision, ALT_B, device, single=True)
        found += K.pt103_bits(entry.name + ".f32", precision,
                              "a second run of the f32 twin", _flat(two),
                              _flat(one))
        if entry.batched:
            five = entry_values(entry, precision, CANON_B, device,
                                single=True)
            found += K.pt103_bits(
                entry.name + ".f32", precision,
                f"f32 twin, member i at B={CANON_B} against B={ALT_B}",
                _flat(five), _flat(one[:CANON_B]))
    return found, vals


# ---------------------------------------------------------------------------
# PT104: the mesh entries' collectives
# ---------------------------------------------------------------------------

def _mesh_run(name: str, mesh, device: str, work: str):
    """(mesh values, one-device values, collective budget) of one mesh
    entry on the prove inputs at ``dq_acc``."""
    import numpy as np

    from ..core import distributed as D
    from ..core import sparyser
    from ..core.stepspace import plan_slices
    from ..kernels import ops

    fn, dt = name[len("mesh_"):].split(".")
    cplx = dt == "c128"
    sparse = fn.startswith("sparse")
    As = inputs(Entry("sparse" if sparse else "dense", "cuda", dt, "batch"),
                ALT_B)
    A = As[0]
    prec = "dq_acc"
    once = {"all_gather": 2}
    if fn == "permanent_on_mesh":
        ts, cps, C = plan_slices(N, mesh.size, 1, 4)
        got = [D.permanent_on_mesh(A, mesh, precision=prec,
                                   lanes_per_device=4)]
        want = [D.run_campaign(A, total_slices=ts, chunks_per_slice=cps,
                               chunk_size=C, precision=prec,
                               device=device)[0]]
        return got, want, once
    slices = (1 << (N - 1)) // (CPS * CHUNK)
    if fn == "slice_sums_on_mesh":
        ids = [0, 1, -1] + list(range(3, slices))
        his, los = D.slice_sums_on_mesh(A, mesh, ids, chunks_per_slice=CPS,
                                        chunk_size=CHUNK, precision=prec)
        h, e, _ = D.slice_sums(A, [i for i in ids if i >= 0],
                               chunks_per_slice=CPS, chunk_size=CHUNK,
                               precision=prec, device=device)
        h, e = np.insert(h, 2, 0.0), np.insert(e, 2, 0.0)
        return list(his) + list(los), list(h) + list(e), once
    if fn == "run_campaign":
        waves = []
        spec = dict(total_slices=slices, chunks_per_slice=CPS,
                    chunk_size=CHUNK, precision=prec, wave_width=1)
        got, _ = D.run_campaign(
            A, mesh=mesh, checkpoint_path=os.path.join(work, f"{dt}.npz"),
            progress_cb=lambda _s, w: waves.append(w), **spec)
        want, _ = D.run_campaign(A, device=device, **spec)
        return [got], [want], {"all_gather": 1 + len(waves),
                               "broadcast_object_list": 1}
    if fn == "batch_permanents_on_mesh":
        got = D.batch_permanents_on_mesh(As, mesh, precision=prec)
        want = ops.permanent_cuda_batched(As, precision=prec, device=device)
        return list(got), list(want.cpu().numpy()), once
    got = D.sparse_batch_permanents_on_mesh(As, mesh, precision=prec)
    want = ops.sparse_batched_values_cuda(As, *sparyser.padded_ccs(As),
                                          precision=prec, device=device)
    return list(got), list(want.cpu().numpy()), once


def mesh_audit(names, device: str = "cpu") -> tuple[list[Finding], dict]:
    """PT104 (and the mesh values against the one-device entries, PT103)
    for the mesh entries ``names`` on a ("step",) mesh of the current
    world, or of a world of one rank made here: ``(findings, {entry:
    {"calls": {kind: count}, "budget": {...}}})``."""
    import tempfile

    import numpy as np

    from ..launch import mesh as mesh_lib
    findings: list[Finding] = []
    inventory: dict = {}
    if not names:
        return findings, inventory
    with mesh_lib.world(), tempfile.TemporaryDirectory() as work:
        mesh = mesh_lib.make_mesh((mesh_lib.world_size(),), ("step",),
                                  device=device)
        for name in names:
            with K.CollectiveRecorder() as rec:
                got, want, budget = _mesh_run(name, mesh, device, work)
            findings += K.pt104_collectives(name, rec.calls, budget)
            findings += K.pt103_bits(
                name, "dq_acc", "the mesh entry against the one-device one",
                _flat(_hex(np.asarray(got))), _flat(_hex(np.asarray(want))))
            calls: dict = {}
            for kind, _ in rec.calls:
                calls[kind] = calls.get(kind, 0) + 1
            inventory[name] = {"calls": calls, "budget": budget}
    return findings, inventory


# ---------------------------------------------------------------------------
# Goldens
# ---------------------------------------------------------------------------

def golden_path(entry: Entry, golden_dir: str | None = None) -> str:
    return os.path.join(golden_dir or GOLDEN_DIR, entry.name + ".json")


def _golden(entry: Entry, values: dict) -> dict:
    import torch
    return {"version": VERSION, "entry": entry.name,
            "torch": torch.__version__, "device": "cpu",
            "n": N, "num_chunks": NUM_CHUNKS,
            "batch": ALT_B if entry.batched else None,
            "inputs": recipe(entry), "values": values}


def _select(pattern: str | None) -> list[Entry]:
    if not pattern:
        return list(ENTRIES)
    return [e for e in ENTRIES if fnmatch.fnmatch(e.name, pattern)]


def _select_mesh(pattern: str | None) -> list[str]:
    return [m for m in MESH_ENTRIES
            if not pattern or fnmatch.fnmatch(m, pattern)]


def run_check(entries: str | None = None, golden_dir: str | None = None,
              device: str = "cpu", bless_mode: bool = False,
              log=None) -> dict:
    """Run, check the contracts, and gate (or bless) the goldens; the
    report dict."""
    gdir = golden_dir or GOLDEN_DIR
    selected = _select(entries)
    findings: list[Finding] = []
    drifted, missing, blessed = [], [], []
    for entry in selected:
        got = {}
        for prec in PRECISIONS:
            found, vals = _entry_findings(entry, prec, device)
            findings += found
            got[prec] = vals
        if log:
            log(f"  ran {entry.name} at {len(PRECISIONS)} precisions on "
                f"{device}")
        path = golden_path(entry, gdir)
        if bless_mode:
            os.makedirs(gdir, exist_ok=True)
            with open(path, "w", encoding="utf-8") as f:
                json.dump(_golden(entry, got), f, indent=1)
                f.write("\n")
            blessed.append(entry.name)
            continue
        if not os.path.exists(path):
            missing.append(entry.name)
            continue
        with open(path, encoding="utf-8") as f:
            want = json.load(f)["values"]
        for prec in PRECISIONS:
            if want.get(prec) != got[prec]:
                drifted.append({"entry": entry.name, "precision": prec,
                                "want": want.get(prec), "got": got[prec]})
    mesh_names = [] if bless_mode else _select_mesh(entries)
    mesh_found, pt104 = mesh_audit(mesh_names, device)
    findings += mesh_found
    if log and mesh_names:
        log(f"  ran {len(mesh_names)} mesh entries on {device} (PT104)")
    return {"version": VERSION, "device": device,
            "entries": [e.name for e in selected] + mesh_names,
            "findings": findings,
            "goldens": {"dir": gdir, "drifted": drifted, "missing": missing,
                        "blessed": blessed},
            "pt104": pt104}


def bless(entries: str | None = None, golden_dir: str | None = None,
          log=None) -> dict:
    """Rewrite the goldens from the plain versions on the CPU."""
    return run_check(entries, golden_dir, device="cpu", bless_mode=True,
                     log=log)


def extent_invariance(n: int, b_a: int, b_b: int, device: str = "cuda",
                      precision: str = "dq_acc") -> dict:
    """Member i of a b_a stack against member i of a b_b stack, for the
    four batch entries of the ``cuda`` engine at size n: {entry: number of
    members that differ}."""
    out = {}
    for entry in ENTRIES:
        if entry.engine != "cuda" or not entry.batched:
            continue
        big = entry_values(entry, precision, max(b_a, b_b), device, n)
        small = entry_values(entry, precision, min(b_a, b_b), device, n)
        out[entry.name] = sum(x != y for x, y in zip(_flat(small),
                                                     _flat(big)))
    return out


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def failed(report: dict) -> bool:
    g = report["goldens"]
    return bool(report["findings"] or g["drifted"] or g["missing"])


def render(report: dict) -> str:
    lines = [f.render() for f in report["findings"]]
    g = report["goldens"]
    for d in g["drifted"]:
        lines.append(f"GOLDEN DRIFT {d['entry']} precision={d['precision']}:"
                     f" want {d['want']}, got {d['got']}")
    lines += [f"GOLDEN MISSING {name}: no {name}.json in {g['dir']}; run "
              f"--bless and commit it" for name in g["missing"]]
    for name, inv in report["pt104"].items():
        calls = ", ".join(f"{k} x{v}" for k, v in sorted(inv["calls"].items()))
        lines.append(f"PT104 {name}: {calls} (budget {inv['budget']})")
    n_mesh = len(report["pt104"])
    lines.append(f"torchprove: {len(report['entries']) - n_mesh} entries x "
                 f"{len(PRECISIONS)} precisions and {n_mesh} mesh entries "
                 f"on {report['device']}, "
                 f"{len(report['findings'])} finding(s), "
                 f"{len(g['drifted']) + len(g['missing'])} golden "
                 f"problem(s)")
    return "\n".join(lines)


def report_json(report: dict) -> dict:
    return {**report, "findings": [f.to_json() for f in report["findings"]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.prove",
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--check", action="store_true",
                    help="run every entry, check the contracts and goldens")
    ap.add_argument("--bless", action="store_true",
                    help="rewrite the goldens from the CPU plain versions")
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    ap.add_argument("--entries", default=None, metavar="GLOB",
                    help="fnmatch filter over entry names, e.g. 'dense_*'")
    ap.add_argument("--goldens", default=None, metavar="DIR",
                    help=f"golden directory (default {GOLDEN_DIR})")
    ap.add_argument("--json", action="store_true",
                    help="the report as JSON on stdout")
    args = ap.parse_args(argv)
    if args.check == args.bless:
        ap.print_usage(sys.stderr)
        return 2
    if args.entries and not _select(args.entries) \
            and not _select_mesh(args.entries):
        print(f"no entries match {args.entries!r}", file=sys.stderr)
        return 2
    if args.bless and args.device != "cpu":
        print("goldens are blessed on the CPU only", file=sys.stderr)
        return 2
    log = None if args.json else print
    report = bless(args.entries, args.goldens, log=log) if args.bless \
        else run_check(args.entries, args.goldens, device=args.device,
                       log=log)
    if args.json:
        print(json.dumps(report_json(report), indent=1))
    elif args.bless:
        for name in report["goldens"]["blessed"]:
            print(f"blessed {name}")
    else:
        print(render(report))
    return 1 if failed(report) else 0


if __name__ == "__main__":
    raise SystemExit(main())
