"""Autotuner CLI: fill the on-disk kernel-geometry tuning table.

    PYTHONPATH=src python -m repro_torch.launch.tune \
        --routes dense,complex,sparse --n 22,24 --out table.json
    PYTHONPATH=src python -m repro_torch.launch.tune \
        --routes campaign --n 34 --out table.json
    PYTHONPATH=src python -m repro_torch.launch.tune --device cpu \
        --routes dense,sparse --n 6,7 --batch 2 --out table.json  # tests
    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 2 -m repro_torch.launch.tune --routes campaign \
        --n 34 --out table.json --ranks-per-device 2

One line prints per tuned key (winner geometry, default and winner
times, speedup over the default, modelled/measured ratio); the table
lands at ``--out`` in the versioned, kernel-hashed format of
``repro_torch.tune.table`` and is picked up by the planner through
``SolverConfig.tuning_table``.  ``--report`` also writes the
per-candidate rows (launch, occupancy, modelled and measured seconds) as
JSON.  The tuner measures on the card unless ``--device cpu`` asks for
the plain versions on the host; the ``campaign`` route measures one wave
of the campaign wave body on the one card.  Under ``torchrun`` every rank
runs the tuner over a ("step",) mesh of the world (the reference's mesh
over all devices): the ``campaign`` route measures one collective wave
over it, each key's winner is picked from the slowest rank's times, so
every rank holds the same table, and shard 0 prints and saves it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

__all__ = ["parse_ns", "tune_main"]


def parse_ns(spec: str) -> list[int]:
    """``"8..16"`` (inclusive range) or ``"8,10,12"`` (list) -> sizes."""
    spec = spec.strip()
    if ".." in spec:
        lo, hi = spec.split("..", 1)
        lo, hi = int(lo), int(hi)
        if lo > hi:
            raise ValueError(f"empty size range {spec!r}")
        return list(range(lo, hi + 1))
    return [int(tok) for tok in spec.split(",") if tok]


def tune_main(argv=None) -> int:
    from ..tune.search import ROUTES

    ap = argparse.ArgumentParser()
    ap.add_argument("--routes", default="dense",
                    help=f"comma list of {','.join(ROUTES)}")
    ap.add_argument("--n", "--sizes", default="8..12", dest="sizes",
                    help='matrix sizes: "8..16" or "8,10,12" (--sizes under '
                         "torchrun, whose own parser may read --n as one "
                         "of its flags)")
    ap.add_argument("--out", required=True, help="tuning table JSON path")
    ap.add_argument("--report", default=None,
                    help="also write per-candidate mispredict rows (JSON)")
    ap.add_argument("--precision", default="dq_acc",
                    choices=("dd", "dq_fast", "dq_acc", "qq", "kahan"))
    ap.add_argument("--density", type=float, default=0.5,
                    help="sparse-route density (bucketed in the table)")
    ap.add_argument("--batch", type=int, default=16,
                    help="measurement batch size")
    ap.add_argument("--top-k", type=int, default=3,
                    help="model-ranked candidates to measure per key")
    ap.add_argument("--repeats", type=int, default=3,
                    help="timed repeats per candidate (median kept)")
    ap.add_argument("--device", default=None,
                    help="'cpu' measures the plain versions on the host "
                         "(tests); default: the card")
    ap.add_argument("--hw", default=None,
                    help="override the hardware spec (utils/roofline.py "
                         "registry name; default: the card's, or cpu)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ranks-per-device", type=int, default=1,
                    help="under torchrun: ranks a card may hold")
    args = ap.parse_args(argv)

    routes = [r for r in args.routes.split(",") if r]
    for r in routes:
        if r not in ROUTES:
            raise SystemExit(f"unknown route {r!r}; choose from {ROUTES}")
    ns = parse_ns(args.sizes)
    from . import mesh as mesh_lib
    if not mesh_lib.launched_by_torchrun():
        return _tune(args, routes, ns, None, print)
    with mesh_lib.world():
        mesh = mesh_lib.make_mesh(
            (mesh_lib.world_size(),), ("step",), device=args.device,
            ranks_per_device=args.ranks_per_device)
        return _tune(args, routes, ns, mesh, print if mesh.index == 0
                     else lambda *a, **k: None)


def _tune(args, routes: list, ns: list, mesh, print) -> int:
    """The CLI's work, over ``mesh`` when there is one; ``print`` and the
    table's save happen on shard 0 only."""
    from ..core.ryser import resolve_device
    from ..tune.search import tune_table
    from ..utils.roofline import detect_hw, get_hw
    dev = resolve_device(args.device) if mesh is None else mesh.device
    hw = get_hw(args.hw) if args.hw else \
        detect_hw() if dev.type == "cuda" else get_hw("cpu")
    print(f"[tune] routes={','.join(routes)} n={ns} hw={hw.name} "
          f"device={dev} ranks={1 if mesh is None else mesh.size}",
          flush=True)
    t0 = time.time()

    def progress(entry):
        print(f"[tune] {entry.key()} -> {entry.geometry.tag()} "
              f"default={entry.default_s * 1e3:.4f}ms "
              f"winner={entry.measured_s * 1e3:.4f}ms "
              f"speedup={entry.speedup:.3f}x "
              f"pred/meas={entry.mispredict_ratio:.3f}", flush=True)

    table, report = tune_table(
        routes, ns, density=args.density, precision=args.precision,
        batch=args.batch, top_k=args.top_k, repeats=args.repeats,
        device=dev, seed=args.seed, mesh=mesh, hw=hw,
        progress=progress)
    if mesh is not None and mesh.index != 0:
        return 0
    table.save(args.out)
    print(f"[tune] {len(table.entries)} entr(ies) -> {args.out} "
          f"({time.time() - t0:.1f}s)", flush=True)
    if args.report:
        with open(args.report, "w") as f:
            json.dump({"hw": hw.name, "rows": report}, f, indent=1)
        print(f"[tune] mispredict report -> {args.report}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(tune_main())
