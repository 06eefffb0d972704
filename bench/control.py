"""Readings of the check's numbers on a cell's first calls, for setting
its limits: the program as the window drives it, or a control.

    python3 bench/control.py --workload <cell> --seeds 1,2,3 \
        --items <k> --path program|dd|lower [--device cuda|cpu]

For each seed, the first ``items`` calls (or permanents) of the window's
stream, the same inputs a run of that seed starts with, go through

* ``program``: the timed path, the cell's loop (``loops/<loop>.py``) as
  a run drives it;
* ``dd``: the same loop and plan with the solver's ``precision`` set to
  ``dd``, the program's next accumulator below the configuration's
  ``dq_acc``: plain f64 sums where ``dq_acc`` keeps a twofloat one;
* ``lower``: the program's own single-precision path, one step below the
  configuration's f64 data: the loop's ``lower_window`` (the kernel
  entries on f32 / complex64 copies of the inputs, or ``run_campaign``
  on the f32 matrix, one card: a mesh's values are one card's).

and then ``check.judge``, as a run's answers do.  One JSON line a seed.
The benchmark's runs never run this.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))

PATHS = ("program", "dd", "lower")


def control_window(cell, seed: int, items: int, path: str, device: str):
    import dataclasses
    import tempfile

    from bench import byname, harness, tracing
    loop = byname.loop(cell)
    if path == "lower":
        return loop.lower_window(cell, seed, items, device)
    if path == "dd":
        solver = dict(cell.config["solver"], precision="dd")
        cell = dataclasses.replace(cell, config=dict(cell.config,
                                                     solver=solver))
    solver = harness.make_solver(cell.config, device)
    with tempfile.TemporaryDirectory(prefix="bench-control-") as workdir:
        return loop.window(cell, solver, seed, None, tracing.Tracer(False),
                           device, workdir, items=items)


def main(argv) -> int:
    import argparse
    import json
    import time
    from bench import check, harness
    p = argparse.ArgumentParser(prog="bench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--items", type=int, required=True)
    p.add_argument("--path", choices=PATHS, required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = harness.load_cell(ROOT, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        w = control_window(cell, seed, args.items, args.path, args.device)
        checks = check.judge(cell, w, seed, args.device)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "path": args.path, "items": args.items,
                          "seconds": time.perf_counter() - t,
                          "checks": {c["name"]: c["value"]
                                     for c in checks}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
