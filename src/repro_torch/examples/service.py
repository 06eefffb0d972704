"""The always-on permanent service: lanes, SLOs and observability, on the
port.

    python -m repro_torch.examples.service [--device cpu|cuda]

The port of ``examples/service.py``: the layer above the plan/execute
solver, ``repro_torch.serve.PermanentService``.  Configure lanes and
budgets, warm up with a compile cache (the kernel library's build root,
``serve/compile_cache.py``), admit requests (every rejection is a typed
shed), step and drain the loop, read one metrics snapshot, and serve it
as ``GET /metrics`` on 127.0.0.1.  On the CPU the reference's n = 10 and
max_batch 8 with the torch engine; on the card n = 24, max_batch 64 and
``warmup_ns=(24,)`` with the kernels.
"""

from __future__ import annotations

import json
import urllib.request

import numpy as np

from ..core.solver import SolverConfig
from ..kernels.build import build_dir
from ..serve import (LaneSpec, PermanentService, ServiceConfig, ShedError,
                     start_metrics_server)
from . import card, cli

__all__ = ["main"]


def main(device: str | None = None) -> dict:
    dev, on_card = card(device)
    n, max_batch = (24, 64) if on_card else (10, 8)
    rng = np.random.default_rng(0)
    out: dict = {}

    # --- 1. configure: lanes, budgets, warm-up -----------------------------
    # Two strict-priority lanes; each lane's slo_s doubles as the default
    # per-request deadline.  The compile cache is the kernel library's
    # build root: a warm root loads the library without nvcc.
    svc = PermanentService(
        SolverConfig(precision="dq_acc", backend="cuda" if on_card
                     else "torch", device=dev),
        ServiceConfig(max_batch=max_batch,
                      lanes=(LaneSpec("interactive", 0, slo_s=2.0),
                             LaneSpec("bulk", 1, slo_s=30.0)),
                      max_queue_depth=64,
                      compile_cache_dir=str(build_dir().parent),
                      warmup_ns=(n,)))
    wr = svc.warmup_report
    print(f"warmup: {wr['geometries']} geometries in {wr['seconds']:.1f}s, "
          f"persistent compile cache: {wr['compile']}")
    out["warmup"] = wr

    # --- 2. admit: priority lanes, typed shedding --------------------------
    bulk = [svc.submit(rng.uniform(-1, 1, (n, n)), lane="bulk")
            for _ in range(6)]
    urgent = svc.submit(rng.uniform(-1, 1, (n, n)), lane="interactive")
    doomed = svc.submit(rng.uniform(-1, 1, (n, n)), lane="interactive",
                        deadline_s=0.0)          # expires before dispatch

    # --- 3. the loop: continuous batching ----------------------------------
    svc.step()
    backfilled = sum(t.done for t in bulk)
    print(f"after one step: urgent done={urgent.done}, "
          f"{backfilled}/6 bulk done (backfilled)")
    svc.drain()
    print(f"urgent perm = {urgent.result():+.6e}")
    try:
        doomed.result()
        shed = None
    except ShedError as e:
        shed = str(e)
        print(f"doomed request shed as expected: {e}")
    out.update(urgent_done=urgent.done, backfilled=backfilled,
               urgent=urgent.result(), bulk=[t.result() for t in bulk],
               shed=shed)

    # --- 4. observe: one schema everywhere ---------------------------------
    snap = svc.snapshot()
    req, lat = snap["requests"], snap["latency_s"]["overall"]
    print(f"snapshot: admitted={req['admitted']} completed={req['completed']} "
          f"shed={req['shed']} | p50={lat['p50'] * 1e3:.0f}ms "
          f"p99={lat['p99'] * 1e3:.0f}ms | dispatches={snap['dispatches']}")
    hottest = max(snap["solver"]["leaf_timings"].items(),
                  key=lambda kv: kv[1]["total_s"])[0]
    print(f"hottest kernel: {hottest}")
    print(f"persistent compile cache now: {snap['compile_cache']}")
    out.update(admitted=req["admitted"], completed=req["completed"],
               shed_counts=req["shed"], dispatches=snap["dispatches"],
               hottest=hottest)

    server = start_metrics_server(svc.snapshot, port=0)
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{server.server_address[1]}/metrics") as r:
            schema = json.loads(r.read())["schema"]
    finally:
        server.shutdown()
        server.server_close()
    print(f"GET /metrics -> schema {schema}")
    out["schema"] = schema
    return out


if __name__ == "__main__":
    cli(main, __doc__)
