"""Always-on permanent service on one card: continuous batching,
priority lanes, SLOs, and observability over the port's plan/execute
solver stack (the port of the reference package's ``serve``).

    from repro_torch.serve import PermanentService, ServiceConfig

    svc = PermanentService(SolverConfig(precision="dq_acc"),
                           ServiceConfig(max_batch=32,
                                         warmup_ns=(10,),
                                         compile_cache_dir="kernel-cache"))
    t = svc.submit(A, lane="interactive")
    svc.drain()
    print(t.result(), svc.snapshot()["latency_s"]["overall"]["p99"])

Layering: ``lanes`` (admission mechanism: priority lanes, deadlines,
typed shedding) -> ``loop`` (the service: continuous batching, back-
pressure, campaign interleaving) -> ``metrics`` (one snapshot schema) +
``compile_cache`` (kernel-library cache + warm-up).  ``launch/serve.py``
is the CLI over this package.
"""

from .compile_cache import (compile_stats, enable_compile_cache,
                            quantized_batches, warmup)
from .lanes import (DEFAULT_LANES, LaneQueue, LaneSpec, ServeTicket,
                    ShedError, ShedReason, request_cost)
from .loop import CampaignSpec, PermanentService, ServiceConfig, run_soak
from .metrics import Histogram, ServeMetrics, start_metrics_server

__all__ = [
    "CampaignSpec", "DEFAULT_LANES", "Histogram", "LaneQueue", "LaneSpec",
    "PermanentService", "ServeMetrics", "ServeTicket", "ServiceConfig",
    "ShedError", "ShedReason", "compile_stats", "enable_compile_cache",
    "quantized_batches", "request_cost", "run_soak",
    "start_metrics_server", "warmup",
]
