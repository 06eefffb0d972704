"""Observability layer for the always-on permanent service.

A copy of the reference package's ``serve/metrics.py`` with the same
schema.  Monotonic-clock histograms and counters for the serve loop,
exported in ONE schema -- the soak's report, the periodic log line, and
the JSON snapshot endpoint all read the same counters, and the port's
``PermanentSolver.stats()`` (dispatch/cache accounting + the executor's
per-leaf ``leaf_timings`` from its ``ExecStats``) is embedded verbatim.

Snapshot schema (``ServeMetrics.snapshot()``)::

    {
      "schema": "repro.serve.metrics/v1",
      "uptime_s": float,                  # monotonic, since construction
      "requests": {
        "admitted": int,                  # tickets submitted (admission
                                          #   attempts, incl. ones shed
                                          #   at the door)
        "completed": int,                 # tickets resolved with a value
        "pending": int,                   # still queued (loop-supplied)
        "shed": {reason: int, ...},       # typed rejections, by reason
        "shed_total": int                 # sum of the above
      },                                  # invariant: admitted ==
                                          #   completed+shed_total+pending
      "latency_s": {                      # admission -> result
        "overall": HIST, "<lane>": HIST, ...
      },
      "queue_depth": HIST,                # sampled once per loop tick
      "bucket_occupancy": HIST,           # served/batch-capacity per
      "dispatches": int,                  #   bucket dispatch
      "cache_hit_rate": float | None,     # solver result cache (mirror)
      "campaign_fraction": float | None,  # interleaved campaign progress
      "solver": <PermanentSolver.stats()>,  # incl. cache + leaf_timings
      "compile_cache": <serve.compile_cache.compile_stats()> | None
                                          # (kernel library loads)
    }

    HIST = {"count": int, "mean": float, "p50": float, "p99": float,
            "max": float}

Quantiles come from fixed log-spaced bucket histograms (no sample
retention -- bounded memory under millions of requests); ``p50``/``p99``
are bucket upper-bound estimates, conservative by at most one bucket
width (~26% with the default 10-buckets-per-decade layout).

:func:`start_metrics_server` serves the snapshot as JSON over stdlib
HTTP (``GET /metrics``) for scraping; ``ServeMetrics.log_line()`` is the
one-line periodic summary the loop prints.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Callable

from .lanes import ShedReason

__all__ = ["Histogram", "ServeMetrics", "start_metrics_server"]

SCHEMA = "repro.serve.metrics/v1"


class Histogram:
    """Fixed log-spaced-bucket histogram with quantile estimation.

    Buckets span [lo, hi) at ``per_decade`` buckets per decade, plus
    underflow/overflow buckets; observation is O(log buckets), memory is
    O(buckets) regardless of sample count.
    """

    def __init__(self, lo: float = 1e-6, hi: float = 1e5,
                 per_decade: int = 10):
        if not (0 < lo < hi):
            raise ValueError(f"need 0 < lo < hi, got {lo}, {hi}")
        import math
        decades = math.log10(hi / lo)
        nb = max(1, round(decades * per_decade))
        ratio = (hi / lo) ** (1.0 / nb)
        self._edges = [lo * ratio ** i for i in range(nb + 1)]
        self._counts = [0] * (nb + 2)        # + underflow / overflow
        self.count = 0
        self.total = 0.0
        self.max = 0.0

    def observe(self, v: float) -> None:
        self.count += 1
        self.total += v
        self.max = max(self.max, v)
        import bisect
        self._counts[bisect.bisect_right(self._edges, v)] += 1

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Upper-bound estimate of the q-quantile (0 when empty)."""
        if not self.count:
            return 0.0
        target = q * self.count
        seen = 0
        for i, c in enumerate(self._counts):
            seen += c
            if seen >= target and c:
                if i == 0:                       # underflow bucket
                    return self._edges[0]
                if i > len(self._edges) - 1:     # overflow bucket
                    return self.max
                return min(self._edges[i], self.max)
        return self.max

    def to_json(self) -> dict:
        return {"count": self.count, "mean": self.mean,
                "p50": self.quantile(0.50), "p99": self.quantile(0.99),
                "max": self.max}


class ServeMetrics:
    """Counters + histograms for one service instance (injected clock)."""

    # torchlint: disable=PT004 the injectable clock's default; tests pass their own
    def __init__(self, clock: Callable[[], float] = time.monotonic, *,  # permlint: disable=PL004  # injectable default; tests override
                 lanes: tuple[str, ...] = ()):
        self._clock = clock
        self.t_start = clock()
        self.admitted = 0
        self.completed = 0
        self.shed: dict[str, int] = {}
        self.dispatches = 0
        self.latency = Histogram()
        self.lane_latency: dict[str, Histogram] = \
            {name: Histogram() for name in lanes}
        self.queue_depth = Histogram(lo=1.0, hi=1e6, per_decade=10)
        self.bucket_occupancy = Histogram(lo=1e-3, hi=10.0, per_decade=20)
        self._last_log = self.t_start

    # -- recording (called by the serve loop) -------------------------------

    def record_admit(self, ticket) -> None:
        """Count every submission -- including tickets shed at the door,
        so admitted == completed + shed_total + pending always holds."""
        self.admitted += 1

    def record_shed(self, ticket) -> None:
        reason: ShedReason = ticket.shed_reason
        self.shed[reason.value] = self.shed.get(reason.value, 0) + 1

    def record_complete(self, ticket) -> None:
        self.completed += 1
        lat = ticket.latency_s
        if lat is not None:
            self.latency.observe(lat)
            h = self.lane_latency.setdefault(ticket.lane.name, Histogram())
            h.observe(lat)

    def record_dispatch(self, served: int, capacity: int) -> None:
        self.dispatches += 1
        self.bucket_occupancy.observe(served / max(1, capacity))

    def sample_queue_depth(self, depth: int) -> None:
        self.queue_depth.observe(float(depth))

    # -- exporting -----------------------------------------------------------

    @property
    def shed_total(self) -> int:
        return sum(self.shed.values())

    def snapshot(self, *, pending: int = 0, solver_stats: dict | None = None,
                 compile_stats: dict | None = None,
                 campaign_fraction: float | None = None) -> dict:
        """The one JSON shape (see module docstring for the schema)."""
        cache = (solver_stats or {}).get("cache")
        return {
            "schema": SCHEMA,
            "uptime_s": self._clock() - self.t_start,
            "requests": {"admitted": self.admitted,
                         "completed": self.completed,
                         "pending": pending,
                         "shed": dict(sorted(self.shed.items())),
                         "shed_total": self.shed_total},
            "latency_s": {"overall": self.latency.to_json(),
                          **{name: h.to_json()
                             for name, h in sorted(
                                 self.lane_latency.items())}},
            "queue_depth": self.queue_depth.to_json(),
            "bucket_occupancy": self.bucket_occupancy.to_json(),
            "dispatches": self.dispatches,
            "cache_hit_rate": cache["hit_rate"] if cache else None,
            "campaign_fraction": campaign_fraction,
            "solver": solver_stats,
            "compile_cache": compile_stats,
        }

    def log_line(self, *, pending: int = 0,
                 cache_hit_rate: float | None = None,
                 campaign_fraction: float | None = None) -> str:
        """One-line periodic summary (same counters as the snapshot)."""
        lat = self.latency
        parts = [f"[serve] up={self._clock() - self.t_start:.0f}s",
                 f"admitted={self.admitted}",
                 f"done={self.completed}",
                 f"shed={self.shed_total}",
                 f"pending={pending}",
                 f"p50={lat.quantile(0.5) * 1e3:.0f}ms",
                 f"p99={lat.quantile(0.99) * 1e3:.0f}ms",
                 f"depth_p99={self.queue_depth.quantile(0.99):.0f}",
                 f"occ={self.bucket_occupancy.mean:.2f}"]
        if cache_hit_rate is not None:
            parts.append(f"cache={cache_hit_rate:.0%}")
        if campaign_fraction is not None:
            parts.append(f"campaign={campaign_fraction:.1%}")
        return " ".join(parts)

    def should_log(self, every_s: float) -> bool:
        """True (and reset the timer) when ``every_s`` elapsed since the
        last periodic log line."""
        now = self._clock()
        if now - self._last_log >= every_s:
            self._last_log = now
            return True
        return False


def start_metrics_server(snapshot_fn: Callable[[], dict], port: int = 0,
                         host: str = "127.0.0.1"):
    """Serve ``snapshot_fn()`` as JSON on ``GET /metrics`` (stdlib only).

    Returns the started ``ThreadingHTTPServer`` (daemon thread; call
    ``.shutdown()`` to stop).  ``port=0`` binds an ephemeral port --
    read it back from ``server.server_address``.
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path not in ("/metrics", "/"):
                self.send_error(404)
                return
            body = json.dumps(snapshot_fn(), indent=1).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):     # quiet: the loop owns logging
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server
