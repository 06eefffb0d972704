"""The traced run's device trace, reduced to what the readers need.

``Tracer`` runs ``torch.profiler`` (CUPTI) over the first ``TRACE_S``
seconds of the measured window, to the end of the call in flight then,
when tracing is on and the run is on a card; otherwise it records
nothing.  The harness marks its own host spans with ``tracer.span(name)``
(``record_function``, so they share the trace's clock); the traced part
of the window is the span ``bench.window``.

``Tracer.reduce()`` gives, over the traced window: the device's busy seconds
(the union of every device operation's interval, kernels and copies
alike), the seconds of the Ryser kernels (device kernels whose name holds
``ryser``), device seconds by operation name, and the device's idle
seconds, each idle gap named by the innermost host event (a harness
span, a PyTorch operator or a CUDA runtime call of the main thread) that
was open at the gap's midpoint: what the host was doing while the device
waited.  It gives None where the trace holds no device operation.
"""

from __future__ import annotations

import contextlib
import time

__all__ = ["TRACE_S", "Tracer", "WINDOW"]

WINDOW = "bench.window"
TRACE_S = 8.0          # seconds of the window the profiler records


class Tracer:
    """The profiler over the window's first ``TRACE_S`` seconds: ``start``
    at the window's start, ``stop(calls)`` after the call that ends the
    traced part (``calls`` completed by then).  Reading a trace costs
    about 20 ms of host time for each second of a call-heavy window, so
    the window runs on untraced; ``paused_s`` is what stopping took."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self._window = None
        self.calls = 0
        self.paused_s = 0.0

    @property
    def active(self) -> bool:
        return self._window is not None

    def start(self) -> None:
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile, record_function
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._window = record_function(WINDOW)
        self._window.__enter__()

    def stop(self, calls: int) -> None:
        if not self.active:
            return
        t = time.perf_counter()
        self._window.__exit__(None, None, None)
        self._window = None
        self.prof.__exit__(None, None, None)
        self.calls = calls
        self.paused_s = time.perf_counter() - t

    def span(self, name: str):
        if not self.active:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(name)

    def reduce(self) -> dict | None:
        if self.prof is None:
            return None
        from torch.autograd import DeviceType
        events = list(self.prof.events())
        window = [e for e in events if e.name == WINDOW]
        if not window:
            return None
        w0, w1 = window[0].time_range.start, window[0].time_range.end
        device, host = [], []
        main = window[0].thread           # the harness's own thread
        for e in events:
            start, end = e.time_range.start, e.time_range.end
            if e.device_type == DeviceType.CUDA:
                if getattr(e, "is_user_annotation", False) or \
                        e.name.startswith("bench."):
                    continue      # a host span mirrored on the device's row
                a, b = max(start, w0), min(end, w1)
                if b > a:
                    device.append((a, b, e.name))
            elif e.thread == main:
                host.append((start, end, e.name))
        if not device:
            return None
        device.sort()
        by_name: dict[str, float] = {}
        ryser = 0.0
        for a, b, name in device:
            by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
            if "ryser" in name.lower():
                ryser += (b - a) / 1e6
        busy, gaps, end = 0.0, [], w0
        for a, b, _ in device:
            if a > end:
                gaps.append((end, a))
            if b > end:
                busy += b - max(a, end)
                end = b
        if w1 > end:
            gaps.append((end, w1))
        idle = _name_gaps(gaps, host)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        return {"window_s": (w1 - w0) / 1e6, "busy_s": busy / 1e6,
                "ryser_s": ryser, "device_ops": [list(t) for t in top],
                "idle_gaps": [list(t) for t in idle[:10]]}


def _name_gaps(gaps, host) -> list:
    """Idle seconds by the innermost host event open at each gap's
    midpoint, the largest first.  Host events of one thread nest, so a
    sweep with a stack of open events finds each innermost one."""
    host = sorted(host, key=lambda h: (h[0], -h[1]))
    starts = [h[0] for h in host]
    out: dict[str, float] = {}
    stack: list = []
    k = 0
    for a, b in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
        mid = (a + b) / 2
        while k < len(host) and starts[k] <= mid:
            stack.append(host[k])
            k += 1
        stack[:] = [h for h in stack if h[1] >= mid]    # still open
        name = stack[-1][2] if stack else "(no host event)"
        out[name] = out.get(name, 0.0) + (b - a) / 1e6
    return sorted(out.items(), key=lambda kv: -kv[1])
