"""The formula behind the ``idle_in_*`` readers of ``bench/metrics/``.

The program marks its phases with spans on the profiler's clock
(``repro_torch/utils/spans.py``: ``repro.plan``, ``repro.dispatch``,
``repro.campaign``, ``repro.mesh`` and their sub-spans).  A traced run
names each idle gap of the device by the innermost host event open at the
gap's midpoint and keeps a rank's ten largest names (``tracing.Tracer``,
``idle_gaps``).  So a gap named ``repro.plan.leaves`` is an idle stretch
whose midpoint fell while the planner's own Python was the innermost
event, and it counts there whole; a PyTorch operator or a CUDA runtime
call made inside a layer keeps its own name and is not counted.

``idle_in(view, prefix)``: for each rank, the idle seconds of the gaps
whose name is ``prefix`` or begins with ``prefix + "."``, over that
rank's traced window; the mean over the ranks, in percent.  None without
a trace on every rank, and None where a rank's list is full and holds
none of the layer's gaps, since the share then lies below the tenth and
cannot be read; a shorter list without one reads a true 0.  A program
without these spans reads 0 or None.
"""

from __future__ import annotations

import numpy as np

from bench.readers import _traced

__all__ = ["FULL", "idle_in"]

FULL = 10          # names a rank's trace keeps (``tracing.Tracer.reduce``)


def idle_in(view, prefix: str) -> float | None:
    """Percent of the traced window the device idled under ``prefix``'s
    spans, the mean over the ranks."""
    traces = _traced(view)
    if traces is None:
        return None
    shares = []
    for t in traces:
        gaps = t["idle_gaps"]
        mine = [s for name, s in gaps
                if name == prefix or name.startswith(prefix + ".")]
        if not mine and len(gaps) >= FULL:
            return None
        shares.append(sum(mine) / t["window_s"])
    return 100.0 * float(np.mean(shares))
