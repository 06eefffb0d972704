"""Program spans on the profiler's clock.

``with span("repro.dispatch"):`` marks a phase of the port for an
operator's ``torch.profiler`` run: while a profiler records, the span is
``torch.profiler.record_function(name)``, so it sits on the clock of the
CUDA kernels and shows in ``export_chrome_trace`` and in
``prof.events()``.  While none records, it is one shared no-op context:
the cost is one ``torch.autograd._profiler_enabled()`` check, with no
allocation and no string built.  Spans open at phase level only, never
once a matrix or a leaf inside a loop (``PERF.md`` lists each span and
what reads it).
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["span"]

_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler span named ``name`` while a profiler records, else a
    no-op context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
