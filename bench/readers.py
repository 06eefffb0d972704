"""The formulas behind the metric readers of ``bench/metrics/``.

Each ``bench/metrics/<metric>.py`` names one of these as its ``read``; a
reader takes the run's ``harness.View`` and gives a number, or None where
the run has nothing to read (no device trace, no card with a peak on
record, no call): the harness then leaves the metric out of the line.
A share is in percent and is never given as 0 for want of a reading.
"""

from __future__ import annotations

import numpy as np

__all__ = ["call_p95_ms", "campaign_overhead_share", "device_idle",
           "dispatch_host_ms", "kernel_roofline", "perm_time_s",
           "perms_per_s", "plan_ms", "setup_s"]


def _traced(view) -> list | None:
    traces = view.traces
    if not traces or any(t is None for t in traces):
        return None
    return traces


def setup_s(view) -> float:
    """Process start to the first timed call: load, inputs, warm-up."""
    return view.setup_s


def perm_time_s(view) -> float | None:
    """The window's wall seconds over the permanents completed in it."""
    return view.window_s / view.completed if view.completed else None


def perms_per_s(view) -> float | None:
    """Permanents completed over the window's wall seconds."""
    if not view.completed or view.window_s <= 0:
        return None
    return view.completed / view.window_s


def call_p95_ms(view) -> float | None:
    """95th percentile of every call's wall ms, plan to synchronised
    result."""
    if not view.calls:
        return None
    return float(np.percentile([p + e for p, e in view.calls], 95)) * 1e3


def plan_ms(view) -> float | None:
    """Mean host ms of ``plan`` / ``plan_batch`` a call."""
    if not view.calls:
        return None
    return float(np.mean([p for p, _ in view.calls])) * 1e3


def dispatch_host_ms(view) -> float | None:
    """``execute``'s wall ms a call less the device's busy ms a call,
    over the traced window's calls."""
    traces = _traced(view)
    calls = view.calls[:view.traced_calls]
    if traces is None or not calls:
        return None
    execute = sum(e for _, e in calls)
    return (execute - traces[0]["busy_s"]) / len(calls) * 1e3


def campaign_overhead_share(view) -> float | None:
    """Percent of the window the waves spent on the host beside their
    kernels: sum of (host_s - kernel_s + save_s) over the window's waves,
    the mean over the ranks."""
    shares = []
    for waves in view.waves:
        if not waves or any(k is None for _, k, _ in waves):
            return None
        shares.append(sum(h - k + s for h, k, s in waves) / view.window_s)
    return 100.0 * float(np.mean(shares)) if shares else None


def kernel_roofline(view) -> float | None:
    """Percent of the data-sheet FP64 peak that the Ryser kernels reached:
    the yardstick FLOPs of the traced window's completed inputs over their
    device seconds (summed over the ranks) times the peak of one card."""
    traces = _traced(view)
    if traces is None or view.peak is None or not view.traced_flops:
        return None
    seconds = sum(t["ryser_s"] for t in traces)
    if seconds <= 0:
        return None
    return 100.0 * view.traced_flops / (seconds * view.peak)


def device_idle(view) -> float | None:
    """Percent of the traced window in which no operation ran on the
    device, the mean over the ranks."""
    traces = _traced(view)
    if traces is None:
        return None
    return 100.0 * (1.0 - float(np.mean(
        [t["busy_s"] / t["window_s"] for t in traces])))
