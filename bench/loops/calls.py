"""The ``calls`` loop: one caller, closed loop.  Each call takes a fresh
matrix (``batch`` 1: ``PermanentSolver.plan``) or a fresh stack
(``plan_batch``), then ``execute``, and is timed plan to synchronised
result.

Its check, ``value_gap``: for a sample of the answers the window
returned, drawn from the seed, |answer - perm(A)| over
|2| sum_g |prod_i x_g[i]|, both computed by the reference from A.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from bench import check, inputs, tracing
from bench.harness import Window, sync
from bench.reference import ryser as R


def _plan(solver, mats, batched: bool):
    return solver.plan_batch(mats) if batched else solver.plan(mats)


def warm_up(cell, solver, seed: int, device: str, workdir: str) -> None:
    """Two calls of the warm-up stream: the cell's own shapes."""
    draws = inputs.Draws(cell, seed, "warmup")
    for _ in range(2):
        mats, _ = draws.next()
        solver.execute(_plan(solver, mats, draws.batch > 1))
    sync(device)


def window(cell, solver, seed: int, seconds: float | None, tracer,
           device: str, workdir: str, decide=None,
           items: int | None = None) -> Window:
    """Calls until ``seconds`` have passed (the call in flight ends it),
    or, with ``items``, that many calls."""
    draws = inputs.Draws(cell, seed, "window")
    batched = draws.batch > 1
    w = Window(per_call=draws.batch)
    clock = time.perf_counter
    tracer.start()
    start = clock()
    while True:
        mats, token = draws.next()
        w.attempted += 1
        t0 = clock()
        try:
            with tracer.span("bench.plan"):
                plan = _plan(solver, mats, batched)
            t1 = clock()
            with tracer.span("bench.execute"):
                vals = solver.execute(plan)
                sync(device)
            t2 = clock()
        except Exception as e:                  # a failed call counts
            w.failed += 1
            print(f"call {w.attempted} failed: {e!r}", file=sys.stderr)
            t1 = t2 = clock()
        else:
            w.calls.append((t1 - t0, t2 - t1))
            w.tokens.append(token)
            w.values.append(np.asarray(vals))
        elapsed = t2 - start
        stop = w.attempted >= items if items else elapsed >= seconds
        if stop or elapsed >= tracing.TRACE_S:
            tracer.stop(len(w.values))
        if stop:
            break
    w.seconds = clock() - start
    w.paused = tracer.paused_s
    w.traced = tracer.calls
    return w


def sample(cell, window: Window, seed: int) -> list[tuple[int, int]]:
    """(call, item) pairs of the check's sample, drawn from the seed."""
    batch = window.per_call
    total = len(window.values) * batch
    count = min(int(cell.spec["sample"]["answers"]), total)
    picks = inputs.rng(seed, "check").choice(total, count, replace=False)
    return sorted((int(p) // batch, int(p) % batch) for p in picks)


def references(cell, window: Window, seed: int, device: str,
               share=(0, 1)):
    """Nothing: the judge computes its references itself."""
    return None


def judge(cell, window: Window, seed: int, device: str,
          refs=None) -> list:
    draws = inputs.Draws(cell, seed, "window")
    gap = 0.0
    for c, i in sample(cell, window, seed):
        mats = draws.family.matrices(draws.ctx, window.tokens[c], draws.n,
                                     draws.batch)
        got = check.num(np.asarray(window.values[c]).reshape(-1)[i])
        ref, mag = R.permanent(check.tensor(mats[i], device))
        gap = max(gap, abs(got - ref) / mag)
    return [("value_gap", gap)]


def lower_window(cell, seed: int, items: int, device: str) -> Window:
    """The control's answers: the program's own single-precision kernel
    entries (``kernels.ops.permanent_cuda`` / ``permanent_cuda_batched``)
    on f32 / complex64 copies of the first ``items`` calls' inputs."""
    import torch
    from repro_torch.kernels import ops
    draws = inputs.Draws(cell, seed, "window")
    precision = cell.config["solver"]["precision"]
    w = Window(per_call=draws.batch)
    for _ in range(items):
        mats, token = draws.next()
        dt = np.complex64 if np.iscomplexobj(mats) else np.float32
        A = torch.as_tensor(np.asarray(mats, dtype=dt), device=device)
        entry = ops.permanent_cuda_batched if A.ndim == 3 \
            else ops.permanent_cuda
        w.attempted += 1
        w.tokens.append(token)
        w.values.append(entry(A, precision=precision,
                              device=device).cpu().numpy())
    return w
