"""A loop added as a file alone: each call submits ``batch`` fresh
matrices to the solver's queue (``PermanentSolver.submit``), flushes it
and reads every future's result.  It is judged as the ``calls`` loop
is, by the ``calls`` loop's own file."""

import sys
import time

import numpy as np

from bench import byname, inputs, tracing
from bench.harness import Window, sync


def _calls(cell):
    return byname.module(cell.root, "loops", "calls")


def _one(solver, mats):
    reqs = [solver.submit(A) for A in mats]
    solver.flush()
    return np.array([r.result() for r in reqs])


def warm_up(cell, solver, seed, device, workdir):
    draws = inputs.Draws(cell, seed, "warmup")
    _one(solver, draws.next()[0].reshape(-1, draws.n, draws.n))
    sync(device)


def window(cell, solver, seed, seconds, tracer, device, workdir,
           decide=None, items=None):
    draws = inputs.Draws(cell, seed, "window")
    w = Window(per_call=draws.batch)
    clock = time.perf_counter
    tracer.start()
    start = clock()
    while True:
        mats, token = draws.next()
        w.attempted += 1
        t0 = clock()
        try:
            with tracer.span("bench.execute"):
                vals = _one(solver, mats.reshape(-1, draws.n, draws.n))
                sync(device)
        except Exception as e:
            w.failed += 1
            print(f"call {w.attempted} failed: {e!r}", file=sys.stderr)
        else:
            w.calls.append((0.0, clock() - t0))
            w.tokens.append(token)
            w.values.append(vals)
        elapsed = clock() - start
        stop = w.attempted >= items if items else elapsed >= seconds
        if stop or elapsed >= tracing.TRACE_S:
            tracer.stop(len(w.values))
        if stop:
            break
    w.seconds = clock() - start
    w.paused = tracer.paused_s
    w.traced = tracer.calls
    return w


def references(cell, window, seed, device, share=(0, 1)):
    return None


def judge(cell, window, seed, device, refs=None):
    return _calls(cell).judge(cell, window, seed, device, refs)
