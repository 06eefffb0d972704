"""The ``campaign`` loop: one caller, closed loop, whole permanents on
the campaign route.  Each permanent takes a fresh matrix, checkpointed to
a fresh file, its waves recorded through ``solver.campaign_progress``.
With ``ranks`` > 1 every rank of a gloo world, one rank a card, runs the
same loop over the mesh, and rank 0 decides when the window closes.

Its checks (each gap over the scale of its own rounding):

* ``slice_gap``: an n = 38 permanent is 2^37 Gray steps, more than a
  plain recomputation can do inside a run, so the reference follows the
  campaign through its own state.  For a sample of (permanent, slice)
  pairs, drawn from the seed, |hi + lo - S| over sum |terms|, where
  (hi, lo) is the slice's sum in the JobState the program reached and S
  its sum over the slice's steps by the reference; on a mesh every
  rank's JobState is held to it.
* ``close_gap``: for every permanent of the window and every rank,
  |value - 2(-1)^(n-1) (sum of the JobState's slice sums + the g = 0
  term)| over 2 (sum |slice sums| + |g = 0 term|): the reduce and the
  closing term, with the reference's own g = 0 term and an exact sum
  (``math.fsum``).  A permanent whose JobState is not complete reads
  infinity.
"""

from __future__ import annotations

import math
import os
import sys
import time

import numpy as np

from bench import check, inputs, tracing
from bench.harness import Window, sync
from bench.reference import ryser as R


def warm_up(cell, solver, seed: int, device: str, workdir: str) -> None:
    """The first wave of a warm-up permanent: the cell's own shapes."""
    from repro_torch import CampaignPaused
    A, _ = inputs.Draws(cell, seed, "warmup").next()
    base = solver.config
    solver.config = base.replace(
        campaign_max_waves=1,
        campaign_checkpoint=os.path.join(workdir, "warmup.npz"))
    try:
        solver.execute(solver.plan(A))
    except CampaignPaused:
        pass
    finally:
        solver.config = base
    sync(device)


def _state(st):
    return None if st is None else (st.hi.copy(), st.lo.copy(),
                                    st.done.copy())


def window(cell, solver, seed: int, seconds: float | None, tracer,
           device: str, workdir: str,
           decide=lambda stop, trace: (stop, trace),
           items: int | None = None) -> Window:
    """Whole permanents until ``seconds`` have passed, or, with ``items``,
    that many; ``decide(stop, stop_trace)`` turns rank 0's verdicts into
    every rank's (the identity on one card)."""
    draws = inputs.Draws(cell, seed, "window")
    w = Window(per_call=1)
    last: dict = {}

    def progress(state, wave):
        last["state"] = state
        w.waves.append((wave.host_s, wave.kernel_s, wave.save_s))

    solver.campaign_progress = progress
    base = solver.config
    clock = time.perf_counter
    tracer.start()
    start = clock()
    while True:
        A, token = draws.next()
        ckpt = os.path.join(workdir, f"perm{w.attempted}.npz")
        solver.config = base.replace(campaign_checkpoint=ckpt)
        w.attempted += 1
        last.clear()
        t0 = clock()
        try:
            with tracer.span("bench.plan"):
                plan = solver.plan(A)
            t1 = clock()
            with tracer.span("bench.execute"):
                value = solver.execute(plan)
                sync(device)
        except Exception as e:                  # a failed permanent
            w.failed += 1
            print(f"permanent {w.attempted} failed: {e!r}", file=sys.stderr)
        else:
            w.calls.append((t1 - t0, clock() - t1))
            w.tokens.append(token)
            w.values.append(value)
            w.states.append(_state(last.get("state")))
        if os.path.exists(ckpt):
            os.unlink(ckpt)
        elapsed = clock() - start
        stop, stop_trace = decide(
            w.attempted >= items if items else elapsed >= seconds,
            elapsed >= tracing.TRACE_S)
        if stop or stop_trace:
            tracer.stop(len(w.values))
        if stop:
            break
    w.seconds = clock() - start
    w.paused = tracer.paused_s
    w.traced = tracer.calls
    solver.config = base
    return w


def sample(cell, window: Window, seed: int) -> list[tuple[int, int]]:
    """(permanent, slice) pairs of the check's sample, from the seed."""
    slices = int(cell.config["solver"]["campaign_slices"])
    total = len(window.values) * slices
    count = min(int(cell.spec["sample"]["slices"]), total)
    picks = inputs.rng(seed, "check").choice(total, count, replace=False)
    return sorted((int(p) // slices, int(p) % slices) for p in picks)


def references(cell, window: Window, seed: int, device: str,
               share=(0, 1)) -> dict:
    """{(permanent, slice): (sum, magnitude)} of the sample's items that
    fall to ``share`` = (rank, ranks), by the reference on ``device``."""
    rank, ranks = share
    draws = inputs.Draws(cell, seed, "window")
    slices = int(cell.config["solver"]["campaign_slices"])
    out = {}
    for i, (k, s) in enumerate(sample(cell, window, seed)):
        if i % ranks != rank:
            continue
        first, last = R.slice_bounds(draws.n, slices, s)
        out[(k, s)] = R.step_sums(
            check.tensor(draws.matrices(window.tokens[k]), device),
            first, last)
    return out


def judge(cell, window: Window, seed: int, device: str,
          refs=None) -> list:
    draws = inputs.Draws(cell, seed, "window")
    f = R.final_factor(draws.n)
    states = window.rank_states or [window.states]
    values = window.rank_values or [window.values]
    if refs is None:
        refs = references(cell, window, seed, device)
    slice_gap = 0.0
    for (k, s), (ref, mag) in refs.items():
        for rank_states in states:
            st = rank_states[k]
            got = math.inf if st is None else check.fsum([st[0][s],
                                                          st[1][s]])
            slice_gap = max(slice_gap, abs(got - ref) / mag)
    close_gap = 0.0
    for k, token in enumerate(window.tokens):
        p0 = R.base_term(check.tensor(draws.matrices(token), "cpu"))
        for rank_states, rank_values in zip(states, values):
            st = rank_states[k]
            if st is None or not np.all(st[2]):
                close_gap = math.inf
                continue
            hi, lo = st[0], st[1]
            total = check.fsum(list(hi) + list(lo))
            scale = abs(f) * (math.fsum(abs(check.fsum([h, l]))
                                        for h, l in zip(hi, lo)) + abs(p0))
            ref = f * (total + p0)
            close_gap = max(close_gap,
                            abs(check.num(rank_values[k]) - ref) / scale)
    return [("slice_gap", slice_gap), ("close_gap", close_gap)]


def lower_window(cell, seed: int, items: int, device: str) -> Window:
    """The control's permanents: ``core.distributed.run_campaign`` on f32
    copies of the first ``items`` matrices, with the plan's slice
    decomposition, on one card (a mesh's values are one card's)."""
    from bench.harness import make_solver
    from repro_torch.core.distributed import run_campaign
    draws = inputs.Draws(cell, seed, "window")
    solver = make_solver(cell.config, device)
    w = Window(per_call=1)
    for _ in range(items):
        A, token = draws.next()
        spec = solver.plan(A).leaves[0].campaign
        value, st = run_campaign(
            np.asarray(A, dtype=np.float32),
            total_slices=spec.total_slices,
            chunks_per_slice=spec.chunks_per_slice,
            chunk_size=spec.chunk_size, precision=spec.precision,
            backend=spec.backend, geometry=spec.geometry,
            device=None if device == "cuda" else device)
        w.attempted += 1
        w.tokens.append(token)
        w.values.append(value)
        w.states.append(_state(st))
    return w
