"""Preemption-safe computation of one large permanent (paper Sec. 6.3),
on the port.

    python -m repro_torch.examples.large_permanent [--device cpu|cuda]

The port of ``examples/large_permanent.py``: the campaign lifecycle of
the plan/execute stack.

1. PLAN   -- ``campaign_threshold`` routes the matrix to ``step_sharded``;
             the plan records the resumable slice decomposition.
2. RUN    -- the executor's ``CampaignBackend`` runs the slices in waves,
             checkpointing the twofloat partials after each.
3. KILL   -- ``campaign_max_waves`` preempts the run: ``CampaignPaused``
             with work still pending (a SIGKILL behaves alike).
4. RESUME -- a fresh solver on the same checkpoint finishes the slices.
5. CHECK  -- the resumed value equals an uninterrupted campaign bit for
             bit, and the direct engine within 1e-12 (1e-9 on the card,
             whose campaign chunks are 2^15 steps: ``ENGINE_RTOL``).

On the CPU the reference's n = 14, 16 slices of 64 lanes and the torch
engine (the reference's jnp); on the card U(0.2, 1.2) at n = 36 with the
port's default slice spec (1024 slices, waves that fill the card), the
wave body kernel #1, and the direct engine the scalar entry #1 with
``campaign_threshold`` out of the way.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

from ..core.distributed import CampaignPaused
from ..core.solver import PermanentSolver, SolverConfig
from . import card, cli

__all__ = ["main"]

# The resumed campaign against the direct engine.  On the CPU the
# reference's bar (n = 14, chunks of 8 steps).  On the card the default
# spec cuts n = 36 into chunks of 2^15 Gray steps, and the row sums drift
# over a chunk (round-off that grows with its length, PERF.md section 7),
# where the direct entry's chunks are 64 steps: read 3.39e-10 apart on an
# H100, so the bar there is the port's value bar against the oracle.
ENGINE_RTOL = {False: 1e-12, True: 1e-9}


def main(device: str | None = None) -> dict:
    dev, on_card = card(device)
    n = 36 if on_card else 14
    rng = np.random.default_rng(0)
    A = rng.uniform(0.2, 1.2, (n, n))
    spec = {} if on_card else dict(campaign_slices=16, campaign_lanes=64)
    out: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "campaign.npz")
        config = SolverConfig(
            precision="dq_acc", backend="cuda" if on_card else "torch",
            device=dev, preprocess=False, campaign_threshold=-1.0,
            campaign_checkpoint=ckpt, **spec)

        # 1. PLAN: the recorded slice decomposition, before any device work
        solver = PermanentSolver(config.replace(campaign_max_waves=2))
        solver.campaign_progress = lambda s, w: print(
            f"   wave checkpointed: {s.fraction_done():6.1%} done")
        plan = solver.plan(A)
        leaf = plan.leaves[0]
        print(f"1. plan: {plan.summary()}")
        print(f"   route={leaf.route} spec={leaf.campaign}")

        # 2.+3. RUN under a 2-wave budget, then get preempted
        print("2. running with a 2-wave budget ...")
        try:
            solver.execute(plan)
            raise AssertionError("expected the wave budget to preempt the run")
        except CampaignPaused as e:
            print(f"3. preempted: {e}")
            out["paused_at"] = e.state.fraction_done()

        # 4. RESUME: a fresh solver sharing nothing but the checkpoint file
        print("4. resuming from the checkpoint with a fresh solver ...")
        resumed = PermanentSolver(config)
        value = resumed.execute(resumed.plan(A))

    # 5. CHECK: bitwise against an uninterrupted campaign, close to the
    #    direct engine
    uninterrupted = PermanentSolver(config.replace(campaign_checkpoint=None))
    direct = uninterrupted.execute(uninterrupted.plan(A))
    engine = PermanentSolver(config.replace(campaign_checkpoint=None,
                                            campaign_threshold=None))
    oracle = engine.execute(engine.plan(A))
    bitwise = bool(np.float64(value) == np.float64(direct))
    rel = abs(value - oracle) / abs(oracle)
    print(f"5. perm(A)      = {value:+.17e}")
    print(f"   uninterrupted= {direct:+.17e}  bitwise: {bitwise}")
    print(f"   engine       = {oracle:+.17e}  rel.err: {rel:.2e}")
    assert bitwise
    assert rel < ENGINE_RTOL[on_card]
    print("OK")
    out.update(plan=plan.summary(), route=leaf.route, spec=leaf.campaign,
               value=value, uninterrupted=direct, engine=oracle,
               bitwise=bitwise, rel=rel)
    return out


if __name__ == "__main__":
    cli(main, __doc__)
