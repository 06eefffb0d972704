"""Quickstart: compute matrix permanents the SUperman way, on the port.

    python -m repro_torch.examples.quickstart [--device cpu|cuda]

The port of ``examples/quickstart.py``: the plan/execute lifecycle of
``PermanentSolver`` (``solver.plan(A)`` reifies the paper's Alg.-4
dispatch as an inspectable, serializable ``ExecutionPlan``;
``solver.execute(plan)`` runs it through the backend registry and the
result cache), the ``submit``/``flush`` queue, precision modes, complex
input, the CUDA kernels against the torch engine, and stacked batches.
On the card the random dense matrix is 30 x 30 (kernel #1), the complex
one 28 x 28 (#3), the stack 256 x 24 (#2, timed with CUDA events after a
warm-up), the all-ones matrices n = 30; the sparse section adds a
permuted n = 32 band of degree 7 that DM/FM leave whole (#5).
"""

from __future__ import annotations

import time

import numpy as np

from ..core.engine import permanent, permanent_batch
from ..core.oracle import all_ones_permanent
from ..core.solver import PermanentSolver, SolverConfig
from . import card, cli

__all__ = ["main", "band_matrix"]


def band_matrix(n: int, degree: int, seed: int) -> np.ndarray:
    """A circulant band (column j's rows j .. j + degree - 1, mod n) with
    U(0.5, 1.5) entries, its rows and columns permuted: fully
    indecomposable, every line of ``degree`` nonzeros, so DM/FM leave it
    whole."""
    rng = np.random.default_rng(seed)
    A = np.zeros((n, n))
    for j in range(n):
        for o in range(degree):
            A[(j + o) % n, j] = rng.uniform(0.5, 1.5)
    return A[rng.permutation(n)][:, rng.permutation(n)]


def _stack_rate(stack, device: str, on_card: bool) -> tuple[float, np.ndarray]:
    """(perms/s, values) of one warm ``permanent_batch`` call."""
    vals = permanent_batch(stack, device=device)      # warm-up
    if on_card:
        import torch
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        vals = permanent_batch(stack, device=device)
        end.record()
        end.synchronize()
        return len(stack) / (start.elapsed_time(end) / 1e3), vals
    t0 = time.perf_counter()
    vals = permanent_batch(stack, device=device)
    return len(stack) / (time.perf_counter() - t0), vals


def main(device: str | None = None) -> dict:
    dev, on_card = card(device)
    n_rand, n_ones, n_cx, (b_stack, n_stack) = \
        (30, 30, 28, (256, 24)) if on_card else (16, 16, 12, (64, 8))
    out: dict = {}
    rng = np.random.default_rng(0)

    # --- 1. the plan/execute lifecycle -------------------------------------
    engine = "cuda" if on_card else "torch"
    solver = PermanentSolver(SolverConfig(precision="dq_acc", backend=engine,
                                          device=dev))
    A = rng.uniform(-1, 1, (n_rand, n_rand))
    plan = solver.plan(A)
    print(f"plan: {plan.summary()}")
    val = solver.execute(plan)
    print(f"perm(random {n_rand}x{n_rand})            = {val:+.12e}")
    out.update(plan=plan.summary(), perm_random=val)

    # --- 2. plans are inspectable and serializable ---------------------------
    S = rng.uniform(0.5, 1.5, (20, 20)) * (rng.uniform(0, 1, (20, 20)) < 0.25)
    splan = solver.plan(S)
    blob = splan.to_json()
    print(f"sparse 20x20 plan: {len(blob['leaves'])} leaves, "
          f"{len(blob['buckets'])} buckets, "
          f"est {blob['estimated_steps']:.3g} Ryser steps")
    v, report = solver.execute(splan, return_report=True)
    print(f"perm(sparse 20x20)            = {v:+.12e}")
    print(f"  DM removed {report.dm_removed} nonzeros; "
          f"Forbert-Marx left {report.fm_leaves} leaves "
          f"(sizes {report.leaf_sizes[:5]} ...)")
    out.update(sparse_leaves=len(blob["leaves"]), perm_sparse=v,
               dm_removed=report.dm_removed, fm_leaves=report.fm_leaves)
    if on_card:
        band = band_matrix(32, 7, seed=7)
        bplan = solver.plan(band)
        bv, brep = solver.execute(bplan, return_report=True)
        print(f"sparse 32x32 band plan: {bplan.summary()}")
        print(f"perm(band 32x32, degree 7)    = {bv:+.12e} "
              f"dispatch {brep.dispatch}")
        out.update(perm_band=bv, band_dispatch=brep.dispatch)

    # --- 3. the result cache: repeated submatrices skip the device ---------
    solver.execute(solver.plan(A))
    cs = solver.stats()["cache"]
    print(f"cache after re-solve: {cs['hits']} hits / {cs['misses']} misses "
          f"(hit rate {cs['hit_rate']:.0%})")
    out.update(cache_hits=cs["hits"], cache_misses=cs["misses"])

    # --- 4. the async request queue: serving traffic -----------------------
    # (the layer above this queue is repro_torch.serve.PermanentService;
    # see repro_torch.examples.service)
    qsolver = PermanentSolver(SolverConfig(queue_max_batch=4,
                                           queue_max_delay_s=0.5, device=dev))
    reqs = [qsolver.submit(rng.uniform(-1, 1, (8, 8))) for _ in range(10)]
    qsolver.flush()
    print(f"queued 10 requests -> {qsolver.flushes} batched flushes; "
          f"first value {reqs[0].result():+.6e}")
    out.update(flushes=qsolver.flushes, queue_first=reqs[0].result())

    # --- 5. precision modes (paper Table 3) --------------------------------
    B = np.full((n_ones, n_ones), 0.5)
    exact = all_ones_permanent(n_ones, 0.5)
    out["precision_rel"] = {}
    for mode in ("dd", "dq_acc", "kahan"):
        psolver = PermanentSolver(precision=mode, device=dev)
        v = psolver.execute(psolver.plan(B))
        rel = abs(v - exact) / exact
        print(f"perm(0.5 * ones) [{mode:7s}]   rel.err = {rel:.2e}")
        out["precision_rel"][mode] = rel

    # --- 6. complex matrices and the CUDA kernels ----------------------------
    C = rng.normal(size=(n_cx, n_cx)) + 1j * rng.normal(size=(n_cx, n_cx))
    vc = permanent(C, device=dev)
    print(f"perm(complex {n_cx}x{n_cx})           = {vc:+.6e}")
    if on_card:
        # the torch engine at n = 30: 2^20 chunks of 512 steps on the card
        v_cuda, v_torch = val, permanent(A, backend="torch", preprocess=False,
                                         num_chunks=1 << 20, device=dev)
    else:
        v_cuda, v_torch = permanent(A, backend="cuda", preprocess=False,
                                    device=dev), val
    print(f"cuda vs torch                 = {v_cuda:+.12e} "
          f"(delta {abs(v_cuda - v_torch):.2e})")
    out.update(perm_complex=vc, cuda=v_cuda, torch=v_torch)

    # --- 7. one-shot wrappers + batched stacks ------------------------------
    M = np.array([[1, 1, 0, 0],
                  [1, 1, 1, 0],
                  [0, 1, 1, 1],
                  [0, 0, 1, 1]], dtype=float)
    matchings = round(permanent(M, device=dev))
    print(f"perfect matchings of the path-ish graph = {matchings}")
    stack = rng.uniform(-1, 1, (b_stack, n_stack, n_stack))
    rate, vals = _stack_rate(stack, dev, on_card)
    print(f"perm of {b_stack} stacked {n_stack}x{n_stack} in one dispatch: "
          f"{rate:,.0f} perms/s (first: {vals[0]:+.6e})")
    out.update(matchings=matchings, stack_perms_s=rate,
               stack_first=float(vals[0]))
    return out


if __name__ == "__main__":
    cli(main, __doc__)
