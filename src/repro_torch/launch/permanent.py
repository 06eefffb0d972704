"""SUperman CLI of the port: compute a matrix permanent on the card.

    python -m repro_torch.launch.permanent --n 30            # U(-1, 1), seed 0
    python -m repro_torch.launch.permanent --family allones --n 20 --value 0.5
    python -m repro_torch.launch.permanent --n 10 --device cpu --backend torch
    python -m repro_torch.launch.permanent --matrix m.npy   # real or complex
    python -m repro_torch.launch.permanent --sparse-n 12 --density 0.2
    python -m repro_torch.launch.permanent --family fibonacci --n 32 \
        --no-preprocess                                  # the sparse route
    python -m repro_torch.launch.permanent --n 40      # a campaign (n >= 31)
    python -m repro_torch.launch.permanent --n 14 --device cpu \
        --checkpoint job.npz --slices 32 --lanes 8       # forced, resumable
    python -m torch.distributed.run --standalone --nproc-per-node 2 \
        -m repro_torch.launch.permanent --backend distributed \
        --matrix m.npy --ranks-per-device 2   # the step space over 2 ranks

Matrix sources: --matrix <.npy>, --n <random dense>, --sparse-n/--density
(random sparse: U(0.5, 1.5) entries kept with probability --density),
--family allones|fibonacci (known-permanent families).

Runs from the repository root with ``PYTHONPATH=src``.  Prints the
``ExecutionPlan`` summary before dispatching (``--plan-json`` dumps the
whole plan), then ``perm(A) = %+.17e`` (``%+.17e %+.17ej`` for a complex
matrix), ``rel.err`` against the closed form for ``--family allones`` and
``OK``/``MISMATCH`` against F(n+1) for ``--family fibonacci``.  A leaf
beyond ``--campaign-threshold`` (2^34 steps by default: dense n >= 31)
runs as a resumable campaign; ``--checkpoint`` forces the route and
keeps its progress in a ``.npz`` that a rerun resumes.

``--backend distributed`` (the step space of a dense leaf over the ranks
of a ("data", "model") mesh) and ``distributed_batch`` (buckets over a
("data",) mesh) run under ``torchrun``, one process a rank, each rank's
body the CUDA kernels; ``--ranks-per-device`` lets several ranks share a
card.  Without ``torchrun`` they run as a world of one rank.  Only shard
0 prints.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..core.oracle import all_ones_permanent
from ..core.solver import PermanentSolver, SolverConfig
from . import mesh as mesh_lib

__all__ = ["permanent_main"]


def _load_matrix(args) -> np.ndarray:
    rng = np.random.default_rng(args.seed)
    if args.matrix:
        return np.load(args.matrix)
    if args.family == "allones":
        return np.full((args.n, args.n), args.value)
    if args.family == "fibonacci":
        # tridiagonal 0/1 matrix: perm = Fibonacci(n+1)  (Kilic & Tasci)
        i, j = np.indices((args.n, args.n))
        return (np.abs(i - j) <= 1).astype(np.float64)
    if args.sparse_n:
        n = args.sparse_n
        return rng.uniform(0.5, 1.5, (n, n)) \
            * (rng.uniform(0, 1, (n, n)) < args.density)
    return rng.uniform(-1, 1, (args.n, args.n))


def permanent_main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--matrix", help=".npy file with a square real or "
                    "complex matrix")
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--sparse-n", type=int, default=0,
                    help="size of a random sparse matrix")
    ap.add_argument("--density", type=float, default=0.3,
                    help="nonzero probability of --sparse-n")
    ap.add_argument("--family", choices=("allones", "fibonacci"),
                    help="known-permanent family (default: U(-1, 1))")
    ap.add_argument("--value", type=float, default=1.0,
                    help="entry of the allones family")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--precision", default="dq_acc",
                    choices=("dd", "dq_fast", "dq_acc", "qq", "kahan"))
    ap.add_argument("--backend", default="cuda",
                    choices=("cuda", "torch", "distributed",
                             "distributed_batch"))
    ap.add_argument("--ranks-per-device", type=int, default=1,
                    help="ranks that may share one card (distributed)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--chunks", type=int, default=4096,
                    help="chunk count of the torch engine")
    ap.add_argument("--plan-json", action="store_true",
                    help="dump the full ExecutionPlan as JSON first")
    ap.add_argument("--no-preprocess", action="store_true")
    ap.add_argument("--checkpoint", help="resumable job state (.npz); "
                    "forces the step_sharded campaign route")
    ap.add_argument("--campaign-threshold", type=float, default=None,
                    help="step-cost estimate above which a leaf becomes a "
                         "resumable campaign (default: forced with "
                         "--checkpoint, 2^34 otherwise)")
    ap.add_argument("--slices", type=int,
                    default=SolverConfig.campaign_slices,
                    help="campaign slice-count target (plan_slices)")
    ap.add_argument("--lanes", type=int,
                    default=SolverConfig.campaign_lanes,
                    help="campaign chunk-count target (plan_slices)")
    args = ap.parse_args(argv)
    if not args.backend.startswith("distributed"):
        return _run(args, None, print)
    with mesh_lib.world():
        kw = dict(device=args.device,
                  ranks_per_device=args.ranks_per_device)
        mesh = mesh_lib.make_local_mesh(**kw) \
            if args.backend == "distributed" else \
            mesh_lib.make_batch_mesh(**kw)
        return _run(args, mesh, print if mesh.index == 0
                    else lambda *a, **k: None)


def _run(args, mesh, print) -> int:
    """The CLI's work, over ``mesh`` when there is one; ``print`` is a
    no-op on every shard but 0."""
    A = _load_matrix(args)
    n = A.shape[0]
    print(f"[superman] n={n} nnz={int((A != 0).sum())} "
          f"density={(A != 0).mean():.2%} precision={args.precision} "
          f"backend={args.backend} device={args.device or 'cuda'}")
    t0 = time.perf_counter()
    threshold = args.campaign_threshold
    if threshold is None:
        # --checkpoint means "this run must be resumable" -> campaign
        threshold = -1.0 if args.checkpoint \
            else SolverConfig().campaign_threshold
    solver = PermanentSolver(SolverConfig(
        precision=args.precision, backend=args.backend,
        preprocess=not args.no_preprocess, num_chunks=args.chunks,
        device=args.device, cache=False, campaign_threshold=threshold,
        campaign_slices=args.slices, campaign_lanes=args.lanes,
        campaign_checkpoint=args.checkpoint), distributed_ctx=mesh)
    solver.campaign_progress = lambda s, _wave: print(
        f"[superman] {s.fraction_done():6.1%} done", flush=True)
    plan = solver.plan(A)
    print(f"[superman] {plan.summary()}")
    if args.plan_json:
        print(plan.json(indent=2))
    val, report = solver.execute(plan, return_report=True)
    dt = time.perf_counter() - t0
    if isinstance(val, complex):
        print(f"[superman] perm(A) = {val.real:+.17e} {val.imag:+.17e}j"
              f"   ({dt:.2f}s)")
    else:
        print(f"[superman] perm(A) = {val:+.17e}   ({dt:.2f}s)")
    print(f"[superman] dm_removed={report.dm_removed} "
          f"fm_leaves={report.fm_leaves} dispatch={report.dispatch[:6]}")
    if args.family == "allones":
        exact = all_ones_permanent(n, args.value)
        rel = abs(val - exact) / abs(exact)
        print(f"[superman] exact = {exact:+.17e}  rel.err = {rel:.2e}")
    if args.family == "fibonacci":
        fib = [1, 1]  # fib[k] == F(k+1)
        for _ in range(n):
            fib.append(fib[-1] + fib[-2])
        status = "OK" if round(val) == fib[n] else "MISMATCH"
        print(f"[superman] Fibonacci({n + 1}) = {fib[n]}  "
              f"(got {val:.1f})  {status}")
    return 0


if __name__ == "__main__":
    raise SystemExit(permanent_main())
