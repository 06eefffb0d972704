"""Campaign CLI of the port: one large permanent as a resumable job.

    python -m repro_torch.launch.campaign --n 40 \
        --checkpoint job.npz                  # run until done (or killed)
    python -m repro_torch.launch.campaign --n 40 \
        --checkpoint job.npz                  # ... rerun: resumes
    python -m repro_torch.launch.campaign --n 40 \
        --checkpoint job.npz --max-waves 4    # budgeted: exit 3 if pending
    python -m repro_torch.launch.campaign --n 14 --device cpu \
        --slices 32 --lanes 8 --checkpoint /tmp/c.npz
    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m repro_torch.launch.campaign --matrix m.npy --checkpoint job.npz \
        --ranks-per-device 4                  # waves over 4 ranks, 1 card

Runs from the repository root with ``PYTHONPATH=src``.  The run goes
through the plan/execute stack: the planner routes the matrix to the
``step_sharded`` campaign route (``--threshold`` is -1 by default, so even
a small matrix campaigns), the executor's ``CampaignBackend`` runs waves
of slices (``core/distributed.py::run_campaign``) on the card (``--backend
cuda``, the default: the scalar CUDA entry from a u64 chunk base) or
through the torch engine (``--backend torch``), and checkpoints after
every wave.  One ``[campaign] wave`` line is printed per wave -- its
slice ids, the wave width W (enough slices to fill the card; 1 on the
CPU), its kernel milliseconds (CUDA events; ``-`` off the card), host and
save milliseconds -- AFTER the checkpoint is on disk: a SIGKILL any time
after the first such line loses at most the wave in flight, and the
resumed run prints the same ``perm(A) = %+.17e`` as an uninterrupted one,
on any device.

Under ``torchrun`` the waves span the world's ranks (a ("step",) mesh,
``launch/mesh.py``; ``--ranks-per-device`` lets several share a card):
a wave is D x W slices, shard 0 writes the checkpoint and prints, and a
checkpoint resumes under any world size, or on one device, to the same
bits.

Exit codes: 0 value printed, 3 paused by ``--max-waves`` with slices
pending (every rank; ``torchrun`` then reports the workers as failed).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..core import distributed as Dm
from ..core.solver import PermanentSolver, SolverConfig
from . import mesh as mesh_lib

__all__ = ["campaign_main"]


def _load_matrix(args) -> np.ndarray:
    rng = np.random.default_rng(args.seed)
    if args.matrix:
        return np.load(args.matrix)
    if args.family == "allones":
        return np.full((args.n, args.n), 1.0)
    if args.family == "fibonacci":
        i, j = np.indices((args.n, args.n))
        return (np.abs(i - j) <= 1).astype(np.float64)
    A = rng.uniform(0.2, 1.2, (args.n, args.n))
    if args.complex:
        A = A + 1j * rng.uniform(0.2, 1.2, (args.n, args.n))
    return A


def campaign_main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--matrix", help=".npy file with a square matrix")
    ap.add_argument("--n", type=int, default=20)
    ap.add_argument("--family", choices=("allones", "fibonacci"))
    ap.add_argument("--complex", action="store_true",
                    help="random complex matrix (with --n)")
    ap.add_argument("--checkpoint", required=True,
                    help="JobState .npz (created, appended, resumed)")
    ap.add_argument("--precision", default="dq_acc",
                    choices=("dd", "dq_fast", "dq_acc", "qq", "kahan"))
    ap.add_argument("--backend", default="cuda", choices=("cuda", "torch"),
                    help="wave body: the CUDA kernels or the torch engine")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--slices", type=int,
                    default=SolverConfig.campaign_slices,
                    help="slice-count target (plan_slices)")
    ap.add_argument("--lanes", type=int,
                    default=SolverConfig.campaign_lanes,
                    help="chunk-count target (plan_slices)")
    ap.add_argument("--max-waves", type=int, default=None,
                    help="pause (exit 3) after this many waves")
    ap.add_argument("--threshold", type=float, default=-1.0,
                    help="campaign_threshold (default -1: always campaign)")
    ap.add_argument("--preprocess", action="store_true",
                    help="enable DM/FM (default off: campaign the matrix "
                         "as-is so the checkpoint geometry is the whole "
                         "step space)")
    ap.add_argument("--plan-json", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ranks-per-device", type=int, default=1,
                    help="under torchrun: ranks that may share one card")
    args = ap.parse_args(argv)
    if not mesh_lib.launched_by_torchrun():
        return _run(args, None, print)
    with mesh_lib.world():
        mesh = mesh_lib.make_mesh(
            (mesh_lib.world_size(),), ("step",), device=args.device,
            ranks_per_device=args.ranks_per_device)
        return _run(args, mesh, print if mesh.index == 0
                    else lambda *a, **k: None)


def _run(args, mesh, print) -> int:
    """The CLI's work, its waves over ``mesh`` when there is one;
    ``print`` is a no-op on every shard but 0."""
    A = _load_matrix(args)
    n = A.shape[0]
    solver = PermanentSolver(SolverConfig(
        precision=args.precision, backend=args.backend,
        preprocess=args.preprocess, device=args.device,
        campaign_threshold=args.threshold,
        campaign_slices=args.slices, campaign_lanes=args.lanes,
        campaign_checkpoint=args.checkpoint,
        campaign_max_waves=args.max_waves), distributed_ctx=mesh)
    t0 = time.perf_counter()

    def progress(state, wave):
        # printed AFTER the wave's checkpoint hit disk: the kill/resume
        # tests SIGKILL on the first of these lines knowing the recorded
        # progress is durable
        kernel = "-" if wave.kernel_s is None \
            else f"{wave.kernel_s * 1e3:.3f}"
        print(f"[campaign] wave ids={wave.ids_text()} W={wave.width} "
              f"launches={wave.launches} kernel_ms={kernel} "
              f"host_ms={wave.host_s * 1e3:.3f} "
              f"save_ms={wave.save_s * 1e3:.3f} "
              f"done={state.fraction_done():.4f} "
              f"pending={len(state.pending_slices())} "
              f"t={time.perf_counter() - t0:.2f}s", flush=True)

    solver.campaign_progress = progress
    plan = solver.plan(A)
    print(f"[campaign] n={n} device={args.device or 'cuda'} "
          f"{plan.summary()}", flush=True)
    if mesh is not None:
        print(f"[campaign] {mesh.describe()}", flush=True)
    if args.plan_json:
        print(plan.json(indent=2), flush=True)

    try:
        val = solver.execute(plan)
    except Dm.CampaignPaused as e:
        print(f"[campaign] paused: {e}", flush=True)
        return 3
    dt = time.perf_counter() - t0
    # %.17e round-trips float64 exactly: the kill/resume tests compare
    # these printed values as strings
    if isinstance(val, complex):
        print(f"[campaign] perm(A) = {val.real:+.17e} {val.imag:+.17e}j"
              f"   ({dt:.2f}s)", flush=True)
    else:
        print(f"[campaign] perm(A) = {val:+.17e}   ({dt:.2f}s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(campaign_main())
