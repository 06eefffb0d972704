"""Serving CLI of the port: batched permanent serving on one card or
over the ranks of a ``torch.distributed`` world.

    python -m repro_torch.launch.serve --perm-n 20 --batch 32 --requests 256
    python -m repro_torch.launch.serve --soak --perm-n 24 --batch 64 \
        --rate 2000 --compile-cache kernel-cache --metrics-json soak.json
    python -m repro_torch.launch.serve --device cpu --backend torch --soak \
        --perm-n 8 --requests 24
    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m repro_torch.launch.serve --perm-n 20 --batch 32 --mesh 2x2 \
        --campaign 34 --ranks-per-device 4

Runs from the repository root with ``PYTHONPATH=src``.  Without ``--soak``
a synthetic request stream drains through a ``PermanentSolver``'s async
queue semantics (``run_permanent_serving``, the service in ``fill_first``
mode): submissions accumulate in size buckets and flush on size/deadline
triggers, repeated submatrices resolve from the result cache.  With
``--soak`` the continuous-batching service takes an open-loop Poisson
stream (``run_permanent_soak``).  ``--backend cuda`` (the default) runs
the CUDA kernels, ``torch`` the torch engines; ``--device`` defaults to
the card (``cpu`` runs the torch engines and the kernels' plain versions
on the host).

``--mesh N|auto`` (under ``torchrun``, or a world of one rank without
it) shards each bucket over a ("data",) mesh of the world's ranks and
implies ``--backend distributed``; ``--mesh BxS`` builds a
``CampaignMesh``: the buckets on its batch column, ``--campaign`` on its
step row.  Every rank runs this script; shard 0 admits and dispatches
and prints, the other ranks follow its broadcasts
(``PermanentService.follow``) and exit 0 after its "stop".
``--ranks-per-device`` lets several ranks share a card.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

__all__ = ["serve_main", "run_permanent_serving", "run_permanent_soak"]


def run_permanent_serving(*, n: int = 10, batch: int = 32,
                          requests: int = 128, density: float = 1.0,
                          precision: str = "dq_acc", backend: str = "cuda",
                          repeat_pool: int = 0, deadline_s: float = 0.05,
                          cache: bool = True, device: str | None = None,
                          mesh=None, complex_entries: bool = False,
                          seed: int = 0, campaign_matrix=None,
                          campaign_mesh=None, campaign_waves: int = 1,
                          campaign_checkpoint: str | None = None,
                          campaign_slices: int | None = None,
                          campaign_lanes: int | None = None):
    """Drain a synthetic permanent-request stream through the solver queue.

    ``requests`` random n x n matrices (dense, or sparse when
    ``density < 1``; complex when ``complex_entries`` -- the
    boson-sampling amplitude shape; drawn from a pool of ``repeat_pool``
    distinct matrices when > 0, the resampling shape) are submitted one
    by one to a ``PermanentSolver``'s async queue.  Size-bucketed
    accumulation flushes each bucket at depth ``batch`` (or after
    ``deadline_s``), so batches fill from the arrival stream instead of
    being hand-rolled; repeated submatrices resolve from the solver's
    content-hash result cache without touching the device.  Everything
    runs on ``device`` (None = the card).  With ``mesh`` set (a
    ``launch.mesh.Mesh``, or a ``CampaignMesh`` whose batch column takes
    the buckets; ``backend`` then becomes ``distributed``), flushed
    buckets are batch-axis sharded over its ranks; every rank calls this
    with the same arguments, shard 0 returns the stats below and the
    others ``{"follower": <PermanentService.follow()'s counts>}``.
    Returns perms/sec and per-flush latency stats; the first flush is
    reported separately.

    With ``campaign_matrix`` set, a long-running step-space campaign for
    that single huge matrix (checkpointed via ``campaign_checkpoint``)
    advances ``campaign_waves`` waves after every bucket flush (over
    ``campaign_mesh``, or the service's mesh), then runs to completion
    once the stream drains.  The result dict gains
    ``campaign_fraction`` / ``campaign_value``.

    A thin wrapper over :class:`repro_torch.serve.PermanentService` in
    ``fill_first`` mode (bucket quantization off), which reproduces the
    solver queue's flush composition exactly: each bucket reaches
    ``plan_batch`` with the same matrices in the same order, so results
    are bitwise identical to draining the solver queue directly.  The
    open-loop continuous-batching path is :func:`run_permanent_soak`.
    """
    from ..core.solver import SolverConfig
    from ..serve import (CampaignSpec, LaneSpec, PermanentService,
                         ServiceConfig)

    if batch < 1 or requests < 1:
        raise ValueError(f"need batch >= 1 and requests >= 1, got "
                         f"batch={batch} requests={requests}")
    backend = _mesh_backend(mesh, backend)
    rng = np.random.default_rng(seed)

    def draw():
        if density < 1.0:
            M = rng.uniform(0.5, 1.5, (n, n))
            if complex_entries:
                M = M + 1j * rng.uniform(0.5, 1.5, (n, n))
            return M * (rng.uniform(0, 1, (n, n)) < density)
        M = rng.uniform(-1, 1, (n, n))
        if complex_entries:
            M = M + 1j * rng.uniform(-1, 1, (n, n))
        return M

    if repeat_pool > 0:
        pool = [draw() for _ in range(repeat_pool)]
        mats = [pool[i] for i in rng.integers(0, repeat_pool, requests)]
    else:
        mats = [draw() for _ in range(requests)]

    campaign = None
    if campaign_matrix is not None:
        plan = {k: v for k, v in (("slices", campaign_slices),
                                  ("lanes", campaign_lanes)) if v is not None}
        campaign = CampaignSpec(matrix=campaign_matrix, mesh=campaign_mesh,
                                waves=campaign_waves,
                                checkpoint=campaign_checkpoint, **plan)
    svc = PermanentService(
        SolverConfig(precision=precision, backend=backend, cache=cache,
                     queue_max_batch=batch, queue_max_delay_s=deadline_s,
                     device=device),
        ServiceConfig(max_batch=batch, fill_first=True,
                      quantize_buckets=False, deadline_s=deadline_s,
                      lanes=(LaneSpec("default", 0, slo_s=None),),
                      max_queue_depth=2 ** 62, log_every_s=float("inf")),
        distributed_ctx=mesh, campaign=campaign, log=None)
    if not svc.leader:
        return {"follower": svc.follow()}
    with svc:
        return _drain_stream(svc, mats, complex_entries)


def _mesh_backend(mesh, backend: str) -> str:
    """A mesh implies the sharded bucket path, as the reference's
    CLI has it."""
    if mesh is not None and backend not in ("distributed",
                                            "distributed_batch"):
        return "distributed"
    return backend


def _drain_stream(svc, mats: list, complex_entries: bool) -> dict:
    """``run_permanent_serving``'s closed loop on shard 0."""
    tickets = []
    t_all = time.time()
    for M in mats:
        tickets.append(svc.submit(M, deadline_s=None))
        # one tick per arrival: in fill_first mode this dispatches only
        # full or deadline-aged buckets -- the solver queue's flush
        # triggers; the campaign advances after each dispatch
        svc.step()
    tail = svc.pending
    tail_s = 0.0
    if tail:
        t0 = time.time()
        svc.drain(finish_campaign=False)
        tail_s = time.time() - t0
    svc._advance_campaign(None)  # stream drained: finish the campaign
    total_s = time.time() - t_all
    values = np.array([t.result() for t in tickets], dtype=np.complex128)
    # steady state excludes the first dispatch (the cold one) and the
    # ragged tail
    lat = [(dt, served) for _, served, dt, trig in svc.dispatch_log
           if trig in ("size", "age")]
    steady = lat[1:] if len(lat) > 1 else lat
    steady_s = sum(s for s, _ in steady)
    steady_n = sum(c for _, c in steady)
    stats = svc.solver.stats()
    return {"values": values if complex_entries else np.real(values),
            "campaign_value": svc.campaign_value,
            "campaign_fraction": svc.campaign_fraction,
            "total_s": total_s,
            "compile_batch_s": lat[0][0] if lat else tail_s,
            "steady_batch_s": steady_s / max(1, len(steady)),
            "tail_s": tail_s,
            "perms_per_s": steady_n / steady_s if steady_s else 0.0,
            "batches": len(svc.dispatch_log),
            "cache": stats["cache"],
            "downgrades": stats["downgrades"],
            "device_dispatches": stats["device_dispatches"],
            "snapshot": svc.snapshot()}


def run_permanent_soak(*, n: int = 12, batch: int = 8, requests: int = 64,
                       rate_hz: float = 50.0, density: float = 1.0,
                       precision: str = "dq_acc", backend: str = "cuda",
                       repeat_pool: int = 8, complex_entries: bool = False,
                       seed: int = 0, device: str | None = None,
                       mesh=None, slo_ms: float | None = None,
                       compile_cache: str | None = None,
                       warmup: bool = True, expire_every: int = 0,
                       metrics_port: int | None = None,
                       metrics_json: str | None = None,
                       campaign_matrix=None, campaign_mesh=None,
                       campaign_waves: int = 1,
                       campaign_checkpoint: str | None = None,
                       log=print):
    """Open-loop soak of the continuous-batching service (``--soak``).

    Unlike :func:`run_permanent_serving` (closed-loop, solver-queue flush
    semantics), this drives :class:`repro_torch.serve.PermanentService`
    in continuous mode under Poisson arrivals at ``rate_hz``: partial
    buckets dispatch whenever the device is free, padded up the
    power-of-two ladder; lane SLOs shed late work with typed reasons;
    ``compile_cache``/``warmup`` give a cold process a first bucket
    without a kernel build or a first use of the host glue's operators.
    ``metrics_port`` serves the snapshot as JSON over HTTP while the soak
    runs; ``metrics_json`` writes the final snapshot to a file.
    Returns the ``run_soak`` dict (snapshot + tickets) and ``dispatch_s``,
    the host seconds of each dispatch in order.  ``mesh`` /
    ``campaign_mesh`` as in :func:`run_permanent_serving`: every rank
    calls this, and the followers get ``{"follower": ...}``.
    """
    from ..core.solver import SolverConfig
    from ..serve import (DEFAULT_LANES, CampaignSpec, LaneSpec,
                         PermanentService, ServiceConfig)

    backend = _mesh_backend(mesh, backend)
    if slo_ms is None:
        lanes = DEFAULT_LANES
    else:
        # one knob scales both lanes; bulk keeps its 15x-looser ratio
        lanes = (LaneSpec("interactive", 0, slo_s=slo_ms / 1e3),
                 LaneSpec("bulk", 1, slo_s=15 * slo_ms / 1e3))
    campaign = None
    if campaign_matrix is not None:
        campaign = CampaignSpec(matrix=campaign_matrix, mesh=campaign_mesh,
                                waves=campaign_waves,
                                checkpoint=campaign_checkpoint)
    svc = PermanentService(
        SolverConfig(precision=precision, backend=backend, device=device),
        ServiceConfig(max_batch=batch, lanes=lanes,
                      compile_cache_dir=compile_cache,
                      warmup_ns=(n,) if warmup else (),
                      warmup_complex=complex_entries, log_every_s=5.0),
        distributed_ctx=mesh, campaign=campaign, log=log)
    if not svc.leader:
        return {"follower": svc.follow()}
    with svc:
        return _soak(svc, log, metrics_port, metrics_json, requests=requests,
                     rate_hz=rate_hz, n=n, density=density,
                     complex_entries=complex_entries,
                     repeat_pool=repeat_pool, seed=seed,
                     expire_every=expire_every)


def _soak(svc, log, metrics_port, metrics_json, **soak) -> dict:
    """``run_permanent_soak``'s open loop on shard 0."""
    import json as _json

    from ..serve import run_soak, start_metrics_server
    if svc.warmup_report and log:
        wr = svc.warmup_report
        log(f"[serve] warmup: {wr['geometries']} geometries in "
            f"{wr['seconds']:.3f}s, compile cache {wr['compile']}")
    server = None
    if metrics_port is not None:
        server = start_metrics_server(svc.snapshot, port=metrics_port)
        if log:
            log(f"[serve] metrics on http://127.0.0.1:"
                f"{server.server_address[1]}/metrics")
    try:
        out = run_soak(svc, **soak)
    finally:
        if server is not None:
            server.shutdown()
    out["dispatch_s"] = [dt for _, _, dt, _ in svc.dispatch_log]
    if metrics_json:
        with open(metrics_json, "w") as f:
            _json.dump(out["snapshot"], f, indent=1)
    return out


def serve_main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    # --mode is kept for CLI compatibility with the reference's driver;
    # permanent is the only mode.
    ap.add_argument("--mode", choices=("permanent",), default="permanent")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--perm-n", type=int, default=10,
                    help="matrix size")
    ap.add_argument("--requests", type=int, default=128,
                    help="request stream length")
    ap.add_argument("--density", type=float, default=1.0,
                    help="nnz density of request matrices")
    ap.add_argument("--repeat-pool", type=int, default=0,
                    help="draw requests from this many distinct matrices "
                         "(0 = all distinct)")
    ap.add_argument("--complex", dest="complex_entries", action="store_true",
                    help="complex request matrices (boson-sampling "
                         "amplitudes)")
    ap.add_argument("--deadline-ms", type=float, default=50.0,
                    help="queue flush deadline")
    ap.add_argument("--no-cache", dest="cache", action="store_false",
                    help="disable the result cache")
    ap.add_argument("--precision", default="dq_acc")
    ap.add_argument("--backend", default="cuda",
                    choices=("cuda", "torch", "distributed",
                             "distributed_batch"),
                    help="cuda: the CUDA kernels (their plain versions on "
                         "the CPU); torch: the torch engines; distributed"
                         "(_batch): buckets sharded over the world's ranks, "
                         "the cuda body on each")
    ap.add_argument("--device", default=None,
                    help="where the leaves run (default: the card; 'cpu' "
                         "for the host)")
    ap.add_argument("--mesh", nargs="?", const="auto", default=None,
                    metavar="N|BxS",
                    help="shard buckets over an N-rank ('data',) mesh "
                         "(default: the world; implies --backend "
                         "distributed).  BxS (e.g. 2x2) builds a 2D "
                         "(batch x step) CampaignMesh: the batch column "
                         "serves buckets, the step row runs --campaign "
                         "waves.  Start the ranks with torchrun")
    ap.add_argument("--ranks-per-device", type=int, default=1,
                    help="ranks a card may hold (several ranks time-slice "
                         "one card)")
    ap.add_argument("--campaign", metavar="NPY|N", default=None,
                    help="advance a step-space campaign for this matrix "
                         "(.npy path, or an integer for a random NxN) "
                         "between bucket flushes")
    ap.add_argument("--campaign-checkpoint", default=None,
                    help="JobState .npz for the --campaign job")
    ap.add_argument("--campaign-waves", type=int, default=1,
                    help="campaign waves to run per bucket flush")
    ap.add_argument("--soak", action="store_true",
                    help="open-loop Poisson soak of the continuous-batching "
                         "service instead of the closed-loop queue drain")
    ap.add_argument("--rate", type=float, default=50.0,
                    help="soak: Poisson arrival rate (requests/s)")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="soak: interactive-lane SLO/deadline (default: "
                         "lane defaults, 2s interactive / 30s bulk)")
    ap.add_argument("--compile-cache", default=None, metavar="DIR",
                    help="soak: kernel library build root (a warm one "
                         "loads without nvcc)")
    ap.add_argument("--no-warmup", dest="warmup", action="store_false",
                    help="soak: skip the bucket warm-up pass")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="soak: serve the metrics snapshot as JSON on "
                         "this port (0 = ephemeral) while running")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="soak: write the final metrics snapshot here")
    args = ap.parse_args(argv)
    if args.mesh is not None:
        args.backend = _mesh_backend(args.mesh, args.backend)
    if not args.backend.startswith("distributed"):
        return _serve(args, None, None, print)
    from . import mesh as mesh_lib
    with mesh_lib.world():
        kw = dict(device=args.device, ranks_per_device=args.ranks_per_device)
        if args.mesh is not None and "x" in args.mesh.lower():
            b, st = (int(v) for v in args.mesh.lower().split("x"))
            cm = mesh_lib.make_campaign_mesh(b, st, **kw)
            mesh, campaign_mesh, lead = cm, cm.step_mesh, cm.mesh.index == 0
            note = (f"[serve] 2D campaign mesh {b}x{st}: buckets on the "
                    f"{b}-rank batch column, campaign waves on the "
                    f"{st}-rank step row")
        else:
            mesh = mesh_lib.make_batch_mesh(
                None if args.mesh in (None, "auto") else int(args.mesh), **kw)
            campaign_mesh, lead = None, mesh.index == 0
            note = (f"[serve] batch-sharding buckets over the {mesh.size}-"
                    f"rank mesh {mesh.axis_names}")
        out = print if lead else (lambda *a, **k: None)
        out(note)
        return _serve(args, mesh, campaign_mesh, out)


def _serve(args, mesh, campaign_mesh, print) -> int:
    """The CLI's work, over ``mesh`` when there is one; ``print`` is a
    no-op on every rank but shard 0, and those ranks follow shard 0's
    service until it stops."""
    campaign_matrix = None
    if args.campaign is not None:
        if args.campaign.isdigit():
            cn = int(args.campaign)
            campaign_matrix = np.random.default_rng(7).uniform(
                0.2, 1.2, (cn, cn))
        else:
            campaign_matrix = np.load(args.campaign)
        print(f"[serve] campaign: n={campaign_matrix.shape[0]} "
              f"ckpt={args.campaign_checkpoint} "
              f"waves/flush={args.campaign_waves}")
    if args.soak:
        out = run_permanent_soak(
            n=args.perm_n, batch=args.batch, requests=args.requests,
            rate_hz=args.rate, density=args.density,
            precision=args.precision, backend=args.backend,
            repeat_pool=args.repeat_pool or 8,
            complex_entries=args.complex_entries, device=args.device,
            mesh=mesh, slo_ms=args.slo_ms, compile_cache=args.compile_cache,
            warmup=args.warmup, metrics_port=args.metrics_port,
            metrics_json=args.metrics_json,
            campaign_matrix=campaign_matrix, campaign_mesh=campaign_mesh,
            campaign_waves=args.campaign_waves,
            campaign_checkpoint=args.campaign_checkpoint, log=print)
        if "follower" in out:
            return 0
        snap = out["snapshot"]
        req = snap["requests"]
        lat = snap["latency_s"]["overall"]
        print(f"[serve] soak: {req['admitted']} reqs @ "
              f"{args.rate:.0f}/s -> {req['completed']} done, "
              f"{req['shed_total']} shed {dict(req['shed'])}, "
              f"p50 {lat['p50'] * 1e3:.0f}ms p99 "
              f"{lat['p99'] * 1e3:.0f}ms, "
              f"{snap['dispatches']} dispatches (mean occupancy "
              f"{snap['bucket_occupancy']['mean']:.2f})")
        ds = out["dispatch_s"]
        if ds:
            print(f"[serve] dispatch: first {ds[0] * 1e3:.3f}ms, median "
                  f"{float(np.median(ds)) * 1e3:.3f}ms of {len(ds)}")
        if snap["campaign_fraction"] is not None:
            print(f"[serve] campaign: "
                  f"{snap['campaign_fraction']:.1%} done")
        return 0
    out = run_permanent_serving(
        n=args.perm_n, batch=args.batch, requests=args.requests,
        density=args.density, precision=args.precision,
        backend=args.backend, repeat_pool=args.repeat_pool,
        deadline_s=args.deadline_ms / 1e3, cache=args.cache,
        device=args.device, mesh=mesh, complex_entries=args.complex_entries,
        campaign_matrix=campaign_matrix, campaign_mesh=campaign_mesh,
        campaign_waves=args.campaign_waves,
        campaign_checkpoint=args.campaign_checkpoint)
    if "follower" in out:
        return 0
    print(f"[serve] permanents: {args.requests} "
          f"{'complex ' if args.complex_entries else ''}reqs "
          f"x n={args.perm_n} batch={args.batch} backend={args.backend}")
    if out["downgrades"]:
        print(f"[serve] downgrades: {len(out['downgrades'])} "
              f"(e.g. {out['downgrades'][0]})")
    print(f"[serve] first batch {out['compile_batch_s']:.3f}s, steady "
          f"{out['steady_batch_s'] * 1e3:.1f}ms/batch -> "
          f"{out['perms_per_s']:.0f} perms/s")
    if out["cache"]:
        print(f"[serve] cache: {out['cache']['hits']} hits / "
              f"{out['cache']['misses']} misses "
              f"(hit rate {out['cache']['hit_rate']:.1%}), "
              f"{out['device_dispatches']} device dispatches")
    if out["campaign_fraction"] is not None:
        cv = out["campaign_value"]
        vtxt = "pending" if cv is None else f"{cv:+.17e}"
        print(f"[serve] campaign: {out['campaign_fraction']:.1%} done, "
              f"perm = {vtxt}")
    return 0


if __name__ == "__main__":
    raise SystemExit(serve_main())
