"""Always-on permanent service: vLLM-style continuous batching.

The port of the reference package's ``serve/loop.py`` over the port's
solver, on one card (``SolverConfig.device``, None = the card) or over
the ranks of a ``torch.distributed`` world (``distributed_ctx``, below).
Its buckets launch the batch entries of the CUDA kernels (dense real and
complex, sparse real and complex) under the ``cuda`` backend, or the
torch engines under ``torch``; an interleaved campaign launches the
scalar entries from a u64 chunk base as its wave body.

The solver's own queue flushes a size bucket when it fills or its
oldest request ages out -- between triggers the device idles even with
work queued.  :class:`PermanentService` inverts that: a synchronous loop
(``submit`` / ``step`` / ``drain``) that dispatches whenever the device
is free, filling each dispatch with whatever compatible work is queued
-- batches form from requests that arrived *during* the previous
dispatch, not from waiting out a deadline.  On top of admission it adds
the production concerns the solver queue has no opinion on:

* **Priority lanes + per-request deadlines** (``serve/lanes.py``): an
  interactive request never waits behind bulk traffic of the same
  shape, bulk backfills interactive buckets' spare slots, and a request
  queued past its deadline is shed -- typed, never silently dropped.
* **Backpressure**: admission refuses work (``ShedReason.QUEUE_FULL`` /
  ``COST_BUDGET``) when queue depth or the summed Ryser step-cost
  estimate of queued work exceeds budget.  ``submit`` never raises --
  the returned ticket carries the typed reason and ``result()`` raises
  :class:`~repro_torch.serve.lanes.ShedError`.
* **Bounded bucket shapes**: dispatched buckets are padded up to a
  power-of-two ladder (``quantize_buckets``) with *distinct* random
  filler matrices -- distinct because the executor dedups repeated
  leaves within a batch and the result cache would swallow repeats
  across batches, either of which would shrink the device batch back to
  an unquantized shape.  Together with the kernel-library cache and a
  warm-up pass over the ladder (``serve/compile_cache.py``), a cold
  process serves its first bucket without building a kernel or paying
  the first use of the host glue's operators.
* **Observability** (``serve/metrics.py``): every admit/shed/complete/
  dispatch lands in one snapshot schema; ``step`` prints a periodic
  one-line summary.
* **Campaign interleaving**: a :class:`CampaignSpec` threads a
  step-space campaign (``core/distributed.py::run_campaign``) through the
  loop -- waves advance after each bucket dispatch, and ``drain`` runs
  the campaign to completion.
* **Over a mesh** (``distributed_ctx``: a ``launch.mesh.Mesh``, whose
  ranks shard each bucket under the ``distributed`` backends, or a
  ``CampaignMesh``, whose batch column serves the buckets and whose step
  row runs the campaign): every rank constructs the service with the
  same arguments, and shard 0 of the mesh is the reference's one
  process.  It alone admits, sheds, picks each bucket and keeps the
  tickets and metrics; before each dispatch it broadcasts what the
  others need to run it (``broadcast_object_list`` over the mesh's
  group: the bucket's matrices in order with the padding fillers it drew,
  its key and trigger, and the campaign waves to advance after it; then
  "campaign" and "stop" messages).  The other ranks call :meth:`follow`,
  which runs each broadcast until "stop": every rank then calls
  ``plan_batch`` / ``execute`` on the same matrices through the same
  solver config and result cache, so the mesh functions see identical
  calls.  A dispatch that fails fails on every rank (the mesh
  functions' ok flags): shard 0 sheds its tickets (``DISPATCH_FAILED``,
  with the error) and every rank goes on to the next broadcast.  The
  followers wait in a gloo collective, which gives up after
  ``launch.mesh.DEFAULT_TIMEOUT_S``; an idle shard 0 sends a keep-alive
  from :meth:`step` every ``KEEPALIVE_S``, and a follower that hears
  nothing for the timeout raises.  Shard 0 ends the world with
  :meth:`stop` (or by leaving ``with service:``).

``fill_first=True`` pins the loop to the solver-queue semantics
(dispatch only full or deadline-aged buckets, no shedding, no padding);
``launch/serve.py``'s ``run_permanent_serving`` runs in that mode and is
bitwise-identical to draining the solver queue directly, because a
bucket then reaches ``plan_batch`` with exactly the same matrices in the
same order.

All timing flows through one injected monotonic clock (tests pass a
fake; deadlines, latencies, and log cadence are then deterministic).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Sequence

import numpy as np

from ..core.planner import SolverConfig, campaign_spec
from .compile_cache import (compile_stats, enable_compile_cache,
                            quantized_batches, warmup)
from .lanes import (DEFAULT_LANES, LaneQueue, LaneSpec, ServeTicket,
                    ShedReason)
from .metrics import ServeMetrics

__all__ = ["ServiceConfig", "CampaignSpec", "PermanentService", "run_soak"]

_LANE_DEFAULT = object()      # submit(): "use the lane's slo_s as deadline"
# an idle shard 0 broadcasts a keep-alive this often (host seconds), far
# inside the gloo groups' DEFAULT_TIMEOUT_S
KEEPALIVE_S = 60.0


@dataclass(frozen=True)
class ServiceConfig:
    """Admission + dispatch policy for one :class:`PermanentService`.

    The numeric solver knobs (precision, backend, device, result cache)
    live in :class:`~repro_torch.core.planner.SolverConfig`; this holds
    only the service-side policy.
    """
    max_batch: int = 32                  # bucket capacity per dispatch
    lanes: tuple[LaneSpec, ...] = DEFAULT_LANES
    max_queue_depth: int = 4096          # admission: depth backpressure
    max_pending_cost: float = float("inf")  # admission: step-cost budget
    quantize_buckets: bool = True        # pad dispatches to the pow2 ladder
    fill_first: bool = False             # solver-queue flush semantics
    deadline_s: float = 0.05             # fill_first: bucket age-out trigger
    log_every_s: float = 10.0            # periodic log-line cadence
    compile_cache_dir: str | None = None  # kernel library build root
    warmup_ns: tuple[int, ...] = ()      # warm these matrix sizes ...
    warmup_complex: bool = False         # ... (optionally x complex) x ladder


@dataclass
class CampaignSpec:
    """A step-space campaign interleaved with serving: ``waves``
    checkpointed waves advance after every bucket dispatch, and the
    campaign runs to completion when the request stream drains.  A wave
    is as wide as ``run_campaign`` makes it on the card.  ``slices``
    defaults to the port's ``SolverConfig.campaign_slices`` (1024: a
    card-filling wave is 1/16 of a job; the reference's 64 would be one
    wave on one H100).  ``mesh`` is the ("step",) mesh the waves run over
    (``run_campaign(mesh=)``); None means the service's mesh -- the step
    row of a ``CampaignMesh``, else every rank of the service's mesh --
    or one device when the service has none."""
    matrix: Any
    mesh: Any = None                     # step mesh (None = the service's)
    waves: int = 1                       # waves per bucket dispatch
    checkpoint: str | None = None        # JobState .npz path
    slices: int = SolverConfig.campaign_slices
    lanes: int = SolverConfig.campaign_lanes


def _layout(ctx, spec: CampaignSpec | None):
    """(world, bucket ranks, bucket ctx, step ranks, step mesh) of a
    service: the mesh whose ranks follow shard 0's broadcasts, the ranks
    that run the buckets and the ctx their solver gets, the ranks that run
    the campaign waves and the mesh they run over.  None without a mesh
    anywhere (one device, as the reference's service on one device)."""
    from ..launch.mesh import ctx_mesh
    step = spec.mesh if spec is not None else None
    if ctx is None:
        if step is None:
            return None
        # buckets on shard 0 alone, the campaign over its mesh
        return step, step.ranks[:1].ravel(), None, step.ranks.ravel(), step
    if hasattr(ctx, "batch_mesh") and hasattr(ctx, "step_mesh"):
        if step is not None and step is not ctx.step_mesh:
            raise ValueError("a campaign under a CampaignMesh runs on its "
                             "step_mesh; pass CampaignSpec(mesh=None)")
        grid = ctx.mesh.ranks
        return (ctx.mesh, grid[:, 0], ctx.batch_mesh, grid[0, :],
                ctx.step_mesh)
    world = ctx_mesh(ctx)
    step = step or world
    return world, world.ranks.ravel(), ctx, step.ranks.ravel(), step


class PermanentService:
    """The always-on loop: admission -> lanes -> bucket dispatch.

    Single-threaded by design: ``submit`` only admits (constant-time
    bookkeeping), ``step`` does at most one bucket dispatch, ``drain``
    steps until the queue is empty.  Callers own the thread; an open
    loop is ``run_soak``, a closed one is ``ticket.result()`` after
    ``drain()``.  Over a mesh (``distributed_ctx``; see the module
    docstring) the caller does that on shard 0 (``leader``) and calls
    :meth:`stop` when done, and every other rank calls :meth:`follow`.
    """

    def __init__(self, solver_config=None, service: ServiceConfig | None = None,
                 *, distributed_ctx: Any | None = None,
                 campaign: CampaignSpec | None = None,
                 clock: Callable[[], float] | None = None,
                 log: Callable[[str], None] = print,
                 filler_seed: int = 0x5eed):
        from ..core.ryser import resolve_device
        from ..core.solver import PermanentSolver

        self.scfg = service or ServiceConfig()
        if self.scfg.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got "
                             f"{self.scfg.max_batch}")
        solver_config = solver_config or SolverConfig()
        # a service asked for the card on a machine without one raises here
        resolve_device(solver_config.device)
        self._clock = clock if clock is not None \
            else (solver_config.clock or time.monotonic)  # permlint: disable=PL004  # sanctioned injectable-clock default  # torchlint: disable=PT004 the injectable clock's default
        self._log = log
        self._queue = LaneQueue(self.scfg.lanes)
        self.metrics = ServeMetrics(self._clock,
                                    lanes=tuple(l.name
                                                for l in self._queue.lanes))
        # filler matrices for pow2 padding; its own stream so padding
        # never perturbs caller-visible randomness
        self._filler_rng = np.random.default_rng(filler_seed)
        self._ladder = quantized_batches(self.scfg.max_batch)
        # (key, served, plan+execute seconds, trigger) per dispatch --
        # the wrapper in launch/serve.py derives its latency report here
        self.dispatch_log: list[tuple[tuple, int, float, str]] = []

        layout = _layout(distributed_ctx, campaign)
        self._world = None if layout is None else layout[0]
        if layout is not None:
            import torch.distributed as dist
            me = dist.get_rank()
        self.leader = layout is None or self._world.index == 0
        self._bucket_role = layout is None or me in layout[1]
        self._step_role = layout is None or me in layout[3]
        self._step_mesh = None if layout is None else layout[4]
        bucket_ctx = None if layout is None else layout[2]
        self._last_send = time.perf_counter()
        self._stopped = False
        if layout is not None:
            from ..core.distributed import input_guard
            # every rank must describe the same service, or the
            # collectives below would pair up wrongly
            input_guard(self._world, "PermanentService",
                        repr(solver_config), repr(self.scfg),
                        [int(r) for r in layout[1]],
                        [int(r) for r in layout[3]],
                        None if campaign is None else (
                            np.asarray(campaign.matrix), campaign.waves,
                            campaign.slices, campaign.lanes))

        if self.scfg.compile_cache_dir:
            enable_compile_cache(self.scfg.compile_cache_dir)
        self.solver = PermanentSolver(solver_config,
                                      distributed_ctx=bucket_ctx,
                                      clock=self._clock)
        self.warmup_report: dict | None = None
        if self.scfg.warmup_ns and self._bucket_role:
            batches = self._ladder if self.scfg.quantize_buckets \
                else (self.scfg.max_batch,)
            geoms = [(n, b, c)
                     for n in self.scfg.warmup_ns
                     for b in batches
                     for c in ((False, True) if self.scfg.warmup_complex
                               else (False,))]
            self.warmup_report = warmup(solver_config, geoms,
                                        distributed_ctx=bucket_ctx)

        self._campaign = campaign
        self._camp_state: dict = {"state": None, "value": None}

    # -- campaign interleaving ----------------------------------------------

    def campaign_body(self) -> dict:
        """The ``run_campaign`` keywords of the interleaved campaign: the
        ``CampaignSpec`` the planner's campaign route builds for its matrix
        under the solver config at the campaign's ``slices`` x ``lanes``
        (``planner.campaign_spec``), on the config's device."""
        cfg = self.solver.config
        cmat = np.asarray(self._campaign.matrix)
        spec = campaign_spec(
            cfg.replace(campaign_slices=self._campaign.slices,
                        campaign_lanes=self._campaign.lanes),
            cmat.shape[0], float(np.count_nonzero(cmat)) / cmat.size,
            cmat.dtype.str, cfg.precision)
        return dict(vars(spec), device=cfg.device)

    def _campaign_open(self) -> bool:
        return self._campaign is not None and \
            self._camp_state["value"] is None

    def _advance_campaign(self, waves: int | None) -> None:
        """Run up to ``waves`` campaign waves (None = to completion);
        state threads across calls so each dispatch resumes in place.
        Over a mesh shard 0 broadcasts the order first; to completion goes
        one wave a broadcast, so no follower waits longer than a wave."""
        if not self._campaign_open():
            return
        if self._world is None:
            self._campaign_waves(waves)
            return
        self._check_leader("_advance_campaign")
        while self._campaign_open():
            self._send(("campaign", waves or 1))
            self._campaign_waves(waves or 1)
            if waves is not None:
                return

    def _campaign_waves(self, waves: int | None) -> None:
        """This rank's part of ``waves`` campaign waves: the step ranks
        run them over the step mesh, the others nothing."""
        if not self._step_role or not self._campaign_open():
            return
        from ..core import distributed
        val, st = distributed.run_campaign(
            np.asarray(self._campaign.matrix), **self.campaign_body(),
            checkpoint_path=self._campaign.checkpoint,
            state=self._camp_state["state"], max_waves=waves,
            mesh=self._step_mesh)
        self._camp_state["state"], self._camp_state["value"] = st, val

    @property
    def campaign_value(self):
        return self._camp_state["value"]

    # -- over a mesh -----------------------------------------------------------

    def _check_leader(self, what: str) -> None:
        if not self.leader:
            raise RuntimeError(f"{what}: this rank follows shard 0 of the "
                               "service's mesh; call follow() here")

    def _send(self, msg: tuple) -> tuple:
        """Broadcast ``msg`` from shard 0 to every rank of the mesh; the
        message as received (every rank calls this; shard 0 passes it)."""
        import torch.distributed as dist
        box = [msg]
        dist.broadcast_object_list(box, src=self._world.root,
                                   group=self._world.group)
        self._last_send = time.perf_counter()
        return box[0]

    def _bucket(self, mats: list):
        """This rank's part of a dispatch: ``(values, error, seconds)``,
        the bucket through the solver on the bucket ranks (an error
        caught: on a mesh every rank sees the same one), nothing
        elsewhere."""
        if not self._bucket_role:
            return None, None, 0.0
        t0 = time.perf_counter()
        try:
            out = self.solver.execute(self.solver.plan_batch(mats))
            err = None
        except Exception as e:  # shed as DISPATCH_FAILED, never dropped
            out, err = None, e
        return out, err, time.perf_counter() - t0

    def follow(self) -> dict:
        """Every rank but shard 0 of a service over a mesh: run shard 0's
        broadcasts -- each dispatch's bucket and campaign waves, campaign
        orders, keep-alives -- until "stop".  Returns ``{"dispatches",
        "failed", "keepalives"}``.  A failed dispatch is the shed shard 0
        reports; a campaign error is raised after "stop" (shard 0 raised
        it to its caller too); a shard 0 that sends nothing for the
        group's timeout raises ``RuntimeError`` here."""
        if self._world is None or self.leader:
            raise RuntimeError("follow() runs on the ranks of a service's "
                               "mesh other than shard 0")
        from ..launch.mesh import DEFAULT_TIMEOUT_S
        seen = {"dispatches": 0, "failed": 0, "keepalives": 0}
        camp_err = None
        while True:
            try:
                msg = self._send(None)
            except RuntimeError as e:
                raise RuntimeError(
                    f"service follower: no broadcast from shard 0 within "
                    f"the group's {DEFAULT_TIMEOUT_S:.0f} s (shard 0 must "
                    f"step() or stop()): {e}") from e
            kind = msg[0]
            if kind == "stop":
                break
            if kind == "idle":
                seen["keepalives"] += 1
                continue
            if kind == "dispatch":
                _, key, trigger, mats, served, waves = msg
                _, err, dt = self._bucket(mats)
                seen["dispatches"] += 1
                if err is not None:
                    seen["failed"] += 1
                    if self._log is not None:
                        self._log(f"[serve] dispatch {key} failed on this "
                                  f"rank too: {type(err).__name__}: {err}")
                self.dispatch_log.append((key, served, dt, trigger))
            else:                       # ("campaign", waves)
                waves = msg[1]
            try:
                if waves:
                    self._campaign_waves(waves)
            except Exception as e:  # raised after "stop", as on shard 0
                camp_err = camp_err or e
        if camp_err is not None:
            raise camp_err
        return seen

    def stop(self) -> None:
        """Shard 0: send "stop", ending every follower's :meth:`follow`
        (once; later calls do nothing).  Without a mesh, and on the
        followers, nothing."""
        if self._world is not None and self.leader and not self._stopped:
            self._stopped = True
            self._send(("stop",))

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def campaign_fraction(self) -> float | None:
        st = self._camp_state["state"]
        if st is not None:
            return st.fraction_done()
        return None if self._campaign is None else 0.0

    # -- admission -----------------------------------------------------------

    @property
    def pending(self) -> int:
        return self._queue.depth

    def submit(self, A, *, lane: str | None = None,
               deadline_s=_LANE_DEFAULT,
               t_submit: float | None = None) -> ServeTicket:
        """Admit one matrix; returns a :class:`ServeTicket` immediately.

        Never raises on load: a refused request comes back as a ticket
        already shed with a typed reason (``QUEUE_FULL`` when depth is at
        ``max_queue_depth``, ``COST_BUDGET`` when the queued step-cost
        estimate would exceed ``max_pending_cost``).  ``deadline_s`` is
        relative to admission; defaults to the lane's ``slo_s``; pass
        ``None`` for no deadline.  ``t_submit`` backdates admission to an
        arrival time (open-loop drivers), so queueing latency counts
        from arrival, not from the submit call.
        """
        self._check_leader("submit")
        A = np.asarray(A)
        if A.ndim != 2 or A.shape[0] != A.shape[1]:
            raise ValueError(f"square matrix required, got {A.shape}")
        now = self._clock()
        t_sub = now if t_submit is None else t_submit
        lane_spec = self._queue.lane(lane)
        if deadline_s is _LANE_DEFAULT:
            deadline_s = lane_spec.slo_s
        deadline = None if deadline_s is None else t_sub + deadline_s
        ticket = ServeTicket(A, lane_spec, t_sub, deadline)
        self.metrics.record_admit(ticket)
        if self._queue.depth >= self.scfg.max_queue_depth:
            ticket._shed(ShedReason.QUEUE_FULL,
                         f"queue depth {self._queue.depth} at limit "
                         f"{self.scfg.max_queue_depth}", now)
            self.metrics.record_shed(ticket)
            return ticket
        if self._queue.pending_cost + ticket.cost > \
                self.scfg.max_pending_cost:
            ticket._shed(ShedReason.COST_BUDGET,
                         f"queued step-cost {self._queue.pending_cost:.3g} "
                         f"+ {ticket.cost:.3g} exceeds budget "
                         f"{self.scfg.max_pending_cost:.3g}", now)
            self.metrics.record_shed(ticket)
            return ticket
        self._queue.admit(ticket)
        return ticket

    # -- the loop ------------------------------------------------------------

    def step(self) -> int:
        """One loop tick: shed expired work, then dispatch at most one
        bucket.  Returns the number of tickets resolved (0 = nothing
        ready).  Over a mesh an idle step past ``KEEPALIVE_S`` since the
        last broadcast sends a keep-alive."""
        self._check_leader("step")
        now = self._clock()
        for t in self._queue.shed_expired(now):
            t._shed(ShedReason.DEADLINE_EXPIRED,
                    f"queued past deadline by {now - t.deadline:.3g}s",
                    now)
            self.metrics.record_shed(t)
        self.metrics.sample_queue_depth(self._queue.depth)
        key, trigger = self._pick_bucket(now)
        served = self._dispatch(key, trigger) if key is not None else 0
        if key is None and self._world is not None and \
                time.perf_counter() - self._last_send >= KEEPALIVE_S:
            self._send(("idle",))
        if self._log is not None \
                and self.metrics.should_log(self.scfg.log_every_s):
            self._log(self.metrics.log_line(
                pending=self._queue.depth,
                cache_hit_rate=self._cache_hit_rate(),
                campaign_fraction=self.campaign_fraction))
        return served

    def drain(self, *, finish_campaign: bool = True) -> int:
        """Step until the queue is empty (every ticket resolved or shed);
        then run any interleaved campaign to completion.  Returns the
        number of tickets resolved."""
        self._check_leader("drain")
        total = 0
        while self._queue.depth:
            served = self.step()
            if served == 0 and self._queue.depth:
                # fill_first tail: a partial bucket never meets the
                # size/age trigger -- the drain forces the raggeds out
                ready = self._queue.ready_keys(self._clock())
                if not ready:
                    break
                _, _, key = ready[0]
                served = self._dispatch(key, "drain")
            total += served
        if finish_campaign:
            self._advance_campaign(None)
        return total

    def shutdown(self) -> list[ServeTicket]:
        """Shed everything still queued (typed ``SHUTDOWN``) and, over a
        mesh, :meth:`stop` the followers; returns the shed tickets."""
        self._check_leader("shutdown")
        now = self._clock()
        out = self._queue.drain_all()
        for t in out:
            t._shed(ShedReason.SHUTDOWN, "service shut down with work "
                    "queued", now)
            self.metrics.record_shed(t)
        self.stop()
        return out

    def _pick_bucket(self, now: float):
        ready = self._queue.ready_keys(now)
        if not ready:
            return None, None
        if not self.scfg.fill_first:
            # continuous batching: the device is free (we are being
            # stepped), so serve the most urgent bucket at whatever
            # depth it has
            _, _, key = ready[0]
            return key, "ready"
        # solver-queue semantics: only full or deadline-aged buckets.
        # Scan every key -- a full bucket must dispatch even when a
        # non-full, older one sorts ahead of it.
        for _, t_oldest, key in ready:
            if self._queue.key_depth(key) >= self.scfg.max_batch:
                return key, "size"
            if now - t_oldest >= self.scfg.deadline_s:
                return key, "age"
        return None, None

    def _dispatch(self, key: tuple, trigger: str) -> int:
        tickets = self._queue.take(key, self.scfg.max_batch)
        n, is_complex = key
        mats = [t.matrix for t in tickets]
        if self.scfg.quantize_buckets:
            target = next(b for b in self._ladder if b >= len(mats))
            for _ in range(target - len(mats)):
                F = self._filler_rng.uniform(-1.0, 1.0, (n, n))
                if is_complex:
                    F = F + 1j * self._filler_rng.uniform(-1.0, 1.0,
                                                          (n, n))
                mats.append(F)
        waves = self._campaign.waves if self._campaign_open() else 0
        t0 = time.perf_counter()
        if self._world is not None:
            # what the followers need: the matrices with this rank's
            # fillers, and the campaign waves that follow the bucket
            self._send(("dispatch", key, trigger, mats, len(tickets), waves))
        out, err, _ = self._bucket(mats)
        dt = time.perf_counter() - t0
        t_done = self._clock()
        if err is None:
            for t, v in zip(tickets, out):  # padded tail values discarded
                t._resolve(complex(v) if t.is_complex else float(v), t_done)
                self.metrics.record_complete(t)
        else:
            detail = f"{type(err).__name__}: {err}"
            for t in tickets:
                t._shed(ShedReason.DISPATCH_FAILED, detail, t_done)
                self.metrics.record_shed(t)
            if self._log is not None:
                self._log(f"[serve] dispatch {key} failed, {len(tickets)} "
                          f"request(s) shed: {detail}")
        self.metrics.record_dispatch(len(tickets), self.scfg.max_batch)
        self.dispatch_log.append((key, len(tickets), dt, trigger))
        if waves:
            self._campaign_waves(waves)
        return len(tickets)

    # -- exporting -----------------------------------------------------------

    def _cache_hit_rate(self) -> float | None:
        if self.solver.cache is None:
            return None
        return self.solver.cache.stats()["hit_rate"]

    def snapshot(self) -> dict:
        """The ``repro.serve.metrics/v1`` snapshot (see serve/metrics.py)."""
        return self.metrics.snapshot(
            pending=self._queue.depth,
            solver_stats=self.solver.stats(),
            compile_stats=(compile_stats()
                           if self.scfg.compile_cache_dir else None),
            campaign_fraction=self.campaign_fraction)


def run_soak(service: PermanentService, *, requests: int, rate_hz: float,
             n: int = 12, density: float = 1.0,
             complex_entries: bool = False, repeat_pool: int = 8,
             seed: int = 0, lane_cycle: Sequence[str] | None = None,
             expire_every: int = 0,
             sleep: Callable[[float], None] | None = time.sleep) -> dict:
    """Open-loop Poisson soak: drive ``service`` with seeded exponential
    inter-arrival times at ``rate_hz`` and step the loop between
    arrivals (the single-threaded stand-in for "dispatch whenever the
    device is free").

    Requests draw from a ``repeat_pool``-sized matrix pool (result-cache
    traffic) and round-robin over ``lane_cycle`` (default: every
    configured lane).  ``expire_every=k`` gives every k-th request an
    already-expired deadline -- a deterministic source of
    ``DEADLINE_EXPIRED`` sheds so the typed-shed path is exercised on
    every run.  Tickets are backdated to their arrival time, so latency
    includes time spent queued behind an in-flight dispatch.

    Returns ``{"snapshot", "tickets", "wall_s", "arrival_span_s"}``.
    """
    if requests < 1 or rate_hz <= 0:
        raise ValueError(f"need requests >= 1 and rate_hz > 0, got "
                         f"{requests}, {rate_hz}")
    rng = np.random.default_rng(seed)

    def draw():
        M = rng.uniform(-1.0, 1.0, (n, n))
        if complex_entries:
            M = M + 1j * rng.uniform(-1.0, 1.0, (n, n))
        if density < 1.0:
            M = M * (rng.uniform(0, 1, (n, n)) < density)
        return M

    pool = [draw() for _ in range(max(1, repeat_pool))]
    picks = rng.integers(0, len(pool), requests)
    arrivals = np.cumsum(rng.exponential(1.0 / rate_hz, requests))
    lanes = list(lane_cycle) if lane_cycle is not None \
        else [l.name for l in service._queue.lanes]

    clock = service._clock
    t0 = clock()
    tickets = []
    for i in range(requests):
        target = t0 + arrivals[i]
        while clock() < target:
            # device free until the next arrival: serve queued work
            if service.step() == 0:
                wait = target - clock()
                if wait <= 0:
                    break
                if sleep is not None:
                    sleep(min(wait, 1e-3))
                else:
                    break               # fake clock: nothing will age
        kwargs = {}
        if expire_every and i % expire_every == expire_every - 1:
            kwargs["deadline_s"] = -1.0      # expired on arrival
        # backdate to the arrival time (not past the clock, which may
        # lag the schedule under an injected fake clock)
        tickets.append(service.submit(
            pool[picks[i]], lane=lanes[i % len(lanes)],
            t_submit=min(target, clock()), **kwargs))
    service.drain()
    return {"snapshot": service.snapshot(), "tickets": tickets,
            "wall_s": clock() - t0, "arrival_span_s": float(arrivals[-1])}
