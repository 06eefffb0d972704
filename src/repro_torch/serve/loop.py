"""Always-on permanent service: vLLM-style continuous batching.

The port of the reference package's ``serve/loop.py`` over the port's
solver, on one card (``SolverConfig.device``, None = the card).  Its
buckets launch the batch entries of the CUDA kernels (dense real and
complex, sparse real and complex) under the ``cuda`` backend, or the
torch engines under ``torch``; an interleaved campaign launches the
scalar entries from a u64 chunk base as its wave body.

The solver's own queue a size bucket when it fills or its
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
  the campaign to completion.  One device: the spec has no mesh.

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

from ..core.planner import SolverConfig
from .compile_cache import (compile_stats, enable_compile_cache,
                            quantized_batches, warmup)
from .lanes import (DEFAULT_LANES, LaneQueue, LaneSpec, ServeTicket,
                    ShedReason)
from .metrics import ServeMetrics

__all__ = ["ServiceConfig", "CampaignSpec", "PermanentService", "run_soak"]

_LANE_DEFAULT = object()      # submit(): "use the lane's slo_s as deadline"


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
    wave on one H100).  The service runs on one device: a ``mesh``
    raises (the service over a mesh is ROADMAP item 8: the other ranks
    would have to follow rank 0's dispatches)."""
    matrix: Any
    mesh: Any = None                     # ROADMAP item 8: must stay None
    waves: int = 1                       # waves per bucket dispatch
    checkpoint: str | None = None        # JobState .npz path
    slices: int = SolverConfig.campaign_slices
    lanes: int = SolverConfig.campaign_lanes

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "the service runs a campaign on one device; a campaign "
                "mesh in the service is ROADMAP.md, modules queue, item 8 "
                "(the service and the tuner over a mesh)")


class PermanentService:
    """The always-on loop: admission -> lanes -> bucket dispatch.

    Single-threaded by design: ``submit`` only admits (constant-time
    bookkeeping), ``step`` does at most one bucket dispatch, ``drain``
    steps until the queue is empty.  Callers own the thread; an open
    loop is ``run_soak``, a closed one is ``ticket.result()`` after
    ``drain()``.
    """

    def __init__(self, solver_config=None, service: ServiceConfig | None = None,
                 *, campaign: CampaignSpec | None = None,
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

        if self.scfg.compile_cache_dir:
            enable_compile_cache(self.scfg.compile_cache_dir)
        self.solver = PermanentSolver(solver_config, clock=self._clock)
        self.warmup_report: dict | None = None
        if self.scfg.warmup_ns:
            batches = self._ladder if self.scfg.quantize_buckets \
                else (self.scfg.max_batch,)
            geoms = [(n, b, c)
                     for n in self.scfg.warmup_ns
                     for b in batches
                     for c in ((False, True) if self.scfg.warmup_complex
                               else (False,))]
            self.warmup_report = warmup(solver_config, geoms)

        self._campaign = campaign
        self._camp_state: dict = {"state": None, "value": None}
        if campaign is not None:
            self._camp_setup(campaign)

    # -- campaign interleaving ----------------------------------------------

    def _camp_setup(self, spec: CampaignSpec) -> None:
        from ..core.stepspace import plan_slices
        cmat = np.asarray(spec.matrix)
        ts, cps, C = plan_slices(cmat.shape[0], spec.slices, 1, spec.lanes)
        self._camp_args = (cmat, ts, cps, C)

    def campaign_body(self) -> dict:
        """The ``run_campaign`` keywords of the interleaved campaign: its
        slice plan, and the wave body the solver config names -- the same
        cuda/torch collapse as the planner's campaign route, with the
        kernel geometry under ``cuda`` resolved as the planner's campaign
        route resolves it (config override > tuning table > kernel
        defaults); the torch body has none."""
        cfg = self.solver.config
        cmat, ts, cps, C = self._camp_args
        backend = "cuda" if cfg.backend == "cuda" else "torch"
        geometry = None
        if backend == "cuda":
            from ..core.planner import ROUTE_CAMPAIGN, _resolve_geometry
            geometry = _resolve_geometry(
                cfg, ROUTE_CAMPAIGN, cmat.shape[0],
                float(np.count_nonzero(cmat)) / cmat.size, cmat.dtype.str,
                cfg.precision)
        return dict(total_slices=ts, chunks_per_slice=cps, chunk_size=C,
                    precision=cfg.precision, backend=backend,
                    geometry=geometry, device=cfg.device)

    def _advance_campaign(self, waves: int | None) -> None:
        """Run up to ``waves`` campaign waves (None = to completion);
        state threads across calls so each dispatch resumes in place."""
        if self._campaign is None or self._camp_state["value"] is not None:
            return
        from ..core import distributed
        val, st = distributed.run_campaign(
            self._camp_args[0], **self.campaign_body(),
            checkpoint_path=self._campaign.checkpoint,
            state=self._camp_state["state"], max_waves=waves)
        self._camp_state["state"], self._camp_state["value"] = st, val

    @property
    def campaign_value(self):
        return self._camp_state["value"]

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
        ready)."""
        now = self._clock()
        for t in self._queue.shed_expired(now):
            t._shed(ShedReason.DEADLINE_EXPIRED,
                    f"queued past deadline by {now - t.deadline:.3g}s",
                    now)
            self.metrics.record_shed(t)
        self.metrics.sample_queue_depth(self._queue.depth)
        key, trigger = self._pick_bucket(now)
        served = self._dispatch(key, trigger) if key is not None else 0
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
        """Shed everything still queued (typed ``SHUTDOWN``); returns the
        shed tickets."""
        now = self._clock()
        out = self._queue.drain_all()
        for t in out:
            t._shed(ShedReason.SHUTDOWN, "service shut down with work "
                    "queued", now)
            self.metrics.record_shed(t)
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
        t0 = time.perf_counter()
        plan = self.solver.plan_batch(mats)
        out = self.solver.execute(plan)
        dt = time.perf_counter() - t0
        t_done = self._clock()
        for t, v in zip(tickets, out):      # padded tail values discarded
            t._resolve(complex(v) if t.is_complex else float(v), t_done)
            self.metrics.record_complete(t)
        self.metrics.record_dispatch(len(tickets), self.scfg.max_batch)
        self.dispatch_log.append((key, len(tickets), dt, trigger))
        if self._campaign is not None:
            self._advance_campaign(self._campaign.waves)
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
