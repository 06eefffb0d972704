"""`PermanentSolver`: the stateful plan/execute session object.

The port of the reference package's ``core/solver.py``:

    solver = PermanentSolver(SolverConfig(precision="dq_acc"))
    plan = solver.plan(A)            # DM/FM + routing; no device work
    value = solver.execute(plan)     # dispatch through the backend registry
    values = solver.execute(solver.plan_batch(As))   # one program per bucket

**Queue** (`submit` / `flush` / `poll`): submitted matrices accumulate in
size-keyed buckets and flush through a bucketed batch plan when a bucket
reaches ``config.queue_max_batch`` or its oldest request ages past
``config.queue_max_delay_s``.  ``submit`` returns a
:class:`PermanentRequest` future.  Leaf results are memoised in a
content-hash :class:`~repro_torch.core.cache.ResultCache`.

**Campaigns**: a leaf the planner routes to ``step_sharded`` runs as
checkpointed waves (``SolverConfig.campaign_checkpoint``,
``campaign_max_waves``); ``solver.campaign_progress(state, wave)`` is
called after every checkpointed wave, and a spent wave budget raises
:class:`~repro_torch.core.distributed.CampaignPaused`.

**Meshes**: ``PermanentSolver(config, distributed_ctx=mesh)`` executes
every plan over a ``launch.mesh.Mesh`` (or an object with a ``.mesh``):
the ``distributed`` / ``distributed_batch`` backends shard buckets and
step spaces over its ranks, and campaign waves span them; every rank
holds its own solver and runs the same calls.

**Hooks** for the service's observability: ``solver.on_submit(request)``
fires after a request is queued, ``solver.on_flush(n, served, seconds)``
after a bucket flush resolved its futures.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Sequence

import numpy as np

from .cache import ResultCache
from .executor import ExecStats, LeafTiming, execute_plan
from .planner import ExecutionPlan, PermanentReport, SolverConfig, build_plan

__all__ = ["PermanentSolver", "PermanentRequest", "SolverConfig",
           "SolverError", "plan_values"]


def plan_values(plan: ExecutionPlan, totals: np.ndarray, reports):
    """An executor's complex128 totals as the plan's value type: complex128
    for a complex plan, else the float64 real part; sets each report's
    ``value`` to a Python complex or float."""
    out = totals if plan.is_complex else totals.real.copy()
    for r, v in zip(reports, out):
        r.value = v.item()
    return out


class SolverError(RuntimeError):
    """Typed failure from the solver's queue/flush machinery."""


class PermanentRequest:
    """Future for one queued permanent; resolved by a solver flush."""

    def __init__(self, solver: "PermanentSolver", matrix: np.ndarray):
        self._solver = solver
        self.matrix = matrix
        self.n = matrix.shape[0]
        self.done = False
        self.value: complex | float | None = None
        self.report: PermanentReport | None = None

    def result(self) -> complex | float:
        """The permanent; flushes this request's size bucket if pending."""
        if not self.done:
            self._solver._flush_bucket(self.n)
        if not self.done:
            _, reqs = self._solver._queue.get(self.n, (0.0, []))
            raise SolverError(
                f"flush of size bucket n={self.n} left {len(reqs)} "
                f"request(s) unresolved (this future among them)")
        return self.value

    def _resolve(self, value, report) -> None:
        self.value = value
        self.report = report
        self.done = True


class PermanentSolver:
    """Stateful plan/execute session: backend dispatch + cache + queue."""

    def __init__(self, config: SolverConfig | None = None, *,
                 distributed_ctx: Any | None = None,
                 clock: Callable[[], float] | None = None, **overrides):
        config = config or SolverConfig()
        if overrides:
            config = config.replace(**overrides)
        self.config = config
        self.distributed_ctx = distributed_ctx
        self.cache = ResultCache(config.cache_entries) if config.cache \
            else None
        # clock precedence: explicit kwarg > SolverConfig.clock > monotonic
        self._clock = clock if clock is not None \
            else (config.clock or time.monotonic)  # permlint: disable=PL004  # sanctioned injectable-clock default  # torchlint: disable=PT004 the injectable clock's default
        self._queue: dict[int, tuple[float, list[PermanentRequest]]] = {}
        self._stats = ExecStats()
        self.flushes = 0
        # optional (JobState, Wave) -> None callback fired after every
        # checkpointed wave of a step_sharded (campaign) leaf
        self.campaign_progress: Callable | None = None
        # admission/flush observability hooks: on_submit(request) fires
        # after a request is enqueued (before any flush it triggers);
        # on_flush(n, served, seconds) after a bucket flush resolves its
        # futures
        self.on_submit: Callable[[PermanentRequest], None] | None = None
        self.on_flush: Callable[[int, int, float], None] | None = None

    # -- plan ---------------------------------------------------------------

    def plan(self, A) -> ExecutionPlan:
        """Scalar plan for one matrix (per-leaf dispatch order)."""
        A = np.asarray(A)
        if A.ndim != 2 or A.shape[0] != A.shape[1]:
            raise ValueError(f"square matrix required, got {A.shape}")
        return build_plan([A], self.config, batched=False)

    def plan_batch(self, As: Sequence) -> ExecutionPlan:
        """Bucketed batch plan: same-size leaves share one device program.

        A (B, n, n) ndarray goes to the planner whole, as one stack."""
        if not isinstance(As, np.ndarray):
            As = list(As)
        return build_plan(As, self.config, batched=True)

    # -- execute ------------------------------------------------------------

    def execute(self, plan: ExecutionPlan, *, return_report: bool = False):
        """Dispatch a plan; scalar plans return a Python float, batch plans
        a (B,) float64 ndarray (Python complex / complex128 for a complex
        plan)."""
        totals, reports, stats = execute_plan(
            plan, cache=self.cache, distributed_ctx=self.distributed_ctx,
            campaign_progress=self.campaign_progress)
        self._merge_stats(stats)
        out = plan_values(plan, totals, reports)
        if not plan.batched and plan.num_matrices == 1:
            value = reports[0].value
            return (value, reports[0]) if return_report else value
        return (out, reports) if return_report else out

    # -- async request queue ------------------------------------------------

    def submit(self, A) -> PermanentRequest:
        """Queue one matrix; returns a future resolved at the next flush."""
        A = np.asarray(A)
        if A.ndim != 2 or A.shape[0] != A.shape[1]:
            raise ValueError(f"square matrix required, got {A.shape}")
        req = PermanentRequest(self, A)
        _, reqs = self._queue.setdefault(A.shape[0], (self._clock(), []))
        reqs.append(req)
        if self.on_submit is not None:
            self.on_submit(req)
        if len(reqs) >= self.config.queue_max_batch:
            self._flush_bucket(A.shape[0])
        self.poll()
        return req

    @property
    def pending(self) -> int:
        return sum(len(reqs) for _, reqs in self._queue.values())

    def poll(self) -> int:
        """Flush every bucket whose deadline has passed; returns the
        number of requests flushed."""
        now = self._clock()
        due = [n for n, (t0, reqs) in self._queue.items()
               if reqs and now - t0 >= self.config.queue_max_delay_s]
        return sum(self._flush_bucket(n) for n in due)

    def flush(self) -> int:
        """Flush every queued bucket; returns the number of requests."""
        return sum(self._flush_bucket(n) for n in list(self._queue))

    def _flush_bucket(self, n: int) -> int:
        _, reqs = self._queue.get(n, (0.0, []))
        if not reqs:
            self._queue.pop(n, None)
            return 0
        # plan + execute BEFORE dequeuing: if either raises, the bucket
        # stays queued and the pending futures remain resolvable
        t0 = time.perf_counter()
        plan = self.plan_batch([r.matrix for r in reqs])
        _, reports = self.execute(plan, return_report=True)
        self._queue.pop(n, None)
        for req, report in zip(reqs, reports):
            req._resolve(report.value, report)
        self.flushes += 1
        if self.on_flush is not None:
            self.on_flush(n, len(reqs), time.perf_counter() - t0)
        return len(reqs)

    # -- accounting ---------------------------------------------------------

    def _merge_stats(self, s: ExecStats) -> None:
        t = self._stats
        t.device_dispatches += s.device_dispatches
        t.batched_leaves += s.batched_leaves
        t.scalar_leaves += s.scalar_leaves
        t.inline_leaves += s.inline_leaves
        t.cache_hits += s.cache_hits
        t.cache_misses += s.cache_misses
        t.downgrades.extend(s.downgrades)
        for key, lt in s.timings.items():
            t.timings.setdefault(key, LeafTiming()).merge(lt)

    def stats(self) -> dict:
        """Dispatch + cache + queue accounting for the session."""
        return {"device_dispatches": self._stats.device_dispatches,
                "batched_leaves": self._stats.batched_leaves,
                "scalar_leaves": self._stats.scalar_leaves,
                "inline_leaves": self._stats.inline_leaves,
                "downgrades": list(self._stats.downgrades),
                "flushes": self.flushes,
                "pending": self.pending,
                "leaf_timings": {k: t.to_json() for k, t in
                                 sorted(self._stats.timings.items())},
                "cache": self.cache.stats() if self.cache else None}
