"""Priority lanes, per-request deadlines, and typed load-shedding.

A copy of the reference package's ``serve/lanes.py`` (it imports no JAX,
but the port keeps its own copy).  The always-on service
(``serve/loop.py``) does not use the solver's
size+deadline flush queue -- it owns admission.  This module is the
mechanism layer:

* :class:`LaneSpec` -- one priority lane (name, strict priority, default
  SLO).  ``DEFAULT_LANES`` ships an ``interactive`` lane (priority 0,
  tight SLO) and a ``bulk`` lane (priority 1, loose SLO).
* :class:`ServeTicket` -- the service-side future for one admitted (or
  shed) request: carries admission/completion timestamps, the absolute
  deadline, and -- when shed -- a typed :class:`ShedReason`.  Every
  rejection is typed; a ticket can never be silently dropped.
* :class:`ShedReason` / :class:`ShedError` -- the typed rejection
  vocabulary (queue depth, step-cost budget, deadline expiry, shutdown).
  ``ticket.result()`` on a shed ticket raises ``ShedError``.
* :class:`LaneQueue` -- admitted tickets in per-(lane, bucket-key) FIFO
  order, where the bucket key is ``(n, is_complex)`` (matrices sharing a
  key share one device program).  ``take(key, k)`` drains a bucket's
  worth across lanes in priority order, so an interactive request is
  never stuck behind bulk traffic of the same size -- and bulk traffic
  backfills an interactive bucket's spare slots instead of fragmenting
  device programs.

Policy (when to dispatch, when to shed) lives in the serve loop; this
module only keeps the books, against an injected clock.
"""

from __future__ import annotations

import enum
import itertools
from collections import deque
from dataclasses import dataclass
from typing import Iterator

import numpy as np

__all__ = ["LaneSpec", "DEFAULT_LANES", "ShedReason", "ShedError",
           "ServeTicket", "LaneQueue", "request_cost"]


@dataclass(frozen=True)
class LaneSpec:
    """One priority lane.  Lower ``priority`` preempts higher; ``slo_s``
    is the lane's default admission->result deadline (None = no
    deadline)."""
    name: str
    priority: int
    slo_s: float | None = None


DEFAULT_LANES = (LaneSpec("interactive", 0, slo_s=2.0),
                 LaneSpec("bulk", 1, slo_s=30.0))


class ShedReason(enum.Enum):
    """Why a request was rejected or dropped.  Every shed carries one."""
    QUEUE_FULL = "queue_full"            # admission: depth backpressure
    COST_BUDGET = "cost_budget"          # admission: est. step-cost budget
    DEADLINE_EXPIRED = "deadline_expired"  # queued past its deadline
    SHUTDOWN = "shutdown"                # service stopped with work queued
    # the port's: its dispatch raised (on every rank of a mesh at once);
    # the detail carries the error
    DISPATCH_FAILED = "dispatch_failed"


class ShedError(RuntimeError):
    """Raised by ``ServeTicket.result()`` when the request was shed."""

    def __init__(self, reason: ShedReason, detail: str = ""):
        self.reason = reason
        self.detail = detail
        super().__init__(f"request shed ({reason.value})"
                         + (f": {detail}" if detail else ""))


def request_cost(n: int) -> float:
    """Ryser step-space size of one dense n x n request (the planner's
    dispatch-free cost proxy) -- the unit of the admission budget."""
    return float(n) * float(2 ** max(0, n - 1))


_TICKET_IDS = itertools.count()

QUEUED = "queued"
DONE = "done"
SHED = "shed"


class ServeTicket:
    """Service-side future for one request (admitted or shed)."""

    def __init__(self, matrix: np.ndarray, lane: LaneSpec, t_submit: float,
                 deadline: float | None):
        self.id = next(_TICKET_IDS)
        self.matrix = matrix
        self.n = matrix.shape[0]
        self.is_complex = bool(np.iscomplexobj(matrix))
        self.lane = lane
        self.t_submit = t_submit             # admission timestamp
        self.deadline = deadline             # absolute, or None
        self.cost = request_cost(self.n)
        self.status = QUEUED
        self.value: complex | float | None = None
        self.t_done: float | None = None
        self.shed_reason: ShedReason | None = None
        self.shed_detail: str = ""

    @property
    def key(self) -> tuple[int, bool]:
        """Bucket key: same-key tickets share one device program."""
        return (self.n, self.is_complex)

    @property
    def done(self) -> bool:
        return self.status == DONE

    @property
    def shed(self) -> bool:
        return self.status == SHED

    @property
    def latency_s(self) -> float | None:
        """Admission->result (or ->shed) latency; None while queued."""
        if self.t_done is None:
            return None
        return self.t_done - self.t_submit

    def result(self) -> complex | float:
        """The permanent; raises :class:`ShedError` for shed tickets and
        ``RuntimeError`` while still queued (drive the loop first)."""
        if self.status == SHED:
            raise ShedError(self.shed_reason, self.shed_detail)
        if self.status != DONE:
            raise RuntimeError(f"ticket {self.id} still queued -- "
                               f"step/drain the serve loop to resolve it")
        return self.value

    def _resolve(self, value, now: float) -> None:
        self.value = value
        self.t_done = now
        self.status = DONE

    def _shed(self, reason: ShedReason, detail: str, now: float) -> None:
        self.shed_reason = reason
        self.shed_detail = detail
        self.t_done = now
        self.status = SHED


class LaneQueue:
    """Admitted tickets, per-(lane, bucket-key) FIFO, priority-ordered.

    Tracks total depth and the summed step-cost estimate of queued work
    (the backpressure signals) incrementally.
    """

    def __init__(self, lanes: tuple[LaneSpec, ...] = DEFAULT_LANES):
        if not lanes:
            raise ValueError("need at least one lane")
        names = [l.name for l in lanes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate lane names: {names}")
        self.lanes = tuple(sorted(lanes, key=lambda l: l.priority))
        self.by_name = {l.name: l for l in self.lanes}
        # lane name -> bucket key -> FIFO of queued tickets
        self._q: dict[str, dict[tuple, deque[ServeTicket]]] = \
            {l.name: {} for l in self.lanes}
        self.depth = 0
        self.pending_cost = 0.0

    def lane(self, name: str | None) -> LaneSpec:
        if name is None:
            return self.lanes[0]
        try:
            return self.by_name[name]
        except KeyError:
            raise ValueError(f"unknown lane {name!r}; configured: "
                             f"{sorted(self.by_name)}") from None

    def admit(self, ticket: ServeTicket) -> None:
        self._q[ticket.lane.name].setdefault(ticket.key,
                                             deque()).append(ticket)
        self.depth += 1
        self.pending_cost += ticket.cost

    def _drop(self, ticket: ServeTicket) -> None:
        self.depth -= 1
        self.pending_cost -= ticket.cost

    def _iter_queues(self) -> Iterator[tuple[LaneSpec, tuple,
                                             deque[ServeTicket]]]:
        for lane in self.lanes:
            for key, q in self._q[lane.name].items():
                if q:
                    yield lane, key, q

    def shed_expired(self, now: float) -> list[ServeTicket]:
        """Remove and return every queued ticket whose deadline passed.

        The caller marks them shed (DEADLINE_EXPIRED) -- the queue only
        decides membership.
        """
        out: list[ServeTicket] = []
        for lane, key, q in self._iter_queues():
            keep = deque()
            while q:
                t = q.popleft()
                if t.deadline is not None and now >= t.deadline:
                    self._drop(t)
                    out.append(t)
                else:
                    keep.append(t)
            q.extend(keep)
        return out

    def ready_keys(self, now: float) -> list[tuple[int, float, tuple]]:
        """Every bucket key with queued work, as (best priority, oldest
        admission time, key) sorted most-urgent first -- the serve loop's
        dispatch-order view."""
        best: dict[tuple, tuple[int, float]] = {}
        for lane, key, q in self._iter_queues():
            cand = (lane.priority, q[0].t_submit)
            if key not in best or cand < best[key]:
                best[key] = cand
        return sorted((p, t, k) for k, (p, t) in best.items())

    def key_depth(self, key: tuple) -> int:
        return sum(len(self._q[l.name].get(key, ()))
                   for l in self.lanes)

    def take(self, key: tuple, k: int) -> list[ServeTicket]:
        """Drain up to ``k`` tickets of ``key`` across lanes in priority
        order (FIFO within a lane) -- one bucket's worth."""
        out: list[ServeTicket] = []
        for lane in self.lanes:
            q = self._q[lane.name].get(key)
            while q and len(out) < k:
                t = q.popleft()
                self._drop(t)
                out.append(t)
            if len(out) >= k:
                break
        return out

    def drain_all(self) -> list[ServeTicket]:
        """Remove and return everything (shutdown shedding)."""
        out: list[ServeTicket] = []
        for lane, key, q in self._iter_queues():
            while q:
                t = q.popleft()
                self._drop(t)
                out.append(t)
        return out
