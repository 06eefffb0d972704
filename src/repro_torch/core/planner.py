"""Plan side of the SUperman plan/execute split (Alg. 4 as data).

A copy of the reference package's ``core/planner.py`` with the port's
backend names (``torch`` for the reference's ``jnp``, ``cuda`` for its
``pallas``), a ``device`` field, and tuning tables not ported yet.

The paper's dispatch pipeline -- type sniff -> DM elimination -> Forbert-
Marx compression -> dense/sparse routing -> size bucketing -- used to be
re-derived inside every ``permanent`` call.  This module runs it ONCE and
reifies the result as an :class:`ExecutionPlan`: an inspectable,
JSON-serializable description of exactly what the executor will do (which
leaves exist, how they route, which buckets share a device program, what
the Ryser-step cost estimate is) before any device work happens.

* :class:`SolverConfig` -- one frozen dataclass replacing the engine's
  kwarg sprawl (precision, backend, preprocessing, chunking, cache and
  queue policy).
* :class:`LeafTask` -- one post-DM/FM leaf: owner matrix index, additive
  coefficient, the leaf matrix, its dense/sparse route and a lazy
  content hash (the result-cache key material).
* :class:`ExecutionPlan` -- leaves + per-matrix summaries + size buckets
  + cost estimate.  ``plan == plan`` compares content fingerprints, so
  planning is checkably deterministic; ``to_json()`` serializes the
  dispatch decisions for logging or offline inspection.
* :func:`build_plan` -- the only constructor; ``PermanentSolver.plan`` /
  ``plan_batch`` and the legacy ``engine.permanent*`` wrappers all call
  it.

Planning is pure host-side NumPy: no device, no state.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import asdict, dataclass, field, replace
from typing import Any

import numpy as np

from ..utils.spans import span
from . import decompose as D
from .stepspace import Geometry, plan_slices

__all__ = [
    "DENSITY_SWITCH",
    "SolverConfig",
    "PermanentReport",
    "CampaignSpec",
    "campaign_spec",
    "LeafTask",
    "MatrixPlan",
    "ExecutionPlan",
    "build_plan",
]

# Alg. 4: dense kernel when nonzero density >= 30%
DENSITY_SWITCH = 0.30
# Sec. 4: DM runs below this density; FM compresses a row or column of
# at most _FM_MAX_MIN_NNZ nonzeros (``fm_decompose``'s ``max_min_nnz``).
_DM_DENSITY = 0.5
_FM_MAX_MIN_NNZ = 4

ROUTE_DENSE = "dense"
ROUTE_SPARSE = "sparse"
ROUTE_INLINE = "inline"        # n <= 2 closed form, no device program
ROUTE_CAMPAIGN = "step_sharded"  # 2^{n-1} step space sliced across waves


@dataclass(frozen=True)
class SolverConfig:
    """Everything that used to be seven keyword arguments.

    Dispatch knobs (``precision``/``backend``/``preprocess``/``dm``/``fm``/
    ``num_chunks``) mirror the legacy ``permanent`` kwargs exactly; the
    remaining fields configure the stateful solver layers (result cache,
    async request queue).
    """
    precision: str = "dq_acc"        # dd | dq_fast | dq_acc | qq | kahan
    # torch | cuda | distributed | distributed_batch.  The default departs
    # from the reference's ``jnp``: on the card the CUDA kernel IS the
    # main path, the torch engine the numerics baseline it is held
    # against.  The distributed pair runs the ``cuda`` body on each rank
    # of the mesh the executor is given (``distributed_ctx``).
    backend: str = "cuda"
    preprocess: bool = True          # master switch for DM + FM (Sec. 4)
    dm: bool | None = None           # override DM elimination
    fm: bool | None = None           # override Forbert-Marx compression
    num_chunks: int = 4096           # Alg. 3 tau (rounded to power of two)
    # Device the leaves run on: None = the card ("cuda"); "cpu" runs the
    # torch engine and the kernels' plain versions on the host.
    device: str | None = None
    # CUDA kernel geometry (None = kernel defaults): ``geometry`` pins one
    # explicit Geometry for every kernel leaf; ``tuning_table`` names a
    # ``repro_torch.tune`` table resolved per leaf (config geometry > table
    # hit > defaults).  The *resolved* per-leaf geometry is part of numeric
    # identity (fingerprints, cache keys).
    geometry: Geometry | None = None
    tuning_table: str | None = None
    # Step-space campaign routing: a single leaf whose Ryser-step estimate
    # exceeds campaign_threshold re-routes to ROUTE_CAMPAIGN -- its step
    # space is cut into resumable slices (geometry recorded in the plan as
    # a CampaignSpec) and the executor's CampaignBackend runs them in
    # checkpointed waves.  None disables the route; negative forces it.
    # campaign_slices is the reference's 64 x 16: on one card a slice is
    # chunks/lanes CTAs (8 at the defaults) and the card holds about 66
    # slices of the real body at once, so 64 slices would be one wave and
    # one checkpoint; 1024 gives 16 waves, each a checkpoint.
    campaign_threshold: float | None = float(2 ** 34)
    campaign_slices: int = 1024      # plan_slices() slice-count target
    campaign_lanes: int = 1024       # plan_slices() chunk-count target
    campaign_checkpoint: str | None = None   # JobState .npz path
    campaign_max_waves: int | None = None    # pause (CampaignPaused) after
    cache: bool = True               # content-hash result cache on leaves
    cache_entries: int = 4096        # LRU capacity of the result cache
    queue_max_batch: int = 32        # flush a size bucket at this depth
    queue_max_delay_s: float = 0.05  # ... or when its oldest request ages out
    # Injected time source for the queue's deadline triggers (None =
    # time.monotonic).  Queue policy only -- it decides WHEN buckets
    # flush, never what is computed -- so it is excluded from plan
    # fingerprints, equality, and to_json (callables aren't JSON).
    clock: Any = field(default=None, compare=False, repr=False)

    def replace(self, **kw) -> "SolverConfig":
        return replace(self, **kw)

    def effective_precision(self, is_complex: bool) -> str:
        # qq's Dekker-split inner product is real-only; complex falls back
        # to kahan (engine contract since the scalar pipeline).  The plan
        # surfaces this as a ``qq->kahan`` precision_downgrade tag in the
        # dispatch tags and --plan-json, like backend downgrades.
        if is_complex and self.precision == "qq":
            return "kahan"
        return self.precision


@dataclass
class PermanentReport:
    """Everything the engine did for one matrix, for logging."""
    value: complex | float = 0.0
    n: int = 0
    nnz: int = 0
    density: float = 1.0
    dm_removed: int = 0
    fm_leaves: int = 0
    leaf_sizes: list[int] = field(default_factory=list)
    dispatch: list[str] = field(default_factory=list)
    precision: str = "dq_acc"
    backend: str = "cuda"


@dataclass(frozen=True)
class CampaignSpec:
    """The resumable step-space decomposition of one ROUTE_CAMPAIGN leaf.

    Fixed at plan time from the campaign knobs alone (never the runtime
    device count), so the same plan -- and any checkpoint it wrote -- can
    be executed or resumed under any mesh size.  ``total_slices *
    chunks_per_slice * chunk_size == 2^{n-1}``.
    """
    total_slices: int
    chunks_per_slice: int
    chunk_size: int
    precision: str                   # effective precision of the wave body
    backend: str                     # per-device slice body: torch | cuda
    geometry: Geometry | None = None   # cuda wave-body kernel geometry

    def as_tuple(self) -> tuple:
        return (self.total_slices, self.chunks_per_slice, self.chunk_size,
                self.precision, self.backend,
                self.geometry.tag() if self.geometry else None)


@dataclass
class LeafTask:
    """coef * perm(matrix) is one additive contribution to owner's result."""
    owner: int                       # index into the planned matrix list
    coef: complex | float
    matrix: np.ndarray               # post-DM/FM leaf (float64 / complex128)
    route: str                       # dense | sparse | inline | step_sharded
    campaign: CampaignSpec | None = None   # set iff route == step_sharded
    # Resolved kernel geometry of a dense or sparse leaf: set where the
    # configured backend is a kernel one (KERNEL_BACKENDS), n is at or
    # above KERNEL_FLOOR_N and a geometry or tuning table was configured.
    # None = kernel defaults.  The cache key reads it only where the
    # executor's producer rule names a kernel strategy for the leaf.
    geometry: Geometry | None = None
    _key: str | None = None

    @property
    def n(self) -> int:
        return self.matrix.shape[0]

    @property
    def key(self) -> str:
        """Content hash of the leaf matrix (result-cache key material)."""
        if self._key is None:
            h = hashlib.sha1()
            h.update(self.matrix.dtype.str.encode())
            h.update(str(self.matrix.shape).encode())
            h.update(np.ascontiguousarray(self.matrix).tobytes())
            self._key = h.hexdigest()
        return self._key


@dataclass
class MatrixPlan:
    """Per-input-matrix planning summary (feeds PermanentReport)."""
    index: int
    n: int
    nnz: int
    density: float
    dm_removed: int = 0
    fm_leaves: int = 0
    leaf_sizes: list[int] = field(default_factory=list)
    const: complex | float = 0.0     # folded 1x1/2x2 contributions


@dataclass
class ExecutionPlan:
    """The reified Alg.-4 dispatch for one matrix or one batch.

    ``leaves`` hold the device work; ``buckets`` group leaf indices by
    (route, n) -- in batched plans each multi-leaf bucket becomes ONE
    vmapped device program.  ``estimated_steps`` is the summed Ryser
    step-space size (n * 2^(n-1) per dense leaf, density-scaled for
    sparse), a dispatch-free cost proxy.
    """
    config: SolverConfig
    batched: bool                    # bucketed batch dispatch vs per-leaf
    is_complex: bool
    precision: str                   # effective (qq->kahan on complex)
    entries: list[MatrixPlan]
    leaves: list[LeafTask]
    buckets: dict[tuple[str, int], list[int]]
    estimated_steps: float
    # "qq->kahan" when the effective precision differs from the configured
    # one (complex qq); None otherwise.  Executor mirrors it into every
    # report's dispatch tags.
    precision_downgrade: str | None = None
    # Matrices the stack screen passed whole (one leaf, the matrix as
    # cast).  Not identity: a plan is the same plan whichever path
    # planned its matrices, so it stays out of ``fingerprint()``.
    screened: int = 0

    @property
    def num_matrices(self) -> int:
        return len(self.entries)

    # Every SolverConfig field is classified exactly once below, and
    # permlint rule PL005 rejects any new field that isn't: a field in
    # _NUMERIC_FIELDS perturbs what is computed (it participates in
    # ``fingerprint()``); a field in _POLICY_FIELDS only changes WHEN or
    # WHERE work is dispatched -- two plans differing only there execute
    # identically.  ``device`` is numeric: the kernel and its plain
    # version may differ at the ulp.
    _NUMERIC_FIELDS = ("precision", "backend", "preprocess", "dm", "fm",
                       "num_chunks", "device")
    # The campaign_* knobs steer routing and slice geometry; their effect
    # on numerics is already captured in the fingerprint body via each
    # leaf's route and ``CampaignSpec.as_tuple()``, so hashing the raw
    # knobs would only split identical executions.  cache/queue knobs and
    # the injected clock never touch device work at all.  geometry /
    # tuning_table follow the campaign precedent: they steer *which*
    # kernel geometry each leaf resolves to, and the resolved value is
    # hashed per leaf in the fingerprint body (LeafTask.geometry /
    # CampaignSpec.geometry) -- hashing the raw knobs (a table *path*)
    # would split plans whose resolved execution is identical.
    _POLICY_FIELDS = ("campaign_threshold", "campaign_slices",
                      "campaign_lanes", "campaign_checkpoint",
                      "campaign_max_waves", "geometry", "tuning_table",
                      "cache", "cache_entries",
                      "queue_max_batch", "queue_max_delay_s", "clock")

    def fingerprint(self) -> tuple:
        """Content identity: equal fingerprints -> identical execution.

        Only the numerics-affecting config fields participate; queue /
        cache policy knobs are deliberately excluded (see
        ``_NUMERIC_FIELDS``).
        """
        cfg = tuple((f, getattr(self.config, f))
                    for f in self._NUMERIC_FIELDS)
        return (
            cfg, self.batched, self.is_complex, self.precision,
            tuple((l.owner, complex(l.coef), l.route, l.key,
                   l.campaign.as_tuple() if l.campaign else None,
                   l.geometry.as_tuple() if l.geometry else None)
                  for l in self.leaves),
            tuple(sorted((r, n, tuple(idx))
                         for (r, n), idx in self.buckets.items())),
            tuple((e.index, e.n, e.nnz, e.dm_removed, e.fm_leaves,
                   complex(e.const)) for e in self.entries),
        )

    def __eq__(self, other) -> bool:
        if not isinstance(other, ExecutionPlan):
            return NotImplemented
        return self.fingerprint() == other.fingerprint()

    def to_json(self) -> dict:
        """JSON-serializable dispatch description (no matrix payloads)."""
        def _num(x):
            x = complex(x)
            return x.real if x.imag == 0 else [x.real, x.imag]
        cfg = asdict(self.config)
        cfg.pop("clock", None)       # queue-policy callable, not JSON
        return {
            "config": cfg,
            "batched": self.batched,
            "is_complex": self.is_complex,
            "precision": self.precision,
            "precision_downgrade": self.precision_downgrade,
            "matrices": [
                {"index": e.index, "n": e.n, "nnz": e.nnz,
                 "density": e.density, "dm_removed": e.dm_removed,
                 "fm_leaves": e.fm_leaves, "leaf_sizes": e.leaf_sizes,
                 "const": _num(e.const)}
                for e in self.entries],
            "leaves": [
                {"owner": l.owner, "n": l.n, "route": l.route,
                 "coef": _num(l.coef), "key": l.key,
                 "campaign": asdict(l.campaign) if l.campaign else None,
                 "geometry": l.geometry.tag() if l.geometry else None}
                for l in self.leaves],
            "buckets": [
                {"route": r, "n": n, "size": len(idx), "leaves": list(idx)}
                for (r, n), idx in sorted(self.buckets.items())],
            "estimated_steps": self.estimated_steps,
            "screened": self.screened,
        }

    def json(self, **kw) -> str:
        return json.dumps(self.to_json(), **kw)

    def summary(self) -> str:
        """One-line human summary for CLIs and logs."""
        b = len(self.entries)
        routes = {}
        for l in self.leaves:
            routes[l.route] = routes.get(l.route, 0) + 1
        rtxt = " ".join(f"{r}={c}" for r, c in sorted(routes.items())) \
            or "const-only"
        ptxt = self.precision if self.precision_downgrade is None \
            else f"{self.precision}({self.precision_downgrade})"
        return (f"plan[{'batch' if self.batched else 'scalar'}] "
                f"matrices={b} leaves={len(self.leaves)} ({rtxt}) "
                f"buckets={len(self.buckets)} screened={self.screened} "
                f"est_steps={self.estimated_steps:.3g} "
                f"precision={ptxt} backend={self.config.backend}")


def _preprocess_leaves(work: np.ndarray, mplan: MatrixPlan,
                       do_dm: bool, do_fm: bool) -> list[D.Leaf]:
    """DM elimination + Forbert-Marx on one matrix (Sec. 4).

    Returns the leaf list; [] when DM zeroed the matrix (perm == 0).
    """
    n = work.shape[0]
    if do_dm and mplan.density < _DM_DENSITY and n >= 3:
        work, removed = D.dm_eliminate(work)
        mplan.dm_removed = removed
        if not work.any():
            mplan.fm_leaves = 0
            return []
    if do_fm and n >= 3:
        leaves = D.fm_decompose(work, max_min_nnz=_FM_MAX_MIN_NNZ)
    else:
        leaves = [D.Leaf(1.0, work)]
    mplan.fm_leaves = len(leaves)
    mplan.leaf_sizes = [l.matrix.shape[0] for l in leaves]
    return leaves


def _density_of(m: np.ndarray) -> float:
    n = m.shape[0]
    return float((m != 0).sum()) / max(1, n * n)


def _route(m: np.ndarray, batched: bool,
           density: float | None = None) -> str:
    """``density`` is ``m``'s when the caller has it; else counted here."""
    n = m.shape[0]
    if batched and n <= 2:
        return ROUTE_INLINE          # closed form, folded at execute time
    if n <= 2:
        return ROUTE_DENSE
    if density is None:
        density = _density_of(m)
    return ROUTE_DENSE if density >= DENSITY_SWITCH else ROUTE_SPARSE


def _screen(stack: np.ndarray, do_dm: bool,
            do_fm: bool) -> tuple[list[int], list[bool]]:
    """Per matrix of a (k, n, n) stack: its nnz, and whether the
    per-matrix path provably returns it unchanged as its only leaf.

    That holds for n >= 5 when DM does not run (off, or density at
    least 0.5) and FM cannot compress (off, or every row and column has
    more than four nonzeros): ``_preprocess_leaves`` then hands back
    ``[Leaf(1.0, work)]``.  One mask over the stack serves every test.
    Smaller matrices always take the per-matrix path (with FM on, one
    of their rows is short enough to compress).
    """
    k, n = stack.shape[0], stack.shape[1]
    if n <= _FM_MAX_MIN_NNZ:
        return (stack != 0).sum(axis=(1, 2)).tolist(), [False] * k
    if np.iscomplexobj(stack):
        # nonzero iff either half is: the two halves' bools, side by side,
        # read as one uint16 (half the time of a complex != 0)
        mask = (stack.view(np.float64) != 0).view(np.uint16) != 0
    else:
        mask = stack != 0
    # degrees as products with ones: float32 sums of 0/1 are exact
    # below 2**24, and BLAS takes a tenth of the time of bool reductions
    fmask = mask.astype(np.float32)
    ones = np.ones(n, np.float32)
    rdeg = fmask @ ones                          # (k, n) row degrees
    nnz = rdeg.sum(axis=1).astype(np.int64).tolist()
    area = n * n
    whole = [not do_dm or c / area >= _DM_DENSITY for c in nnz]
    if do_fm and any(whole):
        cdeg = ones @ fmask                      # (k, n) column degrees
        deg = np.minimum(rdeg.min(axis=1), cdeg.min(axis=1)).tolist()
        whole = [w and d > _FM_MAX_MIN_NNZ for w, d in zip(whole, deg)]
    return nnz, whole


# Backends whose leaves and campaign waves run the CUDA kernels: ``cuda``
# on one card, the ``distributed`` pair on each rank of a mesh.  Below
# KERNEL_FLOOR_N the torch engine serves their leaves: no kernel, no
# geometry identity.  The executor's producer rule reads both.
KERNEL_BACKENDS = ("cuda", "distributed", "distributed_batch")
KERNEL_FLOOR_N = 4


def _resolve_geometry(config: SolverConfig, route: str, n: int,
                      density: float | None, dtype_str: str,
                      precision: str) -> Geometry | None:
    """config override > tuning-table hit > None (kernel defaults).

    ``density`` is read only for a table lookup; None where none is made.

    The table import is lazy and only happens when a table is configured:
    the default planning path stays file-I/O-free.  The table's device
    kind is the plan's device's (``host_device_kind(config.device)``).
    """
    if config.geometry is not None:
        return config.geometry
    if config.tuning_table is None:
        return None
    from ..tune.table import host_device_kind, resolve_geometry
    kind = host_device_kind(config.device)
    g = resolve_geometry(config.tuning_table, route, n, density,
                         dtype_str, precision, kind)
    if g is None and route == ROUTE_CAMPAIGN:
        # campaign wave bodies fall back to the dense-route entry
        g = resolve_geometry(config.tuning_table, ROUTE_DENSE, n, density,
                             dtype_str, precision, kind)
    return g


def campaign_spec(config: SolverConfig, n: int, density: float | None,
                  dtype_str: str, precision: str) -> CampaignSpec:
    """The campaign route of an n x n matrix under ``config``: the slice
    plan of ``campaign_slices`` x ``campaign_lanes``, the ``cuda`` wave
    body under a kernel backend (else ``torch``), and its geometry as
    ``_resolve_geometry`` finds it for the campaign route, falling back to
    the dense route's table entry; the torch body has none."""
    ts, cps, C = plan_slices(n, config.campaign_slices, 1,
                             config.campaign_lanes)
    cuda = config.backend in KERNEL_BACKENDS
    return CampaignSpec(
        total_slices=ts, chunks_per_slice=cps, chunk_size=C,
        precision=precision, backend="cuda" if cuda else "torch",
        geometry=_resolve_geometry(config, ROUTE_CAMPAIGN, n, density,
                                   dtype_str, precision) if cuda else None)


def _leaf_cost(m: np.ndarray, route: str) -> float:
    n = m.shape[0]
    if route == ROUTE_INLINE or n <= 2:
        return float(n)
    steps = n * float(2 ** (n - 1))
    if route == ROUTE_SPARSE:
        steps *= float((m != 0).sum()) / (n * n)
    return steps


def build_plan(mats: list[np.ndarray] | np.ndarray, config: SolverConfig, *,
               batched: bool) -> ExecutionPlan:
    """Run type sniff + DM/FM + routing + bucketing over ``mats``.

    ``mats`` is a sequence of square matrices or a (B, n, n) stack.
    ``batched=False`` preserves the scalar engine's per-leaf dispatch
    order exactly (every leaf is its own unit of work); ``batched=True``
    is the bucketed dispatcher shape (n <= 2 leaves fold inline, same-size
    same-route leaves share a bucket).

    Same-shape matrices are cast and screened as one stack (``_screen``):
    a matrix DM and FM would hand back unchanged becomes its own leaf
    without the per-matrix pass; the rest take it, in the same order.
    """
    with span("repro.plan"):
        if isinstance(mats, np.ndarray) and mats.ndim == 3:
            if mats.shape[1] != mats.shape[2]:
                raise ValueError(
                    f"square matrices required, got {mats.shape[1:]}")
            is_complex = np.iscomplexobj(mats)
            count = mats.shape[0]
            groups = [(range(count), mats)]
        else:
            mats = [np.asarray(M) for M in mats]
            by_shape: dict[tuple, list[int]] = {}
            for i, M in enumerate(mats):
                if M.ndim != 2 or M.shape[0] != M.shape[1]:
                    raise ValueError(
                        f"square matrices required, got {M.shape}")
                by_shape.setdefault(M.shape, []).append(i)
            is_complex = any(np.iscomplexobj(M) for M in mats)
            count = len(mats)
            groups = [(idx, [mats[i] for i in idx])
                      for idx in by_shape.values()]
        precision = config.effective_precision(is_complex)
        dtype = np.complex128 if is_complex else np.float64
        do_dm = config.preprocess if config.dm is None else config.dm
        do_fm = config.preprocess if config.fm is None else config.fm

        entries: list[MatrixPlan] = [None] * count
        leaves: list[LeafTask] = []
        passed = [False] * count
        with span("repro.plan.leaves"):
            for idx, group in groups:
                # the planner's own copy: leaves never alias the caller's
                stack = np.array(group, dtype=dtype, order="C")
                n = stack.shape[1]
                nnz, whole = _screen(stack, do_dm, do_fm)
                for k, i in enumerate(idx):
                    work = stack[k]
                    mplan = MatrixPlan(index=i, n=n, nnz=nnz[k],
                                       density=nnz[k] / max(1, n * n))
                    entries[i] = mplan
                    if whole[k]:
                        passed[i] = True
                        mplan.fm_leaves = 1
                        mplan.leaf_sizes = [n]
                        leaves.append(LeafTask(
                            owner=i, coef=1.0, matrix=work,
                            route=_route(work, batched, mplan.density)))
                        continue
                    for leaf in _preprocess_leaves(work, mplan, do_dm,
                                                   do_fm):
                        m = leaf.matrix
                        if m.shape == (1, 1) and m[0, 0] == 1:
                            mplan.const += leaf.coef
                            continue
                        leaves.append(LeafTask(owner=i, coef=leaf.coef,
                                               matrix=m,
                                               route=_route(m, batched)))
            if len(groups) > 1:
                leaves.sort(key=lambda l: l.owner)   # stable: FM order kept

        # _resolve_geometry reads a leaf's density only to look up a table
        reads_density = config.geometry is None and \
            config.tuning_table is not None

        def density(leaf: LeafTask) -> float | None:
            if not reads_density:
                return None
            if passed[leaf.owner]:
                return entries[leaf.owner].density
            return _density_of(leaf.matrix)

        with span("repro.plan.geometry"):
            # Campaign re-route: any dense/sparse leaf whose step-cost
            # estimate exceeds the threshold becomes a step_sharded leaf
            # with a resumable slice decomposition recorded in the plan.
            # The geometry depends only on the plan knobs (never the
            # runtime device count) -- that is what makes the checkpoint
            # elastic.
            thr = config.campaign_threshold
            if thr is not None:
                for leaf in leaves:
                    if leaf.route in (ROUTE_DENSE, ROUTE_SPARSE) and \
                            _leaf_cost(leaf.matrix, leaf.route) > thr:
                        leaf.route = ROUTE_CAMPAIGN
                        # identity lives on the CampaignSpec
                        leaf.campaign = campaign_spec(
                            config, leaf.n, density(leaf),
                            leaf.matrix.dtype.str, precision)

            # Kernel geometry resolution: only leaves a CUDA kernel will
            # actually produce carry one -- torch plans (and tiny-n
            # fallback leaves) keep geometry out of their identity.
            # Without a configured geometry or table every leaf keeps None.
            if config.backend in KERNEL_BACKENDS and (
                    config.geometry is not None or reads_density):
                for leaf in leaves:
                    if leaf.route in (ROUTE_DENSE, ROUTE_SPARSE) and \
                            leaf.n >= KERNEL_FLOOR_N:
                        leaf.geometry = _resolve_geometry(
                            config, leaf.route, leaf.n, density(leaf),
                            leaf.matrix.dtype.str, precision)

        with span("repro.plan.buckets"):
            buckets: dict[tuple[str, int], list[int]] = {}
            for j, leaf in enumerate(leaves):
                buckets.setdefault((leaf.route, leaf.n), []).append(j)
            cost = sum(_leaf_cost(l.matrix, l.route) for l in leaves)
        downgrade = None if precision == config.precision \
            else f"{config.precision}->{precision}"
        return ExecutionPlan(config=config, batched=batched,
                             is_complex=is_complex, precision=precision,
                             entries=entries, leaves=leaves, buckets=buckets,
                             estimated_steps=cost,
                             precision_downgrade=downgrade,
                             screened=sum(passed))
