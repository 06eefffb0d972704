"""Execute side of the plan/execute split: backend registry + dispatcher.

The port of the reference package's ``core/executor.py`` for the dense,
sparse and campaign routes, real and complex.  A :class:`Backend`
computes one leaf or one same-size bucket; ``register_backend`` adds
strategies without touching the dispatcher.  Five register at import,
each computing one thing:

* ``torch`` -- the chunked torch engines (``core/ryser.py``, sparse
  ``core/sparyser.py``), the counterpart of the reference's ``jnp``;
* ``cuda`` -- the CUDA kernels (``kernels/ops.py``) at n >= 4, the
  counterpart of ``pallas``: the scalar entry for a leaf, the batch-grid
  entry for a bucket, of the dense real kernel, the split-plane complex
  one, or the SpaRyser one for sparse leaves (density < 0.30);
* ``distributed_batch`` -- a bucket's batch axis sharded over the ranks
  of the mesh in ``execute_plan(..., distributed_ctx=)``, body ``cuda``;
* ``distributed`` -- a scalar dense leaf split over the Gray-step space
  of that mesh (``distributed.permanent_on_mesh``);
* ``campaign`` -- a ``step_sharded`` leaf, which the planner routes when
  its step estimate exceeds ``campaign_threshold``, as checkpointed
  waves of slices (``distributed.run_campaign``) through the wave body
  its ``CampaignSpec`` names, over the mesh's ranks when there is one.
  Its tag is ``campaign(n=..,cuda)``; a ``campaign_max_waves`` budget
  that runs out raises ``CampaignPaused`` through :func:`execute_plan`.

**One rule names who computes a leaf.**  :func:`producer` takes the
configured backend, the route, n, scalar or bucket, the mesh and the
device: ``torch`` under ``torch`` and below the kernel floor n < 4 (as
the reference's ``PallasBackend._kernel_ok`` sends n < 4 to ``jnp``);
``cuda`` under ``cuda``; under the ``distributed`` pair with a mesh,
``distributed_batch`` for a bucket, ``distributed`` for a scalar dense
leaf of ``distributed`` and ``cuda`` on every rank for other scalar
leaves; without a mesh ``cuda`` on a card (the kernels, never the torch
engine, serve card tensors; the reference runs ``jnp`` there) and
``torch`` on the CPU.  :func:`execute_plan` hands each leaf or bucket to that
strategy, on the mesh's device under the ``distributed`` pair, and the
result cache keys on its name (``value_backend``): a value's cache
identity is the strategy whose code ran.  The torch engine serving a
kernel backend's bucket is tagged ``dense_batch(n=..,b=..,cuda->torch)``
(``distributed->torch``: the reference's ``distributed->jnp``); a scalar
sparse tag names the producer, ``sparse(n=..,cuda)``, with a
``cfg->producer`` suffix when it is not the configured backend.  Every
rank of the ctx's mesh (a ``launch.mesh.Mesh``, or an object with a
``.mesh``) executes the same plan.

All run on ``SolverConfig.device`` (None = the card).  A complex ``qq``
plan runs as ``kahan`` and says so with a ``precision(qq->kahan)`` tag on
every report.  **Batch contract**: ``dense_batch(stack, *, precision,
num_chunks, geometry, device, ctx)`` and ``sparse_batch`` return a (B,)
ndarray, or ``None`` where the rule hands a kernel backend's bucket to
the torch engine: the caller runs that and tags the downgrade.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ..utils.spans import span
from . import ryser as R
from . import sparyser as S
from .cache import ResultCache
from .planner import (KERNEL_BACKENDS, KERNEL_FLOOR_N, ROUTE_CAMPAIGN,
                      ROUTE_DENSE, ROUTE_INLINE, ROUTE_SPARSE, CampaignSpec,
                      ExecutionPlan, LeafTask, PermanentReport)

__all__ = ["Backend", "TorchBackend", "CudaBackend", "DistributedBackend",
           "DistributedBatchBackend", "CampaignBackend", "producer",
           "register_backend", "get_backend", "available_backends",
           "ExecStats", "LeafTiming", "execute_plan"]


def _mesh_of(ctx):
    """``launch.mesh.ctx_mesh`` of a distributed ctx; None without one
    (``launch.mesh`` loads only with a ctx)."""
    if ctx is None:
        return None
    from ..launch.mesh import ctx_mesh
    return ctx_mesh(ctx)


def _on_card(device) -> bool:
    """Whether ``device`` (None = the card) names a card; whether one is
    present is the kernels' wrappers' to check."""
    return device is None or torch.device(device).type == "cuda"


def producer(backend: str, route: str, n: int, *, batched: bool,
             mesh=None, device=None) -> str:
    """Registry name of the strategy that computes an n x n ``route``
    leaf (a bucket of them when ``batched``) under the configured
    ``backend``, with ``mesh`` (None = none) on ``device`` (None = the
    card): the module docstring's rule, and the value's cache identity.
    A backend outside the kernel ones computes its own leaves."""
    if backend not in KERNEL_BACKENDS:
        return backend
    if n < KERNEL_FLOOR_N:
        return "torch"
    if backend == "cuda":
        return "cuda"
    if mesh is None:
        return "cuda" if _on_card(device) else "torch"
    if batched:
        return "distributed_batch"
    return "distributed" if backend == "distributed" and \
        route == ROUTE_DENSE else "cuda"


def _run_device(backend: str, mesh, device):
    """Where the configured ``backend``'s leaves run: the mesh's device
    under the ``distributed`` pair with a mesh (a ``device`` of another
    kind raises), else ``device``."""
    if mesh is None or backend not in ("distributed", "distributed_batch"):
        return device
    from .distributed import _mesh_device
    return _mesh_device(mesh, device)


def _scalar(v) -> complex | float:
    """A 0-d tensor / numpy scalar / Python number as a Python float, or
    a Python complex for a complex value."""
    v = v.item() if hasattr(v, "item") else v
    return v if isinstance(v, complex) else float(v)


def _host(vals) -> np.ndarray:
    return vals.detach().cpu().numpy() if hasattr(vals, "detach") \
        else np.asarray(vals)


@dataclass
class LeafTiming:
    """Wall-clock accounting for one dispatch-site key, e.g.
    ``dense_batch(n=12,cuda)``: ``count`` device dispatches, ``leaves``
    the leaf results they produced."""
    count: int = 0
    leaves: int = 0
    total_s: float = 0.0
    max_s: float = 0.0

    def add(self, seconds: float, leaves: int = 1) -> None:
        self.count += 1
        self.leaves += leaves
        self.total_s += seconds
        self.max_s = max(self.max_s, seconds)

    def merge(self, other: "LeafTiming") -> None:
        self.count += other.count
        self.leaves += other.leaves
        self.total_s += other.total_s
        self.max_s = max(self.max_s, other.max_s)

    def to_json(self) -> dict:
        return {"count": self.count, "leaves": self.leaves,
                "total_s": self.total_s, "max_s": self.max_s,
                "mean_s": self.total_s / self.count if self.count else 0.0}


@dataclass
class ExecStats:
    """What one execute_plan call actually did (for tests/benchmarks)."""
    device_dispatches: int = 0       # scalar leaf calls + bucket programs
    batched_leaves: int = 0          # leaves served by bucket programs
    scalar_leaves: int = 0           # leaves served one at a time
    inline_leaves: int = 0           # n <= 2 closed forms
    cache_hits: int = 0
    cache_misses: int = 0
    downgrades: list[str] = field(default_factory=list)
    timings: dict[str, LeafTiming] = field(default_factory=dict)

    def record_time(self, key: str, seconds: float,
                    leaves: int = 1) -> None:
        self.timings.setdefault(key, LeafTiming()).add(seconds, leaves)


# ---------------------------------------------------------------------------
# Backend strategy registry
# ---------------------------------------------------------------------------

class Backend:
    """One execution strategy for dense and sparse permanent leaves.

    ``dense`` / ``sparse`` return a leaf's value as a Python scalar,
    ``dense_batch`` / ``sparse_batch`` follow the batch contract in the
    module docstring.  Each hands its input to the strategy that
    :func:`producer` names for this one configured, whose ``compute``
    computes it: a direct call gets what :func:`execute_plan` computes
    under ``SolverConfig(backend=name)``.  Every strategy gets the leaf's
    dense matrix (a stack for a bucket); a sparse one builds the padded
    CCS arrays it needs from it (``sparyser.padded_ccs``).  ``geometry``
    is the leaf's resolved kernel geometry (None = kernel defaults); the
    torch engine ignores it.  Times are host wall-clock around work that
    ends in a copy to the host, so they include the device's work.
    """

    name = "?"

    def value_backend(self, route: str, n: int, *, batched: bool,
                      ctx: Any | None = None, device=None) -> str:
        """Registry name of the strategy whose numerics produce this leaf's
        value (the result-cache identity) on ``device`` (None = the
        card)."""
        return producer(self.name, route, n, batched=batched,
                        mesh=_mesh_of(ctx), device=device)

    def dense(self, M: np.ndarray, **kw) -> complex | float:
        return self._hand_over(ROUTE_DENSE, False, M, **kw)

    def sparse(self, M: np.ndarray, **kw) -> complex | float:
        return self._hand_over(ROUTE_SPARSE, False, M, **kw)

    def dense_batch(self, stack: np.ndarray, **kw) -> np.ndarray | None:
        return self._hand_over(ROUTE_DENSE, True, stack, **kw)

    def sparse_batch(self, stack: np.ndarray, **kw) -> np.ndarray | None:
        return self._hand_over(ROUTE_SPARSE, True, stack, **kw)

    def _hand_over(self, route: str, batched: bool, x: np.ndarray, *,
                device=None, ctx: Any | None = None, **kw):
        mesh = _mesh_of(ctx)
        name = producer(self.name, route, x.shape[-1], batched=batched,
                        mesh=mesh, device=device)
        if batched and name == "torch" != self.name:
            return None           # the caller's tagged torch-engine run
        return get_backend(name).compute(
            route, batched, x, device=_run_device(self.name, mesh, device),
            ctx=ctx, **kw)

    def compute(self, route: str, batched: bool, x: np.ndarray, *,
                precision: str, num_chunks: int, geometry=None, device=None,
                ctx: Any | None = None):
        """This strategy's own value of a ``route`` leaf (a bucket's (B,)
        ndarray when ``batched``), for what the producer rule hands it."""
        raise NotImplementedError


class TorchBackend(Backend):
    """Chunked torch engine (the reference's ``jnp`` counterpart)."""

    name = "torch"

    def compute(self, route, batched, x, *, precision, num_chunks,
                device=None, **_):
        if route == ROUTE_SPARSE:
            stack = x if batched else x[None]   # one matrix: a bucket of one
            vals = S.sparse_values(stack, *S.padded_ccs(stack), num_chunks,
                                   precision, device=device)
            return _host(vals) if batched else _scalar(vals[0])
        run = R.perm_ryser_batched if batched else R.perm_ryser_chunked
        vals = run(x, num_chunks=num_chunks, precision=precision,
                   device=device)
        return _host(vals) if batched else _scalar(vals)


class CudaBackend(Backend):
    """CUDA kernels, dense or sparse, real or complex, n >= 4: the scalar
    entry for a leaf, the batch-grid entry for a bucket."""

    name = "cuda"

    def compute(self, route, batched, x, *, precision, geometry=None,
                device=None, **_):
        from ..kernels import ops as K
        if route == ROUTE_SPARSE:
            with span("repro.dispatch.sparse.ccs"):
                ccs = S.padded_ccs(x)
            run = K.sparse_batched_values_cuda if batched \
                else K.sparse_value_cuda
            v = run(x, *ccs, precision=precision, geometry=geometry,
                    device=device)
        else:
            run = K.permanent_cuda_batched if batched else K.permanent_cuda
            v = run(x, precision=precision, geometry=geometry, device=device)
        with span("repro.dispatch.copy"):
            return _host(v) if batched else _scalar(v)


class DistributedBatchBackend(Backend):
    """Batch-axis sharding over the mesh of the context: a bucket (n >= 4)
    is cut into one contiguous share a rank
    (``distributed.batch_permanents_on_mesh`` /
    ``sparse_batch_permanents_on_mesh``, body ``cuda``): each rank owns
    whole matrices, a ragged tail is padded, and one gather returns the
    values in bucket order, each bit for bit the one-device ``cuda``
    backend's.  Scalar leaves, and everything without a mesh, the
    producer rule hands to ``cuda`` or ``torch``."""

    name = "distributed_batch"

    def compute(self, route, batched, x, *, precision, num_chunks,
                geometry=None, ctx=None, **_):
        from . import distributed as Dm
        run = Dm.sparse_batch_permanents_on_mesh if route == ROUTE_SPARSE \
            else Dm.batch_permanents_on_mesh
        return run(x, _mesh_of(ctx), precision=precision,
                   num_chunks=num_chunks, backend="cuda", geometry=geometry)


class DistributedBackend(Backend):
    """Mesh-wide: a scalar dense leaf (n >= 4) is split over the Gray-step
    space of the context's mesh (``distributed.permanent_on_mesh``, body
    ``cuda``; a ctx with its own ``permanent`` at the plan's precision,
    such as ``DistributedPermanent``, computes it instead).  Its buckets
    the producer rule hands to ``distributed_batch``, its scalar sparse
    leaves to ``cuda`` on every rank."""

    name = "distributed"

    def compute(self, route, batched, x, *, precision, geometry=None,
                ctx=None, **_):
        # a runner computes at ITS OWN precision: only honour it when that
        # is the plan's, else the value would be cached under a precision
        # it was never computed at
        if hasattr(ctx, "permanent") and \
                getattr(ctx, "precision", precision) == precision:
            return _scalar(ctx.permanent(x))
        from . import distributed as Dm
        return _scalar(Dm.permanent_on_mesh(x, _mesh_of(ctx),
                                            precision=precision,
                                            backend="cuda",
                                            geometry=geometry))


class CampaignBackend(Backend):
    """Checkpointed step-space waves for ROUTE_CAMPAIGN leaves.

    Not selected through ``SolverConfig.backend``: the planner routes a
    leaf here when its step estimate crosses ``campaign_threshold``, and
    the :class:`CampaignSpec` it records (slice geometry, wave-body
    backend, precision, kernel geometry) fully determines the numerics.
    Execution is ``core.distributed.run_campaign`` on ``device`` (over
    the ranks of the ctx's mesh when there is one), twofloat slice
    partials checkpointed to ``checkpoint_path`` after each wave, a
    fixed-order final reduce, in waves of
    ``distributed.default_wave_width`` slices (a rank).  A ``max_waves``
    budget that expires with slices pending raises ``CampaignPaused``
    (the checkpoint holds the progress).
    """

    name = "campaign"

    def campaign(self, M: np.ndarray, spec: CampaignSpec, *, device=None,
                 ctx: Any | None = None, checkpoint_path: str | None = None,
                 progress_cb=None,
                 max_waves: int | None = None) -> complex | float:
        from . import distributed as Dm
        mesh = _mesh_of(ctx)
        value, state = Dm.run_campaign(
            M, total_slices=spec.total_slices,
            chunks_per_slice=spec.chunks_per_slice,
            chunk_size=spec.chunk_size, precision=spec.precision,
            backend=spec.backend, geometry=spec.geometry,
            device=device if mesh is None else Dm._mesh_device(mesh, device),
            checkpoint_path=checkpoint_path, progress_cb=progress_cb,
            max_waves=max_waves, mesh=mesh)
        if value is None:
            raise Dm.CampaignPaused(state)
        return _scalar(value)


_BACKENDS: dict[str, Backend] = {}


def register_backend(backend: Backend, name: str | None = None) -> Backend:
    """Register a strategy object under ``name`` (default: backend.name)."""
    _BACKENDS[name or backend.name] = backend
    return backend


def get_backend(name: str) -> Backend:
    try:
        return _BACKENDS[name]
    except KeyError:
        raise ValueError(f"unknown backend {name!r}; registered: "
                         f"{sorted(_BACKENDS)}") from None


def available_backends() -> list[str]:
    return sorted(_BACKENDS)


register_backend(TorchBackend())
register_backend(CudaBackend())
register_backend(DistributedBackend())
register_backend(DistributedBatchBackend())
register_backend(CampaignBackend())


# ---------------------------------------------------------------------------
# Plan execution
# ---------------------------------------------------------------------------

def _geometry_tag(leaf: LeafTask, produced_by: str) -> str:
    """Geometry component of the cache key: the kernel geometry tag when a
    CUDA kernel serves the leaf (on one card or over a mesh), else the
    ``"-"`` sentinel."""
    g = leaf.geometry if produced_by in KERNEL_BACKENDS else None
    return g.tag() if g is not None else "-"


def _cache_key(leaf: LeafTask, plan: ExecutionPlan, produced_by: str) -> tuple:
    """Result-cache key for ``leaf``: content hash, route, effective
    precision, the VALUE-producing backend, chunk count, leaf dtype and
    resolved kernel geometry -- all seven components bound."""
    return ResultCache.key(leaf.key, leaf.route, plan.precision,
                           produced_by, plan.config.num_chunks,
                           dtype=leaf.matrix.dtype.str,
                           geometry=_geometry_tag(leaf, produced_by))


def _cached_as(leaf: LeafTask, cfg, mesh, batched: bool) -> str:
    """The producer a leaf's value is cached under: the rule's, or a
    campaign leaf's full wave-body identity -- backend, slice geometry and
    kernel geometry -- since its twofloat slice partials depend on the
    decomposition, not just the engine."""
    if leaf.route != ROUTE_CAMPAIGN:
        return producer(cfg.backend, leaf.route, leaf.n, batched=batched,
                        mesh=mesh, device=cfg.device)
    s = leaf.campaign
    return (f"campaign[{s.backend},{s.total_slices}x{s.chunks_per_slice}x"
            f"{s.chunk_size},{s.geometry.tag() if s.geometry else '-'}]")


def _inline_value(m: np.ndarray) -> complex | float:
    return m[0, 0] if m.shape[0] == 1 else \
        m[0, 0] * m[1, 1] + m[0, 1] * m[1, 0]


def execute_plan(plan: ExecutionPlan, *, cache: ResultCache | None = None,
                 distributed_ctx: Any | None = None,
                 campaign_progress=None):
    """Dispatch every leaf of ``plan`` and accumulate per-matrix totals.

    Returns ``(totals, reports, stats)``: ``totals`` is a (B,) complex128
    array (callers take the real part for real plans), ``reports`` one
    PermanentReport per planned matrix, ``stats`` the dispatch/cache
    accounting.  ``distributed_ctx`` (a ``launch.mesh.Mesh``, or an object
    with a ``.mesh``) is the mesh of the ``distributed`` strategies and of
    campaign waves; every rank of it executes the same plan.
    ``campaign_progress(state, wave)`` is called after every checkpointed
    wave of a campaign leaf.

    One loop runs the plan's units.  A unit is a leaf (a campaign leaf, a
    leaf of a scalar plan, a one-leaf bucket group whose scalar producer
    is its bucket's) or a bucket group of one kernel geometry: one device
    program.  A scalar plan's units are its leaves in plan order, each
    probed in the cache at its turn.  A batched plan probes every leaf
    first (n <= 2 leaves fold inline; a duplicate of a leaf scheduled in
    this batch waits as a follower), runs what missed in sorted bucket
    order, then serves the followers.
    """
    with span("repro.dispatch"):
        cfg = plan.config
        mesh = _mesh_of(distributed_ctx)
        stats = ExecStats()
        totals = np.zeros(plan.num_matrices, dtype=np.complex128)
        reports = [PermanentReport(n=e.n, nnz=e.nnz, density=e.density,
                                   dm_removed=e.dm_removed,
                                   fm_leaves=e.fm_leaves,
                                   leaf_sizes=list(e.leaf_sizes),
                                   precision=plan.precision,
                                   backend=cfg.backend)
                   for e in plan.entries]
        for e in plan.entries:
            totals[e.index] += e.const
        computed: dict[tuple, complex | float | None] = {}
        campaigns = sum(l.route == ROUTE_CAMPAIGN for l in plan.leaves)

        def tag(text: str, owners, downgrade: bool = False) -> None:
            if downgrade:
                stats.downgrades.append(text)
            for i in owners:
                reports[i].dispatch.append(text)

        if plan.precision_downgrade:
            tag(f"precision({plan.precision_downgrade})",
                range(len(reports)), True)

        def probe(key: tuple):
            """The value cached under ``key``, or None; counted."""
            val = cache.get(key)
            if val is None:
                stats.cache_misses += 1
            else:
                stats.cache_hits += 1
            return val

        def served(leaf: LeafTask, val) -> None:
            tag(f"cache({leaf.route},n={leaf.n})", [leaf.owner])
            totals[leaf.owner] += leaf.coef * val

        def put(leaf: LeafTask, key: tuple | None, val) -> None:
            if key is not None:
                cache.put(key, val)
                computed[key] = val
            totals[leaf.owner] += leaf.coef * val

        def timed(key: str, t0: float, leaves: int, batched: bool) -> None:
            stats.record_time(key, time.perf_counter() - t0, leaves=leaves)
            stats.device_dispatches += 1
            if batched:
                stats.batched_leaves += leaves
            else:
                stats.scalar_leaves += 1

        def compute(name: str, route: str, batched: bool, x, geometry):
            return get_backend(name).compute(
                route, batched, x, precision=plan.precision,
                num_chunks=cfg.num_chunks, geometry=geometry,
                device=_run_device(cfg.backend, mesh, cfg.device),
                ctx=distributed_ctx)

        def run_campaign(leaf: LeafTask) -> complex | float:
            """The checkpoint path is the configured one verbatim for a
            plan with one campaign leaf, suffixed by the leaf key when
            several (their JobStates must not collide)."""
            ckpt = cfg.campaign_checkpoint
            if ckpt is not None and campaigns > 1:
                ckpt = f"{ckpt}.{leaf.key[:12]}.npz"
            text = f"campaign(n={leaf.n},{leaf.campaign.backend})"
            tag(text, [leaf.owner])
            t0 = time.perf_counter()
            val = get_backend("campaign").campaign(
                leaf.matrix, leaf.campaign, device=cfg.device,
                ctx=distributed_ctx, checkpoint_path=ckpt,
                progress_cb=campaign_progress,
                max_waves=cfg.campaign_max_waves)
            timed(text, t0, 1, False)
            return val

        def run_leaf(leaf: LeafTask, name: str) -> complex | float:
            """One leaf through strategy ``name``'s scalar entry.  A sparse
            tag names the strategy, with a ``cfg->name`` suffix when it is
            not the configured backend."""
            n = leaf.n
            if leaf.route == ROUTE_SPARSE:
                down = name != cfg.backend
                tag(f"sparse(n={n},{cfg.backend}->{name})" if down
                    else f"sparse(n={n},{name})", [leaf.owner], down)
            else:
                tag(f"dense(n={n})", [leaf.owner])
            t0 = time.perf_counter()
            val = compute(name, leaf.route, False, leaf.matrix, leaf.geometry)
            timed(f"{leaf.route}(n={n},{name})", t0, 1, False)
            return val

        def run_bucket(leaves: list[LeafTask], name: str) -> list:
            """One device program over a bucket group; the torch engine
            standing in for a kernel backend is a downgrade."""
            route, n, b = leaves[0].route, leaves[0].n, len(leaves)
            down = name == "torch" != cfg.backend
            text = f"{route}_batch(n={n},b={b}" + \
                (f",{cfg.backend}->torch)" if down else ")")
            t0 = time.perf_counter()
            vals = compute(name, route, True,
                           np.stack([l.matrix for l in leaves]),
                           leaves[0].geometry)
            timed(f"{route}_batch(n={n},{name})", t0, b, True)
            tag(text, [l.owner for l in leaves], down)
            return [_scalar(v) for v in vals]

        # the units: (producer, [(leaf, cache key or None), ...])
        followers: list[tuple[LeafTask, tuple]] = []
        if plan.batched:
            pending: dict[tuple[str, int], list] = {}
            names: dict[tuple[str, int], str] = {}
            with span("repro.dispatch.probe"):
                for (route, n), idxs in plan.buckets.items():
                    name = names[route, n] = _cached_as(
                        plan.leaves[idxs[0]], cfg, mesh, True)
                    for j in idxs:
                        leaf = plan.leaves[j]
                        if route == ROUTE_INLINE:
                            tag(f"dense(n={n})", [leaf.owner])
                            totals[leaf.owner] += \
                                leaf.coef * _inline_value(leaf.matrix)
                            stats.inline_leaves += 1
                            continue
                        key = None
                        if cache is not None:
                            if route == ROUTE_CAMPAIGN:   # its own spec's
                                name = _cached_as(leaf, cfg, mesh, True)
                            key = _cache_key(leaf, plan, name)
                            if key in computed:
                                followers.append((leaf, key))
                                continue
                            val = probe(key)
                            if val is not None:
                                served(leaf, val)
                                continue
                            computed[key] = None  # filled by its unit
                        pending.setdefault((route, n), []).append((leaf, key))
            units = []
            for (route, n), pairs in sorted(pending.items()):
                if route == ROUTE_CAMPAIGN:    # each its own wave sequence
                    units += [(None, [p]) for p in pairs]
                    continue
                # one device program per resolved kernel geometry: geometry
                # is numeric identity, leaves of different geometry share
                # none
                groups: dict[str, list] = {}
                for p in pairs:
                    g = p[0].geometry
                    groups.setdefault(g.tag() if g is not None else "-",
                                      []).append(p)
                units += [(names[route, n], g)
                          for _, g in sorted(groups.items())]
        else:                       # probed at their turn, in plan order
            units = [(_cached_as(leaf, cfg, mesh, False), [(leaf, None)])
                     for leaf in plan.leaves]

        for name, pairs in units:
            leaf = pairs[0][0]
            if not plan.batched and cache is not None:
                with span("repro.dispatch.probe"):
                    key = _cache_key(leaf, plan, name)
                    val = probe(key)
                if val is not None:
                    served(leaf, val)
                    continue
                pairs = [(leaf, key)]
            if leaf.route == ROUTE_CAMPAIGN:
                vals = [run_campaign(leaf)]
            elif len(pairs) == 1 and (not plan.batched or name ==
                                      _cached_as(leaf, cfg, mesh, False)):
                # a one-leaf group takes the scalar path while that
                # produces the bucket's numerics (over a mesh a scalar
                # dense leaf is the step-space split, another family,
                # under a key the batched probes never read)
                vals = [run_leaf(leaf, name)]
            else:
                vals = run_bucket([l for l, _ in pairs], name)
            for (leaf, key), val in zip(pairs, vals):
                put(leaf, key, val)

        for leaf, key in followers:        # duplicates of scheduled leaves
            val = computed[key]
            if val is None:
                raise RuntimeError("scheduled leaf was never computed")
            cache.hits += 1                # in-flight dedup is still a hit
            stats.cache_hits += 1
            served(leaf, val)
        return totals, reports, stats
