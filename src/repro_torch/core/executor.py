"""Execute side of the plan/execute split: backend registry + dispatcher.

The port of the reference package's ``core/executor.py`` for the dense,
sparse and campaign routes, real and complex.  Each :class:`Backend` runs
one leaf and (optionally) a whole same-size bucket of either route;
``register_backend`` adds strategies without touching the dispatcher.
Five register at import:

* ``torch`` -- the chunked torch engines (``core/ryser.py``, sparse
  ``core/sparyser.py``), the counterpart of the reference's ``jnp``;
* ``cuda``  -- the CUDA kernels (``kernels/ops.py``), the counterpart of
  ``pallas``: real dense scalar leaves run the dense scalar entry
  (``baseline``), buckets the batch-grid entry (``batched``); complex
  leaves and buckets run the split-plane kernel's two entries; sparse
  leaves and buckets (density < 0.30) the SpaRyser kernel's scalar and
  batched entries, real or complex; n < 4 runs the torch engine, as
  ``PallasBackend._kernel_ok`` sends n < 4 to ``jnp``;
* ``campaign`` -- not selected by ``SolverConfig.backend``: the planner
  routes a leaf whose step estimate exceeds ``campaign_threshold`` to
  ``step_sharded``, and :class:`CampaignBackend` runs it as checkpointed
  waves of slices (``core/distributed.py::run_campaign``) through the wave
  body its ``CampaignSpec`` names: the scalar CUDA entry from a u64 chunk
  base (real ``batched`` mode, or the split-plane kernel) under ``cuda``,
  the torch engine under ``torch``.  Its tag is ``campaign(n=..,cuda)``;
  a ``campaign_max_waves`` budget that runs out raises
  :class:`~repro_torch.core.distributed.CampaignPaused` through
  :func:`execute_plan`; with a mesh in the context its waves span the
  mesh's ranks;
* ``distributed_batch`` -- a bucket's batch axis sharded over the ranks
  of the mesh in ``execute_plan(..., distributed_ctx=)``
  (``distributed.batch_permanents_on_mesh`` /
  ``sparse_batch_permanents_on_mesh``); each rank's body is ``cuda``
  (the kernels on the card, their plain versions on the CPU, the torch
  engine below the kernel floor n < 4, as ``cuda`` does); a scalar leaf
  runs as under ``cuda`` on every rank;
* ``distributed`` -- as ``distributed_batch``, and a scalar dense leaf is
  split over the Gray-step space of the mesh (``permanent_on_mesh``).

Without a mesh both ``distributed`` strategies run as ``cuda`` on a card
(the kernels, never the torch engine, serve card tensors), and as
``torch`` on the CPU: buckets with a ``distributed->torch`` downgrade tag
(the reference's ``distributed->jnp``).  A value's cache identity names the strategy
whose numerics produced it (``value_backend``), so a torch-engine
downgrade never satisfies a sharded lookup.  The ``distributed_ctx`` is a
``launch.mesh.Mesh`` or any object with a ``.mesh`` (e.g.
``distributed.DistributedPermanent``); every rank of the mesh executes
the same plan.

All run on ``SolverConfig.device`` (None = the card).  A complex ``qq``
plan runs as ``kahan`` and says so with a ``precision(qq->kahan)`` tag on
every report.  Scalar sparse tags name the value's producer,
``sparse(n=..,cuda)``, with a ``cuda->torch`` suffix when the torch
engine serves an n < 4 leaf.

**Batch contract.**  ``dense_batch(stack, *, precision, num_chunks,
geometry, device)`` and ``sparse_batch(stack, ...)`` run one same-size
bucket as a single device program and return a (B,) ndarray, or ``None`` for
"unsupported for this bucket": the dispatcher then re-runs it on ``torch``
and tags the downgrade ``dense_batch(n=..,b=..,cuda->torch)`` (or
``sparse_batch(...)``).  ``value_backend`` names the
strategy whose numerics produce a leaf's value; the result cache keys on
THAT name, so a torch-computed downgrade never satisfies a kernel lookup.

:func:`execute_plan` returns per-matrix totals, one
:class:`PermanentReport` per matrix and an :class:`ExecStats`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from . import ryser as R
from . import sparyser as S
from .cache import ResultCache
from .planner import (KERNEL_BACKENDS, ROUTE_CAMPAIGN, ROUTE_DENSE,
                      ROUTE_INLINE, ROUTE_SPARSE, CampaignSpec, ExecutionPlan,
                      LeafTask, PermanentReport)

__all__ = ["Backend", "TorchBackend", "CudaBackend", "DistributedBackend",
           "DistributedBatchBackend", "CampaignBackend",
           "register_backend", "get_backend", "available_backends",
           "ExecStats", "LeafTiming", "execute_plan"]


def _ctx_mesh(ctx):
    """The port ``Mesh`` of a distributed ctx (a Mesh, or an object with
    a ``.mesh``), else None."""
    if ctx is None:
        return None
    from ..launch.mesh import Mesh
    mesh = getattr(ctx, "mesh", ctx)
    return mesh if isinstance(mesh, Mesh) else None


def _on_card(device) -> bool:
    """Whether ``device`` (None = the card) names a card; whether one is
    present is the kernels' wrappers' to check."""
    return device is None or torch.device(device).type == "cuda"


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

    ``dense`` / ``sparse`` run a single leaf and return a Python scalar;
    ``dense_batch`` / ``sparse_batch`` follow the batch contract in the
    module docstring.  Every strategy gets the leaf's dense matrix (a
    stack for a bucket); a sparse strategy builds the padded CCS arrays it
    needs from it (``sparyser.padded_ccs``), so nothing is rebuilt from
    CRS.
    ``geometry`` is the leaf's resolved kernel geometry (None = kernel
    defaults); the torch engine ignores it.  Times are host wall-clock
    around work that ends in a copy to the host, so they include the
    device's work.
    """

    name = "?"

    def dense(self, M: np.ndarray, *, precision: str, num_chunks: int,
              geometry=None, device=None,
              ctx: Any | None = None) -> complex | float:
        raise NotImplementedError

    def sparse(self, M: np.ndarray, *, precision: str, num_chunks: int,
               geometry=None, device=None,
               ctx: Any | None = None) -> complex | float:
        raise NotImplementedError

    def dense_batch(self, stack: np.ndarray, *, precision: str,
                    num_chunks: int, geometry=None, device=None,
                    ctx: Any | None = None) -> np.ndarray | None:
        return None

    def sparse_batch(self, stack: np.ndarray, *, precision: str,
                     num_chunks: int, geometry=None, device=None,
                     ctx: Any | None = None) -> np.ndarray | None:
        return None

    def value_backend(self, route: str, n: int, *, batched: bool,
                      ctx: Any | None = None, device=None) -> str:
        """Registry name of the strategy whose numerics produce this leaf's
        value (the result-cache identity) on ``device`` (None = the
        card)."""
        return self.name


class TorchBackend(Backend):
    """Chunked torch engine (the reference's ``jnp`` counterpart)."""

    name = "torch"

    def dense(self, M, *, precision, num_chunks, geometry=None, device=None,
              ctx=None):
        return _scalar(R.perm_ryser_chunked(M, num_chunks=num_chunks,
                                            precision=precision,
                                            device=device))

    def sparse(self, M, *, precision, num_chunks, geometry=None,
               device=None, ctx=None):
        stack = M[None]              # a one-matrix bucket, as the reference
        return _scalar(S.sparse_values(stack, *S.padded_ccs(stack),
                                       num_chunks, precision,
                                       device=device)[0])

    def dense_batch(self, stack, *, precision, num_chunks, geometry=None,
                    device=None, ctx=None):
        return _host(R.perm_ryser_batched(stack, num_chunks=num_chunks,
                                          precision=precision, device=device))

    def sparse_batch(self, stack, *, precision, num_chunks, geometry=None,
                     device=None, ctx=None):
        return _host(S.sparse_values(stack, *S.padded_ccs(stack), num_chunks,
                                     precision, device=device))


class CudaBackend(TorchBackend):
    """CUDA kernels, dense or sparse, real or complex, n >= 4 (scalar entry
    for leaves, batch-grid entry for buckets); n < 4 runs the torch engine
    (dense scalar silently, sparse scalar with a ``sparse(n=..,cuda->torch)``
    tag, buckets with a ``cuda->torch`` downgrade tag)."""

    name = "cuda"

    @staticmethod
    def _kernel_ok(n: int) -> bool:
        return n >= 4

    def dense(self, M, *, precision, num_chunks, geometry=None, device=None,
              ctx=None):
        if self._kernel_ok(M.shape[-1]):
            from ..kernels import ops as K
            return _scalar(K.permanent_cuda(M, precision=precision,
                                            geometry=geometry,
                                            device=device))
        return super().dense(M, precision=precision, num_chunks=num_chunks,
                             device=device)

    def sparse(self, M, *, precision, num_chunks, geometry=None,
               device=None, ctx=None):
        if self._kernel_ok(M.shape[-1]):
            from ..kernels import ops as K
            return _scalar(K.sparse_value_cuda(M, *S.padded_ccs(M),
                                               precision=precision,
                                               geometry=geometry,
                                               device=device))
        return super().sparse(M, precision=precision, num_chunks=num_chunks,
                              device=device)

    def dense_batch(self, stack, *, precision, num_chunks, geometry=None,
                    device=None, ctx=None):
        if self._kernel_ok(stack.shape[-1]):
            from ..kernels import ops as K
            return _host(K.permanent_cuda_batched(
                stack, precision=precision, geometry=geometry,
                device=device))
        return None                  # dispatcher falls back + tags downgrade

    def sparse_batch(self, stack, *, precision, num_chunks, geometry=None,
                     device=None, ctx=None):
        if self._kernel_ok(stack.shape[-1]):
            from ..kernels import ops as K
            return _host(K.sparse_batched_values_cuda(
                stack, *S.padded_ccs(stack), precision=precision,
                geometry=geometry, device=device))
        return None                  # tiny bucket: torch fallback, tagged

    def value_backend(self, route, n, *, batched, ctx=None, device=None):
        # dense and sparse kernels alike; below the floor the torch engines
        return "cuda" if self._kernel_ok(n) else "torch"


class DistributedBatchBackend(CudaBackend):
    """Batch-axis sharding over the mesh of the context.

    ``dense_batch`` / ``sparse_batch`` cut a bucket (n >= 4) into one
    contiguous share a rank (``distributed.batch_permanents_on_mesh`` /
    ``sparse_batch_permanents_on_mesh``, body ``cuda``): each rank owns
    whole matrices, a ragged tail is padded, and one gather returns the
    values in bucket order, each bit for bit the one-device ``cuda``
    backend's.  A scalar leaf runs as under ``cuda``, on every rank (a
    one-matrix bucket has nothing to shard), on the mesh's device.
    Without a mesh, on a card it runs as ``cuda`` (a world of one rank
    has nothing to shard: the kernels, never the torch engine, serve card
    tensors); on the CPU as ``torch``, buckets tagged
    ``distributed_batch->torch`` (the reference's ``->jnp`` downgrade).
    n < 4 buckets return None, as ``cuda``'s do, and run on ``torch``
    with a tag.
    """

    name = "distributed_batch"

    @staticmethod
    def _device(ctx, device):
        """This rank's device: the mesh's, or ``device`` without one."""
        mesh = _ctx_mesh(ctx)
        if mesh is None:
            return device
        from .distributed import _mesh_device
        return _mesh_device(mesh, device)

    @staticmethod
    def _plain(ctx, device) -> bool:
        """No mesh and the CPU: the reference's downgrade to the torch
        engine."""
        return _ctx_mesh(ctx) is None and not _on_card(device)

    def dense(self, M, *, precision, num_chunks, geometry=None, device=None,
              ctx=None):
        if self._plain(ctx, device):
            return TorchBackend.dense(self, M, precision=precision,
                                      num_chunks=num_chunks, device=device)
        return super().dense(M, precision=precision, num_chunks=num_chunks,
                             geometry=geometry,
                             device=self._device(ctx, device))

    def sparse(self, M, *, precision, num_chunks, geometry=None,
               device=None, ctx=None):
        if self._plain(ctx, device):
            return TorchBackend.sparse(self, M, precision=precision,
                                       num_chunks=num_chunks, device=device)
        return super().sparse(M, precision=precision, num_chunks=num_chunks,
                              geometry=geometry,
                              device=self._device(ctx, device))

    def dense_batch(self, stack, *, precision, num_chunks, geometry=None,
                    device=None, ctx=None):
        mesh = _ctx_mesh(ctx)
        if mesh is None:             # the card's kernels, or the CPU's
            return None if self._plain(ctx, device) else super().dense_batch(
                stack, precision=precision, num_chunks=num_chunks,
                geometry=geometry, device=device)
        if not self._kernel_ok(stack.shape[-1]):
            return None              # the dispatcher's tagged torch run
        from . import distributed as Dm
        self._device(ctx, device)
        return Dm.batch_permanents_on_mesh(
            stack, mesh, precision=precision, num_chunks=num_chunks,
            backend="cuda", geometry=geometry)

    def sparse_batch(self, stack, *, precision, num_chunks, geometry=None,
                     device=None, ctx=None):
        mesh = _ctx_mesh(ctx)
        if mesh is None:
            return None if self._plain(ctx, device) else super().sparse_batch(
                stack, precision=precision, num_chunks=num_chunks,
                geometry=geometry, device=device)
        if not self._kernel_ok(stack.shape[-1]):
            return None
        from . import distributed as Dm
        self._device(ctx, device)
        return Dm.sparse_batch_permanents_on_mesh(
            stack, mesh, precision=precision, num_chunks=num_chunks,
            backend="cuda", geometry=geometry)

    def value_backend(self, route, n, *, batched, ctx=None, device=None):
        if self._plain(ctx, device) or not self._kernel_ok(n):
            return "torch"
        if _ctx_mesh(ctx) is None:
            return "cuda"
        return self.name if batched else "cuda"


class DistributedBackend(DistributedBatchBackend):
    """Mesh-wide: a scalar dense leaf (n >= 4) is split over the Gray-step
    space of the context's mesh (``distributed.permanent_on_mesh``, body
    ``cuda``; a ctx with its own ``permanent`` at the plan's precision,
    such as ``DistributedPermanent``, computes it instead); buckets are
    ``distributed_batch``'s; scalar sparse leaves run as under ``cuda`` on
    every rank.  Without a mesh it runs as ``distributed_batch`` does:
    ``cuda`` on a card, ``torch`` on the CPU (buckets tagged
    ``distributed->torch``).
    """

    name = "distributed"

    def dense(self, M, *, precision, num_chunks, geometry=None, device=None,
              ctx=None):
        mesh = _ctx_mesh(ctx)
        if mesh is None or not self._kernel_ok(M.shape[-1]):
            return super().dense(M, precision=precision,
                                 num_chunks=num_chunks, geometry=geometry,
                                 device=device, ctx=ctx)
        self._device(ctx, device)
        # a runner computes at ITS OWN precision: only honour it when that
        # is the plan's, else the value would be cached under a precision
        # it was never computed at
        if hasattr(ctx, "permanent") and \
                getattr(ctx, "precision", precision) == precision:
            return _scalar(ctx.permanent(M))
        from . import distributed as Dm
        return _scalar(Dm.permanent_on_mesh(M, mesh, precision=precision,
                                            backend="cuda",
                                            geometry=geometry))

    def value_backend(self, route, n, *, batched, ctx=None, device=None):
        if not batched and route == ROUTE_DENSE and self._kernel_ok(n) \
                and _ctx_mesh(ctx) is not None:
            return self.name
        if batched and _ctx_mesh(ctx) is not None and self._kernel_ok(n):
            return "distributed_batch"
        return super().value_backend(route, n, batched=batched, ctx=ctx,
                                     device=device)


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
        mesh = _ctx_mesh(ctx)
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

_FALLBACK = "torch"


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


def _run_leaf(leaf: LeafTask, plan: ExecutionPlan, backend: Backend,
              report: PermanentReport, stats: ExecStats,
              ctx: Any | None = None) -> complex | float:
    """One dense or sparse leaf through the scalar strategy path.  Sparse
    tags name the value's producer, ``sparse(n=..,<backend>)``, with a
    ``cfg->produced`` suffix when another strategy serves the leaf."""
    n = leaf.n
    cfg = plan.config
    produced = backend.value_backend(leaf.route, n, batched=False, ctx=ctx,
                                     device=cfg.device)
    kw = dict(precision=plan.precision, num_chunks=cfg.num_chunks,
              geometry=leaf.geometry, device=cfg.device, ctx=ctx)
    if leaf.route == ROUTE_SPARSE:
        if produced == cfg.backend:
            tag = f"sparse(n={n},{produced})"
        else:
            tag = f"sparse(n={n},{cfg.backend}->{produced})"
            stats.downgrades.append(tag)
        report.dispatch.append(tag)
        t0 = time.perf_counter()
        val = backend.sparse(leaf.matrix, **kw)
    else:
        report.dispatch.append(f"dense(n={n})")
        t0 = time.perf_counter()
        val = backend.dense(leaf.matrix, **kw)
    stats.record_time(f"{leaf.route}(n={n},{produced})",
                      time.perf_counter() - t0)
    stats.device_dispatches += 1
    stats.scalar_leaves += 1
    return val


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
    """
    cfg = plan.config
    backend = get_backend(cfg.backend)
    fallback = get_backend(_FALLBACK)
    stats = ExecStats()
    totals = np.zeros(plan.num_matrices, dtype=np.complex128)
    reports = [PermanentReport(n=e.n, nnz=e.nnz, density=e.density,
                               dm_removed=e.dm_removed,
                               fm_leaves=e.fm_leaves,
                               leaf_sizes=list(e.leaf_sizes),
                               precision=plan.precision, backend=cfg.backend)
               for e in plan.entries]
    for e in plan.entries:
        totals[e.index] += e.const
    if plan.precision_downgrade:
        ptag = f"precision({plan.precision_downgrade})"
        stats.downgrades.append(ptag)
        for r in reports:
            r.dispatch.append(ptag)

    def produced_by(leaf: LeafTask, batched: bool) -> str:
        """Name of the strategy whose numerics serve this leaf.  Campaign
        leaves name the full wave-body identity of their spec -- backend,
        slice geometry and kernel geometry -- since their twofloat slice
        partials depend on the decomposition, not just the engine."""
        if leaf.route == ROUTE_CAMPAIGN:
            s = leaf.campaign
            return (f"campaign[{s.backend},{s.total_slices}x"
                    f"{s.chunks_per_slice}x{s.chunk_size},"
                    f"{s.geometry.tag() if s.geometry else '-'}]")
        return backend.value_backend(leaf.route, leaf.n, batched=batched,
                                     ctx=distributed_ctx, device=cfg.device)

    campaign_leaves = [l for l in plan.leaves if l.route == ROUTE_CAMPAIGN]

    def campaign_ckpt(leaf: LeafTask) -> str | None:
        """The configured checkpoint path verbatim for a plan with one
        campaign leaf, suffixed by the leaf key when several campaign
        (their JobStates must not collide)."""
        base = cfg.campaign_checkpoint
        if base is None or len(campaign_leaves) == 1:
            return base
        return f"{base}.{leaf.key[:12]}.npz"

    def run_campaign_leaf(leaf: LeafTask) -> complex | float:
        tag = f"campaign(n={leaf.n},{leaf.campaign.backend})"
        reports[leaf.owner].dispatch.append(tag)
        t0 = time.perf_counter()
        val = get_backend("campaign").campaign(
            leaf.matrix, leaf.campaign, device=cfg.device,
            ctx=distributed_ctx, checkpoint_path=campaign_ckpt(leaf),
            progress_cb=campaign_progress,
            max_waves=cfg.campaign_max_waves)
        stats.record_time(tag, time.perf_counter() - t0)
        stats.device_dispatches += 1
        stats.scalar_leaves += 1
        return val

    if not plan.batched:
        # scalar mode: strict plan-order per-leaf dispatch
        for leaf in plan.leaves:
            key = val = None
            if cache is not None:
                key = _cache_key(leaf, plan, produced_by(leaf, False))
                val = cache.get(key)
                if val is None:
                    stats.cache_misses += 1
                else:
                    stats.cache_hits += 1
            if val is not None:
                reports[leaf.owner].dispatch.append(
                    f"cache({leaf.route},n={leaf.n})")
            else:
                val = run_campaign_leaf(leaf) \
                    if leaf.route == ROUTE_CAMPAIGN else \
                    _run_leaf(leaf, plan, backend, reports[leaf.owner], stats,
                              distributed_ctx)
                if key is not None:
                    cache.put(key, val)
            totals[leaf.owner] += leaf.coef * val
        return totals, reports, stats

    # batched mode: inline folds, cache probe (duplicate leaves of one
    # cold batch are scheduled once), then one program per bucket
    pending: dict[tuple[str, int], list[int]] = {}
    computed: dict[tuple, complex | float | None] = {}
    followers: list[LeafTask] = []
    for (route, n), idxs in plan.buckets.items():
        for j in idxs:
            leaf = plan.leaves[j]
            if route == ROUTE_INLINE:
                reports[leaf.owner].dispatch.append(f"dense(n={n})")
                totals[leaf.owner] += leaf.coef * _inline_value(leaf.matrix)
                stats.inline_leaves += 1
                continue
            if cache is not None:
                key = _cache_key(leaf, plan, produced_by(leaf, True))
                if key in computed:
                    followers.append(leaf)
                    continue
                val = cache.get(key)
                if val is not None:
                    stats.cache_hits += 1
                    reports[leaf.owner].dispatch.append(
                        f"cache({route},n={n})")
                    totals[leaf.owner] += leaf.coef * val
                    continue
                stats.cache_misses += 1
                computed[key] = None      # scheduled; filled after its bucket
            pending.setdefault((route, n), []).append(j)

    for (route, n), idxs in sorted(pending.items()):
        if route == ROUTE_CAMPAIGN:
            # campaign leaves never share a device program: each is its
            # own checkpointed wave sequence (probe key == store key)
            for j in idxs:
                leaf = plan.leaves[j]
                val = run_campaign_leaf(leaf)
                if cache is not None:
                    k = _cache_key(leaf, plan, produced_by(leaf, True))
                    cache.put(k, val)
                    computed[k] = val
                totals[leaf.owner] += leaf.coef * val
            continue
        # one device program per resolved kernel geometry: geometry is
        # numeric identity, so leaves of different geometry never share one
        groups: dict[str, list[LeafTask]] = {}
        for j in idxs:
            leaf = plan.leaves[j]
            gtag = leaf.geometry.tag() if leaf.geometry is not None else "-"
            groups.setdefault(gtag, []).append(leaf)
        for _gtag, leaves in sorted(groups.items()):
            bname = produced_by(leaves[0], True)
            geometry = leaves[0].geometry
            # ragged straggler: the scalar path, while it produces the
            # bucket's numerics (over a mesh a scalar dense leaf is the
            # step-space split, another family, and its cache entry would
            # sit under a key the batched probes never read)
            if len(leaves) == 1 and bname == produced_by(leaves[0], False):
                leaf = leaves[0]
                val = _run_leaf(leaf, plan, backend, reports[leaf.owner],
                                stats, distributed_ctx)
                if cache is not None:
                    k = _cache_key(leaf, plan, bname)
                    cache.put(k, val)
                    computed[k] = val
                totals[leaf.owner] += leaf.coef * val
                continue
            tag = f"{route}_batch(n={n},b={len(leaves)})"
            t_bucket = time.perf_counter()
            stack = np.stack([l.matrix for l in leaves])
            run, run_fallback = (
                (backend.dense_batch, fallback.dense_batch)
                if route == ROUTE_DENSE else
                (backend.sparse_batch, fallback.sparse_batch))
            vals = run(stack, precision=plan.precision,
                       num_chunks=cfg.num_chunks, geometry=geometry,
                       device=cfg.device, ctx=distributed_ctx)
            if vals is None:             # tiny bucket, or no mesh on the CPU
                vals = run_fallback(stack, precision=plan.precision,
                                    num_chunks=cfg.num_chunks,
                                    device=cfg.device)
                tag = f"{route}_batch(n={n},b={len(leaves)}," \
                      f"{cfg.backend}->{_FALLBACK})"
                stats.downgrades.append(tag)
                bname = _FALLBACK
            stats.device_dispatches += 1
            stats.batched_leaves += len(leaves)
            stats.record_time(f"{route}_batch(n={n},{bname})",
                              time.perf_counter() - t_bucket,
                              leaves=len(leaves))
            for leaf, v in zip(leaves, vals):
                v = _scalar(v)
                reports[leaf.owner].dispatch.append(tag)
                if cache is not None:
                    cache.put(_cache_key(leaf, plan, bname), v)
                    computed[_cache_key(leaf, plan,
                                        produced_by(leaf, True))] = v
                totals[leaf.owner] += leaf.coef * v

    for leaf in followers:               # duplicates of scheduled leaves
        val = computed[_cache_key(leaf, plan, produced_by(leaf, True))]
        if val is None:
            raise RuntimeError("scheduled leaf was never computed")
        cache.hits += 1                  # in-flight dedup is still a hit
        stats.cache_hits += 1
        reports[leaf.owner].dispatch.append(
            f"cache({leaf.route},n={leaf.n})")
        totals[leaf.owner] += leaf.coef * val
    return totals, reports, stats
