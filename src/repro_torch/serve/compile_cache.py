"""Kernel-library cache wiring + bucket warm-up for the service.

The port of the reference package's ``serve/compile_cache.py``.  There, a
cold process pays an XLA compile for every bucket shape it meets, and
XLA's persistent compilation cache keeps the executables on disk.  Here
the port's CUDA kernels are ONE library that ``kernels/build.py`` builds
with ``nvcc`` at first use into a build root, keyed by a hash of the
sources and flags; a later process that finds it there loads it without
``nvcc``.  PyTorch runs eagerly, so no bucket shape compiles anything.
What a cold process still pays at its first bucket is the library load
(or build) and PyTorch's own first use of the operators the host glue
runs: the sparse route's leaf ordering (``kernels/ops.py::
order_sparse_leaves``: sorts, argsorts, scatters) costs 230-330 ms at
its first call on the card.

* :func:`enable_compile_cache` points the build root at a directory
  (``kernels/build.py::set_build_root``; the default stays
  ``build/repro_torch/`` in the repository).
* :func:`warmup` runs the serve plan's bucket geometries through a
  throwaway solver before traffic is admitted, and one sparse matrix of
  each warmed size, so the library is loaded and the sparse ordering's
  operators have run once before the first bucket.
* :func:`compile_stats` counts the library loads from the build root with
  the reference's keys; the metrics snapshot embeds it.
"""

from __future__ import annotations

import time
from typing import Sequence

import numpy as np

__all__ = ["enable_compile_cache", "compile_stats", "warmup",
           "quantized_batches"]

WARM_BAND = 5     # the least band degree DM/FM leave whole


def compile_stats() -> dict:
    """Cumulative kernel-library load counters for this process, under the
    reference's keys: ``requests`` counts loads of the library from the
    build root; each was a ``persistent_hits`` (loaded from disk, no
    ``nvcc``) or a ``persistent_misses`` (built by ``nvcc``, then loaded).
    All zero until a wrapper launched a kernel on the card (a CPU run
    never loads the library)."""
    from ..kernels.build import load_stats
    s = load_stats()
    return {"requests": s["requests"], "persistent_hits": s["hits"],
            "persistent_misses": s["misses"]}


def enable_compile_cache(path: str) -> str:
    """Build and load the kernel library under ``path`` (created if
    missing) from now on; returns the absolute path."""
    from ..kernels.build import set_build_root
    return str(set_build_root(path))


def quantized_batches(max_batch: int) -> tuple[int, ...]:
    """The device-batch sizes the serve loop dispatches: powers of two up
    to (and including, when itself a power of two) ``max_batch``, capped
    at the next power of two otherwise.

    Quantizing dispatch sizes bounds the shapes a stream produces: the
    loop pads a partial bucket up to the next size in this ladder (the
    reference's reason, one trace and compile per shape, does not hold
    here; the ladder is kept so both services dispatch the same
    buckets).
    """
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    out = []
    b = 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(b)                    # next pow2 >= max_batch
    return tuple(out)


def _band_matrix(rng, n: int, k: int, is_complex: bool = False) -> np.ndarray:
    """A permuted circulant band: k nonzeros (U(0.5, 1.5), or complex with
    both parts so) in every row and column, each on a perfect matching.
    With k >= 5 DM and FM leave it whole (FM folds columns of degree up to
    4: a band of 4 folds to constants), so it stays one sparse leaf of size
    n when k / n < 0.30 (a random mask of that density instead leaves rows
    of one or two nonzeros, whose DM/FM planning takes seconds a matrix at
    n = 24)."""
    i = np.arange(n)
    M = np.zeros((n, n), dtype=np.complex128 if is_complex else np.float64)
    for o in range(k):
        v = rng.uniform(0.5, 1.5, n)
        if is_complex:
            v = v + 1j * rng.uniform(0.5, 1.5, n)
        M[i, (i + o) % n] = v
    return M[rng.permutation(n)][:, rng.permutation(n)]


def warmup(config, geometries: Sequence[tuple], *, distributed_ctx=None,
           seed: int = 0, progress=None) -> dict:
    """Run every bucket geometry in ``geometries`` once before traffic
    arrives.

    ``config`` is the serving :class:`~repro_torch.core.planner.SolverConfig`;
    ``geometries`` is an iterable of ``(n, batch)`` or
    ``(n, batch, is_complex)`` tuples -- typically every ``n`` the
    service expects crossed with :func:`quantized_batches`.  Runs each
    geometry once through a throwaway solver (result cache off, so the
    synthetic matrices never pollute the serving cache) with the serving
    config -- its ``geometry`` override and ``tuning_table`` too, so the
    buckets are planned with the kernel geometry the live loop will
    launch and a tuned service warms exactly those launches; then one
    sparse matrix of each (n, is_complex) it
    warmed (``_band_matrix`` of degree 5, a sparse leaf from n = 17 on), so
    the sparse route's host operators run once too.  This adds no
    knob: the sparse pass follows from the geometries.  With a
    ``distributed_ctx`` (a ``launch.mesh.Mesh``) the throwaway solver runs
    over it, as the service's does: every rank of the mesh calls this with
    the same arguments and warms the same seeded geometries in the same
    order, so the mesh functions see identical calls.
    Returns ``{"geometries", "seconds", "compile"}`` where ``compile`` is
    the :func:`compile_stats` delta of the pass.
    """
    from ..core.solver import PermanentSolver

    solver = PermanentSolver(config.replace(cache=False),
                             distributed_ctx=distributed_ctx)
    rng = np.random.default_rng(seed)
    before = compile_stats()
    t0 = time.perf_counter()
    done = 0
    kinds: dict[tuple[int, bool], None] = {}
    for geom in geometries:
        n, batch = geom[0], geom[1]
        is_complex = bool(geom[2]) if len(geom) > 2 else False
        mats = rng.uniform(-1.0, 1.0, (batch, n, n))
        if is_complex:
            mats = mats + 1j * rng.uniform(-1.0, 1.0, (batch, n, n))
        solver.execute(solver.plan_batch(list(mats)))
        kinds[(n, is_complex)] = None
        done += 1
        if progress is not None:
            progress(n, batch, is_complex)
    for n, is_complex in kinds:
        solver.execute(solver.plan_batch(
            [_band_matrix(rng, n, WARM_BAND, is_complex)]))
    after = compile_stats()
    return {"geometries": done,
            "seconds": time.perf_counter() - t0,
            "compile": {k: after[k] - before[k] for k in after}}
