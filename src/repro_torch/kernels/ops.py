"""Entry points around the CUDA Ryser kernels: dense and sparse, real and
complex.

The port of the reference package's ``kernels/ops.py``.
``permanent_cuda(A)`` computes perm(A) with the dense scalar kernel entry
(``mode="baseline"``, or ``batched`` or ``schedmat``);
``permanent_cuda_batched(As)`` covers a same-size
stack with one (block, batch)-grid launch (``mode="batched"``).  Both go
through ``_cuda_values``: geometry, padding, NW base vectors and the
twofloat cross-block epilogue ``kernel_reduce`` are shared, only the
kernel entry differs.  Real input launches ``ryser_dense.cu``; complex
input launches the split-plane kernel ``ryser_complex.cu`` in its only
mode, ``batched``, and ``kernel_reduce`` runs once per plane.

The sparse arm has the same shape: ``sparse_value_cuda`` /
``sparse_batched_values_cuda`` take dense forms with their padded CCS
arrays (the executor's path), ``permanent_cuda_sparse(sp)`` /
``permanent_cuda_sparse_batched(sps)`` take ``SparseMatrix`` input; all
drive the padded-CCS SpaRyser kernels of ``ryser_sparse.cu`` through
``_cuda_sparse_values``, sharing padding, the NW base vectors,
``prepare``/``prepare_complex`` and ``kernel_reduce`` with the dense arm;
the CCS ``rows`` travel as int32.  A real sparse leaf is first permuted
(``order_sparse_leaves``) so that the kernel's low columns touch few rows,
which come first: the real sparse kernel skips the window states of the
rest.  The permutation depends on the leaf alone and a scalar sparse leaf
and its bucket entry run one kernel body from chunk 0, so they agree bit
for bit.
``block_partials_cuda`` exposes the raw per-block real dense partials over
any chunk window.

``campaign_slice_sums`` is the wave body of a step-space campaign
(``core/distributed.py``): the per-slice twofloat sums of a run of
contiguous slices from ONE launch of the scalar entry from a u64 chunk
base (real: ``batched`` mode, complex: the split-plane kernel), or from
the torch engine's chunk partials at the same offset.

``device=None`` means the card.  On a CPU tensor the kernel wrappers run
their plain PyTorch versions instead.  f32 and complex64 input, dense and
sparse, keep their dtype through kernel, partials and ``kernel_reduce``
(the ``_f32`` entries), as the reference's follows its input; other real
input is taken as f64, other complex input as complex128.  A campaign's
wave body does the same (#1's and #3's ``_f32`` entries from a u64 chunk
base).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import precision as P
from ..core.ryser import (_final_factor, _small_n, chain_prod,
                          chain_prod_complex,
                          chunk_partial_sums, chunk_partial_sums_complex,
                          is_complex, nw_base_vector, resolve_device)
from ..core.sparyser import pack_padded_ccs
from ..core.stepspace import DEFAULT_GEOMETRY, Geometry
from ..utils.spans import span
from .ryser_complex_cuda import (ctas_per_sm_complex, ryser_cuda_call_complex,
                                 ryser_cuda_call_complex_batched)
from .ryser_cuda import ctas_per_sm, ryser_cuda_call, ryser_cuda_call_batched
from .ryser_sparse_cuda import (ryser_sparse_cuda_call,
                                ryser_sparse_cuda_call_batched,
                                ryser_sparse_cuda_call_complex,
                                ryser_sparse_cuda_call_complex_batched)

__all__ = ["Geometry", "DEFAULT_GEOMETRY", "permanent_cuda",
           "permanent_cuda_batched", "permanent_cuda_sparse",
           "permanent_cuda_sparse_batched", "sparse_value_cuda",
           "sparse_batched_values_cuda",
           "block_partials_cuda", "campaign_slice_sums", "wave_geometry",
           "wave_precision", "wave_ctas_per_sm", "kernel_reduce",
           "order_sparse_leaves",
           "pad_matrix", "pad_base_vector", "prepare", "prepare_complex",
           "prepare_sparse", "sparse_leaf_order",
           "split_matrix_planes", "split_base_planes", "tree_sum"]

_PAD = 8  # the kernel is instantiated for n_pad in 8, 16, ..., 64


def pad_matrix(A, n_pad: int | None = None):
    """Zero-pad the last two axes of A to (n_pad, n_pad); the padded base
    entries are 1 (``pad_base_vector``), so products are unaffected."""
    n = A.shape[-1]
    if n_pad is None:
        n_pad = max(_PAD, int(math.ceil(n / _PAD)) * _PAD)
    out = torch.zeros(A.shape[:-2] + (n_pad, n_pad), dtype=A.dtype,
                      device=A.device)
    out[..., :n, :n] = A
    return out


def pad_base_vector(x, n_pad: int):
    """Pad the last axis of x to n_pad with ones."""
    n = x.shape[-1]
    out = torch.ones(x.shape[:-1] + (n_pad,), dtype=x.dtype, device=x.device)
    out[..., :n] = x
    return out


def split_matrix_planes(A):
    """Zero-padded (re, im) f64 planes of a complex matrix or stack."""
    return pad_matrix(A.real), pad_matrix(A.imag)


def split_base_planes(xb, n_pad: int):
    """Padded (re, im) planes (..., n_pad, 1) of complex NW base
    vector(s): re pads with ones, im with zeros, so padded rows multiply
    by (1 + 0i)."""
    return (pad_base_vector(xb.real, n_pad)[..., None],
            torch.nn.functional.pad(xb.imag, (0, n_pad - xb.shape[-1]))
            [..., None])


def tree_sum(x):
    """Fixed-order pairwise sum over the last axis (odd tails peeled per
    level) -- the association never depends on the device or batch."""
    L = x.shape[-1]
    while L > 1:
        half = L // 2
        s = x[..., :half] + x[..., half:2 * half]
        x = s if L == 2 * half else torch.cat([s, x[..., 2 * half:]], dim=-1)
        L = (L + 1) // 2
    return x[..., 0]


def kernel_reduce(parts_hi, parts_lo, p0, n: int):
    """Cross-block twofloat epilogue: sum the per-block (hi, lo) partials
    over the last axis with fixed-order trees, fold in the base (g = 0)
    product and apply the final Ryser factor."""
    hi, e = P.two_sum(tree_sum(parts_hi), tree_sum(parts_lo))
    total = P.tf_add_acc(P.TwoFloat(hi, e), p0)
    return P.tf_value(total) * _final_factor(n)


def prepare(As):
    """Kernel inputs (A_pads, xb_pads (..., n_pad, 1), xbs) for a matrix
    or a stack: zero-padded A and the padded NW base vectors."""
    A_pads = pad_matrix(As)
    xbs = nw_base_vector(As)
    return A_pads, pad_base_vector(xbs, A_pads.shape[-1])[..., None], xbs


def prepare_complex(As):
    """Kernel inputs (Ar_pads, Ai_pads, xbr_pads, xbi_pads, xbs) of a
    complex matrix or stack; the NW base vectors ``xbs`` are computed per
    plane (real adds and an exact halving)."""
    xbs = torch.complex(nw_base_vector(As.real), nw_base_vector(As.imag))
    Ar_pads, Ai_pads = split_matrix_planes(As)
    return (Ar_pads, Ai_pads, *split_base_planes(xbs, Ar_pads.shape[-1]),
            xbs)


def _low_columns(supp, kw: int):
    """(taken, touched), each (B, n) bool: the kw columns chosen as a
    leaf's low columns and the rows they touch, from ``supp[b, j, i]``
    (column j has a nonzero in row i).  Greedy and deterministic: start
    from a column of least degree, then keep adding the column that adds
    the fewest rows not yet touched; ties go to the lowest column."""
    B, n, _ = supp.shape
    dev = supp.device
    bidx = torch.arange(B, device=dev)
    taken = torch.zeros((B, n), dtype=torch.bool, device=dev)
    touched = torch.zeros((B, n), dtype=torch.bool, device=dev)
    col = torch.arange(n, device=dev)
    for _ in range(kw):
        # torchlint: disable=PT001 an integer count of bools (leaf ordering)
        new = (supp & ~touched[:, None, :]).sum(-1)
        key = (new * n + col).masked_fill(taken, n * (n + 1))  # unique min
        j = torch.argmin(key, dim=-1)
        taken[bidx, j] = True
        touched |= supp[bidx, j]
    return taken, touched


def sparse_leaf_order(rows, kw: int):
    """``(cols, order, R)`` of each leaf of (B, n, maxdeg) padded CCS
    ``rows``, each (B, n) / (B,): the column order, the kw low columns
    ``_low_columns`` picks first, then the other columns; the row order,
    the R rows those columns touch first, then the others; each group in
    its original order.  A function of each leaf's nonzero pattern alone,
    so a leaf gets the same order alone and in any bucket."""
    B, n, _ = rows.shape
    supp = torch.zeros((B, n, n + 1), dtype=torch.bool, device=rows.device)
    supp.scatter_(2, rows.long(), True)
    taken, touched = _low_columns(supp[..., :n], kw)
    cols = torch.argsort((~taken).to(torch.int8), dim=-1, stable=True)
    order = torch.argsort((~touched).to(torch.int8), dim=-1, stable=True)
    # torchlint: disable=PT001 an integer count of bools (rows touched)
    return cols, order, touched.sum(-1)


def order_sparse_leaves(As, rows, vals, kw: int):
    """Each real sparse leaf of a (B, n, n) stack and its (B, n, maxdeg)
    padded CCS arrays permuted for the sparse kernel
    (``sparse_leaf_order``): ``A[order][:, cols]``, the CCS row ids
    remapped and each column's entries in ascending row (padding, row n,
    last) with their values, as ``padded_ccs`` of the permuted leaf
    would give them at this maxdeg.  A permutation of rows and columns
    leaves the permanent as it is."""
    n = As.shape[-1]
    cols, order, _ = sparse_leaf_order(rows, kw)
    bidx = torch.arange(As.shape[0], device=As.device)[:, None]
    new_id = torch.argsort(order, dim=-1)             # old row -> new row
    As = As[bidx[..., None], order[:, :, None], cols[:, None, :]]
    r = rows.long()[bidx, cols]
    r = torch.where(r < n, new_id.gather(1, r.clamp(max=n - 1).flatten(1))
                    .view_as(r), n)
    r, by_row = torch.sort(r, dim=-1, stable=True)
    return As, r.to(torch.int32), vals[bidx, cols].gather(-1, by_row)


def prepare_sparse(As, rows, vals, Wu: int):
    """Real sparse kernel inputs ``(A_pads, rows, vals, xb_pads, xbs)`` of
    a leaf (n, n) with its (n, maxdeg) CCS arrays or of a stack: the
    leaves ordered for a window of Wu steps (``order_sparse_leaves``,
    kw = log2(Wu)), then padded as ``prepare`` pads."""
    one = As.ndim == 2
    if one:
        As, rows, vals = As[None], rows[None], vals[None]
    with span("repro.dispatch.sparse.order"):
        As, rows, vals = order_sparse_leaves(As, rows, vals,
                                             int(math.log2(Wu)))
    if one:
        As, rows, vals = As[0], rows[0], vals[0]
    A_pads, xb_pads, xbs = prepare(As)
    return A_pads, rows, vals, xb_pads, xbs


_NUMPY = {torch.float32: np.float32, torch.float64: np.float64,
          torch.complex64: np.complex64, torch.complex128: np.complex128}


def _kernel_dtype(A) -> torch.dtype:
    """The dtype the kernels take for ``A``: f32 and complex64 keep theirs
    (the ``_f32`` entries); other complex input is complex128, other real
    input f64."""
    if torch.is_tensor(A):
        single = A.dtype in (torch.float32, torch.complex64)
    else:
        single = np.asarray(A).dtype in (np.float32, np.complex64)
    if is_complex(A):
        return torch.complex64 if single else torch.complex128
    return torch.float32 if single else torch.float64


def _as_input(A, device, dtype: torch.dtype | None = None):
    """A tensor on ``device`` in ``dtype`` (default: ``_kernel_dtype``)."""
    device = resolve_device(device)
    dtype = dtype or _kernel_dtype(A)
    if torch.is_tensor(A):
        return A.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(A).astype(_NUMPY[dtype]),
                           device=device)


def _reduce_real(out, xbs, n: int):
    """Epilogue over (..., blocks, 2) real partials: the g = 0 term is the
    chain product of the NW base vector(s)."""
    p0 = chain_prod(xbs[..., None])[..., 0]
    return kernel_reduce(out[..., 0], out[..., 1], p0, n)


def _reduce_complex(out, xbs, n: int):
    """Per-plane epilogue over (..., blocks, 4) split-plane partials.  The
    g = 0 term is ``chain_prod_complex`` over the base planes, where the
    reference takes a complex-dtype product (``jnp.prod``); the contract
    forbids complex ``*`` here, and the two differ at most in the last ulp
    of that one term, far inside the 1e-9 value bar."""
    p0r, p0i = chain_prod_complex(xbs.real[..., None], xbs.imag[..., None])
    return torch.complex(kernel_reduce(out[..., 0], out[..., 1], p0r[..., 0],
                                       n),
                         kernel_reduce(out[..., 2], out[..., 3], p0i[..., 0],
                                       n))


def _cuda_values(As, *, batched: bool, precision: str, mode: str,
                 geometry: Geometry, device):
    """The body behind both dense entries: ``As`` to ``device`` in
    ``_kernel_dtype``, then (n, n) -> 0-d, (B, n, n) -> (B,); complex
    input runs the split-plane kernel (window-batched only)."""
    with span("repro.dispatch.stage"):
        As = _as_input(As, device)
        if As.ndim != (3 if batched else 2) or \
                As.shape[-1] != As.shape[-2]:
            raise ValueError(
                f"{'(B, n, n) stack' if batched else 'square matrix'}"
                f" required, got {tuple(As.shape)}")
        n = As.shape[-1]
        if n <= 2:
            return _small_n(As) if batched else _small_n(As[None])[0]
        cplx = As.is_complex()
        staged = prepare_complex(As) if cplx else prepare(As)
    TB, C, Wu, blocks = geometry.kernel_geometry(n)
    geo = dict(n=n, TB=TB, C=C, Wu=Wu, num_blocks=blocks,
               precision=precision)
    if cplx:
        Ar_pads, Ai_pads, xbr, xbi, xbs = staged
        with span("repro.dispatch.launch"):
            if batched:
                out = ryser_cuda_call_complex_batched(Ar_pads, Ai_pads, xbr,
                                                      xbi, **geo)
            else:
                out = ryser_cuda_call_complex(Ar_pads, Ai_pads, xbr, xbi, 0,
                                              **geo)
        with span("repro.dispatch.reduce"):
            return _reduce_complex(out, xbs, n)
    A_pads, xb_pads, xbs = staged
    with span("repro.dispatch.launch"):
        if batched:
            out = ryser_cuda_call_batched(A_pads, xb_pads, mode=mode, **geo)
        else:
            out = ryser_cuda_call(A_pads, xb_pads, 0, mode=mode, **geo)
    with span("repro.dispatch.reduce"):
        return _reduce_real(out, xbs, n)


def _cuda_sparse_values(A, rows, vals, *, batched: bool, precision: str,
                        geometry: Geometry, device):
    """The body behind both sparse entries: the dense form(s) ``A`` (init,
    NW base vectors, boundary column) and the (..., n, maxdeg) padded CCS
    arrays driving the window states to ``device`` (the values'
    ``_kernel_dtype`` for both, int32 rows), then (n, n) -> 0-d,
    (B, n, n) -> (B,).  Real input is ordered (``prepare_sparse``) and
    launches the real sparse kernel, complex the split-plane one as it
    comes."""
    with span("repro.dispatch.stage"):
        device = resolve_device(device)
        dt = _kernel_dtype(vals)
        As = _as_input(A, device, dt)
        rows = torch.as_tensor(rows, dtype=torch.int32, device=device)
        vals = _as_input(vals, device, dt)
        if As.ndim != (3 if batched else 2) or \
                As.shape[-1] != As.shape[-2]:
            raise ValueError(
                f"{'(B, n, n) stack' if batched else 'square matrix'}"
                f" required, got {tuple(As.shape)}")
        n = As.shape[-1]
        if n <= 2:
            return _small_n(As) if batched else _small_n(As[None])[0]
        TB, C, Wu, blocks = geometry.kernel_geometry(n)
        cplx = As.is_complex()
        if cplx:
            Ar_pads, Ai_pads, xbr, xbi, xbs = prepare_complex(As)
            planes = (Ar_pads, Ai_pads, rows, vals.real.contiguous(),
                      vals.imag.contiguous(), xbr, xbi)
        else:
            A_pads, rows, vals, xb_pads, xbs = prepare_sparse(As, rows, vals,
                                                              Wu)
    geo = dict(n=n, TB=TB, C=C, Wu=Wu, num_blocks=blocks,
               precision=precision)
    if cplx:
        with span("repro.dispatch.launch"):
            if batched:
                out = ryser_sparse_cuda_call_complex_batched(*planes, **geo)
            else:
                out = ryser_sparse_cuda_call_complex(*planes, 0, **geo)
        with span("repro.dispatch.reduce"):
            return _reduce_complex(out, xbs, n)
    with span("repro.dispatch.launch"):
        if batched:
            out = ryser_sparse_cuda_call_batched(A_pads, rows, vals, xb_pads,
                                                 **geo)
        else:
            out = ryser_sparse_cuda_call(A_pads, rows, vals, xb_pads, 0,
                                         **geo)
    with span("repro.dispatch.reduce"):
        return _reduce_real(out, xbs, n)


def block_partials_cuda(A, *, dev_chunk_base: int = 0,
                        num_blocks: int | None = None,
                        geometry: Geometry | None = None,
                        precision: str = "dq_acc", mode: str = "baseline",
                        device=None):
    """Run the scalar kernel over ``num_blocks`` blocks from chunk
    ``dev_chunk_base``; returns ((num_blocks, 2) partials, geometry), in
    the dtype of a real ``A`` (f32, else f64)."""
    if is_complex(A):
        raise TypeError("block_partials_cuda takes a real matrix")
    A = _as_input(A, device)
    n = A.shape[0]
    TB, C, Wu, full_blocks = (geometry or DEFAULT_GEOMETRY).kernel_geometry(n)
    A_pads, xb_pads, _ = prepare(A)
    out = ryser_cuda_call(A_pads, xb_pads, dev_chunk_base, n=n, TB=TB, C=C,
                          Wu=Wu, num_blocks=num_blocks or full_blocks,
                          precision=precision, mode=mode)
    return out, (TB, C, Wu, full_blocks)


def wave_precision(precision: str) -> str:
    """The accumulator a campaign wave body runs: ``qq`` has no twofloat
    product in the step-space family and runs as ``dq_acc``, as the
    reference's wave bodies do (``_pallas_device_partials`` and
    ``_dyn_chunk_partials``)."""
    return precision if precision in ("dd", "kahan", "dq_acc", "dq_fast") \
        else "dq_acc"


def wave_geometry(chunks_per_slice: int, chunk_size: int,
                  geometry: Geometry | None = None) -> tuple[int, int]:
    """(TB, Wu) of a campaign wave launch: TB = min(lanes, chunks per
    slice) threads a CTA, one chunk each, and Wu = min(window, C), as the
    reference's wave body takes them; the chunk size C itself is the
    campaign's.  A slice is chunks_per_slice / TB CTAs."""
    g = geometry or DEFAULT_GEOMETRY
    return min(g.lanes, chunks_per_slice), min(g.window, chunk_size)


def wave_ctas_per_sm(n: int, cplx: bool, *, chunks_per_slice: int,
                     chunk_size: int, precision: str,
                     geometry: Geometry | None = None) -> int:
    """CTAs of the campaign wave body one SM of the card holds at once
    (the occupancy query of the instantiation the wave launches)."""
    TB, Wu = wave_geometry(chunks_per_slice, chunk_size, geometry)
    n_pad = max(_PAD, -(-n // _PAD) * _PAD)
    if cplx:
        return ctas_per_sm_complex(n_pad, TB=TB, Wu=Wu,
                                   precision=wave_precision(precision))
    return ctas_per_sm(n_pad, TB=TB, Wu=Wu,
                       precision=wave_precision(precision), mode="batched")


def _slice_sums(hi, lo, num_slices: int):
    """(hi, lo) of each slice from its partials (blocks or chunks, in
    order, the last axis): ``two_sum`` of the fixed-order trees over that
    slice's own partials, so a slice's sum is a function of the slice
    alone, whichever run of slices shared its launch."""
    return P.two_sum(tree_sum(hi.reshape(num_slices, -1)),
                     tree_sum(lo.reshape(num_slices, -1)))


def _timed(events: list | None, A, launch):
    """``launch()``, bracketed by a pair of CUDA events appended to
    ``events`` when it is a list and ``A`` lies on the card."""
    if events is None or not A.is_cuda:
        return launch()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = launch()
    end.record()
    events.append((start, end))
    return out


def campaign_slice_sums(A, first_slice: int, num_slices: int, *,
                        chunks_per_slice: int, chunk_size: int,
                        precision: str = "dq_acc",
                        geometry: Geometry | None = None,
                        backend: str = "cuda", device=None,
                        events: list | None = None):
    """Per-slice twofloat sums ``(hi, lo)``, each (num_slices,) on
    ``device`` in ``_kernel_dtype(A)`` (f32 and complex64 keep theirs,
    other input is f64 or complex128), of the contiguous campaign
    slices [first_slice, first_slice + num_slices), each
    ``chunks_per_slice`` chunks of ``chunk_size`` steps (g = 0 term NOT
    included).

    ``backend="cuda"`` is ONE launch of the scalar entry from chunk base
    ``first_slice * chunks_per_slice`` over ``num_slices * chunks_per_slice
    / TB`` blocks (``wave_geometry``): the real kernel in ``batched`` mode
    or the split-plane complex kernel (the plain versions on a CPU
    tensor); n < 3 runs the torch engine.  ``backend="torch"`` is the
    chunked torch engine (``chunk_partial_sums`` with ``chunk_offset``).
    Either way each slice reduces over its own partials
    (``_slice_sums``).  ``events``, when given, collects a (start, end)
    pair of CUDA events around the kernel launch on the card."""
    A = _as_input(A, device)
    n = A.shape[-1]
    if A.ndim != 2 or A.shape[0] != n:
        raise ValueError(f"square matrix required, got {tuple(A.shape)}")
    if backend not in ("cuda", "torch"):
        raise ValueError(f"backend must be cuda|torch, got {backend!r}")
    prec = wave_precision(precision)
    base = first_slice * chunks_per_slice
    if backend == "cuda" and n >= 3:
        TB, Wu = wave_geometry(chunks_per_slice, chunk_size, geometry)
        geo = dict(n=n, TB=TB, C=chunk_size, Wu=Wu,
                   num_blocks=num_slices * chunks_per_slice // TB,
                   precision=prec)
        if A.is_complex():
            Ar, Ai, xbr, xbi, _ = prepare_complex(A)
            out = _timed(events, A, lambda: ryser_cuda_call_complex(
                Ar, Ai, xbr, xbi, base, **geo))
            re = _slice_sums(out[:, 0], out[:, 1], num_slices)
            im = _slice_sums(out[:, 2], out[:, 3], num_slices)
            return torch.complex(re[0], im[0]), torch.complex(re[1], im[1])
        A_pad, xb_pad, _ = prepare(A)
        out = _timed(events, A, lambda: ryser_cuda_call(
            A_pad, xb_pad, base, mode="batched", **geo))
        return _slice_sums(out[:, 0], out[:, 1], num_slices)
    T, total = num_slices * chunks_per_slice, (1 << (n - 1)) // chunk_size
    if A.is_complex():
        re, im, _ = chunk_partial_sums_complex(
            A.real[None], A.imag[None], T, chunk_size, prec,
            chunk_offset=base, total_chunks=total)
        re = _slice_sums(re.hi[0], re.lo[0], num_slices)
        im = _slice_sums(im.hi[0], im.lo[0], num_slices)
        return torch.complex(re[0], im[0]), torch.complex(re[1], im[1])
    parts = chunk_partial_sums(A[None], T, chunk_size, prec,
                               chunk_offset=base, total_chunks=total)
    return _slice_sums(parts.hi[0], parts.lo[0], num_slices)


def permanent_cuda(A, *, precision: str = "dq_acc", mode: str = "baseline",
                   geometry: Geometry | None = None, device=None):
    """perm(A) via the scalar kernel entry (full step space, one card) in
    ``mode`` baseline, batched or schedmat; a 0-d tensor on ``device``
    (default: the card) in ``_kernel_dtype(A)``: f32 or f64 for real
    input, complex64 or complex128 for complex input, which runs the
    split-plane kernel in ``batched`` mode."""
    return _cuda_values(A, batched=False, precision=precision, mode=mode,
                        geometry=geometry or DEFAULT_GEOMETRY, device=device)


def permanent_cuda_batched(As, *, precision: str = "dq_acc",
                           mode: str = "batched",
                           geometry: Geometry | None = None, device=None):
    """perms of a (B, n, n) stack via ONE batch-grid kernel launch in
    ``mode`` baseline or batched; a (B,) tensor on ``device`` (default: the
    card) in ``_kernel_dtype(As)``."""
    return _cuda_values(As, batched=True, precision=precision, mode=mode,
                        geometry=geometry or DEFAULT_GEOMETRY, device=device)


def sparse_value_cuda(A, rows, vals, *, precision: str = "dq_acc",
                      geometry: Geometry | None = None, device=None):
    """perm of one matrix via the scalar SpaRyser entry from its dense form
    ``A`` (init, NW base vector, boundary column) and its (n, maxdeg)
    padded CCS arrays (window states); a 0-d tensor in the values'
    ``_kernel_dtype``."""
    return _cuda_sparse_values(A, rows, vals, batched=False,
                               precision=precision,
                               geometry=geometry or DEFAULT_GEOMETRY,
                               device=device)


def sparse_batched_values_cuda(A_stack, rows_stack, vals_stack, *,
                               precision: str = "dq_acc",
                               geometry: Geometry | None = None,
                               device=None):
    """(B,) sparse kernel values of a packed padded-CCS stack
    (``sparyser.pack_padded_ccs`` or ``sparyser.padded_ccs``) in ONE
    batch-grid launch."""
    return _cuda_sparse_values(A_stack, rows_stack, vals_stack,
                               batched=True, precision=precision,
                               geometry=geometry or DEFAULT_GEOMETRY,
                               device=device)


def permanent_cuda_sparse(sp, *, precision: str = "dq_acc",
                          geometry: Geometry | None = None, device=None):
    """perm of one ``sparyser.SparseMatrix`` via the scalar SpaRyser kernel
    entry; a 0-d tensor in its values' ``_kernel_dtype``."""
    return sparse_value_cuda(sp.to_dense(), *sp.padded_columns(),
                             precision=precision, geometry=geometry,
                             device=device)


def permanent_cuda_sparse_batched(sps, *, precision: str = "dq_acc",
                                  geometry: Geometry | None = None,
                                  device=None):
    """perms of a same-size ``SparseMatrix`` bucket via ONE batch-grid
    SpaRyser launch: the bucket is packed on the host to its bucket-wide
    maxdeg (the extra padding is inert), and a (B,) tensor comes back."""
    return sparse_batched_values_cuda(*pack_padded_ccs(sps),
                                      precision=precision, geometry=geometry,
                                      device=device)
