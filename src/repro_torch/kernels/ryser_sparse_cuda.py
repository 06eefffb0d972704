"""SpaRyser (padded-CCS sparse) Gray-code Ryser block partials, real and
split-plane complex: the CUDA kernels and their plain PyTorch versions.

The port of ``kernels/ryser_sparse.py``.  One source,
``csrc/ryser_sparse.cu``, replaces the four Pallas kernels:
``ryser_sparse_pallas_call`` / ``ryser_sparse_pallas_call_batched`` (real)
and ``ryser_sparse_pallas_call_complex`` /
``ryser_sparse_pallas_call_complex_batched`` (split re/im planes).  A
scalar entry runs grid (num_blocks, 1) from a ``uint64`` chunk base, a
batched entry grid (num_blocks, B) from 0; each kind runs one body.

The matrix arrives twice: dense and zero-padded (``A_pad``, used for the
chunk init and the boundary column) and as the (n, maxdeg) padded CCS
arrays ``rows`` (int32) / ``vals`` of ``core/sparyser.py`` (leading
dimension n, not n_pad; padded entries carry row n and value 0).  The
window states come from the kw = log2(Wu) low CCS columns scattered into
U (n_pad, kw): ``D = U @ cumsig[:kw]``, the dense batched mode's states
from fewer columns.  Entries at row n_pad (when n == n_pad) are skipped.
The kernels instantiate the dense bodies (``csrc/ryser_kernels.cuh``)
with U as the source of the low columns, and the plain versions run the
dense plain bodies on U; U equals A's low columns exactly, so both equal
the dense batched mode bit for bit on the same matrix.  The real kernel
also reads R, the rows its low columns touch (``low_column_rows``), and
adds window states only to the rows below R rounded up to 8: on the rest
they are +0 and the result is the same to the bit, so the plain version
has no such step.

Every entry returns per-block partials WITHOUT the g = 0 term: ``(hi, lo)``
real, ``(re_hi, re_err, im_hi, im_err)`` complex; ``kernels/ops.py::
kernel_reduce`` closes each.  Input is f64 or f32 (f32 and complex64
values: the ``_f32`` entries) and the partials come back in its dtype, as
the reference's follow its input.  Precisions as in the dense kernels (``qq``
runs as ``dd``).  A wrapper takes the plain version only for a tensor on
the CPU; for a CUDA tensor it launches the kernel or raises.  Launches and
plain calls count in ``ryser_cuda.counters``.
"""

from __future__ import annotations

import math

import torch

from .ryser_complex_cuda import _check_complex, _plain_partials_complex
from .ryser_cuda import (PRECISION_CODES, _check, _check_batch, _check_range,
                         _cumsig_device, _entry, _launch, _occupancy,
                         _on_card, _plain_partials, counters)

__all__ = ["ryser_sparse_cuda_call", "ryser_sparse_cuda_call_batched",
           "ryser_sparse_cuda_call_complex",
           "ryser_sparse_cuda_call_complex_batched",
           "block_partials_plain_sparse",
           "block_partials_plain_sparse_complex", "low_column_rows",
           "ctas_per_sm_sparse"]


def _scatter_low_columns(rows, vals, kw: int, n_pad: int):
    """U (B, n_pad, kw) as the kernel builds it: from zero, column j < kw
    adds ``vals[b, j, d]`` at row ``rows[b, j, d]`` in ascending d; a row
    outside [0, n_pad) (the dummy row n when n == n_pad) is skipped."""
    B, _, maxdeg = rows.shape
    U = torch.zeros((B, n_pad + 1, kw), dtype=vals.dtype, device=vals.device)
    bidx = torch.arange(B, device=vals.device)
    r_all = rows.long()
    r_all = torch.where((r_all >= 0) & (r_all < n_pad), r_all, n_pad)
    for j in range(kw):
        for d in range(maxdeg):
            r = r_all[:, j, d]
            U[bidx, r, j] = U[bidx, r, j] + vals[:, j, d]
    return U[:, :n_pad]                              # row n_pad: the sink


def low_column_rows(rows, kw: int, n: int):
    """R of each matrix as the real kernel derives it from its (..., n,
    maxdeg) CCS rows: 1 + the largest live row id (< n) among the kw low
    columns, 0 if they hold none.  The kernel runs the window loop compiled
    for RPAD, R rounded up to a multiple of 8 (at least 8)."""
    r = rows[..., :kw, :].long()
    return torch.where(r < n, r + 1, 0).flatten(-2).amax(-1)


def block_partials_plain_sparse(A_pads, rows, vals, xb_pads, chunk_base: int,
                                *, n: int, TB: int, C: int, Wu: int,
                                num_blocks: int,
                                precision: str = "dq_acc") -> torch.Tensor:
    """(B, num_blocks, 2) partials of a (B, n_pad, n_pad) stack and its
    (B, n, maxdeg) padded CCS arrays, op for op the kernel's."""
    counters["block_partials_plain_sparse"] += 1
    U = _scatter_low_columns(rows, vals, int(math.log2(Wu)), A_pads.shape[-1])
    return _plain_partials(A_pads, xb_pads, U, chunk_base, n=n, TB=TB, C=C,
                           Wu=Wu, num_blocks=num_blocks, precision=precision)


def block_partials_plain_sparse_complex(Ar_pads, Ai_pads, rows, vals_r,
                                        vals_i, xbr_pads, xbi_pads,
                                        chunk_base: int, *, n: int, TB: int,
                                        C: int, Wu: int, num_blocks: int,
                                        precision: str = "dq_acc"
                                        ) -> torch.Tensor:
    """(B, num_blocks, 4) split-plane partials, op for op the kernel's:
    one scatter per plane from the shared ``rows``."""
    counters["block_partials_plain_sparse_complex"] += 1
    kw, n_pad = int(math.log2(Wu)), Ar_pads.shape[-1]
    Ur = _scatter_low_columns(rows, vals_r, kw, n_pad)
    Ui = _scatter_low_columns(rows, vals_i, kw, n_pad)
    return _plain_partials_complex(Ar_pads, Ai_pads, xbr_pads, xbi_pads, Ur,
                                   Ui, chunk_base, n=n, TB=TB, C=C, Wu=Wu,
                                   num_blocks=num_blocks, precision=precision)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _check_ccs(rows, vals_planes, like, *, n: int, batched: bool) -> None:
    """rows int32 and the value planes in ``like``'s dtype, all (..., n,
    maxdeg) on ``like``'s device with ``like``'s leading batch shape."""
    lead = like.shape[:-2]
    if rows.dtype != torch.int32:
        raise TypeError(f"rows must be int32, got {rows.dtype}")
    if rows.ndim != (3 if batched else 2) or tuple(rows.shape[:-1]) != (
            *lead, n) or rows.shape[-1] < 1:
        raise ValueError(f"rows shape {tuple(rows.shape)} != "
                         f"{(*lead, n, 'maxdeg')}")
    for v in vals_planes:
        if (v.dtype, v.shape) != (like.dtype, rows.shape):
            raise ValueError(f"vals {v.dtype} {tuple(v.shape)} must be "
                             f"{like.dtype} of the rows' shape "
                             f"{tuple(rows.shape)}")
    for t in (rows, *vals_planes):
        if t.device != like.device:
            raise ValueError(f"CCS arrays on {t.device}, A on {like.device}")


def _geo_args(n: int, n_pad: int, maxdeg: int, TB: int, C: int, Wu: int,
              num_blocks: int, precision: str):
    return (n, n_pad, maxdeg, TB, int(math.log2(C)), int(math.log2(Wu)),
            num_blocks, PRECISION_CODES[precision])


def _cumsig(Wu: int, A) -> int:
    """Device pointer of the batched mode's cumsig in ``A``'s dtype."""
    return _cumsig_device(Wu, A.shape[-1], A.device, A.dtype).data_ptr()


def ryser_sparse_cuda_call(A_pad, rows, vals, x_base_pad,
                           dev_chunk_base: int, *, n: int, TB: int, C: int,
                           Wu: int, num_blocks: int,
                           precision: str = "dq_acc") -> torch.Tensor:
    """(num_blocks, 2) per-block (hi, lo) partials of one sparse matrix over
    blocks [0, num_blocks) from chunk ``dev_chunk_base`` (g = 0 term NOT
    included).  ``A_pad`` (n_pad, n_pad), ``rows``/``vals`` (n, maxdeg),
    ``x_base_pad`` (n_pad, 1)."""
    geo = dict(n=n, TB=TB, C=C, Wu=Wu, num_blocks=num_blocks,
               precision=precision)
    _check(A_pad, x_base_pad, mode="batched", batched=False, **geo)
    _check_ccs(rows, (vals,), A_pad, n=n, batched=False)
    base = int(dev_chunk_base)
    _check_range(base, num_blocks, TB, C, n)
    if A_pad.device.type == "cpu":
        return block_partials_plain_sparse(A_pad[None], rows[None],
                                           vals[None], x_base_pad[None],
                                           base, **geo)[0]
    _on_card(A_pad)
    A_pad, rows, vals, x_base_pad = (t.contiguous() for t in
                                     (A_pad, rows, vals, x_base_pad))
    n_pad = A_pad.shape[0]
    out = torch.empty((num_blocks, 2), dtype=A_pad.dtype,
                      device=A_pad.device)
    _launch(_entry("ryser_sparse_scalar", A_pad), A_pad, x_base_pad, out,
            A_pad.data_ptr(), rows.data_ptr(), vals.data_ptr(),
            x_base_pad.data_ptr(), _cumsig(Wu, A_pad), out.data_ptr(), base,
            *_geo_args(n, n_pad, rows.shape[-1], TB, C, Wu, num_blocks,
                       precision))
    return out


def ryser_sparse_cuda_call_batched(A_pads, rows, vals, x_base_pads, *, n: int,
                                   TB: int, C: int, Wu: int, num_blocks: int,
                                   precision: str = "dq_acc") -> torch.Tensor:
    """(B, num_blocks, 2) partials of a (B, n_pad, n_pad) stack and its
    (B, n, maxdeg) padded CCS arrays (bucket-wide maxdeg) in ONE launch,
    grid (num_blocks, B), chunk base 0.  ``x_base_pads`` is (B, n_pad, 1)."""
    geo = dict(n=n, TB=TB, C=C, Wu=Wu, num_blocks=num_blocks,
               precision=precision)
    _check(A_pads, x_base_pads, mode="batched", batched=True, **geo)
    _check_ccs(rows, (vals,), A_pads, n=n, batched=True)
    _check_range(0, num_blocks, TB, C, n)
    if A_pads.device.type == "cpu":
        return block_partials_plain_sparse(A_pads, rows, vals, x_base_pads,
                                           0, **geo)
    _on_card(A_pads)
    B, n_pad = A_pads.shape[0], A_pads.shape[1]
    _check_batch(B)
    A_pads, rows, vals, x_base_pads = (t.contiguous() for t in
                                       (A_pads, rows, vals, x_base_pads))
    out = torch.empty((B, num_blocks, 2), dtype=A_pads.dtype,
                      device=A_pads.device)
    _launch(_entry("ryser_sparse_batched", A_pads), A_pads, x_base_pads, out,
            A_pads.data_ptr(), rows.data_ptr(), vals.data_ptr(),
            x_base_pads.data_ptr(), _cumsig(Wu, A_pads), out.data_ptr(), B,
            *_geo_args(n, n_pad, rows.shape[-1], TB, C, Wu, num_blocks,
                       precision))
    return out


def ryser_sparse_cuda_call_complex(Ar_pad, Ai_pad, rows, vals_r, vals_i,
                                   xbr, xbi, dev_chunk_base: int, *, n: int,
                                   TB: int, C: int, Wu: int, num_blocks: int,
                                   precision: str = "dq_acc") -> torch.Tensor:
    """(num_blocks, 4) ``(re_hi, re_err, im_hi, im_err)`` partials of one
    complex sparse matrix from chunk ``dev_chunk_base`` (g = 0 term NOT
    included).  Planes (n_pad, n_pad), CCS (n, maxdeg), base planes
    (n_pad, 1)."""
    geo = dict(n=n, TB=TB, C=C, Wu=Wu, num_blocks=num_blocks,
               precision=precision)
    _check_complex(Ar_pad, Ai_pad, xbr, xbi, batched=False, **geo)
    _check_ccs(rows, (vals_r, vals_i), Ar_pad, n=n, batched=False)
    base = int(dev_chunk_base)
    _check_range(base, num_blocks, TB, C, n)
    if Ar_pad.device.type == "cpu":
        return block_partials_plain_sparse_complex(
            *(t[None] for t in (Ar_pad, Ai_pad, rows, vals_r, vals_i, xbr,
                                xbi)), base, **geo)[0]
    _on_card(Ar_pad)
    ts = [t.contiguous() for t in (Ar_pad, Ai_pad, rows, vals_r, vals_i, xbr,
                                   xbi)]
    n_pad = Ar_pad.shape[0]
    out = torch.empty((num_blocks, 4), dtype=Ar_pad.dtype,
                      device=Ar_pad.device)
    _launch(_entry("ryser_sparse_complex_scalar", Ar_pad), ts[0], ts[5], out,
            *(t.data_ptr() for t in ts), _cumsig(Wu, Ar_pad),
            out.data_ptr(), base,
            *_geo_args(n, n_pad, rows.shape[-1], TB, C, Wu, num_blocks,
                       precision))
    return out


def ryser_sparse_cuda_call_complex_batched(Ar_pads, Ai_pads, rows, vals_r,
                                           vals_i, xbr_pads, xbi_pads, *,
                                           n: int, TB: int, C: int, Wu: int,
                                           num_blocks: int,
                                           precision: str = "dq_acc"
                                           ) -> torch.Tensor:
    """(B, num_blocks, 4) split-plane partials of a complex sparse bucket in
    ONE launch, grid (num_blocks, B), chunk base 0."""
    geo = dict(n=n, TB=TB, C=C, Wu=Wu, num_blocks=num_blocks,
               precision=precision)
    _check_complex(Ar_pads, Ai_pads, xbr_pads, xbi_pads, batched=True, **geo)
    _check_ccs(rows, (vals_r, vals_i), Ar_pads, n=n, batched=True)
    _check_range(0, num_blocks, TB, C, n)
    if Ar_pads.device.type == "cpu":
        return block_partials_plain_sparse_complex(
            Ar_pads, Ai_pads, rows, vals_r, vals_i, xbr_pads, xbi_pads, 0,
            **geo)
    _on_card(Ar_pads)
    B, n_pad = Ar_pads.shape[0], Ar_pads.shape[1]
    _check_batch(B)
    ts = [t.contiguous() for t in (Ar_pads, Ai_pads, rows, vals_r, vals_i,
                                   xbr_pads, xbi_pads)]
    out = torch.empty((B, num_blocks, 4), dtype=Ar_pads.dtype,
                      device=Ar_pads.device)
    _launch(_entry("ryser_sparse_complex_batched", Ar_pads), ts[0], ts[5],
            out, *(t.data_ptr() for t in ts), _cumsig(Wu, Ar_pads),
            out.data_ptr(), B,
            *_geo_args(n, n_pad, rows.shape[-1], TB, C, Wu, num_blocks,
                       precision))
    return out


def ctas_per_sm_sparse(n_pad: int, *, TB: int, Wu: int,
                       precision: str = "dq_acc") -> int:
    """CTAs of TB threads of the f64 real sparse instantiation for
    ``n_pad`` that one SM of the card holds at once."""
    return _occupancy("ryser_sparse_occupancy", n_pad,
                      PRECISION_CODES[precision], TB, int(math.log2(Wu)))
