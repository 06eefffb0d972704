"""Entry points around the dense CUDA Ryser kernel (real f64 arm).

The port of the reference package's ``kernels/ops.py``.
``permanent_cuda(A)`` computes perm(A) with the scalar kernel entry
(``mode="baseline"``); ``permanent_cuda_batched(As)`` covers a same-size
stack with one (block, batch)-grid launch (``mode="batched"``).  Both go
through ``_cuda_values``: geometry, padding, NW base vectors and the
twofloat cross-block epilogue ``kernel_reduce`` are shared, only the
kernel entry differs.  ``block_partials_cuda`` exposes the raw per-block
partials over any chunk window.

``device=None`` means the card.  On a CPU tensor the kernel wrappers run
their plain PyTorch version instead (``ryser_cuda.block_partials_plain``).
Complex, sparse and f32 input are not ported yet.
"""

from __future__ import annotations

import math

import torch

from ..core import precision as P
from ..core.ryser import _final_factor, as_matrix, chain_prod, nw_base_vector
from ..core.stepspace import DEFAULT_GEOMETRY, Geometry
from .ryser_cuda import ryser_cuda_call, ryser_cuda_call_batched

__all__ = ["Geometry", "DEFAULT_GEOMETRY", "permanent_cuda",
           "permanent_cuda_batched", "block_partials_cuda", "kernel_reduce",
           "pad_matrix", "pad_base_vector", "prepare", "tree_sum"]

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


def _cuda_values(As, *, batched: bool, precision: str, mode: str,
                 geometry: Geometry):
    """The body behind both dense entries: (n, n) -> 0-d, (B, n, n) -> (B,)."""
    n = As.shape[-1]
    TB, C, Wu, blocks = geometry.kernel_geometry(n)
    A_pads, xb_pads, xbs = prepare(As)
    if batched:
        out = ryser_cuda_call_batched(A_pads, xb_pads, n=n, TB=TB, C=C,
                                      Wu=Wu, num_blocks=blocks,
                                      precision=precision, mode=mode)
    else:
        out = ryser_cuda_call(A_pads, xb_pads, 0, n=n, TB=TB, C=C, Wu=Wu,
                              num_blocks=blocks, precision=precision,
                              mode=mode)
    p0 = chain_prod(xbs[..., None])[..., 0]
    return kernel_reduce(out[..., 0], out[..., 1], p0, n)


def block_partials_cuda(A, *, dev_chunk_base: int = 0,
                        num_blocks: int | None = None,
                        geometry: Geometry | None = None,
                        precision: str = "dq_acc", mode: str = "baseline",
                        device=None):
    """Run the scalar kernel over ``num_blocks`` blocks from chunk
    ``dev_chunk_base``; returns ((num_blocks, 2) partials, geometry)."""
    A = as_matrix(A, device)
    n = A.shape[0]
    TB, C, Wu, full_blocks = (geometry or DEFAULT_GEOMETRY).kernel_geometry(n)
    A_pads, xb_pads, _ = prepare(A)
    out = ryser_cuda_call(A_pads, xb_pads, dev_chunk_base, n=n, TB=TB, C=C,
                          Wu=Wu, num_blocks=num_blocks or full_blocks,
                          precision=precision, mode=mode)
    return out, (TB, C, Wu, full_blocks)


def permanent_cuda(A, *, precision: str = "dq_acc", mode: str = "baseline",
                   geometry: Geometry | None = None, device=None):
    """perm(A) via the scalar kernel entry (full step space, one card);
    a 0-d f64 tensor on ``device`` (default: the card)."""
    A = as_matrix(A, device)
    n = A.shape[0]
    if A.ndim != 2 or A.shape[1] != n:
        raise ValueError(f"square matrix required, got {tuple(A.shape)}")
    if n == 1:
        return A[0, 0]
    if n == 2:
        return A[0, 0] * A[1, 1] + A[0, 1] * A[1, 0]
    return _cuda_values(A, batched=False, precision=precision, mode=mode,
                        geometry=geometry or DEFAULT_GEOMETRY)


def permanent_cuda_batched(As, *, precision: str = "dq_acc",
                           mode: str = "batched",
                           geometry: Geometry | None = None, device=None):
    """perms of a (B, n, n) stack via ONE batch-grid kernel launch; a (B,)
    f64 tensor on ``device`` (default: the card)."""
    As = as_matrix(As, device)
    if As.ndim != 3 or As.shape[1] != As.shape[2]:
        raise ValueError(f"(B, n, n) stack required, got {tuple(As.shape)}")
    n = As.shape[1]
    if n == 1:
        return As[:, 0, 0]
    if n == 2:
        return As[:, 0, 0] * As[:, 1, 1] + As[:, 0, 1] * As[:, 1, 0]
    return _cuda_values(As, batched=True, precision=precision, mode=mode,
                        geometry=geometry or DEFAULT_GEOMETRY)
