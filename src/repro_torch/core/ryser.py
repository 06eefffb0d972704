"""Dense Gray-code Ryser engine (paper Alg. 3) in PyTorch: the ``torch``
backend, real and split-plane complex.

The port of the reference package's ``core/ryser.py`` (dense arms).
The iteration space is split into ``T`` power-of-two, window-aligned
chunks (the paper's CEG load distribution); each chunk rebuilds its
row-sum vector from ``Gray(start)`` and iterates locally, and the column
update at every local step but the last is a broadcast.  Every function
takes a leading batch axis: the scalar engine runs as a one-matrix batch,
so a scalar leaf equals the same leaf inside a bucket bit for bit (eager
elementwise ops do not depend on the batch extent).

Complex matrices travel as (re, im) f64 planes (``as_planes``): column
updates are two real adds, the product is the explicit 4-mult/2-add
recurrence (``chain_prod_complex``), and partial sums accumulate per
component.  The reference maps its complex engine over the batch with
``lax.map`` because XLA fuses differently at different batch extents;
eager elementwise torch ops do not, so the complex engine also runs on
the leading batch axis (pinned by tests/test_torch_complex.py).

Precision modes (paper Table 3): ``dd``, ``dq_fast``, ``dq_acc``, ``qq``,
``kahan`` (complex ``qq`` runs as ``kahan``).  The cross-chunk reduction is a fixed-order twofloat tree
(``tf_tree_sum``) and the products are sequential chains, never
``torch.sum``/``torch.prod``.  Runs on whatever device the tensors are on.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import gray as G
from . import precision as P
from .stepspace import chunk_geometry

__all__ = [
    "nw_base_vector",
    "perm_ryser_chunked",
    "perm_ryser_seq",
    "perm_ryser_batched",
    "batched_values",
    "batched_values_complex",
    "tf_tree_sum",
    "chain_prod",
    "chain_prod_complex",
    "complex_precision",
    "chunk_partial_sums",
    "chunk_partial_sums_complex",
    "rank1_chunk_init",
    "chunk_geometry",
    "ryser_flops",
    "as_matrix",
    "as_planes",
    "is_complex",
    "resolve_device",
]


def resolve_device(device) -> torch.device:
    """``None`` means the card.  A CUDA request without a usable card
    raises; nothing falls back to the CPU unless the caller asks for it."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; the port runs on the card unless the "
            "caller passes device='cpu'")
    return device


def is_complex(A) -> bool:
    return A.is_complex() if torch.is_tensor(A) else np.iscomplexobj(A)


def as_matrix(A, device) -> torch.Tensor:
    """f64 tensor on ``device`` from a real array-like.  Complex input
    raises: no real-only function may drop an imaginary part."""
    device = resolve_device(device)
    if is_complex(A):
        raise TypeError("complex input to a real-only function; use "
                        "as_planes")
    if torch.is_tensor(A):
        return A.to(device=device, dtype=torch.float64)
    return torch.as_tensor(np.asarray(A).astype(np.float64), device=device)


def as_planes(A, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The f64 (re, im) planes on ``device`` of a real or complex
    array-like (a real input has a zero im plane)."""
    device = resolve_device(device)
    if torch.is_tensor(A):
        A = A.to(device)
        if not A.is_complex():
            A = A.to(torch.float64)
            return A, torch.zeros_like(A)
        A = A.to(torch.complex128)
        return A.real.contiguous(), A.imag.contiguous()
    A = np.asarray(A)
    return (torch.as_tensor(np.real(A).astype(np.float64), device=device),
            torch.as_tensor(np.imag(A).astype(np.float64), device=device))


def nw_base_vector(A):
    """Nijenhuis-Wilf start vector  x[i] = a[i, n-1] - rowsum_i / 2, over
    the last two axes; the row sum is a fixed-order sequential chain."""
    n = A.shape[-1]
    rowsum = A[..., :, 0]
    for j in range(1, n):
        rowsum = rowsum + A[..., :, j]
    return A[..., :, -1] - rowsum / 2


def _final_factor(n: int) -> int:
    """(4 * (n mod 2) - 2) == 2 * (-1)^{n-1}."""
    return 4 * (n % 2) - 2


def ryser_flops(n: int) -> float:
    """Model FLOPs: ~2n per Gray step (n adds for the row-sum update + n
    mults for the product) over 2^{n-1} steps."""
    return 2.0 * n * 2.0 ** (n - 1)


def chain_prod(X):
    """Fixed-order product over axis -2 of a (..., n, T) tensor (axis -1
    of an (..., n) vector is handled by passing ``X[..., None]``)."""
    t = X[..., 0, :]
    for i in range(1, X.shape[-2]):
        t = t * X[..., i, :]
    return t


def chain_prod_complex(Xr, Xi):
    """Fixed-order complex product over axis -2 of split (re, im) planes
    (..., n, T): the explicit 4-mult/2-add recurrence the kernel unrolls,
    never complex-dtype ``*``."""
    pr, pi = Xr[..., 0, :], Xi[..., 0, :]
    for i in range(1, Xr.shape[-2]):
        xr, xi = Xr[..., i, :], Xi[..., i, :]
        pr, pi = pr * xr - pi * xi, pr * xi + pi * xr
    return pr, pi


def complex_precision(precision: str) -> str:
    """``qq``'s twofloat product relies on Dekker splitting, which is
    real-only; complex runs it as ``kahan`` (the planner tags this
    ``qq->kahan``)."""
    return "kahan" if precision == "qq" else precision


def tf_tree_sum(hi, lo):
    """Pairwise twofloat tree reduction over the last axis with a FIXED
    association order (odd tails peeled per level).  Returns ``(hi, lo)``
    with the last axis removed."""
    L = hi.shape[-1]
    while L > 1:
        half = L // 2
        t = P.tf_add_tf(P.TwoFloat(hi[..., :half], lo[..., :half]),
                        P.TwoFloat(hi[..., half:2 * half],
                                   lo[..., half:2 * half]))
        if L == 2 * half:
            hi, lo = t.hi, t.lo
        else:
            hi = torch.cat([t.hi, hi[..., 2 * half:]], dim=-1)
            lo = torch.cat([t.lo, lo[..., 2 * half:]], dim=-1)
        L = (L + 1) // 2
    return hi[..., 0], lo[..., 0]


class _CEGSchedules:
    """Host-constant CEG schedules for chunks [offset, offset + T); they
    depend only on (n, T, C, chunk_offset), never on the matrix."""

    def __init__(self, n: int, T: int, C: int, chunk_offset: int = 0,
                 total_chunks: int | None = None):
        if total_chunks is None:
            total_chunks = T
        k = int(math.log2(C))
        if C != 1 << k or k < 1:
            raise ValueError(f"chunks must be power-of-2 sized, C >= 2: {C}")
        space = 1 << (n - 1)
        if total_chunks * C != space:
            raise ValueError(f"{total_chunks} x {C} != 2^{n - 1}")
        self.k = k
        starts = (np.arange(T, dtype=np.uint64)
                  + np.uint64(chunk_offset)) * np.uint64(C)
        self.starts = starts
        sched = G.changed_bit_schedule(k)            # (C-1,) changed bits
        w_arr = np.arange(1, C, dtype=np.uint64)
        jj = sched.astype(np.uint64)
        bit_j = ((w_arr >> jj) ^ (w_arr >> (jj + np.uint64(1)))) \
            & np.uint64(1)
        self.sched_j = sched.tolist()
        self.base_bits = bit_j.astype(np.int64).tolist()
        self.mid_flags = (jj + 1 == k).tolist()      # only at w = C/2
        self.w_parity = (w_arr & np.uint64(1)).astype(np.int64).tolist()
        self.lane_bitk = ((starts >> np.uint64(k)) & np.uint64(1)) \
            .astype(np.int64)                        # (T,)
        g_tail = starts + np.uint64(C)
        tail_j = np.array([G.ctz(int(g)) for g in g_tail], dtype=np.int64)
        tail_sign = np.array([G.step_sign(int(g)) for g in g_tail],
                             dtype=np.int64)
        tail_live = g_tail <= np.uint64(space - 1)
        self.tail_j = np.where(tail_live, tail_j, 0)
        self.tail_sign = tail_sign
        self.tail_live = tail_live

    def gray_bits(self, n: int, dtype, device):
        """(n, T) Gray-code bits of the chunk start steps."""
        return torch.as_tensor(G.gray_bits_matrix(self.starts, n),
                               dtype=dtype, device=device)

    def tail_columns(self, A):
        """Signed, liveness-masked tail columns A[..., :, tail_j] (..., n, T)."""
        scale = torch.as_tensor((self.tail_sign * self.tail_live)
                                .astype(np.float64), dtype=A.dtype,
                                device=A.device)
        idx = torch.as_tensor(self.tail_j, device=A.device)
        return A[..., :, idx] * scale


def rank1_chunk_init(A, x_base, Gbits):
    """Chunk state init as fixed-order rank-1 accumulation over columns:
    X0 = x_base + sum_j A[:, j] * Gbits[j] in ascending j."""
    X0 = x_base[..., :, None]
    for j in range(A.shape[-1]):
        X0 = X0 + A[..., :, j:j + 1] * Gbits[j:j + 1, :]
    return X0


def chunk_partial_sums(A, T: int, C: int, precision: str = "dq_acc",
                       chunk_offset: int = 0,
                       total_chunks: int | None = None) -> P.TwoFloat:
    """Per-chunk partial sums for chunks [chunk_offset, chunk_offset + T)
    of a (B, n, n) stack: TwoFloat of shape (B, T) with
    ``partial[t] = sum_{w=1..C} (-1)^g prod_i x_{t,w}[i]`` -- the base
    (g == 0) term is NOT included."""
    n = A.shape[-1]
    dtype, dev = A.dtype, A.device
    S = _CEGSchedules(n, T, C, chunk_offset, total_chunks)
    X = rank1_chunk_init(A, nw_base_vector(A), S.gray_bits(n, dtype, dev))
    Xlo = torch.zeros_like(X)
    lane_bitk = torch.as_tensor(S.lane_bitk, device=dev)
    use_qq = precision == "qq"

    def tf_update(Xhi, Xlo, d):
        shi, slo = P.two_sum(Xhi, d)
        return P.fast_two_sum(shi, slo + Xlo)

    def product(Xhi, Xlo) -> P.TwoFloat:
        if not use_qq:
            return P.tf_from(chain_prod(Xhi))
        t = P.TwoFloat(Xhi[..., 0, :], Xlo[..., 0, :])
        for i in range(1, n):
            t = P.tf_mul_tf(t, P.TwoFloat(Xhi[..., i, :], Xlo[..., i, :]))
        return t

    def accum(acc, term: P.TwoFloat):
        if precision == "dq_fast":
            t = P.tf_add_fast(P.TwoFloat(*acc), term.hi)
            return (t.hi, t.lo)
        if precision == "dq_acc":
            t = P.tf_add_acc(P.TwoFloat(*acc), term.hi)
            return (t.hi, t.lo)
        if precision == "qq":
            t = P.tf_add_tf(P.TwoFloat(*acc), term)
            return (t.hi, t.lo)
        if precision == "kahan":
            return P.kahan_add(acc, term.hi)
        return (acc[0] + term.hi, acc[1])            # dd

    z = torch.zeros(X.shape[:-2] + (T,), dtype=dtype, device=dev)
    acc = (z, z)
    for col_j, bit, midf, par in zip(S.sched_j, S.base_bits, S.mid_flags,
                                     S.w_parity):
        if midf:                                     # lane-dependent sign
            s = (2 * (bit ^ lane_bitk) - 1).to(dtype)
        else:
            s = float(2 * bit - 1)
        d = A[..., :, col_j:col_j + 1] * s           # broadcast column
        if use_qq:
            X, Xlo = tf_update(X, Xlo, d)
        else:
            X = X + d
        prod = product(X, Xlo)
        term = P.TwoFloat(-prod.hi, -prod.lo) if par else prod
        acc = accum(acc, term)

    # tail step w = C (per-chunk column; sign/mask folded into Atail)
    Atail = S.tail_columns(A)
    if use_qq:
        X, Xlo = tf_update(X, Xlo, Atail)
    else:
        X = X + Atail
    prod = product(X, Xlo)
    live = torch.as_tensor(S.tail_live, device=dev)
    neg = (C & 1) == 1       # (-1)^{g = start + C} == (-1)^C, chunk-uniform
    zero = torch.zeros_like(prod.hi)
    hi = torch.where(live, -prod.hi if neg else prod.hi, zero)
    lo = torch.where(live, -prod.lo if neg else prod.lo, zero)
    acc = accum(acc, P.TwoFloat(hi, lo))

    if precision in ("kahan", "dd"):
        return P.TwoFloat(acc[0], torch.zeros_like(acc[0]))
    return P.TwoFloat(acc[0], acc[1])


def batched_values(As, T: int, C: int, precision: str):
    """(B,) permanents of a (B, n, n) stack at a fixed chunk geometry."""
    n = As.shape[-1]
    parts = chunk_partial_sums(As, T, C, precision)
    hi, e1 = tf_tree_sum(parts.hi, parts.lo)
    p0 = chain_prod(nw_base_vector(As)[..., None])[..., 0]
    total = P.tf_add_acc(P.TwoFloat(hi, e1), p0)
    return P.tf_value(total) * _final_factor(n)


def chunk_partial_sums_complex(Ar, Ai, T: int, C: int,
                               precision: str = "dq_acc",
                               chunk_offset: int = 0,
                               total_chunks: int | None = None):
    """Split-plane complex chunk partials of a (B, n, n) stack given as
    (re, im) planes; mirrors ``chunk_partial_sums``.

    Returns ``(re, im, base)``: ``re``/``im`` are TwoFloats of shape
    (B, T) WITHOUT the base (g == 0) term, accumulated per component;
    ``base`` is the ``(p0_re, p0_im)`` (B,) pair of that term, the product
    of lane 0's initial state (the NW base vector when
    ``chunk_offset == 0``).  ``qq`` runs as ``kahan``.
    """
    precision = complex_precision(precision)
    n = Ar.shape[-1]
    dtype, dev = Ar.dtype, Ar.device
    S = _CEGSchedules(n, T, C, chunk_offset, total_chunks)
    Gbits = S.gray_bits(n, dtype, dev)
    Xr = rank1_chunk_init(Ar, nw_base_vector(Ar), Gbits)
    Xi = rank1_chunk_init(Ai, nw_base_vector(Ai), Gbits)
    b0r, b0i = chain_prod_complex(Xr[..., :1], Xi[..., :1])
    base = (b0r[..., 0], b0i[..., 0])
    lane_bitk = torch.as_tensor(S.lane_bitk, device=dev)

    def accum(acc, term):
        if precision == "dq_fast":
            t = P.tf_add_fast(P.TwoFloat(*acc), term)
            return (t.hi, t.lo)
        if precision == "dq_acc":
            t = P.tf_add_acc(P.TwoFloat(*acc), term)
            return (t.hi, t.lo)
        if precision == "kahan":
            return P.kahan_add(acc, term)
        return (acc[0] + term, acc[1])               # dd

    z = torch.zeros(Xr.shape[:-2] + (T,), dtype=dtype, device=dev)
    acc_r = acc_i = (z, z)
    for col_j, bit, midf, par in zip(S.sched_j, S.base_bits, S.mid_flags,
                                     S.w_parity):
        if midf:                                     # lane-dependent sign
            s = (2 * (bit ^ lane_bitk) - 1).to(dtype)
        else:
            s = float(2 * bit - 1)
        Xr = Xr + Ar[..., :, col_j:col_j + 1] * s    # broadcast column
        Xi = Xi + Ai[..., :, col_j:col_j + 1] * s
        pr, pi = chain_prod_complex(Xr, Xi)
        acc_r = accum(acc_r, -pr if par else pr)
        acc_i = accum(acc_i, -pi if par else pi)

    # tail step w = C (per-chunk column; sign/mask folded into the columns)
    Xr = Xr + S.tail_columns(Ar)
    Xi = Xi + S.tail_columns(Ai)
    pr, pi = chain_prod_complex(Xr, Xi)
    live = torch.as_tensor(S.tail_live, device=dev)
    neg = (C & 1) == 1       # (-1)^{g = start + C} == (-1)^C, chunk-uniform
    zero = torch.zeros_like(pr)
    acc_r = accum(acc_r, torch.where(live, -pr if neg else pr, zero))
    acc_i = accum(acc_i, torch.where(live, -pi if neg else pi, zero))

    if precision in ("kahan", "dd"):
        return (P.TwoFloat(acc_r[0], torch.zeros_like(acc_r[0])),
                P.TwoFloat(acc_i[0], torch.zeros_like(acc_i[0])), base)
    return (P.TwoFloat(*acc_r), P.TwoFloat(*acc_i), base)


def batched_values_complex(Ars, Ais, T: int, C: int, precision: str):
    """(values_re, values_im), each (B,), of a split-plane complex stack at
    a fixed chunk geometry: per-component fixed-order twofloat trees."""
    n = Ars.shape[-1]
    parts_r, parts_i, (p0r, p0i) = chunk_partial_sums_complex(
        Ars, Ais, T, C, precision)
    f = _final_factor(n)
    out = []
    for parts, p0 in ((parts_r, p0r), (parts_i, p0i)):
        hi, e1 = tf_tree_sum(parts.hi, parts.lo)
        out.append(P.tf_value(P.tf_add_acc(P.TwoFloat(hi, e1), p0)) * f)
    return tuple(out)


def _small_n(As):
    """perm of a (B, n, n) stack with n <= 2 in closed form."""
    if As.shape[-1] == 1:
        return As[:, 0, 0]
    return As[:, 0, 0] * As[:, 1, 1] + As[:, 0, 1] * As[:, 1, 0]


def perm_ryser_batched(As, num_chunks: int = 4096,
                       precision: str = "dq_acc", *,
                       device="cuda") -> torch.Tensor:
    """Permanents of a (B, n, n) stack of same-size matrices; returns a
    (B,) f64 tensor on ``device``, complex128 for complex input."""
    cplx = is_complex(As)
    As = torch.complex(*as_planes(As, device)) if cplx \
        else as_matrix(As, device)
    if As.ndim != 3 or As.shape[1] != As.shape[2]:
        raise ValueError(f"(B, n, n) stack required, got {tuple(As.shape)}")
    n = As.shape[1]
    if n <= 2:
        return _small_n(As)
    T, C, _ = chunk_geometry(n, num_chunks)
    if cplx:
        return torch.complex(*batched_values_complex(As.real, As.imag, T, C,
                                                     precision))
    return batched_values(As, T, C, precision)


def perm_ryser_chunked(A, num_chunks: int = 4096, precision: str = "dq_acc",
                       *, device="cuda") -> torch.Tensor:
    """perm(A) by chunked Alg. 3 with CEG-aligned chunks; a 0-d f64 tensor
    (complex128 for complex input).

    Runs as a one-matrix batch, so it equals the same matrix's entry of
    ``perm_ryser_batched`` bit for bit.
    """
    if not torch.is_tensor(A):
        A = np.asarray(A)
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(f"square matrix required, got {tuple(A.shape)}")
    return perm_ryser_batched(A[None], num_chunks, precision,
                              device=device)[0]


def perm_ryser_seq(A, *, device="cuda") -> torch.Tensor:
    """Faithful Algorithm 1 with twofloat accumulation: one sequential
    Gray walk over all 2^(n-1) - 1 steps from the Nijenhuis-Wilf start
    vector, each step's product added by ``tf_add_acc``, following the
    reference's ``_ryser_seq_jit`` step for step.  A 0-d tensor on
    ``device``, in the input's dtype (f32 or f64; real input only).

    The reference has no kernel for it, so it is plain torch on the
    caller's device, a Python loop of a few small ops a step; the
    reference advises n <= ~26, and here n <= ~20 keeps it to seconds."""
    device = resolve_device(device)
    if torch.is_tensor(A) and A.dtype == torch.float32 or \
            not torch.is_tensor(A) and np.asarray(A).dtype == np.float32:
        A = torch.as_tensor(A, device=device)
    else:
        A = as_matrix(A, device)
    n = A.shape[0]
    if A.ndim != 2 or A.shape[1] != n:
        raise ValueError(f"square matrix required, got {tuple(A.shape)}")
    if n == 1:
        return A[0, 0]
    x = nw_base_vector(A)
    p0 = chain_prod(x[:, None])[0]
    acc = P.TwoFloat(p0, torch.zeros_like(p0))
    for g in range(1, 1 << (n - 1)):
        low = g & -g
        j = low.bit_length() - 1
        s = 1.0 if (g ^ (g >> 1)) & low else -1.0
        x = x + s * A[:, j]
        prod = chain_prod(x[:, None])[0]
        acc = P.tf_add_acc(acc, -prod if g & 1 else prod)
    return (acc.hi + acc.lo) * _final_factor(n)
