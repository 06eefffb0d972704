"""Sparse-matrix permanent: CRS/CCS storage and SpaRyser (paper Alg. 2) in
PyTorch, the ``torch`` backend's sparse route, real and split-plane complex.

The port of the reference package's ``core/sparyser.py``.  ``SparseMatrix``
(the paper's dual CRS + CCS storage, Fig. 1) and ``pack_padded_ccs`` are
host numpy, kept here as the port's own copies; ``pack_padded_ccs`` packs
through ``padded_ccs``, which builds the packed arrays from dense matrices
in bulk (the executor's path, which holds each leaf dense).  The Gray-code loop updates the row-sum state X
with the nonzeros of the changed column only, through the padded CCS
arrays: per column j a ``(rows[j], vals[j])`` pair of length ``maxdeg``,
padded with ``(row = n, val = 0)`` entries.

* **The dummy row.**  X keeps n + 1 rows.  Row n takes the padded entries
  and only ``X[:n]`` enters a product.
* **The scatter.**  ``X[b, rows, :] = X[b, rows, :] + vals * s`` (an
  advanced-index update): within one column the live rows are distinct, so
  each live row receives exactly one add, the reference's ``X.at[r].add``.
  Duplicate indices occur only at the dummy row, which every duplicate
  leaves at +0 and no product reads, so no live value depends on the
  scatter order, and no order-free reduction touches a live row.  The
  update is in place: the engine owns X and reads only its newest state.

As in ``core/ryser.py``, every engine runs a leading batch axis and the
scalar entry runs as a one-matrix batch, so a scalar leaf equals the same
leaf inside a bucket bit for bit; the complex engine also runs that axis
where the reference uses ``lax.map`` (eager elementwise torch ops round
each element alike whatever the batch extent).  Products are sequential
chains and cross-chunk sums fixed-order twofloat trees.  Runs on whatever
device the tensors are on.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import precision as P
from .ryser import (_CEGSchedules, _final_factor, _small_n, chain_prod,
                    chain_prod_complex, chunk_geometry, complex_precision,
                    nw_base_vector, rank1_chunk_init, resolve_device,
                    tf_tree_sum)

__all__ = ["SparseMatrix", "pack_padded_ccs", "padded_ccs", "sparse_partials",
           "sparse_partials_complex", "sparse_chunked_value",
           "sparse_batched_values", "sparse_batched_values_complex",
           "sparse_values", "perm_sparyser_chunked", "perm_sparyser_batched"]


@dataclass(frozen=True)
class SparseMatrix:
    """CRS + CCS dual storage (paper Fig. 1).  Host-side numpy arrays."""
    n: int
    rptrs: np.ndarray   # (n+1,)
    cids: np.ndarray    # (nnz,) column ids, row-major order
    rvals: np.ndarray   # (nnz,)
    cptrs: np.ndarray   # (n+1,)
    rids: np.ndarray    # (nnz,) row ids, column-major order
    cvals: np.ndarray   # (nnz,)

    @property
    def nnz(self) -> int:
        return int(self.cids.shape[0])

    @property
    def density(self) -> float:
        return self.nnz / float(self.n * self.n)

    @staticmethod
    def from_dense(A: np.ndarray, tol: float = 0.0) -> "SparseMatrix":
        A = np.asarray(A)
        n = A.shape[0]
        mask = np.abs(A) > tol
        rptrs = np.zeros(n + 1, dtype=np.int32)
        cids, rvals = [], []
        for i in range(n):
            js = np.nonzero(mask[i])[0]
            cids.append(js)
            rvals.append(A[i, js])
            rptrs[i + 1] = rptrs[i] + len(js)
        cptrs = np.zeros(n + 1, dtype=np.int32)
        rids, cvals = [], []
        for j in range(n):
            is_ = np.nonzero(mask[:, j])[0]
            rids.append(is_)
            cvals.append(A[is_, j])
            cptrs[j + 1] = cptrs[j] + len(is_)
        cat = lambda xs, dt: (np.concatenate(xs).astype(dt) if xs else  # noqa: E731
                              np.zeros(0, dtype=dt))
        return SparseMatrix(
            n=n,
            rptrs=rptrs, cids=cat(cids, np.int32), rvals=cat(rvals, A.dtype),
            cptrs=cptrs, rids=cat(rids, np.int32), cvals=cat(cvals, A.dtype))

    def to_dense(self) -> np.ndarray:
        A = np.zeros((self.n, self.n), dtype=self.rvals.dtype)
        for i in range(self.n):
            sl = slice(self.rptrs[i], self.rptrs[i + 1])
            A[i, self.cids[sl]] = self.rvals[sl]
        return A

    def padded_columns(self):
        """(rows, vals) of shape (n, maxdeg): column-j nonzeros, padded with
        (row=n, val=0) -- the shape-static scatter form."""
        n = self.n
        maxdeg = max(1, int(np.max(self.cptrs[1:] - self.cptrs[:-1])))
        rows = np.full((n, maxdeg), n, dtype=np.int32)
        vals = np.zeros((n, maxdeg), dtype=self.cvals.dtype)
        for j in range(n):
            sl = slice(self.cptrs[j], self.cptrs[j + 1])
            deg = sl.stop - sl.start
            rows[j, :deg] = self.rids[sl]
            vals[j, :deg] = self.cvals[sl]
        return rows, vals

    def min_degree(self):
        """(which, index, deg): minimum nonzero count over rows and columns.

        which is 'row' or 'col'.  Used by the Alg. 4 dispatcher.
        """
        rdeg = self.rptrs[1:] - self.rptrs[:-1]
        cdeg = self.cptrs[1:] - self.cptrs[:-1]
        ri = int(np.argmin(rdeg))
        ci = int(np.argmin(cdeg))
        if rdeg[ri] <= cdeg[ci]:
            return "row", ri, int(rdeg[ri])
        return "col", ci, int(cdeg[ci])


def pack_padded_ccs(sps: list[SparseMatrix]):
    """Pack a same-size bucket into batch-stacked dense + padded-CCS arrays.

    Returns host-side ``(A_stack, rows_stack, vals_stack)`` with shapes
    (B, n, n), (B, n, maxdeg), (B, n, maxdeg); the per-matrix columns are
    padded to the bucket-wide max column degree with (row=n, val=0)
    entries, which land in the dummy row and are arithmetically inert --
    per-element numerics do not depend on the bucket's maxdeg.
    """
    if not sps:
        raise ValueError("empty bucket")
    n = sps[0].n
    if any(sp.n != n for sp in sps):
        raise ValueError("bucket must be same-size")
    dtype = np.result_type(*(sp.cvals.dtype for sp in sps))
    A_stack = np.stack([sp.to_dense().astype(dtype) for sp in sps])
    return (A_stack, *padded_ccs(A_stack))


def padded_ccs(A):
    """The padded CCS arrays of a dense (n, n) matrix or (B, n, n) stack
    without per-matrix loops: ``(rows, vals)`` of shape (..., n, maxdeg),
    column j's nonzeros in ascending row order, padded with (row = n,
    val = 0) to the stack-wide max column degree: each matrix's
    ``SparseMatrix.padded_columns`` padded further to that degree."""
    A = np.asarray(A)
    n = A.shape[-1]
    At = np.swapaxes(A, -1, -2)                          # (..., col, row)
    mask = np.abs(At) > 0
    deg = mask.sum(axis=-1)
    maxdeg = max(1, int(deg.max(initial=0)))
    order = np.argsort(~mask, axis=-1, kind="stable")[..., :maxdeg]
    live = np.arange(maxdeg) < deg[..., None]
    rows = np.where(live, order, n).astype(np.int32)
    vals = np.where(live, np.take_along_axis(At, order, axis=-1), 0)
    return rows, vals.astype(A.dtype)


# ---------------------------------------------------------------------------
# The torch engines (leading batch axis everywhere)
# ---------------------------------------------------------------------------

def _accumulator(precision: str):
    """The lane accumulator of the sparse engines: ``qq`` runs as
    ``dq_acc`` (X has no twofloat limb on this route), as in the
    reference."""
    def accum(acc, term):
        if precision == "dq_fast":
            t = P.tf_add_fast(P.TwoFloat(*acc), term)
            return (t.hi, t.lo)
        if precision in ("dq_acc", "qq"):
            t = P.tf_add_acc(P.TwoFloat(*acc), term)
            return (t.hi, t.lo)
        if precision == "kahan":
            return P.kahan_add(acc, term)
        return (acc[0] + term, acc[1])               # dd
    return accum


def _finish(acc, precision: str) -> P.TwoFloat:
    if precision in ("kahan", "dd"):
        return P.TwoFloat(acc[0], torch.zeros_like(acc[0]))
    return P.TwoFloat(*acc)


def _with_dummy_row(X):
    """(B, n, T) -> (B, n + 1, T) with a zero dummy row n."""
    return torch.cat([X, X.new_zeros(X.shape[0], 1, X.shape[-1])], dim=-2)


def _signs(S, lane_bitk, dtype):
    """Per inner step: (column, sign as a float or a (T,) lane tensor,
    parity).  The mid step's sign depends on the lane."""
    for col_j, bit, midf, par in zip(S.sched_j, S.base_bits, S.mid_flags,
                                     S.w_parity):
        if midf:
            yield col_j, (2 * (bit ^ lane_bitk) - 1).to(dtype), par
        else:
            yield col_j, float(2 * bit - 1), par


def _scatter_column(Xs, rows, vals_planes, col_j: int, s, bidx):
    """Advanced-index update of column ``col_j``'s padded entries into each
    (B, n + 1, T) plane, in place: ``X[b, rows[b, j, d], :] += vals[b, j, d]
    * s``."""
    r = rows[:, col_j]                                    # (B, maxdeg)
    out = []
    for X, vals in zip(Xs, vals_planes):
        upd = vals[:, col_j, :, None] * s                 # (B, maxdeg, T|1)
        X[bidx, r] = X[bidx, r] + upd
        out.append(X)
    return out


def _scatter_tail(Xs, rows, vals_planes, S, bidx):
    """The tail step w = C, in place: per lane t the column ``tail_j[t]``,
    signed and masked by liveness, into each plane."""
    dev = rows.device
    T = Xs[0].shape[-1]
    tj = torch.as_tensor(S.tail_j, device=dev)
    r = rows[:, tj]                                       # (B, T, maxdeg)
    tidx = torch.arange(T, device=dev)[None, :, None]
    b3 = bidx[..., None]
    out = []
    for X, vals in zip(Xs, vals_planes):
        sgn = torch.as_tensor((S.tail_sign * S.tail_live).astype(np.float64),
                              dtype=X.dtype, device=dev)
        upd = vals[:, tj] * sgn[:, None]                  # (B, T, maxdeg)
        X[b3, r, tidx] = X[b3, r, tidx] + upd
        out.append(X)
    return out


def sparse_partials(A, rows, vals, T: int, C: int, precision: str = "dq_acc",
                    chunk_offset: int = 0,
                    total_chunks: int | None = None) -> P.TwoFloat:
    """SpaRyser per-chunk partials of a (B, n, n) stack: TwoFloat of shape
    (B, T) WITHOUT the base (g == 0) term.  ``A`` serves the chunk init
    (fixed-order rank-1) and the NW base vector; ``rows`` (int64) and
    ``vals`` are the (B, n, maxdeg) padded CCS arrays driving the column
    updates."""
    n = A.shape[-1]
    dtype, dev = A.dtype, A.device
    S = _CEGSchedules(n, T, C, chunk_offset, total_chunks)
    X = _with_dummy_row(rank1_chunk_init(A, nw_base_vector(A),
                                         S.gray_bits(n, dtype, dev)))
    lane_bitk = torch.as_tensor(S.lane_bitk, device=dev)
    bidx = torch.arange(A.shape[0], device=dev)[:, None]
    accum = _accumulator(precision)

    z = torch.zeros(A.shape[:-2] + (T,), dtype=dtype, device=dev)
    acc = (z, z)
    for col_j, s, par in _signs(S, lane_bitk, dtype):
        X, = _scatter_column((X,), rows, (vals,), col_j, s, bidx)
        prod = chain_prod(X[:, :n])
        acc = accum(acc, -prod if par else prod)

    X, = _scatter_tail((X,), rows, (vals,), S, bidx)
    prod = chain_prod(X[:, :n])
    live = torch.as_tensor(S.tail_live, device=dev)
    neg = (C & 1) == 1       # (-1)^{g = start + C} == (-1)^C, chunk-uniform
    acc = accum(acc, torch.where(live, -prod if neg else prod,
                                 torch.zeros_like(prod)))
    return _finish(acc, precision)


def sparse_partials_complex(Ar, Ai, rows, vals_r, vals_i, T: int, C: int,
                            precision: str = "dq_acc",
                            chunk_offset: int = 0,
                            total_chunks: int | None = None):
    """Split-plane complex SpaRyser partials of a (B, n, n) plane pair;
    mirrors ``sparse_partials``.  Returns ``(re, im, base)``: (B, T)
    TwoFloats per component and the ``(p0_re, p0_im)`` (B,) pair of the
    g == 0 term, the product of lane 0's initial state (valid at
    ``chunk_offset == 0``).  ``qq`` runs as ``kahan``."""
    precision = complex_precision(precision)
    n = Ar.shape[-1]
    dtype, dev = Ar.dtype, Ar.device
    S = _CEGSchedules(n, T, C, chunk_offset, total_chunks)
    Gbits = S.gray_bits(n, dtype, dev)
    Xr = rank1_chunk_init(Ar, nw_base_vector(Ar), Gbits)
    Xi = rank1_chunk_init(Ai, nw_base_vector(Ai), Gbits)
    b0r, b0i = chain_prod_complex(Xr[..., :1], Xi[..., :1])
    base = (b0r[..., 0], b0i[..., 0])
    Xs = (_with_dummy_row(Xr), _with_dummy_row(Xi))
    planes = (vals_r, vals_i)
    lane_bitk = torch.as_tensor(S.lane_bitk, device=dev)
    bidx = torch.arange(Ar.shape[0], device=dev)[:, None]
    accum = _accumulator(precision)

    z = torch.zeros(Ar.shape[:-2] + (T,), dtype=dtype, device=dev)
    acc_r = acc_i = (z, z)
    for col_j, s, par in _signs(S, lane_bitk, dtype):
        Xs = _scatter_column(Xs, rows, planes, col_j, s, bidx)
        pr, pi = chain_prod_complex(Xs[0][:, :n], Xs[1][:, :n])
        acc_r = accum(acc_r, -pr if par else pr)
        acc_i = accum(acc_i, -pi if par else pi)

    Xs = _scatter_tail(Xs, rows, planes, S, bidx)
    pr, pi = chain_prod_complex(Xs[0][:, :n], Xs[1][:, :n])
    live = torch.as_tensor(S.tail_live, device=dev)
    neg = (C & 1) == 1
    zero = torch.zeros_like(pr)
    acc_r = accum(acc_r, torch.where(live, -pr if neg else pr, zero))
    acc_i = accum(acc_i, torch.where(live, -pi if neg else pi, zero))
    return _finish(acc_r, precision), _finish(acc_i, precision), base


def _close(parts: P.TwoFloat, p0, n: int):
    """Fixed-order twofloat tree over the chunks, the g == 0 term, the
    final Ryser factor."""
    hi, e1 = tf_tree_sum(parts.hi, parts.lo)
    return P.tf_value(P.tf_add_acc(P.TwoFloat(hi, e1), p0)) \
        * _final_factor(n)


def sparse_batched_values(A_stack, rows_stack, vals_stack, T: int, C: int,
                          precision: str):
    """(B,) sparse permanents of a packed same-size stack."""
    n = A_stack.shape[-1]
    parts = sparse_partials(A_stack, rows_stack, vals_stack, T, C, precision)
    p0 = chain_prod(nw_base_vector(A_stack)[..., None])[..., 0]
    return _close(parts, p0, n)


def sparse_chunked_value(A, rows, vals, T: int, C: int, precision: str):
    """0-d sparse permanent of one (n, n) matrix and its (n, maxdeg) padded
    CCS arrays, run as a one-matrix batch (equal to its bucket entry)."""
    return sparse_batched_values(A[None], rows[None], vals[None], T, C,
                                 precision)[0]


def sparse_batched_values_complex(Ar_stack, Ai_stack, rows_stack,
                                  vals_r_stack, vals_i_stack, T: int, C: int,
                                  precision: str):
    """(values_re, values_im), each (B,), of a packed split-plane complex
    stack: per-component fixed-order twofloat trees."""
    n = Ar_stack.shape[-1]
    parts_r, parts_i, (p0r, p0i) = sparse_partials_complex(
        Ar_stack, Ai_stack, rows_stack, vals_r_stack, vals_i_stack, T, C,
        precision)
    return _close(parts_r, p0r, n), _close(parts_i, p0i, n)


def sparse_values(A_stack, rows_stack, vals_stack, num_chunks: int = 4096,
                  precision: str = "dq_acc", *, device="cuda") -> torch.Tensor:
    """(B,) permanents of a packed same-size stack, the dense forms and
    their padded CCS arrays (``pack_padded_ccs`` or ``padded_ccs``) on
    ``device``: f32 or complex64 for values of those dtypes (the
    reference's dtype follows its input), else f64 or complex128."""
    device = resolve_device(device)
    A_np, rows_np, vals_np = (np.asarray(a) for a in (A_stack, rows_stack,
                                                      vals_stack))
    n = A_np.shape[-1]
    cplx = np.iscomplexobj(vals_np)
    single = vals_np.dtype in (np.float32, np.complex64)
    real_dt = np.float32 if single else np.float64
    if n <= 2:
        return _small_n(torch.as_tensor(
            A_np.astype(np.result_type(real_dt, vals_np.dtype)),
            device=device))
    T, C, _ = chunk_geometry(n, num_chunks)
    rows = torch.as_tensor(rows_np, dtype=torch.int64, device=device)
    as_real = lambda a: torch.as_tensor(  # noqa: E731
        np.ascontiguousarray(a, dtype=real_dt), device=device)
    if cplx:
        vr, vi = sparse_batched_values_complex(
            as_real(A_np.real), as_real(A_np.imag), rows,
            as_real(vals_np.real), as_real(vals_np.imag), T, C, precision)
        return torch.complex(vr, vi)
    return sparse_batched_values(as_real(A_np), rows, as_real(vals_np), T, C,
                                 precision)


def perm_sparyser_batched(sps: list[SparseMatrix], num_chunks: int = 4096,
                          precision: str = "dq_acc", *,
                          device="cuda") -> torch.Tensor:
    """Permanents of a bucket of same-size sparse matrices in one pass: a
    (B,) tensor on ``device`` in the dtype ``sparse_values`` gives.  Columns
    are padded to the bucket-wide max degree (inert, see
    ``pack_padded_ccs``)."""
    return sparse_values(*pack_padded_ccs(sps), num_chunks, precision,
                         device=device)


def perm_sparyser_chunked(sp: SparseMatrix, num_chunks: int = 4096,
                          precision: str = "dq_acc", *,
                          device="cuda") -> torch.Tensor:
    """perm of one sparse matrix by chunked SpaRyser: a 0-d tensor in the
    dtype ``sparse_values`` gives.  Runs as a one-matrix bucket, so it
    equals the same matrix's entry of ``perm_sparyser_batched`` bit for
    bit."""
    return perm_sparyser_batched([sp], num_chunks, precision,
                                 device=device)[0]
