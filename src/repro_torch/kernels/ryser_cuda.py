"""Dense real Gray-code Ryser block partials: the CUDA kernel and its plain
PyTorch version.

The port of ``kernels/ryser_pallas.py``.  The kernel
(``csrc/ryser_dense.cu``) replaces ``ryser_pallas_call`` (grid over
blocks from a u64 chunk base) and ``ryser_pallas_call_batched`` (grid over
(batch, block), chunk base 0); both run one block body, as
``_ryser_block`` serves both Pallas kernels.

Geometry: block = TB chunks (one thread each), chunk = C = Wu * M Gray
steps.  Every entry returns per-block ``(hi, lo)`` partial sums WITHOUT
the g = 0 term; ``kernels/ops.py::kernel_reduce`` closes the sum.

Modes: ``baseline`` (sequential X updates, paper Alg. 3), ``batched``
(window states ``(X + A @ cumsig) + corr``) and, in the scalar entry only,
``schedmat`` (each inner step adds its signed schedule column
``C0 = A @ Sel``, built by ``sched_columns``; the batch entry refuses it,
as ``ryser_pallas_call_batched`` does).  Precisions follow ``_accum_add``:
``dd``, ``kahan``, ``dq_acc``, ``dq_fast``; ``qq`` runs as ``dd``.  Input
is f64 or f32, and the partials come back in the input's dtype, as the
reference's follow its input (f32 launches the ``_f32`` entries).

A wrapper takes the plain version only for a tensor on the CPU.  For a
CUDA tensor it launches the kernel or raises; a failed build or launch
propagates.  ``counters`` counts kernel launches per entry and plain
calls, so a run can show which path served it; the scalar entry's
schedmat launches count apart (``ryser_dense_scalar_schedmat``,
``..._f32_schedmat``), as they run an instantiation of their own.  Every
launch of either entry at NPAD 40-48, where the body's rows run without a
branch (``ryser_kernels.cuh::RealForm``), counts once more under
``ryser_dense_free_rows``: a campaign's waves at n = 33-48 show there.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..core import gray as G

__all__ = ["ryser_cuda_call", "ryser_cuda_call_batched",
           "block_partials_plain", "counters", "reset_counters",
           "ctas_per_sm", "sched_columns", "PRECISION_CODES",
           "FREE_ROWS_COUNTER", "FREE_ROWS_NPADS"]

# _accum_add's modes; qq has no twofloat product in-kernel and runs as dd
PRECISION_CODES = {"dd": 0, "qq": 0, "kahan": 1, "dq_acc": 2, "dq_fast": 3}
_MODE_CODES = {"baseline": 0, "batched": 1, "schedmat": 2}
_BATCH_MODES = ("baseline", "batched")   # one schedule input for the grid
_DTYPES = (torch.float64, torch.float32)
# the padded sizes above 32 whose real dense rows run branch-free, and the
# counter of their launches (both entries, every mode and dtype)
FREE_ROWS_NPADS = (40, 48)
FREE_ROWS_COUNTER = "ryser_dense_free_rows"

# one dict for every entry of the port, so one reset covers them all
counters = {"ryser_dense_scalar": 0, "ryser_dense_batched": 0,
            "ryser_dense_scalar_f32": 0, "ryser_dense_batched_f32": 0,
            "ryser_dense_scalar_schedmat": 0,
            "ryser_dense_scalar_f32_schedmat": 0, FREE_ROWS_COUNTER: 0,
            "block_partials_plain": 0, "ryser_complex_scalar": 0,
            "ryser_complex_batched": 0, "ryser_complex_scalar_f32": 0,
            "ryser_complex_batched_f32": 0, "block_partials_plain_complex": 0,
            "ryser_sparse_scalar": 0, "ryser_sparse_batched": 0,
            "ryser_sparse_scalar_f32": 0, "ryser_sparse_batched_f32": 0,
            "ryser_sparse_complex_scalar": 0,
            "ryser_sparse_complex_batched": 0,
            "ryser_sparse_complex_scalar_f32": 0,
            "ryser_sparse_complex_batched_f32": 0,
            "block_partials_plain_sparse": 0,
            "block_partials_plain_sparse_complex": 0}


def reset_counters() -> None:
    for k in counters:
        counters[k] = 0


def _signed_const_schedule(Wu: int):
    """Host schedule for inner steps w = 1..Wu-1 of any aligned window.

    Returns [(j, s_const, is_mid, parity)]; the true sign is ``s_const``
    except at the mid step (w = Wu/2), where lanes whose window base has
    bit kw set use ``-s_const``.
    """
    kw = int(math.log2(Wu))
    out = []
    for w in range(1, Wu):
        j = G.ctz(w)
        if j + 1 < kw or kw == 0:
            bit = ((w >> j) ^ (w >> (j + 1))) & 1
            is_mid = False
        else:  # w == Wu // 2, j == kw - 1
            bit = (w >> j) & 1  # == 1; true bit = 1 ^ bit_kw(base)
            is_mid = True
        out.append((j, 2 * bit - 1, is_mid, w & 1))
    return out


def sched_columns(A_pads, Wu: int) -> torch.Tensor:
    """The schedmat mode's signed schedule columns ``C0 = A @ Sel``
    (B, n_pad, Wu-1) of a (B, n_pad, n_pad) stack, in its dtype and on its
    device: column idx is ``s_const * A[:, j]`` of inner step idx.  Each
    column of Sel holds one +-1, so a gather and a multiply by +-1 give
    the product exactly (the reference forms it with ``A_pad @ sel``)."""
    sched = _signed_const_schedule(Wu)
    cols = torch.tensor([j for j, _s, _m, _p in sched], device=A_pads.device)
    signs = torch.tensor([float(s) for _j, s, _m, _p in sched],
                         dtype=A_pads.dtype, device=A_pads.device)
    return (A_pads[:, :, cols] * signs).contiguous()


def _cumsig_host(sched, n_pad: int) -> np.ndarray:
    """Cumulative signed one-hot schedule (n_pad, Wu-1) for batched mode:
    column idx holds sum_{w' <= w} s_const(w') e_{j(w')} (entries 0 or 1;
    rows >= kw are zero)."""
    C0 = np.zeros((n_pad, max(1, len(sched))), dtype=np.float64)
    run = np.zeros(n_pad, dtype=np.float64)
    for idx, (j, s, _is_mid, _) in enumerate(sched):
        run[j] += s
        C0[:, idx] = run
    return C0


# ---------------------------------------------------------------------------
# The plain version: the kernel's arithmetic, vectorised over all lanes
# ---------------------------------------------------------------------------

def _ctz_u64(g: np.ndarray) -> np.ndarray:
    low = g & (~g + np.uint64(1))            # lowest set bit, a power of two
    return np.log2(low.astype(np.float64)).astype(np.int64)


def _lane_tree(v: torch.Tensor, TB: int) -> torch.Tensor:
    """(B, L) -> (B, L // TB): the kernel's shared-memory halving tree."""
    v = v.reshape(v.shape[0], -1, TB)
    h = TB
    while h > 1:
        h //= 2
        v = v[..., :h] + v[..., h:2 * h]
    return v[..., 0]


def _accum(s, c, term, precision: str):
    """``_accum_add``: one product term into the lane accumulator (s, c)."""
    if precision == "kahan":
        y = term - c
        t = s + y
        return t, (t - s) - y
    if precision == "dq_acc":
        hi = s + term
        bp = hi - s
        e = (s - (hi - bp)) + (term - bp)
        return hi, c + e
    if precision == "dq_fast":
        hi = s + term
        bp = hi - s
        e = (s - (hi - bp)) + (term - bp) + c
        s2 = hi + e
        return s2, e - (s2 - hi)
    return s + term, c                       # dd, qq


def _block_sums(acc, TB: int, precision: str):
    """(s, c) lane accumulators -> the per-block (hi, lo) lane-tree sums;
    lo is zero unless the precision keeps an error limb."""
    s, c = acc
    lo = c if precision in ("dq_acc", "dq_fast") else torch.zeros_like(c)
    return _lane_tree(s, TB), _lane_tree(lo, TB)


def _lane_starts(chunk_base: int, L: int, k: int) -> np.ndarray:
    """Host uint64 start step of each of the L lanes (exact up to n = 64)."""
    return (np.uint64(chunk_base) + np.arange(L, dtype=np.uint64)) \
        << np.uint64(k)


def _init_state(A_pads, xb_pads, gbits, n: int):
    """X = xb + sum_j A[:, j] * graybit_j in ascending j: (B, n_pad, L)."""
    B, n_pad, _ = A_pads.shape
    X = xb_pads.reshape(B, n_pad, 1).expand(B, n_pad, gbits.shape[-1])
    for j in range(n):
        X = X + A_pads[:, :, j:j + 1] * gbits[j]
    return X


def _window_states(A_pads, C0, kw: int):
    """D = A @ cumsig (B, n_pad, Wu-1) as the kernel sums it: ascending
    k < kw from zero (cumsig rows >= kw are zero, entries 0 or 1).  Only
    the kw low columns of ``A_pads`` are read."""
    B, n_pad, _ = A_pads.shape
    D = torch.zeros((B, n_pad, C0.shape[1]), dtype=A_pads.dtype,
                    device=A_pads.device)
    for kk in range(kw):
        D = D + A_pads[:, :, kk:kk + 1] * C0[kk]
    return D


def _boundary(macro: np.ndarray, Wu: int, space: int, tensor):
    """The boundary step w = Wu of each lane's window from ``macro``:
    (column index jb as a tensor, signed live factor, live 0/1)."""
    gb = macro + np.uint64(Wu)
    jb = _ctz_u64(gb)
    ggb = gb ^ (gb >> np.uint64(1))
    sb = 2.0 * ((ggb >> jb.astype(np.uint64)) & np.uint64(1)) \
        .astype(np.float64) - 1.0
    live = tensor((gb <= np.uint64(space - 1)).astype(np.float64))
    return tensor(jb).long(), tensor(sb) * live, live


def block_partials_plain(A_pads, xb_pads, chunk_base: int, *, n: int,
                         TB: int, C: int, Wu: int, num_blocks: int,
                         precision: str = "dq_acc",
                         mode: str = "baseline") -> torch.Tensor:
    """(B, num_blocks, 2) partials of a (B, n_pad, n_pad) stack, op for op
    the kernel's: same init order, same window schedule, same lane tree.

    Lane step indices are host numpy uint64 (exact up to n = 64); the
    matrix arithmetic runs on the input's device.
    """
    counters["block_partials_plain"] += 1
    if mode not in _MODE_CODES:
        raise ValueError(f"mode must be baseline|batched|schedmat, got "
                         f"{mode!r}")
    low = A_pads if mode == "batched" else None
    C0 = sched_columns(A_pads, Wu) if mode == "schedmat" else None
    return _plain_partials(A_pads, xb_pads, low, chunk_base, n=n, TB=TB, C=C,
                           Wu=Wu, num_blocks=num_blocks, precision=precision,
                           sched_cols=C0)


def _plain_partials(A_pads, xb_pads, low, chunk_base: int, *, n: int,
                    TB: int, C: int, Wu: int, num_blocks: int,
                    precision: str, sched_cols=None) -> torch.Tensor:
    """The body of the real plain versions, in the dtype of ``A_pads``.
    ``low`` is None for the baseline and schedmat modes (sequential X
    updates: by the step's signed column, or with ``sched_cols`` (B, n_pad,
    Wu-1) by its signed schedule column and at the mid step by
    ``col_mid * (-2 bitk)``); otherwise the window states and the mid
    column come from its kw low columns: ``A_pads`` itself in the dense
    batched mode, the scattered CCS columns U in the sparse kernel.
    ``A_pads`` always serves the init and the boundary column."""
    B, n_pad, _ = A_pads.shape
    dev, dt = A_pads.device, A_pads.dtype
    k, kw, M = int(math.log2(C)), int(math.log2(Wu)), C // Wu
    L = num_blocks * TB
    tensor = lambda a: torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731

    starts = _lane_starts(chunk_base, L, k)
    X = _init_state(A_pads, xb_pads, tensor(G.gray_bits_matrix(starts, n)),
                    n)

    def prod(S):
        p = S[:, 0]
        for i in range(1, n):
            p = p * S[:, i]
        return p

    z = torch.zeros((B, L), dtype=dt, device=dev)
    acc = (z, z)
    sched = _signed_const_schedule(Wu)
    mid_idx = Wu // 2 - 1
    if low is not None:
        col_mid = low[:, :, kw - 1:kw]                         # (B, n_pad, 1)
        D = _window_states(low, tensor(_cumsig_host(sched, n_pad)), kw)

    for m in range(M):
        macro = starts + np.uint64(m * Wu)
        bitk = tensor(((macro >> np.uint64(kw)) & np.uint64(1))
                      .astype(np.float64))
        if sched_cols is not None:
            col_mid = A_pads[:, :, kw - 1:kw]
            for idx, (_j, s, is_mid, parity) in enumerate(sched):
                X = X + sched_cols[:, :, idx:idx + 1]
                if is_mid:
                    X = X + col_mid * (-2.0 * s * bitk)
                p = prod(X)
                acc = _accum(*acc, -p if parity else p, precision)
        elif low is None:
            mid_flip = 1.0 - 2.0 * bitk
            for (j, s, is_mid, parity) in sched:
                sl = mid_flip if is_mid else float(s)
                X = X + A_pads[:, :, j:j + 1] * sl
                p = prod(X)
                acc = _accum(*acc, -p if parity else p, precision)
        else:
            corr = col_mid * (-2.0 * bitk)
            for idx, (_j, _s, _is_mid, parity) in enumerate(sched):
                st = X + D[:, :, idx:idx + 1]
                if idx >= mid_idx:
                    st = st + corr
                p = prod(st)
                acc = _accum(*acc, -p if parity else p, precision)
            X = X + D[:, :, Wu - 2:Wu - 1]
            X = X + corr

        jb, f, live = _boundary(macro, Wu, 1 << (n - 1), tensor)
        X = X + A_pads[:, :, jb] * f                           # (B, n_pad, L)
        acc = _accum(*acc, prod(X) * live, precision)

    return torch.stack(_block_sums(acc, TB, precision), dim=-1)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _check(A, xb, *, n: int, TB: int, C: int, Wu: int, num_blocks: int,
           precision: str, mode: str, batched: bool) -> None:
    """Shapes, geometry, precision and mode of a real entry's input (or
    of a complex entry's re planes): f64 or f32, one dtype."""
    if A.dtype not in _DTYPES or xb.dtype != A.dtype:
        raise TypeError(f"f64 or f32 input of one dtype required, got "
                        f"{A.dtype}/{xb.dtype}")
    if xb.device != A.device:
        raise ValueError(f"A on {A.device}, xb on {xb.device}")
    if A.ndim != (3 if batched else 2) or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"bad A shape {tuple(A.shape)}")
    n_pad = A.shape[-1]
    lead = A.shape[:-2]
    if tuple(xb.shape) != (*lead, n_pad, 1):
        raise ValueError(f"xb shape {tuple(xb.shape)} != {(*lead, n_pad, 1)}")
    if not 3 <= n <= min(n_pad, 64) or n_pad % 8 or n_pad > 64:
        raise ValueError(f"n={n} n_pad={n_pad}: need 3 <= n <= n_pad <= 64, "
                         "n_pad a multiple of 8")
    for name, v in (("TB", TB), ("C", C), ("Wu", Wu)):
        if v < 1 or v & (v - 1):
            raise ValueError(f"{name}={v} must be a power of two")
    if Wu < 2 or C % Wu or TB > 256 or num_blocks < 1:
        raise ValueError(f"bad geometry TB={TB} C={C} Wu={Wu} "
                         f"blocks={num_blocks}")
    if C > 1 << (n - 1):
        raise ValueError(f"chunk size C = 2^{int(math.log2(C))} exceeds the "
                         f"2^{n - 1} step space of n={n}")
    if precision not in PRECISION_CODES:
        raise ValueError(f"unknown precision {precision!r}")
    modes = _BATCH_MODES if batched else tuple(_MODE_CODES)
    if mode not in modes:
        raise ValueError(f"{'batch grid' if batched else 'scalar entry'} "
                         f"supports {'|'.join(modes)}, got {mode!r}")


def _on_card(t) -> None:
    """A wrapper's input that is not on the CPU must be on the card."""
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")


def _check_batch(B: int) -> None:
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the grid's 65535 rows")


def _check_range(base: int, num_blocks: int, TB: int, C: int,
                 n: int) -> None:
    """The chunks [base, base + num_blocks * TB) of C steps lie in the
    2^(n-1) step space (the C entries refuse the launch otherwise)."""
    if base < 0 or (base + num_blocks * TB) * C > (1 << (n - 1)):
        raise ValueError(f"chunk range [{base}, +{num_blocks * TB}) of "
                         f"C={C} steps exceeds the 2^{n - 1} step space")


@functools.lru_cache(maxsize=64)
def _cumsig_device(Wu: int, n_pad: int, device: torch.device,
                   dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """The batched mode's cumsig on the card, copied there once per
    (Wu, n_pad, device, dtype) rather than at every launch."""
    return torch.as_tensor(_cumsig_host(_signed_const_schedule(Wu), n_pad),
                           dtype=dtype, device=device)


def _c0(mode: str, A_pads, Wu: int):
    """The kernel's schedule input: cumsig for the batched mode, the
    signed schedule columns of the (one) matrix for schedmat, None for the
    baseline mode, which reads none (NULL)."""
    if mode == "batched":
        return _cumsig_device(Wu, A_pads.shape[-1], A_pads.device,
                              A_pads.dtype)
    if mode == "schedmat":
        return sched_columns(A_pads.reshape(-1, *A_pads.shape[-2:]), Wu)[0]
    return None


def _occupancy(entry: str, *args) -> int:
    """CTAs one SM holds at once, from the occupancy query ``entry`` of
    the kernel library (registers and shared memory of the
    instantiation)."""
    import ctypes

    from .build import load_library
    lib = load_library()
    ctas = ctypes.c_int(0)
    rc = getattr(lib, entry)(*args, ctypes.byref(ctas))
    if rc != 0:
        raise RuntimeError(f"{entry} failed: "
                           f"{lib.ryser_error_string(rc).decode()} ({rc})")
    return ctas.value


def ctas_per_sm(n_pad: int, *, TB: int, Wu: int, precision: str = "dq_acc",
                mode: str = "batched") -> int:
    """CTAs of TB threads of the real dense instantiation for ``n_pad``
    that one SM of the card holds at once (the campaign's wave width)."""
    return _occupancy("ryser_dense_occupancy", n_pad,
                      PRECISION_CODES[precision], TB, int(math.log2(Wu)),
                      _MODE_CODES[mode])


def _entry(name: str, A) -> str:
    """The C entry for ``A``'s dtype: ``name`` for f64, ``name_f32`` for
    f32 (every entry has an f32 twin)."""
    return name if A.dtype == torch.float64 else f"{name}_f32"


def _launch(entry: str, A, xb, out, *args, counter: str | None = None) -> None:
    """Call the C entry ``entry`` on A's stream; count the launch under
    ``counter`` (default: the entry's name)."""
    from .build import load_library
    lib = load_library()
    rc = getattr(lib, entry)(*args,
                             torch.cuda.current_stream(A.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} failed: "
                           f"{lib.ryser_error_string(rc).decode()} ({rc})")
    counters[counter or entry] += 1


def _count_free_rows(A_pads) -> None:
    """Count a dense launch again under FREE_ROWS_COUNTER when its NPAD
    runs the rows branch-free above 32."""
    if A_pads.shape[-1] in FREE_ROWS_NPADS:
        counters[FREE_ROWS_COUNTER] += 1


def ryser_cuda_call(A_pad, x_base_pad, dev_chunk_base: int, *, n: int,
                    TB: int, C: int, Wu: int, num_blocks: int,
                    precision: str = "dq_acc",
                    mode: str = "baseline") -> torch.Tensor:
    """(num_blocks, 2) per-block (hi, lo) partials of one matrix over
    blocks [0, num_blocks) from chunk ``dev_chunk_base`` (g = 0 term NOT
    included), in the input's dtype.  ``A_pad`` is (n_pad, n_pad),
    ``x_base_pad`` (n_pad, 1), f64 or f32; every mode."""
    _check(A_pad, x_base_pad, n=n, TB=TB, C=C, Wu=Wu, num_blocks=num_blocks,
           precision=precision, mode=mode, batched=False)
    base = int(dev_chunk_base)
    _check_range(base, num_blocks, TB, C, n)
    if A_pad.device.type == "cpu":
        return block_partials_plain(A_pad[None], x_base_pad[None], base,
                                    n=n, TB=TB, C=C, Wu=Wu,
                                    num_blocks=num_blocks,
                                    precision=precision, mode=mode)[0]
    _on_card(A_pad)
    A_pad, x_base_pad = A_pad.contiguous(), x_base_pad.contiguous()
    out = torch.empty((num_blocks, 2), dtype=A_pad.dtype,
                      device=A_pad.device)
    c0 = _c0(mode, A_pad, Wu)
    entry = _entry("ryser_dense_scalar", A_pad)
    _launch(entry, A_pad, x_base_pad, out,
            A_pad.data_ptr(), x_base_pad.data_ptr(),
            None if c0 is None else c0.data_ptr(), out.data_ptr(),
            base, n, A_pad.shape[0], TB,
            int(math.log2(C)), int(math.log2(Wu)), num_blocks,
            PRECISION_CODES[precision], _MODE_CODES[mode],
            counter=f"{entry}_schedmat" if mode == "schedmat" else None)
    _count_free_rows(A_pad)
    return out


def ryser_cuda_call_batched(A_pads, x_base_pads, *, n: int, TB: int, C: int,
                            Wu: int, num_blocks: int,
                            precision: str = "dq_acc",
                            mode: str = "batched") -> torch.Tensor:
    """(B, num_blocks, 2) partials of a (B, n_pad, n_pad) stack in ONE
    launch, grid (num_blocks, B), chunk base 0 (g = 0 terms NOT
    included), in the input's dtype.  ``x_base_pads`` is (B, n_pad, 1).
    ``schedmat`` raises ``ValueError``: its columns are per matrix."""
    _check(A_pads, x_base_pads, n=n, TB=TB, C=C, Wu=Wu,
           num_blocks=num_blocks, precision=precision, mode=mode,
           batched=True)
    _check_range(0, num_blocks, TB, C, n)
    if A_pads.device.type == "cpu":
        return block_partials_plain(A_pads, x_base_pads, 0, n=n, TB=TB, C=C,
                                    Wu=Wu, num_blocks=num_blocks,
                                    precision=precision, mode=mode)
    _on_card(A_pads)
    B = A_pads.shape[0]
    _check_batch(B)
    A_pads, x_base_pads = A_pads.contiguous(), x_base_pads.contiguous()
    out = torch.empty((B, num_blocks, 2), dtype=A_pads.dtype,
                      device=A_pads.device)
    c0 = _c0(mode, A_pads, Wu)
    _launch(_entry("ryser_dense_batched", A_pads), A_pads, x_base_pads, out,
            A_pads.data_ptr(), x_base_pads.data_ptr(),
            None if c0 is None else c0.data_ptr(), out.data_ptr(),
            B, n, A_pads.shape[1], TB, int(math.log2(C)),
            int(math.log2(Wu)), num_blocks, PRECISION_CODES[precision],
            _MODE_CODES[mode])
    _count_free_rows(A_pads)
    return out
