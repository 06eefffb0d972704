"""Split-plane complex Gray-code Ryser block partials: the CUDA kernel and
its plain PyTorch version.

The port of ``kernels/ryser_complex.py``.  The kernel
(``csrc/ryser_complex.cu``) replaces ``ryser_pallas_call_complex`` (grid
over blocks from a u64 chunk base) and
``ryser_pallas_call_complex_batched`` (grid over (batch, block), chunk base
0); both run one block body, as ``_ryser_block_cx`` serves both Pallas
kernels.  The matrix travels as (re, im) planes, f64 or f32 (complex64
input: the ``_f32`` entries), and the partials come back in the planes'
dtype, as the reference's follow its input; padded rows of the base
planes are (1 + 0i).  The window-batched mode is the only one, as in the
reference.

Every entry returns per-block ``(re_hi, re_err, im_hi, im_err)`` partials
WITHOUT the g = 0 term; ``kernels/ops.py::kernel_reduce`` closes each
plane.  The ``err`` columns are zero unless the precision is ``dq_acc`` or
``dq_fast``; ``qq`` runs as ``dd``, as in every kernel.

As in ``ryser_cuda.py``: a wrapper takes the plain version only for a
tensor on the CPU; for a CUDA tensor it launches the kernel or raises.
Launches and plain calls count in ``ryser_cuda.counters``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import gray as G
from .ryser_cuda import (PRECISION_CODES, _accum, _block_sums, _boundary,
                         _check, _check_batch, _check_range, _cumsig_device,
                         _cumsig_host, _entry, _init_state, _lane_starts,
                         _launch, _occupancy, _on_card,
                         _signed_const_schedule, _window_states, counters)

__all__ = ["ryser_cuda_call_complex", "ryser_cuda_call_complex_batched",
           "block_partials_plain_complex", "ctas_per_sm_complex"]


def _cprod_rows(row, n: int):
    """Complex chain over rows 0..n-1, ``row(i) -> (re, im)``: the kernel's
    (pr, pi) <- (pr*xr - pi*xi, pr*xi + pi*xr)."""
    pr, pi = row(0)
    for i in range(1, n):
        xr, xi = row(i)
        pr, pi = pr * xr - pi * xi, pr * xi + pi * xr
    return pr, pi


def block_partials_plain_complex(Ar_pads, Ai_pads, xbr_pads, xbi_pads,
                                 chunk_base: int, *, n: int, TB: int, C: int,
                                 Wu: int, num_blocks: int,
                                 precision: str = "dq_acc") -> torch.Tensor:
    """(B, num_blocks, 4) partials of a (B, n_pad, n_pad) plane pair in
    the planes' dtype, op for op the kernel's: same init order, same D
    sums, the product streamed row by row, the same lane tree."""
    counters["block_partials_plain_complex"] += 1
    return _plain_partials_complex(Ar_pads, Ai_pads, xbr_pads, xbi_pads,
                                   Ar_pads, Ai_pads, chunk_base, n=n, TB=TB,
                                   C=C, Wu=Wu, num_blocks=num_blocks,
                                   precision=precision)


def _plain_partials_complex(Ar_pads, Ai_pads, xbr_pads, xbi_pads, low_r,
                            low_i, chunk_base: int, *, n: int, TB: int,
                            C: int, Wu: int, num_blocks: int,
                            precision: str) -> torch.Tensor:
    """The body of the complex plain versions: the window states and the
    mid column come from the kw low columns of ``(low_r, low_i)`` (the
    planes themselves, or the sparse kernel's scattered CCS columns); the
    planes serve the init and the boundary column."""
    B, n_pad, _ = Ar_pads.shape
    dev, dt = Ar_pads.device, Ar_pads.dtype
    k, kw, M = int(math.log2(C)), int(math.log2(Wu)), C // Wu
    L = num_blocks * TB
    tensor = lambda a: torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731

    starts = _lane_starts(chunk_base, L, k)
    gbits = tensor(G.gray_bits_matrix(starts, n))
    Xr = _init_state(Ar_pads, xbr_pads, gbits, n)
    Xi = _init_state(Ai_pads, xbi_pads, gbits, n)
    del gbits
    sched = _signed_const_schedule(Wu)
    C0 = tensor(_cumsig_host(sched, n_pad))
    Dr, Di = _window_states(low_r, C0, kw), _window_states(low_i, C0, kw)
    cmr, cmi = low_r[:, :, kw - 1], low_i[:, :, kw - 1]        # (B, n_pad)
    mid_idx = Wu // 2 - 1
    z = torch.zeros((B, L), dtype=dt, device=dev)
    acc_r = acc_i = (z, z)

    for m in range(M):
        macro = starts + np.uint64(m * Wu)
        cm = -2.0 * tensor(((macro >> np.uint64(kw)) & np.uint64(1))
                           .astype(np.float64))                # (L,)
        for idx, (_j, _s, _is_mid, parity) in enumerate(sched):
            def state(i, idx=idx):
                sr = Xr[:, i] + Dr[:, i, idx:idx + 1]
                si = Xi[:, i] + Di[:, i, idx:idx + 1]
                if idx >= mid_idx:
                    sr = sr + cmr[:, i:i + 1] * cm
                    si = si + cmi[:, i:i + 1] * cm
                return sr, si
            pr, pi = _cprod_rows(state, n)
            acc_r = _accum(*acc_r, -pr if parity else pr, precision)
            acc_i = _accum(*acc_i, -pi if parity else pi, precision)
        Xr = Xr + Dr[:, :, Wu - 2:Wu - 1]
        Xr = Xr + cmr[:, :, None] * cm
        Xi = Xi + Di[:, :, Wu - 2:Wu - 1]
        Xi = Xi + cmi[:, :, None] * cm

        jb, f, live = _boundary(macro, Wu, 1 << (n - 1), tensor)
        Xr = Xr + Ar_pads[:, :, jb] * f
        Xi = Xi + Ai_pads[:, :, jb] * f
        pr, pi = _cprod_rows(lambda i: (Xr[:, i], Xi[:, i]), n)
        acc_r = _accum(*acc_r, pr * live, precision)
        acc_i = _accum(*acc_i, pi * live, precision)

    return torch.stack([*_block_sums(acc_r, TB, precision),
                        *_block_sums(acc_i, TB, precision)], dim=-1)


def _check_complex(Ar, Ai, xbr, xbi, *, batched: bool, **geo) -> None:
    _check(Ar, xbr, mode="batched", batched=batched, **geo)
    for name, t, like in (("Ai", Ai, Ar), ("xbi", xbi, xbr)):
        if (t.dtype, t.shape, t.device) != (like.dtype, like.shape,
                                            like.device):
            raise ValueError(f"{name} {t.dtype} {tuple(t.shape)} on "
                             f"{t.device} does not match its re plane")


def ryser_cuda_call_complex(Ar_pad, Ai_pad, xbr, xbi, dev_chunk_base: int, *,
                            n: int, TB: int, C: int, Wu: int,
                            num_blocks: int,
                            precision: str = "dq_acc") -> torch.Tensor:
    """(num_blocks, 4) ``(re_hi, re_err, im_hi, im_err)`` partials of one
    matrix over blocks [0, num_blocks) from chunk ``dev_chunk_base`` (g = 0
    term NOT included), in the planes' dtype (f64 or f32).  Planes
    (n_pad, n_pad), base planes (n_pad, 1)."""
    geo = dict(n=n, TB=TB, C=C, Wu=Wu, num_blocks=num_blocks,
               precision=precision)
    _check_complex(Ar_pad, Ai_pad, xbr, xbi, batched=False, **geo)
    base = int(dev_chunk_base)
    _check_range(base, num_blocks, TB, C, n)
    if Ar_pad.device.type == "cpu":
        return block_partials_plain_complex(
            Ar_pad[None], Ai_pad[None], xbr[None], xbi[None], base, **geo)[0]
    _on_card(Ar_pad)
    Ar_pad, Ai_pad, xbr, xbi = (t.contiguous()
                                for t in (Ar_pad, Ai_pad, xbr, xbi))
    n_pad = Ar_pad.shape[0]
    out = torch.empty((num_blocks, 4), dtype=Ar_pad.dtype,
                      device=Ar_pad.device)
    _launch(_entry("ryser_complex_scalar", Ar_pad), Ar_pad, xbr, out,
            Ar_pad.data_ptr(), Ai_pad.data_ptr(), xbr.data_ptr(),
            xbi.data_ptr(), _cumsig_device(Wu, n_pad, Ar_pad.device,
                                           Ar_pad.dtype)
            .data_ptr(), out.data_ptr(), base, n, n_pad, TB,
            int(math.log2(C)), int(math.log2(Wu)), num_blocks,
            PRECISION_CODES[precision])
    return out


def ryser_cuda_call_complex_batched(Ar_pads, Ai_pads, xbr_pads, xbi_pads, *,
                                    n: int, TB: int, C: int, Wu: int,
                                    num_blocks: int,
                                    precision: str = "dq_acc") -> torch.Tensor:
    """(B, num_blocks, 4) partials of a (B, n_pad, n_pad) plane pair in ONE
    launch, grid (num_blocks, B), chunk base 0 (g = 0 terms NOT
    included).  Base planes (B, n_pad, 1)."""
    geo = dict(n=n, TB=TB, C=C, Wu=Wu, num_blocks=num_blocks,
               precision=precision)
    _check_complex(Ar_pads, Ai_pads, xbr_pads, xbi_pads, batched=True, **geo)
    _check_range(0, num_blocks, TB, C, n)
    if Ar_pads.device.type == "cpu":
        return block_partials_plain_complex(Ar_pads, Ai_pads, xbr_pads,
                                            xbi_pads, 0, **geo)
    _on_card(Ar_pads)
    B, n_pad = Ar_pads.shape[0], Ar_pads.shape[1]
    _check_batch(B)
    Ar_pads, Ai_pads, xbr_pads, xbi_pads = (
        t.contiguous() for t in (Ar_pads, Ai_pads, xbr_pads, xbi_pads))
    out = torch.empty((B, num_blocks, 4), dtype=Ar_pads.dtype,
                      device=Ar_pads.device)
    _launch(_entry("ryser_complex_batched", Ar_pads), Ar_pads, xbr_pads, out,
            Ar_pads.data_ptr(), Ai_pads.data_ptr(), xbr_pads.data_ptr(),
            xbi_pads.data_ptr(), _cumsig_device(Wu, n_pad, Ar_pads.device,
                                                Ar_pads.dtype)
            .data_ptr(), out.data_ptr(), B, n, n_pad, TB,
            int(math.log2(C)), int(math.log2(Wu)), num_blocks,
            PRECISION_CODES[precision])
    return out


def ctas_per_sm_complex(n_pad: int, *, TB: int, Wu: int,
                        precision: str = "dq_acc") -> int:
    """CTAs of TB threads of the split-plane dense instantiation for
    ``n_pad`` that one SM of the card holds at once."""
    return _occupancy("ryser_complex_occupancy", n_pad,
                      PRECISION_CODES[precision], TB, int(math.log2(Wu)))
