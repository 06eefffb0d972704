"""Gray-code machinery for Ryser/Nijenhuis-Wilf permanent computation.

The port of the reference package's ``core/gray.py``.  The Nijenhuis-Wilf
variant iterates column subsets S of {0..n-2} in binary reflected
Gray-code order: at global step ``g`` (1-based) the changed bit is
``j = ctz(g)`` and its new value is bit ``j`` of ``gray(g) = g ^ (g >> 1)``.

For chunks of size ``2^k`` starting at multiples of ``2^k`` the changed
bit at local step ``w < 2^k`` is ``ctz(w)`` for every chunk; only the
final local step (``w = 2^k``) has a chunk-dependent bit.  The
accumulation sign ``(-1)^g`` equals ``(-1)^w`` for such chunks.

Python-int helpers build host schedules; the ``*_torch`` helpers evaluate
the same formulas on integer tensors.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "gray",
    "ctz",
    "gray_bit",
    "step_sign",
    "changed_bit_schedule",
    "gray_bits_matrix",
    "gray_code_torch",
    "step_sign_torch",
]


# ---------------------------------------------------------------------------
# Python-int versions (host constants; exact for any n via bigints)
# ---------------------------------------------------------------------------

def gray(g: int) -> int:
    """The g-th binary reflected Gray code."""
    return g ^ (g >> 1)


def ctz(g: int) -> int:
    """Count trailing zeros == index of the bit changed at step g (g >= 1)."""
    if g <= 0:
        raise ValueError("ctz requires g >= 1")
    return (g & -g).bit_length() - 1


def gray_bit(g: int, j: int) -> int:
    """Bit j of gray(g)."""
    return (gray(g) >> j) & 1


def step_sign(g: int) -> int:
    """+1 if the changed bit at step g turned on, else -1."""
    return 2 * gray_bit(g, ctz(g)) - 1


def changed_bit_schedule(chunk_log2: int) -> np.ndarray:
    """Changed-bit index for local steps ``w = 1 .. 2^k - 1`` of an aligned
    power-of-2 chunk (identical for every chunk).  Length ``2^k - 1``."""
    k = chunk_log2
    return np.array([ctz(w) for w in range(1, 1 << k)], dtype=np.int32)


def gray_bits_matrix(starts: np.ndarray, nbits: int) -> np.ndarray:
    """(nbits, T) 0/1 matrix: column t holds the bits of gray(starts[t])."""
    starts = np.asarray(starts, dtype=np.uint64)
    g = starts ^ (starts >> np.uint64(1))
    j = np.arange(nbits, dtype=np.uint64)[:, None]
    return ((g[None, :] >> j) & np.uint64(1)).astype(np.int32)


# ---------------------------------------------------------------------------
# torch versions (vectorized over lanes)
# ---------------------------------------------------------------------------

def gray_code_torch(g: torch.Tensor) -> torch.Tensor:
    """gray(g) for integer tensors."""
    return g ^ (g >> 1)


def step_sign_torch(g: torch.Tensor, j) -> torch.Tensor:
    """Vectorized step sign: +1 if bit j of gray(g) is 1 else -1 (int32).

    ``bit_j(gray(g)) = (g >> j ^ g >> (j+1)) & 1``.
    """
    b = ((g >> j) ^ (g >> (j + 1))) & 1
    return 2 * b.to(torch.int32) - 1
