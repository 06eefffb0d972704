"""Compensated floating-point arithmetic (paper Sec. 5) on torch tensors.

The port of the reference package's ``core/precision.py``.  A twofloat
``(hi, lo)`` pair doubles the mantissa of its base dtype; on the H100 the
base is native f64, so the ladder is the paper's df64 (~106-bit mantissa).

Every primitive is a sequence of elementwise torch ops.  Eager torch runs
each op as its own kernel and never contracts a multiply and an add into
one FMA, which the error-free transforms rely on: ``two_prod`` is Dekker's
split product and assumes no FMA.  So never rewrite these with
``torch.addcmul`` / ``addmm`` / ``lerp``, which round once.

References: Dekker 1971 [30] (fast/sloppy add, split, two_prod),
Knuth TwoSum (accurate add, the NVIDIA-forum variant [31]), Kahan 1965 [29].
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

__all__ = [
    "two_sum",
    "fast_two_sum",
    "split",
    "two_prod",
    "TwoFloat",
    "tf_from",
    "tf_add_fast",
    "tf_add_acc",
    "tf_add_tf",
    "tf_mul_tf",
    "tf_value",
    "kahan_add",
    "PRECISION_MODES",
]


# ---------------------------------------------------------------------------
# Error-free transformations
# ---------------------------------------------------------------------------

def two_sum(a, b):
    """Knuth TwoSum: s + e == a + b exactly (6 flops, branch-free)."""
    s = a + b
    bp = s - a
    e = (a - (s - bp)) + (b - bp)
    return s, e


def fast_two_sum(a, b):
    """Dekker FastTwoSum: requires |a| >= |b| (3 flops)."""
    s = a + b
    e = b - (s - a)
    return s, e


def _split_const(dtype) -> float:
    """Dekker splitting constant 2^ceil(p/2) + 1 for p-bit mantissa."""
    p = round(-math.log2(torch.finfo(dtype).eps)) + 1  # incl. implicit bit
    return float((1 << ((p + 1) // 2)) + 1)


def split(a):
    """Dekker split: a == hi + lo with hi, lo having ~p/2 mantissa bits."""
    c = _split_const(a.dtype) * a
    hi = c - (c - a)
    lo = a - hi
    return hi, lo


def two_prod(a, b):
    """Dekker TwoProd via splitting (no FMA assumed): p + e == a * b."""
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


# ---------------------------------------------------------------------------
# TwoFloat ("emulated quad")
# ---------------------------------------------------------------------------

class TwoFloat(NamedTuple):
    hi: torch.Tensor
    lo: torch.Tensor


def tf_from(x) -> TwoFloat:
    return TwoFloat(x, torch.zeros_like(x))


def tf_add_fast(t: TwoFloat, b) -> TwoFloat:
    """t + b, Dekker-style sloppy add (the paper's DQ[30]; 10-flop class)."""
    s, e = two_sum(t.hi, b)
    return TwoFloat(*fast_two_sum(s, e + t.lo))


def tf_add_acc(t: TwoFloat, b) -> TwoFloat:
    """t + b, accurate two_sum-based add (the paper's DQ[31]; 18-flop class)."""
    s, e = two_sum(t.hi, b)
    lo, e2 = two_sum(t.lo, e)
    hi, lo = fast_two_sum(s, lo)
    return TwoFloat(*fast_two_sum(hi, lo + e2))


def tf_add_tf(a: TwoFloat, b: TwoFloat) -> TwoFloat:
    """Full twofloat + twofloat add (used for the outer/global reduction)."""
    s, e = two_sum(a.hi, b.hi)
    e = e + a.lo + b.lo
    return TwoFloat(*fast_two_sum(s, e))


def tf_mul_tf(a: TwoFloat, b: TwoFloat) -> TwoFloat:
    p, e = two_prod(a.hi, b.hi)
    e = e + (a.hi * b.lo + a.lo * b.hi)
    return TwoFloat(*fast_two_sum(p, e))


def tf_value(t: TwoFloat):
    return t.hi + t.lo


# ---------------------------------------------------------------------------
# Kahan compensated accumulation
# ---------------------------------------------------------------------------

def kahan_add(acc, x):
    """acc = (sum, c); returns updated (sum, c) with compensation c."""
    s, c = acc
    y = x - c
    t = s + y
    c = (t - s) - y
    return (t, c)


# The engine-level precision modes mirroring the paper's Table 3 columns.
PRECISION_MODES = ("dd", "dq_fast", "dq_acc", "qq", "kahan")
