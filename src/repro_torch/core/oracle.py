"""Exact oracles for matrix permanents (host-side, NumPy / Python bigints).

A copy of the reference package's ``core/oracle.py``.  These are the
ground truth the port's layers (torch engines, CUDA kernels) are
validated against:

* ``perm_definition``   -- O(n * n!) permutation expansion, n <= 11.
* ``perm_ryser_exact``  -- O(n * 2^n) Ryser over Python scalars; exact for
  integer matrices (bigints), high-accuracy (math.fsum) for floats.
* ``perm_bigint``       -- exact integer permanent for integer matrices.
* ``all_ones_permanent``-- closed form n! * a^n for constant matrices
  (the paper's Sec. 5 precision-test family).
"""

from __future__ import annotations

import math
from fractions import Fraction
from itertools import permutations

import numpy as np

__all__ = [
    "perm_definition",
    "perm_bigint",
    "perm_ryser_exact",
    "all_ones_permanent",
]


def perm_definition(A) -> complex | float:
    """Permanent via the definition. Exact control for small n (<= ~11)."""
    A = np.asarray(A)
    n = A.shape[0]
    assert A.shape == (n, n)
    total = 0
    for sigma in permutations(range(n)):
        p = 1
        for i in range(n):
            p = p * A[i, sigma[i]].item()
        total += p
    return total


def perm_bigint(A) -> int:
    """Exact permanent of an integer matrix via Ryser over Python bigints.

    Uses the plain inclusion-exclusion form (Eq. 2) with Gray-code updates;
    no floating point anywhere, so the result is exact for any magnitude.
    """
    A = np.asarray(A)
    n = A.shape[0]
    ai = [[int(A[i, j]) for j in range(n)] for i in range(n)]
    # Gray iteration over non-empty subsets of all n columns (Eq. 2).
    x = [0] * n
    total = 0
    for g in range(1, 1 << n):
        low = g & -g
        j = low.bit_length() - 1
        s = 1 if (g ^ (g >> 1)) & low else -1
        for i in range(n):
            x[i] += s * ai[i][j]
        prod = 1
        for i in range(n):
            prod *= x[i]
        total += (-1 if (g & 1) else 1) * prod
    return ((-1) ** n) * total


def perm_ryser_exact(A):
    """High-accuracy Ryser for real/complex floats using Fraction arithmetic
    when the input is exactly representable, falling back to float with
    math.fsum-style compensated accumulation.

    For float inputs the entries are lifted to Fractions (floats are exact
    binary rationals), so the returned value is the *exact* permanent of the
    stored matrix, rounded once at the end.
    """
    A = np.asarray(A)
    n = A.shape[0]
    if np.iscomplexobj(A):
        # complex permanent is not separable; do full complex Fraction math
        ar = [[Fraction(float(A[i, j].real)) for j in range(n)] for i in range(n)]
        ai = [[Fraction(float(A[i, j].imag)) for j in range(n)] for i in range(n)]
        xr = [Fraction(0)] * n
        xi = [Fraction(0)] * n
        tr, ti = Fraction(0), Fraction(0)
        for g in range(1, 1 << n):
            low = g & -g
            j = low.bit_length() - 1
            s = 1 if (g ^ (g >> 1)) & low else -1
            for i in range(n):
                xr[i] += s * ar[i][j]
                xi[i] += s * ai[i][j]
            pr, pi = Fraction(1), Fraction(0)
            for i in range(n):
                pr, pi = pr * xr[i] - pi * xi[i], pr * xi[i] + pi * xr[i]
            sign = -1 if (g & 1) else 1
            tr += sign * pr
            ti += sign * pi
        sgn = (-1) ** n
        return complex(float(sgn * tr), float(sgn * ti))

    af = [[Fraction(float(A[i, j])) for j in range(n)] for i in range(n)]
    x = [Fraction(0)] * n
    total = Fraction(0)
    for g in range(1, 1 << n):
        low = g & -g
        j = low.bit_length() - 1
        s = 1 if (g ^ (g >> 1)) & low else -1
        for i in range(n):
            x[i] += s * af[i][j]
        prod = Fraction(1)
        for i in range(n):
            prod *= x[i]
        total += (-1 if (g & 1) else 1) * prod
    return float((-1) ** n * total)


def all_ones_permanent(n: int, a: float = 1.0):
    """perm of the n x n constant matrix with entries a: n! * a^n.

    Returned as a Python float via exact integer/Fraction math (may overflow
    to inf for very large n; callers compare in log space then).
    """
    return float(math.factorial(n) * Fraction(float(a)) ** n)
