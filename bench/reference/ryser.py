"""Plain Ryser sums: the reference that decides a run's ``correct``.

Plain PyTorch, written from the formula and nothing else: no kernel, no
incremental update, no twofloat.  Gray step g of an n x n matrix A
(0 <= g < 2^(n-1)) takes the columns j < n - 1 whose bit is set in
gray(g) = g ^ (g >> 1), and

    x_g = A[:, n-1] - rowsum(A) / 2 + sum_{j in gray(g)} A[:, j]
    perm(A) = 2 (-1)^(n-1) * sum_g (-1)^g prod_i x_g[i]

(Nijenhuis and Wilf's form of Ryser's formula).  Each x_g is computed
afresh from A by one matrix product, so no rounding carries from step to
step.  ``step_sums`` returns the signed sum over a range of steps and the
sum of the terms' magnitudes, the scale every gap is measured against.
Block sums are added on the host with ``math.fsum``.

A campaign's slice s of S, with w = 2^(n-1) / S, covers the steps
s w < g <= (s + 1) w that lie below 2^(n-1): a chunk of Gray steps starts
after the step its state is set up at, and the g = 0 term, which
``base_term`` gives, is in no slice.
"""

from __future__ import annotations

import math

import torch

__all__ = ["BLOCK", "base_term", "final_factor", "fsum", "permanent",
           "slice_bounds", "step_sums"]

BLOCK = 1 << 20          # Gray steps per block: ~1 GB of f64 work at n = 40


def final_factor(n: int) -> int:
    return 2 * (-1) ** (n - 1)


def _base(A: torch.Tensor) -> torch.Tensor:
    return A[:, -1] - A.sum(dim=1) / 2


def base_term(A: torch.Tensor):
    """prod_i x_0[i]: the g = 0 term, as a Python float or complex."""
    return torch.prod(_base(A)).item()


def fsum(values) -> float | complex:
    """``math.fsum`` of Python floats, or of complex numbers part by part."""
    values = list(values)
    if any(isinstance(v, complex) for v in values):
        return complex(math.fsum(v.real for v in values),
                       math.fsum(v.imag for v in values))
    return math.fsum(values)


def step_sums(A: torch.Tensor, first: int, last: int, *,
              block: int = BLOCK):
    """(sum_{g = first}^{last - 1} (-1)^g prod_i x_g[i],
    sum_{g = first}^{last - 1} |prod_i x_g[i]|) for the matrix ``A``
    (float64 or complex128, on any device), as Python numbers."""
    n = A.shape[0]
    cols = torch.arange(n - 1, device=A.device)
    head = A[:, :n - 1].T.contiguous()                 # (n - 1, n)
    base = _base(A)
    signed, magnitude = [], []
    for lo in range(first, last, block):
        g = torch.arange(lo, min(lo + block, last), device=A.device,
                         dtype=torch.int64)
        bits = ((g ^ (g >> 1))[:, None] >> cols) & 1
        x = base + bits.to(A.dtype) @ head             # (K, n)
        terms = torch.prod(x, dim=1)
        sign = 1 - 2 * (g & 1)
        signed.append((terms * sign.to(A.dtype)).sum().item())
        magnitude.append(terms.abs().sum().item())
    return fsum(signed), math.fsum(magnitude)


def permanent(A: torch.Tensor, *, block: int = BLOCK):
    """(perm(A), |factor| * sum_g |prod_i x_g[i]|): the value and the
    scale of its rounding."""
    n = A.shape[0]
    s, m = step_sums(A, 0, 1 << (n - 1), block=block)
    f = final_factor(n)
    return f * s, abs(f) * m


def slice_bounds(n: int, total_slices: int, s: int) -> tuple[int, int]:
    """Steps [first, last) of slice ``s`` of ``total_slices``:
    (s w, (s + 1) w] with w = 2^(n-1) / total_slices, cut at 2^(n-1)."""
    width = (1 << (n - 1)) // total_slices
    if width * total_slices != 1 << (n - 1):
        raise ValueError(f"{total_slices} slices do not split the "
                         f"2^{n - 1} steps of n = {n} evenly")
    return s * width + 1, min((s + 1) * width + 1, 1 << (n - 1))
