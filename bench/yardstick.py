"""The benchmark's frozen yardstick: the work a permanent needs, and the
card's data-sheet peak.

These are counts of the floating-point operations that Ryser's formula
needs for an input, whatever implements it, set against the full
data-sheet FP64 rate, which no implementation can pass:

* real, per Gray step: n adds to update the row sums x, n - 1 multiplies
  for prod_i x[i], one add into the sum: 2n FLOPs, 2n 2^(n-1) a permanent;
* complex, per Gray step: 2n adds to update x's two planes, n - 1
  complex multiplies of 6 FLOPs (4 multiplies, 2 adds), two adds into
  the sum: 8n - 4 FLOPs, (8n - 4) 2^(n-1) a permanent.

The compensation work of a twofloat precision mode, and a fused
multiply-add that does two of these FLOPs in one instruction, change
neither count.  The peak counts an FMA as two FLOPs, as the data sheet
does.  A kernel whose operations cannot fuse into FMAs (Ryser's adds and
multiplies mostly cannot) tops out near half of it; the share is still
taken against the full peak, so that no later kernel can read over 100%
by fusing what today's does not.

The counts and rates are copied here, not imported from the program, so
that a change to the program cannot move the yardstick it is measured by.
"""

from __future__ import annotations

__all__ = ["FP64_PEAK", "complex_ryser_flops", "fp64_peak", "real_ryser_flops"]

# NVIDIA H100 data sheet: FP64 vector FLOP/s, an FMA counted as two, at
# the part's full power limit.  Keyed by a substring of
# torch.cuda.get_device_name(), checked in order.
FP64_PEAK = (("h100 pcie", 25.6e12),
             ("h100 nvl", 30.0e12),
             ("h100", 34.0e12))        # SXM: "NVIDIA H100 80GB HBM3"


def fp64_peak(device_name: str) -> float | None:
    """The data-sheet FP64 rate of the named card, or None for a card
    that has none on record (a share of it is then not reported)."""
    low = device_name.strip().lower()
    for pattern, rate in FP64_PEAK:
        if pattern in low:
            return rate
    return None


def real_ryser_flops(n: int) -> float:
    return 2.0 * n * 2.0 ** (n - 1)


def complex_ryser_flops(n: int) -> float:
    return (8.0 * n - 4.0) * 2.0 ** (n - 1)
