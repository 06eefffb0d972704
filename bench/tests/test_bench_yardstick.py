"""The frozen yardstick against brute-force operation counts."""

import pytest

from bench import byname, yardstick
from bench.tests.fixture_root import REAL


def _count_real(n: int) -> int:
    """FLOPs of Ryser's Gray-code loop over 2^(n-1) steps, counted as it
    runs: n adds to update x (none at g = 0), n - 1 multiplies for the
    product, one add into the sum."""
    flops = 0
    for g in range(2 ** (n - 1)):
        if g:
            flops += n
        flops += (n - 1) + 1
    return flops


def _count_complex(n: int) -> int:
    """The same for complex entries: 2n adds to update x's planes, n - 1
    complex multiplies of 4 multiplies and 2 adds, 2 adds into the sum."""
    flops = 0
    for g in range(2 ** (n - 1)):
        if g:
            flops += 2 * n
        flops += 6 * (n - 1) + 2
    return flops


@pytest.mark.parametrize("n", [3, 4, 6, 9, 12])
def test_counts_match_brute_force(n):
    # the yardstick counts the g = 0 step's update too: one step's adds
    assert yardstick.real_ryser_flops(n) - _count_real(n) == n
    assert yardstick.complex_ryser_flops(n) - _count_complex(n) == 2 * n
    # each family counts its permanents by the yardstick
    assert byname.module(REAL, "families", "uniform").flops(n) == \
        yardstick.real_ryser_flops(n)
    assert byname.module(REAL, "families", "haar_submatrices").flops(n) == \
        yardstick.complex_ryser_flops(n)


def test_headline_counts():
    assert yardstick.real_ryser_flops(38) == 2 * 38 * 2 ** 37
    assert yardstick.complex_ryser_flops(24) == (8 * 24 - 4) * 2 ** 23


@pytest.mark.parametrize("name,peak", [
    ("NVIDIA H100 80GB HBM3", 34e12), ("NVIDIA H100 PCIe", 25.6e12),
    ("NVIDIA H100 NVL", 30e12), ("cpu", None), ("NVIDIA A100", None)])
def test_peaks_by_card_name(name, peak):
    assert yardstick.fp64_peak(name) == peak
