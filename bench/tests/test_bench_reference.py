"""The plain reference against brute force, and its slices against the
program's decomposition of a campaign."""

import itertools
import math

import numpy as np
import pytest
import torch

from bench.reference import ryser as R


def _perm_definition(A):
    n = A.shape[0]
    return sum(math.prod(A[i, s[i]] for i in range(n))
               for s in itertools.permutations(range(n)))


@pytest.mark.parametrize("n", [1, 2, 3, 5, 7])
@pytest.mark.parametrize("cplx", [False, True])
def test_permanent_matches_the_definition(n, cplx):
    rng = np.random.default_rng(n)
    A = rng.uniform(-1, 1, (n, n))
    if cplx:
        A = A + 1j * rng.uniform(-1, 1, (n, n))
    value, scale = R.permanent(torch.as_tensor(A), block=8)
    want = _perm_definition(A)
    assert abs(value - want) <= 1e-13 * max(scale, 1.0)
    assert scale >= abs(want) * (1 - 1e-12)


def test_blocks_do_not_change_the_sum():
    A = torch.as_tensor(np.random.default_rng(3).uniform(-1, 1, (9, 9)))
    a = R.step_sums(A, 5, 200, block=7)
    b = R.step_sums(A, 5, 200, block=1 << 20)
    assert abs(a[0] - b[0]) <= 1e-13 * a[1]
    assert math.isclose(a[1], b[1], rel_tol=1e-13)


def test_slices_cover_the_steps_once():
    n, S = 9, 8
    bounds = [R.slice_bounds(n, S, s) for s in range(S)]
    assert bounds[0][0] == 1 and bounds[-1][1] == 2 ** (n - 1)
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    with pytest.raises(ValueError):
        R.slice_bounds(n, 3, 0)


def test_slices_and_base_term_close_to_the_permanent():
    A = torch.as_tensor(np.random.default_rng(4).uniform(-1, 1, (8, 8)))
    parts = [R.step_sums(A, *R.slice_bounds(8, 4, s))[0] for s in range(4)]
    value = R.final_factor(8) * (math.fsum(parts) + R.base_term(A))
    assert abs(value - R.permanent(A)[0]) <= 1e-13 * R.permanent(A)[1]


@pytest.mark.parametrize("cplx", [False, True])
def test_slices_are_the_programs(cplx):
    """The program's campaign, on the CPU, records in slice s the sum the
    reference gives over slice s's steps."""
    from repro_torch.core.distributed import run_campaign
    from repro_torch.core.stepspace import plan_slices
    n = 11
    rng = np.random.default_rng(5)
    A = rng.uniform(-1, 1, (n, n))
    if cplx:
        A = A + 1j * rng.uniform(-1, 1, (n, n))
    ts, cps, C = plan_slices(n, 8, 1, 4)
    _, st = run_campaign(A, total_slices=ts, chunks_per_slice=cps,
                         chunk_size=C, backend="cuda", device="cpu")
    for s in range(ts):
        ref, mag = R.step_sums(torch.as_tensor(A), *R.slice_bounds(n, ts, s))
        assert abs(complex(st.hi[s]) + complex(st.lo[s]) - ref) <= 1e-14 * mag
