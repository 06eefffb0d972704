"""DM elimination and Forbert-Marx compression: the port's copy
(``repro_torch.core.decompose``) against the reference's
(``repro.core.decompose``), and the planning cost both pay on random
sparse masks.

Both are host NumPy.  Bars: the leaves must be equal -- the same count,
order, coefficients and matrices, bit for bit -- since the port's planner
sums them in the same order as the reference's.

Run as a script, it times both on the density-0.2 request pool of the
service's soak (``run_soak`` at n = 24, density 0.2, pool 8, seed 0 --
the soak CLI's defaults but --perm-n 24 --density 0.2):

    PYTHONPATH=src python tests/test_torch_decompose.py
"""

import time

import numpy as np
import pytest

from repro.core import decompose as RD
from repro_torch.core import decompose as TD


def _masked(rng, n: int, density: float, cplx: bool) -> np.ndarray:
    """``run_soak``'s draw: U(-1, 1) entries (complex: both parts), then a
    random mask at ``density``."""
    M = rng.uniform(-1.0, 1.0, (n, n))
    if cplx:
        M = M + 1j * rng.uniform(-1.0, 1.0, (n, n))
    return M * (rng.uniform(0, 1, (n, n)) < density)


def _soak_pool(n: int = 24, density: float = 0.2, k: int = 8,
               seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    return [_masked(rng, n, density, False) for _ in range(k)]


def _dm_fm(D, M):
    W, removed = D.dm_eliminate(M.copy())
    return removed, W, (D.fm_decompose(W) if W.any() else [])


def _same_leaves(a, b) -> bool:
    return len(a) == len(b) and all(
        x.coef == y.coef and x.matrix.shape == y.matrix.shape
        and np.array_equal(x.matrix, y.matrix) for x, y in zip(a, b))


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("n,density", [(8, 0.4), (12, 0.3), (16, 0.25),
                                       (20, 0.2)])
def test_dm_fm_leaves_equal_reference(n, density, cplx):
    rng = np.random.default_rng([n, int(100 * density), cplx])
    for _ in range(6):
        M = _masked(rng, n, density, cplx)
        r_removed, r_work, r_leaves = _dm_fm(RD, M)
        t_removed, t_work, t_leaves = _dm_fm(TD, M)
        assert t_removed == r_removed
        assert np.array_equal(t_work, r_work)
        assert _same_leaves(t_leaves, r_leaves)


def test_fm_expands_a_random_density_mask_into_small_leaves():
    """The planning fault of ROADMAP section 3: one matrix of the soak's
    density-0.2 pool at n = 24 (index 7, the cheapest to plan that DM does
    not zero) becomes over a thousand FM leaves, none larger than 7 x 7,
    where one n = 24 leaf is 24 x 2^23 Ryser steps on the card.  Both
    packages give the same leaves."""
    M = _soak_pool()[7]
    _, _, t_leaves = _dm_fm(TD, M)
    _, _, r_leaves = _dm_fm(RD, M)
    assert len(t_leaves) > 1000
    assert max(l.matrix.shape[0] for l in t_leaves) <= 7
    assert _same_leaves(t_leaves, r_leaves)


def main() -> None:
    pool = _soak_pool()
    print("n = 24, density 0.2, run_soak pool of 8 (seed 0): "
          "DM + FM seconds and leaves, port | reference")
    for i, M in enumerate(pool):
        row = []
        for D in (TD, RD):
            t0 = time.perf_counter()
            _, _, leaves = _dm_fm(D, M)
            row.append((time.perf_counter() - t0, len(leaves)))
        print(f"  matrix {i}: port {row[0][0]:.3f} s ({row[0][1]} leaves) | "
              f"reference {row[1][0]:.3f} s ({row[1][1]} leaves)")


if __name__ == "__main__":
    main()
