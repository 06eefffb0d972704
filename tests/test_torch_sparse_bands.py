"""The ``sparse_bands_real`` deployment on the port's CPU path: weighted
(0,1)-circulant bands, relabelled (``bench/families/relabelled_band7.py``),
through ``PermanentSolver`` with the configuration's own ``SolverConfig``.

At n = 32 and degree 7 a band plans to one whole sparse leaf (DM removes
nothing from a regular bipartite graph, FM leaves a minimum degree above
4 whole, density 7/32 is under ``DENSITY_SWITCH``, and its cost 7 2^31 is
under the campaign threshold); at n = 33 the leaf re-routes to the
campaign.  At n = 18, degree 5 (density 0.278, minimum degree 5) the same
plan shape runs the sparse kernel's plain version, held against the
benchmark's reference (``bench/reference/ryser.py``) to the cell's limit.
"""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench.reference import ryser as R  # noqa: E402
from repro_torch import PermanentSolver, SolverConfig  # noqa: E402
from repro_torch.core import planner  # noqa: E402

CONFIG = json.loads((ROOT / "bench/configs/sparse_bands_real.json")
                    .read_text())
LIMIT = json.loads((ROOT / "bench/workloads/sparse_bands32.json")
                   .read_text())["limits"]["value_gap"]


def _family():
    path = ROOT / "bench/families/relabelled_band7.py"
    spec = importlib.util.spec_from_file_location("relabelled_band7", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FAMILY = _family()


def _solver():
    return PermanentSolver(SolverConfig(**CONFIG["solver"], device="cpu"))


def _band(n: int, degree: int, seed: int, low=0.0, high=1.0) -> np.ndarray:
    gen = np.random.default_rng(seed)
    return FAMILY.build(FAMILY.draw_band(gen, n, 1, degree, low, high))[0]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_band32_plans_to_one_whole_sparse_leaf(seed):
    A = _band(32, 7, seed)
    plan = _solver().plan(A)
    (entry,) = plan.entries
    assert entry.dm_removed == 0 and entry.fm_leaves == 1
    assert entry.density == pytest.approx(7 / 32)
    assert entry.density < planner.DENSITY_SWITCH
    (leaf,) = plan.leaves
    assert leaf.route == planner.ROUTE_SPARSE and leaf.n == 32
    assert leaf.campaign is None
    cost = planner._leaf_cost(leaf.matrix, leaf.route)
    assert cost == 7 * 2.0 ** 31
    assert cost < CONFIG["solver"]["campaign_threshold"]


def test_band33_plans_to_the_campaign():
    plan = _solver().plan(_band(33, 7, 4))
    (leaf,) = plan.leaves
    assert plan.entries[0].fm_leaves == 1
    assert leaf.route == planner.ROUTE_CAMPAIGN and leaf.campaign is not None


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_solver_matches_the_reference_within_the_cells_limit(seed):
    A = _band(18, 5, seed)
    solver = _solver()
    plan = solver.plan(A)
    assert [l.route for l in plan.leaves] == [planner.ROUTE_SPARSE]
    value, report = solver.execute(plan, return_report=True)
    assert report.dispatch == ["sparse(n=18,cuda)"]
    ref, mag = R.permanent(torch.tensor(A, dtype=torch.float64))
    assert abs(value - ref) / mag <= LIMIT


def test_relabelling_a_01_band_leaves_its_count():
    """The (0,1) band counts the perfect matchings of the circulant graph;
    relabelling rows and columns counts the same graph's."""
    ones = _band(18, 5, 0, low=1.0, high=1.0)
    gen = np.random.default_rng(8)
    plain = np.zeros((18, 18))
    plain[FAMILY.band(18, 5), np.arange(18)[:, None]] = 1.0
    count, _ = R.permanent(torch.tensor(plain))
    assert count == round(count) and count > 0
    solver = _solver()
    values = [solver.execute(solver.plan(M)) for M in
              [plain, ones] + [plain[gen.permutation(18)][:, gen.permutation(18)]
                               for _ in range(3)]]
    assert all(v == count for v in values)
