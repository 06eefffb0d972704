"""The control: the program's own single-precision path, one step below
the configuration's f64, fails the limits that the f64 timed path meets;
the program's plain-f64 accumulator (``dd``) does not.  Tiny cells, held
to the real cells' limits."""

import pytest

from bench import check, control, harness
from bench.tests.fixture_root import make_root

CASES = [("tiny_campaign", 2), ("tiny_amplitudes", 2), ("tiny_scalar", 6),
         ("tiny_campaign_mesh2", 2)]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("checkout"))


def _checks(root, name, items, path, seed):
    cell = harness.load_cell(root, name)
    w = control.control_window(cell, seed, items, path, "cpu")
    return check.judge(cell, w, seed, "cpu")


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("name,items", CASES)
def test_lower_precision_fails_a_limit(root, name, items, seed):
    checks = _checks(root, name, items, "lower", seed)
    assert checks and any(c["value"] > c["limit"] for c in checks)


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("name,items", CASES)
def test_the_timed_path_meets_every_limit(root, name, items, seed):
    checks = _checks(root, name, items, "program", seed)
    assert checks and all(c["value"] <= c["limit"] for c in checks)


@pytest.mark.parametrize("name,items", CASES)
def test_the_dd_accumulator_meets_every_limit(root, name, items):
    """``dd``, the accumulator below the configuration's ``dq_acc``, reads
    as the timed path does: no number of these checks tells the two apart
    (PERF.md, section 2), which is why ``lower`` is the control."""
    checks = _checks(root, name, items, "dd", 4)
    program = _checks(root, name, items, "program", 4)
    assert checks and all(c["value"] <= c["limit"] for c in checks)
    for c, p in zip(checks, program):
        assert c["value"] <= max(10 * p["value"], 1e-15)
