"""The general generator and its families: the same seed gives the same
inputs."""

import numpy as np
import pytest

from bench import byname, harness, inputs
from bench.tests.fixture_root import REAL

DENSE = {"family": "uniform", "low": -1.0, "high": 1.0}
BOSON = {"family": "haar_submatrices", "modes": 36, "photons": 6}
SEEDS = [0, 7, 2 ** 31 + 11, -5, 2 ** 70 + 3]


def Draws(config, traffic, seed, stream):
    cell = harness.Cell(name="probe", config=config, traffic=traffic,
                        chips=1, spec={}, metrics={}, root=REAL)
    return inputs.Draws(cell, seed, stream)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("config,traffic", [
    (DENSE, {"n": 9, "batch": 1}), (DENSE, {"n": 5, "batch": 4}),
    (BOSON, {"n": 6, "batch": 8})], ids=["scalar", "stack", "boson"])
def test_same_seed_same_inputs(seed, config, traffic):
    a = Draws(config, traffic, seed, "window")
    b = Draws(config, traffic, seed, "window")
    for _ in range(3):
        (ma, ta), (mb, tb) = a.next(), b.next()
        np.testing.assert_array_equal(ma, mb)
        np.testing.assert_array_equal(ta, tb)
        np.testing.assert_array_equal(a.matrices(ta), ma)


@pytest.mark.parametrize("config,traffic", [
    (DENSE, {"n": 9, "batch": 1}), (BOSON, {"n": 6, "batch": 8})],
    ids=["dense", "boson"])
def test_streams_and_seeds_differ(config, traffic):
    first = Draws(config, traffic, 3, "window").next()[0]
    assert not np.array_equal(
        first, Draws(config, traffic, 3, "warmup").next()[0])
    assert not np.array_equal(
        first, Draws(config, traffic, 4, "window").next()[0])


def test_uniform_entries_and_shapes():
    m, _ = Draws(DENSE, {"n": 30, "batch": 1}, 1, "window").next()
    assert m.shape == (30, 30) and m.dtype == np.float64
    assert m.min() >= -1.0 and m.max() < 1.0
    s, _ = Draws(DENSE, {"n": 5, "batch": 3}, 1, "window").next()
    assert s.shape == (3, 5, 5)


def test_boson_patterns_are_collision_free_and_distinct():
    d = Draws(BOSON, {"n": 6, "batch": 64}, 9, "window")
    mats, pats = d.next()
    assert mats.shape == (64, 6, 6) and np.iscomplexobj(mats)
    assert np.all(np.diff(pats, axis=1) > 0)          # sorted, no repeat
    assert len(np.unique(pats, axis=0)) == 64
    U = d.ctx["unitary"]
    np.testing.assert_allclose(U @ U.conj().T, np.eye(36), atol=1e-12)
    b, j = 5, 2
    np.testing.assert_array_equal(mats[b][:, j], U[:6, pats[b, j]])


def test_one_unitary_a_seed_for_every_stream():
    w = Draws(BOSON, {"n": 6, "batch": 2}, 4, "window")
    c = Draws(BOSON, {"n": 6, "batch": 2}, 4, "check")
    np.testing.assert_array_equal(w.ctx["unitary"], c.ctx["unitary"])


def test_photons_must_match_the_configuration():
    with pytest.raises(ValueError):
        Draws(BOSON, {"n": 5, "batch": 2}, 1, "window")


@pytest.mark.parametrize("family", ["uniform", "haar_submatrices"])
def test_a_family_is_found_by_its_file(family):
    mod = byname.module(REAL, "families", family)
    assert all(callable(getattr(mod, f)) for f in
               ("setup", "draw", "matrices", "flops"))


def test_a_missing_family_is_named():
    with pytest.raises(KeyError, match="no_such"):
        Draws(dict(DENSE, family="no_such"), {"n": 4}, 1, "window")
