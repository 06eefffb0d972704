"""The ``sparse_bands32`` cell's files on the program's CPU path: the
``relabelled_band7`` family, the ``sparse_calls`` loop and its control,
through a tiny cell (``fixture/sparse_bands/``, n = 24: the smallest n at
which a degree-7 band routes ``sparse``) held to the real cell's limit."""

import json
import shutil
import time
from pathlib import Path

import numpy as np
import pytest

from bench import byname, check, control, harness, inputs, tracing
from bench.tests.fixture_root import FIXTURE, REAL, make_root

CELL = "tiny_sparse_bands"
REAL_CELL = "sparse_bands32"
ALTER = 1.0 + 1e-6


def _read(path: Path):
    return json.loads(path.read_text())


def add_sparse_bands(root: Path) -> Path:
    """``root`` with the tiny cell standing for ``sparse_bands32``: its
    files, its entries, and the real cell's limits and metrics."""
    src = FIXTURE / "sparse_bands"
    for d in ("configs", "traffic"):
        for f in (src / d).glob("*.json"):
            shutil.copy(f, root / "bench" / d / f.name)
    spec = _read(src / "workloads" / f"{CELL}.json")
    spec["limits"] = _read(REAL / "bench" / "workloads"
                           / f"{REAL_CELL}.json")["limits"]
    (root / "bench" / "workloads" / f"{CELL}.json").write_text(
        json.dumps(spec))
    doc = _read(root / "BENCHMARK.json")
    real = _read(REAL / "BENCHMARK.json")
    doc["configs"].append({"name": "tiny_sparse_bands",
                           "source": "a test fixture",
                           "file": "bench/configs/tiny_sparse_bands.json",
                           "reduced": [], "why": "stands for "
                           "sparse_bands_real"})
    doc["workloads"].append({"name": CELL, "config": "tiny_sparse_bands",
                             "traffic": "tiny_sparse_n24", "chips": 1,
                             "why": f"stands for {REAL_CELL}"})
    for kind in ("end_to_end", "per_layer"):
        cells = {m["name"]: m.get("workloads") for m in real[kind]}
        for m in doc[kind]:
            if REAL_CELL in (cells.get(m["name"]) or []):
                m["workloads"] = m["workloads"] + [CELL]
    (root / "BENCHMARK.json").write_text(json.dumps(doc, indent=1))
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return add_sparse_bands(make_root(tmp_path_factory.mktemp("checkout")))


@pytest.fixture(scope="module")
def cell(root):
    return harness.load_cell(root, CELL)


def _family():
    return byname.module(REAL, "families", "relabelled_band7")


def _real_cell():
    return harness.load_cell(REAL, REAL_CELL)


# --- the family --------------------------------------------------------------

def test_same_seed_same_inputs_and_the_streams_differ():
    cell = _real_cell()
    seed = 2 ** 40 + 17
    a, b = (inputs.Draws(cell, seed, "window") for _ in range(2))
    for _ in range(3):
        (A, ta), (B, tb) = a.next(), b.next()
        np.testing.assert_array_equal(A, B)
        for x, y in zip(ta, tb):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(a.matrices(ta), A)   # token rebuilds
    firsts = [inputs.Draws(cell, s, stream).next()[0]
              for s, stream in ((seed, "window"), (seed, "warmup"),
                                (seed, "check"), (seed + 1, "window"))]
    for i in range(len(firsts)):
        for j in range(i):
            assert not np.array_equal(firsts[i], firsts[j])


def test_every_row_and_column_has_seven_nonzeros():
    cell = _real_cell()
    draws = inputs.Draws(cell, 11, "window")
    assert draws.n == 32 and draws.batch == 1
    band = _family().band(32, 7)
    for _ in range(4):
        A, (rperm, cperm, w) = draws.next()
        nz = A != 0
        assert (nz.sum(axis=0) == 7).all() and (nz.sum(axis=1) == 7).all()
        assert ((A >= 0) & (A < 1)).all()
        # undoing the relabelling gives the band's support back
        M = np.empty_like(A)
        M[np.ix_(rperm[0], cperm[0])] = A
        support = np.zeros((32, 32), dtype=bool)
        support[band, np.arange(32)[:, None]] = True
        np.testing.assert_array_equal(M != 0, support)


def test_build_takes_any_degree():
    fam = _family()
    gen = np.random.default_rng(3)
    mats = fam.build(fam.draw_band(gen, 10, 3, 4, 0.5, 1.0))
    assert mats.shape == (3, 10, 10)
    nz = mats != 0
    assert (nz.sum(axis=1) == 4).all() and (nz.sum(axis=2) == 4).all()
    with pytest.raises(ValueError):
        fam.band(5, 6)


@pytest.mark.parametrize("n", [24, 30, 32, 33])
def test_flops_count_the_sparse_ryser_steps(n):
    assert _family().flops(n) == (n + 7) * 2 ** (n - 1)


def test_setup_refuses_another_degree():
    with pytest.raises(ValueError, match="degree"):
        _family().setup({"degree": 5, "low": 0.0, "high": 1.0}, 32, 1)


# --- the loop ----------------------------------------------------------------

def test_the_loop_is_the_calls_loop_but_for_its_control(cell):
    loop, calls = byname.loop(cell), byname.module(cell.root, "loops",
                                                   "calls")
    for f in ("warm_up", "window", "sample", "references", "judge"):
        assert getattr(loop, f) is getattr(calls, f)
    assert loop.lower_window is not calls.lower_window


@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_window_runs_and_is_correct(root, cell, trace):
    line, _ = harness.run(cell, 2 ** 33 + 5, 0.3, trace, "cpu", time.time(),
                          "cpu")
    assert line["correct"] is True and line["failed"] == 0
    kind = "per_layer" if trace else "end_to_end"
    if not trace:
        assert set(line["metrics"]) == {m["name"]
                                        for m in cell.metrics[kind]}
    assert "idle_in_sparse.calls" in {m["name"]
                                      for m in cell.metrics["per_layer"]}
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]


def test_window_calls_reach_the_sparse_kernel(cell):
    from repro_torch.kernels import ryser_cuda
    solver = harness.make_solver(cell.config, "cpu")
    before = dict(ryser_cuda.counters)
    w = byname.loop(cell).window(cell, solver, 7, None,
                                 tracing.Tracer(False), "cpu", "", items=2)
    assert w.attempted == len(w.values) == 2
    grew = {k for k, v in ryser_cuda.counters.items()
            if v != before.get(k, 0)}
    assert grew == {"block_partials_plain_sparse"}


def _checks(cell, path, seed, items=2):
    w = control.control_window(cell, seed, items, path, "cpu")
    return check.judge(cell, w, seed, "cpu")


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_lower_fails_the_limit_and_the_timed_path_meets_it(cell, seed):
    lower = _checks(cell, "lower", seed)
    assert lower and all(c["value"] > c["limit"] for c in lower)
    program = _checks(cell, "program", seed)
    assert program and all(c["value"] <= c["limit"] for c in program)


def test_lower_runs_the_sparse_single_precision_entry(cell, monkeypatch):
    from repro_torch.kernels import ops

    def refuse(*args, **kwargs):
        raise AssertionError("the dense entry ran")
    monkeypatch.setattr(ops, "permanent_cuda", refuse)
    monkeypatch.setattr(ops, "permanent_cuda_batched", refuse)
    w = control.control_window(cell, 4, 1, "lower", "cpu")
    assert w.values[0].dtype == np.float32


def test_a_planted_altered_answer_is_not_correct(cell, monkeypatch):
    from repro_torch.kernels import ops
    scalar = ops.sparse_value_cuda
    monkeypatch.setattr(ops, "sparse_value_cuda",
                        lambda *a, **kw: scalar(*a, **kw) * ALTER)
    line, _ = harness.run(cell, 424242, 0.3, False, "cpu", time.time(),
                          "cpu")
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


def test_the_real_cells_sample_fits_its_check():
    spec = _real_cell().spec
    assert 6 <= spec["sample"]["answers"] <= 12
    assert set(spec["limits"]) == {"value_gap"}
