"""A run with the timed path broken underneath comes out not correct:
each fault a cell can have, planted in the program on its CPU path."""

import json
import subprocess
import sys
import time

import pytest

from bench import harness
from bench.tests import faults
from bench.tests.fixture_root import REAL, make_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("checkout"))


@pytest.mark.parametrize("name,fault", [
    ("tiny_campaign", "state_unchanged"),
    ("tiny_campaign", "campaign_value_altered"),
    ("tiny_amplitudes", "half_batch_left_out"),
    ("tiny_amplitudes", "batch_value_altered"),
    ("tiny_scalar", "scalar_value_altered"),
])
def test_a_planted_fault_is_not_correct(root, monkeypatch, name, fault):
    faults.plant(fault, monkeypatch.setattr)
    cell = harness.load_cell(root, name)
    line, _ = harness.run(cell, 424242, 0.3, False, "cpu", time.time(),
                          "cpu")
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


@pytest.mark.parametrize("fault", ["exchange_left_out", "state_unchanged",
                                   "campaign_value_altered"])
def test_a_planted_fault_over_a_mesh_is_not_correct(tmp_path, fault):
    root = make_root(tmp_path / "checkout")
    out = subprocess.run(
        [sys.executable, "-m", "bench.tests.faults", str(root),
         "tiny_campaign_mesh2", fault],
        cwd=REAL, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is False
