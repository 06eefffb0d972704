"""The port stands alone and never falls back: it imports neither jax nor
the reference package, a card that is asked for and missing raises, the
sparse route runs (real and complex), a tuning table resolves, and the
route not ported yet (a campaign mesh in the service) raises
``NotImplementedError``."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch.core import oracle  # noqa: E402
from repro_torch.core.solver import PermanentSolver  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ryser_cuda as RC  # noqa: E402

REPO = os.path.join(os.path.dirname(__file__), "..")

_PROBE = """
import sys
import repro_torch, repro_torch.core.engine, repro_torch.kernels.ops
import repro_torch.kernels.build, repro_torch.launch.permanent
import repro_torch.interop, repro_torch.core.sparyser
import repro_torch.kernels.ryser_sparse_cuda
import repro_torch.core.distributed, repro_torch.core.resume
import repro_torch.launch.campaign, repro_torch.launch.mesh
import repro_torch.serve, repro_torch.serve.compile_cache
import repro_torch.launch.serve
import repro_torch.tune, repro_torch.tune.search, repro_torch.launch.tune
import repro_torch.utils.roofline, repro_torch.analysis.geometry
import repro_torch.analysis.lint, repro_torch.analysis.rules
import repro_torch.analysis.contracts, repro_torch.analysis.prove
import repro_torch.analysis.check
import repro_torch.examples.quickstart, repro_torch.examples.boson_sampling
import repro_torch.examples.sparse_matchings
import repro_torch.examples.large_permanent, repro_torch.examples.service
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print("BAD", bad)
import torch.distributed as dist
print("GROUP", dist.is_available() and dist.is_initialized())
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"), REPO]))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    # importing the mesh functions creates no process group
    assert "GROUP False" in out.stdout, out.stdout


def test_missing_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    A = np.random.default_rng(0).uniform(-1, 1, (6, 6))
    RC.reset_counters()
    for call in (lambda: repro_torch.permanent(A),
                 lambda: repro_torch.permanent_batch([A, A]),
                 lambda: repro_torch.permanent(A, device="cuda",
                                               backend="torch"),
                 lambda: PermanentSolver().execute(PermanentSolver().plan(A))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert RC.counters["block_partials_plain"] == 0


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build, "TOOLKIT_NVCC", str(tmp_path / "no-nvcc"))
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "build_dir", lambda: tmp_path / "kernels")
    RC.reset_counters()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load_library()
    assert RC.counters["block_partials_plain"] == 0
    assert not (tmp_path / "kernels").exists()


def test_sparse_input_runs_and_matches_oracle():
    rng = np.random.default_rng(1)
    sparse = rng.uniform(0.5, 1.5, (8, 8)) * (rng.uniform(0, 1, (8, 8)) < 0.2)
    np.fill_diagonal(sparse, 1.0)
    for A in (sparse, sparse * (1 + 1j)):
        want = oracle.perm_ryser_exact(A)
        got, rep = repro_torch.permanent(A, preprocess=False, device="cpu",
                                         return_report=True)
        assert rep.dispatch[-1] == "sparse(n=8,cuda)"
        assert abs(got - want) <= 1e-9 * abs(want)
    vals, reps = repro_torch.permanent_batch([sparse * 1j] * 2 + [sparse.T],
                                             preprocess=False, device="cpu",
                                             return_report=True)
    assert reps[0].dispatch == ["sparse_batch(n=8,b=3)"]
    want = oracle.perm_ryser_exact(sparse)
    np.testing.assert_allclose(vals, [want * 1j ** 8] * 2 + [want],
                               rtol=1e-9)


def test_unported_routes_raise(tmp_path):
    """Tuning is ported: a table resolves into the plan.  The one route
    left to port, a campaign mesh in the service (item 8), raises."""
    from repro_torch.core.stepspace import Geometry
    from repro_torch.serve import CampaignSpec
    from repro_torch.tune.table import TableEntry, TuningTable
    table = TuningTable()
    table.put(TableEntry(route="dense", n=4, density_bucket="1.00",
                         dtype="<f8", precision="dq_acc", device_kind="cpu",
                         geometry=Geometry(4, 2, 2), predicted_s=1.0,
                         measured_s=1.0, default_s=1.0))
    path = str(tmp_path / "t.json")
    table.save(path)
    plan = PermanentSolver(device="cpu", tuning_table=path,
                           preprocess=False).plan(np.eye(4) + 1)
    assert plan.leaves[0].geometry == Geometry(4, 2, 2)
    with pytest.raises(NotImplementedError, match="item 8"):
        CampaignSpec(matrix=np.eye(4), mesh=object())
