"""The port's public entry points vs the reference's, on the CPU.

``repro_torch.permanent``/``permanent_batch`` with ``device="cpu"``:
``backend="cuda"`` (the kernel's plain version) vs the reference's
``pallas`` (interpret mode) at rtol 1e-9, ``backend="torch"`` vs ``jnp``
at rtol 1e-12, and identical dispatch tags up to the backend names.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.engine as REF  # noqa: E402
from repro.core.planner import SolverConfig as RefConfig  # noqa: E402
from repro.core.stepspace import Geometry as RefGeometry  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core.solver import PermanentSolver  # noqa: E402
from repro_torch.launch.permanent import permanent_main  # noqa: E402

PAIRS = {"cuda": ("pallas", 1e-9), "torch": ("jnp", 1e-12)}


def _tags(reports, names=None):
    out = [list(r.dispatch) for r in reports]
    if names:
        for old, new in names.items():
            out = [[t.replace(old, new) for t in ts] for ts in out]
    return out


def _dm_fm_matrices():
    """Matrices DM and FM reduce to dense leaves (density >= 0.30)."""
    rng = np.random.default_rng(31)
    # DM: three dense 5x5 diagonal blocks plus entries above them that lie
    # in no perfect matching (density 0.37 < 0.5 switches DM on)
    dm = np.zeros((15, 15))
    for b in range(3):
        dm[5 * b:5 * b + 5, 5 * b:5 * b + 5] = rng.uniform(0.5, 1.5, (5, 5))
    for i, j in [(0, 7), (1, 12), (3, 9), (6, 13), (2, 14), (8, 11)]:
        dm[i, j] = rng.uniform(0.5, 1.5)
    # FM: a row with 2 nonzeros (D2) and one with 3 (D34)
    fm = rng.uniform(-1, 1, (9, 9))
    fm[0, 2:] = 0.0
    fm[4, [0, 1, 2, 3, 5, 6]] = 0.0
    return [dm, fm]


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_permanent_scalar_matches_reference(backend):
    ref_backend, rtol = PAIRS[backend]
    rng = np.random.default_rng(30)
    for A in [rng.uniform(-1, 1, (n, n)) for n in (3, 5, 8, 11)] \
            + _dm_fm_matrices():
        got, rep = repro_torch.permanent(A, backend=backend, device="cpu",
                                         return_report=True)
        want, wrep = REF.permanent(A, backend=ref_backend,
                                   return_report=True)
        np.testing.assert_allclose(got, want, rtol=rtol)
        assert _tags([rep]) == _tags([wrep])
        assert (rep.dm_removed, rep.fm_leaves, rep.leaf_sizes) == \
            (wrep.dm_removed, wrep.fm_leaves, wrep.leaf_sizes)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_permanent_batch_ragged_matches_reference(backend):
    """Mixed sizes: multi-leaf buckets, a ragged straggler, inline n <= 2
    (FM folds the 3x3 ones too), and the DM/FM-reducible matrices."""
    ref_backend, rtol = PAIRS[backend]
    rng = np.random.default_rng(32)
    mats = [rng.uniform(-1, 1, (n, n)) for n in (6, 7, 6, 3, 6, 3, 2, 1, 8)]
    mats += _dm_fm_matrices()
    got, reps = repro_torch.permanent_batch(mats, backend=backend,
                                            device="cpu", return_report=True)
    want, wreps = REF.permanent_batch(mats, backend=ref_backend,
                                      return_report=True)
    np.testing.assert_allclose(got, np.real(want), rtol=rtol)
    assert _tags(reps) == _tags(wreps, {"pallas": "cuda", "jnp": "torch"})
    # an n=3 bucket (FM off) sits below the kernel floor: under cuda it
    # runs on the torch engine behind a cuda->torch downgrade tag
    small = [rng.uniform(-1, 1, (3, 3)) for _ in range(2)]
    got, reps = repro_torch.permanent_batch(small, backend=backend,
                                            preprocess=False, device="cpu",
                                            return_report=True)
    want, wreps = REF.permanent_batch(small, backend=ref_backend,
                                      preprocess=False, return_report=True)
    np.testing.assert_allclose(got, np.real(want), rtol=rtol)
    assert _tags(reps) == _tags(wreps, {"pallas": "cuda", "jnp": "torch"})
    assert any("cuda->torch" in t for ts in _tags(reps) for t in ts) == \
        (backend == "cuda")


def test_scalar_leaf_equals_bucket_member_in_torch_engine():
    rng = np.random.default_rng(33)
    mats = rng.uniform(-1, 1, (3, 9, 9))
    bucket = repro_torch.permanent_batch(mats, backend="torch", device="cpu")
    for M, v in zip(mats, bucket):
        assert repro_torch.permanent(M, backend="torch", device="cpu") == v


def test_solver_queue_and_cache_on_cpu():
    rng = np.random.default_rng(34)
    mats = [rng.uniform(-1, 1, (6, 6)) for _ in range(3)]
    solver = PermanentSolver(device="cpu", queue_max_batch=3,
                             clock=lambda: 0.0)
    reqs = [solver.submit(M) for M in mats]
    assert solver.pending == 0 and all(r.done for r in reqs)
    again = solver.execute(solver.plan_batch(mats))
    np.testing.assert_array_equal(again, [r.result() for r in reqs])
    st = solver.stats()
    assert st["cache"]["hits"] == 3 and st["flushes"] == 1
    plan = solver.plan(mats[0])
    assert plan.to_json()["config"]["device"] == "cpu"
    assert plan != solver.plan(mats[1])


def test_cli_runs_on_cpu(capsys):
    assert permanent_main(["--n", "9", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "plan[scalar]" in out and "perm(A) = " in out
    assert permanent_main(["--n", "10", "--family", "allones", "--value",
                           "0.5", "--device", "cpu", "--backend", "torch",
                           "--plan-json", "--precision", "kahan"]) == 0
    out = capsys.readouterr().out
    rel = float(out.split("rel.err = ")[1].split()[0])
    assert rel < 1e-12
    assert '"backend": "torch"' in out


def test_interop_round_trips_reference_config():
    ref = RefConfig(precision="kahan", backend="pallas", num_chunks=256,
                    geometry=RefGeometry(8, 8, 4), campaign_slices=32)
    cfg = interop.config_from_reference(dataclasses.asdict(ref))
    assert (cfg.backend, cfg.precision, cfg.num_chunks,
            cfg.campaign_slices) == ("cuda", "kahan", 256, 32)
    assert cfg.geometry.tag() == ref.geometry.tag() == "8x8x4"
    assert interop.geometry_from_tag("8x8x4b2").max_blocks == 2
    d = dataclasses.asdict(RefConfig())
    assert interop.config_from_reference(d).backend == "torch"
    with pytest.raises(ValueError):
        interop.config_from_reference(
            dataclasses.asdict(RefConfig(backend="distributed")))
    A = np.random.default_rng(35).uniform(-1, 1, (7, 7))
    same = PermanentSolver(cfg.replace(device="cpu")).execute(
        PermanentSolver(cfg.replace(device="cpu")).plan(A))
    np.testing.assert_allclose(
        same, REF.permanent(A, backend="pallas", precision="kahan"),
        rtol=1e-9)


@pytest.mark.parametrize("knob", [{"campaign_checkpoint": "job.npz"},
                                  {"campaign_max_waves": 2}])
def test_interop_rejects_unported_campaign_knobs(knob, tmp_path):
    """The campaign knobs cross as they are; what the port rejects is a
    checkpoint the reference wrote: its partial sums name the reference's
    wave body (``pallas``), so resuming it is a config mismatch."""
    from repro.core.resume import JobState as RefJobState
    if "campaign_checkpoint" in knob:
        knob = {"campaign_checkpoint": str(tmp_path / "job.npz")}
    cfg = interop.config_from_reference(dataclasses.asdict(RefConfig(
        backend="pallas", **knob)))
    for name, value in knob.items():
        assert getattr(cfg, name) == value
    ckpt = knob.get("campaign_checkpoint", str(tmp_path / "ref.npz"))
    A = np.random.default_rng(36).uniform(-1, 1, (9, 9))
    solver = PermanentSolver(cfg.replace(
        device="cpu", preprocess=False, campaign_threshold=-1.0,
        campaign_checkpoint=ckpt))
    plan = solver.plan(A)
    spec = plan.leaves[0].campaign
    assert (spec.backend, spec.geometry) == ("cuda", None)
    RefJobState.create(A, spec.total_slices, precision=spec.precision,
                       backend="pallas",
                       chunks_per_slice=spec.chunks_per_slice,
                       chunk_size=spec.chunk_size).save(ckpt)
    with pytest.raises(ValueError, match="config mismatch.*backend"):
        solver.execute(plan)
