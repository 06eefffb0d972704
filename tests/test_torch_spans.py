"""Program spans (``repro_torch/utils/spans.py``) and ``Wave.gather_s``.

With no profiler recording, no ``record_function`` is built on the paths
the benchmark's cells run (a dense plan and execute, a complex bucket, a
campaign with a checkpoint), and the values are the ones of a run
without the check.  Under ``torch.profiler`` the same paths record the
documented spans, each under the span ``PERF.md`` nests it in, a plan's
as many for 8 matrices as for 64.  A world of two gloo ranks records the
mesh's gather and broadcast and each wave's ``gather_s``; one device
reads 0.0, and the campaign CLI prints it as ``gather_ms=``.  A sparse leaf
and a sparse bucket add the CCS build and the leaf ordering to the
dispatch's spans, and without a profiler keep the bits of the steps
they took before they had spans."""

import collections
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import PermanentSolver, SolverConfig  # noqa: E402
from repro_torch.core import distributed as D  # noqa: E402
from repro_torch.core import sparyser as S  # noqa: E402
from repro_torch.core.stepspace import DEFAULT_GEOMETRY  # noqa: E402
from repro_torch.examples.sparse_matchings import circulant_band  # noqa: E402
from repro_torch.kernels import ops as K  # noqa: E402
from repro_torch.kernels.ryser_sparse_cuda import (  # noqa: E402
    ryser_sparse_cuda_call, ryser_sparse_cuda_call_batched)
from repro_torch.core.stepspace import plan_slices  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.utils.spans import span  # noqa: E402

N_CAMP, SLICES, LANES, WIDTH = 10, 8, 4, 2
PLAN = {("repro.plan", None): 1,
        ("repro.plan.leaves", "repro.plan"): 1,
        ("repro.plan.geometry", "repro.plan"): 1,
        ("repro.plan.buckets", "repro.plan"): 1}
DISPATCH = {("repro.dispatch", None): 1,
            ("repro.dispatch.probe", "repro.dispatch"): 1,
            ("repro.dispatch.stage", "repro.dispatch"): 1,
            ("repro.dispatch.launch", "repro.dispatch"): 1,
            ("repro.dispatch.reduce", "repro.dispatch"): 1,
            ("repro.dispatch.copy", "repro.dispatch"): 1}
SPARSE = {("repro.dispatch.sparse.ccs", "repro.dispatch"): 1,
          ("repro.dispatch.sparse.order", "repro.dispatch.stage"): 1}


def _matrix(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-1, 1, (n, n))


def _stack(B: int, n: int, seed: int, cplx: bool) -> np.ndarray:
    rng = np.random.default_rng(seed)
    S = rng.uniform(-1, 1, (B, n, n))
    return S + 1j * rng.uniform(-1, 1, S.shape) if cplx else S


def _dense():
    solver = PermanentSolver(SolverConfig(device="cpu"))
    return solver.execute(solver.plan(_matrix(12, 1)))


def _bucket():
    solver = PermanentSolver(SolverConfig(device="cpu"))
    return solver.execute(solver.plan_batch(_stack(64, 6, 2, True)))


def _bands(B: int, n: int = 18, degree: int = 5, seed: int = 4):
    """(B, n, n) circulant bands with U(0, 1) weights, rows and columns
    relabelled: density 5/18, minimum degree 5, one whole sparse leaf
    each."""
    rng = np.random.default_rng(seed)
    band = circulant_band(n, degree)
    return np.stack([(band * rng.uniform(0, 1, (n, n)))
                     [rng.permutation(n)][:, rng.permutation(n)]
                     for _ in range(B)])


def _sparse_leaf():
    solver = PermanentSolver(SolverConfig(device="cpu"))
    return solver.execute(solver.plan(_bands(1)[0]))


def _sparse_bucket():
    solver = PermanentSolver(SolverConfig(device="cpu"))
    return solver.execute(solver.plan_batch(_bands(6)))


def _parent_sparse(As, *, batched: bool):
    """The sparse arm's values by the steps it took before its spans:
    padded CCS, upload, ordering and padding, the kernel entry (its plain
    version here), the real epilogue."""
    rows, vals = S.padded_ccs(As)
    As, rows, vals = (torch.as_tensor(As), torch.as_tensor(rows),
                      torch.as_tensor(vals))
    n = As.shape[-1]
    TB, C, Wu, blocks = DEFAULT_GEOMETRY.kernel_geometry(n)
    geo = dict(n=n, TB=TB, C=C, Wu=Wu, num_blocks=blocks, precision="dq_acc")
    A_pads, rows, vals, xb_pads, xbs = K.prepare_sparse(As, rows, vals, Wu)
    if batched:
        out = ryser_sparse_cuda_call_batched(A_pads, rows, vals, xb_pads,
                                             **geo)
    else:
        out = ryser_sparse_cuda_call(A_pads, rows, vals, xb_pads, 0, **geo)
    return K._reduce_real(out, xbs, n).numpy()


def _campaign(path: str, mesh=None):
    """``run_campaign`` of an n = 10 matrix in waves of ``WIDTH`` slices a
    rank, checkpointed to ``path``: (value, the waves)."""
    ts, cps, C = plan_slices(N_CAMP, SLICES, 1, LANES)
    waves = []
    value, _ = D.run_campaign(
        _matrix(N_CAMP, 3), total_slices=ts, chunks_per_slice=cps,
        chunk_size=C, device="cpu", checkpoint_path=path, mesh=mesh,
        wave_width=WIDTH, progress_cb=lambda state, w: waves.append(w))
    return value, waves


def _profiled(fn):
    """``fn()`` under a CPU profiler: (its result, a Counter of (span,
    the innermost ``repro.`` span it sits in) over every ``repro.`` span
    recorded)."""
    cpu = torch.profiler.ProfilerActivity.CPU
    with torch.profiler.profile(activities=[cpu]) as prof:
        out = fn()
    found = collections.Counter()
    for e in prof.events():
        if not e.name.startswith("repro."):
            continue
        parent = e.cpu_parent
        while parent is not None and not parent.name.startswith("repro."):
            parent = parent.cpu_parent
        found[e.name, parent.name if parent else None] += 1
    return out, found


def _refuse(*args, **kwargs):
    raise AssertionError("record_function built with no profiler on")


def test_off_path_builds_no_record_function(monkeypatch, tmp_path):
    want = (_dense(), _bucket(), _campaign(str(tmp_path / "a.npz"))[0])
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _refuse)
    assert span("repro.plan") is span("repro.dispatch")    # one shared no-op
    got = (_dense(), _bucket(), _campaign(str(tmp_path / "b.npz"))[0])
    assert got[0] == want[0] and got[2] == want[2]
    np.testing.assert_array_equal(got[1], want[1])


def test_sparse_arm_off_builds_no_record_function_and_keeps_its_bits(
        monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _refuse)
    leaf, bucket = _sparse_leaf(), _sparse_bucket()
    assert leaf == _parent_sparse(_bands(1)[0], batched=False)
    np.testing.assert_array_equal(bucket,
                                  _parent_sparse(_bands(6), batched=True))


def test_sparse_leaf_records_its_spans_nested():
    value, found = _profiled(_sparse_leaf)
    assert value == _sparse_leaf()
    assert found == collections.Counter({**PLAN, **DISPATCH, **SPARSE})
    assert sum(found.values()) == 12          # a sparse_bands32 call's


def test_sparse_bucket_records_its_spans_once():
    values, found = _profiled(_sparse_bucket)
    np.testing.assert_array_equal(values, _sparse_bucket())
    assert found == collections.Counter({**PLAN, **DISPATCH, **SPARSE})


def test_dense_call_records_its_spans_nested():
    value, found = _profiled(_dense)
    assert value == _dense()
    assert found == collections.Counter({**PLAN, **DISPATCH})
    assert sum(found.values()) <= 10          # a dense30 call's budget


def test_complex_bucket_records_four_spans_a_bucket():
    values, found = _profiled(_bucket)
    np.testing.assert_array_equal(values, _bucket())
    assert found == collections.Counter({**PLAN, **DISPATCH})


def test_campaign_records_a_span_a_wave_phase(tmp_path):
    (value, waves), found = _profiled(
        lambda: _campaign(str(tmp_path / "job.npz")))
    k = len(waves)
    assert k == SLICES // WIDTH
    assert found == collections.Counter({
        ("repro.campaign", None): 1,
        ("repro.campaign.wave", "repro.campaign"): k,
        ("repro.campaign.record", "repro.campaign"): k,
        ("repro.campaign.save", "repro.campaign"): k})
    assert all(w.gather_s == 0.0 for w in waves)         # one device
    assert value == _campaign(str(tmp_path / "again.npz"))[0]


@pytest.mark.parametrize("cplx", [False, True])
def test_plan_spans_do_not_grow_with_the_batch(cplx):
    solver = PermanentSolver(SolverConfig(device="cpu"))
    counts = []
    for B in (8, 64):
        _, found = _profiled(
            lambda: solver.plan_batch(_stack(B, 6, B, cplx)))
        counts.append(sum(c for (name, _), c in found.items()
                          if name.startswith("repro.plan")))
    assert counts == [4, 4]


def test_campaign_cli_prints_gather_ms_after_save_ms(tmp_path, capsys):
    from repro_torch.launch.campaign import campaign_main
    assert campaign_main(["--n", "10", "--slices", "8", "--lanes", "4",
                          "--device", "cpu", "--checkpoint",
                          str(tmp_path / "job.npz")]) == 0
    waves = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[campaign] wave")]
    assert waves and all(
        re.search(r" save_ms=[0-9.]+ gather_ms=0\.000 done=", ln)
        for ln in waves)


def _world2(rank: int, world: int, work: str) -> dict:
    mesh = M.make_mesh((world,), ("step",), device="cpu")
    (value, waves), found = _profiled(
        lambda: _campaign(os.path.join(work, "job.npz"), mesh))
    return {"value": value, "gather_s": [w.gather_s for w in waves],
            "spans": dict(found)}


def test_world_of_two_records_the_mesh_gather(tmp_path):
    want, _ = _campaign(str(tmp_path / "one.npz"))
    work = str(tmp_path / "w2")
    ranks = M.run_world(_world2, 2, work, args=(work,), timeout_s=120)
    waves = SLICES // (2 * WIDTH)
    for out in ranks:
        assert out["value"] == want
        assert len(out["gather_s"]) == waves
        assert all(s >= 0.0 for s in out["gather_s"])
        spans = out["spans"]
        # the input's digest, then one gather a wave
        assert spans[("repro.mesh.gather", "repro.campaign")] == 1
        assert spans[("repro.mesh.gather", "repro.campaign.wave")] == waves
        assert spans[("repro.mesh.broadcast", "repro.campaign")] == 1
        assert spans[("repro.campaign.wave", "repro.campaign")] == waves
