"""The port's step-space campaign on the CPU, held against the reference.

``repro_torch.core.distributed.run_campaign`` and the ``step_sharded``
route through the solver, with ``device="cpu"``: the ``cuda`` wave body is
the scalar kernel entry's plain version (``block_partials_plain``, real
``batched`` mode, or the split-plane one), the ``torch`` body the chunked
torch engine.  Against the reference's ``run_campaign`` on a one-device
mesh -- ``pallas`` (interpret mode) for ``cuda``, ``jnp`` for ``torch`` --
each slice's hi + lo and the final value agree within rtol 1e-12 (the
worst ulp gap is reported); against ``core/oracle.py`` within 1e-9.
The ports of ``tests/test_campaign.py`` (planning, execution, pause and
resume, checkpoint safety, the CLI killed with SIGKILL and resumed) and
of the campaign cases of ``tests/test_distributed.py`` run here at small
n, as do the plain versions from chunk bases at the end of the 2^63 step
space and the edge cases of ``tests/test_u64emu.py`` on the port's host
helpers.
"""

import os
import shutil
import signal
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import distributed as RD  # noqa: E402
from repro.kernels import ops as ROPS  # noqa: E402
from repro.kernels import ryser_complex as RPX  # noqa: E402
from repro.kernels import ryser_pallas as RP  # noqa: E402
from repro_torch.core import distributed as D  # noqa: E402
from repro_torch.core import gray as TG  # noqa: E402
from repro_torch.core import oracle, resume  # noqa: E402
from repro_torch.core.executor import execute_plan  # noqa: E402
from repro_torch.core.planner import (ROUTE_CAMPAIGN, SolverConfig,  # noqa: E402
                                      build_plan)
from repro_torch.core.solver import PermanentSolver  # noqa: E402
from repro_torch.core.stepspace import (Geometry, chunk_geometry,  # noqa: E402
                                        plan_slices)
from repro_torch.kernels import ryser_complex_cuda as RX  # noqa: E402
from repro_torch.kernels import ryser_cuda as RC  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
PAIRS = {"cuda": "pallas", "torch": "jnp"}


def _cfg(**kw):
    base = dict(device="cpu", preprocess=False, campaign_threshold=1.0,
                campaign_slices=8, campaign_lanes=8)
    base.update(kw)
    return SolverConfig(**base)


def _matrix(n: int, seed: int, cplx: bool = False) -> np.ndarray:
    rng = np.random.default_rng(seed)
    A = rng.uniform(0.2, 1.2, (n, n))
    if cplx:
        A = A + 1j * rng.uniform(0.2, 1.2, (n, n))
    return A


def _ulps(got, want) -> float:
    """Worst gap in ulps of the larger magnitude, per real component."""
    g = np.atleast_1d(np.asarray(got))
    w = np.atleast_1d(np.asarray(want))
    if np.iscomplexobj(g) or np.iscomplexobj(w):
        return max(_ulps(g.real, w.real), _ulps(g.imag, w.imag))
    scale = np.spacing(np.maximum(np.abs(g), np.abs(w)))
    return float(np.max(np.abs(g - w) / np.where(scale > 0, scale, 1.0)))


# ---------------------------------------------------------------------------
# planning
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_plan_routes_large_leaf_to_campaign(backend):
    A = _matrix(10, 0)
    plan = build_plan([A], _cfg(backend=backend), batched=False)
    (leaf,) = plan.leaves
    assert leaf.route == ROUTE_CAMPAIGN
    spec = leaf.campaign
    assert spec.total_slices * spec.chunks_per_slice * spec.chunk_size \
        == 1 << 9
    assert spec.backend == backend and spec.precision == plan.precision
    j = plan.to_json()
    assert j["leaves"][0]["campaign"]["total_slices"] == spec.total_slices
    assert "step_sharded" in plan.summary()


def test_default_threshold_campaigns_from_n31():
    """At the default config a dense n = 31 leaf (31 x 2^30 > 2^34 steps)
    campaigns under the default spec, plan_slices(n, 1024, 1, 1024); n = 30
    does not."""
    cfg = SolverConfig(device="cpu")
    for n, route in ((30, "dense"), (31, ROUTE_CAMPAIGN)):
        plan = build_plan([np.ones((n, n))], cfg, batched=False)
        assert plan.leaves[0].route == route
    spec = build_plan([np.ones((40, 40))], cfg, batched=False) \
        .leaves[0].campaign
    assert (spec.total_slices, spec.chunks_per_slice, spec.chunk_size,
            spec.backend) == (1024, 1024, 1 << 19, "cuda")
    assert (spec.total_slices, spec.chunks_per_slice, spec.chunk_size) == \
        plan_slices(40, 1024, 1, 1024)


def test_plan_threshold_none_disables_campaign():
    plan = build_plan([_matrix(10, 0)], _cfg(campaign_threshold=None),
                      batched=False)
    assert plan.leaves[0].route == "dense"
    assert plan.leaves[0].campaign is None


def test_plan_fingerprint_sees_campaign_spec():
    A = _matrix(10, 0)
    p1 = build_plan([A], _cfg(), batched=False)
    p2 = build_plan([A], _cfg(campaign_checkpoint="x.npz",
                              campaign_max_waves=3), batched=False)
    p3 = build_plan([A], _cfg(campaign_lanes=16), batched=False)
    assert p1 == p2          # checkpoint and budget are policy, not numerics
    assert p1 != p3          # different slice geometry -> different plan


def test_stepspace_decomposition_invariants():
    for n in (8, 12, 20, 33):
        for slices in (1, 8, 64):
            ts, cps, C = plan_slices(n, slices, 1, 32)
            assert ts * cps * C == 1 << (n - 1)
            assert C >= 2 and (C & (C - 1)) == 0
        T, C, k = chunk_geometry(n, 64)
        assert T * C == 1 << (n - 1) and C == 1 << k
    for n in (8, 12, 20, 33, 56):
        for d in (1, 8, 256, 512):
            ts, cps, C = plan_slices(n, d)
            assert ts * cps * C == 1 << (n - 1)
            assert C >= 2 and (C & (C - 1)) == 0


# ---------------------------------------------------------------------------
# execution against the oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_campaign_matches_oracle(backend, cplx):
    A = _matrix(10 if not cplx else 8, 1 + cplx, cplx)
    ref = oracle.perm_ryser_exact(A)
    solver = PermanentSolver(_cfg(backend=backend))
    plan = solver.plan(A)
    assert plan.leaves[0].route == ROUTE_CAMPAIGN
    got, rep = solver.execute(plan, return_report=True)
    assert rep.dispatch == [f"campaign(n={A.shape[0]},{backend})"]
    assert isinstance(got, complex) == cplx
    np.testing.assert_allclose(got, ref, rtol=1e-9)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("n", [17, 21])
def test_identity_plus_derangement_is_exact(backend, n):
    """I + P (P a derangement) has permanent 2^(cycles of P) and every
    Ryser term a small integer, so a campaign returns it exactly; the
    column order is not symmetric, so a Gray step that took a wrong
    column would show."""
    rng = np.random.default_rng(n)
    while True:
        p = rng.permutation(n)
        if np.all(p != np.arange(n)):
            break
    A = np.eye(n)
    A[np.arange(n), p] += 1.0
    seen, cycles = np.zeros(n, dtype=bool), 0
    for i in range(n):
        if not seen[i]:
            cycles += 1
            while not seen[i]:
                seen[i], i = True, p[i]
    solver = PermanentSolver(_cfg(backend=backend, campaign_slices=16,
                                  campaign_lanes=16, cache=False))
    got, rep = solver.execute(solver.plan(A), return_report=True)
    assert rep.dispatch == [f"campaign(n={n},{backend})"]
    assert got == 2.0 ** cycles


def test_campaign_in_batch_plan_and_cache():
    """permanent_batch-style plans campaign each leaf, keyed in the cache
    under the full wave-body identity, duplicates resolved from it."""
    A, B = _matrix(9, 3), _matrix(9, 4)
    solver = PermanentSolver(_cfg(campaign_slices=4))
    vals, reps = solver.execute(solver.plan_batch([A, B, A]),
                                return_report=True)
    np.testing.assert_allclose(
        vals, [oracle.perm_ryser_exact(M) for M in (A, B, A)], rtol=1e-9)
    assert reps[0].dispatch == ["campaign(n=9,cuda)"]
    assert reps[2].dispatch == ["cache(step_sharded,n=9)"]
    spec = solver.plan(A).leaves[0].campaign
    name = (f"campaign[cuda,{spec.total_slices}x{spec.chunks_per_slice}x"
            f"{spec.chunk_size},-]")
    assert sum(name in k for k in solver.cache._data) == 2
    again = solver.execute(solver.plan(A))
    assert again == vals[0]
    assert solver.stats()["cache"]["hits"] >= 2


def test_pause_resume_through_solver(tmp_path):
    A = _matrix(10, 3)
    ckpt = str(tmp_path / "job.npz")
    cfg = _cfg(campaign_checkpoint=ckpt, campaign_slices=64,
               campaign_lanes=2)
    seen = []
    budgeted = PermanentSolver(cfg.replace(campaign_max_waves=2))
    budgeted.campaign_progress = lambda st, wave: seen.append(
        (st.fraction_done(), wave.ids, wave.width))
    with pytest.raises(D.CampaignPaused) as exc:
        budgeted.execute(budgeted.plan(A))
    assert [s[1] for s in seen] == [[0], [1]] and seen[0][2] == 1
    st = resume.JobState.load(ckpt)
    assert 0 < st.fraction_done() < 1
    assert exc.value.state.pending_slices() == st.pending_slices()
    shutil.copy(ckpt, tmp_path / "other_w.npz")
    resumed = PermanentSolver(cfg)
    got = resumed.execute(resumed.plan(A))
    clean = PermanentSolver(_cfg(campaign_slices=64, campaign_lanes=2))
    assert np.float64(got) == np.float64(clean.execute(clean.plan(A)))
    # the same checkpoint resumed at another wave width: the same bits
    spec = resumed.plan(A).leaves[0].campaign
    other, _ = D.run_campaign(
        A, total_slices=spec.total_slices,
        chunks_per_slice=spec.chunks_per_slice, chunk_size=spec.chunk_size,
        precision=spec.precision, device="cpu",
        checkpoint_path=str(tmp_path / "other_w.npz"), wave_width=5)
    assert np.float64(other) == np.float64(got)


def test_campaign_paused_propagates_through_execute_plan(tmp_path):
    A = _matrix(9, 5)
    plan = build_plan([A], _cfg(campaign_max_waves=0), batched=False)
    with pytest.raises(D.CampaignPaused, match="0.0%"):
        execute_plan(plan)


def test_several_campaign_leaves_get_their_own_checkpoints(tmp_path):
    base = str(tmp_path / "job.npz")
    A, B = _matrix(8, 6), _matrix(8, 7)
    solver = PermanentSolver(_cfg(campaign_checkpoint=base))
    plan = solver.plan_batch([A, B])
    vals = solver.execute(plan)
    np.testing.assert_allclose(
        vals, [oracle.perm_ryser_exact(M) for M in (A, B)], rtol=1e-9)
    assert not os.path.exists(base)
    for leaf in plan.leaves:
        assert resume.JobState.load(
            f"{base}.{leaf.key[:12]}.npz").fraction_done() == 1.0


def test_waves_record_only_their_own_slices():
    """The port's waves carry no sentinel ids: a short wave is fewer ids,
    a wave of non-contiguous ids launches once per run and returns each
    slice's sum in the order asked, equal to the slice alone; a negative
    id is refused, never computed as slice 0."""
    A = _matrix(10, 4)
    ts, cps, C = plan_slices(10, 8, 1, 8)
    assert ts == 8
    body = dict(chunks_per_slice=cps, chunk_size=C, device="cpu")
    alone = [D.slice_sums(A, [i], **body)[:2] for i in range(ts)]
    ids = [6, 0, 1, 3]
    his, los, launches = D.slice_sums(A, ids, **body)
    assert launches == 3                 # runs 0-1, 3 and 6
    for k, i in enumerate(ids):
        assert his[k] == alone[i][0][0] and los[k] == alone[i][1][0]
    assert alone[0][0][0] != 0.0
    with pytest.raises(ValueError, match="step space"):
        D.slice_sums(A, [-1], **body)
    value, st = D.run_campaign(A, total_slices=ts, chunks_per_slice=cps,
                               chunk_size=C, device="cpu", wave_width=3)
    assert st.done.all()
    np.testing.assert_allclose(value, oracle.perm_ryser_exact(A), rtol=1e-9)


def test_wave_runs_and_ids_text():
    w = D.Wave(ids=[3, 5, 6, 7, 9], width=5, launches=3, kernel_s=None,
               host_s=0.0, save_s=0.0)
    assert w.ids_text() == "3,5-7,9"
    assert D._runs([0, 1, 2]) == [(0, 2)]
    assert D.default_wave_width(_matrix(9, 0), pending=8, chunks_per_slice=8,
                                chunk_size=8, device="cpu") == 1


@pytest.mark.parametrize("pending,resident,want", [
    (1024, 4, 64),     # fill 66: 16 waves of 64, not 15 of 66 + one of 34
    (256, 4, 64),      # 4 waves of 64
    (64, 4, 64),       # one wave, capped at the pending count
    (5, 4, 5),
    (1024, 2, 32),     # fill 33: 32 waves of 32
    (100, 2, 25),      # fill 33: 4 waves of 25, not 3 of 33 + one of 1
    (1, 1, 1),
])
def test_default_wave_width_fills_the_card_in_even_waves(
        monkeypatch, pending, resident, want):
    """On the card W is the fewest slices that fill every SM (132 SMs x
    resident CTAs / 8 CTAs a slice), evened out over the waves the pending
    slices need; the card is stood in for by its two readings."""
    from repro_torch.kernels import ops as K

    class Props:
        multi_processor_count = 132

    monkeypatch.setattr(D, "resolve_device",
                        lambda device: torch.device("cuda"))
    monkeypatch.setattr(K, "wave_ctas_per_sm", lambda *a, **k: resident)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: Props())
    W = D.default_wave_width(_matrix(40, 0), pending=pending,
                             chunks_per_slice=1024, chunk_size=1 << 19)
    assert W == want
    assert -(-pending // W) == -(-pending // max(1, -(-132 * resident // 8)))
    assert D.default_wave_width(_matrix(40, 0), pending=pending,
                                chunks_per_slice=1024, chunk_size=1 << 19,
                                backend="torch") == 1


def test_short_default_waves_widen(monkeypatch):
    """A default W above 1 (the card's) whose wave ends within MIN_WAVE_S
    widens the next wave; the JobState stays the W = 1 one bit for bit."""
    A = _matrix(10, 12)
    ts, cps, C = plan_slices(10, 64, 1, 2)
    body = dict(total_slices=ts, chunks_per_slice=cps, chunk_size=C,
                device="cpu")
    _, want = D.run_campaign(A, wave_width=1, **body)
    monkeypatch.setattr(D, "default_wave_width", lambda *a, **k: 2)
    monkeypatch.setattr(D, "MIN_WAVE_S", 60.0)
    widths = []
    _, got = D.run_campaign(A, progress_cb=lambda st, w: widths.append(
        len(w.ids)), **body)
    assert widths[0] == 2 and widths[1] > 2 and sum(widths) == ts
    assert np.array_equal(got.hi, want.hi) and np.array_equal(got.lo, want.lo)


def test_widened_waves_are_whole_multiples_of_the_first(monkeypatch):
    """A widened wave is a whole number of the first (card-filling) width,
    so it runs whole rounds of CTAs; the JobState stays the W = 1 one."""
    A = _matrix(10, 13)
    ts, cps, C = plan_slices(10, 64, 1, 2)
    body = dict(total_slices=ts, chunks_per_slice=cps, chunk_size=C,
                device="cpu")
    _, want = D.run_campaign(A, wave_width=1, **body)
    monkeypatch.setattr(D, "default_wave_width", lambda *a, **k: 3)
    monkeypatch.setattr(D, "MIN_WAVE_S", 60.0)
    waves = []
    _, got = D.run_campaign(A, progress_cb=lambda st, w: waves.append(w),
                            **body)
    assert waves[0].width == 3 and waves[1].width > 3
    assert all(w.width % 3 == 0 for w in waves)
    assert sum(len(w.ids) for w in waves) == ts
    assert np.array_equal(got.hi, want.hi) and np.array_equal(got.lo, want.lo)


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_wave_width_never_changes_the_job_state(backend, cplx):
    """W = 1, W = 3 and W = all slices give the same JobState bit for
    bit, and the same value."""
    A = _matrix(12, 8, cplx)
    ts, cps, C = plan_slices(12, 32, 1, 8)
    runs = [D.run_campaign(A, total_slices=ts, chunks_per_slice=cps,
                           chunk_size=C, backend=backend, device="cpu",
                           wave_width=w) for w in (1, 3, ts)]
    (v0, s0), rest = runs[0], runs[1:]
    for v, s in rest:
        assert v == v0
        assert np.array_equal(s.hi, s0.hi) and np.array_equal(s.lo, s0.lo)


# ---------------------------------------------------------------------------
# against the reference's run_campaign (one-device mesh)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision", ["dq_acc", "kahan", "dd", "qq"])
@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_slices_and_value_match_reference_run_campaign(backend, cplx,
                                                        precision):
    n = 12 if cplx else 14
    A = _matrix(n, 21 + n, cplx)
    ts, cps, C = plan_slices(n, 32, 1, 8)
    mesh = jax.make_mesh((1,), ("step",))
    want_v, want = RD.run_campaign(A, mesh, total_slices=ts,
                                   chunks_per_slice=cps, chunk_size=C,
                                   precision=precision,
                                   backend=PAIRS[backend])
    got_v, got = D.run_campaign(A, total_slices=ts, chunks_per_slice=cps,
                                chunk_size=C, precision=precision,
                                backend=backend, device="cpu",
                                wave_width=ts // 4)
    g, w = got.hi + got.lo, want.hi + want.lo
    ulps = _ulps(g, w)
    print(f"{backend} vs {PAIRS[backend]} n={n} {precision}: worst slice "
          f"gap {ulps:g} ulp, value gap {_ulps(got_v, want_v):g} ulp")
    np.testing.assert_allclose(g, w, rtol=1e-12, atol=0)
    np.testing.assert_allclose(got_v, want_v, rtol=1e-12)
    assert got.backend == backend and want.backend == PAIRS[backend]


# ---------------------------------------------------------------------------
# checkpoint config safety
# ---------------------------------------------------------------------------

def _one_wave(A, ckpt, **kw):
    ts, cps, C = plan_slices(A.shape[0], 8, 1, 8)
    args = dict(total_slices=ts, chunks_per_slice=cps, chunk_size=C,
                max_waves=1, device="cpu")
    args.update(kw)
    return D.run_campaign(A, checkpoint_path=ckpt, **args)


def test_checkpoint_rejects_config_mismatch(tmp_path):
    A = _matrix(10, 5)
    ckpt = str(tmp_path / "job.npz")
    val, st = _one_wave(A, ckpt)
    assert val is None and st.fraction_done() > 0
    assert (st.backend, st.geometry) == ("cuda", "-")
    for bad in (dict(precision="dd"), dict(backend="torch"),
                dict(chunk_size=st.chunk_size // 2,
                     chunks_per_slice=2 * st.chunks_per_slice),
                dict(geometry=Geometry(64, 32, 8))):
        with pytest.raises(ValueError, match="config mismatch"):
            _one_wave(A, ckpt, **bad)
    with pytest.raises(ValueError, match="slices"):
        D.run_campaign(A, total_slices=2 * st.total_slices,
                       chunks_per_slice=st.chunks_per_slice // 2,
                       chunk_size=st.chunk_size, checkpoint_path=ckpt,
                       device="cpu")
    val2, _ = _one_wave(A, ckpt, max_waves=None)
    np.testing.assert_allclose(val2, oracle.perm_ryser_exact(A), rtol=1e-9)


def test_checkpoint_rejects_geometry_mismatch(tmp_path):
    A = _matrix(10, 9)
    ckpt = str(tmp_path / "tuned.npz")
    g = Geometry(64, 32, 8)
    val, st = _one_wave(A, ckpt, geometry=g)
    assert val is None and st.geometry == g.tag()
    for other in (Geometry(128, 64, 16), None):
        with pytest.raises(ValueError, match="config mismatch"):
            _one_wave(A, ckpt, geometry=other)
    val2, _ = _one_wave(A, ckpt, geometry=g, max_waves=None)
    assert val2 is not None


def test_checkpoint_rejects_preversion_format_and_wrong_matrix(tmp_path):
    p = str(tmp_path / "old.npz")
    np.savez(p, fingerprint="abc", total_slices=4,
             done=np.zeros(4, bool), hi=np.zeros(4), lo=np.zeros(4))
    with pytest.raises(ValueError, match="config-safety"):
        resume.JobState.load(p)
    A = _matrix(8, 1)
    st = resume.JobState.create(A, 4)
    q = str(tmp_path / "s.npz")
    st.save(q)
    with pytest.raises(ValueError, match="different matrix"):
        resume.JobState.load_or_create(q, A + 1e-9, 4)


def test_jobstate_round_trip_and_fields(tmp_path):
    A = _matrix(8, 6)
    st = resume.JobState.create(A, 16, precision="kahan", backend="cuda",
                                chunks_per_slice=2, chunk_size=16,
                                geometry="64x32x8")
    st.record_wave([0, 3, 5], [1.0, 2.0, 3.0], [0.0, 1e-20, 0.0])
    p = str(tmp_path / "s.npz")
    st.save(p)
    st2 = resume.JobState.load(p)
    assert (st2.precision, st2.backend) == ("kahan", "cuda")
    assert (st2.chunks_per_slice, st2.chunk_size) == (2, 16)
    assert st2.geometry == "64x32x8"
    assert st2.version == resume.FORMAT_VERSION
    assert st2.pending_slices() == [i for i in range(16)
                                    if i not in (0, 3, 5)]
    hi, lo = st2.reduce()
    assert abs(hi - 6.0) < 1e-12
    assert resume.JobState.create(A, 4).backend == "torch"


def test_reference_checkpoint_is_refused(tmp_path):
    """A checkpoint the reference wrote (backend ``pallas``) is a config
    mismatch for the port's ``cuda`` body, never merged."""
    from repro.core.resume import JobState as RefJobState
    A = _matrix(10, 11)
    ts, cps, C = plan_slices(10, 8, 1, 8)
    ckpt = str(tmp_path / "ref.npz")
    RefJobState.create(A, ts, backend="pallas", chunks_per_slice=cps,
                       chunk_size=C).save(ckpt)
    with pytest.raises(ValueError, match="config mismatch"):
        _one_wave(A, ckpt)


# ---------------------------------------------------------------------------
# the CLI killed with SIGKILL mid-campaign, then resumed
# ---------------------------------------------------------------------------

def _cli_env():
    return dict(os.environ, PYTHONPATH=SRC)


def _cli(args) -> str:
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.campaign", *args],
        env=_cli_env(), capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr[-3000:]
    return r.stdout


def _value_of(out: str) -> str:
    for line in out.splitlines():
        if "perm(A) =" in line:
            return line.split("perm(A) =")[1].split("  (")[0].strip()
    raise AssertionError(f"no value line in output:\n{out}")


def _run_and_kill_after_first_wave(args):
    p = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.campaign", *args],
        env=_cli_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        for line in p.stdout:
            if "[campaign] wave" in line:
                # printed only after its checkpoint hit disk
                os.kill(p.pid, signal.SIGKILL)
                break
        p.wait(timeout=120)
    finally:
        p.stdout.close()
        if p.poll() is None:
            p.kill()
            p.wait(timeout=120)


CASES = [
    (False, "dd"), (False, "dq_acc"), (False, "kahan"),
    (True, "dq_acc"), (True, "qq"),
]


@pytest.mark.parametrize("use_complex,precision", CASES)
def test_sigkill_resume_bitwise_identical(tmp_path, use_complex, precision):
    ckpt = str(tmp_path / "job.npz")
    # 128 waves of one slice (about 0.6 s on a CPU): the kill lands with
    # most slices pending
    base = ["--n", "14", "--slices", "128", "--lanes", "8", "--device",
            "cpu", "--precision", precision, "--seed", "9"]
    if use_complex:
        base.append("--complex")
    ref = _value_of(_cli([*base, "--checkpoint", str(tmp_path / "ref.npz")]))
    _run_and_kill_after_first_wave([*base, "--checkpoint", ckpt])
    st = resume.JobState.load(ckpt)
    assert 0 < st.fraction_done() < 1, "kill landed outside the campaign"
    expect = "kahan" if use_complex and precision == "qq" else precision
    assert st.precision == expect
    got = _value_of(_cli([*base, "--checkpoint", ckpt]))
    assert got == ref, (got, ref)


def test_campaign_cli_pause_exit_code(tmp_path):
    from repro_torch.launch.campaign import campaign_main
    ckpt = str(tmp_path / "job.npz")
    args = ["--n", "12", "--slices", "16", "--lanes", "8", "--device",
            "cpu", "--checkpoint", ckpt, "--max-waves", "1"]
    assert campaign_main(args) == 3
    assert resume.JobState.load(ckpt).fraction_done() < 1
    assert campaign_main(args[:-2]) == 0


# ---------------------------------------------------------------------------
# plain versions from chunk bases at the end of the step space
# ---------------------------------------------------------------------------

def _padded_ref(A):
    A_pad = np.asarray(ROPS.pad_matrix(jnp.asarray(A)))
    from repro.core.ryser import nw_base_vector
    xb = np.asarray(ROPS.pad_base_vector(nw_base_vector(jnp.asarray(A)),
                                         A_pad.shape[0])).reshape(-1, 1)
    return A_pad, xb


@pytest.mark.parametrize("n", [40, 48, 64])
def test_plain_version_from_the_end_of_the_space_matches_reference(n):
    """Blocks from the last chunks of the 2^(n-1) space and from around
    2^(n-2): the real plain version (``batched`` mode) and the complex one
    against the reference's interpret-mode kernels at rtol 1e-12 on
    hi + lo."""
    rng = np.random.default_rng(n)
    TB, C, Wu, blocks = 8, 16, 4, 2
    chunks = (1 << (n - 1)) // C
    geo = dict(n=n, TB=TB, C=C, Wu=Wu, num_blocks=blocks,
               precision="dq_acc")
    worst = 0.0
    for base in (chunks - blocks * TB, chunks // 2 - TB):
        A = rng.uniform(-1, 1, (n, n)) / 2
        A_pad, xb = _padded_ref(A)
        want = np.asarray(RP.ryser_pallas_call(
            jnp.asarray(A_pad), jnp.asarray(xb), base, mode="batched",
            interpret=True, **geo))
        got = RC.ryser_cuda_call(torch.as_tensor(A_pad), torch.as_tensor(xb),
                                 base, mode="batched", **geo).numpy()
        np.testing.assert_allclose(got.sum(-1), want.sum(-1), rtol=1e-12)
        worst = max(worst, _ulps(got.sum(-1), want.sum(-1)))
        Z = A + 1j * rng.uniform(-1, 1, (n, n)) / 2
        Ar, Ai = ROPS.split_matrix_planes(jnp.asarray(Z))
        from repro.core.ryser import nw_base_vector
        xbr, xbi = ROPS.split_base_planes(nw_base_vector(jnp.asarray(Z)),
                                          Ar.shape[0])
        want = np.asarray(RPX.ryser_pallas_call_complex(
            Ar, Ai, xbr, xbi, base, interpret=True, **geo))
        got = RX.ryser_cuda_call_complex(
            *(torch.as_tensor(np.asarray(t)) for t in (Ar, Ai, xbr, xbi)),
            base, **geo).numpy()
        for cols in ((0, 1), (2, 3)):
            np.testing.assert_allclose(got[:, cols].sum(-1),
                                       want[:, cols].sum(-1), rtol=1e-12)
    print(f"n={n}: worst real gap {worst:g} ulp")


def test_out_of_range_chunk_size_and_range_refused():
    A_pad, xb = (torch.zeros((8, 8), dtype=torch.float64),
                 torch.ones((8, 1), dtype=torch.float64))
    with pytest.raises(ValueError, match="exceeds the 2\\^4 step space"):
        RC.ryser_cuda_call(A_pad, xb, 0, n=5, TB=1, C=32, Wu=2,
                           num_blocks=1)
    with pytest.raises(ValueError, match="exceeds the 2\\^4 step space"):
        RC.ryser_cuda_call(A_pad, xb, 7, n=5, TB=1, C=2, Wu=2,
                           num_blocks=2)
    RC.ryser_cuda_call(A_pad, xb, 6, n=5, TB=1, C=2, Wu=2, num_blocks=2)


# ---------------------------------------------------------------------------
# the u64 edge cases of tests/test_u64emu.py on the port's host helpers
# ---------------------------------------------------------------------------

def test_u64_edge_cases_on_host_helpers():
    # a carry across bit 32: lane starts from a chunk base just below 2^32
    starts = RC._lane_starts((1 << 32) - 2, 4, 3)
    assert [int(s) for s in starts] == [((1 << 32) - 2 + i) << 3
                                        for i in range(4)]
    # ctz at bit 63, and at every bit
    g = np.array([1 << 63, (1 << 63) | (1 << 40), 3 << 31],
                 dtype=np.uint64)
    np.testing.assert_array_equal(RC._ctz_u64(g), [63, 40, 31])
    np.testing.assert_array_equal(
        RC._ctz_u64(np.uint64(1) << np.arange(64, dtype=np.uint64)),
        np.arange(64))
    assert TG.ctz(1 << 63) == 63
    # gray at 2^63 - 1 and the sign of the step that reaches it
    top = (1 << 63) - 1
    assert TG.gray(top) == top ^ (top >> 1) == 1 << 62
    bits = TG.gray_bits_matrix(np.array([top], dtype=np.uint64), 64)[:, 0]
    assert bits.tolist() == [int(b) for b in
                             format(1 << 62, "064b")[::-1]]
    # step 2^63 - 1 turns bit 0 off, step 2^62 turns bit 62 on
    assert TG.step_sign(top) == -1 and TG.step_sign(1 << 62) == 1
    g = np.array([top, 1 << 62, (1 << 63) - 2], dtype=np.uint64)
    np.testing.assert_array_equal(
        TG.step_sign_torch(torch.as_tensor(g.astype(np.int64)),
                           torch.as_tensor(RC._ctz_u64(g))).numpy(),
        [TG.step_sign(int(v)) for v in g])
