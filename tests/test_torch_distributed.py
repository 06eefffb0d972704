"""The port's mesh functions on the CPU, held against the reference and
against the one-device port.

``repro_torch.core.distributed``'s ``permanent_on_mesh``,
``slice_sums_on_mesh``, ``run_campaign(mesh=)``,
``batch_permanents_on_mesh``, ``sparse_batch_permanents_on_mesh`` and
``DistributedPermanent``, and the ``distributed`` / ``distributed_batch``
strategies of the executor, run over gloo worlds of CPU ranks:

* worlds of 2 and 4 ranks are spawned processes with a ``file://`` store
  under ``tmp_path`` (``launch.mesh.run_world``, which kills a world that
  outlives its timeout), each doing many checks in one spawn and sending
  its results back; a world of one rank runs in the test's own process
  and is destroyed after each test;
* the reference's ``permanent_on_mesh`` at D = 1, 2, 4 runs in
  subprocesses with ``XLA_FLAGS=--xla_force_host_platform_device_count=D``
  (as ``tests/test_distributed.py`` runs it) and prints ``float.hex``:
  the port's ``torch`` body against ``backend="jnp"``, its ``cuda`` body
  (the kernels' plain versions) against ``"pallas"`` in interpret mode,
  within 1e-12 relative (the reference sums with ``psum``, the port
  gathers and sums in slice-id order), both within 1e-9 of the oracle;
* against the one-device port, bit for bit: ``permanent_on_mesh`` and
  ``run_campaign`` at the same slice decomposition, the sharded buckets
  (ragged B = 11 at D = 4) against the one-device ``cuda`` and ``torch``
  backends, and a campaign killed at world 4, resumed at 2, then at 1
  and on the plain path, against the uninterrupted one;
* failures: a rank that fails one wave (every rank retries it, same
  bits), a rank that always fails (every rank raises, well within the
  timeout), ranks given different inputs (``ValueError`` on every rank);
* the solver with and without a ``distributed_ctx``: tags, the
  ``distributed->torch`` downgrade and distinct cache keys (the port's
  counterparts of ``tests/test_distributed_batch.py``'s executor tests).
"""

import os
import shutil
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import permanent, permanent_batch  # noqa: E402
from repro_torch.core import distributed as D  # noqa: E402
from repro_torch.core import oracle  # noqa: E402
from repro_torch.core.executor import (available_backends,  # noqa: E402
                                       get_backend)
from repro_torch.core.planner import ROUTE_DENSE, SolverConfig  # noqa: E402
from repro_torch.core.solver import PermanentSolver  # noqa: E402
from repro_torch.core.stepspace import plan_slices  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
PRECISIONS = ("dd", "dq_fast", "dq_acc", "qq", "kahan")
BODIES = {"torch": "jnp", "cuda": "pallas"}    # port body -> reference
N_MESH, LANES = 10, 16                   # permanent_on_mesh's cases
N_BUCKET, B_RAGGED = 8, 11               # sharded buckets
N_CAMP, CAMP_SLICES, CAMP_LANES = 12, 32, 8   # the kill-and-resume chain
WORLD_TIMEOUT_S = 120.0


def _matrix(n: int, seed: int, cplx: bool = False) -> np.ndarray:
    rng = np.random.default_rng(seed)
    A = rng.uniform(0.2, 1.2, (n, n))
    if cplx:
        A = A + 1j * rng.uniform(0.2, 1.2, (n, n))
    return A


def _bucket(seed: int, cplx: bool, sparse: bool, B: int = B_RAGGED):
    rng = np.random.default_rng(seed)
    S = rng.uniform(-1, 1, (B, N_BUCKET, N_BUCKET))
    if cplx:
        S = S + 1j * rng.uniform(-1, 1, S.shape)
    if sparse:                           # degree-3 bands, a different shift
        i, j = np.indices((N_BUCKET, N_BUCKET))
        S = S * np.stack([((i - j - b) % N_BUCKET < 3) for b in range(B)])
    return S


def _camp_spec():
    ts, cps, C = plan_slices(N_CAMP, CAMP_SLICES, 1, CAMP_LANES)
    return dict(total_slices=ts, chunks_per_slice=cps, chunk_size=C)


class _Killed(Exception):
    """Stands in for a SIGKILL right after a wave's checkpoint."""


def _kill_after_first_wave(state, wave):
    raise _Killed(len(wave.ids))


# ---------------------------------------------------------------------------
# the spawned worlds (module level: the ranks import this module)
# ---------------------------------------------------------------------------

def _pom_values(mesh) -> dict:
    out = {}
    for body in BODIES:
        for cplx in (False, True):
            A = _matrix(N_MESH, 3, cplx)
            for prec in PRECISIONS:
                out[body, cplx, prec] = D.permanent_on_mesh(
                    A, mesh, precision=prec, lanes_per_device=LANES,
                    backend=body)
    return out


def _world4(rank: int, world: int, work: str) -> dict:
    mesh = M.make_mesh((world,), ("step",), device="cpu")
    out = {"pom": _pom_values(mesh), "buckets": {}}
    for body in ("cuda", "torch"):
        for cplx in (False, True):
            S = _bucket(5, cplx, False)
            out["buckets"]["dense", body, cplx] = \
                D.batch_permanents_on_mesh(S, mesh, backend=body)
            S = _bucket(6, cplx, True)
            out["buckets"]["sparse", body, cplx] = \
                D.sparse_batch_permanents_on_mesh(S, mesh, backend=body)
    # f32 keeps its dtype across the gather
    out["f32"] = D.batch_permanents_on_mesh(
        _bucket(7, False, False).astype(np.float32), mesh)
    # the chain's first leg: killed right after its first wave
    try:
        D.run_campaign(_matrix(N_CAMP, 9), mesh=mesh, **_camp_spec(),
                       checkpoint_path=os.path.join(work, "job.npz"),
                       progress_cb=_kill_after_first_wave, device="cpu")
    except _Killed as e:
        out["killed_after"] = e.args[0]
    return out


def _flaky_slice_sums(fail_calls: set):
    """``D.slice_sums`` that raises on the listed calls (1-based)."""
    real, calls = D.slice_sums, [0]

    def flaky(*a, **k):
        calls[0] += 1
        if calls[0] in fail_calls:
            raise RuntimeError(f"injected failure, call {calls[0]}")
        return real(*a, **k)
    return flaky


def _world2(rank: int, world: int, work: str) -> dict:
    mesh = M.make_mesh((world,), ("step",), device="cpu")
    out = {"pom": _pom_values(mesh)}
    A = _matrix(N_CAMP, 9)
    # the chain's second leg: resume the world-4 checkpoint for one wave
    value, state = D.run_campaign(A, mesh=mesh, **_camp_spec(),
                                  checkpoint_path=os.path.join(work,
                                                               "job.npz"),
                                  max_waves=1, device="cpu")
    out["resumed"] = (value, int(state.done.sum()))
    # rank 1 fails its second wave once: every rank retries it
    real = D.slice_sums
    if rank == 1:
        D.slice_sums = _flaky_slice_sums({2})
    waves = []
    out["retried"] = D.run_campaign(
        A, mesh=mesh, **_camp_spec(), device="cpu", wave_width=2,
        progress_cb=lambda s, w: waves.append(w.ids))[0]
    out["retried_waves"] = waves
    # rank 1 always fails: every rank raises after max_wave_retries
    if rank == 1:
        D.slice_sums = _flaky_slice_sums(set(range(1, 100)))
    t0 = time.monotonic()
    try:
        D.run_campaign(A, mesh=mesh, **_camp_spec(), device="cpu",
                       max_wave_retries=2)
        out["always"] = None
    except RuntimeError as e:
        out["always"] = (str(e), time.monotonic() - t0)
    D.slice_sums = real
    # ranks given different inputs: ValueError on every rank
    out["mismatch"] = []
    for call in (lambda X: D.permanent_on_mesh(X, mesh, lanes_per_device=4),
                 lambda X: D.batch_permanents_on_mesh(X[None], mesh)):
        try:
            call(_matrix(6, 1) + rank)
            out["mismatch"].append(None)
        except ValueError as e:
            out["mismatch"].append(str(e))
    # the solver over the mesh: buckets, the step split, campaigns
    mats = [_matrix(9, s) for s in range(5)] + \
        [_matrix(9, s, True)[:7, :7] for s in range(3)]
    out["solver_batch"] = permanent_batch(
        mats, backend="distributed_batch", device="cpu", preprocess=False,
        distributed_ctx=mesh, return_report=True)
    out["solver_scalar"] = permanent(
        _matrix(N_MESH, 3), backend="distributed", device="cpu",
        distributed_ctx=mesh, return_report=True)
    solver = PermanentSolver(SolverConfig(
        backend="distributed", device="cpu", preprocess=False,
        campaign_threshold=1.0, campaign_slices=8, campaign_lanes=8),
        distributed_ctx=mesh)
    out["solver_campaign"] = solver.execute(solver.plan(_matrix(10, 4)),
                                            return_report=True)
    runner = D.DistributedPermanent(mesh, slices_per_device=2,
                                    lanes_per_device=8)
    out["runner"] = runner.permanent(_matrix(10, 4))
    return out


def _run_worlds(work: str) -> dict:
    """World 4, then world 2 (it resumes world 4's checkpoint): every
    rank's results by world, and the chain's checkpoint under "chain"."""
    os.makedirs(work)
    out = {"chain": os.path.join(work, "job.npz")}
    for world, fn in ((4, _world4), (2, _world2)):
        out[world] = M.run_world(fn, world, os.path.join(work, f"w{world}"),
                                 args=(work,), timeout_s=WORLD_TIMEOUT_S)
    return out


# ---------------------------------------------------------------------------
# the reference, D forced host devices a subprocess
# ---------------------------------------------------------------------------

_REF = """
import jax
jax.config.update("jax_enable_x64", True)
import numpy as np
from repro.core import distributed
D = {D}
mesh = jax.make_mesh((D,), ("step",))
for body in {bodies}:
    for cplx in (False, True):
        rng = np.random.default_rng(3)
        A = rng.uniform(0.2, 1.2, ({n}, {n}))
        if cplx:
            A = A + 1j * rng.uniform(0.2, 1.2, ({n}, {n}))
        for prec in {precs}:
            v = complex(distributed.permanent_on_mesh(
                A, mesh, precision=prec, lanes_per_device={lanes},
                backend=body))
            print(body, int(cplx), prec, v.real.hex(), v.imag.hex())
"""


def _ref_procs() -> dict:
    """One subprocess a (D, reference body), all started at once."""
    procs = {}
    for d in (1, 2, 4):
        env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
                   XLA_FLAGS=f"--xla_force_host_platform_device_count={d}")
        for body in BODIES.values():
            code = textwrap.dedent(_REF.format(
                D=d, n=N_MESH, lanes=LANES, precs=PRECISIONS,
                bodies=(body,)))
            procs[d, body] = subprocess.Popen(
                [sys.executable, "-c", code], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return procs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference subprocesses and the spawned worlds, run side by
    side once for the module."""
    procs = _ref_procs()
    try:
        worlds = _run_worlds(str(tmp_path_factory.mktemp("mesh") / "w"))
        refs = {1: {}, 2: {}, 4: {}}
        for (d, _), p in procs.items():
            out, err = p.communicate(timeout=600)
            assert p.returncode == 0, err[-3000:]
            for line in out.strip().splitlines():
                body, cplx, prec, re, im = line.split()
                refs[d][body, bool(int(cplx)), prec] = complex(
                    float.fromhex(re), float.fromhex(im))
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    return {"worlds": worlds, "refs": refs}


@pytest.fixture
def mesh1():
    """A world of one rank in this process, destroyed after the test."""
    with M.world():
        yield M.make_mesh((1,), ("step",), device="cpu")
    assert not torch.distributed.is_initialized()


def _rel(a, b) -> float:
    return abs(complex(a) - complex(b)) / abs(complex(b))


def _pom_world(runs, d: int, mesh1=None) -> list[dict]:
    if d == 1:
        return [_pom_values(mesh1)]
    return [r["pom"] for r in runs["worlds"][d]]


# ---------------------------------------------------------------------------
# permanent_on_mesh against the reference and the one-device port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [1, 2, 4])
def test_permanent_on_mesh_against_reference_and_oracle(runs, d, request):
    mesh1 = request.getfixturevalue("mesh1") if d == 1 else None
    ranks = _pom_world(runs, d, mesh1)
    ref = runs["refs"][d]
    exact = {c: oracle.perm_ryser_exact(_matrix(N_MESH, 3, c))
             for c in (False, True)}
    for key, got in ranks[0].items():
        body, cplx, prec = key
        assert all(r[key] == got for r in ranks), key   # same bits, all ranks
        want = ref[BODIES[body], cplx, prec]
        assert _rel(got, want) <= 1e-12, (key, got, want)
        assert _rel(got, exact[cplx]) <= 1e-9
        assert _rel(want, exact[cplx]) <= 1e-9
        assert isinstance(got, complex) == cplx


@pytest.mark.parametrize("d", [1, 2, 4])
@pytest.mark.parametrize("body", ["torch", "cuda"])
def test_permanent_on_mesh_equals_one_device_campaign(runs, d, body,
                                                      request):
    mesh1 = request.getfixturevalue("mesh1") if d == 1 else None
    got = _pom_world(runs, d, mesh1)[0]
    ts, cps, C = plan_slices(N_MESH, d, 1, LANES)
    for cplx in (False, True):
        for prec in PRECISIONS:
            want, _ = D.run_campaign(_matrix(N_MESH, 3, cplx),
                                     total_slices=ts, chunks_per_slice=cps,
                                     chunk_size=C, precision=prec,
                                     backend=body, device="cpu")
            assert got[body, cplx, prec] == want, (cplx, prec)


def test_slice_sums_on_mesh_sentinels_and_order(mesh1):
    A = _matrix(9, 2, True)
    ids = [5, -1, 0, 1, 2, -3, 7]
    his, los = D.slice_sums_on_mesh(A, mesh1, ids, chunks_per_slice=4,
                                    chunk_size=8)
    live = [i for i in ids if i >= 0]
    h, e, _ = D.slice_sums(A, live, chunks_per_slice=4, chunk_size=8,
                           device="cpu")
    k = 0
    for pos, i in enumerate(ids):
        if i < 0:
            assert his[pos] == 0 and los[pos] == 0
        else:
            assert his[pos] == h[k] and los[pos] == e[k]
            k += 1


# ---------------------------------------------------------------------------
# sharded buckets against the one-device backends
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ["dense", "sparse"])
@pytest.mark.parametrize("body", ["cuda", "torch"])
@pytest.mark.parametrize("cplx", [False, True])
def test_ragged_buckets_equal_one_device_backends(runs, route, body, cplx):
    ranks = runs["worlds"][4]
    got = ranks[0]["buckets"][route, body, cplx]
    for r in ranks[1:]:
        assert np.array_equal(r["buckets"][route, body, cplx], got)
    S = _bucket(5 if route == "dense" else 6, cplx, route == "sparse")
    run = getattr(get_backend(body), f"{route}_batch")
    want = run(S, precision="dq_acc", num_chunks=4096, device="cpu")
    assert got.shape == (B_RAGGED,) and got.dtype == want.dtype
    assert np.array_equal(got, want)


def test_f32_bucket_keeps_its_dtype_across_the_gather(runs):
    got = runs["worlds"][4][0]["f32"]
    S = _bucket(7, False, False).astype(np.float32)
    want = get_backend("cuda").dense_batch(S, precision="dq_acc",
                                           num_chunks=4096, device="cpu")
    assert got.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("fn", ["batch_permanents_on_mesh",
                                "sparse_batch_permanents_on_mesh"])
def test_small_n_buckets_use_closed_forms(mesh1, fn):
    S = _bucket(8, True, False)[:, :2, :2]
    got = getattr(D, fn)(S, mesh1)
    np.testing.assert_array_equal(
        got, S[:, 0, 0] * S[:, 1, 1] + S[:, 0, 1] * S[:, 1, 0])


# ---------------------------------------------------------------------------
# campaigns: killed at world 4, resumed at 2, then at 1 and on one device
# ---------------------------------------------------------------------------

def test_campaign_killed_at_4_resumed_at_2_then_1_and_plain(runs, tmp_path,
                                                            mesh1):
    A = _matrix(N_CAMP, 9)
    spec = _camp_spec()
    want, _ = D.run_campaign(A, **spec, device="cpu")
    w4, w2 = runs["worlds"][4], runs["worlds"][2]
    assert all(r["killed_after"] == 4 for r in w4)   # one wave of 4 x W=1
    assert all(r["resumed"] == (None, 6) for r in w2)   # + 2 x W=1
    # the chain goes on from copies of the world-2 checkpoint: at world 1
    # and on the plain one-device path
    ckpt = runs["worlds"]["chain"]
    for path, mesh in ((tmp_path / "w1.npz", mesh1),
                       (tmp_path / "plain.npz", None)):
        shutil.copy(ckpt, path)
        got, state = D.run_campaign(A, **spec, checkpoint_path=str(path),
                                    mesh=mesh, device="cpu")
        assert got == want and state.done.all()
    exact = oracle.perm_ryser_exact(A)
    assert _rel(want, exact) <= 1e-9


def test_failed_wave_is_retried_by_every_rank(runs):
    A = _matrix(N_CAMP, 9)
    want, _ = D.run_campaign(A, **_camp_spec(), device="cpu")
    ranks = runs["worlds"][2]
    assert all(r["retried"] == want for r in ranks)
    waves = ranks[0]["retried_waves"]
    assert ranks[1]["retried_waves"] == waves
    # every slice recorded once, in waves of D x W = 4, none lost
    assert sorted(i for w in waves for i in w) == list(
        range(_camp_spec()["total_slices"]))
    assert all(len(w) == 4 for w in waves)


def test_failures_past_the_retries_raise_on_every_rank(runs):
    r0, r1 = (r["always"] for r in runs["worlds"][2])
    assert r1 is not None and "injected failure" in r1[0]
    assert r0 is not None and "shard(s) [1] failed" in r0[0]
    assert max(r0[1], r1[1]) < WORLD_TIMEOUT_S / 4


def test_ranks_given_different_inputs_raise_value_error(runs):
    for r in runs["worlds"][2]:
        assert len(r["mismatch"]) == 2
        assert all(m and "different inputs" in m for m in r["mismatch"])


# ---------------------------------------------------------------------------
# the solver over a mesh
# ---------------------------------------------------------------------------

def test_solver_over_a_world_of_two_equals_one_device(runs):
    ranks = runs["worlds"][2]
    vals, reps = ranks[0]["solver_batch"]
    mats = [_matrix(9, s) for s in range(5)] + \
        [_matrix(9, s, True)[:7, :7] for s in range(3)]
    want = permanent_batch(mats, device="cpu", preprocess=False)
    assert np.array_equal(vals, want)
    assert np.array_equal(ranks[1]["solver_batch"][0], vals)
    assert reps[0].dispatch == ["dense_batch(n=9,b=5)"]
    assert reps[5].dispatch == ["dense_batch(n=7,b=3)"]
    v, rep = ranks[0]["solver_scalar"]
    assert rep.dispatch == [f"dense(n={N_MESH})"]
    ts, cps, C = plan_slices(N_MESH, 2, 1, D.MESH_LANES)
    assert v == ranks[1]["solver_scalar"][0] == D.run_campaign(
        _matrix(N_MESH, 3), total_slices=ts, chunks_per_slice=cps,
        chunk_size=C, device="cpu")[0]
    solver = PermanentSolver(SolverConfig(
        backend="cuda", device="cpu", preprocess=False,
        campaign_threshold=1.0, campaign_slices=8, campaign_lanes=8))
    want = solver.execute(solver.plan(_matrix(10, 4)))
    v, rep = ranks[0]["solver_campaign"]
    assert v == want and rep.dispatch == ["campaign(n=10,cuda)"]
    ts, cps, C = plan_slices(10, 2, 2, 8)
    assert ranks[0]["runner"] == D.run_campaign(
        _matrix(10, 4), total_slices=ts, chunks_per_slice=cps, chunk_size=C,
        device="cpu")[0]


def test_registry_has_the_distributed_strategies():
    assert {"distributed", "distributed_batch"} <= set(available_backends())
    be = get_backend("distributed_batch")
    assert be.name == "distributed_batch"
    # no mesh attached, on the CPU -> batch methods signal the downgrade
    assert be.dense_batch(_matrix(5, 1)[None].repeat(3, 0),
                          precision="dq_acc", num_chunks=64,
                          device="cpu") is None


@pytest.mark.parametrize("strategy", ["distributed", "distributed_batch"])
def test_without_mesh_a_card_runs_the_kernels_not_the_torch_engine(strategy):
    """No mesh and the card (None or "cuda"): the ``cuda`` body, under
    the ``cuda`` cache identity; never the torch engine on card tensors.
    Without a card the kernels' wrappers refuse: nothing falls back to
    the CPU."""
    be = get_backend(strategy)
    for dev in (None, "cuda"):
        for batched in (False, True):
            assert be.value_backend(ROUTE_DENSE, 8, batched=batched,
                                    device=dev) == "cuda"
            assert be.value_backend(ROUTE_DENSE, 3, batched=batched,
                                    device=dev) == "torch"
        assert be.value_backend(ROUTE_DENSE, 8, batched=True,
                                device="cpu") == "torch"
    A = _matrix(8, 2)
    calls = [lambda: be.dense(A, precision="dq_acc", num_chunks=64),
             lambda: be.dense_batch(A[None].repeat(3, 0), precision="dq_acc",
                                    num_chunks=64, device="cuda")]
    if torch.cuda.is_available():
        want = permanent(A, backend="cuda", preprocess=False)
        assert calls[0]() == want
        assert calls[1]()[0] == want
    else:
        for call in calls:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()


@pytest.mark.parametrize("strategy", ["distributed", "distributed_batch"])
def test_solver_without_mesh_downgrades_with_tag(strategy):
    mats = [_matrix(7, s) for s in range(3)]
    solver = PermanentSolver(SolverConfig(backend=strategy, device="cpu",
                                          preprocess=False))
    vals, reports = solver.execute(solver.plan_batch(mats),
                                   return_report=True)
    ref = permanent_batch(mats, backend="torch", device="cpu",
                          preprocess=False)
    assert np.array_equal(vals, ref)
    tags = [t for r in reports for t in r.dispatch]
    assert any(f"{strategy}->torch" in t for t in tags), tags
    assert solver.stats()["downgrades"]
    assert all(k[3] == "torch" for k in solver.cache._data)


@pytest.mark.parametrize("strategy", ["distributed", "distributed_batch"])
def test_solver_with_mesh_shards_buckets_bitwise(mesh1, strategy):
    band = (np.eye(9) + np.roll(np.eye(9), 1, axis=1)).astype(bool)
    mats = [_matrix(8, s) for s in range(4)] + \
        [_matrix(9, s) * band for s in range(3)]      # density 0.22
    dist = PermanentSolver(SolverConfig(backend=strategy, device="cpu",
                                        preprocess=False),
                           distributed_ctx=mesh1)
    cuda = PermanentSolver(SolverConfig(backend="cuda", device="cpu",
                                        preprocess=False))
    got, reports = dist.execute(dist.plan_batch(mats), return_report=True)
    assert np.array_equal(got, cuda.execute(cuda.plan_batch(mats)))
    assert not dist.stats()["downgrades"]
    tags = [t for r in reports for t in r.dispatch]
    assert "dense_batch(n=8,b=4)" in tags and "sparse_batch(n=9,b=3)" in tags
    assert all(k[3] == "distributed_batch" for k in dist.cache._data)


def test_bare_mesh_accepted_as_ctx_for_queue(mesh1):
    solver = PermanentSolver(SolverConfig(backend="distributed",
                                          device="cpu", queue_max_batch=4,
                                          queue_max_delay_s=1e9),
                             distributed_ctx=mesh1)
    mats = [_matrix(6, s) for s in range(4)]
    reqs = [solver.submit(M_) for M_ in mats]
    assert all(r.done for r in reqs)
    assert np.array_equal(np.array([r.result() for r in reqs]),
                          permanent_batch(mats, device="cpu"))
    assert not solver.stats()["downgrades"]


def test_sharded_bucket_cache_roundtrip(mesh1):
    mats = [_matrix(7, s) for s in range(3)]
    solver = PermanentSolver(SolverConfig(backend="distributed",
                                          device="cpu", preprocess=False),
                             distributed_ctx=mesh1)
    v1 = solver.execute(solver.plan_batch(mats))
    dispatches = solver.stats()["device_dispatches"]
    assert all(k[3] == "distributed_batch" for k in solver.cache._data)
    v2 = solver.execute(solver.plan_batch(mats))
    assert np.array_equal(v1, v2)
    assert solver.stats()["device_dispatches"] == dispatches


def test_singleton_bucket_under_mesh_stays_bitwise_and_cacheable(mesh1):
    """A one-leaf bucket goes through the sharded bucket, not the
    step-space split (another numerics family, under a key the batched
    probes never read)."""
    A = _matrix(8, 3)
    solver = PermanentSolver(SolverConfig(backend="distributed",
                                          device="cpu", preprocess=False),
                             distributed_ctx=mesh1)
    v1, reps = solver.execute(solver.plan_batch([A]), return_report=True)
    assert reps[0].dispatch == ["dense_batch(n=8,b=1)"]
    assert np.array_equal(
        v1, get_backend("cuda").dense_batch(A[None], precision="dq_acc",
                                            num_chunks=4096, device="cpu"))
    assert all(k[3] == "distributed_batch" for k in solver.cache._data)
    dispatches = solver.stats()["device_dispatches"]
    v2 = solver.execute(solver.plan_batch([A]))
    assert np.array_equal(v1, v2)
    assert solver.stats()["device_dispatches"] == dispatches


def test_downgraded_and_sharded_values_use_distinct_cache_keys(mesh1):
    mats = [_matrix(6, s) for s in range(3)]
    no_mesh = PermanentSolver(SolverConfig(backend="distributed",
                                           device="cpu", preprocess=False))
    no_mesh.execute(no_mesh.plan_batch(mats))
    assert all(k[3] == "torch" for k in no_mesh.cache._data)
    meshed = PermanentSolver(SolverConfig(backend="distributed",
                                          device="cpu", preprocess=False),
                             distributed_ctx=mesh1)
    meshed.execute(meshed.plan_batch(mats))
    assert all(k[3] == "distributed_batch" for k in meshed.cache._data)
    assert not set(no_mesh.cache._data) & set(meshed.cache._data)


def test_scalar_leaves_under_a_mesh(mesh1):
    """A dense scalar leaf is the step-space split (``distributed``), a
    sparse one the cuda leaf on every rank, n < 4 the torch engine."""
    A = _matrix(9, 1)
    solver = PermanentSolver(SolverConfig(backend="distributed",
                                          device="cpu", preprocess=False),
                             distributed_ctx=mesh1)
    v, rep = solver.execute(solver.plan(A), return_report=True)
    assert v == D.permanent_on_mesh(A, mesh1)
    assert [k[3] for k in solver.cache._data] == ["distributed"]
    S = np.eye(9) + np.roll(np.eye(9), 1, axis=1) * 0.5
    v, rep = solver.execute(solver.plan(S), return_report=True)
    assert rep.dispatch == ["sparse(n=9,distributed->cuda)"]
    assert v == permanent(S, device="cpu", preprocess=False)
    v3 = solver.execute(solver.plan(_matrix(3, 2)))
    assert v3 == permanent(_matrix(3, 2), device="cpu", backend="torch",
                           preprocess=False)


def test_mesh_device_must_agree_with_the_config(mesh1):
    solver = PermanentSolver(SolverConfig(backend="distributed",
                                          device="cuda", preprocess=False),
                             distributed_ctx=mesh1)
    with pytest.raises(ValueError, match="disagrees with the mesh"):
        solver.execute(solver.plan(_matrix(9, 1)))
