"""The service and the tuner over a mesh, on the CPU: gloo worlds of 1, 2
and 4 ranks held against the one-device service and the reference.

``repro_torch.serve.PermanentService(distributed_ctx=)``: shard 0 admits,
sheds and picks each bucket, broadcasts each dispatch, and the other
ranks ``follow()``.  Cases:

* seeded ``fill_first`` streams with a fake clock -- dense and sparse,
  real and complex, each key two full buckets and a lone request --
  through a ("data",) mesh of 1 (in this process), 2 and 4 ranks (spawned
  by ``launch.mesh.run_world`` over a ``file://`` store under a temporary
  directory): every bucket member bit for bit the one-device service's,
  every lone dense leaf bit for bit ``permanent_on_mesh`` at that world
  (one-device ``run_campaign`` at its decomposition) and within 1e-12 of
  the one-device service; the same streams through the reference's
  service on a forced-device jax CPU mesh (a subprocess a D, with
  ``XLA_FLAGS=--xla_force_host_platform_device_count=D``) within 1e-12;
* a 2 x 2 ``CampaignMesh`` with an interleaved n = 12 campaign: run out,
  bit for bit one-device ``run_campaign``; stopped after two dispatches
  and resumed at world 2 to the same bits;
* a dispatch that fails on one rank: its tickets are shed
  (``DISPATCH_FAILED``) on shard 0, the next dispatch is served, and the
  world ends well within its timeout; an idle shard 0's keep-alives;
* ``tune_table(["campaign"], [10], mesh=)`` at world 2: the same table on
  both ranks, keyed as the reference keys it;
* both CLIs under ``torch.distributed.run --nproc-per-node 2``.

The worlds, the reference subprocesses and the CLIs start together
once for the module.
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

from repro_torch.core import distributed as D  # noqa: E402
from repro_torch.core.planner import SolverConfig  # noqa: E402
from repro_torch.core.stepspace import plan_slices  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.serve import (CampaignSpec, PermanentService,  # noqa: E402
                               ServiceConfig, ShedReason)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ROOT = os.path.dirname(SRC)
N_DENSE, N_SPARSE, BAND = 8, 12, 3       # a band of 3 at n = 12: sparse
MAX_BATCH, PER_KEY = 4, 2 * 4 + 1        # two full buckets and a lone one
N_CAMP, CAMP_SLICES, CAMP_LANES = 12, 8, 8
WORLD_TIMEOUT_S = 120.0


class FakeClock:
    """A clock that stands still: fill_first dispatches on size only."""

    def __call__(self) -> float:
        return 0.0


def _band(rng, n: int, k: int, cplx: bool) -> np.ndarray:
    i = np.arange(n)
    A = np.zeros((n, n), complex if cplx else float)
    for o in range(k):
        v = rng.uniform(0.5, 1.5, n)
        A[i, (i + o) % n] = v + 1j * rng.uniform(0.5, 1.5, n) if cplx else v
    return A[rng.permutation(n)][:, rng.permutation(n)]


def _stream() -> list[np.ndarray]:
    """Four keys interleaved: dense n = 8 real and complex, band n = 12
    real and complex, PER_KEY requests each."""
    rng = np.random.default_rng(2121)
    out = []
    for _ in range(PER_KEY):
        out.append(rng.uniform(-1, 1, (N_DENSE, N_DENSE)))
        out.append(rng.uniform(-1, 1, (N_DENSE, N_DENSE))
                   + 1j * rng.uniform(-1, 1, (N_DENSE, N_DENSE)))
        out.append(_band(rng, N_SPARSE, BAND, False))
        out.append(_band(rng, N_SPARSE, BAND, True))
    return out


def _config(backend: str) -> SolverConfig:
    return SolverConfig(backend=backend, device="cpu", preprocess=False)


def _service_config() -> ServiceConfig:
    return ServiceConfig(max_batch=MAX_BATCH, fill_first=True,
                         quantize_buckets=False, log_every_s=float("inf"))


def _drive(svc, mats) -> dict:
    """fill_first: a step an arrival, then drain; the values, and whether
    each ticket was served alone, in arrival order."""
    tickets = []
    for A in mats:
        tickets.append(svc.submit(A, deadline_s=None))
        svc.step()
    svc.drain()
    return {"values": [t.result() for t in tickets],
            "lone": _lone(tickets, svc.dispatch_log)}


def _lone(tickets, log) -> list[bool]:
    """Whether each ticket was served alone (the drain's tail of one)."""
    per_key: dict = {}
    for t in tickets:
        per_key.setdefault(t.key, []).append(t)
    lone = set()
    for key, served, _, trigger in log:
        if served == 1 and trigger == "drain":
            lone.add(per_key[key][-1].id)
    return [t.id in lone for t in tickets]


# the stream's last dense requests, real and complex: each served alone
# (the drain's tail)
LONE_DENSE = (4 * PER_KEY - 4, 4 * PER_KEY - 3)


def _lone_dense() -> list[np.ndarray]:
    mats = _stream()
    return [mats[i] for i in LONE_DENSE]


def _serve_world(mesh) -> dict | None:
    """The stream through a service over ``mesh``: shard 0's results, or
    None on a follower; then the lone dense requests through
    ``permanent(backend="distributed")`` on every rank."""
    from repro_torch import permanent
    svc = PermanentService(_config("distributed"), _service_config(),
                           distributed_ctx=mesh, clock=FakeClock(), log=None)
    out = None
    if svc.leader:
        with svc:
            out = _drive(svc, _stream())
    else:
        svc.follow()
    split = [permanent(A, backend="distributed", device="cpu",
                       preprocess=False, distributed_ctx=mesh)
             for A in _lone_dense()]
    return None if out is None else {**out, "split": split}


def _campaign_spec(checkpoint: str | None) -> CampaignSpec:
    C = np.random.default_rng(9).uniform(0.2, 1.2, (N_CAMP, N_CAMP))
    return CampaignSpec(matrix=C, waves=1, checkpoint=checkpoint,
                        slices=CAMP_SLICES, lanes=CAMP_LANES)


def _campaign_service(ctx, checkpoint, *, stop_after: int | None = None):
    """Dense n = 8 requests with a campaign interleaved over ``ctx``: run
    out, or left after ``stop_after`` dispatches (its checkpoint then
    holds what was done).  Shard 0's (value, fraction), None elsewhere."""
    svc = PermanentService(_config("distributed"), _service_config(),
                           distributed_ctx=ctx,
                           campaign=_campaign_spec(checkpoint),
                           clock=FakeClock(), log=None)
    if not svc.leader:
        svc.follow()
        return None
    rng = np.random.default_rng(5)
    with svc:
        for _ in range(MAX_BATCH * (stop_after or 1)):
            svc.submit(rng.uniform(-1, 1, (N_DENSE, N_DENSE)),
                       deadline_s=None)
            svc.step()
        if stop_after is None:
            svc.drain()
    return svc.campaign_value, svc.campaign_fraction


def _world4(rank: int, world: int, work: str) -> dict:
    out = {"serve": _serve_world(M.make_batch_mesh(device="cpu"))}
    cm = M.make_campaign_mesh(2, 2, device="cpu")
    out["campaign"] = _campaign_service(cm, None)
    out["stopped"] = _campaign_service(cm, os.path.join(work, "camp.npz"),
                                       stop_after=2)
    return out


def _failing_dispatch(mesh, rank: int) -> dict | None:
    """Rank 1's kernel entry raises at its first call: the bucket fails
    on every rank (the mesh functions' ok flags); the next one is
    served."""
    from repro_torch.kernels import ops
    real, calls = ops.permanent_cuda_batched, [0]

    def flaky(*a, **k):
        calls[0] += 1
        if calls[0] == 1:
            raise RuntimeError("injected kernel failure")
        return real(*a, **k)
    if rank == 1:
        ops.permanent_cuda_batched = flaky
    svc = PermanentService(_config("distributed"), _service_config(),
                           distributed_ctx=mesh, clock=FakeClock(), log=None)
    try:
        if not svc.leader:
            return {"follower": svc.follow()}
        t0 = time.monotonic()
        rng = np.random.default_rng(4)
        with svc:
            ts = [svc.submit(rng.uniform(-1, 1, (N_DENSE, N_DENSE)),
                             deadline_s=None) for _ in range(2 * MAX_BATCH)]
            svc.drain()
        return {"status": [(t.shed, t.shed_reason, t.shed_detail)
                           for t in ts],
                "values": [None if t.shed else t.result() for t in ts],
                "mats": [t.matrix for t in ts],
                "seconds": time.monotonic() - t0,
                "snapshot": svc.snapshot()["requests"]}
    finally:
        ops.permanent_cuda_batched = real


def _keepalive(mesh) -> dict | int:
    """An idle shard 0 (keep-alive period 0 here) broadcasts one
    keep-alive a step; a follower counts them."""
    from repro_torch.serve import loop
    loop.KEEPALIVE_S = 0.0
    svc = PermanentService(_config("distributed"), _service_config(),
                           distributed_ctx=mesh, clock=FakeClock(), log=None)
    if not svc.leader:
        return svc.follow()
    with svc:
        return sum(svc.step() for _ in range(3))


def _world2(rank: int, world: int, work: str) -> dict:
    from repro_torch.tune.search import tune_table
    mesh = M.make_batch_mesh(device="cpu")
    out = {"serve": _serve_world(mesh)}
    # the 2 x 2 world's stopped campaign, resumed over this world
    shutil.copy(os.path.join(work, "camp.npz"),
                os.path.join(work, f"resume{rank}.npz"))
    out["resumed"] = _campaign_service(mesh, os.path.join(work,
                                                          "resume0.npz"))
    out["failing"] = _failing_dispatch(mesh, rank)
    out["keepalive"] = _keepalive(mesh)
    step = M.make_mesh((world,), ("step",), device="cpu")
    table, rows = tune_table(["campaign"], [10], batch=2, top_k=2,
                             repeats=1, device="cpu", mesh=step)
    out["tune"] = ([(e.key(), e.to_dict()) for e in table.entries.values()],
                   [(r["geometry"], r["ranks"], r["batch"]) for r in rows])
    return out


def _run_worlds(work: str) -> dict:
    os.makedirs(work)
    return {world: M.run_world(fn, world, os.path.join(work, f"w{world}"),
                               args=(work,), timeout_s=WORLD_TIMEOUT_S)
            for world, fn in ((4, _world4), (2, _world2))}


# ---------------------------------------------------------------------------
# the reference's service, D forced host devices a subprocess; the CLIs
# ---------------------------------------------------------------------------

_REF = """
import jax
jax.config.update("jax_enable_x64", True)
import numpy as np
import tests.test_torch_serve_mesh as T
from repro.core.solver import SolverConfig
from repro.launch.mesh import make_batch_mesh
from repro.serve import PermanentService, ServiceConfig
svc = PermanentService(
    SolverConfig(backend="distributed", preprocess=False),
    ServiceConfig(max_batch=T.MAX_BATCH, fill_first=True,
                  quantize_buckets=False, log_every_s=float("inf")),
    distributed_ctx=make_batch_mesh({D}), clock=T.FakeClock(), log=None)
for v in T._drive(svc, T._stream())["values"]:
    v = complex(v)
    print(v.real.hex(), v.imag.hex())
"""


def _ref_procs() -> dict:
    procs = {}
    for d in (1, 2, 4):
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, ROOT]),
                   JAX_PLATFORMS="cpu",
                   XLA_FLAGS=f"--xla_force_host_platform_device_count={d}")
        procs[d] = subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(_REF.format(D=d))],
            env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    return procs


def _cli_procs(work: str) -> dict:
    """Both CLIs under torchrun, two CPU ranks each (``--sizes``: the
    launcher's own parser can read a script's ``--n`` as one of its
    flags)."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    run = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m"]
    tail = ["--device", "cpu", "--ranks-per-device", "2"]
    cmds = {
        "serve": [*run, "repro_torch.launch.serve", "--mesh", "2",
                  "--perm-n", "8", "--requests", "12", "--batch", "4",
                  *tail],
        "tune": [*run, "repro_torch.launch.tune", "--routes", "campaign",
                 "--sizes", "10", "--batch", "2", "--top-k", "1",
                 "--repeats", "1", "--out", os.path.join(work, "t.json"),
                 *tail]}
    return {k: subprocess.Popen(c, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
            for k, c in cmds.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("serve_mesh")
    os.makedirs(work / "cli")
    procs, clis = _ref_procs(), _cli_procs(str(work / "cli"))
    try:
        worlds = _run_worlds(str(work / "w"))
        refs = {}
        for d, p in procs.items():
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-3000:]
            refs[d] = [complex(float.fromhex(a), float.fromhex(b))
                       for a, b in (ln.split() for ln in
                                    out.strip().splitlines())]
        cli = {}
        for k, p in clis.items():
            out, _ = p.communicate(timeout=300)
            cli[k] = (p.returncode, out)
    finally:
        for p in [*procs.values(), *clis.values()]:
            if p.poll() is None:
                p.kill()
    return {"worlds": worlds, "refs": refs, "cli": cli,
            "table": str(work / "cli" / "t.json")}


@pytest.fixture
def mesh1():
    """A world of one rank in this process, destroyed after the test."""
    with M.world():
        yield M.make_batch_mesh(device="cpu")
    assert not torch.distributed.is_initialized()


def _one_device() -> dict:
    svc = PermanentService(_config("cuda"), _service_config(),
                           clock=FakeClock(), log=None)
    return _drive(svc, _stream())


def _rel(a, b) -> float:
    return abs(complex(a) - complex(b)) / abs(complex(b))


def _shard0(runs, d: int, mesh1, key: str = "serve"):
    if d == 1:
        return _serve_world(mesh1)
    ranks = runs["worlds"][d]
    assert all(r[key] is None for r in ranks[1:])   # followers hold nothing
    return ranks[0][key]


# ---------------------------------------------------------------------------
# the streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [1, 2, 4])
def test_bucket_members_equal_the_one_device_service(runs, d, request):
    mesh1 = request.getfixturevalue("mesh1") if d == 1 else None
    got, want = _shard0(runs, d, mesh1), _one_device()
    assert got["lone"] == want["lone"] and sum(got["lone"]) == 4
    from repro_torch.kernels import ops
    mats = _stream()
    for A, g, w, lone in zip(mats, got["values"], want["values"],
                             got["lone"]):
        assert type(g) is type(w)
        if not lone or A.shape[0] == N_SPARSE:
            assert g == w                    # the same entries, same bits
            continue
        # a lone dense request is a bucket of one over the mesh (the
        # reference's straggler rule: the scalar path there would be the
        # step-space split, another family): the batch entry's bits, the
        # one-device service's scalar entry within 1e-12
        assert g == ops.permanent_cuda_batched(A[None], device="cpu")[0]
        assert _rel(g, w) <= 1e-12
    # the same leaves as scalars over the mesh: permanent_on_mesh's bits
    # (one-device run_campaign at the world's decomposition)
    ts, cps, C = plan_slices(N_DENSE, d, 1, D.MESH_LANES)
    for i, v in zip(LONE_DENSE, got["split"]):
        on_mesh, _ = D.run_campaign(mats[i], total_slices=ts,
                                    chunks_per_slice=cps, chunk_size=C,
                                    device="cpu")
        assert v == on_mesh
        assert _rel(v, want["values"][i]) <= 1e-12


@pytest.mark.parametrize("d", [1, 2, 4])
def test_streams_agree_with_the_reference_service(runs, d, request):
    mesh1 = request.getfixturevalue("mesh1") if d == 1 else None
    got = _shard0(runs, d, mesh1)["values"]
    ref = runs["refs"][d]
    assert len(ref) == len(got) == 4 * PER_KEY
    for g, r in zip(got, ref):
        assert _rel(g, r) <= 1e-12, (g, r)


# ---------------------------------------------------------------------------
# the campaign on a 2 x 2 CampaignMesh, stopped and resumed at world 2
# ---------------------------------------------------------------------------

def _one_device_campaign():
    spec = _campaign_spec(None)
    svc = PermanentService(_config("distributed"), _service_config(),
                           campaign=spec, clock=FakeClock(), log=None)
    want, _ = D.run_campaign(spec.matrix, **svc.campaign_body())
    return want


def test_campaign_on_a_campaign_mesh_equals_one_device(runs):
    want = _one_device_campaign()
    value, fraction = _shard0(runs, 4, None, "campaign")
    assert fraction == 1.0 and value == want


def test_campaign_stopped_on_2x2_resumes_at_world_2_to_the_same_bits(runs):
    want = _one_device_campaign()
    value, fraction = _shard0(runs, 4, None, "stopped")
    assert value is None and 0.0 < fraction < 1.0
    value, fraction = _shard0(runs, 2, None, "resumed")
    assert fraction == 1.0 and value == want


# ---------------------------------------------------------------------------
# a failing dispatch, the tuner, the CLIs
# ---------------------------------------------------------------------------

def test_a_dispatch_failing_on_one_rank_sheds_its_tickets(runs):
    lead, follower = (r["failing"] for r in runs["worlds"][2])
    first, second = lead["status"][:MAX_BATCH], lead["status"][MAX_BATCH:]
    assert all(shed and reason is ShedReason.DISPATCH_FAILED
               for shed, reason, _ in first)
    assert any("shard(s) [1] failed" in detail for _, _, detail in first)
    assert not any(shed for shed, _, _ in second)
    assert lead["snapshot"]["shed"] == {"dispatch_failed": MAX_BATCH}
    assert lead["snapshot"]["completed"] == MAX_BATCH
    assert follower["follower"]["dispatches"] == 2
    assert follower["follower"]["failed"] == 1
    assert lead["seconds"] < WORLD_TIMEOUT_S / 4          # nothing hung
    svc = PermanentService(_config("cuda"), _service_config(),
                           clock=FakeClock(), log=None)
    ts = [svc.submit(A, deadline_s=None) for A in lead["mats"][MAX_BATCH:]]
    svc.drain()
    assert [t.result() for t in ts] == lead["values"][MAX_BATCH:]


def test_an_idle_shard_0_keeps_its_followers_alive(runs):
    lead, follower = (r["keepalive"] for r in runs["worlds"][2])
    assert lead == 0                          # nothing was served
    assert follower == {"dispatches": 0, "failed": 0, "keepalives": 3}


def test_tuner_over_a_world_of_two_agrees_on_every_rank(runs):
    from repro.tune.table import density_bucket, table_key
    tables = [r["tune"] for r in runs["worlds"][2]]
    assert tables[0] == tables[1]
    ((key, entry),), rows = tables[0]
    assert key == table_key("step_sharded", 10, density_bucket(1.0), "<f8",
                            "dq_acc", "cpu")
    assert entry["route"] == "step_sharded" and entry["n"] == 10
    assert all(ranks == 2 for _, ranks, _ in rows)


def test_clis_under_torchrun_with_two_ranks(runs):
    rc, out = runs["cli"]["serve"]
    assert rc == 0, out[-3000:]
    assert out.count("[serve] permanents: 12 reqs") == 1   # shard 0 prints
    assert "2-rank mesh" in out and "backend=distributed" in out
    rc, out = runs["cli"]["tune"]
    assert rc == 0, out[-3000:]
    assert out.count("entr(ies) ->") == 1 and "ranks=2" in out
    from repro_torch.tune.table import TuningTable
    assert len(TuningTable.load(runs["table"]).entries) == 1
