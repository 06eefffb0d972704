"""The port's always-on service (``repro_torch.serve``) against the
reference's (``repro.serve``): every case of ``tests/test_serve_loop.py``
run on the port, under the ``torch`` backend and the ``cuda`` backend on
the CPU (the kernels' plain versions), and the same seeded streams through
both services side by side.

Everything time-dependent runs against an injected FakeClock: deadline
expiry, lane ordering and log cadence are deterministic, never sleeps.
Value bars: a served value equals the port's own ``permanent`` /
``permanent_batch`` bit for bit (the service only routes matrices); the
port's values are within rtol 1e-12 of the reference's, the bar the
port's engines meet against the reference's jnp engines.
"""

import json
import os
import subprocess
import sys
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.solver import SolverConfig as RefSolverConfig  # noqa: E402
from repro.serve import PermanentService as RefService  # noqa: E402
from repro.serve import ServiceConfig as RefServiceConfig  # noqa: E402
from repro.serve import quantized_batches as ref_quantized  # noqa: E402
from repro_torch.core import distributed as Dm  # noqa: E402
from repro_torch.core.engine import permanent, permanent_batch  # noqa: E402
from repro_torch.core.solver import (PermanentSolver, SolverConfig,  # noqa: E402
                                     SolverError)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.serve import (DEFAULT_LANES, CampaignSpec, Histogram,  # noqa: E402
                               LaneQueue, LaneSpec, PermanentService,
                               ServiceConfig, ShedError, ShedReason,
                               compile_stats, quantized_batches, run_soak,
                               start_metrics_server)

REPO = os.path.join(os.path.dirname(__file__), "..")
RTOL_REF = 1e-12


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def mk(rng, n=5, complex_entries=False):
    M = rng.uniform(-1, 1, (n, n))
    if complex_entries:
        M = M + 1j * rng.uniform(-1, 1, (n, n))
    return M


@pytest.fixture(params=["torch", "cuda"])
def backend(request):
    """The port's two solver backends, on the CPU."""
    return request.param


def cfg(backend, **kw):
    return SolverConfig(backend=backend, device="cpu", **kw)


def service(clock, backend, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("log_every_s", float("inf"))
    return PermanentService(cfg(backend), ServiceConfig(**kw), clock=clock,
                            log=None)


def alone(M, backend):
    """The value the service must serve for M, bit for bit: a bucket of
    one through the same backend (the cuda backend's bucket entry runs the
    batched mode, its scalar entry the baseline mode, which agree to
    1e-12 only; the torch engine's bucket equals its scalar leaf)."""
    if backend == "torch":
        return permanent(M, backend="torch", device="cpu")
    v = permanent_batch([M], backend=backend, device="cpu")[0]
    return complex(v) if np.iscomplexobj(M) else float(v)


# -- lanes / priority ---------------------------------------------------------

class TestLanes:
    def test_interactive_preempts_bulk(self, backend):
        """A later interactive request dispatches before earlier bulk
        traffic of the same shape."""
        clock = FakeClock()
        svc = service(clock, backend, max_batch=2)
        rng = np.random.default_rng(0)
        bulk = [svc.submit(mk(rng), lane="bulk", deadline_s=None)
                for _ in range(3)]
        inter = svc.submit(mk(rng), lane="interactive", deadline_s=None)
        svc.step()                      # one bucket of 2
        assert inter.done
        # the interactive ticket took one slot; oldest bulk backfilled
        assert bulk[0].done and not bulk[1].done and not bulk[2].done
        svc.drain()
        assert all(t.done for t in bulk)

    def test_unknown_lane_rejected(self, backend):
        svc = service(FakeClock(), backend)
        with pytest.raises(ValueError, match="unknown lane"):
            svc.submit(np.eye(3), lane="nope")

    def test_lane_queue_priority_order(self):
        q = LaneQueue(DEFAULT_LANES)
        assert [l.name for l in q.lanes] == ["interactive", "bulk"]
        assert q.lane(None).name == "interactive"

    def test_values_match_scalar_engine(self, backend):
        """Continuous dispatch with pow2 padding serves each matrix's own
        value bit for bit (batch-shape independence + discarded pad)."""
        clock = FakeClock()
        svc = service(clock, backend, max_batch=4)
        rng = np.random.default_rng(1)
        mats = [mk(rng, n=6) for _ in range(5)]
        ts = [svc.submit(M, deadline_s=None) for M in mats]
        svc.drain()
        for t, M in zip(ts, mats):
            assert t.result() == alone(M, backend)
            assert t.result() == pytest.approx(
                permanent(M, device="cpu"), rel=1e-12)

    def test_complex_bucket(self, backend):
        clock = FakeClock()
        svc = service(clock, backend, max_batch=2)
        rng = np.random.default_rng(2)
        mats = [mk(rng, n=5, complex_entries=True) for _ in range(3)]
        ts = [svc.submit(M, deadline_s=None) for M in mats]
        svc.drain()
        for t, M in zip(ts, mats):
            assert t.result() == alone(M, backend)


# -- deadlines / shedding -----------------------------------------------------

class TestShedding:
    def test_deadline_expiry_sheds_with_reason(self, backend):
        clock = FakeClock()
        svc = service(clock, backend)
        t = svc.submit(np.eye(4), deadline_s=1.0)
        clock.t = 1.5
        svc.step()
        assert t.shed and t.shed_reason is ShedReason.DEADLINE_EXPIRED
        with pytest.raises(ShedError) as ei:
            t.result()
        assert ei.value.reason is ShedReason.DEADLINE_EXPIRED

    def test_lane_slo_is_default_deadline(self, backend):
        clock = FakeClock()
        svc = service(clock, backend)            # interactive slo_s=2.0
        t = svc.submit(np.eye(4), lane="interactive")
        clock.t = 2.1
        svc.step()
        assert t.shed and t.shed_reason is ShedReason.DEADLINE_EXPIRED

    def test_queue_full_backpressure(self, backend):
        clock = FakeClock()
        svc = service(clock, backend, max_queue_depth=2)
        rng = np.random.default_rng(3)
        ts = [svc.submit(mk(rng), deadline_s=None) for _ in range(3)]
        assert not ts[0].shed and not ts[1].shed
        assert ts[2].shed and ts[2].shed_reason is ShedReason.QUEUE_FULL
        assert "queue depth" in ts[2].shed_detail
        svc.drain()
        assert ts[0].done and ts[1].done

    def test_cost_budget_backpressure(self, backend):
        clock = FakeClock()
        svc = service(clock, backend, max_pending_cost=100.0)
        rng = np.random.default_rng(4)
        a = svc.submit(mk(rng, n=5), deadline_s=None)   # cost 5*16 = 80
        b = svc.submit(mk(rng, n=5), deadline_s=None)   # 160 > 100
        assert not a.shed
        assert b.shed and b.shed_reason is ShedReason.COST_BUDGET

    def test_shutdown_sheds_typed(self, backend):
        clock = FakeClock()
        svc = service(clock, backend)
        t = svc.submit(np.eye(4), deadline_s=None)
        (shed,) = svc.shutdown()
        assert shed is t and t.shed_reason is ShedReason.SHUTDOWN

    def test_result_before_dispatch_raises(self, backend):
        svc = service(FakeClock(), backend)
        t = svc.submit(np.eye(4), deadline_s=None)
        with pytest.raises(RuntimeError, match="still queued"):
            t.result()


# -- fill_first (solver-queue semantics) --------------------------------------

class TestFillFirst:
    def test_dispatch_only_when_full_or_aged(self, backend):
        clock = FakeClock()
        svc = service(clock, backend, max_batch=3, fill_first=True,
                      deadline_s=5.0, quantize_buckets=False,
                      lanes=(LaneSpec("default", 0, slo_s=None),))
        rng = np.random.default_rng(5)
        a = svc.submit(mk(rng), deadline_s=None)
        assert svc.step() == 0          # 1 of 3: waits
        b = svc.submit(mk(rng), deadline_s=None)
        assert svc.step() == 0
        c = svc.submit(mk(rng), deadline_s=None)
        assert svc.step() == 3          # full bucket dispatches
        assert a.done and b.done and c.done
        d = svc.submit(mk(rng), deadline_s=None)
        assert svc.step() == 0
        clock.t = 6.0                   # ... until the age trigger
        assert svc.step() == 1
        assert d.done

    def test_full_bucket_beats_older_partial(self, backend):
        """A full bucket dispatches even when an older, non-full bucket
        of another size sorts ahead of it."""
        clock = FakeClock()
        svc = service(clock, backend, max_batch=2, fill_first=True,
                      deadline_s=1e9, quantize_buckets=False,
                      lanes=(LaneSpec("default", 0, slo_s=None),))
        rng = np.random.default_rng(6)
        older = svc.submit(mk(rng, n=6), deadline_s=None)
        full = [svc.submit(mk(rng, n=7), deadline_s=None) for _ in range(2)]
        assert svc.step() == 2
        assert all(t.done for t in full) and not older.done

    def test_legacy_wrapper_matches_direct_solver_queue(self, backend):
        """run_permanent_serving over the service == driving the solver
        queue by hand, bitwise."""
        from repro_torch.launch.serve import run_permanent_serving

        out = run_permanent_serving(n=6, batch=4, requests=10,
                                    repeat_pool=3, deadline_s=1e9, seed=11,
                                    backend=backend, device="cpu")
        # reference: the solver queue directly, same stream construction
        rng = np.random.default_rng(11)
        pool = [rng.uniform(-1, 1, (6, 6)) for _ in range(3)]
        mats = [pool[i] for i in rng.integers(0, 3, 10)]
        solver = PermanentSolver(cfg(backend, queue_max_batch=4,
                                     queue_max_delay_s=1e9))
        reqs = [solver.submit(M) for M in mats]
        solver.flush()
        ref = np.array([r.result() for r in reqs])
        assert np.array_equal(out["values"], ref)
        assert out["batches"] == 3      # 2 full + ragged tail
        snap = out["snapshot"]
        assert snap["requests"]["completed"] == 10
        assert snap["requests"]["shed_total"] == 0


# -- metrics ------------------------------------------------------------------

class TestMetrics:
    def test_histogram_quantiles(self):
        h = Histogram(lo=1e-3, hi=1e3)
        for v in [0.01] * 98 + [5.0, 8.0]:
            h.observe(v)
        assert h.count == 100
        assert h.quantile(0.5) <= 0.02
        assert 5.0 <= h.quantile(0.99) <= 8.0
        assert h.to_json()["max"] == 8.0

    def test_snapshot_schema_and_consistency(self, backend):
        clock = FakeClock()
        svc = service(clock, backend, max_queue_depth=3)
        rng = np.random.default_rng(7)
        for i in range(5):
            svc.submit(mk(rng), lane="bulk" if i % 2 else "interactive",
                       deadline_s=None if i != 1 else 0.0)
        clock.t = 0.5
        svc.drain()
        snap = svc.snapshot()
        assert snap["schema"] == "repro.serve.metrics/v1"
        req = snap["requests"]
        assert req["admitted"] == (req["completed"] + req["shed_total"]
                                   + req["pending"])
        assert req["pending"] == 0
        # depth cap 3: submits 4 and 5 bounce; submit 2 expires queued
        assert req["shed"] == {"deadline_expired": 1, "queue_full": 2}
        assert snap["latency_s"]["overall"]["count"] == req["completed"]
        assert "interactive" in snap["latency_s"]
        assert snap["queue_depth"]["count"] >= 1
        assert snap["dispatches"] >= 1
        # the solver's stats (incl. per-leaf timings) come through whole
        assert snap["solver"]["device_dispatches"] >= 1
        assert any(k.startswith("dense_batch(")
                   for k in snap["solver"]["leaf_timings"])
        json.dumps(snap)                # JSON-clean end to end

    def test_leaf_timing_shape(self, backend):
        clock = FakeClock()
        svc = service(clock, backend)
        svc.submit(np.random.default_rng(8).uniform(-1, 1, (5, 5)),
                   deadline_s=None)
        svc.drain()
        (key, t), *_ = svc.solver.stats()["leaf_timings"].items()
        assert set(t) == {"count", "leaves", "total_s", "max_s", "mean_s"}
        assert t["count"] >= 1 and t["total_s"] > 0

    def test_metrics_http_endpoint(self, backend):
        clock = FakeClock()
        svc = service(clock, backend)
        server = start_metrics_server(svc.snapshot, port=0)
        try:
            port = server.server_address[1]
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/metrics", timeout=5) as r:
                snap = json.loads(r.read())
            assert snap["schema"] == "repro.serve.metrics/v1"
        finally:
            server.shutdown()

    def test_periodic_log_line(self, backend):
        clock = FakeClock()
        lines = []
        svc = PermanentService(
            cfg(backend), ServiceConfig(max_batch=2, log_every_s=10.0),
            clock=clock, log=lines.append)
        svc.submit(np.eye(3), deadline_s=None)
        svc.step()
        assert not lines                # cadence not reached
        clock.t = 11.0
        svc.step()
        assert len(lines) == 1 and "p99=" in lines[0]


# -- solver-layer satellites --------------------------------------------------

class TestSolverSatellites:
    def test_solver_error_names_bucket_and_count(self, backend,
                                                 monkeypatch):
        solver = PermanentSolver(cfg(backend, queue_max_batch=100))
        req = solver.submit(np.eye(4))
        monkeypatch.setattr(solver, "_flush_bucket", lambda n: 0)
        with pytest.raises(SolverError, match=r"n=4 left 1 request"):
            req.result()

    def test_solver_config_clock_injected(self, backend):
        clock = FakeClock()
        solver = PermanentSolver(cfg(backend, clock=clock,
                                     queue_max_batch=100,
                                     queue_max_delay_s=2.0))
        req = solver.submit(np.eye(3))
        assert solver.poll() == 0
        clock.t = 2.5
        assert solver.poll() == 1 and req.done

    def test_solver_config_clock_excluded_from_json(self, backend):
        c = cfg(backend, clock=FakeClock())
        plan = PermanentSolver(c).plan(np.eye(3))
        js = plan.to_json()              # dict; must be json-clean
        assert "clock" not in js["config"]
        json.dumps(js)
        # and the clock doesn't break plan equality/fingerprints
        assert c.replace(clock=None) == c

    def test_admission_hooks_fire(self, backend):
        seen = {"submit": 0, "flush": []}
        solver = PermanentSolver(cfg(backend, queue_max_batch=2))
        solver.on_submit = lambda req: seen.__setitem__(
            "submit", seen["submit"] + 1)
        solver.on_flush = lambda n, served, dt: seen["flush"].append(
            (n, served, dt >= 0))
        solver.submit(np.eye(4))
        solver.submit(np.eye(4))        # fills the bucket -> flush
        assert seen["submit"] == 2
        assert seen["flush"] == [(4, 2, True)]


# -- soak helper --------------------------------------------------------------

class TestSoak:
    def test_run_soak_deterministic_clock(self, backend):
        """Open-loop soak under a fake clock: every request resolves or
        sheds, forced expiries land as typed deadline sheds."""
        clock = FakeClock()
        svc = service(clock, backend, max_batch=4)
        out = run_soak(svc, requests=12, rate_hz=1000.0, n=5,
                       repeat_pool=3, seed=9, expire_every=4, sleep=None)
        snap = out["snapshot"]
        req = snap["requests"]
        assert req["admitted"] == 12 + 0
        assert req["shed"] == {"deadline_expired": 3}
        assert req["completed"] == 9 and req["pending"] == 0
        assert snap["solver"]["cache"]["hits"] > 0   # repeat pool
        statuses = [("shed" if t.shed else "done") for t in out["tickets"]]
        assert statuses.count("shed") == 3

    def test_quantized_ladder(self):
        assert quantized_batches(8) == (1, 2, 4, 8)
        assert quantized_batches(6) == (1, 2, 4, 8)
        assert quantized_batches(1) == (1,)
        with pytest.raises(ValueError):
            quantized_batches(0)
        for b in (1, 2, 3, 6, 8, 33, 64, 100):
            assert quantized_batches(b) == ref_quantized(b)


# -- cold start / kernel-library cache ----------------------------------------

_SUB = r"""
import json, sys
import numpy as np
from repro_torch.core.solver import SolverConfig
from repro_torch.serve import PermanentService, ServiceConfig, compile_stats

svc = PermanentService(
    SolverConfig(device="cpu"),
    ServiceConfig(max_batch=4, compile_cache_dir=sys.argv[1],
                  warmup_ns=(6,), log_every_s=float("inf")),
    log=None)
warm = svc.warmup_report["compile"]
s0 = compile_stats()
t = svc.submit(np.random.default_rng(0).uniform(-1, 1, (6, 6)),
               deadline_s=None)
svc.step()
assert t.done
s1 = compile_stats()
print("STATS", json.dumps({"warm": warm, "first_misses":
      s1["persistent_misses"] - s0["persistent_misses"],
      "snapshot": svc.snapshot()["compile_cache"]}))
"""


def test_warm_compile_cache_cold_start(tmp_path, monkeypatch):
    """Two cold processes sharing a kernel-library root: on the CPU no
    wrapper loads the library, so both warm up and serve their first
    bucket with every counter at zero (the card's run of this property is
    chip_smoke.py's serve phase).  In process, with the build and the load
    stubbed: the first load from an empty root builds (a miss), a later
    process's load finds the library there (a hit)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    for _ in range(2):
        r = subprocess.run([sys.executable, "-c", _SUB,
                            str(tmp_path / "cache")], env=env,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
        stats = json.loads(next(line for line in r.stdout.splitlines()
                                if line.startswith("STATS "))[6:])
        zero = {"requests": 0, "persistent_hits": 0, "persistent_misses": 0}
        assert stats["warm"] == zero and stats["snapshot"] == zero
        assert stats["first_misses"] == 0

    old_root = build.build_dir().parent
    built = []

    def fake_compile(out_dir):
        out_dir.mkdir(parents=True)
        (out_dir / "libryser.so").write_bytes(b"")
        built.append(out_dir)
        return out_dir / "libryser.so"

    monkeypatch.setattr(build, "_compile", fake_compile)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: path)
    monkeypatch.setattr(build, "_bind", lambda lib: lib)
    monkeypatch.setattr(build, "_loads", dict.fromkeys(build._loads, 0))
    monkeypatch.setattr(build, "_lib", None)
    from repro_torch.serve import enable_compile_cache
    try:
        enable_compile_cache(str(tmp_path / "root"))
        assert build.build_dir().parent == tmp_path / "root"
        first = build.load_library()             # cold root: nvcc
        assert build.load_library() == first     # loaded once a process
        monkeypatch.setattr(build, "_lib", None)  # a new process
        assert build.load_library() == first
        assert built == [build.build_dir()]
        assert compile_stats() == {"requests": 2, "persistent_hits": 1,
                                   "persistent_misses": 1}
    finally:
        build.set_build_root(old_root)


def test_campaign_backend_follows_solver_config(monkeypatch):
    """The service's campaign waves run under the solver's configured
    backend: cuda -> the CUDA wave body, torch -> the torch engine."""
    captured = {}

    def fake_run_campaign(A, **kw):
        captured.update(kw)
        return 1.0, None

    monkeypatch.setattr(Dm, "run_campaign", fake_run_campaign)
    rng = np.random.default_rng(0)
    for solver_backend, expect in (("cuda", "cuda"), ("torch", "torch")):
        svc = PermanentService(
            cfg(solver_backend),
            ServiceConfig(max_batch=2, log_every_s=float("inf")),
            campaign=CampaignSpec(matrix=mk(rng, 8), waves=1),
            clock=FakeClock(), log=None)
        captured.clear()
        svc._advance_campaign(1)
        assert captured["backend"] == expect, solver_backend
        assert captured["precision"] == svc.solver.config.precision
        assert captured["device"] == "cpu"
        assert captured["max_waves"] == 1


# -- the port's own: held against the reference, campaign, mesh, no card -----

def _mixed_stream(seed: int, count: int):
    """(matrix, lane, deadline_s) of a seeded mixed stream: dense real,
    dense complex and sparse (density 0.2) requests at n = 5-7, lanes
    alternating, every 5th request expired on arrival (as ``run_soak``'s
    ``expire_every``) and every 7th with a deadline that passes at t = 1
    if it is still queued then."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        n = 5 + i % 3
        kind = i % 3
        M = rng.uniform(-1, 1, (n, n))
        if kind == 1:
            M = M + 1j * rng.uniform(-1, 1, (n, n))
        elif kind == 2:
            M = M * (rng.uniform(0, 1, (n, n)) < 0.2) + np.eye(n)
        dl = -1.0 if i % 5 == 4 else 0.5 if i % 7 == 6 else None
        out.append((M, ("interactive", "bulk")[i % 2], dl))
    return out


def _drive(svc, clock, stream):
    """Submit the stream two at a time, a loop step after each pair; at
    t = 1 the short deadlines have passed; then drain."""
    tickets = []
    for i, (M, lane, dl) in enumerate(stream):
        tickets.append(svc.submit(M, lane=lane, deadline_s=dl))
        if i % 2:
            svc.step()
        if i == len(stream) // 2:
            clock.t = 1.0
    svc.drain()
    return tickets


def _keys(d, depth=2):
    if not isinstance(d, dict) or depth == 0:
        return None
    return {k: _keys(v, depth - 1) for k, v in d.items()
            if k != "leaf_timings"}


@pytest.mark.parametrize("fill_first", [False, True])
def test_service_held_against_reference(backend, fill_first):
    """The same seeded stream through the reference's service (jnp) and
    the port's, under the same ServiceConfig: the same tickets resolve,
    with the same shed reasons and the same dispatches, values within
    rtol 1e-12; the snapshots have the same keys."""
    kw = dict(max_batch=4, log_every_s=float("inf"), max_queue_depth=20,
              fill_first=fill_first, deadline_s=0.25,
              quantize_buckets=not fill_first)
    stream = _mixed_stream(21, 30)
    ref_clock, clock = FakeClock(), FakeClock()
    ref = RefService(RefSolverConfig(backend="jnp"), RefServiceConfig(**kw),
                     clock=ref_clock, log=None)
    svc = PermanentService(cfg(backend), ServiceConfig(**kw), clock=clock,
                           log=None)
    want = _drive(ref, ref_clock, stream)
    got = _drive(svc, clock, stream)
    assert [t.status for t in got] == [t.status for t in want]
    def reasons(ts):
        return [t.shed_reason and t.shed_reason.value for t in ts]

    assert reasons(got) == reasons(want)
    assert any(t.shed for t in got) and any(t.done for t in got)
    assert [(k, s, trig) for k, s, _, trig in svc.dispatch_log] == \
        [(k, s, trig) for k, s, _, trig in ref.dispatch_log]
    for a, b in zip(got, want):
        if b.done:
            np.testing.assert_allclose(a.result(), b.result(),
                                       rtol=RTOL_REF, atol=1e-300)
    assert _keys(svc.snapshot()) == _keys(ref.snapshot())
    assert svc.snapshot()["requests"] == ref.snapshot()["requests"]


def test_compile_counters_stay_zero_on_cpu(tmp_path):
    """On the CPU the wrappers run the plain versions: the kernel library
    is never loaded, so a service with a cache root and a warm-up reports
    zero loads, and the root moved and is restored."""
    old_root = build.build_dir().parent
    try:
        svc = PermanentService(
            cfg("cuda"), ServiceConfig(max_batch=2, warmup_ns=(5,),
                                       warmup_complex=True,
                                       compile_cache_dir=str(tmp_path),
                                       log_every_s=float("inf")),
            clock=FakeClock(), log=None)
        assert build.build_dir().parent == tmp_path
        assert svc.warmup_report["geometries"] == 4      # (1, 2) x 2
        svc.submit(mk(np.random.default_rng(3)), deadline_s=None)
        svc.drain()
        zero = {"requests": 0, "persistent_hits": 0, "persistent_misses": 0}
        assert svc.warmup_report["compile"] == zero
        assert svc.snapshot()["compile_cache"] == zero == compile_stats()
    finally:
        build.set_build_root(old_root)


@pytest.mark.parametrize("cplx", [False, True])
def test_campaign_interleaving_equals_run_campaign(backend, cplx):
    """A campaign threaded through the loop (one wave a dispatch, then run
    out by drain) ends on run_campaign's value at the same spec, bit for
    bit, and within 1e-12 of the port's direct permanent."""
    rng = np.random.default_rng(31)
    C = mk(rng, n=9, complex_entries=cplx)
    svc = PermanentService(
        cfg(backend), ServiceConfig(max_batch=2, log_every_s=float("inf")),
        campaign=CampaignSpec(matrix=C, waves=1, slices=8, lanes=16),
        clock=FakeClock(), log=None)
    assert svc.campaign_fraction == 0.0
    ts = [svc.submit(mk(rng), deadline_s=None) for _ in range(4)]
    svc.step()
    assert 0.0 < svc.campaign_fraction < 1.0 and svc.campaign_value is None
    svc.drain()
    assert all(t.done for t in ts) and svc.campaign_fraction == 1.0
    want, _ = Dm.run_campaign(C, **svc.campaign_body())
    assert svc.campaign_value == want
    assert svc.campaign_value == pytest.approx(
        permanent(C, backend="torch", device="cpu"), rel=1e-12)


def test_campaign_mesh_not_ported():
    # the mesh functions are ported; the service over a mesh is item 8
    with pytest.raises(NotImplementedError, match="item 8"):
        CampaignSpec(matrix=np.eye(4), mesh=object())
    assert CampaignSpec(matrix=np.eye(4)).slices == \
        SolverConfig().campaign_slices == 1024


def test_service_without_card_raises(monkeypatch):
    """A service asked for the card on a machine without one raises at
    construction; nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for backend in ("cuda", "torch"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            PermanentService(SolverConfig(backend=backend),
                             ServiceConfig(), log=None)
    from repro_torch.launch.serve import serve_main
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_main(["--soak", "--perm-n", "5", "--requests", "2"])
