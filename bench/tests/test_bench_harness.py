"""The harness at tiny sizes on the program's CPU path: the window loops,
the result line, the readers, cells, a family and a loop added by files
alone, and the command's refusals."""

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from bench import byname, harness, readers, tracing
from bench.tests.fixture_root import REAL, add_extra, make_root

DEVICE_METRICS = {"dispatch_host_ms.calls", "kernel_roofline.campaign",
                  "kernel_roofline.calls", "device_idle.campaign",
                  "device_idle.calls"}
TINY = ["tiny_campaign", "tiny_amplitudes", "tiny_scalar"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("checkout"))


def _run(root, name, trace, seconds=0.3):
    cell = harness.load_cell(root, name)
    line, forbidden = harness.run(cell, 2 ** 31 + 99, seconds, trace, "cpu",
                                  time.time(), "cpu")
    return cell, line, forbidden


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", TINY)
def test_window_and_result_line(root, name, trace):
    cell, line, forbidden = _run(root, name, trace)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    kind = "per_layer" if trace else "end_to_end"
    wanted = {m["name"] for m in cell.metrics[kind]}
    got = set(line["metrics"])
    assert got <= wanted
    assert not got & DEVICE_METRICS          # no device metric off the card
    if not trace:
        assert got == wanted                 # every end-to-end metric
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    dev = line["device"]
    assert dev["platform"] == "cpu" and dev["count"] == cell.chips
    assert "busy_s" not in dev and "breakdown" not in line
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]
    json.dumps(line)


def test_window_ends_with_the_call_in_flight(root):
    cell = harness.load_cell(root, "tiny_scalar")
    solver = harness.make_solver(cell.config, "cpu")
    t = time.perf_counter()
    w = byname.loop(cell).window(cell, solver, 5, 0.2,
                                 tracing.Tracer(False), "cpu", str(root))
    assert 0.2 <= w.seconds <= time.perf_counter() - t
    assert len(w.values) == len(w.calls) == len(w.tokens) == w.attempted


def test_campaign_window_keeps_every_permanents_state(root):
    cell = harness.load_cell(root, "tiny_campaign")
    solver = harness.make_solver(cell.config, "cpu")
    w = byname.loop(cell).window(cell, solver, 5, 0.2,
                                 tracing.Tracer(False), "cpu", str(root))
    assert len(w.states) == len(w.values) == w.attempted >= 1
    hi, lo, done = w.states[0]
    assert done.all() and len(hi) == cell.config["solver"]["campaign_slices"]
    assert w.waves and all(k is None for _, k, _ in w.waves)  # no card
    assert not list(Path(root).glob("perm*.npz"))              # removed


def _view(**kw):
    base = dict(chips=1, setup_s=1.0,
                window_s=2.0, completed=10, calls=[(0.01, 0.09)] * 10,
                waves=[], traces=[None], peak=None)
    base.update(kw)
    return harness.View(**base)


def test_readers_give_nothing_without_a_device_reading():
    v = _view()
    for read in (readers.dispatch_host_ms, readers.kernel_roofline,
                 readers.device_idle, readers.campaign_overhead_share):
        assert read(v) is None


def test_readers_on_a_traced_view():
    trace = {"window_s": 2.0, "busy_s": 1.5, "ryser_s": 1.25}
    v = _view(traces=[trace, dict(trace, busy_s=1.0, ryser_s=0.75)],
              chips=2, peak=34e12, waves=[[(0.5, 0.4, 0.1)], [(0.6, 0.4, 0.0)]],
              traced_calls=10, traced_flops=34e12)
    assert readers.kernel_roofline(v) == pytest.approx(100.0 / 2.0)
    assert readers.device_idle(v) == pytest.approx(100 * (1 - 0.625))
    assert readers.campaign_overhead_share(v) == pytest.approx(100 * 0.1)
    assert readers.dispatch_host_ms(v) == pytest.approx((0.9 - 1.5) / 10 * 1e3)
    assert readers.perms_per_s(v) == 5.0 and readers.perm_time_s(v) == 0.2
    assert readers.call_p95_ms(v) == pytest.approx(100.0)
    assert readers.plan_ms(v) == pytest.approx(10.0)


def test_idle_gaps_are_named_by_the_innermost_host_event():
    host = [(0, 100, "bench.window"), (10, 40, "bench.plan"),
            (20, 30, "aten::copy_"), (50, 90, "bench.execute")]
    gaps = [(22, 28), (12, 18), (60, 70), (95, 99)]
    named = dict(tracing._name_gaps(gaps, host))
    assert named == {"aten::copy_": 6e-6, "bench.plan": 6e-6,
                     "bench.execute": 10e-6, "bench.window": 4e-6}


@pytest.fixture(scope="module")
def extended(tmp_path_factory):
    root = make_root(tmp_path_factory.mktemp("extended"))
    before = {p: p.read_bytes() for p in (root / "bench").rglob("*")
              if p.is_file()}
    add_extra(root)
    for p, body in before.items():
        assert p.read_bytes() == body        # nothing there was edited
    return root


@pytest.mark.parametrize("name", ["tiny_stack_kahan", "tiny_queue_gauss"])
def test_a_cell_is_added_by_files_and_entries_alone(extended, name):
    _, line, _ = _run(extended, name, False)
    assert {"setup_s", "perms_per_s", "call_p95_ms"} == set(line["metrics"])
    assert line["correct"] is True
    _, line, _ = _run(extended, name, True)
    assert set(line["metrics"]) == {"plan_share.calls"}


def test_a_family_and_a_loop_are_found_by_their_files(extended):
    """The added cell runs the fixture's own ``families/gaussian.py`` and
    ``loops/queue.py``, which no file of the benchmark names."""
    cell = harness.load_cell(extended, "tiny_queue_gauss")
    fam, loop = byname.family(cell), byname.loop(cell)
    assert Path(fam.__file__) == extended / "bench/families/gaussian.py"
    assert Path(loop.__file__) == extended / "bench/loops/queue.py"
    solver = harness.make_solver(cell.config, "cpu")
    w = loop.window(cell, solver, 11, None, tracing.Tracer(False), "cpu",
                    str(extended), items=3)
    assert w.attempted == len(w.values) == 3 and w.per_call == 6
    assert w.values[0].shape == (6,)
    w.values = [v * (1 + 1e-6) for v in w.values]     # altered answers
    from bench import check
    checks = check.judge(cell, w, 11, "cpu")
    assert checks and checks[0]["value"] > checks[0]["limit"]


@pytest.fixture
def no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal shows only without")


def _command(cwd: Path):
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "dense38_campaign",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=120)


def test_run_without_a_card_exits_nonzero_and_prints_no_result(no_card):
    out = _command(REAL)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "no CUDA card" in out.stderr


def test_run_in_a_directory_of_the_benchmark_alone_exits_nonzero(tmp_path):
    shutil.copy(REAL / "BENCHMARK.json", tmp_path)
    shutil.copytree(REAL / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _command(tmp_path)
    assert out.returncode != 0 and "{" not in out.stdout


def test_mesh_cell_on_two_cpu_ranks(tmp_path):
    root = make_root(tmp_path / "checkout")
    out = subprocess.run(
        [sys.executable, "-m", "bench.tests.faults", str(root),
         "tiny_campaign_mesh2", "none"],
        cwd=REAL, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == {"setup_s", "perm_time_s"}
