"""The port's kernel-geometry tuner against the reference's
(``tests/test_tune.py``'s cases on ``repro_torch.tune``) and its planner
resolution side by side with the reference planner's.

Everything runs on the CPU: the tuner measures the plain versions
(``device="cpu"``), the planner resolves the table's ``cpu`` or ``any``
entries, and tuned plans execute through the plain versions, held within
1e-12 of the reference's interpret-mode kernels at the same geometry.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import planner as RPL  # noqa: E402
from repro.core import solver as RSOL  # noqa: E402
from repro.core.stepspace import Geometry as RG  # noqa: E402
from repro.tune import table as RT  # noqa: E402
from repro_torch.analysis.geometry import (SMEM_PER_BLOCK,  # noqa: E402
                                           block_smem_bytes, validate_tiling)
from repro_torch.core.planner import (SolverConfig, _resolve_geometry,  # noqa: E402
                                      build_plan)
from repro_torch.core.solver import PermanentSolver  # noqa: E402
from repro_torch.core.stepspace import DEFAULT_GEOMETRY, Geometry  # noqa: E402
from repro_torch.tune.search import (enumerate_candidates,  # noqa: E402
                                     model_cost, tune_key)
from repro_torch.tune.table import (TABLE_FORMAT_VERSION, TableEntry,  # noqa: E402
                                    TuningTable, density_bucket,
                                    kernel_sources_hash, table_key)
from repro_torch.utils.roofline import HW_SPECS, detect_hw, get_hw  # noqa: E402

REPO = os.path.join(os.path.dirname(__file__), "..")
G_TUNED = Geometry(64, 32, 8)
CPU = get_hw("cpu")


def _entry(route="dense", n=12, bucket="1.00", dtype="<f8",
           precision="dq_acc", device_kind="any", geometry=G_TUNED):
    return TableEntry(route=route, n=n, density_bucket=bucket, dtype=dtype,
                      precision=precision, device_kind=device_kind,
                      geometry=geometry, predicted_s=2e-3, measured_s=1e-3,
                      default_s=1.5e-3)


def _saved(tmp_path, *entries, name="t.json"):
    table = TuningTable()
    for e in entries or (_entry(),):
        table.put(e)
    p = str(tmp_path / name)
    table.save(p)
    return p, table


def _edit(p, fn):
    doc = json.load(open(p))
    fn(doc)
    json.dump(doc, open(p, "w"))


# ---------------------------------------------------------------------------
# Geometry + table round-trip
# ---------------------------------------------------------------------------

def test_geometry_tag_roundtrip():
    assert DEFAULT_GEOMETRY.tag() == "128x64x16"
    for g in (DEFAULT_GEOMETRY, G_TUNED, Geometry(8, 8, 8, max_blocks=4)):
        assert Geometry.from_tag(g.tag()) == g


def test_table_roundtrip(tmp_path):
    table = TuningTable()
    table.put(_entry())
    table.put(_entry(route="sparse", bucket="0.25",
                     geometry=Geometry(32, 64, 8)))
    p = str(tmp_path / "t.json")
    table.save(p)
    back = TuningTable.load(p)
    assert back.entries == table.entries
    assert back.kernels_hash == kernel_sources_hash()
    e = back.get("dense", 12, 1.0, "<f8", "dq_acc", device_kind="cpu")
    assert e is not None and e.geometry == G_TUNED
    assert e.speedup == pytest.approx(1.5)
    assert e.mispredict_ratio == pytest.approx(2.0)
    assert json.load(open(p))["format"] == "repro_torch.tune.table/v1"


def test_table_rejects_version_skew(tmp_path):
    p, _ = _saved(tmp_path)
    _edit(p, lambda d: d.update(version=TABLE_FORMAT_VERSION + 1))
    with pytest.raises(ValueError, match="format version"):
        TuningTable.load(p)


def test_table_rejects_kernel_source_drift(tmp_path):
    # winners measured against other kernel bodies are stale: loud error,
    # with an explicit opt-out for inspection tooling
    p, _ = _saved(tmp_path)
    _edit(p, lambda d: d.update(kernels_hash="deadbeefdeadbeef"))
    with pytest.raises(ValueError, match="kernel sources changed"):
        TuningTable.load(p)
    assert TuningTable.load(p, strict_hash=False).entries


def test_kernel_hash_covers_glue_sources_and_flags(monkeypatch):
    """The hash moves with the .py glue, the CUDA sources and the nvcc
    flags (build.py's source hash), so a table goes stale with the
    compiled library."""
    from repro_torch.kernels import build
    base = kernel_sources_hash()
    build._source_hash.cache_clear()
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    try:
        assert kernel_sources_hash() != base
    finally:
        build._source_hash.cache_clear()
    monkeypatch.undo()
    assert kernel_sources_hash() == base


@pytest.mark.parametrize("geometry", ["7x5x3", "512x64x16", "128x4096x4096"])
def test_table_rejects_pl007_violating_entry(tmp_path, geometry):
    # a hand-edited table cannot smuggle a geometry the CUDA entries
    # refuse (not a power of two; TB 512 > 256 threads; a window whose
    # shared memory exceeds the 227 KB opt-in) into the planner
    p, _ = _saved(tmp_path, _entry(n=30))
    _edit(p, lambda d: d["entries"][0].update(geometry=geometry))
    with pytest.raises(ValueError, match="PL007"):
        TuningTable.load(p)


def test_validate_tiling_limits():
    assert validate_tiling(24, 128, 64, 16) == []
    assert any("256" in v for v in validate_tiling(30, 512, 64, 16))
    assert any("opt-in" in v for v in validate_tiling(40, 128, 4096, 4096))
    assert validate_tiling(2, 8, 8, 8) and validate_tiling(65, 8, 8, 8)
    # the largest mode (split-plane sparse) at NPAD 64 and the grid's
    # largest TB and window fits Hopper's opt-in
    assert block_smem_bytes(64, 256, 32) <= SMEM_PER_BLOCK
    assert block_smem_bytes(24, 128, 16, "dense") == \
        8 * (24 * 24 + 24 * 15 + 2 * 128)


def test_density_bucketing():
    assert density_bucket(0.05) == "0.25"
    assert density_bucket(0.25) == "0.25"
    assert density_bucket(0.26) == "0.50"
    assert density_bucket(0.80) == "1.00"
    assert density_bucket(1.00) == "1.00"


def test_density_bucket_and_key_equal_reference():
    for d in np.linspace(0.0, 1.2, 241):
        assert density_bucket(d) == RT.density_bucket(d)
    for args in (("dense", 12, "1.00", "<f8", "dq_acc", "cpu"),
                 ("sparse", 24, "0.25", "<c16", "kahan", "any"),
                 ("step_sharded", 34, "1.00", "<f8", "dd", "nvidia h100")):
        assert table_key(*args) == RT.table_key(*args)


def test_table_device_kind_wildcard():
    table = TuningTable()
    table.put(_entry(device_kind="any"))
    # a concrete card kind falls back to the "any" wildcard row
    assert table.resolve("dense", 12, 1.0, "<f8", "dq_acc",
                         device_kind="nvidia h100 80gb hbm3") == G_TUNED
    assert table.resolve("dense", 13, 1.0, "<f8", "dq_acc",
                         device_kind="cpu") is None
    table.put(_entry(device_kind="cpu", geometry=Geometry(32, 32, 8)))
    assert table.resolve("dense", 12, 1.0, "<f8", "dq_acc",
                         device_kind="cpu") == Geometry(32, 32, 8)


def test_reference_table_is_refused(tmp_path):
    p = str(tmp_path / "ref.json")
    ref = RT.TuningTable()
    ref.put(RT.TableEntry(route="dense", n=12, density_bucket="1.00",
                          dtype="<f8", precision="dq_acc", device_kind="any",
                          geometry=RG(64, 32, 8), predicted_s=2e-3,
                          measured_s=1e-3, default_s=1.5e-3))
    ref.save(p)
    with pytest.raises(ValueError, match="not the port's"):
        TuningTable.load(p)
    # and the other way round: the reference refuses the port's table
    q, _ = _saved(tmp_path, name="port.json")
    with pytest.raises(ValueError):
        RT.TuningTable.load(q)


# ---------------------------------------------------------------------------
# candidate enumeration + cost model
# ---------------------------------------------------------------------------

def test_enumerate_candidates_valid_and_deduped():
    for n in (8, 12, 16, 24):
        cands = enumerate_candidates(n)
        assert cands[0] == DEFAULT_GEOMETRY
        resolved = set()
        for g in cands:
            assert validate_tiling(n, g.lanes, g.steps_per_chunk,
                                   g.window) == []
            resolved.add(g.kernel_geometry(n))
        assert len(resolved) == len(cands), "clamped duplicates survived"


def test_model_cost_orders_sanely():
    # monotone in n and batch; complex costs more than real; sparse less
    # at low density; f32 less than f64 -- the model only RANKS
    g = DEFAULT_GEOMETRY
    cost = lambda *a, **k: model_cost(*a, hw=CPU, **k)  # noqa: E731
    assert cost(g, 16) > cost(g, 12)
    assert cost(g, 12, batch=64) > cost(g, 12, batch=1)
    assert cost(g, 12, route="complex") > cost(g, 12)
    assert cost(g, 12, route="sparse", density=0.2) \
        < cost(g, 12, route="sparse", density=1.0)
    assert cost(g, 24, batch=256, dtype="<f4") < cost(g, 24, batch=256)
    # a launch with fewer CTAs than the card has slots pays a tail
    assert cost(g, 24, batch=1, ctas_per_sm=64) == \
        cost(g, 24, batch=1, ctas_per_sm=1)
    card = HW_SPECS["h100-sxm"]
    full = model_cost(g, 24, batch=256, hw=card, ctas_per_sm=3)
    ragged = model_cost(g, 24, batch=256, hw=card, ctas_per_sm=5)
    assert ragged > full    # 6 waves of 660 CTAs for 4096 vs 11 of 396


def test_tune_key_on_the_cpu_measures_the_default_and_never_loses():
    entry, rows = tune_key("dense", 12, batch=2, top_k=3, repeats=1,
                           device="cpu", hw=CPU)
    tags = [r["geometry"] for r in rows]
    assert DEFAULT_GEOMETRY.tag() in tags and len(tags) >= 2
    assert len({tuple(r["launch"]) for r in rows}) == len(rows)
    assert entry.measured_s <= entry.default_s and entry.speedup >= 1.0
    assert entry.device_kind == "cpu" and entry.route == "dense"
    assert entry.predicted_s == next(r["modeled_s"] for r in rows
                                     if r["geometry"] == entry.geometry.tag())


# ---------------------------------------------------------------------------
# planner resolution: config override > table hit > defaults
# ---------------------------------------------------------------------------

def test_resolve_precedence(tmp_path):
    p, _ = _saved(tmp_path)
    over = Geometry(8, 8, 8)
    cfg = dict(device="cpu")
    # explicit config override wins even over a table hit
    assert _resolve_geometry(
        SolverConfig(geometry=over, tuning_table=p, **cfg),
        "dense", 12, 1.0, "<f8", "dq_acc") == over
    # table hit
    assert _resolve_geometry(
        SolverConfig(tuning_table=p, **cfg),
        "dense", 12, 1.0, "<f8", "dq_acc") == G_TUNED
    # no table, no override: kernel defaults (None)
    assert _resolve_geometry(
        SolverConfig(**cfg), "dense", 12, 1.0, "<f8", "dq_acc") is None
    # campaign wave bodies fall back to the dense entry
    assert _resolve_geometry(
        SolverConfig(tuning_table=p, **cfg),
        "step_sharded", 12, 1.0, "<f8", "dq_acc") == G_TUNED


def test_resolve_missing_table_is_loud(tmp_path):
    cfg = SolverConfig(tuning_table=str(tmp_path / "nope.json"),
                       device="cpu")
    with pytest.raises(OSError):
        _resolve_geometry(cfg, "dense", 12, 1.0, "<f8", "dq_acc")


def test_resolve_without_a_card_raises(tmp_path, monkeypatch):
    """The table's device kind is the card's unless the plan asks for the
    CPU; with no card that raises, as every entry does."""
    from repro_torch.tune import table as TT
    p, _ = _saved(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    TT._device_kind.cache_clear()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _resolve_geometry(SolverConfig(tuning_table=p), "dense", 12, 1.0,
                          "<f8", "dq_acc")


# ---------------------------------------------------------------------------
# geometry is part of plan identity
# ---------------------------------------------------------------------------

def test_plan_records_geometry_in_identity(tmp_path):
    A = np.random.default_rng(0).uniform(0.2, 1.0, (8, 8))
    base = dict(backend="cuda", preprocess=False, device="cpu")
    plain = build_plan([A], SolverConfig(**base), batched=True)
    tuned = build_plan([A], SolverConfig(geometry=G_TUNED, **base),
                       batched=True)
    assert plain.leaves[0].geometry is None
    assert tuned.leaves[0].geometry == G_TUNED
    # fingerprint and --plan-json both carry the resolved geometry
    assert plain.fingerprint() != tuned.fingerprint()
    leaf_json = tuned.to_json()["leaves"][0]
    assert leaf_json["geometry"] == G_TUNED.tag()
    assert plain.to_json()["leaves"][0]["geometry"] is None
    # two distinct geometries are two distinct identities
    tuned2 = build_plan([A], SolverConfig(geometry=Geometry(8, 8, 8),
                                          **base), batched=True)
    assert tuned2.fingerprint() != tuned.fingerprint()
    # the torch backend never carries geometry, even when configured
    torch_plan = build_plan([A], SolverConfig(
        geometry=G_TUNED, preprocess=False, backend="torch", device="cpu"),
        batched=True)
    assert torch_plan.leaves[0].geometry is None
    # a table hit is an identity of its own, as an explicit geometry is
    p, _ = _saved(tmp_path, _entry(n=8))
    from_table = build_plan([A], SolverConfig(tuning_table=p, **base),
                            batched=True)
    assert from_table.fingerprint() == tuned.fingerprint()


# ---------------------------------------------------------------------------
# side by side with the reference planner
# ---------------------------------------------------------------------------

def _tables(tmp_path, specs):
    """The same entries in a port table and a reference table:
    (route, n, bucket, dtype, device_kind, (lanes, spc, window))."""
    port, ref = TuningTable(), RT.TuningTable()
    for route, n, bucket, dtype, kind, g in specs:
        port.put(_entry(route=route, n=n, bucket=bucket, dtype=dtype,
                        device_kind=kind, geometry=Geometry(*g)))
        ref.put(RT.TableEntry(route=route, n=n, density_bucket=bucket,
                              dtype=dtype, precision="dq_acc",
                              device_kind=kind, geometry=RG(*g),
                              predicted_s=2e-3, measured_s=1e-3,
                              default_s=1.5e-3))
    p, q = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    port.save(p)
    ref.save(q)
    return p, q


def _sparse(rng, n, density=0.2):
    A = rng.uniform(0.5, 1.5, (n, n)) * (rng.uniform(size=(n, n)) < density)
    np.fill_diagonal(A, 1.0)
    return A


TABLE_SPECS = (("dense", 9, "1.00", "<f8", "any", (32, 32, 8)),
               ("dense", 10, "1.00", "<c16", "cpu", (64, 8, 4)),
               ("sparse", 10, "0.25", "<f8", "any", (16, 16, 8)),
               ("step_sharded", 11, "1.00", "<f8", "cpu", (32, 64, 8)),
               ("dense", 12, "1.00", "<f8", "any", (64, 32, 16)))


def test_planner_resolves_the_reference_planners_geometries(tmp_path):
    """Same matrices, same entries: the same per-leaf routes and geometry
    tags as the reference planner, dense, sparse, complex and campaign (a
    leaf over the threshold, whose step_sharded entry or dense fallback
    lands on its CampaignSpec)."""
    p, q = _tables(tmp_path, TABLE_SPECS)
    rng = np.random.default_rng(7)
    mats = [rng.uniform(-1, 1, (9, 9)), rng.uniform(-1, 1, (9, 9)),
            _sparse(rng, 10), rng.uniform(-1, 1, (13, 13)),
            rng.uniform(-1, 1, (10, 10)) * (1 + 1j)]
    for batched in (True, False):
        for thr, picked in ((None, mats), (3000.0, [mats[0], mats[3]]),
                            (30000.0, [rng.uniform(-1, 1, (11, 11)),
                                       rng.uniform(-1, 1, (12, 12))])):
            cfg = dict(preprocess=False, campaign_threshold=thr)
            got = build_plan(picked, SolverConfig(
                backend="cuda", device="cpu", tuning_table=p, **cfg),
                batched=batched)
            want = RPL.build_plan(picked, RPL.SolverConfig(
                backend="pallas", tuning_table=q, **cfg), batched=batched)

            def tags(plan):
                return [(l.route, l.n,
                         l.geometry.tag() if l.geometry else None,
                         l.campaign.geometry.tag()
                         if l.campaign and l.campaign.geometry else None)
                        for l in plan.leaves]
            assert tags(got) == tags(want), (batched, thr)
    hits = [t for t in tags(got) if t[2] or t[3]]
    assert hits, "no leaf resolved a table entry"


def test_tuned_plan_values_match_reference_kernels(tmp_path):
    """A tuned plan's values through the port's plain versions within
    1e-12 of the reference's interpret-mode kernels at the same
    geometries, dense and sparse, scalar and batched."""
    p, q = _tables(tmp_path, TABLE_SPECS)
    rng = np.random.default_rng(8)
    real = [rng.uniform(-1, 1, (9, 9)) for _ in range(2)] + \
        [_sparse(rng, 10) for _ in range(2)]
    cplx = [rng.uniform(-1, 1, (10, 10)) + 1j * rng.uniform(-1, 1, (10, 10))
            for _ in range(2)]
    port = PermanentSolver(backend="cuda", device="cpu", tuning_table=p,
                           preprocess=False, cache=False)
    ref = RSOL.PermanentSolver(RPL.SolverConfig(
        backend="pallas", tuning_table=q, preprocess=False, cache=False))
    for mats, tags in ((real, {"32x32x8", "16x16x8"}), (cplx, {"64x8x4"})):
        plan = port.plan_batch(mats)
        assert {l.geometry.tag() for l in plan.leaves} == tags
        got = np.asarray(port.execute(plan))
        want = np.asarray(ref.execute(ref.plan_batch(mats)))
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)
        for A in mats[::2]:
            np.testing.assert_allclose(
                port.execute(port.plan(A)), ref.execute(ref.plan(A)),
                rtol=1e-12, atol=1e-15)


def test_tune_cli_on_the_cpu_writes_a_table_the_solver_applies(tmp_path):
    out = str(tmp_path / "table.json")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.tune", "--device", "cpu",
         "--routes", "dense,sparse", "--n", "6,7", "--batch", "2",
         "--top-k", "2", "--repeats", "1", "--out", out],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    assert run.stdout.count("-> ") >= 4, run.stdout
    table = TuningTable.load(out)
    assert {e.route for e in table.entries.values()} == {"dense", "sparse"}
    assert all(e.device_kind == "cpu" for e in table.entries.values())
    solver = PermanentSolver(device="cpu", tuning_table=out,
                             preprocess=False)
    A = np.random.default_rng(9).uniform(-1, 1, (7, 7))
    plan = solver.plan(A)
    want = table.resolve("dense", 7, 1.0, "<f8", "dq_acc", "cpu")
    assert want is not None and plan.leaves[0].geometry == want
    from repro_torch.core import oracle
    assert solver.execute(plan) == pytest.approx(oracle.perm_ryser_exact(A),
                                                 rel=1e-9)


# ---------------------------------------------------------------------------
# hardware registry
# ---------------------------------------------------------------------------

def test_detect_hw_precedence(monkeypatch):
    monkeypatch.delenv("REPRO_HW", raising=False)
    assert detect_hw("NVIDIA H100 80GB HBM3").name == "h100-sxm"
    assert detect_hw("NVIDIA H100 PCIe").name == "h100-pcie"
    assert detect_hw("NVIDIA H100 NVL").name == "h100-nvl"
    assert detect_hw("NVIDIA H200").name == "h200"
    # an unknown card raises: no other card's rates stand in
    with pytest.raises(ValueError, match="no data-sheet rates"):
        detect_hw("weird accelerator")
    with pytest.raises(ValueError):
        get_hw("no-such-hw")
    # explicit argument beats the environment override ...
    monkeypatch.setenv("REPRO_HW", "h200")
    assert detect_hw("NVIDIA H100 PCIe").name == "h100-pcie"
    # ... and the environment override beats autodetection
    assert detect_hw().name == "h200"
    monkeypatch.delenv("REPRO_HW")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        detect_hw()
    sxm = HW_SPECS["h100-sxm"]
    assert (sxm.fp64_flops, sxm.fp32_flops, sxm.mem_bw, sxm.sms) == \
        (34.0e12, 67.0e12, 3.35e12, 132)
