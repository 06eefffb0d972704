"""torchprove (``repro_torch.analysis.prove``): every entry at every
precision passes on the CPU against the committed value goldens in
``tests/torch_goldens/``, a mutated body makes PT101, PT102 and PT103
fire, a missing or drifted golden is reported, a golden from another
torch version is still held, and the bless round trip; PT104 on the mesh
entries (a world of one rank in the test's process): clean as the port
is, and an ``all_reduce`` or an extra gather slipped into a value path is
caught."""

import json
import os

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import prove as P  # noqa: E402
from repro_torch.core import ryser  # noqa: E402

NAMES = [e.name for e in P.ENTRIES]


def _rules(report) -> set:
    return {f.rule for f in report["findings"]}


def test_twenty_entries():
    assert len(P.ENTRIES) == 20 and len(set(NAMES)) == 20
    assert sum(e.arity == "wave" for e in P.ENTRIES) == 4
    assert sum(e.batched for e in P.ENTRIES) == 8


@pytest.mark.parametrize("name", NAMES)
def test_entry_passes_against_committed_goldens(name):
    report = P.run_check(entries=name, device="cpu")
    assert report["findings"] == []
    assert report["goldens"]["missing"] == []
    assert report["goldens"]["drifted"] == []


def test_goldens_record_values_recipe_and_torch_version():
    for entry in P.ENTRIES:
        with open(P.golden_path(entry)) as f:
            doc = json.load(f)
        assert doc["entry"] == entry.name and doc["torch"]
        assert doc["inputs"] == P.recipe(entry)
        assert set(doc["values"]) == set(P.PRECISIONS)
        width = P.ALT_B if entry.batched else 1
        if entry.arity == "wave":
            width = 2 * (1 << (P.N - 1)) // (P.CPS * P.CHUNK)
        assert all(len(v) == width for v in doc["values"].values())


def _mutate(monkeypatch, fn):
    real = ryser.batched_values
    monkeypatch.setattr(ryser, "batched_values",
                        lambda As, T, C, p: fn(real(As, T, C, p), As))


def test_pt101_fires_on_a_sum_over_the_batch(monkeypatch):
    _mutate(monkeypatch, lambda out, As: out + 0.0 * torch.sum(out))
    report = P.run_check(entries="dense_torch.f64.batch")
    assert "PT101" in _rules(report)


def test_pt102_fires_on_an_f32_cast(monkeypatch):
    _mutate(monkeypatch, lambda out, As: out.to(torch.float32).to(out.dtype))
    report = P.run_check(entries="dense_torch.f64.*")
    assert "PT102" in _rules(report)
    assert report["goldens"]["drifted"]


def test_pt103_fires_on_a_batch_dependent_program(monkeypatch):
    def per_member(out, As):
        for i in range(out.shape[0]):          # a loop over the batch
            out = out + 0.0 * out[i]
        return out
    _mutate(monkeypatch, per_member)
    report = P.run_check(entries="dense_torch.f64.batch")
    assert any(f.rule == "PT103" and "ops at" in f.message
               for f in report["findings"])


def test_pt103_fires_on_batch_dependent_values(monkeypatch):
    _mutate(monkeypatch, lambda out, As: out * (1 + 2.0 ** -50 * len(As)))
    report = P.run_check(entries="dense_torch.f64.batch")
    assert any(f.rule == "PT103" and "member i" in f.message
               for f in report["findings"])


def test_pt103_fires_on_a_second_run_that_differs(monkeypatch):
    runs = iter(range(1000))
    _mutate(monkeypatch, lambda out, As: out * (1 + 2.0 ** -50 * next(runs)))
    report = P.run_check(entries="dense_torch.f64.scalar")
    assert any(f.rule == "PT103" and "second run" in f.message
               for f in report["findings"])


def test_missing_golden_is_reported(tmp_path, capsys):
    report = P.run_check(entries="sparse_cuda.f64.scalar",
                         golden_dir=str(tmp_path))
    assert report["goldens"]["missing"] == ["sparse_cuda.f64.scalar"]
    assert P.failed(report)
    assert P.main(["--check", "--entries", "sparse_cuda.f64.scalar",
                   "--goldens", str(tmp_path)]) == 1
    assert "GOLDEN MISSING" in capsys.readouterr().out


def test_bless_round_trip_and_drift(tmp_path):
    pattern = "campaign_cuda.*"
    blessed = P.bless(pattern, golden_dir=str(tmp_path))
    assert sorted(blessed["goldens"]["blessed"]) == [
        "campaign_cuda.c128.wave", "campaign_cuda.f64.wave"]
    for name in blessed["goldens"]["blessed"]:
        with open(tmp_path / f"{name}.json") as f, \
                open(os.path.join(P.GOLDEN_DIR, f"{name}.json")) as g:
            assert json.load(f)["values"] == json.load(g)["values"]
    assert not P.failed(P.run_check(pattern, golden_dir=str(tmp_path)))
    path = tmp_path / "campaign_cuda.f64.wave.json"
    doc = json.loads(path.read_text())
    doc["torch"] = "0.0.0"                  # another torch: still held
    path.write_text(json.dumps(doc))
    assert not P.failed(P.run_check(pattern, golden_dir=str(tmp_path)))
    doc["values"]["kahan"][0] = float(1.5).hex()
    path.write_text(json.dumps(doc))
    report = P.run_check(pattern, golden_dir=str(tmp_path))
    assert [(d["entry"], d["precision"]) for d in
            report["goldens"]["drifted"]] == [("campaign_cuda.f64.wave",
                                               "kahan")]


def test_batch_extent_invariance_helper_on_cpu():
    assert P.extent_invariance(6, 5, 3, device="cpu") == {
        "dense_cuda.f64.batch": 0, "dense_cuda.c128.batch": 0,
        "sparse_cuda.f64.batch": 0, "sparse_cuda.c128.batch": 0}


def test_cli(capsys):
    assert P.main(["--check", "--entries", "dense_torch.f64.scalar"]) == 0
    assert "0 finding(s), 0 golden problem(s)" in capsys.readouterr().out
    assert P.main(["--check", "--entries", "nothing*"]) == 2
    assert P.main(["--bless", "--device", "cuda"]) == 2
    assert P.main([]) == 2
    assert P.main(["--check", "--json", "--entries",
                   "sparse_torch.c128.batch"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["findings"] == [] and doc["pt104"] == {}   # no mesh entry


def test_pt104_mesh_entries_are_clean():
    report = P.run_check(entries="mesh_*", device="cpu")
    assert report["findings"] == []
    assert sorted(report["pt104"]) == sorted(P.MESH_ENTRIES)
    for name, inv in report["pt104"].items():
        assert set(inv["calls"]) <= {"all_gather", "broadcast_object_list"}
        assert inv["calls"]["all_gather"] == inv["budget"]["all_gather"]
    assert not torch.distributed.is_initialized()   # the world is gone


def _inject_all_reduce(monkeypatch):
    from repro_torch.core import distributed as D
    real = D._gather

    def summed(mesh, row):
        extra = row.clone()
        torch.distributed.all_reduce(extra, group=mesh.group)
        return real(mesh, row)
    monkeypatch.setattr(D, "_gather", summed)


@pytest.mark.parametrize("entry", ["mesh_permanent_on_mesh.f64",
                                   "mesh_run_campaign.c128",
                                   "mesh_sparse_batch_permanents_on_mesh.f64"])
def test_pt104_catches_an_injected_all_reduce(monkeypatch, entry):
    _inject_all_reduce(monkeypatch)
    report = P.run_check(entries=entry, device="cpu")
    found = [f for f in report["findings"] if f.rule == "PT104"]
    assert found and "all_reduce" in found[0].message


def test_pt104_catches_a_gather_past_its_budget(monkeypatch):
    from repro_torch.core import distributed as D
    real = D._gather
    monkeypatch.setattr(D, "_gather",
                        lambda mesh, row: (real(mesh, row), real(mesh, row))[1])
    report = P.run_check(entries="mesh_batch_permanents_on_mesh.c128")
    assert any(f.rule == "PT104" and "budget" in f.message
               for f in report["findings"])
