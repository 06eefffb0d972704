"""The port's geometry auditor (``repro_torch.analysis.geometry``): every
audit passes on the tree, and each catches the fault it is for -- a
double record in the campaign replay, a tuning table with a bad geometry
(PT007), a spill in a ptxas report, an unregistered producer, a wave
width that drops slices."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch.analysis import geometry as G  # noqa: E402
from repro_torch.core import distributed as D  # noqa: E402
from repro_torch.core import executor as E  # noqa: E402
from repro_torch.core.resume import JobState  # noqa: E402
from repro_torch.core.stepspace import Geometry  # noqa: E402
from repro_torch.tune.table import TableEntry, TuningTable  # noqa: E402


@pytest.mark.parametrize("name", [name for name, _ in G.AUDITS])
def test_audit_passes_on_the_tree(name):
    assert dict(G.AUDITS)[name]() == []


def test_sentinel_audit_catches_a_double_record(monkeypatch):
    pending = JobState.pending_slices

    def reissue(self):
        """Wave formation that hands slice 0 out again once it is done."""
        p = pending(self)
        return p + [0] if p and self.done[0] and 0 not in p else p

    monkeypatch.setattr(JobState, "pending_slices", reissue)
    bad = G.audit_sentinel_masking()
    assert any("recorded twice" in v for v in bad), bad


def test_sentinel_audit_replays_the_real_loop():
    """The replay runs ``run_campaign`` itself: the real wave body is
    restored afterwards and a campaign still computes its value."""
    assert G.audit_sentinel_masking(ns=(8,), widths=(3,)) == []
    assert D.slice_sums.__module__ == D.__name__
    A = np.random.default_rng(4).uniform(-1, 1, (5, 5))
    value, _ = D.run_campaign(A, total_slices=4, chunks_per_slice=2,
                              chunk_size=2, backend="torch", device="cpu")
    want = repro_torch.permanent(A, backend="torch", preprocess=False,
                                 device="cpu")
    assert value == pytest.approx(want, rel=1e-12)


def test_step_coverage_catches_a_width_that_drops_slices(monkeypatch):
    monkeypatch.setattr(D, "even_wave_width", lambda pending, fill: fill + 1)
    assert G.audit_step_coverage(ns=(12,))


def _table(tmp_path, geometry: Geometry) -> str:
    table = TuningTable()
    table.put(TableEntry(route="dense", n=8, density_bucket="1.00",
                         dtype="<f8", precision="dq_acc", device_kind="cpu",
                         geometry=Geometry(16, 8, 4), predicted_s=1.0,
                         measured_s=1.0, default_s=1.0))
    path = tmp_path / "table.json"
    table.save(str(path))
    doc = json.loads(path.read_text())
    doc["entries"][0]["geometry"] = geometry.tag()
    path.write_text(json.dumps(doc))
    return str(path)


def test_tuning_table_audit_pt007(tmp_path):
    assert G.audit_tuning_table(_table(tmp_path, Geometry(16, 8, 4))) == []
    bad = G.audit_tuning_table(_table(tmp_path, Geometry(24, 8, 4)))
    assert bad and "not a power of two" in bad[0]
    assert G.main(["--check", "--table",
                   _table(tmp_path, Geometry(24, 8, 4))]) == 1
    assert G.audit_tuning_table(None) == []
    results, notes = G.run_audits(_table(tmp_path, Geometry(16, 8, 4)))
    assert all(v == [] for v in results.values())


def test_smem_audit_reads_a_ptxas_report():
    log = ("ptxas info    : Compiling entry function "
           "'_Z11ryser_kernelILi32ELi2ELb0EdLb0EEvPKT2_' for 'sm_90a'\n"
           "ptxas info    : Function properties for x\n"
           "    16 bytes stack frame, 8 bytes spill stores, 8 bytes spill "
           "loads\n"
           "ptxas info    : Used 168 registers\n")
    insts = G.ptxas_registers(log)
    assert insts == [{"function": insts[0]["function"], "npad": 32,
                      "spill": 16, "registers": 168}]
    bad = G.audit_smem_budget(log=log)
    assert len(bad) == 1 and "spills 16 bytes" in bad[0]
    notes = []
    assert G.audit_smem_budget(log="", notes=notes) == []
    assert "no ptxas.log" in notes[0]


def test_smem_audit_catches_a_cta_past_the_opt_in():
    assert G.audit_smem_budget(ns=(64,), tilings=((256, 4096, 4096),),
                               log="")


def test_routes_audit_catches_an_unregistered_producer(monkeypatch):
    class Rogue(E.Backend):
        name = "rogue"

        def value_backend(self, route, n, *, batched):
            return "nowhere"

    monkeypatch.setitem(E._BACKENDS, "rogue", Rogue())
    bad = G.audit_routes(ns=(6,))
    assert bad and all("nowhere" in v for v in bad)


def test_cli(capsys):
    assert G.main(["--check"]) == 0
    out = capsys.readouterr().out
    assert "geometry: 0 violation(s) total" in out
    assert G.main([]) == 2
