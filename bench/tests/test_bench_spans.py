"""The ``idle_in_*`` readers (``bench/spans.py``) on synthetic traces:
the prefix match, the mean over ranks, None without a trace or where a
full list holds none of the layer's gaps, a true 0 on a shorter list,
and each metric listed in its own cells only."""

import pytest

from bench import byname, harness
from bench.spans import FULL, idle_in

READERS = {"idle_in_plan.calls": "repro.plan",
           "idle_in_dispatch.calls": "repro.dispatch",
           "idle_in_campaign.campaign": "repro.campaign",
           "idle_in_mesh.campaign": "repro.mesh"}
CELLS = {"idle_in_plan.calls": {"boson24_amplitudes", "dense30_latency"},
         "idle_in_dispatch.calls": {"boson24_amplitudes", "dense30_latency"},
         "idle_in_campaign.campaign": {"dense38_campaign",
                                       "dense40_campaign_4chip"},
         "idle_in_mesh.campaign": {"dense40_campaign_4chip"}}


def _trace(gaps, window_s=8.0):
    return {"window_s": window_s, "busy_s": 6.0, "ryser_s": 5.0,
            "device_ops": [], "idle_gaps": [list(g) for g in gaps]}


def _view(*traces):
    return harness.View(chips=len(traces), setup_s=1.0, traces=list(traces))


def test_prefix_counts_sub_spans_and_nothing_beside():
    t = _trace([("repro.plan", 0.2), ("repro.plan.leaves", 0.6),
                ("repro.planner", 5.0), ("bench.plan", 3.0),
                ("repro.dispatch.stage", 0.4)])
    assert idle_in(_view(t), "repro.plan") == pytest.approx(10.0)
    assert idle_in(_view(t), "repro.dispatch") == pytest.approx(5.0)


def test_mean_over_the_ranks():
    ranks = [_trace([("repro.mesh.gather", s)], window_s=4.0)
             for s in (0.04, 0.08, 0.12, 0.16)]
    assert idle_in(_view(*ranks), "repro.mesh") == pytest.approx(2.5)


def test_none_without_a_trace_on_every_rank():
    assert idle_in(_view(), "repro.plan") is None
    assert idle_in(_view(None), "repro.plan") is None
    t = _trace([("repro.plan", 1.0)])
    assert idle_in(_view(t, None), "repro.plan") is None


def test_full_list_without_the_layer_reads_none_short_list_zero():
    others = [(f"aten::op{k}", 0.1) for k in range(FULL)]
    assert idle_in(_view(_trace(others)), "repro.campaign") is None
    assert idle_in(_view(_trace(others[:-1])), "repro.campaign") == 0.0
    # a full list that holds one of the layer's reads it
    full = others[:-1] + [("repro.campaign.save", 0.4)]
    assert idle_in(_view(_trace(full)), "repro.campaign") == \
        pytest.approx(5.0)
    # one rank's full list without the layer leaves the mean unreadable
    assert idle_in(_view(_trace(full), _trace(others)),
                   "repro.campaign") is None


@pytest.mark.parametrize("metric", sorted(READERS))
def test_each_reader_reads_its_prefix(metric):
    read = byname.reader(harness.ROOT, metric)
    t = _trace([(READERS[metric] + ".x", 0.8), ("bench.window", 0.8)])
    assert read(_view(t)) == pytest.approx(10.0)
    assert read(_view(_trace([("bench.window", 0.8)]))) == 0.0


@pytest.mark.parametrize("metric", sorted(READERS))
def test_each_metric_is_listed_in_its_own_cells(metric):
    cells = [w["name"] for w in harness._json(
        harness.ROOT / "BENCHMARK.json")["workloads"]]
    listed = {c for c in cells
              if metric in {m["name"] for m in harness.load_cell(
                  harness.ROOT, c).metrics["per_layer"]}}
    assert listed == CELLS[metric]
