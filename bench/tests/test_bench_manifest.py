"""BENCHMARK.json against the benchmark's contract, and every file of it
found by name."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
DOC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "projection",
               "head", "expansion", "experts_per_token", "modes")


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(DOC) == KEYS
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_command_and_paths():
    cmd = DOC["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert 1 <= len(DOC["paths"]) <= 16
    for p in DOC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
        assert (ROOT / p).is_dir()
    for word in cmd[1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in DOC["paths"])


def test_run_seconds_fits_the_full_check():
    s = DOC["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    runs = 2 + 14 * 24
    assert runs * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_units_are_legal_and_unique():
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in DOC[kind]]
        assert len(names) == len(set(names)), kind
        assert all(NAME.match(n) for n in names), kind
    metrics = DOC["end_to_end"] + DOC["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES


@pytest.mark.parametrize("entry", DOC["configs"], ids=lambda e: e["name"])
def test_config_entry(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert _line(entry["source"]) and _line(entry["why"])
    assert entry["file"].startswith("bench/")
    body = json.loads((ROOT / entry["file"]).read_text())
    assert body["name"] == entry["name"]
    assert body["reduced"] == entry["reduced"]
    assert len(entry["reduced"]) <= 16
    for key in entry["reduced"]:
        assert NAME.match(key)
        assert not key.endswith(("_dim", "_rank"))
        assert not any(w in key for w in WIDTH_WORDS)
    assert any(w["config"] == entry["name"] for w in DOC["workloads"])


@pytest.mark.parametrize("cell", DOC["workloads"], ids=lambda w: w["name"])
def test_cell_entry_and_its_files(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] in (1, 4) and _line(cell["why"])
    assert NAME.match(cell["config"]) and NAME.match(cell["traffic"])
    bench = ROOT / "bench"
    assert (bench / "configs" / f"{cell['config']}.json").is_file()
    traffic = json.loads(
        (bench / "traffic" / f"{cell['traffic']}.json").read_text())
    assert (bench / "loops" / f"{traffic['loop']}.py").is_file()
    config = json.loads(
        (bench / "configs" / f"{cell['config']}.json").read_text())
    assert (bench / "families" / f"{config['family']}.py").is_file()
    spec = json.loads((bench / "workloads" / f"{cell['name']}.json")
                      .read_text())
    assert set(spec) >= {"sample", "limits"}
    assert int(traffic.get("ranks", 1)) <= cell["chips"]


def test_pairs_and_four_chip_share():
    pairs = [(w["config"], w["traffic"]) for w in DOC["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in DOC["workloads"])
    assert four <= max(1, len(DOC["workloads"]) // 4)


def _cell_metrics(cell: str):
    e2e = [m for m in DOC["end_to_end"]
           if cell in m.get("workloads", [cell])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in DOC["per_layer"]
             if cell in m.get("workloads", [cell] if m["moves"] in moved
                              else [])]
    return e2e, layer


@pytest.mark.parametrize("cell", [w["name"] for w in DOC["workloads"]])
def test_every_cell_reports_enough(cell):
    e2e, layer = _cell_metrics(cell)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and layer
    for m in layer:
        assert m["moves"] in names


def test_end_to_end_metrics():
    names = {m["name"] for m in DOC["end_to_end"]}
    assert "setup_s" in names and 1 <= len(names) <= 16
    cells = {w["name"] for w in DOC["workloads"]}
    for m in DOC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells


def test_per_layer_metrics():
    e2e = {m["name"] for m in DOC["end_to_end"]}
    cells = {w["name"] for w in DOC["workloads"]}
    layers = {}
    for m in DOC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert set(m.get("workloads", [])) <= cells
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] \
                or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("metric", DOC["end_to_end"] + DOC["per_layer"],
                         ids=lambda m: m["name"])
def test_every_metric_has_a_reader(metric):
    path = ROOT / "bench" / "metrics" / f"{metric['name']}.py"
    assert path.is_file()
    assert "def read" in path.read_text() or "as read" in path.read_text()


def test_files_under_paths_are_named_from_name_characters():
    for p in DOC["paths"]:
        for f in (ROOT / p).rglob("*"):
            if "__pycache__" in f.parts or f.is_dir():
                continue
            rel = f.relative_to(ROOT).as_posix()
            assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel


LOOP_API = ("warm_up", "window", "sample", "references", "judge",
            "lower_window")


@pytest.mark.parametrize("path", sorted((ROOT / "bench" / "loops")
                                        .glob("*.py")), ids=lambda p: p.stem)
def test_every_loop_file_has_the_loop_functions(path):
    from bench import byname
    mod = byname.module(ROOT, "loops", path.stem)
    assert all(callable(getattr(mod, f)) for f in LOOP_API)
