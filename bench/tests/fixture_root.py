"""A checkout-shaped root of tiny cells for the CPU tests.

``make_root(dest)`` lays out ``dest/BENCHMARK.json`` and ``dest/bench/``
as a checkout has them: the real metric readers, families and loops, and
the tiny cells of
``fixture/``, each standing for a real cell (``STANDS_FOR``), with that
cell's metrics and the limits of that cell's own file, so the tests hold
the limits the chip runs are held to.  ``add_extra(root)`` then adds the
cells, configurations, traffic mixes, matrix family, loop and metric of
``fixture/extra/`` by new files and new entries alone.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REAL = Path(__file__).resolve().parents[2]
FIXTURE = Path(__file__).resolve().parent / "fixture"

# tiny cell -> (the real cell it stands for, its configuration, its traffic)
STANDS_FOR = {
    "tiny_campaign": ("dense38_campaign", "tiny_dense", "tiny_campaign"),
    "tiny_amplitudes": ("boson24_amplitudes", "tiny_boson",
                        "tiny_amplitudes"),
    "tiny_scalar": ("dense30_latency", "tiny_dense", "tiny_scalar"),
    "tiny_campaign_mesh2": ("dense40_campaign_4chip", "tiny_dense",
                            "tiny_campaign_mesh2"),
}


def _read(path: Path):
    return json.loads(path.read_text())


def make_root(dest: Path) -> Path:
    bench = dest / "bench"
    for d in ("metrics", "families", "loops"):
        shutil.copytree(REAL / "bench" / d, bench / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for d in ("configs", "traffic"):
        shutil.copytree(FIXTURE / d, bench / d)
    (bench / "workloads").mkdir()
    real = _read(REAL / "BENCHMARK.json")
    present = {w["name"] for w in real["workloads"]}
    back = {}
    workloads = []
    for tiny, (cell, config, traffic) in STANDS_FOR.items():
        if cell not in present:
            continue
        back[cell] = tiny
        spec = _read(FIXTURE / "workloads" / f"{tiny}.json")
        spec["limits"] = _read(REAL / "bench" / "workloads"
                               / f"{cell}.json")["limits"]
        (bench / "workloads" / f"{tiny}.json").write_text(json.dumps(spec))
        workloads.append({"name": tiny, "config": config, "traffic": traffic,
                          "chips": 1, "why": f"stands for {cell}"})
    metrics = {}
    for kind in ("end_to_end", "per_layer"):
        metrics[kind] = []
        for m in real[kind]:
            m = dict(m)
            if "workloads" in m:
                m["workloads"] = [back[c] for c in m["workloads"]
                                  if c in back]
            metrics[kind].append(m)
    doc = dict(real, workloads=workloads, **metrics)
    (dest / "BENCHMARK.json").write_text(json.dumps(doc, indent=1))
    return dest


def add_extra(root: Path) -> None:
    """Add ``fixture/extra``'s files and entries to ``root``."""
    extra = FIXTURE / "extra"
    for d in ("configs", "traffic", "workloads", "metrics", "families",
              "loops"):
        for f in (extra / d).glob("*.*"):
            target = root / "bench" / d / f.name
            assert not target.exists(), f"{target} would be edited"
            shutil.copy(f, target)
    add = _read(extra / "entries.json")
    doc = _read(root / "BENCHMARK.json")
    doc["configs"] += add["configs"]
    doc["workloads"] += add["workloads"]
    for m in doc["end_to_end"]:
        cells = add["end_to_end_workloads"].get(m["name"])
        if cells and "workloads" in m:
            m["workloads"] = m["workloads"] + cells
    doc["per_layer"] += add["per_layer"]
    (root / "BENCHMARK.json").write_text(json.dumps(doc, indent=1))
