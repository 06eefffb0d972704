"""The benchmark's parts that are found by name, one file each:

* ``bench/families/<family>.py``: a matrix family (``setup``, ``draw``,
  ``matrices``, ``flops``), named by a configuration's ``family``;
* ``bench/loops/<loop>.py``: how a run drives the program (``warm_up``,
  ``window``, ``judge``, ...), named by a traffic mix's ``loop``;
* ``bench/metrics/<metric>.py``: one metric's ``read``.

A file is loaded by its path under the checkout the cell came from, so
a later cell brings its family, loop or metric as a new file and edits
none that is there.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

__all__ = ["family", "loop", "module", "reader"]

_LOADED: dict = {}


def module(root: Path, folder: str, name: str):
    """``root/bench/<folder>/<name>.py``, loaded once a process."""
    path = Path(root) / "bench" / folder / f"{name}.py"
    key = str(path.resolve())
    if key not in _LOADED:
        if not path.is_file():
            raise KeyError(f"no {folder[:-1]} {name!r}: {path} is missing")
        spec = importlib.util.spec_from_file_location(
            f"bench_{folder}_{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[key] = mod
    return _LOADED[key]


def family(cell):
    """The matrix family of ``cell``'s configuration."""
    return module(cell.root, "families", cell.config["family"])


def loop(cell):
    """The loop of ``cell``'s traffic mix."""
    return module(cell.root, "loops", cell.traffic["loop"])


def reader(root: Path, metric: str):
    """``read`` of ``bench/metrics/<metric>.py``."""
    return module(root, "metrics", metric).read
