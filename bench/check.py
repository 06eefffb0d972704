"""The comparison that decides ``correct``: the program's answers from the
window against the plain reference (``reference/ryser.py``).

Each loop (``bench/loops/<loop>.py``) says what its ``judge`` compares;
every number compared is a gap measured against the scale of its own
rounding, and the cell's file (``workloads/<cell>.json``) gives its
limit and the size of the sample.  This module holds what the loops
share.
"""

from __future__ import annotations

import numpy as np

from . import byname
from .reference import ryser as R

__all__ = ["fsum", "judge", "num", "tensor"]


def tensor(A, device: str):
    """``A`` as a float64 or complex128 tensor on ``device``."""
    import torch
    dt = torch.complex128 if np.iscomplexobj(A) else torch.float64
    return torch.as_tensor(np.asarray(A), dtype=dt, device=device)


def num(x) -> float | complex:
    """A program's answer as a Python float or complex."""
    x = np.asarray(x).item()
    return complex(x) if isinstance(x, complex) else float(x)


def fsum(values) -> float | complex:
    """An exact sum of the program's numbers."""
    return R.fsum([num(v) for v in values])


def judge(cell, window, seed: int, device: str, refs=None) -> list[dict]:
    """The cell's compared numbers, each with its limit."""
    found = byname.loop(cell).judge(cell, window, seed, device, refs) \
        if window.values else []
    limits = cell.spec["limits"]
    return [{"name": name, "value": float(value), "limit": limits[name]}
            for name, value in found]
