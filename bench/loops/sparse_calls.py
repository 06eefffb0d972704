"""The ``sparse_calls`` loop: the ``calls`` loop on sparse leaves.

Its window, warm-up and check (``value_gap``) are the ``calls`` loop's
own, taken from ``loops/calls.py`` of the same checkout.  Only its
control differs: ``lower_window`` runs the program's sparse
single-precision entry, where the ``calls`` loop's runs the dense one.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from bench import byname, inputs
from bench.harness import Window

_CALLS = byname.module(Path(__file__).resolve().parents[2], "loops", "calls")

warm_up = _CALLS.warm_up
window = _CALLS.window
sample = _CALLS.sample
references = _CALLS.references
judge = _CALLS.judge


def lower_window(cell, seed: int, items: int, device: str) -> Window:
    """The control's answers: the program's scalar sparse kernel entry
    (``kernels.ops.sparse_value_cuda``) on f32 copies of the first
    ``items`` calls' matrices and their padded CCS arrays
    (``core.sparyser.padded_ccs``)."""
    from repro_torch.core.sparyser import padded_ccs
    from repro_torch.kernels import ops
    draws = inputs.Draws(cell, seed, "window")
    precision = cell.config["solver"]["precision"]
    w = Window(per_call=draws.batch)
    for _ in range(items):
        mats, token = draws.next()
        A = np.asarray(mats, dtype=np.float32)
        w.attempted += 1
        w.tokens.append(token)
        w.values.append(ops.sparse_value_cuda(
            A, *padded_ccs(A), precision=precision,
            device=device).cpu().numpy())
    return w
