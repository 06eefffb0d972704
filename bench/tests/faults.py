"""Faults planted under the timed path, for the tests that show the check
turns ``correct`` false.  ``plant(fault, setattr_)`` patches the program
(``repro_torch``) with ``setattr_`` (pytest's ``monkeypatch.setattr`` in
a test, plain ``setattr`` in a spawned rank):

* ``state_unchanged``: a campaign wave marks its slices done but leaves
  the JobState's sums as they were;
* ``campaign_value_altered``: the campaign's value, where it is closed,
  off by a relative 1e-6;
* ``exchange_left_out``: over a mesh, each rank keeps only its own
  share of a wave's sums, the others' read zero;
* ``half_batch_left_out``: the batch kernel entry returns the first half
  of the stack's permanents and zeros for the rest;
* ``batch_value_altered`` / ``scalar_value_altered``: the batch / scalar
  kernel entry's answers off by a relative 1e-6;
* ``none``: nothing.

``python -m bench.tests.faults <root> <cell> <fault>`` runs one mesh cell
of ``root`` on the CPU with the fault planted in every rank and prints
the result line.
"""

from __future__ import annotations

import functools
import json
import sys
import time
from pathlib import Path

ALTER = 1.0 + 1e-6


def plant(fault: str, setattr_=setattr) -> None:
    import numpy as np
    from repro_torch.core import distributed as D
    from repro_torch.core import resume
    from repro_torch.kernels import ops
    if fault == "state_unchanged":
        def record_wave(self, slice_ids, his, los):
            for sid in slice_ids:
                self.done[sid] = True
        setattr_(resume.JobState, "record_wave", record_wave)
    elif fault == "campaign_value_altered":
        final = D._final_value
        setattr_(D, "_final_value",
                 lambda A, hi, lo: final(A, hi, lo) * ALTER)
    elif fault == "exchange_left_out":
        share = D._share

        def own_share(mesh, compute, width):
            rows, secs, failed, err = share(mesh, compute, width)
            kept = rows.copy()
            kept[np.arange(len(rows)) != mesh.index] = 0.0
            return kept, secs, failed, err
        setattr_(D, "_share", own_share)
    elif fault in ("half_batch_left_out", "batch_value_altered"):
        batched = ops.permanent_cuda_batched

        def entry(As, **kw):
            out = batched(As, **kw).clone()
            if fault == "half_batch_left_out":
                out[out.shape[0] // 2:] = 0
                return out
            return out * ALTER
        setattr_(ops, "permanent_cuda_batched", entry)
    elif fault == "scalar_value_altered":
        scalar = ops.permanent_cuda
        setattr_(ops, "permanent_cuda", lambda A, **kw: scalar(A, **kw)
                 * ALTER)
    elif fault != "none":
        raise ValueError(f"no fault {fault!r}")


def faulty_rank(fault: str, rank: int, world: int, *args):
    from bench import harness
    plant(fault)
    return harness._rank_main(rank, world, *args)


def main(argv) -> int:
    from bench import harness
    root, cell_name, fault = Path(argv[0]), argv[1], argv[2]
    cell = harness.load_cell(root, cell_name)
    line, _ = harness.run(cell, 20240601, 0.5, False, "cpu", time.time(),
                          "cpu",
                          rank_main=functools.partial(faulty_rank, fault))
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
