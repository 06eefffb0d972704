"""SUperman engine: stateless entry points over the plan/execute API.

The port of the reference package's ``core/engine.py``.
``permanent(A)`` and ``permanent_batch(As)`` build a one-shot plan
(``core.planner``), execute it uncached (``core.executor``) and return
Python floats / a float64 ndarray, or Python complex / a complex128
ndarray when the input is complex.  They run on the card unless the
caller passes ``device="cpu"``; a card that is asked for and missing
raises ``RuntimeError``.  Code that wants plan inspection, cached
re-execution or the request queue holds a ``PermanentSolver`` instead.
"""

from __future__ import annotations

import numpy as np

from .distributed import CampaignPaused
from .executor import execute_plan
from .planner import (DENSITY_SWITCH, PermanentReport, SolverConfig,
                      build_plan)
from .ryser import resolve_device
from .solver import PermanentSolver, plan_values

__all__ = ["permanent", "permanent_batch", "PermanentReport",
           "PermanentSolver", "SolverConfig", "DENSITY_SWITCH",
           "CampaignPaused"]


def _config(precision: str, preprocess: bool, dm: bool | None,
            fm: bool | None, num_chunks: int, backend: str,
            device) -> SolverConfig:
    return SolverConfig(precision=precision, backend=backend,
                        preprocess=preprocess, dm=dm, fm=fm,
                        num_chunks=num_chunks, cache=False,
                        device=str(resolve_device(device)))


def permanent(A, *, precision: str = "dq_acc", preprocess: bool = True,
              dm: bool | None = None, fm: bool | None = None,
              num_chunks: int = 4096, backend: str = "cuda", device=None,
              return_report: bool = False):
    """Compute perm(A) of an (n, n) matrix the SUperman way.

    Args:
      A: (n, n) real or complex array-like; returns a Python float or
        complex.
      precision: one of ``dd | dq_fast | dq_acc | qq | kahan`` (Table 3).
      preprocess / dm / fm: DM + FM preprocessing switches (Sec. 4).
      num_chunks: chunk count of the ``torch`` engine (Alg. 3's tau).
      backend: ``cuda`` (the kernels; the default) or ``torch`` (the
        chunked engines).  Leaves below density 0.30 take the sparse
        route (SpaRyser), the others the dense one.
      device: None (the card) or ``"cpu"``.
      return_report: also return a PermanentReport.
    """
    A = np.asarray(A)
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(f"square matrix required, got {A.shape}")
    cfg = _config(precision, preprocess, dm, fm, num_chunks, backend, device)
    plan = build_plan([A], cfg, batched=False)
    totals, reports, _ = execute_plan(plan)
    plan_values(plan, totals, reports)
    report = reports[0]
    return (report.value, report) if return_report else report.value


def permanent_batch(As, *, precision: str = "dq_acc", preprocess: bool = True,
                    dm: bool | None = None, fm: bool | None = None,
                    num_chunks: int = 4096, backend: str = "cuda",
                    device=None, return_report: bool = False) -> np.ndarray:
    """perm(A) for a stack of real or complex matrices in bucketed
    batches.

    Each matrix is DM/FM-preprocessed; same-size leaves of one route
    (dense, or sparse below density 0.30) share one bucket program
    (``cuda``: one batch-grid launch of the dense or the SpaRyser kernel),
    single-leaf buckets take the scalar path.  ``As`` is (B, n, n) or a sequence of square
    matrices of any sizes; arguments as in ``permanent``.  Returns a (B,)
    float64 array (complex128 when any matrix is complex), with
    ``return_report`` a ``(values, reports)`` tuple.
    """
    mats = [np.asarray(M) for M in As]
    for M in mats:
        if M.ndim != 2 or M.shape[0] != M.shape[1]:
            raise ValueError(f"square matrices required, got {M.shape}")
    cfg = _config(precision, preprocess, dm, fm, num_chunks, backend, device)
    plan = build_plan(mats, cfg, batched=True)
    totals, reports, _ = execute_plan(plan)
    out = plan_values(plan, totals, reports)
    return (out, reports) if return_report else out
