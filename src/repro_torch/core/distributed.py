"""Step-space campaigns on one device: checkpointed, resumable waves of
slices.

The port of the reference package's ``core/distributed.py``, its
one-device parts.  A campaign is one permanent whose 2^(n-1) Gray steps
are cut into slices (``core.stepspace.plan_slices``, recorded in the plan
as a ``CampaignSpec``); ``run_campaign`` drives waves of pending slices
through the wave primitive ``slice_sums`` with twofloat per-slice partials
checkpointed after every wave (``core.resume.JobState``):

* the wave width W -- slices per wave -- is the one-device stand-in for
  the reference's mesh size.  It is no part of numeric identity: a
  slice's (hi, lo) is a function of the slice alone (``ops._slice_sums``
  reduces each slice over its own partials), so any W gives the same
  JobState bit for bit, and a resumed job may use another W;
* by default W is the fewest slices whose CTAs fill every SM of the card
  at the wave body's occupancy, capped at the pending count and evened
  out over the waves that count needs, so the last wave is not a sliver
  (``default_wave_width``); 1 on the CPU.  A card-filling wave shorter
  than ``MIN_WAVE_S`` is mostly launch, copy and save, so the next wave
  is widened to last about that long (small campaigns, n around 31-34);
* a wave launches once per contiguous run of its slice ids (one run,
  unless a resume left gaps);
* a failed wave records nothing; its slices stay pending and the next
  wave retries them (``max_wave_retries`` times in a row, then the error
  propagates);
* the final value is ``JobState.reduce()`` (fixed slice-id order) plus
  the g = 0 term, times the Ryser factor, so a killed-and-resumed
  campaign is bit for bit an uninterrupted one.

Still to come (ROADMAP.md, modules queue: 'Multi-device'): the mesh
functions of the reference module -- ``permanent_on_mesh``,
``slice_sums_on_mesh`` over a mesh, ``batch_permanents_on_mesh``,
``sparse_batch_permanents_on_mesh`` and ``DistributedPermanent``.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from . import precision as P
from .resume import JobState
from .ryser import (_final_factor, chain_prod, chain_prod_complex,
                    nw_base_vector, resolve_device)
from .stepspace import Geometry

__all__ = ["CampaignPaused", "MIN_WAVE_S", "Wave", "default_wave_width",
           "even_wave_width",
           "slice_sums", "run_campaign"]

MIN_WAVE_S = 0.1   # host seconds below which a default-width wave widens


class CampaignPaused(Exception):
    """A wave-budgeted campaign ran out of ``max_waves`` with slices still
    pending.  Carries the in-memory :class:`JobState` so the caller can
    keep driving the same job (``run_campaign(..., state=exc.state)``)
    without re-reading the checkpoint."""

    def __init__(self, state: JobState):
        self.state = state
        super().__init__(
            f"campaign paused at {state.fraction_done():.1%} "
            f"({len(state.pending_slices())} of {state.total_slices} "
            "slices pending)")


@dataclass
class Wave:
    """What one recorded wave did, for progress callbacks: its slice ids,
    the wave width W it was formed under, its launches (contiguous runs),
    the device seconds of its kernel launches (CUDA events around each
    launch; None off the card or on the torch body), the host seconds of
    its slice sums (launches, device work, per-slice reductions and the
    copy back) and of its checkpoint save (0 without a checkpoint)."""
    ids: list[int]
    width: int
    launches: int
    kernel_s: float | None
    host_s: float
    save_s: float

    def ids_text(self) -> str:
        """The slice ids as runs: ``0-32`` or ``3,5-9``."""
        return ",".join(f"{a}" if a == b else f"{a}-{b}"
                        for a, b in _runs(self.ids))


def _runs(ids) -> list[tuple[int, int]]:
    """Maximal runs of consecutive ids, as (first, last) in id order."""
    out: list[tuple[int, int]] = []
    for i in ids:
        if out and i == out[-1][1] + 1:
            out[-1] = (out[-1][0], i)
        else:
            out.append((i, i))
    return out


def default_wave_width(A, *, pending: int, chunks_per_slice: int,
                       chunk_size: int, precision: str = "dq_acc",
                       backend: str = "cuda",
                       geometry: Geometry | None = None, device=None) -> int:
    """Slices per wave when the caller names none, for ``pending``
    slices.  On the card with the ``cuda`` body: the fewest slices whose
    CTAs fill every SM at the wave body's occupancy (SMs x resident CTAs
    an SM / CTAs a slice, rounded up), then evened out: the waves that
    width needs for ``pending`` slices share them equally (66 at 1024
    slices is 16 waves of 64, not 15 of 66 and one of 34).  Elsewhere
    (the CPU, the ``torch`` body, n < 3): 1."""
    n = A.shape[-1]
    dev = resolve_device(device)
    if dev.type != "cuda" or backend != "cuda" or n < 3 or pending < 1:
        return 1
    from ..kernels import ops as K
    TB, _ = K.wave_geometry(chunks_per_slice, chunk_size, geometry)
    resident = K.wave_ctas_per_sm(
        n, bool(np.iscomplexobj(A)), chunks_per_slice=chunks_per_slice,
        chunk_size=chunk_size, precision=precision, geometry=geometry)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_slice = chunks_per_slice // TB
    return even_wave_width(pending, max(1, -(-sms * resident // per_slice)))


def even_wave_width(pending: int, fill: int) -> int:
    """The width of the waves for ``pending`` slices when ``fill`` slices
    fill the card: as many waves as ``fill`` needs, sharing the slices
    equally (never wider than ``fill``)."""
    waves = -(-pending // fill)
    return -(-pending // waves)


def slice_sums(A, slice_ids, *, chunks_per_slice: int, chunk_size: int,
               precision: str = "dq_acc", backend: str = "cuda",
               geometry: Geometry | None = None, device=None,
               events: list | None = None):
    """Per-slice twofloat sums of one wave: ``(his, los)``, each a
    (len(slice_ids),) float64 ndarray (complex128 for complex ``A``) in
    the order of ``slice_ids``, and the number of launches.  One
    ``ops.campaign_slice_sums`` call per maximal run of consecutive ids
    (``events`` collects each kernel launch's CUDA events).  No sentinel
    ids: a short wave is just fewer ids."""
    from ..kernels import ops as K
    ids = [int(i) for i in slice_ids]
    his, los, order = [], [], []
    runs = _runs(sorted(ids))
    for first, last in runs:
        hi, lo = K.campaign_slice_sums(
            A, first, last - first + 1, chunks_per_slice=chunks_per_slice,
            chunk_size=chunk_size, precision=precision, geometry=geometry,
            backend=backend, device=device, events=events)
        his.append(hi.cpu().numpy())
        los.append(lo.cpu().numpy())
        order.extend(range(first, last + 1))
    pos = {sid: k for k, sid in enumerate(order)}
    take = [pos[i] for i in ids]
    return (np.concatenate(his)[take], np.concatenate(los)[take],
            len(runs))


def _final_value(A: np.ndarray, hi: float | complex, lo: float | complex):
    """(hi, lo) of the slice sums plus the g = 0 term (the chain product
    of the NW base vector; per plane for complex), times the Ryser factor,
    on the host in float64 (IEEE adds and multiplies, so the same bits as
    the kernels' epilogue on the card)."""
    n = A.shape[0]
    f = _final_factor(n)
    if np.iscomplexobj(A):
        xr = nw_base_vector(torch.as_tensor(np.ascontiguousarray(A.real)))
        xi = nw_base_vector(torch.as_tensor(np.ascontiguousarray(A.imag)))
        p0r, p0i = chain_prod_complex(xr[:, None], xi[:, None])
        out = []
        for h, e, p0 in ((hi.real, lo.real, p0r[0]),
                         (hi.imag, lo.imag, p0i[0])):
            t = P.tf_add_acc(P.TwoFloat(torch.tensor(h, dtype=torch.float64),
                                        torch.tensor(e, dtype=torch.float64)),
                             p0)
            out.append(float(P.tf_value(t)) * f)
        return complex(*out)
    x = nw_base_vector(torch.as_tensor(np.asarray(A, dtype=np.float64)))
    p0 = chain_prod(x[:, None])[0]
    t = P.tf_add_acc(P.TwoFloat(torch.tensor(hi, dtype=torch.float64),
                                torch.tensor(lo, dtype=torch.float64)), p0)
    return float(P.tf_value(t)) * f


def run_campaign(A, *, total_slices: int, chunks_per_slice: int,
                 chunk_size: int, precision: str = "dq_acc",
                 backend: str = "cuda", geometry: Geometry | None = None,
                 device=None, checkpoint_path: str | None = None,
                 state: JobState | None = None, progress_cb=None,
                 max_waves: int | None = None, max_wave_retries: int = 2,
                 wave_width: int | None = None):
    """Execute a step-space campaign in waves of ``wave_width`` slices.

    The unit of work is a *slice* (``chunks_per_slice`` contiguous chunks
    of ``chunk_size`` Gray steps); the decomposition comes from the
    caller (the planner's ``CampaignSpec``).  Each iteration re-forms a
    wave from the lowest pending slice ids, computes their sums
    (``slice_sums``), records them, saves the checkpoint (``JobState``,
    config-safe ``.npz``) and calls ``progress_cb(state, wave)`` (a
    :class:`Wave`); a SIGKILL loses at most the wave in flight.  A failed
    wave records nothing and is retried.  W never changes a slice's sum:
    ``wave_width`` fixes it (tests pass it); by default it is
    ``default_wave_width`` of the slices pending at the start, widened
    after a wave shorter than ``MIN_WAVE_S``.

    Returns ``(value, state)``; ``value`` is ``None`` when ``max_waves``
    paused the run with slices still pending (the executor's
    ``CampaignBackend`` raises :class:`CampaignPaused` then).  ``value``
    is a float, or a complex for complex ``A``.
    """
    A = np.asarray(A)
    if state is None:
        state = JobState.load_or_create(
            checkpoint_path, A, total_slices, precision=precision,
            backend=backend, chunks_per_slice=chunks_per_slice,
            chunk_size=chunk_size,
            geometry=geometry.tag() if geometry is not None else "-")
    body = dict(chunks_per_slice=chunks_per_slice, chunk_size=chunk_size,
                precision=precision, backend=backend, geometry=geometry,
                device=device)
    W = wave_width
    widen = False             # set once W comes from the card's occupancy
    waves = retries = 0
    while True:
        pending = state.pending_slices()
        if not pending:
            break
        if max_waves is not None and waves >= max_waves:
            return None, state
        if W is None:
            W = default_wave_width(A, pending=len(pending), **body)
            widen = W > 1     # the CPU's W = 1 stays
        wave = pending[:W]
        events: list = []
        t0 = time.perf_counter()
        try:
            his, los, launches = slice_sums(A, wave, events=events, **body)
        except Exception:
            # nothing recorded: the wave's slices stay pending and the
            # next iteration re-forms it
            retries += 1
            if retries > max_wave_retries:
                raise
            continue
        t1 = time.perf_counter()
        # the copy back in slice_sums synchronised: every event is done
        kernel_s = sum(a.elapsed_time(b) for a, b in events) / 1e3 \
            if events else None
        retries = 0
        state.record_wave(wave, his, los)
        waves += 1
        if checkpoint_path:
            state.save(checkpoint_path)
        t2 = time.perf_counter()
        if progress_cb:
            progress_cb(state, Wave(ids=wave, width=W, launches=launches,
                                    kernel_s=kernel_s, host_s=t1 - t0,
                                    save_s=t2 - t1))
        if widen and t2 - t0 < MIN_WAVE_S:
            W = math.ceil(W * MIN_WAVE_S / max(t2 - t0, 1e-4))

    hi, lo = state.reduce()
    return _final_value(A, hi, lo), state
