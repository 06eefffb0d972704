"""Step-space campaigns (checkpointed, resumable waves of slices) and the
mesh programs: one permanent, one bucket or one campaign over the ranks
of a ``torch.distributed`` world.

The port of the reference package's ``core/distributed.py``.  A campaign is one permanent whose 2^(n-1) Gray steps
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

Over a mesh of ranks (``launch/mesh.py``, ``torch.distributed``, one
process a device), the reference's mesh functions:

* ``permanent_on_mesh`` -- one permanent split over the Gray-step space:
  ``plan_slices(n, D, ...)`` slices, each rank its contiguous share
  through ``slice_sums`` (one launch a run), ONE ``all_gather`` of the
  per-slice ``(hi, lo)`` as host float64 tensors (complex as re/im
  planes), then every rank reduces them in slice-id order
  (``JobState.reduce``) and closes the sum (``_final_value``).  The
  reference sums with ``psum``, whose order is free; the port gathers,
  so every rank returns the same bits, and those of ``run_campaign`` on
  one device at the same ``(total_slices, chunks_per_slice,
  chunk_size)``;
* ``slice_sums_on_mesh`` -- any ids split into contiguous shares by
  rank, ids < 0 sentinels that return exact zeros;
* ``run_campaign(A, mesh=...)`` -- a wave is D x W pending slices (W
  from rank 0's card), every rank records the gathered wave into its
  ``JobState``, only shard 0 writes the checkpoint (before the next
  wave's collective), and a resume is loaded by shard 0 and broadcast,
  so a node-local path works and a checkpoint of one world resumes in
  another, or on one device, bit for bit;
* ``batch_permanents_on_mesh`` / ``sparse_batch_permanents_on_mesh`` --
  a bucket's batch axis in contiguous shares (a ragged tail padded with
  zero matrices, or inert all-dummy CCS rows), each rank through the
  one-device entries, values back through one ``all_gather`` in bucket
  order: a member's value does not depend on the stack it is in, so each
  equals the one-device backend's bit for bit;
* ``DistributedPermanent`` -- the reference's legacy wrapper.

Every mesh entry first gathers a 64-bit digest of its input and raises
``ValueError`` on every rank when the ranks disagree.  A rank whose work
raises sends a failed flag with its share instead of leaving the others
in the collective: all ranks see one verdict, and retry the wave
together (``max_wave_retries``) or raise together.  No ``all_reduce``:
gloo's ring order is not fixed (torchprove's PT104 holds the value
paths to ``all_gather`` / ``broadcast_object_list`` / ``barrier``).
``torch.distributed`` is imported inside the mesh functions only.
"""

from __future__ import annotations

import hashlib
import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from . import precision as P
from .resume import JobState
from .ryser import (_final_factor, chain_prod, chain_prod_complex,
                    nw_base_vector, perm_ryser_batched, resolve_device)
from .sparyser import pack_padded_ccs, padded_ccs, sparse_values
from .stepspace import Geometry, plan_slices

__all__ = ["CampaignPaused", "MIN_WAVE_S", "Wave", "default_wave_width",
           "even_wave_width", "slice_sums", "run_campaign",
           "permanent_on_mesh", "slice_sums_on_mesh",
           "batch_permanents_on_mesh", "sparse_batch_permanents_on_mesh",
           "DistributedPermanent", "MESH_LANES", "plan_slices"]

MIN_WAVE_S = 0.1   # host seconds below which a default-width wave widens
# permanent_on_mesh's chunks a rank: 2^16 lanes (512 CTAs of 128) fill an
# H100 (132 SMs); the reference's 1024 would run 8 CTAs a card
MESH_LANES = 1 << 16


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
                 wave_width: int | None = None, mesh=None):
    """Execute a step-space campaign in waves of ``wave_width`` slices.

    The unit of work is a *slice* (``chunks_per_slice`` contiguous chunks
    of ``chunk_size`` Gray steps); the decomposition comes from the
    caller (the planner's ``CampaignSpec``).  Each iteration re-forms a
    wave from the lowest pending slice ids, computes their sums
    (``slice_sums``), records them, saves the checkpoint (``JobState``,
    config-safe ``.npz``) and calls ``progress_cb(state, wave)`` (a
    :class:`Wave`); a SIGKILL loses at most the wave in flight.  A failed
    wave records nothing and is retried (``max_wave_retries`` in a row,
    then the error propagates).  W never changes a slice's sum:
    ``wave_width`` fixes it (tests pass it); by default it is
    ``default_wave_width`` of the slices pending at the start, widened
    after a wave shorter than ``MIN_WAVE_S``.

    Returns ``(value, state)``; ``value`` is ``None`` when ``max_waves``
    paused the run with slices still pending (the executor's
    ``CampaignBackend`` raises :class:`CampaignPaused` then).  ``value``
    is a float, or a complex for complex ``A``.

    With a ``mesh`` (``launch.mesh.Mesh``; every rank calls this with the
    same arguments, on its ``mesh.device``; ``device`` must agree with it
    or be None) the same loop runs on every rank: one digest gather of the
    input, then shard 0 loads (or creates) the JobState -- or takes the
    ``state`` passed in -- and broadcasts it with W (its
    ``default_wave_width`` of its share of the pending slices); a wave is
    the lowest D x W pending ids in D contiguous shares and ONE gather
    that also carries each rank's ok flag and host seconds
    (``_mesh_slice_sums``).  Every rank records the wave; shard 0 saves
    the checkpoint before the next wave's collective.  A wave in which any
    rank failed records nothing on any rank and is retried by all, or
    raised by all.  W widens by the slowest shard's seconds, on every rank
    alike.
    """
    A = np.asarray(A)
    gtag = _gtag(geometry)
    if mesh is not None:
        device = _mesh_device(mesh, device)
        _input_guard(mesh, "run_campaign", A, total_slices,
                     chunks_per_slice, chunk_size, precision, backend, gtag,
                     max_waves, max_wave_retries, wave_width)
    shards = 1 if mesh is None else mesh.size
    body = dict(chunks_per_slice=chunks_per_slice, chunk_size=chunk_size,
                precision=precision, backend=backend, geometry=geometry,
                device=device)

    def start():
        st = state if state is not None else JobState.load_or_create(
            checkpoint_path, A, total_slices, precision=precision,
            backend=backend, chunks_per_slice=chunks_per_slice,
            chunk_size=chunk_size, geometry=gtag)
        share = -(-len(st.pending_slices()) // shards)
        return st, wave_width or (
            default_wave_width(A, pending=share, **body) if share else 1)

    def one_device(wave, events):
        """``_mesh_slice_sums``'s contract on this process alone (no
        seconds: the loop times the wave itself)."""
        try:
            his, los, launches = slice_sums(A, wave, events=events, **body)
        except Exception as e:
            # nothing recorded: the wave's slices stay pending and the
            # next iteration re-forms it
            return None, None, 0, None, [0], e
        return his, los, launches, None, [], None

    if mesh is None:
        state, W = start()
        compute = one_device
    else:
        state, W = _broadcast_state(mesh, start)
        def compute(wave, events):
            return _mesh_slice_sums(A, mesh, wave, body, events)
    root = mesh is None or mesh.index == 0
    widen = wave_width is None and W > 1   # the CPU's W = 1 stays
    waves = retries = 0
    while True:
        pending = state.pending_slices()
        if not pending:
            break
        if max_waves is not None and waves >= max_waves:
            return None, state
        wave = pending[:shards * W]
        events: list = []
        t0 = time.perf_counter()
        his, los, launches, secs, failed, err = compute(wave, events)
        t1 = time.perf_counter()
        if failed:
            # every rank re-forms the same wave, or raises
            retries += 1
            if retries > max_wave_retries:
                _raise_failed("run_campaign", failed, err)
            continue
        # the copy back in slice_sums synchronised: every event is done
        kernel_s = sum(a.elapsed_time(b) for a, b in events) / 1e3 \
            if events else None
        retries = 0
        state.record_wave(wave, his, los)
        waves += 1
        if checkpoint_path and root:
            state.save(checkpoint_path)
        t2 = time.perf_counter()
        if progress_cb:
            progress_cb(state, Wave(ids=wave, width=W, launches=launches,
                                    kernel_s=kernel_s, host_s=t1 - t0,
                                    save_s=t2 - t1))
        took = t2 - t0 if secs is None else float(secs.max())
        if widen and took < MIN_WAVE_S:
            W = math.ceil(W * MIN_WAVE_S / max(took, 1e-4))

    hi, lo = state.reduce()
    return _final_value(A, hi, lo), state


# ---------------------------------------------------------------------------
# Mesh functions: one permanent, bucket or campaign over a world of ranks
# ---------------------------------------------------------------------------

def _dist():
    import torch.distributed as dist
    return dist


def _gtag(geometry: Geometry | None) -> str:
    return geometry.tag() if geometry is not None else "-"


def _mesh_device(mesh, device):
    """The device of this rank's work: the mesh's; a ``device`` that names
    another kind raises."""
    if device is not None and torch.device(device).type != mesh.device.type:
        raise ValueError(f"device {device!r} disagrees with the mesh's "
                         f"device {mesh.device}")
    return mesh.device


def _digest(*parts) -> int:
    """64-bit digest of arrays (shape, dtype, bytes) and other values
    (their repr)."""
    h = hashlib.blake2b(digest_size=8)
    for p in parts:
        if isinstance(p, np.ndarray):
            h.update(f"{p.shape}{p.dtype}".encode())
            h.update(np.ascontiguousarray(p).tobytes())
        else:
            h.update(repr(p).encode())
        h.update(b"|")
    return int.from_bytes(h.digest(), "little", signed=True)


def _gather(mesh, row: torch.Tensor) -> np.ndarray:
    """One ``all_gather`` of a host row per rank over the mesh's gloo
    group: a (D, len) array in shard order."""
    out = [torch.empty_like(row) for _ in range(mesh.size)]
    _dist().all_gather(out, row, group=mesh.group)
    return torch.stack(out).numpy()[mesh.ranks.ravel()]


def _input_guard(mesh, what: str, *parts) -> None:
    """Gather a digest of this rank's input; ``ValueError`` on every rank
    when they differ (a broadcast would hide it)."""
    got = _gather(mesh, torch.tensor([_digest(*parts)], dtype=torch.int64))
    if (got[:, 0] != got[0, 0]).any():
        raise ValueError(
            f"{what}: the ranks were given different inputs (digests "
            f"{[hex(int(d) & (2 ** 64 - 1)) for d in got[:, 0]]}); every "
            f"rank of a mesh passes the same matrix and arguments")


def _share(mesh, compute, width: int):
    """Run ``compute()`` (a float64 vector of ``width``) on this rank and
    gather ``[ok, seconds, vector]`` from every rank: ``(rows (D, width),
    seconds (D,), failed shards, this rank's exception or None)``.  A
    rank whose work raises sends zeros and ok = 0 instead of leaving the
    others waiting in the collective, so every rank learns one verdict."""
    err = None
    t0 = time.perf_counter()
    try:
        vec = np.asarray(compute(), dtype=np.float64)
        if vec.shape != (width,):
            raise ValueError(f"a share of shape {vec.shape}, not ({width},)")
        ok = 1.0
    except Exception as e:  # an SPMD boundary: every rank must hear of it
        err, vec, ok = e, np.zeros(width), 0.0
    row = np.concatenate([[ok, time.perf_counter() - t0], vec])
    rows = _gather(mesh, torch.from_numpy(row))
    failed = [i for i in range(mesh.size) if rows[i, 0] != 1.0]
    return rows[:, 2:], rows[:, 1], failed, err


def _raise_failed(what: str, failed: list, err) -> None:
    """Raise on every rank: this rank's own error, or one naming the
    shards that failed."""
    if err is not None:
        raise err
    raise RuntimeError(f"{what}: shard(s) {failed} failed")


def _planes(v: np.ndarray, cplx: bool) -> np.ndarray:
    """A real or complex vector as float64 planes (re, then im)."""
    return np.concatenate([v.real, v.imag]).astype(np.float64) if cplx \
        else np.asarray(v, dtype=np.float64)


def _unplanes(rows: np.ndarray, cplx: bool) -> np.ndarray:
    """(D, k * per) planes back to one vector in shard order."""
    if not cplx:
        return rows.ravel()
    per = rows.shape[1] // 2
    return rows[:, :per].ravel() + 1j * rows[:, per:].ravel()


def _mesh_slice_sums(A: np.ndarray, mesh, ids: list[int], body: dict,
                     events: list | None = None):
    """The slice ids (ids < 0 sentinels) in D contiguous shares, shard i
    the i-th, each rank its own through ``slice_sums``; one gather.
    Returns ``(his, los, launches, seconds, failed, err)``, his and los
    in the order of ``ids`` (exact zeros at sentinels), ``launches`` this
    rank's, ``seconds`` each shard's host seconds."""
    per = max(1, -(-len(ids) // mesh.size))
    mine = ids[mesh.index * per:(mesh.index + 1) * per]
    mine += [-1] * (per - len(mine))
    cplx = bool(np.iscomplexobj(A))
    launches = 0

    def compute():
        nonlocal launches
        dt = np.complex128 if cplx else np.float64
        hi, lo = np.zeros(per, dt), np.zeros(per, dt)
        pos = [k for k, i in enumerate(mine) if i >= 0]
        if pos:
            h, e, launches = slice_sums(A, [mine[k] for k in pos],
                                        events=events, **body)
            hi[pos], lo[pos] = h, e
        return np.concatenate([_planes(hi, cplx), _planes(lo, cplx)])

    width = per * (4 if cplx else 2)
    rows, secs, failed, err = _share(mesh, compute, width)
    half = width // 2
    his = _unplanes(rows[:, :half], cplx)[:len(ids)]
    los = _unplanes(rows[:, half:], cplx)[:len(ids)]
    return his, los, launches, secs, failed, err


def slice_sums_on_mesh(A, mesh, slice_ids, *, chunks_per_slice: int,
                       chunk_size: int, precision: str = "dq_acc",
                       backend: str = "cuda",
                       geometry: Geometry | None = None):
    """Per-slice twofloat sums of any number of slice ids over the mesh:
    the ids in D contiguous shares by rank, ids < 0 sentinels that come
    back as exact zeros (the reference's convention).  Every rank returns
    ``(his, los)``, each (len(slice_ids),) float64 (complex128 for complex
    ``A``), in the order given."""
    A = np.asarray(A)
    ids = [int(i) for i in slice_ids]
    _input_guard(mesh, "slice_sums_on_mesh", A, ids, chunks_per_slice,
                 chunk_size, precision, backend, _gtag(geometry))
    body = dict(chunks_per_slice=chunks_per_slice, chunk_size=chunk_size,
                precision=precision, backend=backend, geometry=geometry,
                device=mesh.device)
    his, los, _, _, failed, err = _mesh_slice_sums(A, mesh, ids, body)
    if failed:
        _raise_failed("slice_sums_on_mesh", failed, err)
    return his, los


def permanent_on_mesh(A, mesh, *, precision: str = "dq_acc",
                      slices_per_device: int = 1,
                      lanes_per_device: int = MESH_LANES,
                      backend: str = "cuda",
                      geometry: Geometry | None = None):
    """One permanent split over the Gray-step space of every rank of
    ``mesh``.  The decomposition is the reference's,
    ``plan_slices(n, D, slices_per_device, lanes_per_device)`` (the
    default lanes fill a card, ``MESH_LANES``; the reference's are 1024),
    shard i owning slices [i * spd, (i + 1) * spd) of them; each rank sums
    its own (one launch of the wave body per contiguous run), one gather
    brings every slice's ``(hi, lo)`` to every rank, and each reduces them
    in slice-id order and closes the sum.  Every rank returns the same
    float (complex for complex ``A``), equal bit for bit to
    ``run_campaign`` on one device at the same slice decomposition."""
    A = np.asarray(A)
    n = A.shape[-1]
    if A.ndim != 2 or A.shape[0] != n:
        raise ValueError(f"square matrix required, got {A.shape}")
    ts, cps, C = plan_slices(n, mesh.size, slices_per_device,
                             lanes_per_device)
    spd = max(1, ts // mesh.size)
    _input_guard(mesh, "permanent_on_mesh", A, precision, ts, cps, C,
                 backend, _gtag(geometry))
    body = dict(chunks_per_slice=cps, chunk_size=C, precision=precision,
                backend=backend, geometry=geometry, device=mesh.device)
    ids = [s if s < ts else -1 for s in range(mesh.size * spd)]
    his, los, _, _, failed, err = _mesh_slice_sums(A, mesh, ids, body)
    if failed:
        _raise_failed("permanent_on_mesh", failed, err)
    state = JobState.create(A, ts, precision=precision, backend=backend,
                            chunks_per_slice=cps, chunk_size=C,
                            geometry=_gtag(geometry))
    state.record_wave(range(ts), his[:ts], los[:ts])
    return _final_value(A, *state.reduce())


def _broadcast_state(mesh, make):
    """``make()`` -> (state, W) on shard 0, broadcast to every rank; an
    error there (a checkpoint that does not fit) raises on every rank."""
    box = [None, None, None]
    if mesh.index == 0:
        try:
            box[0], box[1] = make()
        except (ValueError, OSError) as e:
            box[2] = f"{type(e).__name__}: {e}"
    _dist().broadcast_object_list(box, src=mesh.root, group=mesh.group)
    if box[2] is not None:
        raise ValueError(f"run_campaign on shard 0: {box[2]}")
    return box[0], box[1]


def _pad_rows(x: np.ndarray, rows: int, fill) -> np.ndarray:
    """``x`` with ``rows`` more entries of ``fill`` on its first axis."""
    if not rows:
        return x
    return np.concatenate([x, np.full((rows, *x.shape[1:]), fill, x.dtype)])


def _sharded_values(mesh, what: str, B: int, parts: tuple, run,
                    cplx: bool) -> np.ndarray:
    """Shard i runs ``run(*shares)`` on rows [i * per, (i + 1) * per) of
    each array of ``parts`` (padded to D * per rows); one gather brings
    the values back in bucket order, the first ``B`` in the dtype the
    one-device entry gave."""
    per = parts[0].shape[0] // mesh.size
    shares = [p[mesh.index * per:(mesh.index + 1) * per] for p in parts]
    dtype: list = []

    def compute():
        v = run(*shares)
        v = v.detach().cpu().numpy() if torch.is_tensor(v) \
            else np.asarray(v)
        dtype.append(v.dtype)
        return _planes(v, cplx)

    rows, _, failed, err = _share(mesh, compute, per * (2 if cplx else 1))
    if failed:
        _raise_failed(what, failed, err)
    return _unplanes(rows, cplx)[:B].astype(dtype[0])


def _check_backend(backend: str) -> None:
    if backend not in ("cuda", "torch"):
        raise ValueError(f"backend must be cuda|torch, got {backend!r}")


def batch_permanents_on_mesh(stack, mesh, *, precision: str = "dq_acc",
                             num_chunks: int = 4096, backend: str = "cuda",
                             geometry: Geometry | None = None) -> np.ndarray:
    """Permanents of a (B, n, n) stack, its batch axis in D contiguous
    shares over ``mesh``: each rank runs its share through the one-device
    entry (``backend="cuda"``: ``ops.permanent_cuda_batched``, one launch
    of the batch-grid kernel; ``"torch"``: ``ryser.perm_ryser_batched``)
    on ``mesh.device``, a ragged tail padded with zero matrices whose
    values are dropped, and one gather returns the (B,) values to every
    rank in bucket order -- each equal bit for bit to the one-device
    entry's (a member's value does not depend on its stack).  n <= 2:
    closed forms on every rank.  Complex stacks cross as re/im planes,
    f32 and complex64 keep their dtype."""
    stack = np.asarray(stack)
    if stack.ndim != 3 or stack.shape[1] != stack.shape[2] or not len(stack):
        raise ValueError(f"(B, n, n) stack required, got {stack.shape}")
    _check_backend(backend)
    _input_guard(mesh, "batch_permanents_on_mesh", stack, precision,
                 num_chunks, backend, _gtag(geometry))

    def run(part):
        if backend == "torch":
            return perm_ryser_batched(part, num_chunks, precision,
                                      device=mesh.device)
        from ..kernels import ops as K
        return K.permanent_cuda_batched(part, precision=precision,
                                        geometry=geometry,
                                        device=mesh.device)

    B, n = stack.shape[:2]
    if n <= 2:
        return run(stack).cpu().numpy()
    pad = (-B) % mesh.size
    return _sharded_values(mesh, "batch_permanents_on_mesh", B,
                           (_pad_rows(stack, pad, 0),), run,
                           bool(np.iscomplexobj(stack)))


def sparse_batch_permanents_on_mesh(sps, mesh, *, precision: str = "dq_acc",
                                    num_chunks: int = 4096,
                                    backend: str = "cuda",
                                    geometry: Geometry | None = None
                                    ) -> np.ndarray:
    """The sparse analogue of :func:`batch_permanents_on_mesh`.  ``sps``
    is a list of ``SparseMatrix`` (packed with ``pack_padded_ccs``) or a
    dense (B, n, n) stack (``padded_ccs``, as the executor's buckets
    come); the bucket-wide padded CCS arrays are cut into the shares, a
    ragged tail padded with inert entries (a zero matrix, every row the
    dummy row n, zero values).  Each rank runs the one-device entry
    (``"cuda"``: ``ops.sparse_batched_values_cuda``, one launch of the
    batch-grid SpaRyser kernel; ``"torch"``: ``sparyser.sparse_values``);
    values equal the one-device entry's bit for bit."""
    _check_backend(backend)
    if isinstance(sps, (list, tuple)):
        A_stack, rows, vals = pack_padded_ccs(list(sps))
    else:
        A_stack = np.asarray(sps)
        if A_stack.ndim != 3 or A_stack.shape[1] != A_stack.shape[2] \
                or not len(A_stack):
            raise ValueError(f"(B, n, n) stack required, got "
                             f"{A_stack.shape}")
        rows, vals = padded_ccs(A_stack)
    _input_guard(mesh, "sparse_batch_permanents_on_mesh", A_stack, rows,
                 vals, precision, num_chunks, backend, _gtag(geometry))

    def run(a, r, v):
        if backend == "torch":
            return sparse_values(a, r, v, num_chunks, precision,
                                 device=mesh.device)
        from ..kernels import ops as K
        return K.sparse_batched_values_cuda(a, r, v, precision=precision,
                                            geometry=geometry,
                                            device=mesh.device)

    B, n = A_stack.shape[:2]
    if n <= 2:
        return run(A_stack, rows, vals).cpu().numpy()
    pad = (-B) % mesh.size
    parts = (_pad_rows(A_stack, pad, 0), _pad_rows(rows, pad, n),
             _pad_rows(vals, pad, 0))
    return _sharded_values(mesh, "sparse_batch_permanents_on_mesh", B,
                           parts, run, bool(np.iscomplexobj(vals)))


@dataclass
class DistributedPermanent:
    """Checkpointable, elastic multi-slice permanent job (the reference's
    legacy wrapper): the slice decomposition from THIS mesh's rank count
    (``plan_slices(n, D, slices_per_device, lanes_per_device)``), the
    waves ``run_campaign(mesh=...)``.  New code routes through the
    planner (``SolverConfig.campaign_threshold``), which records the
    decomposition in the plan, independent of the mesh."""
    mesh: object
    precision: str = "dq_acc"
    slices_per_device: int = 8
    lanes_per_device: int = 1024
    checkpoint_path: str | None = None
    backend: str = "cuda"          # wave body: the kernels, or "torch"

    def permanent(self, A, progress_cb=None):
        A = np.asarray(A)
        total_slices, chunks_per_slice, C = plan_slices(
            A.shape[0], self.mesh.size, self.slices_per_device,
            self.lanes_per_device)
        value, _ = run_campaign(
            A, total_slices=total_slices, chunks_per_slice=chunks_per_slice,
            chunk_size=C, precision=self.precision, backend=self.backend,
            checkpoint_path=self.checkpoint_path, progress_cb=progress_cb,
            mesh=self.mesh)
        return value
