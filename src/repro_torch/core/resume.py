"""Checkpoint / restart state for step-space campaign jobs.

A copy of the reference package's ``core/resume.py`` (which imports no
jax) with the port's backend names: a checkpoint records ``torch`` or
``cuda`` as the wave body that computed its partial sums, so one written
by the reference (``jnp`` / ``pallas``) is refused as a config mismatch,
never merged.

A permanent campaign's durable state is tiny: the matrix fingerprint, the
slice decomposition *and the configuration that produced it*, plus
per-slice twofloat partial sums.  Slices are independent addends, so:

* a crashed job resumes from the last snapshot, losing at most one wave;
* a resumed job may use another wave width (elastic) -- waves are
  re-formed from the pending slice set;
* stragglers only delay their own wave; completed slices are never redone.

Config safety: partial sums are only meaningful under the exact
(precision, backend, chunk geometry) that computed them -- merging a
``dd`` wave into a ``qq`` reduction, or slices cut at a different
``chunk_size``, silently corrupts the result at the ulp level.  The
``.npz`` therefore persists ``precision`` / ``backend`` /
``chunks_per_slice`` / ``chunk_size`` plus a format version, and
``load_or_create`` fails loudly on any mismatch (including checkpoints
written by the pre-versioned seed format).  The sums keep the job's
dtype (``sums_dtype``: f32 and complex64 stay single), which the arrays
record, so a checkpoint of one dtype is refused at another as a config
mismatch too.

The file format is a single ``.npz`` (atomic rename on save).
"""

from __future__ import annotations

import hashlib
import os
import tempfile
from dataclasses import dataclass

import numpy as np

__all__ = ["JobState", "FORMAT_VERSION", "sums_dtype"]

# v2: config-safety fields (precision/backend/chunk geometry) added; v1
# (the unversioned seed format) checkpoints are rejected at load.
# v3: kernel ``geometry`` tag joins the config-safety set -- cuda wave
# partials reduce in a fixed order set by the kernel geometry, so a
# campaign checkpointed under one geometry must not resume under
# another ("-" = no kernel geometry, i.e. torch wave bodies).
FORMAT_VERSION = 3

_CONFIG_KEYS = ("precision", "backend", "chunks_per_slice", "chunk_size",
                "geometry")


def sums_dtype(matrix) -> np.dtype:
    """The dtype of a campaign's slice sums: the wave body's, which keeps
    f32 and complex64 (the kernels' ``_f32`` entries) and takes other
    real input as f64, other complex input as complex128."""
    dt = np.asarray(matrix).dtype
    if np.issubdtype(dt, np.complexfloating):
        return np.dtype(np.complex64 if dt == np.complex64
                        else np.complex128)
    return np.dtype(np.float32 if dt == np.float32 else np.float64)


def matrix_fingerprint(A: np.ndarray) -> str:
    A = np.ascontiguousarray(A)
    h = hashlib.sha256()
    h.update(str(A.shape).encode())
    h.update(str(A.dtype).encode())
    h.update(A.tobytes())
    return h.hexdigest()[:32]


@dataclass
class JobState:
    fingerprint: str
    total_slices: int
    done: np.ndarray          # (total_slices,) bool
    hi: np.ndarray            # (total_slices,) partial sums, sums_dtype
    lo: np.ndarray            # (total_slices,) compensation terms
    precision: str = "dq_acc"
    backend: str = "torch"    # wave body: torch | cuda
    chunks_per_slice: int = 0
    chunk_size: int = 0
    geometry: str = "-"       # kernel Geometry.tag(), "-" = none (torch)
    version: int = FORMAT_VERSION

    # ------------------------------------------------------------------
    @staticmethod
    def create(matrix: np.ndarray, total_slices: int, *,
               precision: str = "dq_acc", backend: str = "torch",
               chunks_per_slice: int = 0,
               chunk_size: int = 0, geometry: str = "-") -> "JobState":
        # complex jobs checkpoint complex slice sums: the twofloat
        # reduction below is add/sub only, which is componentwise-exact
        # under complex arithmetic; f32 and complex64 jobs keep their
        # dtype, as the wave body does
        dtype = sums_dtype(matrix)
        return JobState(
            fingerprint=matrix_fingerprint(matrix),
            total_slices=total_slices,
            done=np.zeros(total_slices, dtype=bool),
            hi=np.zeros(total_slices, dtype=dtype),
            lo=np.zeros(total_slices, dtype=dtype),
            precision=precision, backend=backend,
            chunks_per_slice=chunks_per_slice, chunk_size=chunk_size,
            geometry=geometry)

    @staticmethod
    def load(path: str) -> "JobState":
        with np.load(path, allow_pickle=False) as z:
            if "version" not in z.files:
                raise ValueError(
                    f"checkpoint {path!r} predates the config-safety "
                    f"format (v{FORMAT_VERSION}): it does not record the "
                    "precision/backend/chunk geometry its partial sums "
                    "were computed under and cannot be resumed safely")
            version = int(z["version"])
            if version != FORMAT_VERSION:
                raise ValueError(
                    f"checkpoint {path!r} has format v{version}, this "
                    f"code reads v{FORMAT_VERSION}")
            return JobState(
                fingerprint=str(z["fingerprint"]),
                total_slices=int(z["total_slices"]),
                done=z["done"], hi=z["hi"], lo=z["lo"],
                precision=str(z["precision"]),
                backend=str(z["backend"]),
                chunks_per_slice=int(z["chunks_per_slice"]),
                chunk_size=int(z["chunk_size"]),
                geometry=str(z["geometry"]),
                version=version)

    @staticmethod
    def load_or_create(path: str | None, matrix: np.ndarray,
                       total_slices: int, *,
                       precision: str = "dq_acc", backend: str = "torch",
                       chunks_per_slice: int = 0,
                       chunk_size: int = 0,
                       geometry: str = "-") -> "JobState":
        if path and os.path.exists(path):
            state = JobState.load(path)
            # a job's dtype is part of its config: the sums of an f32 job
            # never resume an f64 one, or the other way round
            if state.hi.dtype != sums_dtype(matrix):
                raise ValueError(
                    "checkpoint config mismatch -- partial sums computed "
                    "under a different configuration cannot be merged "
                    f"(dtype: checkpoint={state.hi.dtype.name!r} "
                    f"plan={sums_dtype(matrix).name!r}); resume with the "
                    "original input dtype or restart from scratch")
            if state.fingerprint != matrix_fingerprint(matrix):
                raise ValueError(
                    "checkpoint belongs to a different matrix "
                    f"({state.fingerprint})")
            if state.total_slices != total_slices:
                raise ValueError(
                    f"checkpoint has {state.total_slices} slices, plan has "
                    f"{total_slices}; re-plan with the original slice "
                    "decomposition or finish with the code that wrote it")
            want = {"precision": precision, "backend": backend,
                    "chunks_per_slice": chunks_per_slice,
                    "chunk_size": chunk_size, "geometry": geometry}
            bad = [k for k in _CONFIG_KEYS
                   if getattr(state, k) != want[k]]
            if bad:
                detail = ", ".join(
                    f"{k}: checkpoint={getattr(state, k)!r} "
                    f"plan={want[k]!r}" for k in bad)
                raise ValueError(
                    "checkpoint config mismatch -- partial sums computed "
                    "under a different configuration cannot be merged "
                    f"({detail}); resume with the original config or "
                    "restart from scratch")
            return state
        return JobState.create(matrix, total_slices, precision=precision,
                               backend=backend,
                               chunks_per_slice=chunks_per_slice,
                               chunk_size=chunk_size, geometry=geometry)

    # ------------------------------------------------------------------
    def pending_slices(self) -> list[int]:
        return [int(i) for i in np.nonzero(~self.done)[0]]

    def record_wave(self, slice_ids, his, los) -> None:
        for sid, h, l in zip(slice_ids, his, los):
            self.done[sid] = True
            self.hi[sid] = h           # dtype fixed at create()
            self.lo[sid] = l

    def fraction_done(self) -> float:
        return float(self.done.mean())

    def reduce(self):
        """Twofloat sum of all completed slice partials (deterministic).

        Fixed slice-id order, independent of wave composition and wave
        width -- the reduction a killed-and-resumed campaign replays
        bitwise-identically.
        """
        hi = lo = self.hi.dtype.type(0)     # in the sums' own dtype
        for i in np.nonzero(self.done)[0]:
            s, e = _two_sum_host(hi, self.hi[i])
            lo = lo + e + self.lo[i]
            hi = s
        # renormalize
        s, e = _two_sum_host(hi, lo)
        return s, e

    def save(self, path: str) -> None:
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
        os.close(fd)
        try:
            np.savez(tmp, fingerprint=self.fingerprint,
                     total_slices=self.total_slices,
                     done=self.done, hi=self.hi, lo=self.lo,
                     precision=self.precision, backend=self.backend,
                     chunks_per_slice=self.chunks_per_slice,
                     chunk_size=self.chunk_size, geometry=self.geometry,
                     version=self.version)
            # np.savez appends .npz to names without it
            produced = tmp if tmp.endswith(".npz") else tmp + ".npz"
            if os.path.exists(produced) and produced != tmp:
                os.replace(produced, tmp)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)


def _two_sum_host(a: float, b: float):
    s = a + b
    bp = s - a
    e = (a - (s - bp)) + (b - bp)
    return s, e
