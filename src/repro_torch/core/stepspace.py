"""Pure step-space decomposition math (no torch, no devices).

A copy of the reference package's ``core/stepspace.py``: the port keeps
its own host modules, and ``Geometry`` / ``kernel_geometry`` /
``chunk_geometry`` give results identical to the reference's.

The 2^{n-1}-step Gray iteration space is split twice:

* :func:`chunk_geometry` -- chunks: the intra-device parallelism unit
  (Alg. 3's tau lanes; every chunk is a power-of-two, window-aligned run
  of Gray steps so the CEG schedules are chunk-uniform).
* :func:`plan_slices` -- slices: the campaign / fault-tolerance unit (a
  contiguous block of chunks).  Slice sums are independent addends, so a
  killed-and-resumed job recomputes only unfinished slices and the final
  fixed-order reduction is identical no matter how slices were grouped
  into waves or how many devices ran them.

Both functions are pure host math: ``core.planner`` calls them while
building an :class:`~repro_torch.core.planner.ExecutionPlan`, and
``core.ryser`` / ``kernels.ryser_cuda`` use them for the device engines.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

__all__ = ["Geometry", "DEFAULT_GEOMETRY", "chunk_geometry", "kernel_geometry",
           "plan_slices"]


@dataclass(frozen=True)
class Geometry:
    """Requested CUDA kernel geometry: one frozen, hashable value.

    ``lanes`` / ``steps_per_chunk`` / ``window`` are the *requested* knobs;
    :func:`kernel_geometry` clamps them to the 2^{n-1} step space per
    matrix size.  ``lanes`` is the kernel's threads per CTA (one chunk per
    thread).  Because it changes the fixed-order reduction shape, a
    ``Geometry`` is part of a value's numeric identity: it is hashed into
    plan fingerprints and appended to ``ResultCache`` keys.
    """

    lanes: int = 128
    steps_per_chunk: int = 64
    window: int = 16
    max_blocks: int | None = None

    def as_tuple(self):
        return (self.lanes, self.steps_per_chunk, self.window,
                self.max_blocks)

    def tag(self) -> str:
        """Short stable string for cache keys / checkpoints / reports."""
        base = f"{self.lanes}x{self.steps_per_chunk}x{self.window}"
        return base if self.max_blocks is None else f"{base}b{self.max_blocks}"

    @staticmethod
    def from_tag(tag: str) -> "Geometry":
        body, _, mb = tag.partition("b")
        lanes, spc, window = (int(p) for p in body.split("x"))
        return Geometry(lanes, spc, window, int(mb) if mb else None)

    def kernel_geometry(self, n: int):
        """Clamp this geometry to n's step space -> (TB, C, Wu, num_blocks)."""
        return kernel_geometry(n, lanes=self.lanes,
                               steps_per_chunk=self.steps_per_chunk,
                               window=self.window, max_blocks=self.max_blocks)


DEFAULT_GEOMETRY = Geometry()


def kernel_geometry(n: int, *, lanes: int = 128, steps_per_chunk: int = 64,
                    window: int = 16, max_blocks: int | None = None):
    """Pick (TB, C, Wu, num_blocks) covering the 2^{n-1} step space.

    All power-of-two; TB * C * num_blocks == 2^{n-1}.  For small test
    matrices the requested sizes are clamped down.  Pure host math --
    the CUDA wrappers in ``kernels/ryser_cuda.py`` use it.
    """
    space = 1 << (n - 1)
    TB = min(lanes, max(2, space // 4))
    TB = 1 << int(math.floor(math.log2(TB)))
    C = min(steps_per_chunk, space // TB)
    C = max(2, 1 << int(math.floor(math.log2(C))))
    Wu = max(2, min(window, C))
    num_blocks = space // (TB * C)
    if max_blocks is not None:
        num_blocks = min(num_blocks, max_blocks)
    return TB, C, Wu, num_blocks


def chunk_geometry(n: int, num_chunks: int):
    """Power-of-2, window-aligned chunking of the 2^{n-1}-step space.

    Returns (T, C, k): T chunks of C = 2^k local steps; T * C == 2^{n-1},
    k >= 1 (so chunk starts are even and the accumulation sign is
    chunk-uniform).  Step ``w`` of chunk ``t`` is global step ``g = t*C + w``.
    """
    space = 1 << (n - 1)
    T = max(1, min(num_chunks, space // 2))
    T = 1 << int(math.floor(math.log2(T)))  # power of two
    C = space // T
    return T, C, int(math.log2(C))


def plan_slices(n: int, num_devices: int, slices_per_device: int = 8,
                lanes_per_device: int = 1024):
    """Static decomposition of the 2^{n-1} step space.

    Returns (total_slices, chunks_per_slice, chunk_size) such that
    ``total_slices * chunks_per_slice * chunk_size == 2^{n-1}`` with
    power-of-two chunk_size >= 2 (CEG alignment) and total_slices a
    power-of-two multiple of num_devices when possible.

    The decomposition depends only on its arguments -- never on the
    runtime device count -- which is what makes campaign checkpoints
    portable across elastic restarts: the planner fixes
    (total_slices, chunks_per_slice, chunk_size) once and any mesh can
    execute the pending slice set in waves of its own size.
    """
    want_chunks = num_devices * slices_per_device * lanes_per_device
    T, C, _ = chunk_geometry(n, want_chunks)
    ts = num_devices * slices_per_device
    ts = 1 << int(math.ceil(math.log2(ts)))
    while ts > 1 and (T % ts != 0 or T // ts < 1):
        ts //= 2
    return ts, T // ts, C
