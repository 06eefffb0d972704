"""Host check of a kernel geometry against the CUDA entries' own limits.

The port's counterpart of the reference's ``analysis/geometry.py::
validate_tiling``: the one place the tuner (``repro_torch.tune``) and the
on-disk tuning table (rule PL007) take a candidate's validity from.  A
(lanes, steps_per_chunk, window) candidate at size n is valid when what
``kernel_geometry`` resolves it to is a launch every entry accepts:

* every component a power of two, ``TB * C * num_blocks == 2^(n-1)``;
* ``2 <= Wu <= C`` and ``log2(Wu) < n`` (the sparse entries' guard,
  ``csrc/ryser_sparse.cu::bad_geometry``);
* ``TB <= kMaxThreads`` (256, ``csrc/ryser_common.cuh``), ``3 <= n <= 64``;
* the dynamic shared memory of the largest mode (the split-plane sparse
  kernel) within a CTA's opt-in, 227 KB on Hopper.

The reference's other audits (VMEM, step coverage, sentinel masking,
routes, eval_shape) are not ported here.
"""

from __future__ import annotations

import math

from ..core.stepspace import kernel_geometry

__all__ = ["KMAX_THREADS", "MODES", "SMEM_PER_BLOCK", "block_smem_bytes",
           "validate_tiling"]

KMAX_THREADS = 256               # csrc/ryser_common.cuh kMaxThreads
SMEM_PER_BLOCK = 227 * 1024      # Hopper's dynamic shared memory opt-in
N_MIN, N_MAX = 3, 64             # what the entries instantiate
MODES = ("dense", "complex", "sparse", "sparse_complex")
_PAD = 8


def _pow2(x: int) -> bool:
    return x >= 1 and (x & (x - 1)) == 0


def _pad(n: int) -> int:
    return max(_PAD, -(-n // _PAD) * _PAD)


def block_smem_bytes(n: int, TB: int, Wu: int,
                     mode: str = "sparse_complex") -> int:
    """Dynamic shared memory of one f64 CTA of ``mode`` as its entry counts
    it (an f32 CTA takes about half): ``dense`` in the batched or
    schedmat mode (``ryser_dense.cu::smem_bytes``), ``complex``
    (``ryser_complex.cu::smem_bytes``), ``sparse`` and ``sparse_complex``
    (``ryser_sparse.cu::smem_real`` / ``smem_cx``)."""
    n_pad, kw, itemsize = _pad(n), int(math.log2(Wu)), 8
    a, d = n_pad * n_pad, n_pad * (Wu - 1)
    if mode == "dense":
        return itemsize * (a + d + 2 * TB)
    if mode == "complex":
        return itemsize * (2 * a + 2 * d + 4 * TB)
    if mode == "sparse":
        return itemsize * (a + n_pad * kw + d + 2 * TB) + 4 * kw
    if mode == "sparse_complex":
        return itemsize * (2 * a + 2 * n_pad * kw + 2 * d + 4 * TB)
    raise ValueError(f"unknown mode {mode!r}; choose from {MODES}")


def validate_tiling(n: int, lanes: int, spc: int, window: int) -> list[str]:
    """Every limit one (lanes, steps_per_chunk, window) candidate must
    meet at matrix size n; an empty list means valid."""
    tag = f"n={n} tiling=({lanes},{spc},{window})"
    if not N_MIN <= n <= N_MAX:
        return [f"{tag}: n outside the kernels' [{N_MIN}, {N_MAX}]"]
    space = 1 << (n - 1)
    TB, C, Wu, nb = kernel_geometry(n, lanes=lanes, steps_per_chunk=spc,
                                    window=window)
    bad = []
    for name, v in (("lanes", lanes), ("steps_per_chunk", spc),
                    ("window", window), ("TB", TB), ("C", C), ("Wu", Wu),
                    ("num_blocks", nb)):
        if not _pow2(v):
            bad.append(f"{tag}: {name}={v} is not a power of two")
    if TB * C * nb != space:
        bad.append(f"{tag}: TB*C*num_blocks = {TB * C * nb} != 2^(n-1) = "
                   f"{space} -- grid does not tile the step space")
    if not 2 <= Wu <= C:
        bad.append(f"{tag}: window Wu={Wu} outside [2, C={C}]")
    if Wu >= 1 << n:
        bad.append(f"{tag}: log2(Wu) = {int(math.log2(Wu))} >= n, past the "
                   "sparse entries' guard")
    if TB > KMAX_THREADS:
        bad.append(f"{tag}: TB={TB} threads exceed the kernels' "
                   f"{KMAX_THREADS}")
    smem = max(block_smem_bytes(n, TB, Wu, m) for m in MODES)
    if smem > SMEM_PER_BLOCK:
        bad.append(f"{tag}: {smem} B of shared memory a CTA exceed the "
                   f"{SMEM_PER_BLOCK} B opt-in")
    return bad
