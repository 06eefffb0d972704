"""Data-sheet rates of the CUDA cards the port runs on, by name.

The port's counterpart of the reference's ``utils/roofline.py`` registry:
:data:`HW_SPECS` maps a canonical name to an :class:`HwSpec` (FP64 and
FP32 vector rates with an FMA counted as two operations, memory rate, SM
count and shared memory per SM), :func:`get_hw` looks one up and
:func:`detect_hw` maps ``torch.cuda.get_device_name`` onto it.  An
unknown card raises: a rate that is not the card's would make every bound
and every modelled time wrong.  ``cpu`` is a rough stand-in for tuning
the plain versions in tests.  The operation counts of the Ryser kernels
(``ryser_ops``, ``complex_ryser_ops``, ``sparse_ryser_ops``) sit beside
the rates: ``chip_smoke.py``'s bounds and the tuner's cost model read
both from here.  The reference's ``Roofline`` and its HLO cost tools read
XLA HLO and have no counterpart here.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

__all__ = ["HwSpec", "HW_SPECS", "complex_ryser_ops", "detect_hw", "get_hw",
           "ryser_ops", "sparse_ryser_ops"]


@dataclass(frozen=True)
class HwSpec:
    name: str
    fp64_flops: float      # FLOP/s, vector, an FMA counted as two
    fp32_flops: float      # FLOP/s, vector, an FMA counted as two
    mem_bw: float          # bytes/s
    sms: int               # streaming multiprocessors
    smem_per_sm: int       # bytes of shared memory an SM holds


_HOPPER_SMEM = 228 * 1024

# Data-sheet rates per SKU (NVIDIA H100 and H200 data sheets: FP64 and
# FP32 vector TFLOP/s, memory TB/s; SMs of each part).
HW_SPECS: dict[str, HwSpec] = {
    "h100-pcie": HwSpec("h100-pcie", 25.6e12, 51.2e12, 2.0e12, 114,
                        _HOPPER_SMEM),
    "h100-nvl": HwSpec("h100-nvl", 30.0e12, 60.0e12, 3.9e12, 132,
                       _HOPPER_SMEM),
    "h100-sxm": HwSpec("h100-sxm", 34.0e12, 67.0e12, 3.35e12, 132,
                       _HOPPER_SMEM),
    "h200": HwSpec("h200", 34.0e12, 67.0e12, 4.8e12, 132, _HOPPER_SMEM),
    # the plain versions on a host: a rough stand-in so that tuning on the
    # CPU still ranks geometries by their work
    "cpu": HwSpec("cpu", 100e9, 200e9, 20e9, 1, _HOPPER_SMEM),
}

# device-name substrings -> registry keys, checked in order (the H100 SXM
# names itself "NVIDIA H100 80GB HBM3")
_NAME_PATTERNS = (("h100 pcie", "h100-pcie"), ("h100 nvl", "h100-nvl"),
                  ("h100", "h100-sxm"), ("h200", "h200"), ("cpu", "cpu"))


def get_hw(name: str) -> HwSpec:
    """The spec registered as ``name``; an unknown name raises."""
    try:
        return HW_SPECS[name]
    except KeyError:
        raise ValueError(f"no hardware spec {name!r}; registered: "
                         f"{sorted(HW_SPECS)}") from None


def detect_hw(device_name: str | None = None) -> HwSpec:
    """The spec of a card by its name.

    Precedence: an explicit ``device_name`` > the ``REPRO_HW`` environment
    variable (a registry name) > ``torch.cuda.get_device_name(0)``.  A
    name no pattern matches raises ``ValueError``, and with no name given
    and no card, ``RuntimeError``: nothing falls back to another card's
    rates.
    """
    override = os.environ.get("REPRO_HW")
    if device_name is None and override:
        return get_hw(override)
    if device_name is None:
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: name the hardware "
                               "(detect_hw('cpu') or REPRO_HW)")
        device_name = torch.cuda.get_device_name(0)
    low = device_name.strip().lower()
    for pat, key in _NAME_PATTERNS:
        if pat in low:
            return HW_SPECS[key]
    raise ValueError(f"no data-sheet rates on record for {device_name!r} "
                     f"(registered: {sorted(HW_SPECS)})")


def ryser_ops(n: int) -> float:
    """FP64 (or FP32) instructions of one real dense permanent: per Gray
    step n adds for the row-sum update and n - 1 multiplies for the
    product (rounded up to 2n), over 2^(n-1) steps."""
    return 2.0 * n * 2.0 ** (n - 1)


def complex_ryser_ops(n: int) -> float:
    """Instructions of one split-plane complex permanent: per Gray step 2n
    adds for the two column updates and 6(n - 1) for the complex product
    (rounded up to 8n), over 2^(n-1) steps."""
    return 8.0 * n * 2.0 ** (n - 1)


def sparse_ryser_ops(rows, n: int, cplx: bool) -> float:
    """Operations SpaRyser needs for the matrices whose padded CCS rows are
    ``rows`` (B, n, maxdeg), counted from their column degrees: Gray step g
    changes column j = ctz(g), which 2^(n-2-j) of the 2^(n-1) - 1 steps do
    (j <= n - 2), and costs deg(j) adds for that column's nonzeros and
    n - 1 multiplies for the product; complex 2 deg(j) adds and 6 (n - 1)
    for the complex product."""
    deg = (np.asarray(rows) < n).sum(axis=-1)[..., :n - 1]     # (B, n - 1)
    flips = 2.0 ** (n - 2 - np.arange(n - 1))
    adds, prod = (2, 6 * (n - 1)) if cplx else (1, n - 1)
    return float(adds * (deg * flips).sum()
                 + deg.shape[0] * (2.0 ** (n - 1) - 1) * prod)
