"""The pure helpers behind the chip smoke, on the CPU: warps per SM from
ptxas registers (``kernels/build.py::warps_per_sm``), the SASS loop
instruction mix (``chip_smoke._loop_mix``) and the sparse matrices whose
low columns touch a set number of rows (``chip_smoke._extent_sparse``)."""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import chip_smoke  # noqa: E402
from repro_torch.core.sparyser import padded_ccs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ryser_sparse_cuda as RS  # noqa: E402


@pytest.mark.parametrize("registers, threads, warps", [
    (224, 128, 8),      # 2 CTAs of 4 warps
    (206, 128, 8),
    (150, 128, 12),     # 152 allocated: 3 CTAs
    (128, 256, 16),     # 2 CTAs of 8 warps
    (96, 256, 16),
    (80, 256, 24),
    (94, 128, 20),      # 96 allocated: 5 CTAs
    (255, 256, 8),      # 256 allocated: one CTA
    (32, 256, 64),      # the 64-warp limit
    (16, 32, 32),       # the 32-CTA limit
])
def test_warps_per_sm(registers, threads, warps):
    assert build.warps_per_sm(registers, threads) == warps


def _sass(lines):
    return "\n".join(f"        /*{a:04x}*/  {ins} ;  /* 0x0 */"
                     for a, ins in lines)


def test_loop_mix_counts_the_innermost_hot_loop():
    inner = ["DMUL R4, R2, R6", "DMUL R8, R2, R10", "DMUL R12, R14, R6",
             "DMUL R16, R14, R10", "DADD R4, R4, -R16", "DADD R8, R8, R12",
             "LDS.64 R2, [R20]", "LDS.64 R14, [R20+0x8]",
             "SHFL.BFLY PT, R3, R3, 0x1, 0x1f", "ISETP.GE.AND P0, PT, R1, R0"]
    lines = [(0x00, "MOV R1, c[0x0][0x28]")]
    lines += [(0x10 * (k + 1), op) for k, op in enumerate(inner)]
    lines += [(0xb0, "@P0 BRA 0x10")]                       # inner loop
    lines += [(0xc0, "DMUL R4, R2, R6"), (0xd0, "DMUL R4, R2, R6"),
              (0xe0, "DMUL R4, R2, R6"), (0xf0, "DMUL R4, R2, R6"),
              (0x100, "DFMA R4, R2, R6, R4"),
              (0x110, "@!P1 BRA 0x10")]                     # outer loop
    lines += [(0x120, "EXIT")]
    mix = chip_smoke._loop_mix(_sass(lines))
    assert mix["loop"] == ["0x10", "0xb0"]
    assert mix["rows"] == 1
    assert mix["counts"] == {"DADD": 2, "DMUL": 4, "DFMA": 0, "LDS": 2,
                             "SHFL": 1, "ISETP": 1, "BRA": 1, "other": 0}
    assert mix["other"] == {}


def test_loop_mix_without_a_loop():
    mix = chip_smoke._loop_mix(_sass([(0, "DMUL R4, R2, R6"), (16, "EXIT")]))
    assert mix["loop"] is None and mix["rows"] == 0


def test_loop_mix_lists_every_real_loop():
    """With ``min_dmul`` every innermost loop holding that many DMUL comes
    back, in address order, its rows the DMUL count (``per=1``)."""
    lines = [(0x00, "MOV R1, c[0x0][0x28]")]
    lines += [(0x10, "DADD R4, R4, R2"), (0x20, "DMUL R6, R6, R4"),
              (0x30, "DMUL R6, R6, R8"), (0x40, "FSEL R6, R6, R2, P0"),
              (0x50, "@P0 BRA 0x10")]                   # variant 1
    lines += [(0x60, "DMUL R6, R6, R4"), (0x70, "@P1 BRA 0x60")]   # 1 DMUL
    lines += [(0x80, "DADD R4, R4, R2"), (0x90, "DADD R8, R8, R2"),
              (0xa0, "DMUL R6, R6, R4"), (0xb0, "DMUL R6, R6, R8"),
              (0xc0, "@P2 BRA 0x80"), (0xd0, "EXIT")]   # variant 2
    mixes = chip_smoke._loop_mix(_sass(lines), per=1, min_dmul=2)
    assert [m["loop"] for m in mixes] == [["0x10", "0x50"], ["0x80", "0xc0"]]
    assert [m["rows"] for m in mixes] == [2, 2]
    assert mixes[0]["per_row"]["DADD"] == 0.5
    assert mixes[1]["per_row"]["DADD"] == 1.0
    assert mixes[0]["counts"]["BRA"] == 1
    assert mixes[0]["other"] == {"FSEL": 1}


@pytest.mark.parametrize("n, R, kw", [(4, 4, 2), (13, 5, 2), (22, 12, 4),
                                      (24, 9, 4), (32, 32, 4)])
def test_extent_sparse_sets_the_rows_the_low_columns_touch(n, R, kw):
    """R as the real sparse kernel derives it is the R asked for, RPAD is R
    rounded up to 8; with ``negzero`` every zero is -0.0."""
    rng = np.random.default_rng(n + R)
    A = chip_smoke._extent_sparse(rng, n, R, kw, extra=2, negzero=True)
    rows = torch.as_tensor(padded_ccs(A)[0])
    assert int(RS.low_column_rows(rows, kw, n)) == R
    assert chip_smoke._rows_rpad(rows[None], 1 << kw, n) == [
        [R, max(8, -(-R // 8) * 8)]]
    assert np.signbit(A[A == 0]).all()
    if R < n - 1:
        assert A[n - 1, kw] == -A[n - 1, kw + 1] != 0
