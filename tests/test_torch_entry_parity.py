"""Kernel-entry parity with the reference: the dense real kernel's
``schedmat`` mode, f32 input to the dense real entries, complex64 input to
the split-plane entries (#3/#4, #7/#8), f32 input to the real sparse
entries (#5/#6), and the sequential engine ``perm_ryser_seq``.

The port's wrappers run their plain versions on CPU tensors
(``ryser_cuda.py::block_partials_plain``, which repeats the kernel's
arithmetic op for op); the reference runs its Pallas kernels in interpret
mode, as its own tests do.  Bars:

* ``schedmat``: per-block partials rtol 1e-12 / atol 1e-15 and values
  within 1e-12 of the reference's ``schedmat`` kernel (both sum the same
  terms in the same order; the init's association differs), values within
  rtol 1e-9 of the oracle (tests/test_kernels.py's bar);
* f32: partials and values within rtol 1e-5 of the reference's f32 kernel
  at the same geometry (f32 rounding, about 6e-8 an operation, through
  products of n factors and the init's other association), values within
  rtol 5e-4 of the oracle (the reference's own f32 bar,
  tests/test_kernels.py:35-42), results f32 on both sides; the same
  rtol 1e-5 for complex64 (#3/#4, #7/#8) and f32 sparse (#5/#6) values,
  results complex64 / f32 on both sides;
* ``perm_ryser_seq``: within 1e-12 of the reference's (the same walk and
  the same twofloat adds; the products' order may differ).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import oracle  # noqa: E402
from repro.core import ryser as RR  # noqa: E402
from repro.core import sparyser as RSP  # noqa: E402
from repro.core.stepspace import Geometry as RG  # noqa: E402
from repro.kernels import ops as OPS  # noqa: E402
from repro_torch.core import ryser as TR  # noqa: E402
from repro_torch.core import sparyser as TSP  # noqa: E402
from repro_torch.core.stepspace import Geometry  # noqa: E402
from repro_torch.kernels import ops as TOPS  # noqa: E402
from repro_torch.kernels import ryser_cuda as RC  # noqa: E402

GEO, RGEO = Geometry(8, 8, 4), RG(8, 8, 4)
PRECISIONS = ("dd", "kahan", "dq_acc", "dq_fast")


def _rng(*key):
    return np.random.default_rng([1717, *key])


def _partials_close(got, want, rtol, atol):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got[..., 0] + got[..., 1],
                               want[..., 0] + want[..., 1],
                               rtol=rtol, atol=atol)


# -- schedmat -----------------------------------------------------------------

@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("n", [6, 10, 12])
def test_schedmat_partials_match_reference(n, precision):
    A = _rng(n, 1).uniform(-1, 1, (n, n))
    want, geo = OPS.block_partials_pallas(A, geometry=RGEO, mode="schedmat",
                                          precision=precision)
    got, tgeo = TOPS.block_partials_cuda(A, geometry=GEO, mode="schedmat",
                                         precision=precision, device="cpu")
    assert tuple(tgeo) == tuple(geo)
    _partials_close(got.numpy(), want, rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("n", [4, 5, 6, 8, 10, 12, 14])
def test_schedmat_values_match_reference_and_oracle(n):
    A = _rng(n, 2).uniform(-1, 1, (n, n))
    want = float(OPS.permanent_pallas(A, mode="schedmat", geometry=RGEO))
    got = TOPS.permanent_cuda(A, mode="schedmat", geometry=GEO, device="cpu")
    assert got.dtype == torch.float64 and got.ndim == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(float(got), oracle.perm_ryser_exact(A),
                               rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("lanes,spc,win", [(4, 4, 2), (16, 16, 16),
                                           (8, 32, 8), (32, 4, 4),
                                           (2, 2, 2), (64, 8, 8)])
def test_schedmat_geometry_sweep(lanes, spc, win):
    """tests/test_kernels.py's geometry sweep, in schedmat mode."""
    A = _rng(lanes, spc, win).uniform(-1, 1, (11, 11))
    want = float(OPS.permanent_pallas(A, mode="schedmat",
                                      geometry=RG(lanes, spc, win)))
    got = float(TOPS.permanent_cuda(A, mode="schedmat",
                                    geometry=Geometry(lanes, spc, win),
                                    device="cpu"))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(got, oracle.perm_ryser_exact(A), rtol=1e-9,
                               atol=1e-12)


def test_schedmat_is_not_baseline_bitwise_but_close():
    """schedmat's mid step rounds otherwise than baseline's: not bit for
    bit, as the reference's modes are not, but within 1e-12."""
    A = _rng(3).uniform(-1, 1, (12, 12))
    s = float(TOPS.permanent_cuda(A, mode="schedmat", geometry=GEO,
                                  device="cpu"))
    b = float(TOPS.permanent_cuda(A, mode="baseline", geometry=GEO,
                                  device="cpu"))
    assert s == pytest.approx(b, rel=1e-12)


def test_batch_entry_refuses_schedmat():
    As = _rng(4).uniform(-1, 1, (2, 6, 6))
    with pytest.raises(ValueError, match="baseline|batched"):
        OPS.permanent_pallas_batched(As, mode="schedmat", geometry=RGEO)
    with pytest.raises(ValueError, match="batch grid supports"):
        TOPS.permanent_cuda_batched(As, mode="schedmat", geometry=GEO,
                                    device="cpu")
    A_pads, xb_pads, _ = TOPS.prepare(torch.as_tensor(As))
    with pytest.raises(ValueError, match="batch grid supports"):
        RC.ryser_cuda_call_batched(A_pads, xb_pads, n=6, TB=8, C=4, Wu=4,
                                   num_blocks=1, mode="schedmat")


def test_sched_columns_equal_reference_premultiplied_schedule():
    """C0 = A @ Sel: the port's gather equals the reference's matmul."""
    from repro.kernels import ryser_pallas as RP
    A = _rng(5).uniform(-1, 1, (13, 13))
    A_pad = OPS.pad_matrix(A)
    for Wu in (2, 4, 16):
        sel = RP._sched_select_host(RP._signed_const_schedule(Wu),
                                    A_pad.shape[0])
        want = np.asarray(A_pad) @ sel
        got = RC.sched_columns(torch.as_tensor(np.array(A_pad))[None],
                               Wu)[0]
        np.testing.assert_array_equal(got.numpy(), want)


# -- f32 input ----------------------------------------------------------------

@pytest.mark.parametrize("mode", ["baseline", "batched", "schedmat"])
@pytest.mark.parametrize("n", [6, 10, 12])
def test_f32_partials_match_reference(n, mode):
    A = _rng(n, 6).uniform(0.1, 1.0, (n, n)).astype(np.float32)
    want, _ = OPS.block_partials_pallas(A, geometry=RGEO, mode=mode)
    got, _ = TOPS.block_partials_cuda(A, geometry=GEO, mode=mode,
                                      device="cpu")
    assert np.asarray(want).dtype == np.float32
    assert got.dtype == torch.float32
    _partials_close(got.numpy(), want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("mode", ["baseline", "batched", "schedmat"])
@pytest.mark.parametrize("n", [4, 7, 10, 12])
def test_f32_values_match_reference_and_oracle(n, mode):
    A = _rng(n, 7).uniform(0.1, 1.0, (n, n)).astype(np.float32)
    want = OPS.permanent_pallas(A, mode=mode, geometry=RGEO)
    got = TOPS.permanent_cuda(A, mode=mode, geometry=GEO, device="cpu")
    assert np.asarray(want).dtype == np.float32
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(got),
                               oracle.perm_ryser_exact(A.astype(np.float64)),
                               rtol=5e-4)


@pytest.mark.parametrize("mode", ["baseline", "batched"])
def test_f32_batch_entry_matches_reference(mode):
    As = _rng(8).uniform(0.1, 1.0, (3, 9, 9)).astype(np.float32)
    want = np.asarray(OPS.permanent_pallas_batched(As, mode=mode,
                                                   geometry=RGEO))
    got = TOPS.permanent_cuda_batched(As, mode=mode, geometry=GEO,
                                      device="cpu")
    assert want.dtype == np.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    for i, A in enumerate(As):
        one = TOPS.permanent_cuda(A, mode=mode, geometry=GEO, device="cpu")
        if mode == "batched":            # the same body from chunk 0
            assert float(one) == float(got[i])


def test_f32_fault_repaired():
    """The fault as it stood (ROADMAP.md section 3): f32 input went through
    an f64 cast and came back as an f64 value computed in f64, where the
    reference computes and returns f32.  Now the port's value is f32, is
    the f32 computation's (equal to the f32 plain partials reduced in
    f32), and differs from the f64 value as the reference's f32 value
    does."""
    A = _rng(9).uniform(0.1, 1.0, (10, 10)).astype(np.float32)
    got = TOPS.permanent_cuda(A, geometry=GEO, device="cpu")
    f64 = TOPS.permanent_cuda(A.astype(np.float64), geometry=GEO,
                              device="cpu")
    ref32 = OPS.permanent_pallas(A, geometry=RGEO)
    assert got.dtype == torch.float32 and f64.dtype == torch.float64
    assert float(got) != float(f64)
    np.testing.assert_allclose(float(got), float(ref32), rtol=1e-5)
    At = torch.as_tensor(A)
    A_pad, xb_pad, xbs = TOPS.prepare(At)
    assert A_pad.dtype == xb_pad.dtype == torch.float32
    TB, C, Wu, blocks = GEO.kernel_geometry(10)
    parts = RC.block_partials_plain(A_pad[None], xb_pad[None], 0, n=10, TB=TB,
                                    C=C, Wu=Wu, num_blocks=blocks)[0]
    p0 = TOPS.chain_prod(xbs[:, None])[0]
    assert float(TOPS.kernel_reduce(parts[:, 0], parts[:, 1], p0, 10)) == \
        float(got)


def test_entry_dtypes_and_refusals():
    """Every entry takes f64 and f32 (complex128 and complex64 planes), its
    result in the input's dtype; mixed dtypes and other dtypes raise."""
    A = _rng(10).uniform(-1, 1, (6, 6))
    assert TOPS.permanent_cuda(A, device="cpu").dtype == torch.float64
    assert TOPS.permanent_cuda(A + 1j * A, device="cpu").dtype == \
        torch.complex128
    assert TOPS.permanent_cuda(A.astype(np.complex64),
                               device="cpu").dtype == torch.complex64
    assert TOPS.permanent_cuda_batched(
        np.stack([A, A]).astype(np.complex64), device="cpu").dtype == \
        torch.complex64
    A_pad, xb_pad, _ = TOPS.prepare(torch.as_tensor(A))
    with pytest.raises(TypeError, match="one dtype"):
        RC.ryser_cuda_call(A_pad.float(), xb_pad, 0, n=6, TB=8, C=4, Wu=4,
                           num_blocks=1)
    from repro_torch.kernels import ryser_complex_cuda as RCC
    from repro_torch.kernels import ryser_sparse_cuda as RSC
    got = RCC.ryser_cuda_call_complex(A_pad.float(), A_pad.float(),
                                      xb_pad.float(), xb_pad.float(), 0, n=6,
                                      TB=8, C=4, Wu=4, num_blocks=1)
    assert got.dtype == torch.float32 and got.shape == (1, 4)
    with pytest.raises(TypeError, match="f64 or f32"):
        RCC.ryser_cuda_call_complex(A_pad.half(), A_pad.half(),
                                    xb_pad.half(), xb_pad.half(), 0, n=6,
                                    TB=8, C=4, Wu=4, num_blocks=1)
    rows, vals = TSP.padded_ccs(A)
    rows = torch.as_tensor(rows)
    got = RSC.ryser_sparse_cuda_call(A_pad.float(), rows,
                                     torch.as_tensor(vals).float(),
                                     xb_pad.float(), 0, n=6, TB=8, C=4, Wu=4,
                                     num_blocks=1)
    assert got.dtype == torch.float32
    with pytest.raises(ValueError, match="must be torch.float32"):
        RSC.ryser_sparse_cuda_call(A_pad.float(), rows,
                                   torch.as_tensor(vals), xb_pad.float(), 0,
                                   n=6, TB=8, C=4, Wu=4, num_blocks=1)


# -- complex64 and f32 sparse input ------------------------------------------

def _cplx64(rng, n, B=None):
    shape = (n, n) if B is None else (B, n, n)
    return (rng.uniform(-1, 1, shape)
            + 1j * rng.uniform(-1, 1, shape)).astype(np.complex64)


def _sparse32(rng, n, cplx=False):
    """U(0.1, 1) masked at density 0.3 with a 0.5 diagonal (the permanent
    stays away from zero); complex: a U(-1, 1) imaginary part on the same
    support.  f32 / complex64."""
    A = rng.uniform(0.1, 1.0, (n, n)) * (rng.uniform(size=(n, n)) < 0.3)
    np.fill_diagonal(A, 0.5)
    if cplx:
        A = A + 1j * rng.uniform(-1, 1, (n, n)) * (A != 0)
        return A.astype(np.complex64)
    return A.astype(np.float32)


@pytest.mark.parametrize("n", [5, 8, 11])
def test_complex64_values_match_reference(n):
    """#3 (scalar) and #4 (batched) on complex64 input: complex64 on both
    sides, within rtol 1e-5 of the reference's complex64 kernels."""
    rng = _rng(n, 12)
    As = _cplx64(rng, n, 3)
    want = np.asarray(OPS.permanent_pallas_batched(As, geometry=RGEO))
    got = TOPS.permanent_cuda_batched(As, geometry=GEO, device="cpu")
    assert want.dtype == np.complex64 and got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    want1 = np.asarray(OPS.permanent_pallas(As[0], geometry=RGEO))
    got1 = TOPS.permanent_cuda(As[0], geometry=GEO, device="cpu")
    assert want1.dtype == np.complex64 and got1.dtype == torch.complex64
    np.testing.assert_allclose(complex(got1), complex(want1), rtol=1e-5)
    exact = oracle.perm_ryser_exact(As[0].astype(np.complex128))
    np.testing.assert_allclose(complex(got1), exact, rtol=5e-4)


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("n", [6, 9, 12])
def test_sparse_single_values_match_reference(n, cplx):
    """#5/#6 on f32 values and #7/#8 on complex64 values: the dtype of the
    input on both sides, within rtol 1e-5 of the reference's kernels (the
    scalar entry and the batch entry).  A complex value that cancels is
    held at 1e-5 of perm(|A|), the scale of its f32 rounding: at n = 12
    one such value, |perm| 0.586 against perm(|A|) 20.6, lies 1.4e-5
    (reference) and 2.7e-5 (port) from the exact value, relative."""
    rng = _rng(n, 13, int(cplx))
    mats = [_sparse32(rng, n, cplx) for _ in range(3)]
    dt = torch.complex64 if cplx else torch.float32
    want = np.asarray(OPS.permanent_pallas_sparse_batched(
        [RSP.SparseMatrix.from_dense(M) for M in mats], geometry=RGEO))
    got = TOPS.permanent_cuda_sparse_batched(
        [TSP.SparseMatrix.from_dense(M) for M in mats], geometry=GEO,
        device="cpu")
    assert want.dtype == mats[0].dtype and got.dtype == dt
    scale = np.array([oracle.perm_ryser_exact(np.abs(M).astype(np.float64))
                      for M in mats])
    assert np.all(np.abs(got.numpy() - want)
                  <= 1e-5 * np.maximum(np.abs(want), scale))
    if not cplx:                 # real positive: perm(|A|) is the value
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    want1 = np.asarray(OPS.permanent_pallas_sparse(
        RSP.SparseMatrix.from_dense(mats[0]), geometry=RGEO))
    got1 = TOPS.permanent_cuda_sparse(TSP.SparseMatrix.from_dense(mats[0]),
                                      geometry=GEO, device="cpu")
    assert want1.dtype == mats[0].dtype and got1.dtype == dt
    np.testing.assert_allclose(got1.numpy(), want1, rtol=1e-5)
    exact = oracle.perm_ryser_exact(mats[0].astype(np.complex128))
    np.testing.assert_allclose(complex(got1), exact, rtol=5e-4)


@pytest.mark.parametrize("n", [7, 10])
def test_complex64_partials_match_reference(n):
    """#3's per-block (re_hi, re_err, im_hi, im_err) partials in f32 planes
    against the reference's complex kernel on the same f32 planes."""
    from repro.kernels import ryser_complex as RXP
    from repro_torch.kernels import ryser_complex_cuda as RCC
    A = _cplx64(_rng(n, 14), n)
    TB, C, Wu, blocks = GEO.kernel_geometry(n)
    Ar, Ai, xbr, xbi, _ = TOPS.prepare_complex(torch.as_tensor(A))
    assert Ar.dtype == xbr.dtype == torch.float32
    got = RCC.ryser_cuda_call_complex(Ar, Ai, xbr, xbi, 0, n=n, TB=TB, C=C,
                                      Wu=Wu, num_blocks=blocks)
    want = RXP.ryser_pallas_call_complex(
        *(np.asarray(t) for t in (Ar, Ai, xbr, xbi)), 0, n=n, TB=TB, C=C,
        Wu=Wu, num_blocks=blocks, interpret=True)
    assert np.asarray(want).dtype == np.float32 and got.dtype == torch.float32
    for lo, hi in ((0, 2), (2, 4)):
        _partials_close(got.numpy()[:, lo:hi], np.asarray(want)[:, lo:hi],
                        rtol=1e-5, atol=1e-6)


def test_complex64_and_sparse_f32_fault_repaired():
    """The fault as it stood (ROADMAP.md section 3): complex64 input to
    #3/#4 and f32 input to #5/#6 went through f64 casts and came back as
    complex128 / f64 values computed in f64, where the reference computes
    and returns complex64 / f32.  Now both keep the input's dtype."""
    rng = np.random.default_rng(3)
    A = (rng.uniform(-1, 1, (8, 8))
         + 1j * rng.uniform(-1, 1, (8, 8))).astype(np.complex64)
    ref = np.asarray(OPS.permanent_pallas(A))
    got = TOPS.permanent_cuda(A, device="cpu")
    wide = TOPS.permanent_cuda(A.astype(np.complex128), device="cpu")
    assert ref.dtype == np.complex64 and got.dtype == torch.complex64
    assert wide.dtype == torch.complex128 and complex(got) != complex(wide)
    np.testing.assert_allclose(complex(got), complex(ref), rtol=1e-5)
    np.testing.assert_allclose(complex(ref),
                               23.752639770507812 - 19.79451560974121j,
                               rtol=1e-6)
    rng = np.random.default_rng(5)
    B = rng.uniform(0.1, 1, (10, 10)) * (rng.uniform(size=(10, 10)) < 0.3)
    np.fill_diagonal(B, 0.5)
    B = B.astype(np.float32)
    ref = np.asarray(OPS.permanent_pallas_sparse(
        RSP.SparseMatrix.from_dense(B)))
    got = TOPS.permanent_cuda_sparse(TSP.SparseMatrix.from_dense(B),
                                     device="cpu")
    wide = TOPS.permanent_cuda_sparse(
        TSP.SparseMatrix.from_dense(B.astype(np.float64)), device="cpu")
    assert ref.dtype == np.float32 and got.dtype == torch.float32
    assert wide.dtype == torch.float64 and float(got) != float(wide)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)


# -- the sequential engine ----------------------------------------------------

def test_perm_ryser_seq_matches_reference():
    worst = 0.0
    for n in range(1, 13):
        A = _rng(n, 11).uniform(-1, 1, (n, n))
        want = float(RR.perm_ryser_seq(A))
        got = TR.perm_ryser_seq(A, device="cpu")
        assert got.dtype == torch.float64 and got.ndim == 0
        np.testing.assert_allclose(float(got), want, rtol=1e-12, atol=1e-15)
        worst = max(worst, abs(float(got) - want) / np.spacing(abs(want)))
        np.testing.assert_allclose(float(got), oracle.perm_ryser_exact(A),
                                   rtol=1e-9, atol=1e-12)
    print(f"perm_ryser_seq: worst gap to the reference {worst:g} ulp")
