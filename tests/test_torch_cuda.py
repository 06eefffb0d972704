"""Tests that need the card: the CUDA kernels (dense real, split-plane
complex, and sparse real and complex, each on f64 and f32 input; the dense
real one also in schedmat mode) against their plain versions, bit for
bit, also from chunk bases at the end of the step space and at the
geometries the tuner measures; the main
path against the torch engines, on the device; the refusal of a chunk
size past the step space; a campaign killed and resumed; a world of two
ranks sharing the card (the mesh functions, bit for bit with one device,
and their collectives under torchprove's PT104); the distributed
strategies without a mesh, on the kernels.
They skip where no card is present; on a machine with one run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import os
import signal
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch.core.sparyser import (SparseMatrix, pack_padded_ccs,  # noqa: E402
                                      padded_ccs)
from repro_torch.core.stepspace import DEFAULT_GEOMETRY  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ryser_complex_cuda as RX  # noqa: E402
from repro_torch.kernels import ryser_cuda as RC  # noqa: E402
from repro_torch.kernels import ryser_sparse_cuda as RS  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("mode", ["baseline", "batched"])
@pytest.mark.parametrize("n", [5, 13, 30, 33, 38, 40, 47, 64])
def test_kernel_matches_plain_on_card(card, n, mode):
    As = torch.as_tensor(np.random.default_rng(n).uniform(-1, 1, (2, n, n)),
                         device=card)
    A_pads, xb_pads, _ = ops.prepare(As)
    TB, C, Wu, blocks = DEFAULT_GEOMETRY.kernel_geometry(n)
    nb = min(4, blocks)
    geo = dict(n=n, TB=TB, C=C, Wu=Wu, num_blocks=nb, mode=mode)
    top = blocks * TB - nb * TB
    got = RC.ryser_cuda_call(A_pads[0], xb_pads[0], top, **geo)
    want = RC.block_partials_plain(A_pads[:1], xb_pads[:1], top, **geo)[0]
    np.testing.assert_allclose(got.sum(-1).cpu(), want.sum(-1).cpu(),
                               rtol=1e-12, atol=1e-15)
    got = RC.ryser_cuda_call_batched(A_pads, xb_pads, **geo)
    want = RC.block_partials_plain(A_pads, xb_pads, 0, **geo)
    np.testing.assert_allclose(got.sum(-1).cpu(), want.sum(-1).cpu(),
                               rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [5, 13, 22, 30, 40])
def test_schedmat_and_f32_entries_equal_plain_on_card(card, n, dtype):
    """Kernel #1 in schedmat mode (f64 and f32) and in baseline and batched
    mode on f32, and kernel #2 on f32, bit for bit with their plain
    versions, from chunk 0 and from the top of the step space; the batch
    entry refuses schedmat.  Entries U(0.1, 1) * 2 / n keep every f32
    product in range."""
    As = torch.as_tensor(np.random.default_rng(n).uniform(0.1, 1, (2, n, n))
                         * 2 / n, device=card).to(dtype)
    A_pads, xb_pads, _ = ops.prepare(As)
    TB, C, Wu, blocks = DEFAULT_GEOMETRY.kernel_geometry(n)
    nb = min(4, blocks)
    modes = ("baseline", "batched", "schedmat") \
        if dtype == torch.float32 else ("schedmat",)
    for mode in modes:
        geo = dict(n=n, TB=TB, C=C, Wu=Wu, num_blocks=nb, mode=mode)
        for base in (0, blocks * TB - nb * TB):
            got = RC.ryser_cuda_call(A_pads[0], xb_pads[0], base, **geo)
            want = RC.block_partials_plain(A_pads[:1], xb_pads[:1], base,
                                           **geo)[0]
            assert got.dtype == dtype
            assert torch.equal(got, want), (mode, base)
        if mode != "schedmat":
            got = RC.ryser_cuda_call_batched(A_pads, xb_pads, **geo)
            want = RC.block_partials_plain(A_pads, xb_pads, 0, **geo)
            assert got.dtype == dtype and torch.equal(got, want), mode
    with pytest.raises(ValueError, match="batch grid supports"):
        RC.ryser_cuda_call_batched(A_pads, xb_pads, n=n, TB=TB, C=C, Wu=Wu,
                                   num_blocks=nb, mode="schedmat")


def test_f32_values_and_sequential_engine_on_card(card):
    """f32 through permanent_cuda(_batched) stays f32 and within rtol 5e-4
    of the f64 value; perm_ryser_seq on the card within 1e-9 of the
    oracle."""
    from repro_torch.core import oracle
    from repro_torch.core.ryser import perm_ryser_seq
    rng = np.random.default_rng(12)
    for n in (10, 16, 24):
        A = rng.uniform(0.1, 1, (3, n, n))
        f64 = ops.permanent_cuda_batched(A).cpu().numpy()
        for mode in ("baseline", "batched"):
            got = ops.permanent_cuda_batched(A.astype(np.float32), mode=mode)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.cpu().numpy(), f64, rtol=5e-4)
        for mode in ("baseline", "batched", "schedmat"):
            one = ops.permanent_cuda(A[0].astype(np.float32), mode=mode)
            assert one.dtype == torch.float32 and one.ndim == 0
            np.testing.assert_allclose(float(one), f64[0], rtol=5e-4)
    A = rng.uniform(-1, 1, (12, 12))
    np.testing.assert_allclose(float(perm_ryser_seq(A)),
                               oracle.perm_ryser_exact(A), rtol=1e-9)


def test_main_path_on_card_matches_torch_engine(card):
    mats = np.random.default_rng(3).uniform(-1, 1, (4, 14, 14))
    RC.reset_counters()
    got = repro_torch.permanent_batch(mats)
    one = repro_torch.permanent(mats[0])
    assert RC.counters["ryser_dense_batched"] == 1
    assert RC.counters["ryser_dense_scalar"] == 1
    assert RC.counters["block_partials_plain"] == 0
    want = repro_torch.permanent_batch(mats, backend="torch")
    np.testing.assert_allclose(got, want, rtol=1e-9)
    np.testing.assert_allclose(one, want[0], rtol=1e-9)


def _cgauss(rng, shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)) / np.sqrt(2)


# n = 4, 5 (NPAD 8), 13 (NPAD 16), 17 (NPAD 24) and 30 (NPAD 32) leave rows
# past n in the branch-free chain's select region (its last 8 rows),
# n = 16, 24, 32 none; n = 64 takes the chain with a branch a row
@pytest.mark.parametrize("n", [4, 5, 13, 16, 17, 24, 30, 32, 64])
def test_complex_kernel_matches_plain_on_card(card, n):
    """The split-plane kernel repeats its plain version's arithmetic op for
    op, so both entries equal it bit for bit."""
    rng = np.random.default_rng(100 + n)
    As = torch.as_tensor(_cgauss(rng, (2, n, n)), device=card)
    planes = ops.prepare_complex(As)[:4]
    TB, C, Wu, blocks = DEFAULT_GEOMETRY.kernel_geometry(n)
    nb = min(4, blocks)
    geo = dict(n=n, TB=TB, C=C, Wu=Wu, num_blocks=nb)
    top = blocks * TB - nb * TB
    got = RX.ryser_cuda_call_complex(*(p[0] for p in planes), top, **geo)
    want = RX.block_partials_plain_complex(*(p[:1] for p in planes), top,
                                           **geo)[0]
    assert torch.equal(got, want)
    got = RX.ryser_cuda_call_complex_batched(*planes, **geo)
    want = RX.block_partials_plain_complex(*planes, 0, **geo)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n, n_pad", [(9, 24), (20, 32), (30, 48)])
def test_complex_kernel_over_padded_matches_plain_on_card(card, n, n_pad):
    """n_pad past the least multiple of 8 >= n: the chain's rows all go
    through the select, bit for bit as the plain version."""
    rng = np.random.default_rng(400 + n)
    As = torch.as_tensor(_cgauss(rng, (2, n, n)), device=card)
    xbs = torch.complex(ops.nw_base_vector(As.real),
                        ops.nw_base_vector(As.imag))
    planes = (ops.pad_matrix(As.real, n_pad), ops.pad_matrix(As.imag, n_pad),
              *ops.split_base_planes(xbs, n_pad))
    TB, C, Wu, blocks = DEFAULT_GEOMETRY.kernel_geometry(n)
    geo = dict(n=n, TB=TB, C=C, Wu=Wu, num_blocks=min(4, blocks))
    got = RX.ryser_cuda_call_complex_batched(*planes, **geo)
    want = RX.block_partials_plain_complex(*planes, 0, **geo)
    assert torch.equal(got, want)


def test_complex_main_path_on_card_matches_torch_engine(card):
    mats = _cgauss(np.random.default_rng(4), (4, 14, 14))
    RC.reset_counters()
    got = repro_torch.permanent_batch(mats)
    one = repro_torch.permanent(mats[0])
    assert RC.counters["ryser_complex_batched"] == 1
    assert RC.counters["ryser_complex_scalar"] == 1
    assert RC.counters["block_partials_plain_complex"] == 0
    assert got.dtype == np.complex128 and isinstance(one, complex)
    want = repro_torch.permanent_batch(mats, backend="torch")
    np.testing.assert_allclose(got, want, rtol=1e-9)
    np.testing.assert_allclose(one, want[0], rtol=1e-9)


def _sparse(rng, n, cplx=False, extra=0, density=0.2):
    """A sparse matrix with a full diagonal, random nonzeros at ``density``
    and ``extra`` more nonzeros in column 0 (uneven column degrees)."""
    A = rng.uniform(0.5, 1.5, (n, n)) * (rng.uniform(0, 1, (n, n)) < density)
    np.fill_diagonal(A, 1.0)
    A[rng.choice(n, size=extra, replace=False), 0] = 1.25
    if cplx:
        A = A * np.exp(1j * rng.uniform(-np.pi, np.pi, (n, n)))
    return A


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("n", [4, 5, 13, 16, 17, 24, 32, 64])
def test_sparse_kernel_matches_plain_on_card(card, n, cplx):
    """Windows at the top of the step space (scalar) and a B = 3 bucket
    whose maxdeg exceeds each member's own (batched), bit for bit."""
    rng = np.random.default_rng(200 + n)
    mats = [_sparse(rng, n, cplx, extra) for extra in (0, 2, n // 3)]
    A_np, rows_np, vals_np = pack_padded_ccs(
        [SparseMatrix.from_dense(A) for A in mats])
    As = torch.as_tensor(A_np, device=card)
    rows = torch.as_tensor(rows_np, device=card)
    vals = torch.as_tensor(vals_np, device=card)
    TB, C, Wu, blocks = DEFAULT_GEOMETRY.kernel_geometry(n)
    nb = min(4, blocks)
    geo = dict(n=n, TB=TB, C=C, Wu=Wu, num_blocks=nb)
    top = blocks * TB - nb * TB
    if cplx:
        Ar, Ai, xbr, xbi, _ = ops.prepare_complex(As)
        vr, vi = vals.real.contiguous(), vals.imag.contiguous()
        got = RS.ryser_sparse_cuda_call_complex(
            Ar[0], Ai[0], rows[0], vr[0], vi[0], xbr[0], xbi[0], top, **geo)
        want = RS.block_partials_plain_sparse_complex(
            Ar[:1], Ai[:1], rows[:1], vr[:1], vi[:1], xbr[:1], xbi[:1], top,
            **geo)[0]
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        got = RS.ryser_sparse_cuda_call_complex_batched(
            Ar, Ai, rows, vr, vi, xbr, xbi, **geo)
        want = RS.block_partials_plain_sparse_complex(
            Ar, Ai, rows, vr, vi, xbr, xbi, 0, **geo)
    else:
        A_pads, xb_pads, _ = ops.prepare(As)
        got = RS.ryser_sparse_cuda_call(A_pads[0], rows[0], vals[0],
                                        xb_pads[0], top, **geo)
        want = RS.block_partials_plain_sparse(A_pads[:1], rows[:1],
                                              vals[:1], xb_pads[:1], top,
                                              **geo)[0]
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        got = RS.ryser_sparse_cuda_call_batched(A_pads, rows, vals, xb_pads,
                                                **geo)
        want = RS.block_partials_plain_sparse(A_pads, rows, vals, xb_pads, 0,
                                              **geo)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _entry_calls(As, cplx: bool, sparse: bool):
    """(scalar call, batched call, plain call) of one kernel pair on the
    stack ``As`` (B, n, n), each taking (chunk base, **geo); the sparse
    pair gets the stack's padded CCS arrays, in ``As``' dtype."""
    if sparse:
        rows_np, vals_np = padded_ccs(As.cpu().numpy())
        rows = torch.as_tensor(rows_np, device=As.device)
        vals = torch.as_tensor(vals_np, device=As.device)
        if cplx:
            Ar, Ai, xbr, xbi, _ = ops.prepare_complex(As)
            ins = (Ar, Ai, rows, vals.real.contiguous(),
                   vals.imag.contiguous(), xbr, xbi)
            calls = (RS.ryser_sparse_cuda_call_complex,
                     RS.ryser_sparse_cuda_call_complex_batched,
                     RS.block_partials_plain_sparse_complex)
        else:
            A_pads, xb_pads, _ = ops.prepare(As)
            ins = (A_pads, rows, vals, xb_pads)
            calls = (RS.ryser_sparse_cuda_call,
                     RS.ryser_sparse_cuda_call_batched,
                     RS.block_partials_plain_sparse)
        kw = {}
    elif cplx:
        ins = ops.prepare_complex(As)[:4]
        calls = (RX.ryser_cuda_call_complex,
                 RX.ryser_cuda_call_complex_batched,
                 RX.block_partials_plain_complex)
        kw = {}
    else:
        ins = ops.prepare(As)[:2]
        calls = (RC.ryser_cuda_call, RC.ryser_cuda_call_batched,
                 RC.block_partials_plain)
        kw = {"mode": "batched"}
    scalar, batched, plain = calls
    return (lambda base, **geo: scalar(*(t[0] for t in ins), base, **kw,
                                       **geo),
            lambda base, **geo: batched(*ins, **kw, **geo),
            lambda base, **geo: plain(*ins, base, **kw, **geo))


def _entry_stack(rng, n: int, cplx: bool, sparse: bool, dtype, device):
    """A (2, n, n) stack on the card: sparse ones at density 0.2 with a
    full diagonal, entries scaled by 2 / (1 + 0.2 n) so every f32 product
    stays in range; dense ones U(0.1, 1) * 2 / n."""
    if sparse:
        As = np.stack([_sparse(rng, n, cplx, extra) for extra in (0, 2)])
        As = As * 2 / (1 + 0.2 * n)
    else:
        As = rng.uniform(0.1, 1, (2, n, n)) * 2 / n
        if cplx:
            As = As * np.exp(1j * rng.uniform(-np.pi, np.pi, (2, n, n)))
    return torch.as_tensor(As, device=device).to(dtype)


# n = 5, 13, 17, 30, 37 leave rows in the branch-free chains' select
# region; the f32 complex rows run branch-free up to NPAD 48 (n = 37, 48)
@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("n", [5, 13, 16, 17, 24, 30, 32, 37, 48])
def test_f32_complex_and_sparse_entries_equal_plain_on_card(card, n,
                                                            sparse):
    """The _f32 entries of #3/#4 (complex64), #5/#6 (f32) and #7/#8
    (complex64) bit for bit with their plain versions in f32, from chunk
    0 and from the top of the step space, scalar and batched; each
    returns f32 partials."""
    rng = np.random.default_rng(600 + n)
    TB, C, Wu, blocks = DEFAULT_GEOMETRY.kernel_geometry(n)
    nb = min(4, blocks)
    geo = dict(n=n, TB=TB, C=C, Wu=Wu, num_blocks=nb)
    for cplx in ((False, True) if sparse else (True,)):
        dt = torch.complex64 if cplx else torch.float32
        scalar, batched, plain = _entry_calls(
            _entry_stack(rng, n, cplx, sparse, dt, card), cplx, sparse)
        for base in (0, blocks * TB - nb * TB):
            got, want = scalar(base, **geo), plain(base, **geo)[0]
            assert got.dtype == torch.float32
            assert torch.equal(got, want), (cplx, base)
        got, want = batched(0, **geo), plain(0, **geo)
        assert got.dtype == torch.float32 and torch.equal(got, want), cplx


# (lanes, steps_per_chunk, window) the tuner's grid reaches that the
# default 128 x 64 x 16 never runs: TB 32 / 64 / 256, Wu 8 / 32
TUNE_GEOMETRIES = ((32, 32, 8), (64, 128, 32), (256, 64, 16),
                   (256, 256, 32), (32, 256, 8))


@pytest.mark.parametrize("lanes,spc,window", TUNE_GEOMETRIES)
@pytest.mark.parametrize("n", [13, 24])
def test_tuning_geometries_equal_plain_on_card(card, n, lanes, spc, window):
    """Every kernel pair, f64, at the tuner's non-default geometries: bit
    for bit with its plain version on a window of blocks from 0 and at
    the top of the step space (the scalar entry, the campaign wave body's
    launch) and over the batch grid."""
    from repro_torch.core.stepspace import Geometry
    rng = np.random.default_rng(700 + n + lanes + window)
    TB, C, Wu, blocks = Geometry(lanes, spc, window).kernel_geometry(n)
    nb = min(4, blocks)
    geo = dict(n=n, TB=TB, C=C, Wu=Wu, num_blocks=nb)
    for cplx, sparse in ((False, False), (True, False), (False, True),
                         (True, True)):
        dt = torch.complex128 if cplx else torch.float64
        scalar, batched, plain = _entry_calls(
            _entry_stack(rng, n, cplx, sparse, dt, card), cplx, sparse)
        for base in (0, blocks * TB - nb * TB):
            assert torch.equal(scalar(base, **geo), plain(base, **geo)[0]), \
                (cplx, sparse, base)
        assert torch.equal(batched(0, **geo), plain(0, **geo)), (cplx, sparse)


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("n", [4, 13, 16, 17, 24, 32])
def test_sparse_kernel_equals_dense_batched_mode_on_card(card, n, cplx):
    """The scattered low CCS columns equal A's own, so the sparse kernel
    and the dense kernel's batched mode agree bit for bit."""
    rng = np.random.default_rng(300 + n)
    mats = [_sparse(rng, n, cplx, extra) for extra in (0, n // 3)]
    A_np, rows_np, vals_np = pack_padded_ccs(
        [SparseMatrix.from_dense(A) for A in mats])
    As = torch.as_tensor(A_np, device=card)
    rows = torch.as_tensor(rows_np, device=card)
    vals = torch.as_tensor(vals_np, device=card)
    TB, C, Wu, blocks = DEFAULT_GEOMETRY.kernel_geometry(n)
    geo = dict(n=n, TB=TB, C=C, Wu=Wu, num_blocks=min(16, blocks))
    if cplx:
        Ar, Ai, xbr, xbi, _ = ops.prepare_complex(As)
        got = RS.ryser_sparse_cuda_call_complex_batched(
            Ar, Ai, rows, vals.real.contiguous(), vals.imag.contiguous(),
            xbr, xbi, **geo)
        want = RX.ryser_cuda_call_complex_batched(Ar, Ai, xbr, xbi, **geo)
    else:
        A_pads, xb_pads, _ = ops.prepare(As)
        got = RS.ryser_sparse_cuda_call_batched(A_pads, rows, vals, xb_pads,
                                                **geo)
        want = RC.ryser_cuda_call_batched(A_pads, xb_pads, mode="batched",
                                          **geo)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("cplx", [False, True])
def test_sparse_main_path_on_card(card, cplx):
    """The sparse route through the entry points launches only the sparse
    kernels, matches the torch engine, and a scalar leaf equals its bucket
    entry bit for bit (the bucket's maxdeg is larger than its own)."""
    rng = np.random.default_rng(5 + cplx)
    mats = [_sparse(rng, 14, cplx, extra, density=0.1)
            for extra in (0, 3, 1, 2)]
    RC.reset_counters()
    got, reps = repro_torch.permanent_batch(mats, preprocess=False,
                                            return_report=True)
    one, rep = repro_torch.permanent(mats[0], preprocess=False,
                                     return_report=True)
    kind = "sparse_complex" if cplx else "sparse"
    assert RC.counters[f"ryser_{kind}_batched"] == 1
    assert RC.counters[f"ryser_{kind}_scalar"] == 1
    assert sum(RC.counters.values()) == 2
    assert reps[0].dispatch == ["sparse_batch(n=14,b=4)"]
    assert rep.dispatch == ["sparse(n=14,cuda)"]
    assert one == got[0]
    want = repro_torch.permanent_batch(mats, preprocess=False,
                                       backend="torch")
    np.testing.assert_allclose(got, want, rtol=1e-9)


# n = 4, 5 (NPAD 8), 13 (16), 17 (24) and 30 (32) drop rows past n in the
# real chain's select region, n = 16, 24, 32 run every row unconditionally,
# n = 64 keeps a branch a row; over-padded n_pad puts a select on every row
@pytest.mark.parametrize("mode", ["baseline", "batched"])
@pytest.mark.parametrize("n, n_pad", [(4, 8), (5, 8), (13, 16), (16, 16),
                                      (17, 24), (24, 24), (30, 32), (32, 32),
                                      (64, 64), (9, 24), (20, 32), (30, 48)])
def test_real_kernel_equals_plain_bitwise_on_card(card, n, n_pad, mode):
    """The real body's branch-free rows keep its plain version's
    arithmetic op for op: both entries equal it bit for bit."""
    rng = np.random.default_rng(600 + n + n_pad)
    As = torch.as_tensor(rng.uniform(-1, 1, (2, n, n)), device=card)
    A_pads = ops.pad_matrix(As, n_pad)
    xb_pads = ops.pad_base_vector(ops.nw_base_vector(As), n_pad)[..., None]
    TB, C, Wu, blocks = DEFAULT_GEOMETRY.kernel_geometry(n)
    nb = min(4, blocks)
    geo = dict(n=n, TB=TB, C=C, Wu=Wu, num_blocks=nb, mode=mode)
    top = blocks * TB - nb * TB
    got = RC.ryser_cuda_call(A_pads[0], xb_pads[0], top, **geo)
    want = RC.block_partials_plain(A_pads[:1], xb_pads[:1], top, **geo)[0]
    assert torch.equal(got, want)
    got = RC.ryser_cuda_call_batched(A_pads, xb_pads, **geo)
    assert torch.equal(got, RC.block_partials_plain(A_pads, xb_pads, 0,
                                                    **geo))


def _extent(rng, n, R, kw, extra=0, negzero=False):
    """Real, density about 0.25 with a full diagonal, whose kw low columns
    touch exactly the rows below R; ``extra`` more nonzeros in column kw;
    ``negzero``: zeros stored as -0.0 and, if R < n - 1, an untouched last
    row whose entries cancel (0.5, -0.5)."""
    A = rng.uniform(0.5, 1.5, (n, n)) * (rng.uniform(0, 1, (n, n)) < 0.25)
    np.fill_diagonal(A, 1.0)
    A[R:, :kw] = 0.0
    A[R - 1, 0] = 0.75
    if extra:
        A[rng.choice(n, size=min(extra, n), replace=False), kw] = 1.25
    if negzero:
        if R < n - 1 and kw + 1 < n:
            A[n - 1] = 0.0
            A[n - 1, kw], A[n - 1, kw + 1] = 0.5, -0.5
        A = np.where(A == 0.0, -0.0, A)
    return A


# (n, R of each member, -0.0 zeros): R < 8 alone; R = n; n no multiple of
# 8; a bucket of four RPAD variants and maxdegs at NPAD 32; the -0.0 leaf
# with a cancelling untouched row; NPAD 64 (rows with a branch)
@pytest.mark.parametrize("n, Rs, negzero", [
    (13, (3, 5, 7), False), (24, (24, 24, 24), False),
    (22, (5, 12, 22), False), (30, (9, 17, 30), False),
    (32, (3, 10, 20, 32), False), (24, (5, 9, 18), True),
    (64, (5, 33, 64), False)])
def test_sparse_kernel_rpad_variants_equal_plain_on_card(card, n, Rs,
                                                         negzero):
    """The real sparse kernel runs the window loop of RPAD = R rounded up
    to 8, R derived per member: both entries equal the plain version and
    the dense batched mode bit for bit (every member through the scalar
    entry at the top of the step space)."""
    rng = np.random.default_rng(700 + n + len(Rs))
    TB, C, Wu, blocks = DEFAULT_GEOMETRY.kernel_geometry(n)
    kw = int(np.log2(Wu))
    mats = [_extent(rng, n, R, kw, extra, negzero)
            for R, extra in zip(Rs, (0, 2, 5, 1))]
    A_np, rows_np, vals_np = pack_padded_ccs(
        [SparseMatrix.from_dense(A) for A in mats])
    As = torch.as_tensor(A_np, device=card)
    rows = torch.as_tensor(rows_np, device=card)
    vals = torch.as_tensor(vals_np, device=card)
    assert RS.low_column_rows(rows, kw, n).tolist() == list(Rs)
    A_pads, xb_pads, _ = ops.prepare(As)
    nb = min(4, blocks)
    geo = dict(n=n, TB=TB, C=C, Wu=Wu, num_blocks=nb)
    top = blocks * TB - nb * TB
    for b in range(len(mats)):
        got = RS.ryser_sparse_cuda_call(A_pads[b], rows[b], vals[b],
                                        xb_pads[b], top, **geo)
        want = RS.block_partials_plain_sparse(
            A_pads[b:b + 1], rows[b:b + 1], vals[b:b + 1],
            xb_pads[b:b + 1], top, **geo)[0]
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    geo["num_blocks"] = min(16, blocks)
    got = RS.ryser_sparse_cuda_call_batched(A_pads, rows, vals, xb_pads,
                                            **geo)
    torch.testing.assert_close(got, RS.block_partials_plain_sparse(
        A_pads, rows, vals, xb_pads, 0, **geo), rtol=0, atol=0)
    torch.testing.assert_close(got, RC.ryser_cuda_call_batched(
        A_pads, xb_pads, mode="batched", **geo), rtol=0, atol=0)


def test_sparse_main_path_orders_real_leaves_on_card(card):
    """A band leaf on the sparse route runs on its ordered form (R = 8 of
    20 rows): the value is within 1e-12 of the kernel on the leaf as it
    comes and within 1e-9 of the torch engine; a bucket entry equals it."""
    rng = np.random.default_rng(9)
    i, j = np.indices((20, 20))
    band = np.where((j - i) % 20 < 5, rng.uniform(0.5, 1.5, (20, 20)), 0.0)
    A = band[rng.permutation(20)][:, rng.permutation(20)]
    TB, C, Wu, blocks = DEFAULT_GEOMETRY.kernel_geometry(20)
    rows, vals = (torch.as_tensor(x, device=card)
                  for x in SparseMatrix.from_dense(A).padded_columns())
    _, _, R = ops.sparse_leaf_order(rows[None], int(np.log2(Wu)))
    assert int(R[0]) == 8
    RC.reset_counters()
    got = repro_torch.permanent(A, preprocess=False)
    assert RC.counters["ryser_sparse_scalar"] == 1
    A_pads, xb_pads, xbs = ops.prepare(torch.as_tensor(A, device=card))
    out = RS.ryser_sparse_cuda_call(A_pads, rows, vals, xb_pads, 0, n=20,
                                    TB=TB, C=C, Wu=Wu, num_blocks=blocks)
    as_comes = float(ops._reduce_real(out, xbs, 20))
    assert abs(got - as_comes) <= 1e-12 * abs(as_comes)
    want = repro_torch.permanent(A, preprocess=False, backend="torch")
    assert abs(got - want) <= 1e-9 * abs(want)
    other = _extent(rng, 20, 20, int(np.log2(Wu)), extra=4)
    assert repro_torch.permanent_batch([A, other], preprocess=False)[0] == got


@pytest.mark.parametrize("n", [40, 48, 64])
def test_scalar_entries_from_large_chunk_bases_on_card(card, n):
    """The four scalar entries (the dense one in both modes) from the last
    chunks of the 2^(n-1) step space and from around 2^(n-2), where a
    campaign's slices start: bit for bit with their plain versions."""
    rng = np.random.default_rng(800 + n)
    TB, C, Wu, nb = 32, 64, 16, 2
    geo = dict(n=n, TB=TB, C=C, Wu=Wu, num_blocks=nb)
    chunks = (1 << (n - 1)) // C
    A_pads, xb_pads, _ = ops.prepare(torch.as_tensor(
        rng.uniform(-1, 1, (1, n, n)) / 2, device=card))
    cx = ops.prepare_complex(torch.as_tensor(
        _cgauss(rng, (1, n, n)) / 2, device=card))[:4]
    sp = [torch.as_tensor(x, device=card) for x in pack_padded_ccs(
        [SparseMatrix.from_dense(_sparse(rng, n, False, 3))])]
    A_sp, rows, vals, xb_sp = ops.prepare_sparse(*sp, Wu)[:4]
    spx = [torch.as_tensor(x, device=card) for x in pack_padded_ccs(
        [SparseMatrix.from_dense(_sparse(rng, n, True, 3))])]
    Ar, Ai, xbr, xbi, _ = ops.prepare_complex(spx[0])
    spx_in = (Ar, Ai, spx[1], spx[2].real.contiguous(),
              spx[2].imag.contiguous(), xbr, xbi)
    for base in (chunks - nb * TB, chunks // 2 - nb * TB // 2):
        for mode in ("baseline", "batched"):
            torch.testing.assert_close(
                RC.ryser_cuda_call(A_pads[0], xb_pads[0], base, mode=mode,
                                   **geo),
                RC.block_partials_plain(A_pads, xb_pads, base, mode=mode,
                                        **geo)[0], rtol=0, atol=0)
        torch.testing.assert_close(
            RX.ryser_cuda_call_complex(*(p[0] for p in cx), base, **geo),
            RX.block_partials_plain_complex(*cx, base, **geo)[0],
            rtol=0, atol=0)
        torch.testing.assert_close(
            RS.ryser_sparse_cuda_call(A_sp[0], rows[0], vals[0], xb_sp[0],
                                      base, **geo),
            RS.block_partials_plain_sparse(A_sp, rows, vals, xb_sp, base,
                                           **geo)[0], rtol=0, atol=0)
        torch.testing.assert_close(
            RS.ryser_sparse_cuda_call_complex(*(t[0] for t in spx_in), base,
                                              **geo),
            RS.block_partials_plain_sparse_complex(*spx_in, base, **geo)[0],
            rtol=0, atol=0)


@pytest.mark.parametrize("n,cplx", [(40, False), (32, True)])
def test_campaign_wave_body_at_main_path_lanes_on_card(card, n, cplx):
    """The campaign wave body at the main path's TB = 128 (small C): kernel
    #1 in batched mode (#3 for complex) equals its plain version bit for
    bit, and so do the per-slice sums of two slices from chunk base 0, the
    middle and the end of the space."""
    rng = np.random.default_rng(900 + n)
    A = rng.uniform(-1, 1, (n, n)) / 2
    if cplx:
        A = _cgauss(rng, (n, n)) / 2
    A = torch.as_tensor(A, device=card)
    cps, C, Wu, TB = 256, 1 << 10, 16, 128
    geo = dict(n=n, TB=TB, C=C, Wu=Wu, num_blocks=2 * cps // TB)
    slices = (1 << (n - 1)) // C // cps
    for first in (0, slices // 2 - 1, slices - 2):
        base = first * cps
        hi, lo = ops.campaign_slice_sums(A, first, 2, chunks_per_slice=cps,
                                         chunk_size=C, device=card)
        if cplx:
            ins = ops.prepare_complex(A[None])[:4]
            got = RX.ryser_cuda_call_complex(*(t[0] for t in ins), base,
                                             **geo)
            plain = RX.block_partials_plain_complex(*ins, base, **geo)[0]
            re = ops._slice_sums(plain[:, 0], plain[:, 1], 2)
            im = ops._slice_sums(plain[:, 2], plain[:, 3], 2)
            want = (torch.complex(re[0], im[0]), torch.complex(re[1], im[1]))
        else:
            A_pads, xb_pads, _ = ops.prepare(A[None])
            got = RC.ryser_cuda_call(A_pads[0], xb_pads[0], base,
                                     mode="batched", **geo)
            plain = RC.block_partials_plain(A_pads, xb_pads, base,
                                            mode="batched", **geo)[0]
            want = ops._slice_sums(plain[:, 0], plain[:, 1], 2)
        torch.testing.assert_close(got, plain, rtol=0, atol=0)
        torch.testing.assert_close(hi, want[0], rtol=0, atol=0)
        torch.testing.assert_close(lo, want[1], rtol=0, atol=0)


@pytest.mark.parametrize("n,cplx", [(40, False), (32, True)])
def test_single_precision_wave_body_equals_plain_on_card(card, n, cplx):
    """f32 and complex64 campaigns keep their dtype: the wave body is #1's
    ``_f32`` entry in batched mode (#3's for complex64) from u64 chunk
    bases at the start, middle and end of the space, bit for bit its plain
    version, and the per-slice sums come back in that dtype."""
    rng = np.random.default_rng(950 + n)
    A = _cgauss(rng, (n, n)) / 2 if cplx else rng.uniform(-1, 1, (n, n)) / 2
    A = torch.as_tensor(A, device=card,
                        dtype=torch.complex64 if cplx else torch.float32)
    cps, C, Wu, TB = 256, 1 << 10, 16, 128
    geo = dict(n=n, TB=TB, C=C, Wu=Wu, num_blocks=2 * cps // TB)
    slices = (1 << (n - 1)) // C // cps
    entry = ("ryser_complex_scalar" if cplx else "ryser_dense_scalar") \
        + "_f32"
    before = (RX.counters if cplx else RC.counters)[entry]
    for first in (0, slices // 2 - 1, slices - 2):
        base = first * cps
        hi, lo = ops.campaign_slice_sums(A, first, 2, chunks_per_slice=cps,
                                         chunk_size=C, device=card)
        assert hi.dtype == lo.dtype == A.dtype
        if cplx:
            ins = ops.prepare_complex(A[None])[:4]
            plain = RX.block_partials_plain_complex(*ins, base, **geo)[0]
            re = ops._slice_sums(plain[:, 0], plain[:, 1], 2)
            im = ops._slice_sums(plain[:, 2], plain[:, 3], 2)
            want = (torch.complex(re[0], im[0]), torch.complex(re[1], im[1]))
        else:
            A_pads, xb_pads, _ = ops.prepare(A[None])
            plain = RC.block_partials_plain(A_pads, xb_pads, base,
                                            mode="batched", **geo)[0]
            want = ops._slice_sums(plain[:, 0], plain[:, 1], 2)
        torch.testing.assert_close(hi, want[0], rtol=0, atol=0)
        torch.testing.assert_close(lo, want[1], rtol=0, atol=0)
    assert (RX.counters if cplx else RC.counters)[entry] - before == 3


def test_chunk_size_past_the_space_refused_on_card(card):
    """A chunk size past the 2^(n-1) step space, or a chunk range past it,
    is refused by the wrapper (ValueError) and by the C entry (rc 1,
    cudaErrorInvalidValue) before any launch."""
    from repro_torch.kernels import build
    n = 40
    A_pad = torch.zeros((40, 40), dtype=torch.float64, device=card)
    xb = torch.ones((40, 1), dtype=torch.float64, device=card)
    with pytest.raises(ValueError, match="step space"):
        RC.ryser_cuda_call(A_pad, xb, 0, n=n, TB=32, C=1 << n, Wu=16,
                           num_blocks=1)
    with pytest.raises(ValueError, match="step space"):
        RC.ryser_cuda_call(A_pad, xb, (1 << 33) - 31, n=n, TB=32, C=64,
                           Wu=16, num_blocks=1)
    lib = build.load_library()
    p, s = A_pad.data_ptr(), torch.cuda.current_stream().cuda_stream
    for base, c_log2 in ((0, n), ((1 << 33) - 31, 6), (1 << 63, 6)):
        assert lib.ryser_dense_scalar(p, p, p, p, base, n, 40, 32, c_log2,
                                      4, 1, 2, 1, s) == 1
        assert lib.ryser_complex_scalar(p, p, p, p, p, p, base, n, 40, 32,
                                        c_log2, 4, 1, 2, s) == 1


def test_campaign_kill_and_resume_on_card(card, tmp_path):
    """n = 32 through the campaign CLI on the card: SIGKILLed after its
    first wave and resumed, it prints the value of an uninterrupted run
    bit for bit; the uninterrupted value is within 1e-9 of the direct
    scalar kernel.  2048 slices make about 40 waves at the default W, so
    the kill lands with most of the job pending."""
    from repro_torch.core.resume import JobState
    from repro_torch.core.solver import PermanentSolver
    A = np.random.default_rng(32).uniform(0.2, 1.2, (32, 32))
    np.save(tmp_path / "A.npy", A)
    solver = PermanentSolver(preprocess=False, campaign_threshold=-1.0,
                             campaign_slices=2048, cache=False)
    ref = solver.execute(solver.plan(A))
    direct = PermanentSolver(campaign_threshold=None, preprocess=False)
    want = direct.execute(direct.plan(A))
    # the value bar: two chunk geometries round apart on this positive
    # matrix (3.3e-11 between C = 2^13 and the direct kernel's 64) (Ryser's alternating sum cancels
    # terms two orders above the permanent)
    assert abs(ref - want) <= 1e-9 * abs(want)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    args = [sys.executable, "-m", "repro_torch.launch.campaign", "--matrix",
            str(tmp_path / "A.npy"), "--slices", "2048", "--checkpoint",
            str(tmp_path / "job.npz")]
    env = dict(os.environ, PYTHONPATH=src)
    p = subprocess.Popen(args, env=env,
                         stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    try:
        for line in p.stdout:
            if "[campaign] wave" in line:
                os.kill(p.pid, signal.SIGKILL)
                break
        p.wait(timeout=300)
    finally:
        p.stdout.close()
        if p.poll() is None:
            p.kill()
            p.wait(timeout=60)
    assert 0 < JobState.load(str(tmp_path / "job.npz")).fraction_done() < 1
    r = subprocess.run(args, env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr[-3000:]
    assert f"perm(A) = {ref:+.17e}" in r.stdout


def test_prove_kernel_entries_equal_cpu_goldens_on_card(card):
    """torchprove's cuda entries run kernels #1-#8 (and the f32 twins
    twice): no finding, and every value equals the CPU golden bit for
    bit."""
    from repro_torch.analysis import prove
    from repro_torch.kernels.build import ENTRIES
    RC.reset_counters()
    report = prove.run_check(entries="*_cuda.*", device="cuda")
    assert report["findings"] == []
    assert report["goldens"]["drifted"] == []
    assert report["goldens"]["missing"] == []
    assert RC.counters["block_partials_plain"] == 0
    assert all(RC.counters[f"{e}{t}"] > 0 for e in ENTRIES
               for t in ("", "_f32"))


def test_large_permanent_example_resumes_bit_for_bit_on_card(card):
    from repro_torch.examples import large_permanent
    out = large_permanent.main("cuda")
    assert out["bitwise"] and out["value"] == out["uninterrupted"]
    assert out["rel"] < large_permanent.ENGINE_RTOL[True]


# ---------------------------------------------------------------------------
# a world of two ranks on the card (launch/mesh.py, core/distributed.py)
# ---------------------------------------------------------------------------

def _mesh_inputs():
    rng = np.random.default_rng(2020)
    A = rng.uniform(-1, 1, (24, 24))
    Ac = A + 1j * rng.uniform(-1, 1, (24, 24))
    S = rng.uniform(-1, 1, (37, 16, 16))
    i, j = np.indices((16, 16))
    band = (j - i) % 16 < 4
    return A, Ac, S, S + 1j * rng.uniform(-1, 1, S.shape), S * band


def _card_world(rank: int, world: int) -> dict:
    """Both ranks share the card (ranks_per_device = world): the step
    split, the four sharded bucket entries, each rank's launches."""
    from repro_torch.core import distributed as D
    from repro_torch.launch import mesh as M
    mesh = M.make_mesh((world,), ("step",), ranks_per_device=world)
    A, Ac, S, Sc, Sp = _mesh_inputs()
    RC.reset_counters()
    out = {"device": str(mesh.device),
           "pom": [D.permanent_on_mesh(X, mesh) for X in (A, Ac)],
           "dense": [D.batch_permanents_on_mesh(X, mesh) for X in (S, Sc)],
           "sparse": [D.sparse_batch_permanents_on_mesh(X, mesh)
                      for X in (Sp, Sp * (1 + 0.5j))]}
    out["counters"] = dict(RC.counters)
    return out


def test_world_of_two_ranks_on_card_equals_one_device(card, tmp_path):
    """Two ranks on the one card: every mesh value equals the one-device
    entries' bit for bit, each rank launched the kernels (#1, #3 for the
    step split; #2, #4, #6, #8 for the bucket shards) and no plain
    version."""
    from repro_torch.core import distributed as D
    from repro_torch.core.stepspace import plan_slices
    from repro_torch.launch import mesh as M
    ranks = M.run_world(_card_world, 2, str(tmp_path / "w"), timeout_s=300)
    A, Ac, S, Sc, Sp = _mesh_inputs()
    ts, cps, C = plan_slices(24, 2, 1, D.MESH_LANES)
    want_pom = [D.run_campaign(X, total_slices=ts, chunks_per_slice=cps,
                               chunk_size=C)[0] for X in (A, Ac)]
    want_dense = [ops.permanent_cuda_batched(X).cpu().numpy()
                  for X in (S, Sc)]
    want_sparse = [ops.sparse_batched_values_cuda(X, *padded_ccs(X))
                   .cpu().numpy() for X in (Sp, Sp * (1 + 0.5j))]
    for out in ranks:
        assert out["device"] == "cuda:0"
        assert out["pom"] == want_pom
        for got, want in zip(out["dense"] + out["sparse"],
                             want_dense + want_sparse):
            assert np.array_equal(got, want)
        c = out["counters"]
        assert all(c[k] > 0 for k in (
            "ryser_dense_scalar", "ryser_complex_scalar",
            "ryser_dense_batched", "ryser_complex_batched",
            "ryser_sparse_batched", "ryser_sparse_complex_batched"))
        assert not any(v for k, v in c.items()
                       if k.startswith("block_partials"))


def _card_service(rank: int, world: int) -> dict:
    """A service over both ranks on the card: shard 0 drives a stream of
    dense real and complex n = 16 requests (three buckets a kind and a
    lone one), the other rank follows; each rank's launches."""
    from repro_torch.core.planner import SolverConfig
    from repro_torch.launch import mesh as M
    from repro_torch.serve import PermanentService, ServiceConfig
    mesh = M.make_batch_mesh(ranks_per_device=world)
    RC.reset_counters()
    svc = PermanentService(SolverConfig(backend="distributed", cache=False),
                           ServiceConfig(max_batch=8, quantize_buckets=False,
                                         log_every_s=float("inf")),
                           distributed_ctx=mesh, log=None)
    out = {"device": str(mesh.device)}
    if svc.leader:
        with svc:
            ts = [svc.submit(A, deadline_s=None) for A in _service_stream()]
            svc.drain()
        out["values"] = [t.result() for t in ts]
    else:
        out["follower"] = svc.follow()
    out["counters"] = dict(RC.counters)
    return out


def _service_stream() -> list:
    rng = np.random.default_rng(2121)
    real = [rng.uniform(-1, 1, (16, 16)) for _ in range(25)]
    return real + [A + 1j * rng.uniform(-1, 1, A.shape) for A in real]


def test_world_of_two_service_on_card_equals_one_device(card, tmp_path):
    """The service over two ranks sharing the card: every member of the
    full buckets bit for bit the one-device service's, the lone requests
    (a bucket of one over the mesh, the scalar entry on one device) within
    1e-12; both ranks launched #2 and #4, no plain version."""
    from repro_torch.core.planner import SolverConfig
    from repro_torch.launch import mesh as M
    from repro_torch.serve import PermanentService, ServiceConfig
    lead, follower = M.run_world(_card_service, 2, str(tmp_path / "w"),
                                 timeout_s=300)
    svc = PermanentService(SolverConfig(cache=False), ServiceConfig(
        max_batch=8, quantize_buckets=False, log_every_s=float("inf")),
        log=None)
    ts = [svc.submit(A, deadline_s=None) for A in _service_stream()]
    svc.drain()
    want = [t.result() for t in ts]
    for i, (g, w) in enumerate(zip(lead["values"], want)):
        if i % 25 == 24:                     # the lone request of a kind
            assert abs(g - w) <= 1e-12 * abs(w)
        else:
            assert g == w, i
    assert follower["follower"]["dispatches"] == 8
    for out in (lead, follower):
        c = out["counters"]
        assert out["device"] == "cuda:0"
        assert c["ryser_dense_batched"] >= 3 and \
            c["ryser_complex_batched"] >= 3
        assert not any(v for k, v in c.items()
                       if k.startswith("block_partials"))


def test_mesh_entries_pass_pt104_on_card(card):
    from repro_torch.analysis import prove
    report = prove.run_check(entries="mesh_*", device="cuda")
    assert report["findings"] == []
    assert sorted(report["pt104"]) == sorted(prove.MESH_ENTRIES)


@pytest.mark.parametrize("strategy", ["distributed", "distributed_batch"])
def test_distributed_strategies_without_mesh_launch_kernels_on_card(
        card, strategy):
    """No mesh on the card: the ``cuda`` body (kernels #1 and #2), bit
    for bit the ``cuda`` backend's, and no plain version."""
    A, _, S, _, _ = _mesh_inputs()
    want = (repro_torch.permanent(A), repro_torch.permanent_batch(S))
    RC.reset_counters()
    got = (repro_torch.permanent(A, backend=strategy),
           repro_torch.permanent_batch(S, backend=strategy))
    assert got[0] == want[0] and np.array_equal(got[1], want[1])
    c = RC.counters
    assert c["ryser_dense_scalar"] == 1 and c["ryser_dense_batched"] >= 1
    assert not any(v for k, v in c.items() if k.startswith("block_partials"))
