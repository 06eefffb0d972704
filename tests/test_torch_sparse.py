"""The port's sparse route (SpaRyser, real and complex) vs the reference, on
the CPU.

(a) the sparse kernels' plain versions against the reference Pallas sparse
kernels in interpret mode: per-block partials at rtol 1e-12 / atol 1e-15
(tests/test_kernels.py's bar), five precisions, n == n_pad, a Wu = 2
geometry, uneven ``maxdeg``; (b) the torch sparse engines against
``repro.core.sparyser`` at equal chunking within 1e-12, worst ulp gap
reported; (c) the entries against the reference and the oracle within
1e-9; (d) batch invariance bit for bit; (e) the order a real leaf takes
for the sparse kernel (``ops.order_sparse_leaves``); (f) dispatch tags,
interop and the CLI.  On the CPU every kernel wrapper runs its plain
version; the kernels themselves are held against them on the card
(``chip_smoke.py``, ``tests/test_torch_cuda.py``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core.engine as REF  # noqa: E402
from repro.core import oracle  # noqa: E402
from repro.core import sparyser as RSP  # noqa: E402
from repro.core.ryser import nw_base_vector  # noqa: E402
from repro.core.stepspace import Geometry as RefGeometry  # noqa: E402
from repro.kernels import ops as OPS  # noqa: E402
from repro.kernels import ryser_sparse as RPS  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import sparyser as TSP  # noqa: E402
from repro_torch.core.stepspace import Geometry  # noqa: E402
from repro_torch.kernels import ops as TOPS  # noqa: E402
from repro_torch.kernels import ryser_cuda as RC  # noqa: E402
from repro_torch.kernels import ryser_sparse_cuda as RS  # noqa: E402
from repro_torch.launch.permanent import permanent_main  # noqa: E402

PRECISIONS = ("dd", "dq_fast", "dq_acc", "qq", "kahan")
GEO = Geometry(8, 8, 4)


def _sparse(rng, n, cplx=False, extra=0, density=0.2):
    """A full diagonal, random nonzeros at ``density`` and ``extra`` more in
    column 0 (uneven column degrees)."""
    A = rng.uniform(0.5, 1.5, (n, n)) * (rng.uniform(0, 1, (n, n)) < density)
    np.fill_diagonal(A, 1.0)
    A[rng.choice(n, size=min(extra, n), replace=False), 0] = 1.25
    if cplx:
        A = A * np.exp(1j * rng.uniform(-np.pi, np.pi, (n, n)))
    return A


def _ulps(a, b) -> float:
    a, b = np.atleast_1d(a), np.atleast_1d(b)
    parts = [(a.real, b.real), (a.imag, b.imag)]
    return max(float(np.max(np.abs(x - y) / np.spacing(np.maximum(
        np.abs(x), np.abs(y))))) for x, y in parts)


def _packed(mats):
    """The reference's packing of a bucket (numpy), bucket-wide maxdeg."""
    return RSP.pack_padded_ccs([RSP.SparseMatrix.from_dense(A)
                                for A in mats])


def _ref_inputs(A_stack, vals, cplx):
    """The reference's padded kernel inputs of a stack, as numpy: real
    ``(A_pads, vals, xb_pads)``, complex ``(Ar, Ai, vr, vi, xbr, xbi)``."""
    As = jnp.asarray(A_stack)
    xbs = jnp.stack([nw_base_vector(A) for A in As])
    if cplx:
        Ar, Ai = OPS.split_matrix_planes(As)
        xbr, xbi = OPS.split_base_planes(xbs, Ar.shape[-1])
        return [np.asarray(x) for x in (Ar, Ai, np.real(vals), np.imag(vals),
                                        xbr, xbi)]
    A_pads = np.stack([np.asarray(OPS.pad_matrix(A)) for A in As])
    n_pad = A_pads.shape[-1]
    xb = np.stack([np.asarray(OPS.pad_base_vector(x, n_pad)) for x in xbs])
    return [A_pads, vals, xb[..., None]]


def _pair(mats, cplx, geometry, precision, *, base=0, num_blocks=None,
          batched=False):
    """(port partials, reference partials) as numpy for the scalar entry
    on mats[0] from chunk ``base``, or the batched entry on all of mats."""
    n = mats[0].shape[0]
    TB, C, Wu, blocks = geometry.kernel_geometry(n)
    geo = dict(n=n, TB=TB, C=C, Wu=Wu, num_blocks=num_blocks or blocks,
               precision=precision)
    A_stack, rows, vals = _packed(mats)
    ins = _ref_inputs(A_stack, vals, cplx)
    if cplx:
        Ar, Ai, vr, vi, xbr, xbi = ins
        ref_in = [Ar, Ai, rows, vr, vi, xbr, xbi]
        ref_s, ref_b = (RPS.ryser_sparse_pallas_call_complex,
                        RPS.ryser_sparse_pallas_call_complex_batched)
        port_s, port_b = (RS.ryser_sparse_cuda_call_complex,
                          RS.ryser_sparse_cuda_call_complex_batched)
    else:
        A_pads, vals, xb = ins
        ref_in = [A_pads, rows, vals, xb]
        ref_s, ref_b = (RPS.ryser_sparse_pallas_call,
                        RPS.ryser_sparse_pallas_call_batched)
        port_s, port_b = (RS.ryser_sparse_cuda_call,
                          RS.ryser_sparse_cuda_call_batched)
    jx = [jnp.asarray(np.ascontiguousarray(x)) for x in ref_in]
    tx = [torch.tensor(np.ascontiguousarray(x)) for x in ref_in]
    if batched:
        want = ref_b(*jx, interpret=True, **geo)
        got = port_b(*tx, **geo)
    else:
        want = ref_s(*(x[0] for x in jx), base, interpret=True, **geo)
        got = port_s(*(x[0] for x in tx), base, **geo)
    return got.numpy(), np.asarray(want)


def _close(got, want):
    """Per block and per component: (hi + lo) of each pair of columns."""
    assert got.shape == want.shape
    np.testing.assert_allclose(got[..., 0::2] + got[..., 1::2],
                               want[..., 0::2] + want[..., 1::2],
                               rtol=1e-12, atol=1e-15)


# ---------------------------------------------------------------------------
# (a) plain versions vs the reference Pallas sparse kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("n", [4, 5, 13, 16, 17])
def test_sparse_plain_matches_pallas(n, precision, cplx):
    """Scalar entry over up to 8 blocks at the top of the step space (the
    whole space below n = 13); n = 16 has n == n_pad, so the padded CCS
    entries point past U and must be skipped."""
    rng = np.random.default_rng(500 + n)
    A = _sparse(rng, n, cplx, extra=n // 3)
    _, _, _, blocks = GEO.kernel_geometry(n)
    nb = min(8, blocks)
    base = (blocks - nb) * GEO.kernel_geometry(n)[0]
    got, want = _pair([A], cplx, GEO, precision, base=base, num_blocks=nb)
    _close(got, want)
    if precision not in ("dq_acc", "dq_fast"):
        assert not got[:, 1::2].any()


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("precision", ["dd", "dq_acc", "kahan"])
@pytest.mark.parametrize("n", [5, 16])
def test_sparse_batched_plain_matches_pallas_uneven_maxdeg(n, precision,
                                                           cplx):
    """B = 3 with the bucket-wide maxdeg above each member's own."""
    rng = np.random.default_rng(510 + n)
    mats = [_sparse(rng, n, cplx, extra) for extra in (0, 1, n - 2)]
    degs = [RSP.SparseMatrix.from_dense(A).padded_columns()[0].shape[1]
            for A in mats]
    assert min(degs) < max(degs)
    got, want = _pair(mats, cplx, GEO, precision, batched=True)
    _close(got, want)


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("geometry", [(4, 4, 2), (8, 8, 8), (16, 16, 16)])
def test_sparse_plain_matches_pallas_geometries(geometry, cplx):
    """Wu = 2 (kw = 1: the mid column is column 0) and Wu == C (bit kw of a
    window base is the chunk's parity bit), at the top of the space."""
    rng = np.random.default_rng(520)
    A = _sparse(rng, 9, cplx, extra=3)
    geo = Geometry(*geometry)
    TB, _, _, blocks = geo.kernel_geometry(9)
    nb = max(1, blocks // 2)
    got, want = _pair([A], cplx, geo, "dq_acc", base=(blocks - nb) * TB,
                      num_blocks=nb)
    _close(got, want)


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("n", [5, 16])
def test_sparse_plain_equals_dense_batched_mode(n, cplx):
    """The scattered low CCS columns equal A's own, so the sparse plain
    version is the dense batched mode's bit for bit on the same matrices
    (what ryser_kernels.cuh's shared body relies on)."""
    from repro_torch.kernels import ryser_complex_cuda as RX
    rng = np.random.default_rng(530 + n)
    A_stack, rows, vals = TSP.pack_padded_ccs([TSP.SparseMatrix.from_dense(
        _sparse(rng, n, cplx, extra)) for extra in (0, n // 3)])
    TB, C, Wu, blocks = GEO.kernel_geometry(n)
    geo = dict(n=n, TB=TB, C=C, Wu=Wu, num_blocks=min(8, blocks),
               precision="dq_acc")
    As, rows = torch.as_tensor(A_stack), torch.as_tensor(rows)
    vals = torch.as_tensor(vals)
    if cplx:
        Ar, Ai, xbr, xbi, _ = TOPS.prepare_complex(As)
        got = RS.block_partials_plain_sparse_complex(
            Ar, Ai, rows, vals.real.contiguous(), vals.imag.contiguous(), xbr,
            xbi, 0, **geo)
        want = RX.block_partials_plain_complex(Ar, Ai, xbr, xbi, 0, **geo)
    else:
        A_pads, xb_pads, _ = TOPS.prepare(As)
        got = RS.block_partials_plain_sparse(A_pads, rows, vals, xb_pads, 0,
                                             **geo)
        want = RC.block_partials_plain(A_pads, xb_pads, 0, mode="batched",
                                       **geo)
    assert torch.equal(got, want)


def test_scatter_skips_rows_past_n_pad():
    """U of an n == n_pad matrix: padded entries (row n) land nowhere; with
    n < n_pad they add 0 to the padded row, which stays 0."""
    for n in (8, 6):
        A = np.zeros((n, n))
        A[:, 0] = np.arange(1, n + 1)
        A[0, 1] = 7.0
        _, rows, vals = TSP.pack_padded_ccs([TSP.SparseMatrix.from_dense(A)])
        U = RS._scatter_low_columns(torch.tensor(rows), torch.tensor(vals),
                                    2, 8)
        assert U.shape == (1, 8, 2)
        np.testing.assert_array_equal(U[0, :n, 0].numpy(), A[:, 0])
        np.testing.assert_array_equal(U[0, :n, 1].numpy(), A[:, 1])
        assert not U[0, n:].any()


def test_sparse_wrappers_check_inputs():
    A = torch.zeros(16, 16, dtype=torch.float64)
    xb = torch.ones(16, 1, dtype=torch.float64)
    rows = torch.full((10, 3), 10, dtype=torch.int32)
    vals = torch.zeros(10, 3, dtype=torch.float64)
    geo = dict(n=10, TB=8, C=8, Wu=4, num_blocks=8)
    with pytest.raises(TypeError, match="int32"):
        RS.ryser_sparse_cuda_call(A, rows.long(), vals, xb, 0, **geo)
    with pytest.raises(ValueError, match="rows shape"):
        RS.ryser_sparse_cuda_call(A, rows[:9], vals[:9], xb, 0, **geo)
    with pytest.raises(ValueError, match="vals"):
        RS.ryser_sparse_cuda_call(A, rows, vals.float(), xb, 0, **geo)
    with pytest.raises(ValueError, match="step space"):
        RS.ryser_sparse_cuda_call(A, rows, vals, xb, 8, **geo)
    with pytest.raises(ValueError, match="re plane"):
        RS.ryser_sparse_cuda_call_complex(A, A[:8, :8], rows, vals, vals, xb,
                                          xb, 0, **geo)
    meta = [t.to("meta") for t in (A, rows, vals, xb)]
    with pytest.raises(ValueError, match="unsupported device"):
        RS.ryser_sparse_cuda_call(*meta, 0, **geo)


# ---------------------------------------------------------------------------
# (b) the torch sparse engines vs repro.core.sparyser
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("n", [3, 5, 8, 11])
def test_sparyser_chunked_matches_reference(n, precision, cplx):
    A = _sparse(np.random.default_rng(600 + n), n, cplx, extra=2,
                density=0.3)
    want = complex(RSP.perm_sparyser_chunked(
        RSP.SparseMatrix.from_dense(A), num_chunks=16, precision=precision))
    got = TSP.perm_sparyser_chunked(TSP.SparseMatrix.from_dense(A),
                                    num_chunks=16, precision=precision,
                                    device="cpu")
    assert got.dtype == (torch.complex128 if cplx else torch.float64)
    got = complex(got)
    print(f"n={n} {precision} complex={cplx}: worst ulp gap "
          f"{_ulps(got, want):g}")
    assert abs(got - want) <= 1e-12 * abs(want)


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_sparyser_batched_matches_reference(precision, cplx):
    rng = np.random.default_rng(610)
    mats = [_sparse(rng, 9, cplx, extra) for extra in (0, 4, 1)]
    want = np.asarray(RSP.perm_sparyser_batched(
        [RSP.SparseMatrix.from_dense(A) for A in mats], num_chunks=32,
        precision=precision))
    got = TSP.perm_sparyser_batched(
        [TSP.SparseMatrix.from_dense(A) for A in mats], num_chunks=32,
        precision=precision, device="cpu").numpy()
    print(f"{precision} complex={cplx}: worst ulp gap {_ulps(got, want):g}")
    assert np.all(np.abs(got - want) <= 1e-12 * np.abs(want))


def test_sparse_partials_at_an_offset_match_reference():
    n, T, C = 10, 8, 16
    A = _sparse(np.random.default_rng(620), n, extra=3)
    rows, vals = RSP.SparseMatrix.from_dense(A).padded_columns()
    total = (1 << (n - 1)) // C
    want = RSP._sparse_partials_traced(jnp.asarray(A), jnp.asarray(rows),
                                       jnp.asarray(vals), T, C, "dq_acc",
                                       chunk_offset=8, total_chunks=total)
    got = TSP.sparse_partials(torch.as_tensor(A)[None],
                              torch.as_tensor(rows).long()[None],
                              torch.as_tensor(vals)[None], T, C, "dq_acc",
                              chunk_offset=8, total_chunks=total)
    np.testing.assert_allclose(got.hi[0].numpy() + got.lo[0].numpy(),
                               np.asarray(want.hi) + np.asarray(want.lo),
                               rtol=1e-12, atol=1e-15)
    T, C, _ = TSP.chunk_geometry(n, 16)
    val = TSP.sparse_chunked_value(torch.as_tensor(A),
                                   torch.as_tensor(rows).long(),
                                   torch.as_tensor(vals), T, C, "dq_acc")
    ref = RSP.sparse_chunked_value(jnp.asarray(A), jnp.asarray(rows),
                                   jnp.asarray(vals), T, C, "dq_acc")
    assert abs(float(val) - float(ref)) <= 1e-12 * abs(float(ref))


def test_sparse_matrix_copy_matches_reference():
    rng = np.random.default_rng(630)
    mats = [_sparse(rng, 7, cplx, extra) for cplx, extra in
            ((False, 0), (False, 3), (True, 2))]
    for A in mats:
        t, r = TSP.SparseMatrix.from_dense(A), RSP.SparseMatrix.from_dense(A)
        for f in dataclasses.fields(r):
            np.testing.assert_array_equal(getattr(t, f.name),
                                          getattr(r, f.name))
        for got, want in zip(t.padded_columns(), r.padded_columns()):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(t.to_dense(), A)
        assert (t.nnz, t.density, t.min_degree()) == \
            (r.nnz, r.density, r.min_degree())
    sps = [TSP.SparseMatrix.from_dense(A) for A in mats]
    for got, want in zip(TSP.pack_padded_ccs(sps), _packed(mats)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="same-size"):
        TSP.pack_padded_ccs([sps[0], TSP.SparseMatrix.from_dense(np.eye(3))])


@pytest.mark.parametrize("cplx", [False, True])
def test_padded_ccs_equals_reference_packing(cplx):
    """The bulk packing of dense forms equals the reference's per-matrix
    packing: uneven degrees, an empty column, one matrix and a stack."""
    rng = np.random.default_rng(640)
    mats = [_sparse(rng, 8, cplx, extra) for extra in (0, 5, 2)]
    mats[1][:, 3] = 0
    stack = np.stack(mats)
    _, rows, vals = _packed(mats)
    got_rows, got_vals = TSP.padded_ccs(stack)
    assert got_rows.dtype == np.int32 and got_vals.dtype == stack.dtype
    np.testing.assert_array_equal(got_rows, rows)
    np.testing.assert_array_equal(got_vals, vals)
    for got, want in zip(TSP.padded_ccs(mats[0]),
                         RSP.SparseMatrix.from_dense(mats[0])
                         .padded_columns()):
        np.testing.assert_array_equal(got, want)
    rows0, vals0 = TSP.padded_ccs(np.zeros((3, 3)))
    np.testing.assert_array_equal(rows0, np.full((3, 1), 3))
    np.testing.assert_array_equal(vals0, np.zeros((3, 1)))


@pytest.mark.parametrize("cplx", [False, True])
def test_array_sparse_entries_equal_sparse_matrix_entries(cplx):
    """Dense forms with their bulk-packed CCS arrays (the executor's path)
    give the SparseMatrix entries' values bit for bit."""
    rng = np.random.default_rng(650)
    bucket = [_sparse(rng, 9, cplx, extra) for extra in (0, 4, 1)]
    stack = np.stack(bucket)
    sps = [TSP.SparseMatrix.from_dense(A) for A in bucket]
    got = TOPS.sparse_batched_values_cuda(stack, *TSP.padded_ccs(stack),
                                          geometry=GEO, device="cpu")
    want = TOPS.permanent_cuda_sparse_batched(sps, geometry=GEO,
                                              device="cpu")
    assert torch.equal(got, want)
    one = TOPS.sparse_value_cuda(bucket[0], *TSP.padded_ccs(bucket[0]),
                                 geometry=GEO, device="cpu")
    assert one == TOPS.permanent_cuda_sparse(sps[0], geometry=GEO,
                                             device="cpu")
    assert one == got[0]
    got = TSP.sparse_values(stack, *TSP.padded_ccs(stack), 32, device="cpu")
    assert torch.equal(got, TSP.perm_sparyser_batched(sps, num_chunks=32,
                                                      device="cpu"))


# ---------------------------------------------------------------------------
# (c) the entries vs the reference and the oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cplx", [False, True])
def test_cuda_sparse_entries_match_oracle(cplx):
    rng = np.random.default_rng(700)
    mats = [_sparse(rng, n, cplx, extra=2) for n in (1, 2, 4, 7, 12)]
    for A in mats:
        exact = oracle.perm_ryser_exact(A)
        got = complex(TOPS.permanent_cuda_sparse(
            TSP.SparseMatrix.from_dense(A), geometry=GEO, device="cpu"))
        assert abs(got - exact) <= 1e-9 * abs(exact) + 1e-12
    bucket = [_sparse(rng, 9, cplx, extra) for extra in (0, 5, 2)]
    got = TOPS.permanent_cuda_sparse_batched(
        [TSP.SparseMatrix.from_dense(A) for A in bucket], geometry=GEO,
        device="cpu").numpy()
    exact = np.array([oracle.perm_ryser_exact(A) for A in bucket])
    np.testing.assert_allclose(got, exact, rtol=1e-9)
    want = np.asarray(OPS.permanent_pallas_sparse_batched(
        [RSP.SparseMatrix.from_dense(A) for A in bucket],
        geometry=RefGeometry(8, 8, 4)))
    np.testing.assert_allclose(got, want, rtol=1e-9)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("cplx", [False, True])
def test_permanent_sparse_matches_reference_and_oracle(backend, cplx):
    """Sparse leaves through the entry points, tags as the reference's."""
    rng = np.random.default_rng(710)
    ref_backend = {"cuda": "pallas", "torch": "jnp"}[backend]
    for n in (6, 10, 13):
        A = _sparse(rng, n, cplx, extra=1, density=0.05)
        got, rep = repro_torch.permanent(A, backend=backend, device="cpu",
                                         preprocess=False, return_report=True)
        want, wrep = REF.permanent(A, backend=ref_backend, preprocess=False,
                                   return_report=True)
        exact = oracle.perm_ryser_exact(A)
        assert abs(got - want) <= 1e-9 * abs(want)
        assert abs(got - exact) <= 1e-9 * abs(exact)
        assert [[t.replace("pallas", "cuda").replace("jnp", "torch")
                 for t in wrep.dispatch]] == [rep.dispatch]
        assert rep.dispatch[-1].startswith(f"sparse(n={n},")


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_permanent_batch_sparse_mixed_routes(backend):
    """Sparse buckets, a sparse straggler, a dense bucket and tiny leaves in
    one batch, as the reference dispatches them."""
    rng = np.random.default_rng(720)
    ref_backend = {"cuda": "pallas", "torch": "jnp"}[backend]
    mats = [_sparse(rng, 9, extra=e, density=0.1) for e in (0, 3, 1)]
    mats += [_sparse(rng, 7, density=0.1), _sparse(rng, 3, density=0.0),
             _sparse(rng, 3, density=0.0)]
    mats += [rng.uniform(-1, 1, (6, 6)) for _ in range(2)] + [np.eye(2)]
    got, reps = repro_torch.permanent_batch(mats, backend=backend,
                                            preprocess=False, device="cpu",
                                            return_report=True)
    want, wreps = REF.permanent_batch(mats, backend=ref_backend,
                                      preprocess=False, return_report=True)
    np.testing.assert_allclose(got, np.real(want), rtol=1e-9)
    exact = np.array([oracle.perm_ryser_exact(M) for M in mats])
    np.testing.assert_allclose(got, exact, rtol=1e-9)
    assert [r.dispatch for r in reps] == [
        [t.replace("pallas", "cuda").replace("jnp", "torch")
         for t in w.dispatch] for w in wreps]


# ---------------------------------------------------------------------------
# (d) batch invariance, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision", PRECISIONS)
def test_torch_complex_sparse_batch_invariance(precision):
    rng = np.random.default_rng(800)
    sps = [TSP.SparseMatrix.from_dense(_sparse(rng, 9, True, extra))
           for extra in (0, 2, 5, 1, 3)]
    full = TSP.perm_sparyser_batched(sps, num_chunks=32, precision=precision,
                                     device="cpu").numpy()
    for B in (1, 2):
        part = TSP.perm_sparyser_batched(sps[:B], num_chunks=32,
                                         precision=precision,
                                         device="cpu").numpy()
        np.testing.assert_array_equal(part, full[:B])
    for i, sp in enumerate(sps):
        one = TSP.perm_sparyser_chunked(sp, num_chunks=32,
                                        precision=precision,
                                        device="cpu").numpy()
        assert one == full[i], (i, one, full[i])


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_scalar_sparse_leaf_equals_bucket_member(backend, cplx):
    """Through the entry points; the bucket's maxdeg exceeds the leaf's."""
    rng = np.random.default_rng(810)
    A, other = _sparse(rng, 9, cplx, density=0.1), \
        _sparse(rng, 9, cplx, extra=6, density=0.1)
    RC.reset_counters()
    bucket, reps = repro_torch.permanent_batch(
        [A, other], backend=backend, preprocess=False, device="cpu",
        return_report=True)
    assert reps[0].dispatch == ["sparse_batch(n=9,b=2)"]
    assert repro_torch.permanent(A, backend=backend, preprocess=False,
                                 device="cpu") == bucket[0]
    plain = "block_partials_plain_sparse" + ("_complex" if cplx else "")
    assert RC.counters[plain] == (2 if backend == "cuda" else 0)


# ---------------------------------------------------------------------------
# (e) the real leaf order the sparse kernel runs on (ops.order_sparse_leaves)
# ---------------------------------------------------------------------------

def _banded(rng, n, degree):
    """A random row and column permutation of the ``degree``-diagonal
    circulant pattern, U(0.5, 1.5) values."""
    i, j = np.indices((n, n))
    mask = ((j - i) % n < degree)[rng.permutation(n)][:, rng.permutation(n)]
    return np.where(mask, rng.uniform(0.5, 1.5, (n, n)), 0.0)


def _ordered(mats, kw):
    """(stack, rows, vals) as numpy, ``sparse_leaf_order`` and
    ``order_sparse_leaves`` of a same-size list of real matrices."""
    stack = np.stack(mats)
    rows, vals = TSP.padded_ccs(stack)
    order = TOPS.sparse_leaf_order(torch.tensor(rows), kw)
    got = TOPS.order_sparse_leaves(torch.tensor(stack), torch.tensor(rows),
                                   torch.tensor(vals), kw)
    return (stack, rows, vals), order, got


@pytest.mark.parametrize("kw", [1, 2, 4])
@pytest.mark.parametrize("n", [6, 9, 12, 24])
def test_sparse_leaf_order_is_a_permutation(n, kw):
    """Row and column orders are permutations of range(n), the leaf is
    A[order][:, cols], and R lies in [1, n]."""
    rng = np.random.default_rng(1000 + n)
    mats = [_sparse(rng, n, extra=e) for e in (0, 3)] + [_banded(rng, n, 3)]
    (stack, _, _), (cols, order, R), (As, _, _) = _ordered(mats, kw)
    for b in range(len(mats)):
        c, o = cols[b].numpy(), order[b].numpy()
        np.testing.assert_array_equal(np.sort(c), np.arange(n))
        np.testing.assert_array_equal(np.sort(o), np.arange(n))
        np.testing.assert_array_equal(As[b].numpy(), stack[b][o][:, c])
    assert ((1 <= R) & (R <= n)).all()


def test_sparse_leaf_order_depends_on_the_leaf_alone():
    """A leaf gets one order alone, first or last in a bucket whose other
    members raise maxdeg, and on every call."""
    rng = np.random.default_rng(1010)
    leaf = _banded(rng, 12, 3)
    others = [_sparse(rng, 12, extra=e) for e in (6, 9)]
    alone = _ordered([leaf], 4)
    for mats, b in (([leaf] + others, 0), (others + [leaf], 2),
                    ([leaf], 0)):
        _, order, got = _ordered(mats, 4)
        for x, y in zip(order, alone[1]):
            assert torch.equal(x[b], y[0])
        assert torch.equal(got[0][b], alone[2][0][0])
        maxdeg = alone[2][1].shape[-1]
        assert torch.equal(got[1][b, :, :maxdeg], alone[2][1][0])
        assert (got[1][b, :, maxdeg:] == 12).all()
        assert torch.equal(got[2][b, :, :maxdeg], alone[2][2][0])


@pytest.mark.parametrize("n, degree, kw", [(12, 3, 2), (24, 5, 4),
                                           (32, 7, 4)])
def test_sparse_leaf_order_puts_the_touched_rows_first(n, degree, kw):
    """The rows below R are exactly those the kw low columns touch, R is
    what the kernel derives (``low_column_rows``), and on a band the greedy
    columns are band neighbours: degree + kw - 1 rows (10 of 32 at degree
    7), where the first kw columns of the leaf as it comes touch more."""
    rng = np.random.default_rng(1020 + n)
    mats = [_banded(rng, n, degree), _sparse(rng, n, extra=2)]
    (_, rows, _), (_, _, R), (_, r2, _) = _ordered(mats, kw)
    assert torch.equal(R, RS.low_column_rows(r2, kw, n))
    for b in range(len(mats)):
        low = r2[b, :kw]
        assert set(low[low < n].tolist()) == set(range(int(R[b])))
    assert int(R[0]) == degree + kw - 1
    raw = RS.low_column_rows(torch.tensor(rows), kw, n)
    assert int(raw[0]) > int(R[0])


@pytest.mark.parametrize("n", [5, 9, 16])
def test_ordered_ccs_equals_padded_ccs_of_the_ordered_leaf(n):
    """The remapped CCS arrays are ``padded_ccs`` of the permuted dense
    leaf, padded to the bucket's maxdeg."""
    rng = np.random.default_rng(1030 + n)
    mats = [_sparse(rng, n, extra=e) for e in (0, 2, n - 1)]
    _, _, (As, rows, vals) = _ordered(mats, 2)
    want_rows, want_vals = TSP.padded_ccs(As.numpy())
    assert rows.dtype == torch.int32
    np.testing.assert_array_equal(rows.numpy(), want_rows)
    np.testing.assert_array_equal(vals.numpy(), want_vals)


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("n", [6, 9, 12])
def test_ordered_sparse_leaf_matches_oracle_and_reference(n, precision):
    """The real sparse entry runs the plain version on the ordered leaf:
    its value is within 1e-9 of the oracle and within 1e-12 of the
    reference Pallas sparse kernel (interpret mode) on the leaf as it
    comes, at the same geometry and precision."""
    rng = np.random.default_rng(1040 + n)
    A = _sparse(rng, n, extra=2, density=0.3)
    rows, _ = TSP.padded_ccs(A)
    kw = int(np.log2(GEO.kernel_geometry(n)[2]))
    cols, order, _ = TOPS.sparse_leaf_order(torch.tensor(rows)[None], kw)
    assert not (torch.equal(cols[0], torch.arange(n))
                and torch.equal(order[0], torch.arange(n)))
    RC.reset_counters()
    got = float(TOPS.permanent_cuda_sparse(TSP.SparseMatrix.from_dense(A),
                                           precision=precision, geometry=GEO,
                                           device="cpu"))
    assert RC.counters["block_partials_plain_sparse"] == 1
    exact = oracle.perm_ryser_exact(A)
    want = float(OPS.permanent_pallas_sparse(
        RSP.SparseMatrix.from_dense(A), precision=precision,
        geometry=RefGeometry(8, 8, 4)))
    assert abs(got - exact) <= 1e-9 * abs(exact)
    assert abs(got - want) <= 1e-12 * abs(want)


# ---------------------------------------------------------------------------
# (f) tags, interop, the CLI
# ---------------------------------------------------------------------------

def test_sparse_dispatch_tags_and_downgrades():
    rng = np.random.default_rng(900)
    tiny = np.diag([1.0, 2.0, 0.0])          # density 2/9: the sparse route
    _, rep = repro_torch.permanent(tiny, preprocess=False, device="cpu",
                                   return_report=True)
    assert rep.dispatch == ["sparse(n=3,cuda->torch)"]
    _, reps = repro_torch.permanent_batch([tiny, 2 * tiny],
                                          preprocess=False, device="cpu",
                                          return_report=True)
    assert reps[0].dispatch == ["sparse_batch(n=3,b=2,cuda->torch)"]
    A = _sparse(rng, 8, density=0.1)
    _, rep = repro_torch.permanent(A, preprocess=False, device="cpu",
                                   return_report=True)
    assert rep.dispatch == ["sparse(n=8,cuda)"]
    _, rep = repro_torch.permanent(A, preprocess=False, device="cpu",
                                   backend="torch", return_report=True)
    assert rep.dispatch == ["sparse(n=8,torch)"]
    _, wrep = REF.permanent(tiny, preprocess=False, backend="pallas",
                            return_report=True)
    assert wrep.dispatch == ["sparse(n=3,pallas->jnp)"]


def test_sparse_from_reference_round_trips():
    rng = np.random.default_rng(910)
    for A in (_sparse(rng, 6, extra=2), _sparse(rng, 5, True)):
        ref = RSP.SparseMatrix.from_dense(A)
        sp = interop.sparse_from_reference(dataclasses.asdict(ref))
        assert isinstance(sp, TSP.SparseMatrix) and sp.n == ref.n
        for f in dataclasses.fields(ref):
            np.testing.assert_array_equal(getattr(sp, f.name),
                                          getattr(ref, f.name))
        np.testing.assert_array_equal(sp.to_dense(), A)
        got = complex(TSP.perm_sparyser_chunked(sp, num_chunks=16,
                                                device="cpu"))
        want = complex(RSP.perm_sparyser_chunked(ref, num_chunks=16))
        assert abs(got - want) <= 1e-12 * abs(want)
    with pytest.raises(ValueError, match="fields"):
        interop.sparse_from_reference({"n": 3})


def test_cli_sparse_flags(capsys):
    assert permanent_main(["--family", "fibonacci", "--n", "14",
                           "--no-preprocess", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Fibonacci(15) = 610" in out and "OK" in out
    assert "sparse(n=14,cuda)" in out
    assert permanent_main(["--sparse-n", "12", "--density", "0.35",
                           "--seed", "3", "--device", "cpu",
                           "--backend", "torch"]) == 0
    out = capsys.readouterr().out
    got = float(out.split("perm(A) = ")[1].split()[0])
    rng = np.random.default_rng(3)
    A = rng.uniform(0.5, 1.5, (12, 12)) * (rng.uniform(0, 1, (12, 12))
                                           < 0.35)
    exact = oracle.perm_ryser_exact(A)
    assert abs(got - exact) <= 1e-9 * max(abs(exact), 1e-300)
    assert "density=" in out
