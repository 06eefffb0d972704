"""The port's complex dense path vs the reference, on the CPU.

(a) the split-plane kernel's plain version against the reference Pallas
kernels in interpret mode: per-component partials at rtol 1e-12 / atol
1e-15 (tests/test_kernels.py's bar), five precisions; (b) the torch complex
engine against the jnp complex engine within 1e-12, worst ulp gap
reported; (c) the entry points against ``backend="pallas"`` and the oracle
within 1e-9; (d) batch invariance, bit for bit; (e) tags and result types.
On the CPU every kernel wrapper runs its plain version; the kernel itself
is held against it on the card (``chip_smoke.py``,
``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core.engine as REF  # noqa: E402
from repro.core import oracle  # noqa: E402
from repro.core import ryser as R  # noqa: E402
from repro.core.ryser import nw_base_vector  # noqa: E402
from repro.kernels import ops as OPS  # noqa: E402
from repro.kernels import ryser_complex as RPX  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.core import ryser as RT  # noqa: E402
from repro_torch.core.solver import PermanentSolver  # noqa: E402
from repro_torch.core.stepspace import Geometry  # noqa: E402
from repro_torch.kernels import ops as TOPS  # noqa: E402
from repro_torch.kernels import ryser_complex_cuda as RX  # noqa: E402
from repro_torch.kernels import ryser_cuda as RC  # noqa: E402
from repro_torch.launch.permanent import permanent_main  # noqa: E402

PRECISIONS = ("dd", "dq_fast", "dq_acc", "qq", "kahan")
CHUNKS = 16
GEO = Geometry(8, 8, 4)


def _cgauss(rng, shape):
    n = shape[-1]
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)) \
        / np.sqrt(2 * n)


def _haar_unitary(m: int, rng) -> np.ndarray:
    z = (rng.normal(size=(m, m)) + 1j * rng.normal(size=(m, m))) / np.sqrt(2)
    q, r = np.linalg.qr(z)
    return q * (np.diag(r) / np.abs(np.diag(r)))


def _ulps(a, b) -> float:
    a, b = np.atleast_1d(a), np.atleast_1d(b)
    parts = [(a.real, b.real), (a.imag, b.imag)]
    return max(float(np.max(np.abs(x - y) / np.spacing(np.maximum(
        np.abs(x), np.abs(y))))) for x, y in parts)


def _ref_planes(As):
    """Reference padding of a complex matrix or stack, as numpy planes."""
    As = jnp.asarray(As)
    if As.ndim == 2:
        Ar, Ai = OPS.split_matrix_planes(As)
        xbr, xbi = OPS.split_base_planes(nw_base_vector(As), Ar.shape[-1])
    else:
        Ar, Ai = OPS.split_matrix_planes(As)
        xbs = jnp.stack([nw_base_vector(A) for A in As])
        xbr, xbi = OPS.split_base_planes(xbs, Ar.shape[-1])
    return [np.asarray(x) for x in (Ar, Ai, xbr, xbi)]


def _close_components(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.shape[-1] == 4
    for c in (0, 2):                       # (re_hi + re_err), (im_hi + im_err)
        np.testing.assert_allclose(got[..., c] + got[..., c + 1],
                                   want[..., c] + want[..., c + 1],
                                   rtol=1e-12, atol=1e-15)


# ---------------------------------------------------------------------------
# (a) plain version vs the reference Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("window", ["bottom", "top"])
def test_plain_matches_pallas_complex(precision, window):
    """Scalar entry over a window at the bottom or the top of the step
    space.  With Geometry(8, 8, 4) every chunk runs two windows, and the
    second has bit kw of its base set (the mid correction's lanes)."""
    n = 10
    A = _cgauss(np.random.default_rng(40), (n, n))
    TB, C, Wu, blocks = GEO.kernel_geometry(n)
    assert C // Wu >= 2
    nb = blocks // 2
    base = 0 if window == "bottom" else (blocks - nb) * TB
    planes = _ref_planes(A)
    want = RPX.ryser_pallas_call_complex(
        *(jnp.asarray(p) for p in planes), base, n=n, TB=TB, C=C, Wu=Wu,
        num_blocks=nb, precision=precision, interpret=True)
    got = RX.ryser_cuda_call_complex(
        *(torch.tensor(p) for p in planes), base, n=n, TB=TB, C=C, Wu=Wu,
        num_blocks=nb, precision=precision)
    _close_components(got.numpy(), want)
    if precision not in ("dq_acc", "dq_fast"):
        assert not got[:, 1].any() and not got[:, 3].any()


@pytest.mark.parametrize("geometry", [(8, 8, 8), (4, 4, 2), (16, 16, 16)])
def test_plain_matches_pallas_complex_one_window_per_chunk(geometry):
    """Wu == C: bit kw of each window base is the chunk's parity bit, so
    odd lanes take the mid correction; the window ends at the top."""
    n = 11
    A = _cgauss(np.random.default_rng(41), (n, n))
    geo = Geometry(*geometry)
    TB, C, Wu, blocks = geo.kernel_geometry(n)
    nb = max(1, blocks // 2)
    base = (blocks - nb) * TB
    planes = _ref_planes(A)
    want = RPX.ryser_pallas_call_complex(
        *(jnp.asarray(p) for p in planes), base, n=n, TB=TB, C=C, Wu=Wu,
        num_blocks=nb, precision="dq_acc", interpret=True)
    got = RX.ryser_cuda_call_complex(
        *(torch.tensor(p) for p in planes), base, n=n, TB=TB, C=C, Wu=Wu,
        num_blocks=nb, precision="dq_acc")
    _close_components(got.numpy(), want)


@pytest.mark.parametrize("precision", ["dd", "dq_acc", "kahan"])
def test_batched_plain_matches_pallas_complex_batched(precision):
    n, B = 9, 3
    As = _cgauss(np.random.default_rng(42), (B, n, n))
    TB, C, Wu, blocks = GEO.kernel_geometry(n)
    planes = _ref_planes(As)
    want = RPX.ryser_pallas_call_complex_batched(
        *(jnp.asarray(p) for p in planes), n=n, TB=TB, C=C, Wu=Wu,
        num_blocks=blocks, precision=precision, interpret=True)
    got = RX.ryser_cuda_call_complex_batched(
        *(torch.tensor(p) for p in planes), n=n, TB=TB, C=C, Wu=Wu,
        num_blocks=blocks, precision=precision)
    _close_components(got.numpy(), want)


def test_planes_padding_matches_reference():
    A = _cgauss(np.random.default_rng(43), (13, 13))
    want = _ref_planes(A)
    Ar, Ai, xbr, xbi, xbs = TOPS.prepare_complex(torch.as_tensor(A))
    for g, w in zip((Ar, Ai, xbr, xbi), want):
        np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_array_equal(xbs.numpy(),
                                  np.asarray(nw_base_vector(jnp.asarray(A))))
    re, im = RT.as_planes(A, "cpu")
    np.testing.assert_array_equal(torch.complex(re, im).numpy(), A)
    re, im = RT.as_planes(torch.ones(2, 2), "cpu")
    assert re.dtype == torch.float64 and not im.any()
    with pytest.raises(TypeError, match="complex"):
        RT.as_matrix(A, "cpu")


def test_complex_wrapper_checks_inputs():
    Ar = torch.zeros(16, 16, dtype=torch.float64)
    xb = torch.ones(16, 1, dtype=torch.float64)
    geo = dict(n=10, TB=8, C=8, Wu=4, num_blocks=8)
    with pytest.raises(ValueError, match="re plane"):
        RX.ryser_cuda_call_complex(Ar, Ar[:8, :8], xb, xb, 0, **geo)
    with pytest.raises(ValueError, match="step space"):
        RX.ryser_cuda_call_complex(Ar, Ar, xb, xb, 8, **geo)
    with pytest.raises(TypeError, match="f64 or f32"):
        RX.ryser_cuda_call_complex(Ar.half(), Ar.half(), xb.half(),
                                   xb.half(), 0, **geo)
    with pytest.raises(TypeError, match="one dtype"):
        RX.ryser_cuda_call_complex(Ar.float(), Ar.float(), xb, xb, 0, **geo)
    with pytest.raises(ValueError, match="re plane"):
        RX.ryser_cuda_call_complex(Ar.float(), Ar, xb.float(), xb.float(), 0,
                                   **geo)
    meta = [t.to("meta") for t in (Ar, Ar, xb, xb)]
    with pytest.raises(ValueError, match="unsupported device"):
        RX.ryser_cuda_call_complex(*meta, 0, **geo)


# ---------------------------------------------------------------------------
# (b) torch complex engine vs the jnp complex engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("n", [3, 5, 8, 10])
def test_chunked_complex_matches_reference(n, precision):
    A = _cgauss(np.random.default_rng(300 + n), (n, n))
    want = complex(R.perm_ryser_chunked(A, num_chunks=CHUNKS,
                                        precision=precision))
    got = RT.perm_ryser_chunked(A, num_chunks=CHUNKS, precision=precision,
                                device="cpu")
    assert got.dtype == torch.complex128
    got = complex(got)
    print(f"n={n} {precision}: worst ulp gap {_ulps(got, want):g}")
    assert abs(got - want) <= 1e-12 * abs(want)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_batched_complex_matches_reference(precision):
    As = _cgauss(np.random.default_rng(310), (3, 9, 9))
    want = np.asarray(R.perm_ryser_batched(As, num_chunks=CHUNKS,
                                           precision=precision))
    got = RT.perm_ryser_batched(As, num_chunks=CHUNKS, precision=precision,
                                device="cpu").numpy()
    print(f"{precision}: worst ulp gap {_ulps(got, want):g}")
    assert np.all(np.abs(got - want) <= 1e-12 * np.abs(want))


def test_complex_partials_at_an_offset_match_reference():
    n, T, C = 9, 8, 16
    A = _cgauss(np.random.default_rng(311), (n, n))
    total = (1 << (n - 1)) // C
    wr, wi, _ = R.chunk_partial_sums_complex(
        jnp.asarray(A.real), jnp.asarray(A.imag), T, C, "dq_acc",
        chunk_offset=8, total_chunks=total)
    gr, gi, _ = RT.chunk_partial_sums_complex(
        torch.as_tensor(A.real)[None], torch.as_tensor(A.imag)[None], T, C,
        "dq_acc", chunk_offset=8, total_chunks=total)
    for g, w in ((gr, wr), (gi, wi)):
        np.testing.assert_allclose(g.hi[0].numpy() + g.lo[0].numpy(),
                                   np.asarray(w.hi) + np.asarray(w.lo),
                                   rtol=1e-12, atol=1e-15)
    pr, pi = RT.chain_prod_complex(torch.as_tensor(A.real),
                                   torch.as_tensor(A.imag))
    wr, wi = R.chain_prod_complex(jnp.asarray(A.real), jnp.asarray(A.imag))
    np.testing.assert_allclose(pr.numpy(), np.asarray(wr), rtol=1e-13)
    np.testing.assert_allclose(pi.numpy(), np.asarray(wi), rtol=1e-13)
    assert RT.complex_precision("qq") == R.complex_precision("qq") == "kahan"


# ---------------------------------------------------------------------------
# (c) end to end vs backend="pallas" and the oracle
# ---------------------------------------------------------------------------

def _tags(reports, names=None):
    out = [list(r.dispatch) for r in reports]
    for old, new in (names or {}).items():
        out = [[t.replace(old, new) for t in ts] for ts in out]
    return out


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_permanent_complex_matches_reference_and_oracle(backend):
    rng = np.random.default_rng(320)
    U = _haar_unitary(12, rng)
    mats = [U[:6, [0, 2, 3, 5, 8, 11]], U[np.ix_(range(8), range(2, 10))],
            _cgauss(rng, (7, 7)), _cgauss(rng, (3, 3))]
    ref_backend = {"cuda": "pallas", "torch": "jnp"}[backend]
    for A in mats:
        got, rep = repro_torch.permanent(A, backend=backend, device="cpu",
                                         return_report=True)
        want, wrep = REF.permanent(A, backend=ref_backend,
                                   return_report=True)
        exact = oracle.perm_ryser_exact(A)
        assert isinstance(got, complex)
        assert abs(got - want) <= 1e-9 * abs(want)
        assert abs(got - exact) <= 1e-9 * abs(exact)
        assert _tags([rep]) == _tags([wrep])


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_permanent_batch_complex_mixed_sizes(backend):
    """Multi-leaf buckets, a ragged straggler, inline n <= 2 and an n = 3
    bucket below the kernel floor, all complex."""
    rng = np.random.default_rng(321)
    U = _haar_unitary(10, rng)
    mats = [U[np.ix_(range(6), c)] for c in ([0, 1, 2, 3, 4, 5],
                                              [1, 3, 4, 6, 8, 9],
                                              [0, 2, 4, 5, 7, 9])]
    mats += [_cgauss(rng, (n, n)) for n in (5, 3, 3, 2, 1, 8)]
    ref_backend = {"cuda": "pallas", "torch": "jnp"}[backend]
    got, reps = repro_torch.permanent_batch(mats, backend=backend,
                                            preprocess=False, device="cpu",
                                            return_report=True)
    want, wreps = REF.permanent_batch(mats, backend=ref_backend,
                                      preprocess=False, return_report=True)
    assert got.dtype == np.complex128 and got.shape == (len(mats),)
    assert np.all(np.abs(got - want) <= 1e-9 * np.abs(want))
    exact = np.array([oracle.perm_ryser_exact(M) for M in mats])
    assert np.all(np.abs(got - exact) <= 1e-9 * np.abs(exact))
    assert _tags(reps) == _tags(wreps, {"pallas": "cuda", "jnp": "torch"})
    assert [r.value for r in reps] == list(got)


# ---------------------------------------------------------------------------
# (d) batch invariance, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision", PRECISIONS)
def test_torch_complex_batch_invariance(precision):
    As = _cgauss(np.random.default_rng(330), (5, 9, 9))
    full = RT.perm_ryser_batched(As, num_chunks=64, precision=precision,
                                 device="cpu").numpy()
    for B in (1, 2):
        part = RT.perm_ryser_batched(As[:B], num_chunks=64,
                                     precision=precision,
                                     device="cpu").numpy()
        np.testing.assert_array_equal(part, full[:B])
    for i, A in enumerate(As):
        one = RT.perm_ryser_chunked(A, num_chunks=64, precision=precision,
                                    device="cpu").numpy()
        assert one == full[i], (i, one, full[i])


@pytest.mark.parametrize("precision", ["dd", "dq_acc", "kahan"])
def test_cuda_complex_batch_invariance(precision):
    As = _cgauss(np.random.default_rng(331), (5, 8, 8))
    RC.reset_counters()
    full = TOPS.permanent_cuda_batched(As, precision=precision, geometry=GEO,
                                       device="cpu").numpy()
    assert RC.counters["block_partials_plain_complex"] == 1
    assert RC.counters["ryser_complex_batched"] == 0  # plain on the CPU
    for B in (1, 2):
        part = TOPS.permanent_cuda_batched(As[:B], precision=precision,
                                           geometry=GEO,
                                           device="cpu").numpy()
        np.testing.assert_array_equal(part, full[:B])
    for i, A in enumerate(As):
        one = TOPS.permanent_cuda(A, precision=precision, geometry=GEO,
                                  device="cpu").numpy()
        assert one == full[i], (i, one, full[i])


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_scalar_leaf_equals_bucket_member_through_entry_points(backend):
    rng = np.random.default_rng(332)
    A, other = _cgauss(rng, (2, 7, 7))
    bucket = repro_torch.permanent_batch([A, other], backend=backend,
                                         device="cpu")
    assert repro_torch.permanent(A, backend=backend, device="cpu") \
        == bucket[0]


# ---------------------------------------------------------------------------
# (e) tags and types
# ---------------------------------------------------------------------------

def test_qq_on_complex_is_tagged_and_types_are_complex():
    rng = np.random.default_rng(340)
    A = _cgauss(rng, (6, 6))
    v, rep = repro_torch.permanent(A, precision="qq", device="cpu",
                                   return_report=True)
    assert isinstance(v, complex) and "precision(qq->kahan)" in rep.dispatch
    assert rep.precision == "kahan"
    _, wrep = REF.permanent(A, precision="qq", backend="pallas",
                            return_report=True)
    assert rep.dispatch == wrep.dispatch
    assert v == repro_torch.permanent(A, precision="kahan", device="cpu")
    real = rng.uniform(-1, 1, (6, 6))
    r, rrep = repro_torch.permanent(real, precision="qq", device="cpu",
                                    return_report=True)
    assert type(r) is float and not any("precision(" in t
                                        for t in rrep.dispatch)
    out = repro_torch.permanent_batch([real, real], device="cpu")
    assert out.dtype == np.float64 and out.flags.c_contiguous

    solver = PermanentSolver(device="cpu", queue_max_batch=2,
                             clock=lambda: 0.0)
    assert isinstance(solver.execute(solver.plan(A)), complex)
    vals = solver.execute(solver.plan_batch([A, A.conj()]))
    assert vals.dtype == np.complex128
    reqs = [solver.submit(M) for M in (A, A.T)]
    assert all(r.done and isinstance(r.result(), complex) for r in reqs)
    assert reqs[0].result() == vals[0]


def test_cli_complex_matrix(tmp_path, capsys):
    A = _cgauss(np.random.default_rng(341), (6, 6))
    path = tmp_path / "c6.npy"
    np.save(path, A)
    assert permanent_main(["--matrix", str(path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    line = out.split("perm(A) = ")[1].split("(")[0].split()
    assert line[1].endswith("j")
    got = complex(float(line[0]), float(line[1][:-1]))
    want = oracle.perm_ryser_exact(A)
    assert abs(got - want) <= 1e-9 * abs(want)
