"""The port's torch engine (``repro_torch.core.ryser``) vs the reference jnp
engine at equal ``num_chunks``: rtol 1e-12 for all five precisions, with
the worst ulp gap reported; and, inside the port, a scalar leaf equals the
same leaf in a bucket bit for bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import ryser as R  # noqa: E402
from repro_torch.core import ryser as RT  # noqa: E402
from repro_torch.core import stepspace as TS  # noqa: E402
from repro.core import stepspace as S  # noqa: E402

PRECISIONS = ("dd", "dq_fast", "dq_acc", "qq", "kahan")
CHUNKS = 16


def _ulps(a: float, b: float) -> float:
    return abs(a - b) / np.spacing(max(abs(a), abs(b)))


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("n", range(3, 13))
def test_chunked_matches_reference(n, precision):
    A = np.random.default_rng(100 + n).uniform(-1, 1, (n, n))
    want = float(R.perm_ryser_chunked(A, num_chunks=CHUNKS,
                                      precision=precision))
    got = float(RT.perm_ryser_chunked(A, num_chunks=CHUNKS,
                                      precision=precision, device="cpu"))
    print(f"n={n} {precision}: worst ulp gap {_ulps(got, want):g}")
    np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("n", [4, 9, 12])
def test_batched_matches_reference(n, precision):
    As = np.random.default_rng(200 + n).uniform(-1, 1, (3, n, n))
    want = np.asarray(R.perm_ryser_batched(As, num_chunks=CHUNKS,
                                           precision=precision))
    got = RT.perm_ryser_batched(As, num_chunks=CHUNKS, precision=precision,
                                device="cpu").numpy()
    gaps = [_ulps(g, w) for g, w in zip(got, want)]
    print(f"n={n} {precision}: worst ulp gap {max(gaps):g}")
    np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_scalar_leaf_bitwise_equals_bucket_member(precision):
    rng = np.random.default_rng(5)
    As = rng.uniform(-1, 1, (5, 10, 10))
    bucket = RT.perm_ryser_batched(As, num_chunks=64, precision=precision,
                                   device="cpu").numpy()
    for i in range(len(As)):
        scalar = float(RT.perm_ryser_chunked(As[i], num_chunks=64,
                                             precision=precision,
                                             device="cpu"))
        assert scalar == bucket[i], (i, scalar, bucket[i])


def test_partials_and_tree_sum_match_reference():
    """Per-chunk partials at a nonzero chunk offset, and the fixed-order
    twofloat tree on an odd length."""
    n, T, C = 9, 8, 16
    A = np.random.default_rng(3).uniform(-1, 1, (n, n))
    want = R.chunk_partial_sums(jnp.asarray(A), T, C, "dq_acc",
                                chunk_offset=8,
                                total_chunks=(1 << (n - 1)) // C)
    got = RT.chunk_partial_sums(torch.as_tensor(A)[None], T, C, "dq_acc",
                                chunk_offset=8,
                                total_chunks=(1 << (n - 1)) // C)
    np.testing.assert_allclose(got.hi[0].numpy(), np.asarray(want.hi),
                               rtol=1e-12, atol=1e-15)
    hi = np.random.default_rng(4).uniform(-1, 1, 13)
    lo = hi * 1e-17
    w = R.tf_tree_sum(hi, lo)
    g = RT.tf_tree_sum(torch.as_tensor(hi), torch.as_tensor(lo))
    assert (float(g[0]), float(g[1])) == (float(w[0]), float(w[1]))


def test_base_vector_and_small_n():
    A = np.random.default_rng(6).uniform(-1, 1, (7, 7))
    np.testing.assert_array_equal(
        RT.nw_base_vector(torch.as_tensor(A)).numpy(),
        np.asarray(R.nw_base_vector(A)))
    for n in (1, 2):
        M = A[:n, :n]
        assert float(RT.perm_ryser_chunked(M, device="cpu")) == \
            float(R.perm_ryser_chunked(M))


def test_stepspace_copy_is_identical():
    for n in range(2, 40):
        for lanes, spc, win in [(128, 64, 16), (8, 8, 4), (4, 4, 2),
                                (16, 16, 16), (64, 8, 8)]:
            assert TS.kernel_geometry(n, lanes=lanes, steps_per_chunk=spc,
                                      window=win) == \
                S.kernel_geometry(n, lanes=lanes, steps_per_chunk=spc,
                                  window=win)
        for chunks in (1, 16, 4096):
            assert TS.chunk_geometry(n, chunks) == S.chunk_geometry(n, chunks)
    g = TS.Geometry(8, 8, 4, 3)
    assert TS.Geometry.from_tag(g.tag()) == g
    assert g.tag() == S.Geometry(8, 8, 4, 3).tag()
    assert RT.ryser_flops(30) == R.ryser_flops(30)
