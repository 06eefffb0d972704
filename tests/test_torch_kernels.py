"""The dense CUDA kernel's plain version and its glue vs the reference
Pallas kernels (interpret mode, as the reference's own tests run them).

On the CPU every wrapper runs ``block_partials_plain``, which repeats the
kernel's arithmetic op for op; the kernel itself is held against it on
the card (``chip_smoke.py``, ``tests/test_torch_cuda.py``).  Bars are the
reference's: per-block partials rtol 1e-12 / atol 1e-15
(tests/test_kernels.py:53-62), values rtol 1e-9 / atol 1e-12
(tests/test_kernels.py:15-21).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import oracle  # noqa: E402
from repro.core.ryser import nw_base_vector  # noqa: E402
from repro.kernels import ops as OPS  # noqa: E402
from repro.kernels import ryser_pallas as RP  # noqa: E402
from repro_torch.core.stepspace import Geometry  # noqa: E402
from repro_torch.kernels import ops as TOPS  # noqa: E402
from repro_torch.kernels import ryser_cuda as RC  # noqa: E402

PRECISIONS = ("dd", "dq_fast", "dq_acc", "qq", "kahan")


def _padded(A):
    """(A_pad, xb_pad) from the reference's own padding, as numpy."""
    A_pad = np.asarray(OPS.pad_matrix(jnp.asarray(A)))
    xb = np.asarray(OPS.pad_base_vector(nw_base_vector(jnp.asarray(A)),
                                        A_pad.shape[0])).reshape(-1, 1)
    return A_pad, xb


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got[..., 0] + got[..., 1],
                               want[..., 0] + want[..., 1],
                               rtol=1e-12, atol=1e-15)


def _scalar_pair(A, geo, chunk_base, blocks, precision, mode):
    n = A.shape[0]
    TB, C, Wu, _ = geo.kernel_geometry(n)
    A_pad, xb = _padded(A)
    want = RP.ryser_pallas_call(jnp.asarray(A_pad), jnp.asarray(xb),
                                chunk_base, n=n, TB=TB, C=C, Wu=Wu,
                                num_blocks=blocks, precision=precision,
                                mode=mode, interpret=True)
    got = RC.ryser_cuda_call(torch.tensor(A_pad), torch.tensor(xb),
                             chunk_base, n=n, TB=TB, C=C, Wu=Wu,
                             num_blocks=blocks, precision=precision,
                             mode=mode)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("mode", ["baseline", "batched"])
def test_plain_matches_pallas_precisions(mode, precision):
    A = np.random.default_rng(11).uniform(-1, 1, (10, 10))
    geo = Geometry(8, 8, 4)
    _, _, _, blocks = geo.kernel_geometry(10)
    _close(*_scalar_pair(A, geo, 0, blocks, precision, mode))


@pytest.mark.parametrize("geometry", [(8, 8, 4), (4, 4, 2), (16, 16, 16),
                                      (64, 8, 8)])
@pytest.mark.parametrize("mode", ["baseline", "batched"])
def test_plain_matches_pallas_geometry_sweep_nonzero_base(geometry, mode):
    """A window that starts at a nonzero chunk base and ends at the top of
    the step space (the last boundary step is not live)."""
    n = 11
    A = np.random.default_rng(12).uniform(-1, 1, (n, n))
    geo = Geometry(*geometry)
    TB, _, _, blocks = geo.kernel_geometry(n)
    nb = max(1, blocks // 2)
    base = (blocks - nb) * TB
    _close(*_scalar_pair(A, geo, base, nb, "dq_acc", mode))


@pytest.mark.parametrize("mode", ["baseline", "batched"])
@pytest.mark.parametrize("precision", ["dd", "dq_acc"])
def test_batched_plain_matches_pallas_batched(mode, precision):
    n, B = 9, 3
    As = np.random.default_rng(13).uniform(-1, 1, (B, n, n))
    geo = Geometry(8, 8, 4)
    TB, C, Wu, blocks = geo.kernel_geometry(n)
    pads = [_padded(A) for A in As]
    A_pads = np.stack([p[0] for p in pads])
    xbs = np.stack([p[1] for p in pads])
    want = RP.ryser_pallas_call_batched(
        jnp.asarray(A_pads), jnp.asarray(xbs), n=n, TB=TB, C=C, Wu=Wu,
        num_blocks=blocks, precision=precision, mode=mode, interpret=True)
    got = RC.ryser_cuda_call_batched(
        torch.tensor(A_pads), torch.tensor(xbs), n=n, TB=TB, C=C, Wu=Wu,
        num_blocks=blocks, precision=precision, mode=mode)
    _close(got.numpy(), want)


@pytest.mark.parametrize("n", [4, 6, 9, 12])
@pytest.mark.parametrize("mode", ["baseline", "batched"])
def test_permanent_cuda_matches_pallas_and_exact(n, mode):
    A = np.random.default_rng(14 + n).uniform(-1, 1, (n, n))
    geo = Geometry(8, 8, 4)
    got = float(TOPS.permanent_cuda(A, mode=mode, geometry=geo,
                                    device="cpu"))
    np.testing.assert_allclose(got, oracle.perm_ryser_exact(A), rtol=1e-9,
                               atol=1e-12)
    want = float(OPS.permanent_pallas(A, mode=mode, geometry=geo))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


def test_permanent_cuda_default_geometry_and_small_n():
    A = np.random.default_rng(15).uniform(-1, 1, (12, 12))
    np.testing.assert_allclose(float(TOPS.permanent_cuda(A, device="cpu")),
                               oracle.perm_ryser_exact(A), rtol=1e-9,
                               atol=1e-12)
    for n in (1, 2):
        M = A[:n, :n]
        assert float(TOPS.permanent_cuda(M, device="cpu")) == \
            float(OPS.permanent_pallas(M))


def test_batched_entry_bitwise_equals_scalar_entry_in_batched_mode():
    n = 10
    As = np.random.default_rng(16).uniform(-1, 1, (4, n, n))
    geo = Geometry(8, 8, 4)
    batch = TOPS.permanent_cuda_batched(As, geometry=geo,
                                        device="cpu").numpy()
    for i, A in enumerate(As):
        one = float(TOPS.permanent_cuda(A, mode="batched", geometry=geo,
                                        device="cpu"))
        assert one == batch[i]


def test_block_partials_cuda_compose_and_kernel_reduce():
    """Two half windows sum to the full space, and kernel_reduce folds the
    partials into the permanent."""
    n = 11
    A = np.random.default_rng(17).uniform(-1, 1, (n, n))
    geo = Geometry(8, 8, 4)
    full, (TB, C, Wu, blocks) = TOPS.block_partials_cuda(A, geometry=geo,
                                                         device="cpu")
    lo, _ = TOPS.block_partials_cuda(A, num_blocks=blocks // 2,
                                     geometry=geo, device="cpu")
    hi, _ = TOPS.block_partials_cuda(A, dev_chunk_base=(blocks // 2) * TB,
                                     num_blocks=blocks // 2, geometry=geo,
                                     device="cpu")
    np.testing.assert_array_equal(torch.cat([lo, hi]).numpy(), full.numpy())
    At = torch.as_tensor(A)
    p0 = TOPS.chain_prod(TOPS.nw_base_vector(At)[:, None])[0]
    val = float(TOPS.kernel_reduce(full[:, 0], full[:, 1], p0, n))
    np.testing.assert_allclose(val, oracle.perm_ryser_exact(A), rtol=1e-9)
    x = torch.as_tensor(np.random.default_rng(1).uniform(-1, 1, 13))
    assert float(TOPS.tree_sum(x)) == pytest.approx(float(x.sum()),
                                                   rel=1e-14)


def test_padding_matches_reference():
    A = np.random.default_rng(18).uniform(-1, 1, (13, 13))
    np.testing.assert_array_equal(
        TOPS.pad_matrix(torch.as_tensor(A)).numpy(),
        np.asarray(OPS.pad_matrix(jnp.asarray(A))))
    x = A[0]
    np.testing.assert_array_equal(
        TOPS.pad_base_vector(torch.as_tensor(x), 16).numpy(),
        np.asarray(OPS.pad_base_vector(jnp.asarray(x), 16)))
    sched = RC._signed_const_schedule(16)
    assert sched == RP._signed_const_schedule(16)
    np.testing.assert_array_equal(RC._cumsig_host(sched, 16),
                                  RP._cumsig_host(sched, 16))


def test_wrapper_checks_inputs():
    A = torch.zeros(16, 16, dtype=torch.float16)
    xb = torch.ones(16, 1, dtype=torch.float16)
    with pytest.raises(TypeError, match="f64 or f32"):
        RC.ryser_cuda_call(A, xb, 0, n=10, TB=8, C=8, Wu=4, num_blocks=8)
    with pytest.raises(TypeError, match="one dtype"):
        RC.ryser_cuda_call(A.double(), xb.float(), 0, n=10, TB=8, C=8, Wu=4,
                           num_blocks=8)
    with pytest.raises(ValueError, match="step space"):
        RC.ryser_cuda_call(A.double(), xb.double(), 8, n=10, TB=8, C=8,
                           Wu=4, num_blocks=8)
    with pytest.raises(ValueError, match="unsupported device"):
        RC.ryser_cuda_call(A.double().to("meta"), xb.double().to("meta"), 0,
                           n=10, TB=8, C=8, Wu=4, num_blocks=8)
