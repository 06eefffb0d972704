"""Tests that need the card: the CUDA kernels (dense real and split-plane
complex) against their plain versions and the main path against the torch
engine, on the device.  They skip where no
card is present; on a machine with one run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch.core.stepspace import DEFAULT_GEOMETRY  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ryser_complex_cuda as RX  # noqa: E402
from repro_torch.kernels import ryser_cuda as RC  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("mode", ["baseline", "batched"])
@pytest.mark.parametrize("n", [5, 13, 30, 64])
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


@pytest.mark.parametrize("n", [5, 13, 30, 64])
def test_complex_kernel_matches_plain_on_card(card, n):
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
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-15)
    got = RX.ryser_cuda_call_complex_batched(*planes, **geo)
    want = RX.block_partials_plain_complex(*planes, 0, **geo)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-15)


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
