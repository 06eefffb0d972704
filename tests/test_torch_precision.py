"""The port's twofloat primitives and Gray helpers vs the reference package:
elementwise bitwise equality on the same numpy inputs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import gray as G  # noqa: E402
from repro.core import precision as P  # noqa: E402
from repro_torch.core import gray as TG  # noqa: E402
from repro_torch.core import precision as TP  # noqa: E402

RNG = np.random.default_rng(7)
N = 4096


def _inputs():
    """Operands across magnitudes and signs, including cancellation pairs."""
    a = RNG.uniform(-1, 1, N) * 10.0 ** RNG.integers(-8, 9, N)
    b = RNG.uniform(-1, 1, N) * 10.0 ** RNG.integers(-8, 9, N)
    b[: N // 8] = -a[: N // 8] * (1 + RNG.uniform(-1e-12, 1e-12, N // 8))
    return a, b


def _bitwise(got, want):
    got = np.asarray(got.numpy() if hasattr(got, "numpy") else got)
    want = np.asarray(want)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))


def _pairs(ref_out, port_out):
    if isinstance(ref_out, tuple):
        assert len(ref_out) == len(port_out)
        for r, p in zip(ref_out, port_out):
            _bitwise(p, r)
    else:
        _bitwise(port_out, ref_out)


@pytest.mark.parametrize("name", ["two_sum", "fast_two_sum", "two_prod"])
def test_error_free_transforms_bitwise(name):
    a, b = _inputs()
    if name == "fast_two_sum":                   # requires |a| >= |b|
        a, b = np.where(abs(a) >= abs(b), a, b), np.where(abs(a) >= abs(b), b, a)
    ref = getattr(P, name)(jnp.asarray(a), jnp.asarray(b))
    got = getattr(TP, name)(torch.as_tensor(a), torch.as_tensor(b))
    _pairs(ref, got)


def test_split_bitwise_and_exact():
    a, _ = _inputs()
    ref = P.split(jnp.asarray(a))
    got = TP.split(torch.as_tensor(a))
    _pairs(ref, got)
    hi, lo = got
    np.testing.assert_array_equal((hi + lo).numpy(), a)


@pytest.mark.parametrize("name", ["tf_add_fast", "tf_add_acc"])
def test_twofloat_scalar_ops_bitwise(name):
    a, b = _inputs()
    lo = a * 1e-17
    ref = getattr(P, name)(P.TwoFloat(jnp.asarray(a), jnp.asarray(lo)),
                           jnp.asarray(b))
    got = getattr(TP, name)(TP.TwoFloat(torch.as_tensor(a),
                                        torch.as_tensor(lo)),
                            torch.as_tensor(b))
    _pairs(tuple(ref), tuple(got))


@pytest.mark.parametrize("name", ["tf_add_tf", "tf_mul_tf"])
def test_twofloat_pair_ops_bitwise(name):
    a, b = _inputs()
    la, lb = a * 3e-17, b * -2e-17
    ref = getattr(P, name)(P.TwoFloat(jnp.asarray(a), jnp.asarray(la)),
                           P.TwoFloat(jnp.asarray(b), jnp.asarray(lb)))
    got = getattr(TP, name)(TP.TwoFloat(torch.as_tensor(a),
                                        torch.as_tensor(la)),
                            TP.TwoFloat(torch.as_tensor(b),
                                        torch.as_tensor(lb)))
    _pairs(tuple(ref), tuple(got))
    _bitwise(TP.tf_value(got), P.tf_value(ref))


def test_kahan_add_bitwise_over_a_stream():
    terms = RNG.uniform(-1, 1, (64, 256)) * 10.0 ** RNG.integers(-6, 7, (64, 256))
    ref = P.kahan_init(shape=(256,))
    got = (torch.zeros(256, dtype=torch.float64),) * 2
    for t in terms:
        ref = P.kahan_add(ref, jnp.asarray(t))
        got = TP.kahan_add(got, torch.as_tensor(t))
    _pairs(ref, got)


def test_split_constant_matches_reference():
    assert TP._split_const(torch.float64) == P._split_const(jnp.float64)
    assert TP._split_const(torch.float32) == P._split_const(jnp.float32)
    assert TP.PRECISION_MODES == P.PRECISION_MODES


def test_gray_host_helpers_equal():
    for g in range(1, 600):
        assert TG.gray(g) == G.gray(g)
        assert TG.ctz(g) == G.ctz(g)
        assert TG.step_sign(g) == G.step_sign(g)
        for j in range(10):
            assert TG.gray_bit(g, j) == G.gray_bit(g, j)
    big = (1 << 63) - 12345
    assert TG.ctz(big + 1) == G.ctz(big + 1)
    for k in range(1, 9):
        np.testing.assert_array_equal(TG.changed_bit_schedule(k),
                                      G.changed_bit_schedule(k))
    starts = np.array([0, 2, 64, 4096, (1 << 62) + 8, (1 << 63) - 16],
                      dtype=np.uint64)
    np.testing.assert_array_equal(TG.gray_bits_matrix(starts, 64),
                                  G.gray_bits_matrix(starts, 64))


def test_gray_tensor_helpers_equal():
    g = np.arange(1, 5000, dtype=np.int64)
    np.testing.assert_array_equal(
        TG.gray_code_torch(torch.as_tensor(g)).numpy(),
        np.asarray(G.gray_code_jnp(jnp.asarray(g))))
    for j in range(0, 12):
        np.testing.assert_array_equal(
            TG.step_sign_torch(torch.as_tensor(g), j).numpy(),
            np.asarray(G.step_sign_jnp(jnp.asarray(g), j)))
