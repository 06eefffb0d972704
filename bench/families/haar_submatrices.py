"""Boson-sampling amplitude matrices: one Haar-random ``modes`` x
``modes`` unitary U a run, from the seed; an item is U[S, T] for the
first n input modes S and a collision-free output pattern T, n sorted
distinct modes, distinct within a call.  The token is the patterns."""

import numpy as np

from bench import inputs, yardstick


def haar_unitary(m: int, gen: np.random.Generator) -> np.ndarray:
    """A Haar-random m x m unitary: QR of a complex Gaussian matrix with
    the phases of R's diagonal divided out."""
    z = (gen.normal(size=(m, m)) + 1j * gen.normal(size=(m, m))) / np.sqrt(2)
    q, r = np.linalg.qr(z)
    return q * (np.diag(r) / np.abs(np.diag(r)))


def setup(config: dict, n: int, seed: int) -> dict:
    if n != int(config["photons"]):
        raise ValueError(f"traffic n = {n}, but the configuration has "
                         f"{config['photons']} photons")
    modes = int(config["modes"])
    # one unitary a seed, the same for every stream
    unitary = haar_unitary(modes, inputs.rng(seed, "unitary"))
    return {"modes": modes, "unitary": unitary, "rows": unitary[:n]}


def draw(ctx, gen: np.random.Generator, n: int, batch: int) -> np.ndarray:
    while True:
        keys = gen.random((batch, ctx["modes"]))
        pats = np.sort(np.argpartition(keys, n, axis=1)[:, :n],
                       axis=1).astype(np.int16)
        if len(np.unique(pats, axis=0)) == batch:
            return pats


def matrices(ctx, token, n: int, batch: int) -> np.ndarray:
    return np.ascontiguousarray(
        ctx["rows"][:, token.astype(np.int64)].transpose(1, 0, 2))


def flops(n: int) -> float:
    return yardstick.complex_ryser_flops(n)
