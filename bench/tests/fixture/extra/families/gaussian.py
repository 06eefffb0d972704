"""A matrix family added as a file alone: real matrices with entries
drawn from N(0, ``sigma``^2), a fresh matrix an item."""

import numpy as np

from bench import yardstick


def setup(config: dict, n: int, seed: int) -> float:
    return float(config["sigma"])


def draw(ctx, gen: np.random.Generator, n: int, batch: int) -> np.ndarray:
    return gen.normal(0.0, ctx, size=(batch, n, n))


def matrices(ctx, token, n: int, batch: int) -> np.ndarray:
    return token


def flops(n: int) -> float:
    return yardstick.real_ryser_flops(n)
