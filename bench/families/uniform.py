"""Real matrices with entries drawn from U(``low``, ``high``), a fresh
matrix an item; the token is the matrices themselves."""

import numpy as np

from bench import yardstick


def setup(config: dict, n: int, seed: int):
    return float(config["low"]), float(config["high"])


def draw(ctx, gen: np.random.Generator, n: int, batch: int) -> np.ndarray:
    low, high = ctx
    return gen.uniform(low, high, size=(batch, n, n))


def matrices(ctx, token, n: int, batch: int) -> np.ndarray:
    return token


def flops(n: int) -> float:
    return yardstick.real_ryser_flops(n)
