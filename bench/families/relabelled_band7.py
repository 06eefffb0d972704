"""Weighted (0,1)-circulant bands of degree 7, relabelled a call: the
biadjacency matrices of 7-regular bipartite graphs, whose permanent is
the weighted count of their perfect matchings.

The support is the k-band circulant of Minc, "Permanents of
(0,1)-circulants" (Canad. Math. Bull. 7, 1964): column j has its
nonzeros in rows j, j + 1, ..., j + k - 1 (mod n).  A call's graph
arrives unlabelled, so its rows and columns are relabelled by two fresh
uniform permutations, and its edges carry fresh U(``low``, ``high``)
weights.  The token is all that rebuilds a call's matrices: the row and
column permutations and the k n weights, in column-then-offset order.

The yardstick's count is what Ryser's formula needs on this input,
whatever implements it: per Gray step, k adds update the row sums over
the flipped column's nonzeros, n - 1 multiplies form prod_i x[i] and one
add goes into the sum, (n + k) 2^(n-1) a permanent.  ``flops(n)`` takes
n alone, so this file fixes k = 7.
"""

import numpy as np

DEGREE = 7


def band(n: int, degree: int) -> np.ndarray:
    """(n, degree) row ids of the band: row ``(j + k) % n`` is column
    j's k-th nonzero."""
    if not 1 <= degree <= n:
        raise ValueError(f"a band of degree {degree} needs n >= {degree}, "
                         f"got n = {n}")
    return (np.arange(n)[:, None] + np.arange(degree)) % n


def draw_band(gen: np.random.Generator, n: int, batch: int, degree: int,
              low: float, high: float):
    """A token of ``batch`` relabelled bands: (row perms, column perms),
    each (batch, n), and the (batch, n, degree) edge weights."""
    rperm = np.stack([gen.permutation(n) for _ in range(batch)])
    cperm = np.stack([gen.permutation(n) for _ in range(batch)])
    weights = gen.uniform(low, high, size=(batch, n, degree))
    return rperm, cperm, weights


def build(token) -> np.ndarray:
    """The (batch, n, n) matrices of a token: the band weighted by its
    weights, then row i of a matrix is the band's row ``rperm[i]`` and
    column j its column ``cperm[j]``.  The degree is the weights' last
    axis."""
    rperm, cperm, weights = token
    batch, n, degree = weights.shape
    M = np.zeros((batch, n, n))
    cols = np.broadcast_to(np.arange(n)[:, None], (n, degree))
    M[:, band(n, degree), cols] = weights
    b = np.arange(batch)[:, None, None]
    return M[b, rperm[:, :, None], cperm[:, None, :]]


def setup(config: dict, n: int, seed: int):
    if int(config["degree"]) != DEGREE:
        raise ValueError(f"the family relabelled_band7 has degree {DEGREE}, "
                         f"the configuration asks for {config['degree']}")
    band(n, DEGREE)
    return float(config["low"]), float(config["high"])


def draw(ctx, gen: np.random.Generator, n: int, batch: int):
    low, high = ctx
    return draw_band(gen, n, batch, DEGREE, low, high)


def matrices(ctx, token, n: int, batch: int) -> np.ndarray:
    return build(token)


def flops(n: int) -> float:
    return (n + DEGREE) * 2.0 ** (n - 1)
