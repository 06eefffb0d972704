"""The general generator: every input of a run, drawn from ``--seed``.

A configuration (``bench/configs/<name>.json``) names a matrix family,
found by name in ``bench/families/<family>.py``, and its parameters; a
traffic mix (``bench/traffic/<name>.json``) names the size ``n`` and how
many matrices a call takes (``batch``).  A family module gives

* ``setup(config, n, seed)``: what a run's draws share (a unitary, the
  entries' range), once a stream;
* ``draw(ctx, gen, n, batch)``: a call's token, all that it takes to
  rebuild the call's matrices, drawn from ``gen``;
* ``matrices(ctx, token, n, batch)``: the ``(batch, n, n)`` matrices of
  a token;
* ``flops(n)``: the yardstick's FLOPs of one permanent of the family.

The same seed gives the same inputs in the same order; each purpose
(the window, the warm-up, the check's sample) draws from a stream of its
own, so a longer window never changes what the warm-up or the check
draws.
"""

from __future__ import annotations

import numpy as np

from . import byname

__all__ = ["Draws", "STREAMS", "rng"]

STREAMS = {"window": 0, "warmup": 1, "check": 2, "unitary": 3}


def rng(seed: int, stream: str) -> np.random.Generator:
    """The generator of one purpose of one seed; any whole number is a
    seed (negative ones and those past 64 bits included)."""
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) % (1 << 64), STREAMS[stream]]))


class Draws:
    """The calls of one stream of ``cell``: ``next()`` gives ``(matrices,
    token)``, the matrices an ``(n, n)`` array for a batch of 1, else
    ``(batch, n, n)``."""

    def __init__(self, cell, seed: int, stream: str):
        self.family = byname.family(cell)
        self.n = int(cell.traffic["n"])
        self.batch = int(cell.traffic.get("batch", 1))
        self.gen = rng(seed, stream)
        self.ctx = self.family.setup(cell.config, self.n, seed)

    def next(self):
        token = self.family.draw(self.ctx, self.gen, self.n, self.batch)
        return self.matrices(token), token

    def matrices(self, token) -> np.ndarray:
        """The matrices of a call from its token."""
        mats = self.family.matrices(self.ctx, token, self.n, self.batch)
        return mats[0] if self.batch == 1 else mats
