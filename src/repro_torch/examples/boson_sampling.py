"""Boson-sampling output probabilities via permanents (paper Sec. 1), on
the port.

    python -m repro_torch.examples.boson_sampling [--device cpu|cuda]

The port of ``examples/boson_sampling.py``.  The probability of output
configuration T from input S through a linear-optical network U is
|perm(U_{S,T})|^2 / (prod s_i! prod t_j!).  A Haar-random unitary, the
submatrices of a set of output patterns, their probabilities one at a
time and through ``plan_batch`` (one bucket: kernel #4, the split-plane
batch entry, with no downgrade), the result cache on a resampled stream,
and the sum over every collision-free output of a small instance.  On
the CPU the reference's m = 12 modes, n = 6 photons and 32 patterns; on
the card m = 576, n = 24 and 256 patterns, so the bucket runs #4 at the
main path's shape.  The collision-free sum stays at m = 8, n = 4: it
enumerates every output.
"""

from __future__ import annotations

import itertools

import numpy as np

from ..core.engine import permanent
from ..core.solver import PermanentSolver, SolverConfig
from . import card, cli

__all__ = ["main", "haar_unitary"]


def haar_unitary(m: int, rng) -> np.ndarray:
    z = (rng.normal(size=(m, m)) + 1j * rng.normal(size=(m, m))) / np.sqrt(2)
    q, r = np.linalg.qr(z)
    return q * (np.diag(r) / np.abs(np.diag(r)))


def _patterns(m: int, n: int, count: int, rng, on_card: bool) -> list:
    """``count`` collision-free output patterns: the reference's shuffle
    of every combination on the CPU; on the card (C(576, 24) is too many
    to list) ``count`` distinct sorted draws."""
    if not on_card:
        patterns = list(itertools.combinations(range(m), n))
        rng.shuffle(patterns)
        return patterns[:count]
    seen: dict = {}
    while len(seen) < count:
        seen.setdefault(tuple(sorted(rng.choice(m, n, replace=False)
                                     .tolist())), None)
    return list(seen)


def main(device: str | None = None) -> dict:
    dev, on_card = card(device)
    m_modes, n_photons, count = (576, 24, 256) if on_card else (12, 6, 32)
    out: dict = {}
    rng = np.random.default_rng(42)
    U = haar_unitary(m_modes, rng)
    in_modes = list(range(n_photons))
    patterns = _patterns(m_modes, n_photons, count, rng, on_card)

    # --- engine path: one permanent at a time (full preprocessing) -------
    probs = []
    for T in patterns[:8]:
        amp = permanent(U[np.ix_(in_modes, T)], precision="kahan",
                        device=dev)
        probs.append(abs(amp) ** 2)
    print("per-pattern probabilities (engine):")
    for T, p in zip(patterns[:8], probs):
        print(f"  T={T}: {p:.3e}")
    out["probs"] = probs

    # --- batched complex solver path: ONE bucket for the pattern set -----
    subs = [U[np.ix_(in_modes, T)] for T in patterns]
    psolver = PermanentSolver(SolverConfig(precision="kahan", backend="cuda",
                                           device=dev))
    plan = psolver.plan_batch(subs)
    print(f"\n{plan.summary()}")
    amps, reports = psolver.execute(plan, return_report=True)
    tags = sorted({t for r in reports for t in r.dispatch})
    assert not any("->" in t for t in tags), \
        f"complex buckets must not downgrade: {tags}"
    print(f"dispatch tags: {tags}")
    bprobs = np.abs(np.asarray(amps)) ** 2
    print(f"batched over {len(patterns)} patterns: "
          f"sum p = {bprobs.sum():.4f} (partial space)")
    np.testing.assert_allclose(bprobs[:8], probs, rtol=1e-8)
    print("engine vs batched solver paths agree to 1e-8  OK")
    out.update(plan=plan.summary(), tags=tags, sum_p=float(bprobs.sum()))

    # --- solver path: resampled patterns hit the result cache ------------
    solver = PermanentSolver(SolverConfig(precision="kahan", device=dev))
    draws = [patterns[i] for i in rng.integers(0, 8, 64)]
    stream = [U[np.ix_(in_modes, T)] for T in draws]
    svals = solver.execute(solver.plan_batch(stream))
    cs = solver.stats()["cache"]
    print(f"\nresampled stream of {len(stream)} submatrices: "
          f"{cs['hits']} cache hits / {cs['misses']} misses "
          f"({solver.stats()['device_dispatches']} device dispatches)")
    np.testing.assert_allclose(
        np.abs(svals) ** 2, [bprobs[patterns.index(T)] for T in draws],
        rtol=1e-8)
    print("solver path agrees with batched path  OK")
    out.update(hits=cs["hits"], misses=cs["misses"],
               dispatches=solver.stats()["device_dispatches"])

    # --- the sum over ALL collision-free outputs of a small instance -----
    m_small, n_small = 8, 4
    U2 = haar_unitary(m_small, rng)
    total = 0.0
    for T in itertools.combinations(range(m_small), n_small):
        sub = U2[np.ix_(list(range(n_small)), T)]
        total += abs(permanent(sub, precision="kahan", device=dev)) ** 2
    print(f"\nsum over all collision-free outputs (m={m_small}, "
          f"n={n_small}): {total:.4f} <= 1  "
          f"({'OK' if total <= 1.0 + 1e-9 else 'VIOLATION'})")
    out["total"] = total
    return out


if __name__ == "__main__":
    cli(main, __doc__)
