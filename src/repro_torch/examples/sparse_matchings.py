"""Counting perfect matchings of bipartite graphs via 0/1 permanents
(paper Sec. 1), on the port.

    python -m repro_torch.examples.sparse_matchings [--device cpu|cuda]

The port of ``examples/sparse_matchings.py``: DM elimination strips the
edges that lie on no perfect matching, Forbert-Marx compression folds
low-degree vertices, and each count is held against ``perm_bigint``.  On
the card one more graph reaches a kernel: the circulant band of degree 7
at n = 32, which DM/FM leave whole, so it runs the sparse kernel #5.
``perm_bigint`` cannot reach n = 32, so its count is held against the
dense kernel #1 (``ops.permanent_cuda``) on the same matrix within rel
1e-12: Ryser's alternating sum is not exact in f64, and such a count can
pass 2^53.
"""

from __future__ import annotations

import numpy as np

from ..core.decompose import dm_eliminate, fm_decompose
from ..core.engine import permanent
from ..core.oracle import perm_bigint
from . import card, cli

__all__ = ["main", "grid_graph_biadjacency", "circulant_band"]

BAND_N, BAND_DEGREE, BAND_RTOL = 32, 7, 1e-12


def grid_graph_biadjacency(rows: int, cols: int) -> np.ndarray:
    """Bipartite double cover of a rows x cols grid: matchings of the
    cover correspond to dimer configurations."""
    n = rows * cols
    A = np.zeros((n, n))
    for r in range(rows):
        for c in range(cols):
            u = r * cols + c
            A[u, u] = 1
            if c + 1 < cols:
                A[u, u + 1] = 1
                A[u + 1, u] = 1
            if r + 1 < rows:
                A[u, u + cols] = 1
                A[u + cols, u] = 1
    return A


def circulant_band(n: int, degree: int) -> np.ndarray:
    """0/1 biadjacency of the circulant graph: column j joins rows j ..
    j + degree - 1 (mod n)."""
    A = np.zeros((n, n))
    for j in range(n):
        for o in range(degree):
            A[(j + o) % n, j] = 1.0
    return A


def main(device: str | None = None) -> dict:
    dev, on_card = card(device)
    out: dict = {}
    rng = np.random.default_rng(3)

    # --- 1. structured graph ----------------------------------------------
    A = grid_graph_biadjacency(4, 4)
    count = round(permanent(A, device=dev))
    exact = perm_bigint(A.astype(np.int64))
    print(f"4x4 grid cover: {count} perfect matchings "
          f"(exact bigint oracle: {exact}) "
          f"{'OK' if count == exact else 'MISMATCH'}")
    out["grid"] = (count, exact)

    # --- 2. random sparse bipartite graph + preprocessing detail ----------
    n, p = 22, 0.18
    G = (rng.uniform(0, 1, (n, n)) < p).astype(float)
    G[np.arange(n), np.arange(n)] = 1.0
    Gdm, removed = dm_eliminate(G)
    leaves = fm_decompose(Gdm)
    val, report = permanent(G, return_report=True, device=dev)
    exact = perm_bigint(G.astype(np.int64))
    print(f"\nrandom bipartite n={n}, |E|={int(G.sum())}:")
    print(f"  DM removed {removed} edges in no perfect matching")
    print(f"  Forbert-Marx left {len(leaves)} leaves, sizes "
          f"{sorted(set(l.matrix.shape[0] for l in leaves), reverse=True)}")
    print(f"  matchings = {round(val)} (exact {exact}) "
          f"{'OK' if round(val) == exact else 'MISMATCH'}")
    out.update(edges=int(G.sum()), dm_removed=removed, fm_leaves=len(leaves),
               random=(round(val), exact))

    # --- 3. a graph with NO perfect matching ------------------------------
    H = np.zeros((6, 6))
    H[:, :4] = 1.0
    koenig = round(permanent(H, device=dev))
    print(f"\nKoenig-deficient graph: {koenig} "
          "matchings (structurally singular, detected by DM)")
    out["koenig"] = koenig

    # --- 4. triangular: only the diagonal survives DM ---------------------
    T = np.tril(np.ones((8, 8)))
    _, rem = dm_eliminate(T)
    tri = round(permanent(T, device=dev))
    print(f"\nlower-triangular: DM removed {rem}/{int(T.sum()) - 8} "
          f"off-diagonal entries; perm = {tri}")
    out.update(tri_removed=rem, tri=tri)

    # --- 5. (card) a band DM/FM leave whole: the sparse kernel ------------
    if on_card:
        from ..kernels.ops import permanent_cuda
        B = circulant_band(BAND_N, BAND_DEGREE)
        count, report = permanent(B, return_report=True, device=dev)
        dense = float(permanent_cuda(B, device=dev))
        rel = abs(count - dense) / abs(dense)
        ok = rel <= BAND_RTOL and f"sparse(n={BAND_N},cuda)" in report.dispatch
        print(f"\ncirculant band n={BAND_N}, degree {BAND_DEGREE}: "
              f"{count:.17e} matchings ({report.dispatch}); dense kernel "
              f"{dense:.17e}, rel {rel:.2e} "
              f"{'OK' if ok else 'MISMATCH'}")
        out.update(band=count, band_dense=dense, band_rel=rel,
                   band_dispatch=report.dispatch, band_ok=ok)
    return out


if __name__ == "__main__":
    cli(main, __doc__)
