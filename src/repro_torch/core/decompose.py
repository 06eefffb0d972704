"""Sparse preprocessing for permanents (paper Sec. 4): Dulmage-Mendelsohn
redundant-entry elimination and the Forbert-Marx compression recursion.

A copy of the reference package's ``core/decompose.py``.  All host-side
NumPy / pure Python (preprocessing cost is polynomial and
negligible next to the exponential kernel; paper: < 5s for every test
matrix).

* ``dm_eliminate``    -- Sec. 4.1: find a perfect matching (Hopcroft-Karp),
  orient matched edges row->col and the rest col->row, compute SCCs
  (iterative Tarjan), and zero every entry whose edge crosses SCCs -- such
  entries are in no perfect matching, hence contribute nothing.
* ``fm_decompose``    -- Sec. 4.2 / Alg. 4: while some row/column has
  ``minNnz <= 4``, apply D1 / D2 / D34 compression (Eq. 6), producing a
  list of (coefficient, matrix) leaves whose permanents sum to perm(A).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = [
    "hopcroft_karp",
    "strongly_connected_components",
    "dm_eliminate",
    "fm_decompose",
    "Leaf",
]


# ---------------------------------------------------------------------------
# Bipartite maximum matching.  Permanent matrices are tiny (n <= ~64), so
# Kuhn's augmenting-path algorithm (O(V * E)) is exact and more than fast
# enough; the paper's O(E sqrt(V)) Hopcroft-Karp bound is irrelevant at this
# scale (preprocessing < 5s even in the paper's own experiments).
# ---------------------------------------------------------------------------

def hopcroft_karp(adj: list[list[int]], n_left: int, n_right: int):
    """Maximum matching of a bipartite graph (Kuhn's algorithm).

    ``adj[u]`` lists right-vertices adjacent to left-vertex ``u``.
    Returns (match_l, match_r) with -1 for unmatched.
    """
    match_l = [-1] * n_left
    match_r = [-1] * n_right

    def try_augment(u: int, seen: list[bool]) -> bool:
        for v in adj[u]:
            if seen[v]:
                continue
            seen[v] = True
            if match_r[v] == -1 or try_augment(match_r[v], seen):
                match_l[u] = v
                match_r[v] = u
                return True
        return False

    # greedy warm start
    for u in range(n_left):
        for v in adj[u]:
            if match_r[v] == -1:
                match_l[u] = v
                match_r[v] = u
                break
    for u in range(n_left):
        if match_l[u] == -1:
            try_augment(u, [False] * n_right)
    return match_l, match_r


# ---------------------------------------------------------------------------
# Strongly connected components (iterative Tarjan), O(V + E)
# ---------------------------------------------------------------------------

def strongly_connected_components(adj: list[list[int]]) -> list[int]:
    """Returns comp[v] = SCC id for a directed graph given as adjacency lists."""
    n = len(adj)
    UNVISITED = -1
    index = [UNVISITED] * n
    low = [0] * n
    on_stack = [False] * n
    comp = [UNVISITED] * n
    stack: list[int] = []
    next_index = 0
    next_comp = 0

    for root in range(n):
        if index[root] != UNVISITED:
            continue
        work = [(root, 0)]
        while work:
            v, pi = work[-1]
            if pi == 0:
                index[v] = low[v] = next_index
                next_index += 1
                stack.append(v)
                on_stack[v] = True
            advanced = False
            while pi < len(adj[v]):
                w = adj[v][pi]
                pi += 1
                if index[w] == UNVISITED:
                    work[-1] = (v, pi)
                    work.append((w, 0))
                    advanced = True
                    break
                elif on_stack[w]:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            if low[v] == index[v]:
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    comp[w] = next_comp
                    if w == v:
                        break
                next_comp += 1
            work.pop()
            if work:
                u, _ = work[-1]
                low[u] = min(low[u], low[v])
    return comp


# ---------------------------------------------------------------------------
# Dulmage-Mendelsohn redundant-entry elimination (Sec. 4.1)
# ---------------------------------------------------------------------------

def dm_eliminate(A: np.ndarray):
    """Zero out entries that appear in no perfect matching.

    Returns (A', removed_count).  If the matrix has no perfect matching the
    permanent is 0 and A' is the zero matrix.
    """
    A = np.asarray(A)
    n = A.shape[0]
    mask = A != 0
    adj = [list(np.nonzero(mask[i])[0]) for i in range(n)]
    match_l, match_r = hopcroft_karp(adj, n, n)
    if any(m == -1 for m in match_l):
        return np.zeros_like(A), int(mask.sum())

    # directed bipartite graph: rows 0..n-1, cols n..2n-1
    # matched edges row -> col; unmatched col -> row
    dadj: list[list[int]] = [[] for _ in range(2 * n)]
    for i in range(n):
        for j in adj[i]:
            if match_l[i] == j:
                dadj[i].append(n + j)
            else:
                dadj[n + j].append(i)
    comp = strongly_connected_components(dadj)

    # an edge is in some perfect matching iff it is matched or lies on an
    # alternating cycle (endpoints in one SCC).  Matched edges always stay --
    # the paper's phrasing omits this, but e.g. for a triangular matrix every
    # matched (diagonal) edge is its own SCC pair yet obviously survives.
    out = A.copy()
    removed = 0
    for i in range(n):
        for j in adj[i]:
            if match_l[i] != j and comp[i] != comp[n + j]:
                out[i, j] = 0
                removed += 1
    return out, removed


# ---------------------------------------------------------------------------
# Forbert-Marx compression (Sec. 4.2 / Alg. 4)
# ---------------------------------------------------------------------------

@dataclass
class Leaf:
    """coef * perm(matrix) is one additive contribution to perm(A)."""
    coef: complex | float
    matrix: np.ndarray


def _min_degree(A: np.ndarray):
    mask = A != 0
    rdeg = mask.sum(axis=1)
    cdeg = mask.sum(axis=0)
    ri = int(np.argmin(rdeg))
    ci = int(np.argmin(cdeg))
    if rdeg[ri] <= cdeg[ci]:
        return "row", ri, int(rdeg[ri])
    return "col", ci, int(cdeg[ci])


def _compress_row(A: np.ndarray, i: int):
    """Apply Eq. 6 on row i (which must have 2..4 nonzeros, or 1 for D1).

    Returns list of (coef, matrix) children; each child is (n-1)x(n-1) or
    n x n per Alg. 4.
    """
    n = A.shape[0]
    js = np.nonzero(A[i] != 0)[0]
    deg = len(js)
    others = np.array([r for r in range(n) if r != i])
    if deg == 0:
        return []  # permanent contribution is zero
    if deg == 1:
        # D1: perm(A) = alpha * perm(A minus row i, col j)
        j = int(js[0])
        alpha = A[i, j]
        keep = np.array([c for c in range(n) if c != j])
        return [(alpha, A[np.ix_(others, keep)])]
    # pick the two first nonzeros as (alpha, beta)
    j1, j2 = int(js[0]), int(js[1])
    alpha, beta = A[i, j1], A[i, j2]
    keep = np.array([c for c in range(n) if c not in (j1, j2)])
    d = A[others][:, j1]          # column under alpha
    e = A[others][:, j2]          # column under beta
    B = A[np.ix_(others, keep)]
    merged = np.concatenate([(alpha * e + beta * d)[:, None], B], axis=1)
    if deg == 2:
        # D2: only the merged child survives (c == 0 in Eq. 6)
        return [(1.0, merged)]
    # D34: A' = A with alpha,beta zeroed (n x n) + merged ((n-1) x (n-1))
    Ap = A.copy()
    Ap[i, j1] = 0
    Ap[i, j2] = 0
    return [(1.0, Ap), (1.0, merged)]


def fm_decompose(A: np.ndarray, max_min_nnz: int = 4,
                 size_floor: int = 3) -> list[Leaf]:
    """Recursively compress A until every row/column has more than
    ``max_min_nnz`` nonzeros (paper: 4) or the matrix is tiny.

    Returns leaves [(coef, matrix)] with perm(A) = sum coef * perm(matrix).
    Matrices smaller than ``size_floor`` are folded into the coefficient
    directly (1x1 / 2x2 closed forms).
    """
    leaves: list[Leaf] = []
    stack: list[tuple[complex | float, np.ndarray]] = [(1.0, np.asarray(A))]
    while stack:
        coef, M = stack.pop()
        n = M.shape[0]
        if n == 0:
            leaves.append(Leaf(coef, np.ones((1, 1), dtype=M.dtype)))
            continue
        if n == 1:
            leaves.append(Leaf(coef * M[0, 0], np.ones((1, 1), dtype=M.dtype)))
            continue
        if n == 2:
            val = M[0, 0] * M[1, 1] + M[0, 1] * M[1, 0]
            leaves.append(Leaf(coef * val, np.ones((1, 1), dtype=M.dtype)))
            continue
        which, idx, deg = _min_degree(M)
        if deg == 0:
            continue  # zero row/col -> zero contribution
        if deg > max_min_nnz:
            leaves.append(Leaf(coef, M))
            continue
        W = M if which == "row" else M.T.copy()
        for ccoef, child in _compress_row(W, idx):
            child = child if which == "row" else child.T.copy()
            stack.append((coef * ccoef, child))
    return leaves
