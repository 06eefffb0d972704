"""Content-hash result cache for permanent leaves (a copy of the
reference package's ``core/cache.py``).

Permanents are pure functions of the matrix, and boson-sampling pipelines
resample overlapping submatrices -- after DM/FM preprocessing the same
leaf shows up over and over.  :class:`ResultCache` memoizes leaf results
keyed on (content hash, route, precision, backend, num_chunks), so a
repeated leaf skips the device entirely.

The cache is a bounded LRU (``OrderedDict`` move-to-end on hit) with
hit/miss accounting surfaced through :meth:`stats`; ``PermanentSolver``
owns one instance per session and the executor consults it per leaf.
"""

from __future__ import annotations

from collections import OrderedDict

__all__ = ["ResultCache"]


class ResultCache:
    """Bounded LRU mapping leaf cache keys to Python scalar results."""

    def __init__(self, max_entries: int = 4096):
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self.max_entries = max_entries
        self._data: OrderedDict[tuple, complex | float] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @staticmethod
    def key(leaf_key: str, route: str, precision: str, backend: str,
            num_chunks: int, dtype: str = "<f8",
            geometry: str = "-") -> tuple:
        """Full cache key: content hash + every numerics-affecting knob.

        Precision mode, backend and chunk geometry all perturb the
        floating-point result at the ulp level, so they are part of the
        identity -- a ``dd`` result must never satisfy a ``qq`` lookup.
        ``dtype`` (the leaf's numpy dtype string) is carried explicitly as
        well: the content hash already mixes it in, but the key must stay
        collision-free even if a future leaf hash drops the dtype -- a
        float64 leaf and a complex128 leaf whose imaginary part is all
        zeros are different computations (real engine vs split-plane
        engine) and must never share an entry.  ``precision`` is the
        plan's *effective* precision, so a complex ``qq`` plan stores and
        finds its values under ``kahan``.  ``geometry`` is the resolved
        CUDA kernel geometry tag (``Geometry.tag()``) when a kernel
        produced the value -- geometry changes the fixed-order reduction
        shape, so two geometries must never share an entry -- and the
        ``"-"`` sentinel for geometry-free producers (the torch engine).
        """
        return (leaf_key, route, precision, backend, num_chunks, dtype,
                geometry)

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key: tuple) -> bool:
        return key in self._data

    def get(self, key: tuple):
        """Return the cached scalar or None (and count the hit/miss)."""
        try:
            val = self._data[key]
        except KeyError:
            self.misses += 1
            return None
        self._data.move_to_end(key)
        self.hits += 1
        return val

    def put(self, key: tuple, value) -> None:
        self._data[key] = value
        self._data.move_to_end(key)
        while len(self._data) > self.max_entries:
            self._data.popitem(last=False)
            self.evictions += 1

    def clear(self) -> None:
        self._data.clear()

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {"entries": len(self._data), "hits": self.hits,
                "misses": self.misses, "evictions": self.evictions,
                "hit_rate": self.hits / total if total else 0.0}
