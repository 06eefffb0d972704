"""Carry a reference ``SolverConfig`` or ``SparseMatrix`` across to the
port.

The reference package's state travels as plain data -- its
``dataclasses.asdict`` (numpy fields) and ``Geometry.tag()`` strings -- so
the port never imports the reference.  Backend names map ``jnp -> torch``
and ``pallas -> cuda``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .core.planner import SolverConfig
from .core.sparyser import SparseMatrix
from .core.stepspace import Geometry

__all__ = ["BACKEND_NAMES", "config_from_reference", "geometry_from_tag",
           "sparse_from_reference"]

BACKEND_NAMES = {"jnp": "torch", "pallas": "cuda"}


def geometry_from_tag(tag: str | None) -> Geometry | None:
    """``"128x64x16"`` / ``"8x8x4b2"`` -> Geometry; None passes through."""
    return None if tag is None else Geometry.from_tag(tag)


def config_from_reference(d: dict) -> SolverConfig:
    """The port's SolverConfig for a reference config given as
    ``dataclasses.asdict(cfg)``.

    ``geometry`` may arrive as the asdict form (a dict of Geometry's
    fields), a tag string or None.  A backend without a port yet
    (``distributed*``) raises ``ValueError``.  The campaign knobs cross as
    they are; a checkpoint the reference wrote names its own backend, so
    the port refuses to resume it (``core.resume``).
    """
    d = dict(d)
    backend = d.get("backend", "jnp")
    if backend not in BACKEND_NAMES:
        raise ValueError(f"backend {backend!r} has no port yet "
                         f"(ported: {sorted(BACKEND_NAMES)})")
    d["backend"] = BACKEND_NAMES[backend]
    g = d.get("geometry")
    if isinstance(g, dict):
        g = Geometry(**g)
    elif isinstance(g, str):
        g = geometry_from_tag(g)
    d["geometry"] = g
    fields = {f.name for f in dataclasses.fields(SolverConfig)}
    unknown = set(d) - fields
    if unknown:
        raise ValueError(f"reference fields without a port: {sorted(unknown)}")
    return SolverConfig(**d)


def sparse_from_reference(d: dict) -> SparseMatrix:
    """The port's SparseMatrix for a reference one given as
    ``dataclasses.asdict(sp)``: the same CRS + CCS arrays, copied."""
    fields = {f.name for f in dataclasses.fields(SparseMatrix)}
    if set(d) != fields:
        raise ValueError(f"SparseMatrix fields {sorted(d)} != "
                         f"{sorted(fields)}")
    return SparseMatrix(n=int(d["n"]), **{
        k: np.array(v) for k, v in d.items() if k != "n"})
