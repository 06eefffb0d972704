"""On-disk tuning table: persisted kernel-geometry winners.

The port's counterpart of the reference's ``tune/table.py``, with its
semantics: the table is the contract between the tuner
(``repro_torch.tune.search``, run once per card) and the planner
(``core/planner.py``, which reads it on every ``build_plan`` when
``SolverConfig.tuning_table`` is set).  An entry is addressed by
``(route, n, density_bucket, dtype, precision, device_kind)``; the whole
file is versioned, carries the port's own format string (a table of the
reference package is refused) and is keyed by a hash of the kernels:
the ``.py`` glue under ``kernels/``, the CUDA sources and the nvcc flags
(``kernels/build.py``'s source hash, so a table and the compiled library
go stale together).  Any of these out of date raises ``ValueError`` at
load, because a geometry tuned for one kernel body may be invalid, slow
or numerically different for another.

Every entry re-validates against ``analysis/geometry.py::validate_tiling``
at load time (rule PL007): a hand-edited table cannot smuggle a geometry
the CUDA entries refuse into the planner.  ``host_device_kind`` reads
``torch.cuda.get_device_name`` and only when a table is consulted.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from dataclasses import dataclass
from functools import lru_cache

from ..core.stepspace import Geometry

__all__ = ["TABLE_FORMAT", "TABLE_FORMAT_VERSION", "ANY_DEVICE",
           "TableEntry", "TuningTable", "density_bucket", "host_device_kind",
           "kernel_sources_hash", "resolve_geometry", "table_key"]

TABLE_FORMAT_VERSION = 1
TABLE_FORMAT = "repro_torch.tune.table/v%d" % TABLE_FORMAT_VERSION

# Any-device wildcard: ``resolve`` falls back to it after the concrete
# device kind.
ANY_DEVICE = "any"


def kernel_sources_hash() -> str:
    """Content hash of the kernels: every ``.py`` file of
    ``repro_torch/kernels/`` and ``build.py``'s hash of the CUDA sources
    and nvcc flags."""
    from ..kernels import build
    h = hashlib.sha1()
    for fname in sorted(os.listdir(build.CSRC.parent)):
        if fname.endswith(".py"):
            h.update(fname.encode())
            h.update((build.CSRC.parent / fname).read_bytes())
    h.update(build._source_hash().encode())
    return h.hexdigest()[:16]


# Density is quantized so nearby sparsities share one tuned geometry
# (and one table entry): quarter buckets, upper-edge labeled.
_DENSITY_EDGES = (0.25, 0.50, 0.75, 1.00)


def density_bucket(density: float) -> str:
    for edge in _DENSITY_EDGES:
        if density <= edge + 1e-12:
            return f"{edge:.2f}"
    return f"{_DENSITY_EDGES[-1]:.2f}"


def table_key(route: str, n: int, density_b: str, dtype: str,
              precision: str, device_kind: str) -> str:
    return f"{route}/n{n}/d{density_b}/{dtype}/{precision}/{device_kind}"


@lru_cache(maxsize=8)
def _device_kind(device: str) -> str:
    from ..core.ryser import resolve_device
    dev = resolve_device(None if device == "" else device)
    if dev.type == "cpu":
        return "cpu"
    import torch
    return torch.cuda.get_device_name(dev).strip().lower()


def host_device_kind(device=None) -> str:
    """Normalised ``torch.cuda.get_device_name`` of ``device`` (``None``:
    the card), or ``"cpu"`` when the caller asks for the CPU.  With no
    card and no ``device="cpu"`` it raises, as every entry does."""
    return _device_kind("" if device is None else str(device))


@dataclass(frozen=True)
class TableEntry:
    route: str
    n: int
    density_bucket: str
    dtype: str                 # numpy dtype.str of the leaf, e.g. "<f8"
    precision: str
    device_kind: str
    geometry: Geometry         # the winner (requested knobs, not clamped)
    predicted_s: float         # cost-model time for the winner
    measured_s: float          # median-of-repeats measured time
    default_s: float           # measured time of DEFAULT_GEOMETRY

    @property
    def mispredict_ratio(self) -> float:
        """Cost model predicted / measured (1.0 = perfect model)."""
        return self.predicted_s / self.measured_s if self.measured_s else 0.0

    @property
    def speedup(self) -> float:
        """Untuned-default time / tuned time (>= 1.0 by construction:
        the default is always in the measured candidate set)."""
        return self.default_s / self.measured_s if self.measured_s else 0.0

    def key(self) -> str:
        return table_key(self.route, self.n, self.density_bucket,
                         self.dtype, self.precision, self.device_kind)

    def to_dict(self) -> dict:
        return {"route": self.route, "n": self.n,
                "density_bucket": self.density_bucket, "dtype": self.dtype,
                "precision": self.precision,
                "device_kind": self.device_kind,
                "geometry": self.geometry.tag(),
                "predicted_s": self.predicted_s,
                "measured_s": self.measured_s,
                "default_s": self.default_s}

    @staticmethod
    def from_dict(d: dict) -> "TableEntry":
        return TableEntry(route=d["route"], n=int(d["n"]),
                          density_bucket=d["density_bucket"],
                          dtype=d["dtype"], precision=d["precision"],
                          device_kind=d["device_kind"],
                          geometry=Geometry.from_tag(d["geometry"]),
                          predicted_s=float(d["predicted_s"]),
                          measured_s=float(d["measured_s"]),
                          default_s=float(d["default_s"]))


class TuningTable:
    """In-memory view of the persisted table; ``entries`` keyed by
    :func:`table_key`."""

    def __init__(self, entries: dict[str, TableEntry] | None = None,
                 kernels_hash: str | None = None):
        self.entries: dict[str, TableEntry] = dict(entries or {})
        self.kernels_hash = kernels_hash or kernel_sources_hash()

    def put(self, entry: TableEntry) -> None:
        self.entries[entry.key()] = entry

    def get(self, route: str, n: int, density: float, dtype: str,
            precision: str,
            device_kind: str | None = None) -> TableEntry | None:
        """Entry for the key, preferring the concrete device kind (default:
        the card's) and falling back to the ``any`` wildcard."""
        bucket = density_bucket(density)
        kinds = [device_kind or host_device_kind()]
        if ANY_DEVICE not in kinds:
            kinds.append(ANY_DEVICE)
        for kind in kinds:
            e = self.entries.get(
                table_key(route, n, bucket, dtype, precision, kind))
            if e is not None:
                return e
        return None

    def resolve(self, route: str, n: int, density: float, dtype: str,
                precision: str,
                device_kind: str | None = None) -> Geometry | None:
        e = self.get(route, n, density, dtype, precision, device_kind)
        return e.geometry if e is not None else None

    def validate(self) -> list[str]:
        """PL007: every entry re-validated against the CUDA entries'
        limits (``analysis/geometry.py::validate_tiling``)."""
        from ..analysis.geometry import validate_tiling
        bad = []
        for key, e in self.entries.items():
            g = e.geometry
            for v in validate_tiling(e.n, g.lanes, g.steps_per_chunk,
                                     g.window):
                bad.append(f"[{key}] {v}")
        return bad

    def save(self, path: str) -> None:
        doc = {"format": TABLE_FORMAT,
               "version": TABLE_FORMAT_VERSION,
               "kernels_hash": self.kernels_hash,
               "entries": [e.to_dict() for _, e in
                           sorted(self.entries.items())]}
        d = os.path.dirname(os.path.abspath(path)) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
            os.replace(tmp, path)   # atomic like core/resume.py
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    @classmethod
    def load(cls, path: str, *, strict_hash: bool = True) -> "TuningTable":
        """Load + loudly invalidate: another format (the reference
        package's tables), version skew, kernel-source drift and
        geometry-limit violations (PL007) all raise ValueError."""
        with open(path) as f:
            doc = json.load(f)
        fmt = doc.get("format")
        if not str(fmt).startswith("repro_torch.tune.table/"):
            raise ValueError(
                f"tuning table {path}: format {fmt!r} is not the port's "
                f"({TABLE_FORMAT}) -- a table of the reference package "
                "tunes other kernels; re-run python -m "
                "repro_torch.launch.tune")
        ver = doc.get("version")
        if ver != TABLE_FORMAT_VERSION:
            raise ValueError(
                f"tuning table {path}: format version {ver!r} != "
                f"{TABLE_FORMAT_VERSION} -- re-run the tuner "
                "(python -m repro_torch.launch.tune)")
        have = doc.get("kernels_hash")
        want = kernel_sources_hash()
        if strict_hash and have != want:
            raise ValueError(
                f"tuning table {path}: kernel sources changed since "
                f"tuning (table hash {have!r}, current {want!r}) -- "
                "geometry winners are stale; re-run the tuner")
        entries = {}
        for d in doc.get("entries", ()):
            e = TableEntry.from_dict(d)
            entries[e.key()] = e
        table = cls(entries, kernels_hash=have)
        bad = table.validate()
        if bad:
            raise ValueError(
                f"tuning table {path}: {len(bad)} entr(ies) violate the "
                "geometry limits (PL007): " + "; ".join(bad[:3]))
        return table


@lru_cache(maxsize=8)
def _load_cached(path: str, mtime_ns: int) -> TuningTable:
    return TuningTable.load(path)


def resolve_geometry(path: str, route: str, n: int, density: float,
                     dtype: str, precision: str,
                     device_kind: str | None = None) -> Geometry | None:
    """Planner entry point: table hit or None, mtime-cached per file.

    A missing file is a hard error (a configured-but-absent table is a
    deployment bug, not a tuning preference); a stale or invalid table
    raises from :meth:`TuningTable.load`.
    """
    st = os.stat(path)
    table = _load_cached(os.path.abspath(path), st.st_mtime_ns)
    return table.resolve(route, n, density, dtype, precision, device_kind)
