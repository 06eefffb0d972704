"""The PT1xx contracts: the determinism and precision contracts checked on
what an entry executed, op by op, rather than on its source.

``prove.py`` runs each entry under :class:`OpRecorder`, a
``TorchDispatchMode`` that records every aten op with its argument
shapes and dtypes (the kernels' C entries are no aten ops: on the card
the recorder sees their host glue), and hands the records here:

PT101  no floating-point reduction (sum, prod, mm, bmm, addmm, dot,
       cumsum, mean) whose reduced extent tracks the batch extent B: the
       counterpart of the reference's PLI101, found by running each batch
       entry at two coprime extents.
PT102  no narrowing cast (``_to_copy`` or ``copy_`` from f64 to f32, from
       c128 to c64, or from complex to real) on an f64 or c128 entry: the
       counterpart of PLI102.
PT103  batch-extent invariance: the op traces at the two extents are equal
       up to integer extents that scale with B, member i of the one stack
       equals member i of the other bit for bit, and an entry run twice
       gives the same bits: the counterpart of PLI103, with the values
       themselves held as well as the program.
PT104  the collective audit of the mesh functions, the counterpart of
       PLI104: :class:`CollectiveRecorder` records every
       ``torch.distributed`` collective a mesh entry called; a value path
       may use only ``all_gather``, ``broadcast_object_list`` and
       ``barrier`` (never ``all_reduce`` or ``reduce``, whose order over
       the ranks is the library's), each within the entry's budget: one
       digest gather and one partials gather a call, or a wave.

Import-light: ``OpRecorder`` imports torch only when it is built.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

from .rules import Finding

__all__ = ["PT_RULES", "OpRecord", "OpRecorder", "pt101_reductions",
           "pt102_dtype_flow", "pt103_batch_invariance", "pt103_bits",
           "lines_batch_variant", "CollectiveRecorder", "COLLECTIVES",
           "SANCTIONED_COLLECTIVES", "pt104_collectives"]

PT_RULES = {
    "PT101": "no floating-point reduction over an axis whose extent tracks "
             "the batch extent",
    "PT102": "no narrowing cast (f64->f32, c128->c64, complex->real) on an "
             "f64 or c128 entry",
    "PT103": "batch-extent invariance of the op trace and of the values, "
             "and the same bits from a second run",
    "PT104": "a mesh function's collectives: all_gather / "
             "broadcast_object_list / barrier only, within its budget",
}

# every collective of torch.distributed a recorder watches
COLLECTIVES = ("all_reduce", "reduce", "all_gather", "all_gather_into_tensor",
               "all_gather_object", "broadcast", "broadcast_object_list",
               "barrier", "reduce_scatter", "reduce_scatter_tensor",
               "all_to_all", "all_to_all_single", "gather", "scatter",
               "gather_object", "scatter_object_list", "send", "recv",
               "isend", "irecv")
# the ones a value path may call: each rank gets every rank's data and
# reduces it itself, in an order the code fixes
SANCTIONED_COLLECTIVES = ("all_gather", "broadcast_object_list", "barrier")

_SHORT = {"float16": "f16", "bfloat16": "bf16", "float32": "f32",
          "float64": "f64", "complex64": "c64", "complex128": "c128",
          "int8": "i8", "int16": "i16", "int32": "i32", "int64": "i64",
          "uint8": "u8", "bool": "pred"}
_WIDTH = {"f16": 16, "bf16": 16, "f32": 32, "f64": 64, "c64": 64, "c128": 128}
_REDUCERS = ("sum", "prod", "mm", "bmm", "addmm", "baddbmm", "dot", "cumsum",
             "mean")


def short_dtype(dtype) -> str:
    name = str(dtype).replace("torch.", "")
    return _SHORT.get(name, name)


def _floatish(short: str) -> bool:
    return short in _WIDTH


@dataclass(frozen=True)
class OpRecord:
    """One aten op an entry executed."""
    index: int
    op: str                          # e.g. 'sum.dim_IntList'
    line: str                        # canonical text: op, arguments, result
    dtype: str = ""                  # the first tensor argument's dtype
    reduced: tuple[int, ...] = ()    # extents a reduction contracts
    cast: tuple[str, str] | None = None   # (from, to) of a copy or cast


def _render(v) -> str:
    import torch
    if isinstance(v, torch.Tensor):
        return f"{short_dtype(v.dtype)}[{','.join(map(str, v.shape))}]"
    if isinstance(v, (list, tuple)):
        return "(" + ",".join(_render(x) for x in v) + ")"
    if isinstance(v, torch.dtype):
        return short_dtype(v)
    if isinstance(v, (torch.device, torch.layout, torch.memory_format)):
        return "_"                   # where an op runs is no part of it
    if isinstance(v, float):
        return repr(v)
    if isinstance(v, (bool, int, str, complex)) or v is None:
        return repr(v)
    return type(v).__name__


def _reduced(op: str, args, kwargs) -> tuple[int, ...]:
    """Extents an op contracts (its first argument's), or ()."""
    base = op.split(".")[0]
    if base not in _REDUCERS:
        return ()
    x = args[0]
    shape = tuple(x.shape)
    if base in ("sum", "prod", "mean", "cumsum"):
        dims = args[1] if len(args) > 1 else kwargs.get("dim")
        if dims is None or dims == []:
            return shape
        dims = [dims] if isinstance(dims, int) else list(dims)
        return tuple(shape[d] for d in dims)
    if base == "addmm":
        return (args[1].shape[1],)
    if base == "baddbmm":
        return (args[1].shape[2],)
    if base == "mm":
        return (shape[1],)
    if base == "bmm":
        return (shape[2],)
    return (shape[0],)               # dot


class OpRecorder:
    """A context manager recording every aten op run inside it."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        records: list[OpRecord] = []
        self.records = records

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                records.append(_record(len(records), func, args, kwargs,
                                       out))
                return out

        self._mode = _Mode()

    def __enter__(self) -> "OpRecorder":
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)


def _record(index: int, func, args, kwargs, out) -> OpRecord:
    import torch
    op = f"{func._schema.name.split('::')[-1]}.{func._overloadname}"
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    dtype = short_dtype(tensors[0].dtype) if tensors else ""
    kw = ",".join(f"{k}={_render(v)}" for k, v in sorted(kwargs.items()))
    line = f"{op}({','.join(_render(a) for a in args)}" \
           f"{';' + kw if kw else ''}) -> {_render(out)}"
    reduced = _reduced(op, args, kwargs) if _floatish(dtype) else ()
    cast = None
    base = op.split(".")[0]
    if base == "_to_copy" and "dtype" in kwargs and tensors:
        cast = (dtype, short_dtype(kwargs["dtype"]))
    elif base in ("copy_", "copy") and len(tensors) >= 2:
        cast = (short_dtype(tensors[1].dtype), dtype)
    return OpRecord(index, op, line, dtype, reduced, cast)


def pt101_reductions(entry: str, precision: str, recs_a: list[OpRecord],
                     recs_b: list[OpRecord], b_a: int,
                     b_b: int) -> list[Finding]:
    """Floating-point reductions whose contracted extent scales with B."""
    out = []
    if len(recs_a) != len(recs_b):
        return out                   # PT103 reports the divergence
    for ra, rb in zip(recs_a, recs_b):
        for ea, eb in zip(ra.reduced, rb.reduced):
            if ea != eb and _proportional(ea, eb, b_a, b_b):
                out.append(Finding(
                    "PT101", entry, ra.index, 0,
                    f"precision={precision}: {ra.op} ({ra.dtype}) contracts "
                    f"an axis of extent {ea} at B={b_a} and {eb} at B={b_b}: "
                    f"its association would depend on the batch"))
                break
    return out


def pt102_dtype_flow(entry: str, precision: str,
                     recs: list[OpRecord]) -> list[Finding]:
    """Narrowing casts between floating-point dtypes."""
    out = []
    for r in recs:
        if r.cast is None:
            continue
        src, dst = r.cast
        if _floatish(src) and _floatish(dst) and (
                _WIDTH[dst] < _WIDTH[src]
                or src.startswith("c") and not dst.startswith("c")):
            out.append(Finding(
                "PT102", entry, r.index, 0,
                f"precision={precision}: {r.op} narrows {src} -> {dst}"))
    return out


_INT_TOKEN = re.compile(r"(?<![\w.])(\d+)(?![\w.])")


def _proportional(a: int, b: int, b_a: int, b_b: int) -> bool:
    return a % b_a == 0 and b == a // b_a * b_b


def lines_batch_variant(line_a: str, line_b: str, b_a: int, b_b: int) -> bool:
    """True when the two lines differ only by integers that scale with B."""
    ta, tb = _INT_TOKEN.split(line_a), _INT_TOKEN.split(line_b)
    if len(ta) != len(tb):
        return False
    for i, (x, y) in enumerate(zip(ta, tb)):
        if x == y:
            continue
        if i % 2 == 0 or not _proportional(int(x), int(y), b_a, b_b):
            return False
    return True


def pt103_batch_invariance(entry: str, precision: str,
                           recs_a: list[OpRecord], recs_b: list[OpRecord],
                           b_a: int, b_b: int,
                           max_report: int = 3) -> list[Finding]:
    """The op traces at two batch extents, line by line."""
    if len(recs_a) != len(recs_b):
        i = next((i for i, (ra, rb) in enumerate(zip(recs_a, recs_b))
                  if not lines_batch_variant(ra.line, rb.line, b_a, b_b)),
                 min(len(recs_a), len(recs_b)))
        at = [r[i].line if i < len(r) else "-" for r in (recs_a, recs_b)]
        return [Finding("PT103", entry, i, 0,
                        f"precision={precision}: {len(recs_a)} ops at "
                        f"B={b_a} but {len(recs_b)} at B={b_b}: the program "
                        f"depends on the batch extent; first divergence at "
                        f"op {i}:\n    B={b_a}: {at[0]}\n    B={b_b}: "
                        f"{at[1]}")]
    out = []
    for ra, rb in zip(recs_a, recs_b):
        if ra.line == rb.line or lines_batch_variant(ra.line, rb.line, b_a,
                                                     b_b):
            continue
        out.append(Finding(
            "PT103", entry, ra.index, 0,
            f"precision={precision}: op {ra.index} differs beyond extents "
            f"that scale with B:\n    B={b_a}: {ra.line}\n    B={b_b}: "
            f"{rb.line}"))
        if len(out) >= max_report:
            break
    return out


def pt103_bits(entry: str, precision: str, what: str, got: list[str],
               want: list[str]) -> list[Finding]:
    """A finding when two runs' values (bit patterns as text), which must
    agree bit for bit, do not."""
    if got == want:
        return []
    bad = [i for i, (x, y) in enumerate(zip(got, want)) if x != y]
    first = bad[0] if bad else min(len(got), len(want))
    a = got[first] if first < len(got) else "-"
    b = want[first] if first < len(want) else "-"
    return [Finding("PT103", entry, first, 0,
                    f"precision={precision}: {what}: value {first} is {a} "
                    f"against {b} ({len(bad)} of {len(got)} differ)")]


class CollectiveRecorder:
    """A context manager that records every ``torch.distributed``
    collective called inside it (``COLLECTIVES``, looked up on the module
    at call time, as the port calls them) as ``(name, detail)`` and then
    calls it."""

    def __init__(self):
        self.calls: list[tuple[str, str]] = []
        self._saved: dict = {}

    def __enter__(self) -> "CollectiveRecorder":
        import torch.distributed as dist
        for name in COLLECTIVES:
            real = getattr(dist, name, None)
            if real is None:
                continue
            self._saved[name] = real

            def wrapped(*args, _name=name, _real=real, **kwargs):
                self.calls.append((_name, _render(args)))
                return _real(*args, **kwargs)
            setattr(dist, name, wrapped)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        for name, real in self._saved.items():
            setattr(dist, name, real)
        self._saved.clear()
        return False


def pt104_collectives(entry: str, calls: list[tuple[str, str]],
                      budget: dict[str, int]) -> list[Finding]:
    """Findings for collectives outside ``SANCTIONED_COLLECTIVES`` and for
    counts past ``budget`` (kind -> the most allowed; a sanctioned kind
    absent from it is allowed none)."""
    counts: dict[str, int] = {}
    for name, _ in calls:
        counts[name] = counts.get(name, 0) + 1
    out = []
    for name, k in sorted(counts.items()):
        if name not in SANCTIONED_COLLECTIVES:
            out.append(Finding(
                "PT104", entry, 0, 0,
                f"{name} x{k} on a value path: its order over the ranks is "
                f"the library's, so the value would depend on the world; "
                f"gather and reduce in a fixed order"))
        elif k > budget.get(name, 0):
            out.append(Finding(
                "PT104", entry, 0, 0,
                f"{name} x{k} past its budget of {budget.get(name, 0)}: one "
                f"digest gather and one partials gather a call or a wave"))
    return out
