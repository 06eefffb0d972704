"""Host check of a kernel geometry against the CUDA entries' own limits.

The port's counterpart of the reference's ``analysis/geometry.py::
validate_tiling``: the one place the tuner (``repro_torch.tune``) and the
on-disk tuning table (rule PL007) take a candidate's validity from.  A
(lanes, steps_per_chunk, window) candidate at size n is valid when what
``kernel_geometry`` resolves it to is a launch every entry accepts:

* every component a power of two, ``TB * C * num_blocks == 2^(n-1)``;
* ``2 <= Wu <= C`` and ``log2(Wu) < n`` (the sparse entries' guard,
  ``csrc/ryser_sparse.cu::bad_geometry``);
* ``TB <= kMaxThreads`` (256, ``csrc/ryser_common.cuh``), ``3 <= n <= 64``;
* the dynamic shared memory of the largest mode (the split-plane sparse
  kernel) within a CTA's opt-in, 227 KB on Hopper.

The auditor (``python -m repro_torch.analysis.geometry --check``) holds
the numbers the port's source produces against these limits and against
the campaign's bookkeeping, on the host, with no work on a card; each
audit returns its violations (an empty list passes):

* ``audit_kernel_geometry``: ``kernel_geometry`` over a spread of n and
  tilings (powers of two, the step space tiled, ``2 <= Wu <= C``);
* ``audit_smem_budget`` (the reference's VMEM audit): ``block_smem_bytes``
  of every mode against the 227 KB opt-in and, where a build's
  ``ptxas.log`` exists, each instantiation's registers against one CTA of
  the default lanes an SM and no spill at NPAD <= 48;
* ``audit_step_coverage``: ``chunk_geometry`` and ``plan_slices`` tile
  2^(n-1), and the waves of every width ``default_wave_width`` can return
  cover the slices once each;
* ``audit_sentinel_masking``: ``run_campaign`` replayed on the host with a
  synthetic wave body, a failed wave and a pause: every slice recorded
  once, with its own sum;
* ``audit_tuning_table`` (rule PT007, the reference's PL007): every entry
  of a table on disk re-validates through ``validate_tiling``;
* ``audit_routes``: the executor registry resolves every producer;
* ``audit_meta_shapes`` (the reference's ``eval_shape`` audit): the plain
  versions on ``device="meta"`` give each entry's partials shape and
  dtype.
"""

from __future__ import annotations

import argparse
import math
import re
import sys

from ..core.stepspace import kernel_geometry

__all__ = ["KMAX_THREADS", "MODES", "SMEM_PER_BLOCK", "block_smem_bytes",
           "validate_tiling", "audit_kernel_geometry", "audit_smem_budget",
           "audit_step_coverage", "audit_sentinel_masking",
           "audit_tuning_table", "audit_routes", "audit_meta_shapes",
           "run_audits", "main"]

KMAX_THREADS = 256               # csrc/ryser_common.cuh kMaxThreads
SMEM_PER_BLOCK = 227 * 1024      # Hopper's dynamic shared memory opt-in
N_MIN, N_MAX = 3, 64             # what the entries instantiate
MODES = ("dense", "complex", "sparse", "sparse_complex")
_PAD = 8


def _pow2(x: int) -> bool:
    return x >= 1 and (x & (x - 1)) == 0


def _pad(n: int) -> int:
    return max(_PAD, -(-n // _PAD) * _PAD)


def block_smem_bytes(n: int, TB: int, Wu: int,
                     mode: str = "sparse_complex") -> int:
    """Dynamic shared memory of one f64 CTA of ``mode`` as its entry counts
    it (an f32 CTA takes about half): ``dense`` in the batched or
    schedmat mode (``ryser_dense.cu::smem_bytes``), ``complex``
    (``ryser_complex.cu::smem_bytes``), ``sparse`` and ``sparse_complex``
    (``ryser_sparse.cu::smem_real`` / ``smem_cx``)."""
    n_pad, kw, itemsize = _pad(n), int(math.log2(Wu)), 8
    a, d = n_pad * n_pad, n_pad * (Wu - 1)
    if mode == "dense":
        return itemsize * (a + d + 2 * TB)
    if mode == "complex":
        return itemsize * (2 * a + 2 * d + 4 * TB)
    if mode == "sparse":
        return itemsize * (a + n_pad * kw + d + 2 * TB) + 4 * kw
    if mode == "sparse_complex":
        return itemsize * (2 * a + 2 * n_pad * kw + 2 * d + 4 * TB)
    raise ValueError(f"unknown mode {mode!r}; choose from {MODES}")


def validate_tiling(n: int, lanes: int, spc: int, window: int) -> list[str]:
    """Every limit one (lanes, steps_per_chunk, window) candidate must
    meet at matrix size n; an empty list means valid."""
    tag = f"n={n} tiling=({lanes},{spc},{window})"
    if not N_MIN <= n <= N_MAX:
        return [f"{tag}: n outside the kernels' [{N_MIN}, {N_MAX}]"]
    space = 1 << (n - 1)
    TB, C, Wu, nb = kernel_geometry(n, lanes=lanes, steps_per_chunk=spc,
                                    window=window)
    bad = []
    for name, v in (("lanes", lanes), ("steps_per_chunk", spc),
                    ("window", window), ("TB", TB), ("C", C), ("Wu", Wu),
                    ("num_blocks", nb)):
        if not _pow2(v):
            bad.append(f"{tag}: {name}={v} is not a power of two")
    if TB * C * nb != space:
        bad.append(f"{tag}: TB*C*num_blocks = {TB * C * nb} != 2^(n-1) = "
                   f"{space} -- grid does not tile the step space")
    if not 2 <= Wu <= C:
        bad.append(f"{tag}: window Wu={Wu} outside [2, C={C}]")
    if Wu >= 1 << n:
        bad.append(f"{tag}: log2(Wu) = {int(math.log2(Wu))} >= n, past the "
                   "sparse entries' guard")
    if TB > KMAX_THREADS:
        bad.append(f"{tag}: TB={TB} threads exceed the kernels' "
                   f"{KMAX_THREADS}")
    smem = max(block_smem_bytes(n, TB, Wu, m) for m in MODES)
    if smem > SMEM_PER_BLOCK:
        bad.append(f"{tag}: {smem} B of shared memory a CTA exceed the "
                   f"{SMEM_PER_BLOCK} B opt-in")
    return bad


# ---------------------------------------------------------------------------
# Audits
# ---------------------------------------------------------------------------

# small enough to stay fast, wide enough to cross every clamp of the
# geometry (tiny step spaces, TB = lanes, C = steps_per_chunk) and every
# NPAD up to the campaign sizes
N_SPREAD = (3, 4, 5, 6, 8, 10, 12, 14, 16, 20, 24, 30, 32, 40, 48, 64)
TILINGS = ((128, 64, 16), (32, 64, 8), (128, 256, 32), (256, 32, 32))
NO_SPILL_NPAD = 48                 # no instantiation up to here may spill
REGISTERS_PER_SM = 65536


def audit_kernel_geometry(ns=N_SPREAD, tilings=TILINGS) -> list[str]:
    """Every tiling of the spread, at every n, through ``validate_tiling``."""
    return [v for n in ns for t in tilings for v in validate_tiling(n, *t)]


def ptxas_registers(log: str) -> list[dict]:
    """(function, npad, registers, spill bytes) of each instantiation in a
    ``ptxas -v`` report."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            t = re.search(r"ryser_(?:cx_)?kernelILi(\d+)E", m.group(1))
            cur = {"function": m.group(1), "npad": int(t.group(1))} \
                if t else None
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill"] = sum(map(int, m.groups()))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            out.append(cur)
            cur = None
    return out


def audit_smem_budget(ns=N_SPREAD, tilings=TILINGS, log: str | None = None,
                      notes: list | None = None) -> list[str]:
    """Shared memory of every mode's CTA against the opt-in; with a
    ``ptxas.log`` (``log``, default: the current build's), registers and
    spills of every instantiation."""
    bad = []
    for n in ns:
        for lanes, spc, window in tilings:
            TB, C, Wu, _ = kernel_geometry(n, lanes=lanes,
                                           steps_per_chunk=spc, window=window)
            for mode in MODES:
                smem = block_smem_bytes(n, TB, Wu, mode)
                if smem > SMEM_PER_BLOCK:
                    bad.append(f"n={n} tiling={(lanes, spc, window)} {mode}:"
                               f" {smem} B of shared memory a CTA exceed the "
                               f"{SMEM_PER_BLOCK} B opt-in")
    if log is None:
        from ..kernels.build import ptxas_log
        log = ptxas_log()
    insts = ptxas_registers(log)
    if not insts:
        if notes is not None:
            notes.append("no ptxas.log of the current build: registers and "
                         "spills not checked (build the kernels on the card "
                         "first)")
        return bad
    lanes = TILINGS[0][0]
    for d in insts:
        if d["registers"] * lanes > REGISTERS_PER_SM:
            bad.append(f"{d['function']}: {d['registers']} registers x "
                       f"{lanes} threads exceed an SM's {REGISTERS_PER_SM}")
        if d["npad"] <= NO_SPILL_NPAD and d.get("spill", 0):
            bad.append(f"{d['function']} (NPAD {d['npad']}): spills "
                       f"{d['spill']} bytes")
    if notes is not None:
        notes.append(f"ptxas.log: {len(insts)} instantiations checked")
    return bad


# the fills a wave width is evened out from: an H100's 132 SMs times
# 1-16 resident CTAs over 1-16 CTAs a slice, and every small fill
_FILLS = sorted({max(1, -(-132 * r // s)) for r in range(1, 17)
                 for s in (1, 2, 4, 8, 16)} | set(range(1, 17)))


def audit_step_coverage(ns=N_SPREAD) -> list[str]:
    """``chunk_geometry`` and ``plan_slices`` tile 2^(n-1); the waves of
    every width ``default_wave_width`` returns cover each slice once."""
    from ..core.distributed import even_wave_width
    from ..core.stepspace import chunk_geometry, plan_slices
    bad = []
    for n in ns:
        space = 1 << (n - 1)
        for nc in (1, 16, 4096, space * 4):
            T, C, k = chunk_geometry(n, nc)
            if T * C != space or not (_pow2(C) and C >= 2 and C == 1 << k):
                bad.append(f"chunk_geometry(n={n}, {nc}) = {(T, C, k)} does "
                           f"not tile 2^(n-1) in power-of-two chunks >= 2")
        for slices, lanes in ((64, 1024), (1024, 1024), (16, 64)):
            ts, cps, C = plan_slices(n, slices, 1, lanes)
            tag = f"plan_slices(n={n}, {slices}, 1, {lanes})"
            if ts * cps * C != space or not (_pow2(C) and C >= 2):
                bad.append(f"{tag} = {(ts, cps, C)} does not tile 2^(n-1)")
                continue
            for fill in _FILLS:
                W = even_wave_width(ts, fill)
                waves = [list(range(ts))[i:i + W] for i in range(0, ts, W)]
                seen = [s for w in waves for s in w]
                if not 1 <= W <= fill or sorted(seen) != list(range(ts)) \
                        or len(waves) != -(-ts // fill):
                    bad.append(f"{tag}: fill {fill} gives waves of {W} "
                               f"({len(waves)} waves) that do not cover "
                               f"the {ts} slices once each in "
                               f"{-(-ts // fill)} waves")
    return bad


def audit_sentinel_masking(ns=(8, 12), widths=(None, 1, 2, 3, 5, 8)
                           ) -> list[str]:
    """Replay ``run_campaign`` on the host with a synthetic wave body
    (slice s sums to s + 1), one failed wave and a pause after two waves
    resumed from the state: every slice recorded exactly once, with its
    own sum, and nothing left pending."""
    import numpy as np

    from ..core import distributed as D
    from ..core.resume import JobState
    from ..core.stepspace import plan_slices
    bad = []
    real = D.slice_sums
    for n in ns:
        A = np.arange(n * n, dtype=np.float64).reshape(n, n) / n
        ts, cps, C = plan_slices(n, 16, 1, 64)
        for W in widths:
            tag = f"n={n} W={W}"
            records: dict[int, int] = {}
            calls = {"n": 0}

            class Recorded(JobState):
                def record_wave(self, slice_ids, his, los):
                    for s in slice_ids:
                        records[int(s)] = records.get(int(s), 0) + 1
                    super().record_wave(slice_ids, his, los)

            def body(A_, ids, **kw):
                calls["n"] += 1
                if calls["n"] == 2:
                    raise RuntimeError("a wave lost on the way")
                ids = [int(i) for i in ids]
                return (np.array([i + 1.0 for i in ids]), np.zeros(len(ids)),
                        1)

            base = JobState.create(A, ts, precision="dq_acc",
                                   backend="torch", chunks_per_slice=cps,
                                   chunk_size=C)
            state = Recorded(**base.__dict__)
            spec = dict(total_slices=ts, chunks_per_slice=cps, chunk_size=C,
                        backend="torch", device="cpu", wave_width=W)
            D.slice_sums = body
            try:
                value, state = D.run_campaign(A, state=state, max_waves=2,
                                              **spec)
                if value is not None and ts > 2 * (W or 1):
                    bad.append(f"{tag}: a two-wave budget did not pause")
                if value is None:
                    value, state = D.run_campaign(A, state=state, **spec)
            except Exception as e:   # noqa: BLE001 -- the audit's finding
                bad.append(f"{tag}: the replay raised {e!r}")
                continue
            finally:
                D.slice_sums = real
            twice = sorted(s for s, k in records.items() if k > 1)
            if twice:
                bad.append(f"{tag}: slice(s) {twice} recorded twice")
            if sorted(records) != list(range(ts)) or not state.done.all():
                bad.append(f"{tag}: {len(records)} of {ts} slices recorded")
            if not np.array_equal(state.hi, np.arange(ts) + 1.0):
                bad.append(f"{tag}: recorded sums are not the slices' own")
    return bad


def audit_tuning_table(path: str | None = None) -> list[str]:
    """PT007: every entry of the tuning table at ``path`` re-validates
    through ``validate_tiling`` (``TuningTable.load`` raises at the first
    bad entry; this lists them all).  No path: nothing to check."""
    import json

    from ..tune.table import TableEntry
    if path is None:
        return []
    try:
        with open(path) as f:
            doc = json.load(f)
        entries = [TableEntry.from_dict(d) for d in doc.get("entries", ())]
    except (OSError, ValueError, KeyError) as e:
        return [f"tuning table {path}: unreadable: {e}"]
    if not str(doc.get("format")).startswith("repro_torch.tune.table/"):
        return [f"tuning table {path}: format {doc.get('format')!r} is not "
                f"the port's"]
    return [f"tuning table {path} [{e.key()}]: {v}" for e in entries
            for v in validate_tiling(e.n, e.geometry.lanes,
                                     e.geometry.steps_per_chunk,
                                     e.geometry.window)]


def audit_routes(ns=N_SPREAD) -> list[str]:
    """Every registered backend resolves ``value_backend`` to a registered
    producer for both routes, scalar and batched, across the n spread."""
    from ..core.executor import available_backends, get_backend
    from ..core.planner import ROUTE_DENSE, ROUTE_SPARSE
    names = available_backends()
    bad = []
    missing = {"torch", "cuda", "campaign"} - set(names)
    if missing:
        bad.append(f"backend registry lost {sorted(missing)} (registered: "
                   f"{sorted(names)})")
    for name in names:
        backend = get_backend(name)
        for route in (ROUTE_DENSE, ROUTE_SPARSE):
            for n in ns:
                for batched in (False, True):
                    prod = backend.value_backend(route, n, batched=batched)
                    if prod not in names:
                        bad.append(f"{name}.value_backend({route}, n={n}, "
                                   f"batched={batched}) -> {prod!r} is not "
                                   f"registered")
    return bad


def audit_meta_shapes(ns=(6, 10, 12), batch: int = 3) -> list[str]:
    """The four plain versions (the real one in every mode) on meta
    tensors, f64 and f32: (B, num_blocks, 2) real and (B, num_blocks, 4)
    split-plane partials in the input's dtype."""
    import torch

    from ..core.stepspace import DEFAULT_GEOMETRY
    from ..kernels import ryser_complex_cuda as RX
    from ..kernels import ryser_cuda as RC
    from ..kernels import ryser_sparse_cuda as RS
    bad = []
    deg = 3
    for n in ns:
        TB, C, Wu, nb = DEFAULT_GEOMETRY.kernel_geometry(n)
        p = _pad(n)
        geo = dict(n=n, TB=TB, C=C, Wu=Wu, num_blocks=nb)
        for dt in (torch.float64, torch.float32):
            def m(*shape, dtype=dt):
                return torch.empty(shape, dtype=dtype, device="meta")
            A, xb = m(batch, p, p), m(batch, p, 1)
            rows, vals = m(batch, n, deg, dtype=torch.int32), m(batch, n, deg)
            calls = {f"dense {mode}": (
                lambda mode=mode: RC.block_partials_plain(A, xb, 0, mode=mode,
                                                          **geo), 2)
                for mode in ("baseline", "batched", "schedmat")}
            calls["complex"] = (lambda: RX.block_partials_plain_complex(
                A, A, xb, xb, 0, **geo), 4)
            calls["sparse"] = (lambda: RS.block_partials_plain_sparse(
                A, rows, vals, xb, 0, **geo), 2)
            calls["sparse complex"] = (
                lambda: RS.block_partials_plain_sparse_complex(
                    A, A, rows, vals, vals, xb, xb, 0, **geo), 4)
            for what, (fn, width) in calls.items():
                tag = f"n={n} {what} {str(dt).replace('torch.', '')}"
                try:
                    out = fn()
                except Exception as e:  # noqa: BLE001 -- the audit's finding
                    bad.append(f"{tag}: raised on meta tensors: {e!r}")
                    continue
                if tuple(out.shape) != (batch, nb, width) or out.dtype != dt:
                    bad.append(f"{tag}: partials {tuple(out.shape)} "
                               f"{out.dtype}, want {(batch, nb, width)} {dt}")
    return bad


AUDITS = (("kernel-geometry", audit_kernel_geometry),
          ("smem-budget", audit_smem_budget),
          ("step-coverage", audit_step_coverage),
          ("sentinel-masking", audit_sentinel_masking),
          ("tuning-table", audit_tuning_table),
          ("routes", audit_routes),
          ("meta-shapes", audit_meta_shapes))


def run_audits(table: str | None = None) -> tuple[dict, list[str]]:
    """({audit: violations}, notes) of every audit."""
    notes: list[str] = []
    results = {}
    for name, fn in AUDITS:
        if name == "smem-budget":
            results[name] = fn(notes=notes)
        elif name == "tuning-table":
            results[name] = fn(table)
            if table is None:
                notes.append("no tuning table named (--table): PT007 had "
                             "nothing to check")
        else:
            results[name] = fn()
    return results, notes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.geometry",
        description="the port's geometry auditor (no work on a card)")
    ap.add_argument("--check", action="store_true",
                    help="run every audit; exit 1 on any violation")
    ap.add_argument("--table", default=None, metavar="PATH",
                    help="a tuning table to re-validate (PT007)")
    args = ap.parse_args(argv)
    if not args.check:
        ap.print_help()
        return 2
    results, notes = run_audits(args.table)
    failures = 0
    for name, violations in results.items():
        status = f"{len(violations)} violation(s)" if violations else "ok"
        print(f"geometry: {name}: {status}")
        for v in violations:
            print(f"  {v}", file=sys.stderr)
        failures += len(violations)
    for note in notes:
        print(f"note: {note}")
    print(f"geometry: {failures} violation(s) total")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
