"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--time-only | --serve-only | --tune-only |
                           --examples-only | --prove-only | --mesh-only]

Run from the repository root on a machine with a CUDA card and nvcc.  It
builds the kernels from ``src/repro_torch/kernels/csrc`` (the dense real
kernel, the split-plane complex one and the padded-CCS sparse pair), holds
every kernel against its plain PyTorch version on the card (block windows,
and the full grids of the main path's shapes), drives the main path for
real and for complex input, dense (``repro_torch.permanent`` at n = 30,
``permanent_batch`` buckets at n = 22 and n = 24) and sparse (n = 32 and
buckets of n = 22 and n = 24 below density 0.30), with the launch counters
reset just before and read just after each path, checks the values
(closed forms at full width, Fibonacci on the sparse route, the dense
kernel and the torch engine against the sparse route, a scalar leaf
against the same leaf in a bucket), splits each call's host time into
planning and execution, and times each kernel beside its bound.  Phase
``entry_parity`` holds kernel #1's schedmat mode and the f32 entries of
#1-#8 (f32 and complex64 input) against their plain versions and drives
them through ``ops.permanent_cuda(_batched)`` and
``ops.permanent_cuda_sparse(_batched)``; phase ``campaign`` runs the
step-space campaigns; phase ``tune`` runs the tune CLI at the main path's
sizes and its table through the planner and the service; phase ``serve``
drives the always-on service
(``repro_torch.serve``): warm-up, an open-loop soak of one mixed stream
(dense real, dense complex, sparse), a soak of ``run_soak`` on random
masks at density 0.2, ``fill_first``, an interleaved campaign and four
cold processes (three of its CLI; ``--cold-band ROOT`` is the fourth's
own entry).  ``--serve-only`` runs the build and phase ``serve`` alone,
``--tune-only`` the build and phase ``tune``.  Phase ``examples`` runs
each of ``repro_torch.examples`` at its card sizes with its own checks
and adds its launches to the kernels line; phase ``prove`` runs
torchprove on the card (every entry against the CPU value goldens, bit
for bit) and the 256 / 251 batch-extent check at n = 24;
``--examples-only`` and ``--prove-only`` run the build and that phase.
Phase ``mesh`` runs the multi-device slice (``launch/mesh.py``, the mesh
functions of ``core/distributed.py``) as worlds of 1, 2 and 4 ranks that
all share the one card (``ranks_per_device`` = the world), spawned with
a ``file://`` store after this process built the kernels: the step
split of dense n = 30 and complex n = 28, the four 256 x 24 buckets and
a ragged 251 x 24, the scalar sparse leaves and the all-ones n = 40
campaign (its wall seconds at each world; the ranks time-slice the card,
so no scaling is expected), each rank's values bit for bit the
one-device ``cuda`` path's and its launches in the kernels line; then
``launch/permanent.py --backend distributed`` and ``launch/campaign.py``
(killed at world 2, resumed at 4, finished at 1) under ``python -m
torch.distributed.run``; ``--mesh-only`` runs the build and this phase.
A summary goes to ``chiprun_out/chip_smoke.json``.

The build report gives each kernel instantiation's registers, spills and
warps per SM, and the SASS instruction mix of the complex body's hot
loop and of the real body's window loops.  Real sparse leaves go to the
kernels as the main path prepares them (``ops.prepare_sparse``: low
columns that touch few rows, those rows first); the timing phase prints
R, the rows the low columns touch, and RPAD, the window loop it runs.
The kernels are timed in rounds taken in turns before any plain
pass, with the card's SM clock, power and temperature read around each
window; ``--time-only`` stops after those rounds (no plain pass, no value
check, no result line) and appends them to
``chiprun_out/chip_smoke_timing.json``, to compare versions of a kernel
source on one card in one call.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", ...}}``; the line before it is
the per-kernel JSON.  Any failed phase exits 1 without that line, as does
a machine without a usable card.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import queue
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

SEED = 20250226
N_MAIN = 30              # the largest dense leaf the main path serves
N_BUCKET, B_BUCKET = 22, 16
N_THRU, B_THRU = 24, 256
# 33 and 38 pad to NPAD 40 (its last 8 rows dropped past n by a select),
# 41 and 47 to NPAD 48
WINDOW_NS = (4, 13, N_BUCKET, N_THRU, N_MAIN, 33, 38, 40, 41, 47, 64)
# the sparse route: n = 32 is its largest leaf under campaign_threshold =
# 2^34 at degree 7 (cost 32 * 2^31 * 7/32); the buckets are degree 5
N_SPARSE, SPARSE_DEGREE, BUCKET_DEGREE = 32, 7, 5
SPARSE_WINDOW_NS = (4, 13, 16, N_BUCKET, N_THRU, N_SPARSE, 40, 47, 64)
PLAIN_WINDOWS = 8        # the n = 32 plain pass runs in this many slices
# the campaign route (dense n >= 31 at campaign_threshold = 2^34)
N_CAMPAIGN, N_CAMPAIGN_CX = 40, 32   # main paths: all-ones real, complex
CAMPAIGN_ONES = (32, 36, 40)         # all-ones values against n!
# Value bars of the campaign main paths (relative).  All-ones: every Gray
# step's product is of equal integers, so the error is that of the
# products' roundings and the cross-block sums (read 5.6e-12 / 5.2e-11 /
# 6.8e-11 at n = 32 / 36 / 40; worst case (n-1) u x sum|terms| / n! =
# 6.4e-9 at n = 40).  I + P (P a derangement): every row sum, product and
# partial sum is a small integer, so the value is exact, 2^(cycles of P).
# D1 J D2, a rank-one matrix with random diagonals, perm = n! prod(d1)
# prod(d2): its Ryser terms cancel by about 1e6 at n = 40 and its row sums
# are not integers, so they drift over a chunk's C Gray steps -- read
# 1.7e-7 real at n = 40 (C = 2^19), 2.5e-11 complex at n = 32 (C = 2^11).
# Complex against the direct kernel: two chunk geometries round apart by
# what the matrix makes of them -- read 1.0e-12, 4.3e-14 and 1.2e-12 on
# three Gaussian n = 32 matrices.
ONES_BAR, CX_DIRECT_BAR = 1e-10, 1e-11
RANK1_BAR = {False: 1e-6, True: 1e-10}      # real n = 40, complex n = 32
LARGE_BASE_NS = (40, 48, 56, 64)     # scalar entries from large chunk bases
CAMPAIGN_KILL_N, CAMPAIGN_KILL_SLICES = 36, 256   # kill and resume
W1_SLICES = 8                        # slices run again at W = 1
PRECISIONS = ("dd", "dq_fast", "dq_acc", "qq", "kahan")
RTOL_KERNEL, ATOL_KERNEL = 1e-12, 1e-15
MAIN_REPS = 3

# Data-sheet rates and the Ryser kernels' operation counts come from one
# place, repro_torch/utils/roofline.py (HW_SPECS, detect_hw, ryser_ops,
# complex_ryser_ops, sparse_ryser_ops), which the tuner's model reads too.


class Smoke:
    def __init__(self):
        self.failures: list[str] = []
        self.summary: dict = {}

    def check(self, ok: bool, what: str) -> None:
        print(f"[{'ok' if ok else 'FAIL'}] {what}", flush=True)
        if not ok:
            self.failures.append(what)


def _time_ms(torch, fn, reps: int):
    """(mean ms per call over ``reps`` calls by CUDA events after one
    warm-up call, the last call's result)."""
    out = fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def _ulp_gap(a: np.ndarray, b: np.ndarray) -> float:
    scale = np.spacing(np.maximum(np.abs(a), np.abs(b)))
    gap = np.abs(a - b) / np.where(scale > 0, scale, 1.0)
    return float(np.max(gap)) if gap.size else 0.0


# (body, dtype, schedmat) of each family of 32 instantiations (8 NPAD x
# 4 precisions)
INSTANTIATIONS = (("dense", "f64", False), ("dense", "f64", True),
                  ("dense", "f32", False), ("dense", "f32", True),
                  ("complex", "f64", False), ("complex", "f32", False),
                  ("sparse", "f64", False), ("sparse", "f32", False),
                  ("sparse_cx", "f64", False), ("sparse_cx", "f32", False))


def _ptxas_summary(log: str) -> list[dict]:
    """(kernel, npad, precision code, dtype, schedmat, registers, spill
    bytes) per kernel instantiation: ryser_kernel<NPAD, P, SPARSE, T,
    SCHED> ("dense" in ryser_dense.cu, with and without the schedmat mode;
    "sparse" in ryser_sparse.cu) and ryser_cx_kernel<NPAD, P, SPARSE, T>
    ("complex" in ryser_complex.cu, "sparse_cx" in ryser_sparse.cu), each
    f64 and f32."""
    names = {("", "0"): "dense", ("", "1"): "sparse",
             ("cx_", "0"): "complex", ("cx_", "1"): "sparse_cx"}
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            t = re.search(r"ryser_(cx_)?kernelILi(\d+)ELi(\d+)ELb([01])E"
                          r"(?:([df])(?:Lb([01])E)?)?", m.group(1))
            cur = {"kernel": names[(t.group(1) or "", t.group(4))],
                   "npad": int(t.group(2)),
                   "prec": int(t.group(3)),
                   "dtype": "f32" if t.group(5) == "f" else "f64",
                   "sched": t.group(6) == "1"} if t else None
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            out.append(cur)
            cur = None
    return sorted(out, key=lambda d: (d["kernel"], d["dtype"], d["sched"],
                                      d["npad"], d["prec"]))


def phase_card(smoke: Smoke, torch) -> dict:
    q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    line = q.stdout.strip().splitlines()[0] if q.stdout.strip() else ""
    smoke.check(q.returncode == 0 and bool(line), "nvidia-smi reads the card")
    print(line)
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {name} count {torch.cuda.device_count()}")
    return {"nvidia_smi": line, "name": name}


def phase_build(smoke: Smoke) -> None:
    from repro_torch.kernels import build
    from repro_torch.core.stepspace import DEFAULT_GEOMETRY
    t0 = time.perf_counter()
    build.load_library()
    dt = time.perf_counter() - t0
    print(f"build: {dt:.1f} s -> {build.build_dir()}")
    regs = _ptxas_summary(build.ptxas_log())
    TB = DEFAULT_GEOMETRY.lanes
    for r in regs:
        r["warps_per_sm"] = build.warps_per_sm(r["registers"], TB)
    smoke.summary["build_s"] = dt
    smoke.summary["ptxas"] = regs
    for r in regs:
        print(f"  ptxas {r['kernel']:9s} {r['dtype']}"
              f"{' schedmat' if r['sched'] else ''} npad={r['npad']:2d} "
              f"prec={r['prec']} registers={r['registers']} "
              f"spill={r.get('spill_stores', 0)}"
              f"/{r.get('spill_loads', 0)} B warps/SM={r['warps_per_sm']} "
              f"(TB={TB})")
    for kernel, dtype, sched in INSTANTIATIONS:
        k = [r for r in regs if (r["kernel"], r["dtype"], r["sched"]) ==
             (kernel, dtype, sched)]
        what = f"{kernel} {dtype}{' schedmat' if sched else ''}"
        smoke.check(len(k) == 32, f"32 {what} kernel instantiations built "
                                  f"({len(k)})")
    spills = [(r["kernel"], r["npad"], r["prec"]) for r in regs
              if r["npad"] <= 48 and (r.get("spill_stores", 0)
                                      or r.get("spill_loads", 0))]
    smoke.check(not spills, f"no spills at NPAD <= 48 ({spills})")
    smoke.summary["sass"] = mix = _sass_mix(build)
    for name, ms in mix.items():
        for m in (ms if isinstance(ms, list) else [ms]):
            print(f"  sass {name}: loop {m['loop']}, {m['rows']:g} rows: "
                  f"{m['counts']}; per row {m['per_row']}; other "
                  f"{m['other']}")
    smoke.summary["wave_body"] = _wave_body_report(regs)


def _wave_body_report(regs: list) -> dict:
    """Registers, CTAs an SM and waves a permanent of the campaign's wave
    body at n = 38 (the dense f64 dq_acc instantiation of its NPAD,
    batched mode) under the default SolverConfig's slice plan, before any
    widening of short waves."""
    import torch
    from repro_torch.core.distributed import even_wave_width
    from repro_torch.core.planner import SolverConfig
    from repro_torch.core.stepspace import plan_slices
    from repro_torch.kernels import ops
    n, cfg = 38, SolverConfig()
    ts, cps, C = plan_slices(n, cfg.campaign_slices, 1, cfg.campaign_lanes)
    TB, _ = ops.wave_geometry(cps, C)
    npad = -(-n // 8) * 8
    ctas = ops.wave_ctas_per_sm(n, False, chunks_per_slice=cps, chunk_size=C,
                                precision="dq_acc")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    width = even_wave_width(ts, max(1, -(-sms * ctas // (cps // TB))))
    reg = next((r["registers"] for r in regs
                if (r["kernel"], r["dtype"], r["sched"], r["npad"],
                    r["prec"]) == ("dense", "f64", False, npad, 2)), None)
    out = {"n": n, "npad": npad, "registers": reg, "ctas_per_sm": ctas,
           "TB": TB, "wave_width": width, "waves": -(-ts // width),
           "slices": ts}
    print(f"  wave body n={n}: dense f64 dq_acc npad={npad} registers={reg} "
          f"ctas_per_sm={ctas} (TB={TB}), {out['waves']} waves of {width} "
          f"slices a permanent ({ts} slices, {sms} SMs)")
    return out


def _sass_mix(build, prec: int = 2) -> dict:
    """Instruction classes of the Ryser bodies' hot loops at precision code
    ``prec`` (2 = dq_acc), from ``cuobjdump -sass`` of the built objects.
    Complex body (NPAD 32, dense and sparse instantiation): the innermost
    loop (a backward branch with no other inside it) holding the most
    DMUL, its rows DMUL / 4 (the complex product's four multiplies).  Real
    body (NPAD 32 and 24, dense and sparse, and the dense campaign wave
    body at NPAD 40): every innermost loop with 8 or more DMUL -- the
    modes' step loops, the sparse body's RPAD variants -- its rows the
    DMUL count (one multiply a row and step); a variant's DADD per row
    says its RPAD.  ``per_row`` divides each class by the rows."""
    tool = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    out = {}
    if not os.path.exists(tool):
        print(f"  sass: no {tool}, instruction mix not measured")
        return out
    sass = {}
    for kernel, obj, fn, sparse, npad, per in (
            ("complex", "ryser_complex", "ryser_cx_kernel", 0, 32, 4),
            ("sparse_cx", "ryser_sparse", "ryser_cx_kernel", 1, 32, 4),
            ("dense", "ryser_dense", "ryser_kernel", 0, 40, 1),
            ("dense", "ryser_dense", "ryser_kernel", 0, 32, 1),
            ("dense", "ryser_dense", "ryser_kernel", 0, 24, 1),
            ("sparse", "ryser_sparse", "ryser_kernel", 1, 32, 1),
            ("sparse", "ryser_sparse", "ryser_kernel", 1, 24, 1)):
        # the f64 instantiation (the real body's without the schedmat mode)
        tail = "dLb0E" if per == 1 else "dE"
        path = str(build.build_dir() / f"{obj}_n{npad}.o")
        if path not in sass:
            sass[path] = subprocess.run([tool, "-sass", path],
                                        capture_output=True, text=True,
                                        timeout=120).stdout
        want = f"{fn}ILi{npad}ELi{prec}ELb{sparse}E{tail}"
        body = next((b for b in sass[path].split("Function : ")[1:]
                     if b.split(None, 1)[0].find(want) >= 0), "")
        if per == 4:
            out[kernel] = _loop_mix(body)
        else:
            out[f"{kernel}_n{npad}"] = _loop_mix(body, per=1, min_dmul=8)
    return out


def _loop_mix(body: str, per: int = 4, min_dmul: int = 0):
    """Class counts of the innermost loop with the most DMUL in one
    function's SASS, its rows DMUL / ``per``; with ``min_dmul``, a list of
    every innermost loop holding at least that many DMUL, in address order
    (see ``_sass_mix``)."""
    ins, loops = [], []
    for line in body.splitlines():
        m = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)(.*)", line)
        if not m:
            continue
        addr, op = int(m.group(1), 16), m.group(2).split(".")[0]
        ins.append((addr, op))
        t = re.match(r"\s+(0x[0-9a-f]+)", m.group(3))
        if op == "BRA" and t and int(t.group(1), 16) <= addr:
            loops.append((int(t.group(1), 16), addr))
    leaves = [lp for lp in loops if not any(
        o != lp and lp[0] <= o[0] and o[1] <= lp[1] for o in loops)]

    def ops_in(lp):
        return [op for a, op in ins if lp[0] <= a <= lp[1]]

    def mix(lp):
        ops = ops_in(lp)
        classes = ("DADD", "DMUL", "DFMA", "LDS", "SHFL", "ISETP", "BRA")
        counts = {c: ops.count(c) for c in classes}
        counts["other"] = len(ops) - sum(counts.values())
        rows = counts["DMUL"] / per
        others: dict = {}
        for op in ops:
            if op not in classes:
                others[op] = others.get(op, 0) + 1
        return {"loop": [hex(lp[0]), hex(lp[1])], "rows": rows,
                "counts": counts,
                "per_row": {c: round(v / rows, 2) if rows else None
                            for c, v in counts.items()},
                "other": dict(sorted(others.items(),
                                     key=lambda kv: -kv[1])[:6])}
    if min_dmul:
        return [mix(lp) for lp in sorted(leaves)
                if ops_in(lp).count("DMUL") >= min_dmul]
    if not leaves:
        return {"loop": None, "rows": 0, "counts": {}, "per_row": {},
                "other": {}}
    return mix(max(leaves, key=lambda lp: ops_in(lp).count("DMUL")))


def phase_kernel_vs_plain(smoke: Smoke, torch) -> dict:
    """Each kernel entry against block_partials_plain on the card: windows
    of up to 8 blocks, the first and the last (the top of the step space,
    which exercises the u64 high bits and ``live``), both modes, all
    precisions; the batched entry at B = 3; and the bucket of the main
    path (16 x n = 22, dq_acc, batched) over its full grid.  The timing
    phase holds the other two main-path shapes over their full grids."""
    from repro_torch.core.stepspace import DEFAULT_GEOMETRY, Geometry
    from repro_torch.kernels import ops
    from repro_torch.kernels import ryser_cuda as RC
    rng = np.random.default_rng(SEED)
    err = {"ryser_dense_scalar": 0.0, "ryser_dense_batched": 0.0}
    worst_ulp = 0.0
    ok = equal = True
    for n in WINDOW_NS:
        # below the bucket sizes a small geometry, so the window still
        # spans 8 blocks; from there on the main path's own
        geom = DEFAULT_GEOMETRY if n >= N_BUCKET else Geometry(8, 8, 4)
        TB, C, Wu, blocks = geom.kernel_geometry(n)
        nb = min(8, blocks)
        As = torch.as_tensor(rng.uniform(-1, 1, (3, n, n)), device="cuda")
        A_pads, xb_pads, _ = ops.prepare(As)
        geo = dict(n=n, TB=TB, C=C, Wu=Wu, num_blocks=nb)
        for mode in ("baseline", "batched"):
            for prec in PRECISIONS:
                for base in sorted({0, blocks * TB - nb * TB}):
                    got = RC.ryser_cuda_call(A_pads[0], xb_pads[0], base,
                                             precision=prec, mode=mode, **geo)
                    want = RC.block_partials_plain(
                        A_pads[:1], xb_pads[:1], base, precision=prec,
                        mode=mode, **geo)[0]
                    ok &= _agree(got, want, err, "ryser_dense_scalar")
                    equal &= bool(torch.equal(got, want))
                    worst_ulp = max(worst_ulp, _ulp_gap(
                        got.cpu().numpy(), want.cpu().numpy()))
                got = RC.ryser_cuda_call_batched(A_pads, xb_pads,
                                                 precision=prec, mode=mode,
                                                 **geo)
                want = RC.block_partials_plain(A_pads, xb_pads, 0,
                                               precision=prec, mode=mode,
                                               **geo)
                ok &= _agree(got, want, err, "ryser_dense_batched")
                equal &= bool(torch.equal(got, want))
                worst_ulp = max(worst_ulp, _ulp_gap(got.cpu().numpy(),
                                                    want.cpu().numpy()))
        torch.cuda.synchronize()
    TB, C, Wu, blocks = DEFAULT_GEOMETRY.kernel_geometry(N_BUCKET)
    As = torch.as_tensor(rng.uniform(-1, 1, (B_BUCKET, N_BUCKET, N_BUCKET)),
                         device="cuda")
    A_pads, xb_pads, _ = ops.prepare(As)
    geo = dict(n=N_BUCKET, TB=TB, C=C, Wu=Wu, num_blocks=blocks,
               precision="dq_acc", mode="batched")
    got = RC.ryser_cuda_call_batched(A_pads, xb_pads, **geo)
    want = RC.block_partials_plain(A_pads, xb_pads, 0, **geo)
    ok &= _agree(got, want, err, "ryser_dense_batched")
    equal &= bool(torch.equal(got, want))
    worst_ulp = max(worst_ulp, _ulp_gap(got.cpu().numpy(),
                                        want.cpu().numpy()))
    print(f"kernel vs plain: worst ulp gap {worst_ulp:g}, max abs err "
          f"{err}, bit for bit {equal}")
    smoke.check(ok, f"kernels agree with their plain versions for n in "
                    f"{WINDOW_NS} (rtol {RTOL_KERNEL:g}, atol "
                    f"{ATOL_KERNEL:g}), both modes, {len(PRECISIONS)} "
                    f"precisions, scalar windows incl. the top of the space, "
                    f"batched B=3, full grid {B_BUCKET} x n={N_BUCKET} "
                    f"({blocks} blocks)")
    smoke.check(equal, "real dense kernels equal their plain versions bit "
                       "for bit on the same windows and grid")
    smoke.summary["kernel_vs_plain"] = {"worst_ulp": worst_ulp,
                                        "bit_for_bit": equal, **err}
    return err


def _agree(got, want, err: dict, entry: str) -> bool:
    """Partials agree per component: (hi + lo) of a real kernel's
    (hi, lo), (re_hi + re_err, im_hi + im_err) of a complex kernel's."""
    g, w = got.cpu().numpy(), want.cpu().numpy()
    err[entry] = max(err[entry], float(np.max(np.abs(g - w))))
    gs, ws = g[..., 0::2] + g[..., 1::2], w[..., 0::2] + w[..., 1::2]
    return bool(np.all(np.isfinite(g)) and np.all(
        np.abs(gs - ws) <= ATOL_KERNEL + RTOL_KERNEL * np.abs(ws)))


def _cgauss(rng, shape):
    """Complex Gaussian entries of unit variance (amplitude matrices)."""
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)) \
        / math.sqrt(2)


def phase_kernel_vs_plain_complex(smoke: Smoke, torch) -> dict:
    """Both complex entries against block_partials_plain_complex on the
    card, bit for bit: windows of up to 8 blocks, the first and the last,
    all precisions; the batched entry at B = 3; and the complex bucket of
    the main path (16 x n = 22, dq_acc) over its full grid."""
    from repro_torch.core.stepspace import DEFAULT_GEOMETRY, Geometry
    from repro_torch.kernels import ops
    from repro_torch.kernels import ryser_complex_cuda as RX
    rng = np.random.default_rng(SEED + 10)
    err = {"ryser_complex_scalar": 0.0, "ryser_complex_batched": 0.0}
    worst_ulp = 0.0
    ok = True

    def hold(got, want, entry):
        nonlocal ok, worst_ulp
        ok &= _agree(got, want, err, entry) and bool(torch.equal(got, want))
        worst_ulp = max(worst_ulp, _ulp_gap(got.cpu().numpy(),
                                            want.cpu().numpy()))

    for n in WINDOW_NS:
        geom = DEFAULT_GEOMETRY if n >= N_BUCKET else Geometry(8, 8, 4)
        TB, C, Wu, blocks = geom.kernel_geometry(n)
        nb = min(8, blocks)
        As = torch.as_tensor(_cgauss(rng, (3, n, n)), device="cuda")
        Ar, Ai, xbr, xbi, _ = ops.prepare_complex(As)
        geo = dict(n=n, TB=TB, C=C, Wu=Wu, num_blocks=nb)
        for prec in PRECISIONS:
            for base in sorted({0, blocks * TB - nb * TB}):
                got = RX.ryser_cuda_call_complex(Ar[0], Ai[0], xbr[0], xbi[0],
                                                 base, precision=prec, **geo)
                want = RX.block_partials_plain_complex(
                    Ar[:1], Ai[:1], xbr[:1], xbi[:1], base, precision=prec,
                    **geo)[0]
                hold(got, want, "ryser_complex_scalar")
            got = RX.ryser_cuda_call_complex_batched(Ar, Ai, xbr, xbi,
                                                     precision=prec, **geo)
            want = RX.block_partials_plain_complex(Ar, Ai, xbr, xbi, 0,
                                                   precision=prec, **geo)
            hold(got, want, "ryser_complex_batched")
        torch.cuda.synchronize()
    TB, C, Wu, blocks = DEFAULT_GEOMETRY.kernel_geometry(N_BUCKET)
    As = torch.as_tensor(_cgauss(rng, (B_BUCKET, N_BUCKET, N_BUCKET)),
                         device="cuda")
    planes = ops.prepare_complex(As)[:4]
    geo = dict(n=N_BUCKET, TB=TB, C=C, Wu=Wu, num_blocks=blocks,
               precision="dq_acc")
    hold(RX.ryser_cuda_call_complex_batched(*planes, **geo),
         RX.block_partials_plain_complex(*planes, 0, **geo),
         "ryser_complex_batched")
    print(f"complex kernel vs plain: worst ulp gap {worst_ulp:g}, max abs "
          f"err {err}")
    smoke.check(ok, f"complex kernels equal their plain versions bit for "
                    f"bit for n in {WINDOW_NS}, {len(PRECISIONS)} "
                    f"precisions, scalar windows incl. the top of the space, "
                    f"batched B=3, full grid {B_BUCKET} x n={N_BUCKET} "
                    f"({blocks} blocks)")
    smoke.summary["kernel_vs_plain_complex"] = {"worst_ulp": worst_ulp,
                                                **err}
    return err


def phase_main_path(smoke: Smoke, torch) -> dict:
    """The main path through the user entry points, counters 0 before and
    read right after.  Returns the matrices and values for the checks."""
    import repro_torch
    from repro_torch.kernels import ryser_cuda as RC
    rng = np.random.default_rng(SEED + 1)
    A30 = rng.uniform(-1, 1, (N_MAIN, N_MAIN))
    bucket = rng.uniform(-1, 1, (B_BUCKET, N_BUCKET, N_BUCKET))
    thru = rng.uniform(-1, 1, (B_THRU, N_THRU, N_THRU))
    torch.cuda.synchronize()

    RC.reset_counters()
    t_scalar = []
    for _ in range(MAIN_REPS):
        t0 = time.perf_counter()
        v30, rep = repro_torch.permanent(A30, return_report=True)
        t_scalar.append(time.perf_counter() - t0)
    counts_scalar = dict(RC.counters)

    RC.reset_counters()
    vb, reps_b = repro_torch.permanent_batch(bucket, return_report=True)
    t_thru = []
    for _ in range(MAIN_REPS):
        t0 = time.perf_counter()
        vt = repro_torch.permanent_batch(thru)
        t_thru.append(time.perf_counter() - t0)
    counts_batch = dict(RC.counters)

    print(f"main path scalar: perm(A30) = {v30:+.17e}, host seconds "
          f"{t_scalar}, dispatch {rep.dispatch}, counters {counts_scalar}")
    print(f"main path buckets: {reps_b[0].dispatch}; {B_THRU} x n={N_THRU} "
          f"host seconds {t_thru} = {B_THRU / min(t_thru):.1f} perms/s "
          f"(best), counters {counts_batch}")
    smoke.check(counts_scalar["ryser_dense_scalar"] > 0
                and counts_scalar["block_partials_plain"] == 0,
                "scalar main path launched ryser_dense_scalar, plain 0")
    smoke.check(counts_batch["ryser_dense_batched"] > 0
                and counts_batch["block_partials_plain"] == 0,
                "bucket main path launched ryser_dense_batched, plain 0")
    smoke.check(bool(np.isfinite(v30)) and vb.shape == (B_BUCKET,)
                and vt.shape == (B_THRU,) and bool(np.all(np.isfinite(vt))),
                "main-path values are finite and of the expected shape")
    smoke.summary["main_path"] = {
        "perm_A30": v30, "scalar_s": t_scalar, "thru_s": t_thru,
        "thru_perms_per_s": B_THRU / min(t_thru),
        "launches_scalar": counts_scalar, "launches_batch": counts_batch}
    return {"A30": A30, "v30": v30, "bucket": bucket, "vb": vb,
            "thru": thru,
            "launches": {"ryser_dense_scalar":
                         counts_scalar["ryser_dense_scalar"],
                         "ryser_dense_batched":
                         counts_batch["ryser_dense_batched"]}}


def phase_values(smoke: Smoke, torch, mp: dict) -> None:
    import repro_torch
    from repro_torch.core.oracle import all_ones_permanent
    from repro_torch.kernels import ops
    # scaled all-ones D1 J D2: perm = n! prod(r) prod(c)
    rng = np.random.default_rng(SEED + 2)
    r = rng.uniform(0.5, 1.5, N_MAIN)
    c = rng.uniform(0.5, 1.5, N_MAIN)
    exact = all_ones_permanent(N_MAIN) * math.prod(r) * math.prod(c)
    got = repro_torch.permanent(np.outer(r, c), precision="dq_acc")
    rel = rel_ones = abs(got - exact) / abs(exact)
    print(f"all-ones D1 J D2 n={N_MAIN}: {got:+.17e} exact {exact:+.17e} "
          f"rel.err {rel:.3e}")
    smoke.check(rel <= 1e-8, f"scaled all-ones n={N_MAIN} rel.err "
                             f"{rel:.3e} <= 1e-8")
    # the scalar value against the batched entry (the other kernel mode)
    vbat = float(ops.permanent_cuda_batched(mp["A30"][None])[0])
    rel = abs(vbat - mp["v30"]) / abs(mp["v30"])
    smoke.check(rel <= 1e-9, f"n={N_MAIN} scalar (baseline) vs batched "
                             f"entry rel {rel:.3e} <= 1e-9")
    # the bucket against the torch engine on the card
    ref = repro_torch.permanent_batch(mp["bucket"], backend="torch")
    rel = float(np.max(np.abs(mp["vb"] - ref) / np.abs(ref)))
    smoke.check(rel <= 1e-9, f"bucket {B_BUCKET} x n={N_BUCKET} vs torch "
                             f"engine max rel {rel:.3e} <= 1e-9")
    smoke.summary["values"] = {"allones_rel": rel_ones,
                               "bucket_vs_torch": rel}


def phase_main_path_complex(smoke: Smoke, torch) -> dict:
    """The complex main path through the same entry points: a 30 x 30
    complex Gaussian (the amplitude shape of a 30-photon submatrix) and
    complex buckets, counters 0 before each path and read right after."""
    import repro_torch
    from repro_torch.kernels import ryser_cuda as RC
    rng = np.random.default_rng(SEED + 11)
    A30 = _cgauss(rng, (N_MAIN, N_MAIN))
    bucket = _cgauss(rng, (B_BUCKET, N_BUCKET, N_BUCKET))
    thru = _cgauss(rng, (B_THRU, N_THRU, N_THRU))
    torch.cuda.synchronize()

    RC.reset_counters()
    t_scalar = []
    for _ in range(MAIN_REPS):
        t0 = time.perf_counter()
        v30, rep = repro_torch.permanent(A30, return_report=True)
        t_scalar.append(time.perf_counter() - t0)
    counts_scalar = dict(RC.counters)

    RC.reset_counters()
    vb, reps_b = repro_torch.permanent_batch(bucket, return_report=True)
    t_thru = []
    for _ in range(MAIN_REPS):
        t0 = time.perf_counter()
        vt = repro_torch.permanent_batch(thru)
        t_thru.append(time.perf_counter() - t0)
    counts_batch = dict(RC.counters)

    print(f"complex main path scalar: perm(A30c) = {v30.real:+.17e} "
          f"{v30.imag:+.17e}j, host seconds {t_scalar} = "
          f"{1 / min(t_scalar):.1f} perms/s (best), dispatch {rep.dispatch}, "
          f"counters {counts_scalar}")
    print(f"complex main path buckets: {reps_b[0].dispatch}; {B_THRU} x "
          f"n={N_THRU} host seconds {t_thru} = {B_THRU / min(t_thru):.1f} "
          f"perms/s (best), counters {counts_batch}")
    smoke.check(counts_scalar["ryser_complex_scalar"] > 0
                and counts_scalar["block_partials_plain_complex"] == 0,
                "complex scalar main path launched ryser_complex_scalar, "
                "plain 0")
    smoke.check(counts_batch["ryser_complex_batched"] > 0
                and counts_batch["block_partials_plain_complex"] == 0,
                "complex bucket main path launched ryser_complex_batched, "
                "plain 0")
    smoke.check(isinstance(v30, complex) and bool(np.isfinite(v30))
                and vb.shape == (B_BUCKET,) and vb.dtype == np.complex128
                and vt.shape == (B_THRU,) and bool(np.all(np.isfinite(vt))),
                "complex main-path values are finite complex of the "
                "expected shape")
    smoke.summary["main_path_complex"] = {
        "perm_A30c": [v30.real, v30.imag], "scalar_s": t_scalar,
        "thru_s": t_thru, "thru_perms_per_s": B_THRU / min(t_thru),
        "launches_scalar": counts_scalar, "launches_batch": counts_batch}
    return {"A30": A30, "v30": v30, "bucket": bucket, "vb": vb,
            "thru": thru,
            "launches": {"ryser_complex_scalar":
                         counts_scalar["ryser_complex_scalar"],
                         "ryser_complex_batched":
                         counts_batch["ryser_complex_batched"]}}


def phase_values_complex(smoke: Smoke, torch, mp: dict) -> None:
    import repro_torch
    from repro_torch.core.oracle import all_ones_permanent
    # complex scaled all-ones D1 J D2: perm = n! prod(r) prod(c)
    rng = np.random.default_rng(SEED + 12)
    r = rng.uniform(0.5, 1.5, N_MAIN) * np.exp(1j * rng.uniform(
        -np.pi, np.pi, N_MAIN))
    c = rng.uniform(0.5, 1.5, N_MAIN) * np.exp(1j * rng.uniform(
        -np.pi, np.pi, N_MAIN))
    exact = all_ones_permanent(N_MAIN) * complex(np.prod(r)) \
        * complex(np.prod(c))
    got = repro_torch.permanent(np.outer(r, c), precision="dq_acc")
    rel_ones = abs(got - exact) / abs(exact)
    print(f"complex all-ones D1 J D2 n={N_MAIN}: {got} exact {exact} "
          f"rel.err {rel_ones:.3e}")
    smoke.check(rel_ones <= 1e-8, f"complex scaled all-ones n={N_MAIN} "
                                  f"rel.err {rel_ones:.3e} <= 1e-8")
    # the complex bucket against the torch engine on the card
    ref = repro_torch.permanent_batch(mp["bucket"], backend="torch")
    rel = float(np.max(np.abs(mp["vb"] - ref) / np.abs(ref)))
    smoke.check(rel <= 1e-9, f"complex bucket {B_BUCKET} x n={N_BUCKET} vs "
                             f"torch engine max rel {rel:.3e} <= 1e-9")
    # a scalar leaf equals the same leaf in a bucket, bit for bit: both run
    # the window-batched body
    other = _cgauss(rng, (N_MAIN, N_MAIN))
    vb = repro_torch.permanent_batch([mp["A30"], other])
    smoke.check(vb[0] == mp["v30"], f"complex n={N_MAIN} scalar leaf equals "
                                    f"the same leaf in a bucket bit for bit "
                                    f"({mp['v30']} vs {vb[0]})")
    smoke.summary["values_complex"] = {"allones_rel": rel_ones,
                                       "bucket_vs_torch": rel,
                                       "scalar_vs_bucket_equal":
                                       bool(vb[0] == mp["v30"])}


def _circulant_sparse(rng, n: int, degree: int, cplx: bool = False,
                      extra: int = 0):
    """A random row and column permutation of the ``degree``-diagonal
    circulant pattern: every row and column holds ``degree`` nonzeros, each
    entry lies on a perfect matching, so DM and FM (degree > 4) leave the
    matrix whole.  U(0.5, 1.5) values, complex Gaussian for complex.
    ``extra`` adds that many entries to one column (a larger maxdeg)."""
    i, j = np.indices((n, n))
    mask = (j - i) % n < degree
    if extra:
        free = np.flatnonzero(~mask[:, 0])
        mask[rng.choice(free, size=extra, replace=False), 0] = True
    mask = mask[rng.permutation(n)][:, rng.permutation(n)]
    vals = _cgauss(rng, (n, n)) if cplx else rng.uniform(0.5, 1.5, (n, n))
    return np.where(mask, vals, 0)


def _uneven_sparse(rng, n: int, cplx: bool, extra: int):
    """Density about 0.2 with a full diagonal and ``extra`` more nonzeros in
    column 0: uneven column degrees for the kernel windows."""
    A = rng.uniform(0.5, 1.5, (n, n)) * (rng.uniform(0, 1, (n, n)) < 0.2)
    np.fill_diagonal(A, 1.0)
    A[rng.choice(n, size=min(extra, n), replace=False), 0] = 1.25
    return A * np.exp(1j * rng.uniform(-np.pi, np.pi, (n, n))) if cplx else A


def _extent_sparse(rng, n: int, R: int, kw: int, extra: int = 0,
                   negzero: bool = False):
    """Density about 0.25 with a full diagonal, whose kw low columns touch
    exactly the rows below R (row R - 1 among them): the real sparse kernel
    runs its window loop for RPAD = R rounded up to 8.  ``extra`` more
    nonzeros in column kw give a larger maxdeg.  With ``negzero`` the
    zeros are stored as -0.0 and, if R < n - 1, row n - 1 becomes an
    untouched row whose sum cancels (0.5 and -0.5), so its state is 0 on
    some steps."""
    A = rng.uniform(0.5, 1.5, (n, n)) * (rng.uniform(0, 1, (n, n)) < 0.25)
    np.fill_diagonal(A, 1.0)
    A[R:, :kw] = 0.0
    A[R - 1, 0] = 0.75
    if extra:
        A[rng.choice(n, size=min(extra, n), replace=False), kw] = 1.25
    if negzero:
        if R < n - 1 and kw + 1 < n:
            A[n - 1] = 0.0
            A[n - 1, kw], A[n - 1, kw + 1] = 0.5, -0.5
        A = np.where(A == 0.0, -0.0, A)
    return A


def _sparse_inputs(torch, mats, cplx: bool, Wu: int | None = None,
                   single: bool = False):
    """Kernel inputs of a sparse stack on the card, packed to the
    bucket-wide maxdeg: the real ``(A_pads, rows, vals, xb_pads)`` or the
    complex ``(Ar, Ai, rows, vals_r, vals_i, xbr, xbi)``, f32 planes when
    ``single``.  Given the window ``Wu``, real leaves are ordered as the
    main path orders them (``ops.prepare_sparse``); without it they go as
    they come."""
    from repro_torch.core.sparyser import SparseMatrix, pack_padded_ccs
    from repro_torch.kernels import ops
    if single:
        mats = [A.astype(np.complex64 if cplx else np.float32) for A in mats]
    A_np, rows_np, vals_np = pack_padded_ccs(
        [SparseMatrix.from_dense(A) for A in mats])
    As = torch.as_tensor(A_np, device="cuda")
    rows = torch.as_tensor(rows_np, device="cuda")
    vals = torch.as_tensor(vals_np, device="cuda")
    if cplx:
        Ar, Ai, xbr, xbi, _ = ops.prepare_complex(As)
        return (Ar, Ai, rows, vals.real.contiguous(), vals.imag.contiguous(),
                xbr, xbi)
    if Wu is not None:
        return ops.prepare_sparse(As, rows, vals, Wu)[:4]
    A_pads, xb_pads, _ = ops.prepare(As)
    return A_pads, rows, vals, xb_pads


def _rows_rpad(rows, Wu: int, n: int) -> list:
    """[R, RPAD] of each member of real kernel inputs' CCS ``rows``."""
    from repro_torch.kernels import ryser_sparse_cuda as RS
    R = RS.low_column_rows(rows, int(math.log2(Wu)), n).reshape(-1).tolist()
    return [[r, max(8, -(-r // 8) * 8)] for r in R]


def _sparse_calls(cplx: bool):
    """(scalar entry, batched entry, plain version) of the sparse kernels."""
    from repro_torch.kernels import ryser_sparse_cuda as RS
    if cplx:
        return (RS.ryser_sparse_cuda_call_complex,
                RS.ryser_sparse_cuda_call_complex_batched,
                RS.block_partials_plain_sparse_complex)
    return (RS.ryser_sparse_cuda_call, RS.ryser_sparse_cuda_call_batched,
            RS.block_partials_plain_sparse)


def _dense_batched_mode(ins, cplx: bool, **geo):
    """The dense kernel's batched mode (real) or the dense split-plane
    kernel (complex) on the dense planes of sparse kernel inputs."""
    from repro_torch.kernels import ryser_complex_cuda as RX
    from repro_torch.kernels import ryser_cuda as RC
    if cplx:
        return RX.ryser_cuda_call_complex_batched(ins[0], ins[1], ins[5],
                                                  ins[6], **geo)
    return RC.ryser_cuda_call_batched(ins[0], ins[3], mode="batched", **geo)


def phase_kernel_vs_plain_sparse(smoke: Smoke, torch) -> dict:
    """The four sparse entries against their plain versions on the card,
    bit for bit: 8-block windows (the first and the last) for every n of
    SPARSE_WINDOW_NS x 5 precisions (n == n_pad at 16, 24, 32, 40, 64);
    the batched entries at B = 3 with a bucket-wide maxdeg above each
    member's own; and the full grid of 16 x n = 22 (the timing phase holds
    the main path's 256 x n = 24 and n = 32).  Real matrices have a set R
    (``_extent_sparse``): the B = 3 members R = 5 (with -0.0 zeros and a
    cancelling untouched row), about n / 2 + 1, and n, so each window
    reaches three RPAD variants, the scalar entry taking each member in
    turn; the 16 x 22 members cycle R over 3, 8, 9, 16, 17, 22.  Complex
    matrices have uneven column degrees.  Every batched result is also
    held against the dense batched mode on the same matrices, bit for bit:
    the scattered low CCS columns equal A's own."""
    from repro_torch.core.stepspace import DEFAULT_GEOMETRY, Geometry
    rng = np.random.default_rng(SEED + 20)
    err = {k: 0.0 for k in ("ryser_sparse_scalar", "ryser_sparse_batched",
                            "ryser_sparse_complex_scalar",
                            "ryser_sparse_complex_batched")}
    worst_ulp, ok, equal, as_dense = 0.0, True, True, True
    rpads = []                          # (n, [[R, RPAD] per member]), real

    def hold(got, want, entry):
        nonlocal ok, worst_ulp, equal
        ok &= _agree(got, want, err, entry)
        equal &= bool(torch.equal(got, want))
        worst_ulp = max(worst_ulp, _ulp_gap(got.cpu().numpy(),
                                            want.cpu().numpy()))

    for cplx in (False, True):
        kind = "sparse_complex" if cplx else "sparse"
        scalar, batched, plain = _sparse_calls(cplx)
        for n in SPARSE_WINDOW_NS:
            geom = DEFAULT_GEOMETRY if n >= N_BUCKET else Geometry(8, 8, 4)
            TB, C, Wu, blocks = geom.kernel_geometry(n)
            nb = min(8, blocks)
            kw = int(math.log2(Wu))
            mats = [_uneven_sparse(rng, n, cplx, e) for e in (0, 2, n // 3)] \
                if cplx else [
                    _extent_sparse(rng, n, min(5, n), kw, 0, negzero=True),
                    _extent_sparse(rng, n, n // 2 + 1, kw, 2),
                    _extent_sparse(rng, n, n, kw, n // 3)]
            ins = _sparse_inputs(torch, mats, cplx)
            if not cplx:
                rpads.append((n, _rows_rpad(ins[1], Wu, n)))
            geo = dict(n=n, TB=TB, C=C, Wu=Wu, num_blocks=nb)
            for k, prec in enumerate(PRECISIONS):
                b = k % 3                       # each member in turn
                for base in sorted({0, blocks * TB - nb * TB}):
                    got = scalar(*(t[b] for t in ins), base, precision=prec,
                                 **geo)
                    want = plain(*(t[b:b + 1] for t in ins), base,
                                 precision=prec, **geo)[0]
                    hold(got, want, f"ryser_{kind}_scalar")
                got = batched(*ins, precision=prec, **geo)
                hold(got, plain(*ins, 0, precision=prec, **geo),
                     f"ryser_{kind}_batched")
                as_dense &= bool(torch.equal(got, _dense_batched_mode(
                    ins, cplx, precision=prec, **geo)))
            torch.cuda.synchronize()
        TB, C, Wu, blocks = DEFAULT_GEOMETRY.kernel_geometry(N_BUCKET)
        kw = int(math.log2(Wu))
        ins = _sparse_inputs(torch, [
            _circulant_sparse(rng, N_BUCKET, BUCKET_DEGREE, cplx, extra=b % 3)
            if cplx else _extent_sparse(rng, N_BUCKET, (3, 8, 9, 16, 17,
                                                        22)[b % 6], kw, b % 3,
                                        negzero=b % 6 == 0)
            for b in range(B_BUCKET)], cplx)
        if not cplx:
            rpads.append((N_BUCKET, _rows_rpad(ins[1], Wu, N_BUCKET)))
        geo = dict(n=N_BUCKET, TB=TB, C=C, Wu=Wu, num_blocks=blocks,
                   precision="dq_acc")
        got = batched(*ins, **geo)
        hold(got, plain(*ins, 0, **geo), f"ryser_{kind}_batched")
        as_dense &= bool(torch.equal(got, _dense_batched_mode(ins, cplx,
                                                              **geo)))
    print(f"sparse kernels vs plain: worst ulp gap {worst_ulp:g}, max abs "
          f"err {err}, bit for bit {equal}; equal to the dense batched "
          f"mode {as_dense}; real [R, RPAD] per n {rpads}")
    smoke.check(ok and equal, f"sparse kernels (real, complex) equal their "
                              f"plain versions bit for bit for n in "
                              f"{SPARSE_WINDOW_NS}, {len(PRECISIONS)} "
                              f"precisions, scalar windows incl. the top of "
                              f"the space, batched B=3 with uneven maxdeg, "
                              f"full grid {B_BUCKET} x n={N_BUCKET}")
    smoke.check(as_dense, f"sparse batched kernels (real, complex) equal "
                          f"the dense batched mode bit for bit on the same "
                          f"matrices (every window and the {B_BUCKET} x "
                          f"n={N_BUCKET} grid)")
    smoke.summary["kernel_vs_plain_sparse"] = {"worst_ulp": worst_ulp,
                                               "bit_for_bit": equal,
                                               "equals_dense_batched":
                                               as_dense, "rpads": rpads,
                                               **err}
    return err


def phase_main_path_sparse(smoke: Smoke, torch, cplx: bool) -> dict:
    """The sparse main path through the user entry points: ``permanent`` of
    a degree-7 n = 32 matrix (density 0.22) and ``permanent_batch`` of
    degree-5 buckets, counters 0 before each path and read right after.
    Only the sparse kernels may launch: plain 0, dense kernels 0."""
    import repro_torch
    from repro_torch.kernels import ryser_cuda as RC
    kind = "sparse_complex" if cplx else "sparse"
    label = "complex sparse" if cplx else "sparse"
    rng = np.random.default_rng(SEED + (31 if cplx else 21))
    A32 = _circulant_sparse(rng, N_SPARSE, SPARSE_DEGREE, cplx)
    bucket = np.stack([_circulant_sparse(rng, N_BUCKET, BUCKET_DEGREE, cplx)
                       for _ in range(B_BUCKET)])
    thru = np.stack([_circulant_sparse(rng, N_THRU, BUCKET_DEGREE, cplx)
                     for _ in range(B_THRU)])
    torch.cuda.synchronize()

    RC.reset_counters()
    t_scalar = []
    for _ in range(MAIN_REPS):
        t0 = time.perf_counter()
        v32, rep = repro_torch.permanent(A32, return_report=True)
        t_scalar.append(time.perf_counter() - t0)
    counts_scalar = dict(RC.counters)

    RC.reset_counters()
    vb, reps_b = repro_torch.permanent_batch(bucket, return_report=True)
    t_thru = []
    for _ in range(MAIN_REPS):
        t0 = time.perf_counter()
        vt, reps_t = repro_torch.permanent_batch(thru, return_report=True)
        t_thru.append(time.perf_counter() - t0)
    counts_batch = dict(RC.counters)

    print(f"{label} main path scalar: perm(A32) = {v32}, host seconds "
          f"{t_scalar} = {1 / min(t_scalar):.1f} perms/s (best), dispatch "
          f"{rep.dispatch}, counters {counts_scalar}")
    print(f"{label} main path buckets: {reps_b[0].dispatch}, "
          f"{reps_t[0].dispatch}; {B_THRU} x n={N_THRU} host seconds "
          f"{t_thru} = {B_THRU / min(t_thru):.1f} perms/s (best), counters "
          f"{counts_batch}")
    others = lambda c, k: sum(v for key, v in c.items() if key != k)  # noqa: E731
    smoke.check(counts_scalar[f"ryser_{kind}_scalar"] > 0
                and others(counts_scalar, f"ryser_{kind}_scalar") == 0
                and rep.dispatch == [f"sparse(n={N_SPARSE},cuda)"],
                f"{label} scalar main path launched ryser_{kind}_scalar "
                f"only (plain 0, dense kernels 0), dispatch {rep.dispatch}")
    smoke.check(counts_batch[f"ryser_{kind}_batched"] > 0
                and others(counts_batch, f"ryser_{kind}_batched") == 0
                and reps_b[0].dispatch == [
                    f"sparse_batch(n={N_BUCKET},b={B_BUCKET})"]
                and reps_t[0].dispatch == [
                    f"sparse_batch(n={N_THRU},b={B_THRU})"],
                f"{label} bucket main path launched ryser_{kind}_batched "
                f"only (plain 0, dense kernels 0), dispatch "
                f"{reps_b[0].dispatch}")
    smoke.check((isinstance(v32, complex) if cplx else isinstance(v32, float))
                and bool(np.isfinite(v32)) and vb.shape == (B_BUCKET,)
                and vt.shape == (B_THRU,) and bool(np.all(np.isfinite(vt))),
                f"{label} main-path values are finite of the expected type "
                f"and shape")
    smoke.summary[f"main_path_{kind}"] = {
        "perm_A32": [v32.real, v32.imag] if cplx else v32,
        "scalar_s": t_scalar, "thru_s": t_thru,
        "thru_perms_per_s": B_THRU / min(t_thru),
        "launches_scalar": counts_scalar, "launches_batch": counts_batch}
    return {"A32": A32, "v32": v32, "bucket": bucket, "vb": vb,
            "thru": thru, "cplx": cplx,
            "launches": {f"ryser_{kind}_scalar":
                         counts_scalar[f"ryser_{kind}_scalar"],
                         f"ryser_{kind}_batched":
                         counts_batch[f"ryser_{kind}_batched"]}}


def phase_values_sparse(smoke: Smoke, torch, mp: dict) -> None:
    """Values of the sparse route: Fibonacci n = 32 against F_33 (real
    only), the same n = 32 matrix through the dense kernel, the 16 x 22
    bucket against the torch sparse engine on the card, and a scalar leaf
    against its entry in a bucket whose maxdeg exceeds its own."""
    import repro_torch
    from repro_torch.kernels import ops
    cplx = mp["cplx"]
    label = "complex sparse" if cplx else "sparse"
    out = {}
    if not cplx:
        i, j = np.indices((N_SPARSE, N_SPARSE))
        fib = (np.abs(i - j) <= 1).astype(np.float64)
        got, rep = repro_torch.permanent(fib, preprocess=False,
                                         return_report=True)
        f = [1, 1]                                   # f[k] == F(k + 1)
        for _ in range(N_SPARSE):
            f.append(f[-1] + f[-2])
        rel = abs(got - f[N_SPARSE]) / f[N_SPARSE]
        print(f"fibonacci n={N_SPARSE}: {got!r} vs F_{N_SPARSE + 1} = "
              f"{f[N_SPARSE]}, rel {rel:.3e}, dispatch {rep.dispatch}")
        smoke.check(rel <= 1e-12 and rep.dispatch == [
            f"sparse(n={N_SPARSE},cuda)"],
            f"tridiagonal 0/1 n={N_SPARSE} on the sparse route = F_"
            f"{N_SPARSE + 1} within rel {rel:.3e} <= 1e-12")
        out["fibonacci_rel"] = rel
    dense = complex(ops.permanent_cuda(mp["A32"]))
    rel = abs(mp["v32"] - dense) / abs(dense)
    smoke.check(rel <= 1e-9, f"{label} n={N_SPARSE} sparse route vs the "
                             f"dense kernel rel {rel:.3e} <= 1e-9")
    out["vs_dense_kernel"] = rel
    ref = repro_torch.permanent_batch(mp["bucket"], backend="torch")
    rel = float(np.max(np.abs(mp["vb"] - ref) / np.abs(ref)))
    smoke.check(rel <= 1e-9, f"{label} bucket {B_BUCKET} x n={N_BUCKET} vs "
                             f"the torch sparse engine max rel {rel:.3e} "
                             f"<= 1e-9")
    out["bucket_vs_torch"] = rel
    if not cplx:
        rel = _vs_unordered(torch, mp)
        smoke.check(rel <= 1e-12, f"{label} n={N_SPARSE} and bucket "
                                  f"{B_BUCKET} x n={N_BUCKET} values vs the "
                                  f"kernel on the leaves as they come, not "
                                  f"ordered, max rel {rel:.3e} <= 1e-12")
        out["vs_unordered"] = rel
    rng = np.random.default_rng(SEED + (32 if cplx else 22))
    other = _circulant_sparse(rng, N_SPARSE, SPARSE_DEGREE, cplx, extra=2)
    vb = repro_torch.permanent_batch([mp["A32"], other], preprocess=False)
    same = bool(vb[0] == mp["v32"])
    smoke.check(same, f"{label} n={N_SPARSE} scalar leaf equals its entry "
                      f"in a bucket of larger maxdeg bit for bit "
                      f"({mp['v32']} vs {vb[0]})")
    out["scalar_vs_bucket_equal"] = same
    smoke.summary[f"values_{'sparse_complex' if cplx else 'sparse'}"] = out


def _vs_unordered(torch, mp: dict) -> float:
    """Max rel gap of the real sparse main path's values (n = 32 and the
    16 x 22 bucket) to the same kernel on the leaves as they come, not
    ordered (``order_sparse_leaves``): the ordering moves the values by
    rounding only.  Both are printed."""
    from repro_torch.core.stepspace import DEFAULT_GEOMETRY
    from repro_torch.kernels import ops
    worst = 0.0
    for mats, got in (([mp["A32"]], np.array([mp["v32"]])),
                      (list(mp["bucket"]), np.asarray(mp["vb"]))):
        n = mats[0].shape[-1]
        TB, C, Wu, blocks = DEFAULT_GEOMETRY.kernel_geometry(n)
        A_pads, rows, vals, xb_pads = _sparse_inputs(torch, mats, False)
        out = _sparse_calls(False)[1](A_pads, rows, vals, xb_pads, n=n,
                                      TB=TB, C=C, Wu=Wu, num_blocks=blocks,
                                      precision="dq_acc")
        xbs = ops.nw_base_vector(torch.as_tensor(np.stack(mats),
                                                 device="cuda"))
        want = ops._reduce_real(out, xbs, n).cpu().numpy()
        rel = np.abs(got - want) / np.abs(want)
        print(f"sparse n={n} values ordered vs as they come: "
              f"{[(float(a), float(b)) for a, b in zip(got[:4], want[:4])]}"
              f" max rel {float(rel.max()):.3e}")
        worst = max(worst, float(rel.max()))
    return worst


def _timed_inputs(torch, rng, entry: str, n: int, B: int):
    """(kernel call, plain call, input bytes, operation count, mode) of one
    kernel entry at a main-path shape.  An entry name may hold ``_f32``
    (f32 or complex64 input) and the real scalar one end in ``_schedmat``
    (the mode)."""
    from repro_torch.core.stepspace import DEFAULT_GEOMETRY
    from repro_torch.kernels import ops
    from repro_torch.kernels import ryser_complex_cuda as RX
    from repro_torch.kernels import ryser_cuda as RC
    from repro_torch.utils.roofline import complex_ryser_ops, ryser_ops
    TB, C, Wu, blocks = DEFAULT_GEOMETRY.kernel_geometry(n)
    geo = dict(n=n, TB=TB, C=C, Wu=Wu, num_blocks=blocks, precision="dq_acc")
    scalar = "_scalar" in entry
    single = "_f32" in entry
    if entry.startswith("ryser_complex"):
        As = torch.as_tensor(_cgauss(rng, (B, n, n)), device="cuda")
        if single:
            As = As.to(torch.complex64)
        planes = ops.prepare_complex(As)[:4]
        kern = (lambda: RX.ryser_cuda_call_complex(  # noqa: E731
            *(p[0] for p in planes), 0, **geo)) if scalar else \
            (lambda: RX.ryser_cuda_call_complex_batched(  # noqa: E731
                *planes, **geo))
        plain = lambda: RX.block_partials_plain_complex(  # noqa: E731
            *planes, 0, **geo)
        nbytes = planes[0].element_size() * (
            sum(p.numel() for p in planes) + 4 * B * blocks)
        return kern, plain, nbytes, B * complex_ryser_ops(n), "batched"
    mode = "schedmat" if entry.endswith("_schedmat") else \
        "baseline" if scalar else "batched"
    dt = torch.float32 if single else torch.float64
    As = torch.as_tensor(rng.uniform(-1, 1, (B, n, n)), device="cuda").to(dt)
    A_pads, xb_pads, _ = ops.prepare(As)
    kern = (lambda: RC.ryser_cuda_call(  # noqa: E731
        A_pads[0], xb_pads[0], 0, mode=mode, **geo)) if scalar else \
        (lambda: RC.ryser_cuda_call_batched(  # noqa: E731
            A_pads, xb_pads, mode=mode, **geo))
    plain = lambda: RC.block_partials_plain(  # noqa: E731
        A_pads, xb_pads, 0, mode=mode, **geo)
    nbytes = A_pads.element_size() * (A_pads.numel() + xb_pads.numel()
                                      + 2 * B * blocks)
    return kern, plain, nbytes, B * ryser_ops(n), mode


def _timed_inputs_sparse(torch, rng, entry: str, n: int, B: int):
    """(kernel call, plain call, input bytes, operation count, mode) of one
    sparse entry at a main-path shape: the scalar entry on a degree-7
    matrix, its plain version over the full grid in PLAIN_WINDOWS slices
    (one pass would hold tens of GB at n = 32); the batched entry on a
    degree-5 bucket.  Real inputs are ordered as the main path orders them
    (``ops.prepare_sparse``); their R and RPAD are printed.  Bytes count
    each input once (rows as int32) and the partials written; operations
    are what SpaRyser needs for these matrices' column degrees
    (``sparse_ryser_ops``)."""
    from repro_torch.core.stepspace import DEFAULT_GEOMETRY
    from repro_torch.utils.roofline import sparse_ryser_ops
    cplx = "complex" in entry
    scalar_call, batched_call, plain_call = _sparse_calls(cplx)
    TB, C, Wu, blocks = DEFAULT_GEOMETRY.kernel_geometry(n)
    geo = dict(n=n, TB=TB, C=C, Wu=Wu, precision="dq_acc")
    degree = SPARSE_DEGREE if B == 1 else BUCKET_DEGREE
    ins = _sparse_inputs(torch, [_circulant_sparse(rng, n, degree, cplx)
                                 for _ in range(B)], cplx, Wu,
                         single="_f32" in entry)
    if not cplx:
        rr = sorted({tuple(x) for x in _rows_rpad(ins[1], Wu, n)})
        print(f"{entry}: {B} x n={n} timed inputs, [R, RPAD] {rr}")
    if B == 1:
        step = blocks // PLAIN_WINDOWS
        kern = lambda: scalar_call(*(t[0] for t in ins), 0,  # noqa: E731
                                   num_blocks=blocks, **geo)
        plain = lambda: torch.cat([plain_call(  # noqa: E731
            *(t[:1] for t in ins), w * step * TB, num_blocks=step, **geo)
            for w in range(PLAIN_WINDOWS)], dim=1)
    else:
        kern = lambda: batched_call(*ins, num_blocks=blocks,  # noqa: E731
                                    **geo)
        plain = lambda: plain_call(*ins, 0, num_blocks=blocks,  # noqa: E731
                                   **geo)
    nbytes = sum(t.numel() * t.element_size() for t in ins) \
        + ins[0].element_size() * B * blocks * (4 if cplx else 2)
    ops_count = sparse_ryser_ops(ins[2 if cplx else 1].cpu().numpy(), n,
                                 cplx)
    return kern, plain, nbytes, ops_count, "batched"


def _dense_at_sparse_shape(smoke: Smoke, torch, msp: dict,
                           mspc: dict) -> dict:
    """The sparse scalar kernels and the dense kernels on the sparse main
    path's n = 32 matrices, as the main path prepares them, in one call
    (ms per call by CUDA events, beside which PERF.md puts them): the real
    dense entry in both modes, the dense complex entry.  Over this full
    grid each sparse kernel must equal the dense batched mode bit for
    bit."""
    from repro_torch.core.stepspace import DEFAULT_GEOMETRY
    from repro_torch.kernels import ryser_complex_cuda as RX
    from repro_torch.kernels import ryser_cuda as RC
    TB, C, Wu, blocks = DEFAULT_GEOMETRY.kernel_geometry(N_SPARSE)
    geo = dict(n=N_SPARSE, TB=TB, C=C, Wu=Wu, num_blocks=blocks,
               precision="dq_acc")
    out, same = {}, True
    for m, cplx in ((msp, False), (mspc, True)):
        ins = [t[0] for t in _sparse_inputs(torch, [m["A32"]], cplx, Wu)]
        kind = "sparse_complex" if cplx else "sparse"
        out[f"ryser_{kind}_scalar"], got = _time_ms(
            torch, lambda: _sparse_calls(cplx)[0](*ins, 0, **geo), reps=3)
        if cplx:
            out["ryser_complex_scalar"], want = _time_ms(
                torch, lambda: RX.ryser_cuda_call_complex(
                    ins[0], ins[1], ins[5], ins[6], 0, **geo), reps=3)
        else:
            for mode in ("baseline", "batched"):
                out[f"ryser_dense_scalar_{mode}"], want = _time_ms(
                    torch, lambda mode=mode: RC.ryser_cuda_call(
                        ins[0], ins[3], 0, mode=mode, **geo), reps=3)
        same &= bool(torch.equal(got, want))
    print(f"sparse and dense kernels at the sparse shape n={N_SPARSE} (ms): "
          f"{out}; sparse == dense batched mode over the full grid: {same}")
    smoke.check(same, f"sparse scalar kernels (real, complex) equal the "
                      f"dense batched mode bit for bit over the full n="
                      f"{N_SPARSE} grid of the main path's matrices")
    out["equals_dense_batched"] = same
    return out


# (entry, n, B, TPU kernel it replaces, source) of the timed entries: the
# eight of the main paths, then kernel #1's schedmat mode and the f32
# entries of #1-#8 (the entry-parity path; #3/#4 and #7/#8 on complex64)
_SP = "src/repro/kernels/ryser_sparse.py"
_RP = "src/repro/kernels/ryser_pallas.py"
TIMED = (
    ("ryser_dense_scalar", N_MAIN, 1, f"{_RP}:305", "ryser_dense.cu"),
    ("ryser_dense_batched", N_THRU, B_THRU, f"{_RP}:342", "ryser_dense.cu"),
    ("ryser_complex_scalar", N_MAIN, 1,
     "src/repro/kernels/ryser_complex.py:181", "ryser_complex.cu"),
    ("ryser_complex_batched", N_THRU, B_THRU,
     "src/repro/kernels/ryser_complex.py:216", "ryser_complex.cu"),
    ("ryser_sparse_scalar", N_SPARSE, 1, f"{_SP}:331", "ryser_sparse.cu"),
    ("ryser_sparse_batched", N_THRU, B_THRU, f"{_SP}:367", "ryser_sparse.cu"),
    ("ryser_sparse_complex_scalar", N_SPARSE, 1, f"{_SP}:400",
     "ryser_sparse.cu"),
    ("ryser_sparse_complex_batched", N_THRU, B_THRU, f"{_SP}:436",
     "ryser_sparse.cu"),
    ("ryser_dense_scalar_schedmat", N_MAIN, 1, f"{_RP}:305",
     "ryser_dense.cu"),
    ("ryser_dense_scalar_f32", N_MAIN, 1, f"{_RP}:305", "ryser_dense.cu"),
    ("ryser_dense_scalar_f32_schedmat", N_MAIN, 1, f"{_RP}:305",
     "ryser_dense.cu"),
    ("ryser_dense_batched_f32", N_THRU, B_THRU, f"{_RP}:342",
     "ryser_dense.cu"),
    ("ryser_complex_scalar_f32", N_MAIN, 1,
     "src/repro/kernels/ryser_complex.py:181", "ryser_complex.cu"),
    ("ryser_complex_batched_f32", N_THRU, B_THRU,
     "src/repro/kernels/ryser_complex.py:216", "ryser_complex.cu"),
    ("ryser_sparse_scalar_f32", N_SPARSE, 1, f"{_SP}:331", "ryser_sparse.cu"),
    ("ryser_sparse_batched_f32", N_THRU, B_THRU, f"{_SP}:367",
     "ryser_sparse.cu"),
    ("ryser_sparse_complex_scalar_f32", N_SPARSE, 1, f"{_SP}:400",
     "ryser_sparse.cu"),
    ("ryser_sparse_complex_batched_f32", N_THRU, B_THRU, f"{_SP}:436",
     "ryser_sparse.cu"))
ROUNDS, REPS = 3, 5


def _clocks() -> dict:
    """SM clock (MHz), power draw (W) and temperature (C) of card 0."""
    q = subprocess.run(["nvidia-smi", "-i", "0",
                        "--query-gpu=clocks.sm,power.draw,temperature.gpu",
                        "--format=csv,noheader,nounits"],
                       capture_output=True, text=True, timeout=60)
    vals = q.stdout.strip().split(",") if q.returncode == 0 else []
    try:
        sm, power, temp = (float(v) for v in vals)
    except ValueError:
        return {}
    return {"sm_mhz": sm, "power_w": power, "temp_c": temp}


def _time_rounds(torch, kernels: dict) -> dict:
    """Each kernel of ``kernels`` (name -> call) warmed up once, then timed
    in ROUNDS rounds taken in turns (every kernel once a round), each window
    REPS calls by CUDA events, with the card's clocks read just before and
    just after it.  Per kernel: the per-round ms, their median and spread
    ((max - min) / median), the clocks of each window, the last result."""
    for fn in kernels.values():
        fn()
    torch.cuda.synchronize()
    out = {k: {"rounds_ms": [], "clocks": []} for k in kernels}
    for _ in range(ROUNDS):
        for name, fn in kernels.items():
            before = _clocks()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(REPS):
                got = fn()
            end.record()
            torch.cuda.synchronize()
            out[name]["rounds_ms"].append(start.elapsed_time(end) / REPS)
            out[name]["clocks"].append([before, _clocks()])
            out[name]["got"] = got
    for t in out.values():
        ms = sorted(t["rounds_ms"])
        t["ms"] = ms[len(ms) // 2]
        t["spread"] = (ms[-1] - ms[0]) / t["ms"]
    return out


def _print_rounds(timed: dict, bounds: dict) -> None:
    for name, t in timed.items():
        sm = [c.get("sm_mhz") for w in t["clocks"] for c in w]
        temp = [c.get("temp_c") for w in t["clocks"] for c in w]
        power = [c.get("power_w") for w in t["clocks"] for c in w]
        print(f"{name}: median {t['ms']:.4f} ms, spread {t['spread']:.4f}, "
              f"rounds {[round(v, 4) for v in t['rounds_ms']]}, "
              f"{t['ms'] / bounds[name]:.2f}x the bound "
              f"{bounds[name]:.4f} ms; sm MHz {sm}, W {power}, C {temp}")


def _timed_entries(torch, card: dict) -> dict:
    """name -> (kernel call, plain call, bound ms, bound_by, n, B, mode) of
    the timed entries at the main path's shapes, inputs from one seed; an
    f32 entry's operations go over the FP32 rate."""
    from repro_torch.utils.roofline import detect_hw
    hw = detect_hw(card["name"])
    fp64, fp32, bw = hw.fp64_flops, hw.fp32_flops, hw.mem_bw
    rng = np.random.default_rng(SEED + 3)
    entries = {}
    for entry, n, B, _replaces, _source in TIMED:
        kern, plain, nbytes, ops_count, mode = (
            _timed_inputs_sparse if "sparse" in entry else _timed_inputs)(
            torch, rng, entry, n, B)
        rate = fp32 if "_f32" in entry else fp64
        t_ops, t_bytes = ops_count / (rate / 2) * 1e3, nbytes / bw * 1e3
        entries[entry] = (kern, plain, max(t_ops, t_bytes),
                          "operations" if t_ops >= t_bytes else "bytes", n,
                          B, mode)
    print(f"bounds from {hw.name}: FP64 {fp64 / 1e12:g} TFLOP/s / 2, FP32 "
          f"{fp32 / 1e12:g} TFLOP/s / 2, {bw / 1e12:g} TB/s")
    return entries


def phase_timing(smoke: Smoke, torch, card: dict, launches: dict,
                 window_err: dict) -> list:
    """Kernel, plain and bound at the main path's shapes.  The kernels are
    timed first, in rounds taken in turns (``_time_rounds``), before any
    plain pass heats the card; then each kernel's last result is held
    against its plain version over the full grid of the timed shape, bit
    for bit."""
    from repro_torch.core.stepspace import DEFAULT_GEOMETRY
    entries = _timed_entries(torch, card)
    timed = _time_rounds(torch, {k: e[0] for k, e in entries.items()})
    _print_rounds(timed, {k: e[2] for k, e in entries.items()})
    full_err = {}
    rows = []
    for entry, n, B, replaces, source in TIMED:
        _kern, plain, bound, bound_by, _n, _B, mode = entries.pop(entry)
        blocks = DEFAULT_GEOMETRY.kernel_geometry(n)[3]
        got = timed[entry].pop("got")
        plain_ms, want = _time_ms(torch, plain, reps=1)
        if "_scalar" in entry:
            want = want[0]
        full_err[entry] = 0.0
        dtype = str(got.dtype).replace("torch.", "")
        ok = _agree(got, want, full_err, entry)
        ok &= bool(torch.equal(got, want))
        smoke.check(ok, f"{entry} equals its plain version bit for bit over "
                        f"the full grid of {B} x n={n} ({blocks} blocks, "
                        f"{mode}, dq_acc, {dtype}): max abs err "
                        f"{full_err[entry]:g}")
        del plain, got, want
        torch.cuda.empty_cache()
        ms = timed[entry]["ms"]
        rows.append({
            "name": entry, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": replaces, "launches": launches[entry],
            "max_abs_err": max(full_err[entry], window_err[entry]),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": bound_by, "library_ms": None})
        print(f"{entry}: {B} x n={n} {mode} dq_acc {dtype}: kernel "
              f"{ms:.4f} ms "
              f"(median of {ROUNDS}), plain {plain_ms:.2f} ms, bound "
              f"{bound:.4f} ms, {ms / bound:.2f}x the bound")
    smoke.summary["kernel_vs_plain_full_grid"] = full_err
    smoke.summary["timing_rounds"] = timed
    return rows


def _main_calls(mp: dict, mpc: dict, msp: dict, mspc: dict) -> list:
    """(label, batched, data) of the main-path calls the profile and the
    host split read: dense n = 30, sparse n = 32 and both 256 x n = 24
    buckets, real and complex."""
    dense = (("", mp), ("complex ", mpc))
    sparse = (("sparse ", msp), ("complex sparse ", mspc))
    return [(f"{kind}permanent n={N_MAIN}", False, m["A30"])
            for kind, m in dense] + \
        [(f"{kind}permanent n={N_SPARSE}", False, m["A32"])
         for kind, m in sparse] + \
        [(f"{kind}permanent_batch {B_THRU} x n={N_THRU}", True, m["thru"])
         for kind, m in dense + sparse]


def phase_host_split(smoke: Smoke, torch, calls: list) -> None:
    """Host seconds of each main-path call split into planning
    (``plan``/``plan_batch``: DM/FM, routing, buckets) and execution, with
    the executor's per-site wall times (``ExecStats.timings``: stacking,
    transfer, kernel, reduce and copy back of one dispatch site).  A fresh
    solver per call, so no result-cache hit."""
    from repro_torch.core.solver import PermanentSolver
    out = {}
    for label, batched, data in calls:
        runs = []
        for _ in range(MAIN_REPS):
            solver = PermanentSolver()
            t0 = time.perf_counter()
            plan = solver.plan_batch(data) if batched else solver.plan(data)
            t1 = time.perf_counter()
            solver.execute(plan)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            runs.append({"plan_s": t1 - t0, "execute_s": t2 - t1,
                         "sites_s": {k: t["total_s"] for k, t in
                                     solver.stats()["leaf_timings"].items()}})
        out[label] = runs
        print(f"host split {label}: " + "; ".join(
            f"plan {r['plan_s'] * 1e3:.2f} ms, execute "
            f"{r['execute_s'] * 1e3:.2f} ms "
            f"{ {k: round(v * 1e3, 2) for k, v in r['sites_s'].items()} }"
            for r in runs))
    smoke.summary["host_split"] = out


def phase_profile(smoke: Smoke, torch, calls: list) -> None:
    """Device busy share of each main-path call (kernel time over wall
    time, the profiler's own overhead included in the wall time), and
    device time by kernel name, from torch.profiler (CUPTI)."""
    import repro_torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for label, batched, data in calls:
        call = repro_torch.permanent_batch if batched else repro_torch.permanent
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            call(data)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        by_name = {}                 # device-side (kernel) events only
        for ev in prof.key_averages():
            if ev.device_type == DeviceType.CUDA:
                by_name[ev.key] = by_name.get(ev.key, 0.0) + \
                    ev.self_device_time_total
        busy = sum(by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
        share = busy / wall_us if busy > 0 else None
        out[label] = {"wall_us": wall_us, "device_us": busy,
                      "busy_share": share, "top": top}
        print(f"profile {label}: wall {wall_us:.0f} us, device "
              f"{busy:.0f} us, busy share "
              f"{'not measured' if share is None else f'{share:.3f}'}; "
              f"top {[(k[:40], round(v)) for k, v in top]}")
    smoke.summary["profile"] = out


# ---------------------------------------------------------------------------
# The campaign route: checkpointed waves of slices for n >= 31
# ---------------------------------------------------------------------------

def _bits_equal(torch, got, want, err: dict, entry: str) -> bool:
    """Kernel partials equal their plain version bit for bit; the largest
    absolute gap is kept per entry."""
    g, w = got.cpu().numpy(), want.cpu().numpy()
    err[entry] = max(err.get(entry, 0.0), float(np.max(np.abs(g - w))))
    return bool(torch.equal(got, want)) and bool(np.all(np.isfinite(g)))


def _campaign_large_bases(smoke: Smoke, torch) -> dict:
    """Each scalar entry (the dense one in both modes, the complex one and
    the two sparse ones) at n in LARGE_BASE_NS from chunk bases at the end
    of the 2^(n-1) step space and around 2^(n-2), 2 blocks of TB 32, C 64,
    Wu 16, two precisions: bit for bit with its plain version.  The
    campaign main path runs these entries from such bases; the main paths
    of the other phases never go past 2^31."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ryser_complex_cuda as RX
    from repro_torch.kernels import ryser_cuda as RC
    rng = np.random.default_rng(SEED + 40)
    TB, C, Wu, nb = 32, 64, 16, 2
    err: dict = {}
    ok, runs = True, 0
    for n in LARGE_BASE_NS:
        chunks = (1 << (n - 1)) // C
        geo = dict(n=n, TB=TB, C=C, Wu=Wu, num_blocks=nb)
        A = torch.as_tensor(rng.uniform(-1, 1, (1, n, n)) / 2,
                            device="cuda")
        A_pads, xb_pads, _ = ops.prepare(A)
        cx = ops.prepare_complex(torch.as_tensor(_cgauss(rng, (1, n, n)) / 2,
                                                 device="cuda"))[:4]
        sp = _sparse_inputs(torch, [_extent_sparse(
            rng, n, n // 2 + 1, int(math.log2(Wu)), 2)], False, Wu)
        spx = _sparse_inputs(torch, [_uneven_sparse(rng, n, True, 3)], True)
        for prec in ("dq_acc", "dd"):
            for base in (chunks - nb * TB, chunks // 2 - nb * TB // 2):
                kw = dict(precision=prec, **geo)
                for mode in ("baseline", "batched"):
                    ok &= _bits_equal(torch, RC.ryser_cuda_call(
                        A_pads[0], xb_pads[0], base, mode=mode, **kw),
                        RC.block_partials_plain(A_pads, xb_pads, base,
                                                mode=mode, **kw)[0],
                        err, "ryser_dense_scalar")
                ok &= _bits_equal(torch, RX.ryser_cuda_call_complex(
                    *(p[0] for p in cx), base, **kw),
                    RX.block_partials_plain_complex(*cx, base, **kw)[0],
                    err, "ryser_complex_scalar")
                for cplx, ins in ((False, sp), (True, spx)):
                    scalar, _batched, plain = _sparse_calls(cplx)
                    ok &= _bits_equal(
                        torch, scalar(*(t[0] for t in ins), base, **kw),
                        plain(*ins, base, **kw)[0], err,
                        f"ryser_{'sparse_complex' if cplx else 'sparse'}"
                        "_scalar")
                runs += 5
        torch.cuda.synchronize()
    print(f"campaign large bases: {runs} launches at n in {LARGE_BASE_NS}, "
          f"max abs err {err}")
    smoke.check(ok, f"scalar entries (dense both modes, complex, sparse "
                    f"real and complex) from chunk bases at the end of the "
                    f"space and around 2^(n-2), n in {LARGE_BASE_NS}, equal "
                    f"their plain versions bit for bit")
    return {"bit_for_bit": ok, **err}


def _campaign_wave_body(smoke: Smoke, torch) -> dict:
    """The wave body at the main paths' own lane count, TB = 128 (C = 2^10
    and 256 chunks a slice, so two slices are four CTAs): kernel #1 in
    batched mode at n = N_CAMPAIGN and #3 at n = N_CAMPAIGN_CX, f64 and
    (their ``_f32`` entries) f32 / complex64, from the first two slices,
    the middle and the last two of the space, equal their plain versions
    bit for bit, and so do ``campaign_slice_sums``'s per-slice sums."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ryser_complex_cuda as RX
    from repro_torch.kernels import ryser_cuda as RC
    rng = np.random.default_rng(SEED + 44)
    cps, C, Wu, TB = 256, 1 << 10, 16, 128
    ok, err = True, {}
    cases = [(n, cplx, single) for single in (False, True)
             for n, cplx in ((N_CAMPAIGN, False), (N_CAMPAIGN_CX, True))]
    launched = {}
    for n, cplx, single in cases:
        A = _cgauss(rng, (n, n)) / 2 if cplx \
            else rng.uniform(-1, 1, (n, n)) / 2
        dt = (torch.complex64 if cplx else torch.float32) if single \
            else None
        A = torch.as_tensor(A, device="cuda", dtype=dt)
        geo = dict(n=n, TB=TB, C=C, Wu=Wu, num_blocks=2 * cps // TB)
        slices = (1 << (n - 1)) // C // cps
        name = ("ryser_complex_scalar" if cplx else "ryser_dense_scalar") \
            + ("_f32" if single else "")
        before = RC.counters[name]
        for first in (0, slices // 2 - 1, slices - 2):
            base = first * cps
            hi, lo = ops.campaign_slice_sums(
                A, first, 2, chunks_per_slice=cps, chunk_size=C,
                device=A.device)
            if cplx:
                ins = ops.prepare_complex(A[None])[:4]
                got = RX.ryser_cuda_call_complex(*(t[0] for t in ins), base,
                                                 **geo)
                plain = RX.block_partials_plain_complex(*ins, base, **geo)[0]
                re = ops._slice_sums(plain[:, 0], plain[:, 1], 2)
                im = ops._slice_sums(plain[:, 2], plain[:, 3], 2)
                want = (torch.complex(re[0], im[0]),
                        torch.complex(re[1], im[1]))
            else:
                A_pads, xb_pads, _ = ops.prepare(A[None])
                got = RC.ryser_cuda_call(A_pads[0], xb_pads[0], base,
                                         mode="batched", **geo)
                plain = RC.block_partials_plain(A_pads, xb_pads, base,
                                                mode="batched", **geo)[0]
                want = ops._slice_sums(plain[:, 0], plain[:, 1], 2)
            ok &= _bits_equal(torch, got, plain, err, name)
            ok &= bool(torch.equal(hi, want[0]) and torch.equal(lo, want[1]))
            ok &= hi.dtype == A.dtype
        # campaign_slice_sums launched the entry of A's dtype each time
        launched[name] = RC.counters[name] - before
    torch.cuda.synchronize()
    print(f"campaign wave body at TB={TB}, C={C}, {cps} chunks a slice: "
          f"max abs err {err}; launches {launched}")
    smoke.check(ok and min(launched.values()) >= 6,
                f"wave body at the main paths' TB={TB}: kernels #1 "
                f"(n={N_CAMPAIGN}) and #3 (n={N_CAMPAIGN_CX}), f64 and the "
                f"_f32 entries, and their per-slice sums equal the plain "
                f"versions bit for bit from the start, middle and end of "
                f"the space, in the input's dtype ({launched})")
    return {"bit_for_bit": ok, **err, "launches": launched,
            "f32_wave_width": _f32_wave_width(torch)}


def _f32_wave_width(torch) -> dict:
    """The wave width ``run_campaign`` takes for f32 input comes from the
    occupancy query of the f64 instantiation.  Time one f32 wave of that
    width W against 2W (and an f64 wave of W, the width's own case) at
    n = CAMPAIGN_KILL_N (the same NPAD 40 instantiation as n = 40, a
    sixteenth of its time) from the default spec: 2W near twice W's time
    means W already filled the card; near W's time, W left it half
    idle."""
    from repro_torch.core import distributed as Dm
    from repro_torch.core.stepspace import plan_slices
    from repro_torch.kernels import ops
    n = CAMPAIGN_KILL_N
    ts, cps, C = plan_slices(n, 1024, 1, 1024)
    A = np.random.default_rng(SEED + 45).uniform(-1, 1, (n, n)) / 2
    out = {"n": n}
    for label, X in (("f64", A), ("f32", A.astype(np.float32))):
        W = Dm.default_wave_width(X, pending=ts, chunks_per_slice=cps,
                                  chunk_size=C)
        T = torch.as_tensor(X, device="cuda")
        for k in (1, 2):
            ms, _ = _time_ms(torch, lambda: ops.campaign_slice_sums(
                T, 0, k * W, chunks_per_slice=cps, chunk_size=C), 3)
            out[f"{label}_{k}W_ms"] = ms
        out[f"{label}_W"] = W
        out[f"{label}_2W_over_W"] = out[f"{label}_2W_ms"] / out[f"{label}_1W_ms"]
    print(f"f32 wave width from the f64 occupancy query: {out}")
    return out


def _campaign_refusals(smoke: Smoke, torch) -> dict:
    """The window count is 64-bit, so no C is refused for its windows; a C
    past the step space, and a chunk range past it, are refused by the
    Python wrappers (ValueError) and by every scalar C entry (rc
    cudaErrorInvalidValue = 1, before any launch)."""
    from repro_torch.kernels import build
    from repro_torch.kernels import ryser_cuda as RC
    lib = build.load_library()
    buf = torch.zeros(64 * 64 * 4, dtype=torch.float64, device="cuda")
    p = buf.data_ptr()
    s = torch.cuda.current_stream().cuda_stream
    n, TB = 40, 32

    def entries(base, C_log2):
        # (name, call) of the four scalar C entries at (base, C_log2)
        g = (n, 40, TB, C_log2, 4, 1, 2)           # n n_pad TB C Wu blk prec
        return (("ryser_dense_scalar", lambda: lib.ryser_dense_scalar(
                    p, p, p, p, base, *g, 1, s)),
                ("ryser_complex_scalar", lambda: lib.ryser_complex_scalar(
                    p, p, p, p, p, p, base, *g, s)),
                ("ryser_sparse_scalar", lambda: lib.ryser_sparse_scalar(
                    p, p, p, p, p, p, base, n, 40, 4, *g[2:], s)),
                ("ryser_sparse_complex_scalar",
                 lambda: lib.ryser_sparse_complex_scalar(
                     p, p, p, p, p, p, p, p, p, base, n, 40, 4, *g[2:], s)))

    space_chunks = (1 << (n - 1)) >> 6              # at C = 2^6
    rcs = {}
    for label, base, C_log2 in (("C past the space", 0, n),
                                ("range past the space",
                                 space_chunks - TB + 1, 6),
                                ("base 2^63", 1 << 63, 6)):
        rcs[label] = {name: call() for name, call in entries(base, C_log2)}
    torch.cuda.synchronize()
    py = []
    A_pad = torch.zeros((40, 40), dtype=torch.float64, device="cuda")
    xb = torch.ones((40, 1), dtype=torch.float64, device="cuda")
    for kw in (dict(dev_chunk_base=0, C=1 << n),
               dict(dev_chunk_base=space_chunks - TB + 1, C=64)):
        try:
            RC.ryser_cuda_call(A_pad, xb, kw["dev_chunk_base"], n=n, TB=TB,
                               C=kw["C"], Wu=16, num_blocks=1)
            py.append("launched")
        except ValueError as e:
            py.append(str(e))
    print(f"campaign refusals: C entries {rcs}; wrappers {py}")
    ok = all(rc == 1 for r in rcs.values() for rc in r.values()) and \
        all("step space" in m for m in py)
    smoke.check(ok, "a chunk size past the step space and a chunk range "
                    "past it are refused by the wrappers and by the four "
                    "scalar C entries")
    return {"c_entries": rcs, "wrappers": py}


def _profiled(torch, fn):
    """(result, wall s, device s) of ``fn()`` under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = sum(ev.self_device_time_total for ev in prof.key_averages()
              if ev.device_type == DeviceType.CUDA) / 1e6
    return out, wall, dev


def _rank_one(rng, n: int, cplx: bool):
    """D1 J D2 with random diagonals (positive reals, or moduli in
    [0.5, 1.5] with phases within 0.3 rad) and its permanent
    n! prod(d1) prod(d2)."""
    def diag():
        d = rng.uniform(0.5, 1.5, n)
        return d * np.exp(1j * rng.uniform(-0.3, 0.3, n)) if cplx else d
    d1, d2 = diag(), diag()
    return np.outer(d1, d2), math.factorial(n) * np.prod(d1) * np.prod(d2)


def _derangement_plus_identity(rng, n: int):
    """I + P for a random derangement P, and its permanent: 2 to the
    number of P's cycles (each cycle's rows admit exactly two matchings).
    Entries, row sums and the Ryser terms are all small integers."""
    while True:
        p = rng.permutation(n)
        if np.all(p != np.arange(n)):
            break
    A = np.eye(n)
    A[np.arange(n), p] += 1.0
    seen, cycles = np.zeros(n, dtype=bool), 0
    for i in range(n):
        if not seen[i]:
            cycles += 1
            while not seen[i]:
                seen[i], i = True, p[i]
    return A, 2.0 ** cycles


def _campaign_main_path(smoke: Smoke, torch, card: dict) -> tuple:
    """The campaign main paths through ``repro_torch.permanent`` at the
    default config: all-ones n = 40 (real; routes to step_sharded by
    itself) and a complex Gaussian n = 32, counters 0 before each and
    read right after; rank-one D1 J D2 at both and I + P at n = 40
    against their closed forms; then the n = 40 job again through a solver
    with a checkpoint, for each wave's width, kernel, host and save times.
    Gates: the value bars above, the campaign tag, only the campaign's
    kernel launched."""
    import repro_torch
    from repro_torch.core.oracle import all_ones_permanent
    from repro_torch.core.solver import PermanentSolver, SolverConfig
    from repro_torch.kernels import ryser_cuda as RC
    from repro_torch.utils.roofline import detect_hw
    fp64 = detect_hw(card["name"]).fp64_flops
    n = N_CAMPAIGN
    J = np.ones((n, n))
    exact = all_ones_permanent(n)
    RC.reset_counters()
    (v, rep), wall, dev = _profiled(
        torch, lambda: repro_torch.permanent(J, return_report=True))
    counts = dict(RC.counters)
    rel = abs(v - exact) / exact
    bound = 2.0 * n * 2.0 ** (n - 1) / (fp64 / 2)
    free = counts[RC.FREE_ROWS_COUNTER]
    others = sum(c for k, c in counts.items()
                 if k not in ("ryser_dense_scalar", RC.FREE_ROWS_COUNTER))
    print(f"campaign n={n} all-ones: {v:+.17e} exact {exact:+.17e} rel.err "
          f"{rel:.3e}, dispatch {rep.dispatch}, host {wall:.4f} s, device "
          f"{dev:.4f} s, busy share {dev / wall:.3f}, "
          f"{2.0 ** (n - 1) / wall:.4e} Gray steps/s, bound {bound:.4f} s "
          f"({wall / bound:.2f}x), counters {counts}")
    smoke.check(rel <= ONES_BAR and rep.dispatch == [f"campaign(n={n},cuda)"]
                and counts["ryser_dense_scalar"] > 0 and others == 0
                and free == counts["ryser_dense_scalar"],
                f"all-ones n={n} through permanent() at the default config "
                f"runs the campaign route on ryser_dense_scalar only, every "
                f"wave with branch-free rows ({rep.dispatch}, {free} "
                f"{RC.FREE_ROWS_COUNTER}), rel.err {rel:.3e} <= "
                f"{ONES_BAR:g}")
    out = {"n": n, "value": v, "rel_err": rel, "dispatch": rep.dispatch,
           "wall_s": wall, "device_s": dev, "busy_share": dev / wall,
           "gray_steps_per_s": 2.0 ** (n - 1) / wall, "bound_s": bound,
           "x_bound": wall / bound, "launches": counts}

    rng = np.random.default_rng(SEED + 41)
    rank1 = {}
    for m, cplx in ((n, False), (N_CAMPAIGN_CX, True)):
        R, want = _rank_one(rng, m, cplx)
        got, r = repro_torch.permanent(R, return_report=True)
        kind = "complex" if cplx else "real"
        rank1[f"{kind}_n{m}"] = e = abs(got - want) / abs(want)
        print(f"campaign rank-one D1 J D2 n={m} {kind}: {got} closed form "
              f"{want}, rel {e:.3e}, {r.dispatch}")
        smoke.check(e <= RANK1_BAR[cplx] and r.dispatch == [
            f"campaign(n={m},cuda)"], f"{kind} D1 J D2 n={m} campaign vs "
            f"n! prod(d1) prod(d2): rel {e:.3e} <= {RANK1_BAR[cplx]:g}")
        if cplx:
            continue
        # the same matrix at a 16x smaller and a 16x larger chunk: the
        # error follows the Gray steps a row sum runs without a restart
        for label, kw in (("C=2^15", dict(campaign_lanes=1 << 14)),
                          ("C=2^23", dict(campaign_slices=64))):
            other = PermanentSolver(cache=False, **kw)
            g = other.execute(other.plan(R))
            rank1[f"real_n{m}_{label}"] = abs(g - want) / abs(want)
        print(f"campaign rank-one D1 J D2 n={m} real by chunk size: "
              f"{ {k: f'{x:.3e}' for k, x in rank1.items() if 'real' in k} }")
    P, want = _derangement_plus_identity(rng, n)
    exact_solver = PermanentSolver(preprocess=False, cache=False)
    got, r = exact_solver.execute(exact_solver.plan(P), return_report=True)
    print(f"campaign I + P n={n}: {got!r} exact {want!r}, {r.dispatch}")
    smoke.check(got == want and r.dispatch == [f"campaign(n={n},cuda)"],
                f"I + P n={n} (P a derangement) campaign == 2^cycles = "
                f"{want:g} exactly ({got!r})")
    out.update(rank_one_rel=rank1, i_plus_p={"value": got, "exact": want})

    waves = []
    with tempfile.TemporaryDirectory() as tmp:
        solver = PermanentSolver(SolverConfig(
            campaign_checkpoint=os.path.join(tmp, "j40.npz")))
        solver.campaign_progress = lambda st, w: waves.append(
            {"ids": w.ids_text(), "W": w.width, "launches": w.launches,
             "kernel_ms": w.kernel_s * 1e3, "host_ms": w.host_s * 1e3,
             "save_ms": w.save_s * 1e3})
        t0 = time.perf_counter()
        v2 = solver.execute(solver.plan(J))
        wall2 = time.perf_counter() - t0
    for w in waves:
        print(f"  campaign n={n} wave {w}")
    # a kill loses at most the wave in flight: its host time and its save
    lost = max(w["host_ms"] + w["save_ms"] for w in waves) / 1e3
    print(f"campaign n={n} checkpointed: {len(waves)} waves, {wall2:.4f} s, "
          f"at most {lost:.4f} s lost to a kill")
    smoke.check(v2 == v and len(waves) >= 8,
                f"n={n} through a checkpointing solver: {len(waves)} waves "
                f"(>= 8), the same bits as permanent() ({v2!r})")
    out.update(waves=waves, checkpointed_wall_s=wall2, kill_loss_s=lost)

    Z = _cgauss(rng, (N_CAMPAIGN_CX, N_CAMPAIGN_CX))
    RC.reset_counters()
    (vz, repz), wallz, devz = _profiled(
        torch, lambda: repro_torch.permanent(Z, return_report=True))
    counts_z = dict(RC.counters)
    direct_solver = PermanentSolver(campaign_threshold=None, cache=False)
    direct = direct_solver.execute(direct_solver.plan(Z))
    relz = abs(vz - direct) / abs(direct)
    others = sum(c for k, c in counts_z.items()
                 if k != "ryser_complex_scalar")
    print(f"campaign complex n={N_CAMPAIGN_CX}: {vz} vs direct {direct}, "
          f"rel {relz:.3e}, dispatch {repz.dispatch}, host {wallz:.4f} s, "
          f"busy share {devz / wallz:.3f}, counters {counts_z}")
    smoke.check(relz <= CX_DIRECT_BAR and repz.dispatch == [
        f"campaign(n={N_CAMPAIGN_CX},cuda)"]
        and counts_z["ryser_complex_scalar"] > 0 and others == 0,
        f"complex n={N_CAMPAIGN_CX} through permanent() runs the campaign "
        f"route on ryser_complex_scalar only, rel {relz:.3e} <= "
        f"{CX_DIRECT_BAR:g} to the direct kernel")
    out["complex"] = {"n": N_CAMPAIGN_CX, "value": [vz.real, vz.imag],
                      "vs_direct": relz, "wall_s": wallz, "device_s": devz,
                      "busy_share": devz / wallz, "launches": counts_z}
    ones = {}
    for m in CAMPAIGN_ONES:
        if m == n:
            ones[m] = rel
            continue
        got, r = repro_torch.permanent(np.ones((m, m)), return_report=True)
        ones[m] = abs(got - all_ones_permanent(m)) / all_ones_permanent(m)
        smoke.check(ones[m] <= ONES_BAR and r.dispatch == [
            f"campaign(n={m},cuda)"], f"all-ones n={m} campaign rel.err "
                                      f"{ones[m]:.3e} <= {ONES_BAR:g}")
    out["allones_rel"] = ones
    return out, {"ryser_dense_scalar": counts["ryser_dense_scalar"],
                 "ryser_complex_scalar": counts_z["ryser_complex_scalar"]}


def _campaign_vs_direct(smoke: Smoke, torch) -> dict:
    """n = 30 real and n = 28 complex, forced to campaign
    (``campaign_threshold=-1``) and at the default config (the direct
    scalar kernel): values within rel 1e-12."""
    from repro_torch.core.solver import PermanentSolver
    rng = np.random.default_rng(SEED + 42)
    out = {}
    for n, A in ((N_MAIN, rng.uniform(-1, 1, (N_MAIN, N_MAIN))),
                 (28, _cgauss(rng, (28, 28)))):
        vals = {}
        for label, thr in (("campaign", -1.0), ("direct", 2.0 ** 34)):
            s = PermanentSolver(campaign_threshold=thr, cache=False)
            vals[label], rep = s.execute(s.plan(A), return_report=True)
            vals[label + "_tag"] = rep.dispatch
        rel = abs(vals["campaign"] - vals["direct"]) / abs(vals["direct"])
        kind = "complex" if np.iscomplexobj(A) else "real"
        print(f"campaign vs direct {kind} n={n}: {vals}, rel {rel:.3e}")
        smoke.check(rel <= 1e-12 and vals["campaign_tag"] == [
            f"campaign(n={n},cuda)"] and vals["direct_tag"] == [
            f"dense(n={n})"], f"{kind} n={n} campaign vs direct kernel "
                              f"rel {rel:.3e} <= 1e-12")
        out[f"{kind}_n{n}"] = rel
    return out


def _cli_campaign(args: list, kill_after_first_wave: bool = False) -> str:
    """Run the campaign CLI in a child process; with
    ``kill_after_first_wave`` SIGKILL it right after its first
    ``[campaign] wave`` line (printed once that wave's checkpoint is on
    disk).  Returns its output."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    p = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.campaign",
                          *args], env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, cwd=ROOT)
    lines = []
    try:
        for line in p.stdout:
            lines.append(line)
            if kill_after_first_wave and "[campaign] wave" in line:
                os.kill(p.pid, signal.SIGKILL)
                break
        p.wait(timeout=600)
    finally:
        p.stdout.close()
        if p.poll() is None:
            p.kill()
            p.wait(timeout=60)
    return "".join(lines)


def _campaign_resume(smoke: Smoke, torch) -> dict:
    """Kill and resume at n = CAMPAIGN_KILL_N with CAMPAIGN_KILL_SLICES
    slices, real and complex: the CLI SIGKILLed after its first wave and
    resumed prints the same %.17e as an uninterrupted run; an in-process
    ``campaign_max_waves=1`` pause and resume gives the same bits; W = 1
    over the first slices, and a wave of non-contiguous ids, give the same
    slice sums as the default W, bit for bit."""
    from repro_torch.core import distributed as D
    from repro_torch.core.resume import JobState
    from repro_torch.core.solver import PermanentSolver, SolverConfig
    n, slices = CAMPAIGN_KILL_N, CAMPAIGN_KILL_SLICES
    rng = np.random.default_rng(SEED + 43)
    out = {}
    for cplx in (False, True):
        kind = "complex" if cplx else "real"
        A = rng.uniform(0.2, 1.2, (n, n))
        if cplx:
            A = A + 1j * rng.uniform(0.2, 1.2, (n, n))
        with tempfile.TemporaryDirectory() as tmp:
            path = lambda name: os.path.join(tmp, name)  # noqa: E731
            np.save(path("A.npy"), A)
            cfg = SolverConfig(preprocess=False, campaign_threshold=-1.0,
                               campaign_slices=slices, cache=False)
            ref_solver = PermanentSolver(cfg.replace(
                campaign_checkpoint=path("ref.npz")))
            waves = []
            ref_solver.campaign_progress = lambda st, w: waves.append(w)
            t0 = time.perf_counter()
            ref = ref_solver.execute(ref_solver.plan(A))
            t_ref = time.perf_counter() - t0
            ref_txt = f"{ref.real:+.17e} {ref.imag:+.17e}j" if cplx \
                else f"{ref:+.17e}"
            ref_state = JobState.load(path("ref.npz"))
            spec = ref_solver.plan(A).leaves[0].campaign

            cli = ["--matrix", path("A.npy"), "--slices", str(slices),
                   "--checkpoint", path("job.npz")]
            killed = _cli_campaign(cli, kill_after_first_wave=True)
            done = JobState.load(path("job.npz")).fraction_done() \
                if os.path.exists(path("job.npz")) else 0.0
            resumed = _cli_campaign(cli)
            if not 0 < done < 1 or "perm(A) =" not in resumed:
                print(f"campaign CLI output, killed:\n{killed[-3000:]}\n"
                      f"resumed:\n{resumed[-3000:]}")
            got_txt = next((ln.split("perm(A) =")[1].split("  (")[0].strip()
                            for ln in resumed.splitlines()
                            if "perm(A) =" in ln), None)
            first = next((ln.strip() for ln in killed.splitlines()
                          if "[campaign] wave" in ln), "")
            smoke.check(0 < done < 1 and got_txt == ref_txt,
                        f"{kind} n={n}: CLI killed after its first wave "
                        f"({done:.4f} done: {first}) and resumed prints "
                        f"{got_txt} == uninterrupted {ref_txt}")

            paused = PermanentSolver(cfg.replace(
                campaign_checkpoint=path("pause.npz"), campaign_max_waves=1))
            try:
                paused.execute(paused.plan(A))
                was_paused = False
            except D.CampaignPaused:
                was_paused = True
            again = PermanentSolver(cfg.replace(
                campaign_checkpoint=path("pause.npz")))
            same = was_paused and again.execute(again.plan(A)) == ref
            smoke.check(same, f"{kind} n={n}: campaign_max_waves=1 pauses "
                              f"and the resumed solver gives the same bits")

            body = dict(chunks_per_slice=spec.chunks_per_slice,
                        chunk_size=spec.chunk_size,
                        precision=spec.precision, backend="cuda")
            _v, one = D.run_campaign(A, total_slices=spec.total_slices,
                                     wave_width=1, max_waves=W1_SLICES,
                                     **body)
            k = W1_SLICES
            ids = [0, 5, 6, spec.total_slices - 1]
            his, los, launches = D.slice_sums(A, ids, **body)
            w1_same = bool(np.array_equal(one.hi[:k], ref_state.hi[:k])
                           and np.array_equal(one.lo[:k], ref_state.lo[:k])
                           and one.done.sum() == k)
            gaps_same = bool(np.array_equal(his, ref_state.hi[ids])
                             and np.array_equal(los, ref_state.lo[ids])
                             and launches == 3)
            smoke.check(w1_same and gaps_same,
                        f"{kind} n={n}: W = 1 over slices 0-{k - 1} and a "
                        f"wave of ids {ids} ({launches} launches) equal the "
                        f"default W = {waves[0].width}'s slice sums bit for "
                        f"bit")
        out[kind] = {"value": ref_txt, "resumed": got_txt,
                     "killed_at": done, "uninterrupted_s": t_ref,
                     "W": waves[0].width, "waves": len(waves),
                     "wave_kernel_ms": [w.kernel_s * 1e3 for w in waves],
                     "wave_host_ms": [w.host_s * 1e3 for w in waves],
                     "wave_save_ms": [w.save_s * 1e3 for w in waves]}
        print(f"campaign resume {kind} n={n}: {out[kind]}")
    return out


def phase_campaign(smoke: Smoke, torch, card: dict) -> dict:
    """The campaign route on the card (``core/distributed.py``): the scalar
    entries from large chunk bases, the wave body at the main paths' lane
    count, the refusal of out-of-range chunk sizes, the campaign main
    paths through ``permanent`` (all-ones n = 40, complex n = 32, rank-one
    n = 40 and complex n = 32, all-ones n = 32 and 36), campaign against
    the direct kernels, and kill and resume.  Returns the main paths' launches of
    kernels #1 and #3."""
    t0 = time.perf_counter()
    out = {"large_bases": _campaign_large_bases(smoke, torch),
           "wave_body": _campaign_wave_body(smoke, torch),
           "refusals": _campaign_refusals(smoke, torch)}
    out["main"], launches = _campaign_main_path(smoke, torch, card)
    out["vs_direct"] = _campaign_vs_direct(smoke, torch)
    out["resume"] = _campaign_resume(smoke, torch)
    out["seconds"] = time.perf_counter() - t0
    print(f"campaign phase: {out['seconds']:.1f} s")
    smoke.summary["campaign"] = out
    return launches


# ---------------------------------------------------------------------------
# Kernel-entry parity: kernel #1's schedmat mode, f32 input to #1-#8
# ---------------------------------------------------------------------------

PARITY_WINDOW_NS = tuple(n for n in WINDOW_NS if n <= 47)
SCHED_ORACLE_NS = (8, 11, 14)        # schedmat values against the oracle
F32_NS = (10, 16, 20, 24)            # f32 values against the f64 kernel
ORACLE_BAR, F32_BAR = 1e-9, 5e-4     # the reference's bars (f64, f32)
PARITY_ROWS = ("ryser_dense_scalar_schedmat", "ryser_dense_scalar_f32",
               "ryser_dense_scalar_f32_schedmat", "ryser_dense_batched_f32",
               "ryser_complex_scalar_f32", "ryser_complex_batched_f32",
               "ryser_sparse_scalar_f32", "ryser_sparse_batched_f32",
               "ryser_sparse_complex_scalar_f32",
               "ryser_sparse_complex_batched_f32")
SINGLE_ROWS = PARITY_ROWS[4:]        # the _f32 entries of #3-#8
SPARSE_F32_NS = (16, 20, 24)         # f32 sparse values against f64


def _parity_windows(smoke: Smoke, torch) -> dict:
    """#1 in schedmat mode (f64 and f32) and in baseline and batched mode
    on f32, and #2 on f32, bit for bit with their plain versions on block
    windows (the first and the last, all precisions) at n in
    PARITY_WINDOW_NS, with the same inputs in both dtypes (above N_MAIN
    U(0.1, 1) * 2 / n, which keeps every f32 product in range).  The full
    grids at n = 30 and 256 x n = 24 are the timing phase's."""
    from repro_torch.core.stepspace import DEFAULT_GEOMETRY, Geometry
    from repro_torch.kernels import ops
    from repro_torch.kernels import ryser_cuda as RC
    rng = np.random.default_rng(SEED + 17)
    err = dict.fromkeys(PARITY_ROWS, 0.0)
    equal = True
    for n in PARITY_WINDOW_NS:
        geom = DEFAULT_GEOMETRY if n >= N_BUCKET else Geometry(8, 8, 4)
        TB, C, Wu, blocks = geom.kernel_geometry(n)
        nb = min(8, blocks)
        geo = dict(n=n, TB=TB, C=C, Wu=Wu, num_blocks=nb)
        A = rng.uniform(-1, 1, (3, n, n)) if n <= N_MAIN else \
            rng.uniform(0.1, 1, (3, n, n)) * 2 / n
        As = torch.as_tensor(A, device="cuda")
        for dt in (torch.float64, torch.float32):
            f32 = dt == torch.float32
            A_pads, xb_pads, _ = ops.prepare(As.to(dt))
            for mode in (("baseline", "batched", "schedmat") if f32
                         else ("schedmat",)):
                key = ("ryser_dense_scalar" + ("_f32" if f32 else "")
                       + ("_schedmat" if mode == "schedmat" else ""))
                for prec in PRECISIONS:
                    for base in sorted({0, blocks * TB - nb * TB}):
                        got = RC.ryser_cuda_call(A_pads[0], xb_pads[0], base,
                                                 precision=prec, mode=mode,
                                                 **geo)
                        want = RC.block_partials_plain(
                            A_pads[:1], xb_pads[:1], base, precision=prec,
                            mode=mode, **geo)[0]
                        equal &= got.dtype == dt and _bits_equal(
                            torch, got, want, err, key)
                    if f32 and mode != "schedmat":
                        got = RC.ryser_cuda_call_batched(
                            A_pads, xb_pads, precision=prec, mode=mode, **geo)
                        want = RC.block_partials_plain(
                            A_pads, xb_pads, 0, precision=prec, mode=mode,
                            **geo)
                        equal &= got.dtype == dt and _bits_equal(
                            torch, got, want, err, "ryser_dense_batched_f32")
        torch.cuda.synchronize()
    smoke.check(equal, f"#1 schedmat (f64, f32), #1 baseline/batched f32 and "
                       f"#2 f32 equal their plain versions bit for bit on "
                       f"windows at n in {PARITY_WINDOW_NS}, "
                       f"{len(PRECISIONS)} precisions, first and last "
                       f"blocks, B = 3: max abs err {err}")
    return err


def _phased(rng, shape):
    """U(0.1, 1) magnitudes with phases in [-pi/4, pi/4]: the complex
    analogue of the U(0.1, 1) inputs the reference's f32 bar is set on
    (Ryser's terms cancel little, so f32 rounding stays near 1e-6)."""
    return rng.uniform(0.1, 1.0, shape) * np.exp(
        1j * rng.uniform(-np.pi / 4, np.pi / 4, shape))


def _single_windows(smoke: Smoke, torch) -> dict:
    """The _f32 entries of #3/#4 (complex64 planes), #5/#6 (f32, leaves
    ordered as the main path orders them) and #7/#8 (complex64) bit for
    bit with their plain versions on block windows (the first and the
    last, every precision) and over a B = 3 batch grid, at n in
    PARITY_WINDOW_NS up to N_MAIN and 40 (dense) and SPARSE_WINDOW_NS up
    to 47 (sparse; NPAD 40-48 run the f32 complex rows branch-free), each
    returning f32 partials.  The full grids of the main path's shapes are
    the timing phase's."""
    from repro_torch.core.stepspace import DEFAULT_GEOMETRY, Geometry
    from repro_torch.kernels import ops
    from repro_torch.kernels import ryser_complex_cuda as RX
    rng = np.random.default_rng(SEED + 19)
    err = dict.fromkeys(SINGLE_ROWS, 0.0)
    equal = True
    cases = [("complex", n) for n in PARITY_WINDOW_NS
             if n <= N_MAIN or n == 40] + \
        [(kind, n) for kind in ("sparse", "sparse_complex")
         for n in SPARSE_WINDOW_NS if n <= 47]
    for kind, n in cases:
        geom = DEFAULT_GEOMETRY if n >= N_BUCKET else Geometry(8, 8, 4)
        TB, C, Wu, blocks = geom.kernel_geometry(n)
        nb = min(8, blocks)
        geo = dict(n=n, TB=TB, C=C, Wu=Wu, num_blocks=nb)
        cplx = kind != "sparse"
        if kind == "complex":
            ins = ops.prepare_complex(torch.as_tensor(
                _cgauss(rng, (3, n, n)), device="cuda").to(
                    torch.complex64))[:4]
            calls = (RX.ryser_cuda_call_complex,
                     RX.ryser_cuda_call_complex_batched,
                     RX.block_partials_plain_complex)
        else:
            ins = _sparse_inputs(torch, [_circulant_sparse(
                rng, n, min(BUCKET_DEGREE, n - 1), cplx) for _ in range(3)],
                cplx, None if cplx else Wu, single=True)
            calls = _sparse_calls(cplx)
        scalar, batched, plain = calls
        for prec in PRECISIONS:
            for base in sorted({0, blocks * TB - nb * TB}):
                got = scalar(*(t[0] for t in ins), base, precision=prec,
                             **geo)
                want = plain(*(t[:1] for t in ins), base, precision=prec,
                             **geo)[0]
                equal &= got.dtype == torch.float32 and _bits_equal(
                    torch, got, want, err, f"ryser_{kind}_scalar_f32")
            got = batched(*ins, precision=prec, **geo)
            want = plain(*ins, 0, precision=prec, **geo)
            equal &= got.dtype == torch.float32 and _bits_equal(
                torch, got, want, err, f"ryser_{kind}_batched_f32")
        torch.cuda.synchronize()
    smoke.check(equal, f"the _f32 entries of #3-#8 (complex64, f32 sparse, "
                       f"complex64 sparse) equal their plain versions bit "
                       f"for bit on windows, {len(PRECISIONS)} precisions, "
                       f"first and last blocks, B = 3, f32 partials: max "
                       f"abs err {err}")
    return err


def _single_values(rng, torch) -> tuple[dict, bool]:
    """The path a user takes with complex64 and f32 sparse input:
    ``ops.permanent_cuda(_batched)`` on complex64 (#3, #4) and
    ``ops.permanent_cuda_sparse(_batched)`` on f32 and complex64 bands
    (#5-#8), each held within rtol F32_BAR of the f64 entry on the same
    input and checked for its dtype.  Returns (max rel by case, dtypes
    right)."""
    from repro_torch.core.sparyser import SparseMatrix
    from repro_torch.kernels import ops
    rel, ok = {}, True

    def gap(got, want):
        got = np.asarray(got.cpu().numpy(), dtype=np.complex128)
        want = np.asarray(want.cpu().numpy(), dtype=np.complex128)
        return float(np.max(np.abs(got - want) / np.abs(want)))

    for n in F32_NS:
        As = _phased(rng, (4, n, n))
        f64 = ops.permanent_cuda_batched(As)
        got = ops.permanent_cuda_batched(As.astype(np.complex64))
        ok &= got.dtype == torch.complex64 and got.shape == (4,)
        rel[f"#4 n={n}"] = gap(got, f64)
        one = ops.permanent_cuda(As[0].astype(np.complex64))
        ok &= one.dtype == torch.complex64 and one.ndim == 0
        rel[f"#3 n={n}"] = gap(one, f64[0])
    for n in SPARSE_F32_NS:
        for cplx, dt, tag in ((False, np.float32, "#5/#6"),
                              (True, np.complex64, "#7/#8")):
            mats = [_circulant_sparse(rng, n, BUCKET_DEGREE) for _ in
                    range(4)]
            if cplx:
                mats = [A * np.exp(1j * rng.uniform(-np.pi / 4, np.pi / 4,
                                                    A.shape)) for A in mats]
            f64 = ops.permanent_cuda_sparse_batched(
                [SparseMatrix.from_dense(A) for A in mats])
            sps = [SparseMatrix.from_dense(A.astype(dt)) for A in mats]
            got = ops.permanent_cuda_sparse_batched(sps)
            one = ops.permanent_cuda_sparse(sps[0])
            want_dt = torch.complex64 if cplx else torch.float32
            ok &= got.dtype == want_dt and one.dtype == want_dt
            rel[f"{tag} batched n={n}"] = gap(got, f64)
            rel[f"{tag} scalar n={n}"] = gap(one, f64[0])
    return rel, ok


def phase_entry_parity(smoke: Smoke, torch) -> tuple[dict, dict]:
    """Kernel #1's schedmat mode and the f32 entries of #1-#8: windows
    against their plain versions, then the path a user takes
    (``ops.permanent_cuda(_batched)``, ``permanent_cuda_sparse(_batched)``)
    with the launch counters reset just before and read just after:
    schedmat values against the oracle, f32 and complex64 values against
    the f64 entries on the same matrices and in their dtype;
    ``perm_ryser_seq`` on the card against the oracle; #1's three modes
    timed at n = 30 (f64 and f32).  Returns (window max abs errors, the
    path's launches) of PARITY_ROWS."""
    import repro_torch.core.oracle as oracle
    from repro_torch.core.ryser import perm_ryser_seq
    from repro_torch.kernels import ops
    from repro_torch.kernels import ryser_cuda as RC
    t0 = time.perf_counter()
    err = {**_parity_windows(smoke, torch), **_single_windows(smoke, torch)}
    rng = np.random.default_rng(SEED + 18)
    sched_rel, f32_rel, dtypes_ok = {}, {}, True
    RC.reset_counters()
    for n in SCHED_ORACLE_NS:
        A = rng.uniform(-1, 1, (n, n))
        got = float(ops.permanent_cuda(A, mode="schedmat"))
        want = oracle.perm_ryser_exact(A)
        sched_rel[n] = abs(got - want) / abs(want)
    for n in F32_NS:
        As = rng.uniform(0.1, 1.0, (4, n, n))
        f64 = ops.permanent_cuda_batched(As).cpu().numpy()
        A32 = As.astype(np.float32)
        for mode in ("baseline", "batched"):
            got = ops.permanent_cuda_batched(A32, mode=mode)
            dtypes_ok &= got.dtype == torch.float32 and got.shape == (4,)
            f32_rel[f"#2 {mode} n={n}"] = float(np.max(np.abs(
                got.cpu().numpy().astype(np.float64) - f64) / np.abs(f64)))
        for mode in ("baseline", "batched", "schedmat"):
            got = ops.permanent_cuda(A32[0], mode=mode)
            dtypes_ok &= got.dtype == torch.float32 and got.ndim == 0
            f32_rel[f"#1 {mode} n={n}"] = abs(float(got) - f64[0]) / \
                abs(f64[0])
    single_rel, single_ok = _single_values(rng, torch)
    torch.cuda.synchronize()
    launches = {k: RC.counters[k] for k in PARITY_ROWS}
    plain = sum(v for k, v in RC.counters.items()
                if k.startswith("block_partials_plain"))
    print(f"entry parity path: launches {launches}, f64 batched "
          f"{RC.counters['ryser_dense_batched']}, plain {plain}")
    print(f"schedmat vs oracle: {sched_rel}")
    print(f"f32 vs the f64 kernel (max rel): {f32_rel}")
    print(f"complex64 / f32 sparse vs the f64 entries (max rel): "
          f"{single_rel}")
    smoke.check(all(v <= ORACLE_BAR for v in sched_rel.values()),
                f"#1 schedmat within rel {ORACLE_BAR:g} of the oracle at n "
                f"in {SCHED_ORACLE_NS}: {sched_rel}")
    smoke.check(all(v <= F32_BAR for v in f32_rel.values()) and dtypes_ok,
                f"f32 #1 (3 modes) and #2 (2 modes) within rtol {F32_BAR:g} "
                f"of the f64 kernel at n in {F32_NS}, every result f32: "
                f"worst {max(f32_rel.values()):.3e}")
    smoke.check(all(v <= F32_BAR for v in single_rel.values()) and single_ok,
                f"complex64 #3/#4, f32 #5/#6 and complex64 #7/#8 within "
                f"rtol {F32_BAR:g} of the f64 entries, results complex64 / "
                f"f32: worst {max(single_rel.values()):.3e}")
    smoke.check(all(v > 0 for v in launches.values()) and plain == 0,
                f"the entry-parity path launched each of its kernels and no "
                f"plain version: {launches}, plain {plain}")
    A = rng.uniform(-1, 1, (12, 12))
    t1 = time.perf_counter()
    seq = perm_ryser_seq(A)
    seq_s = time.perf_counter() - t1
    want = oracle.perm_ryser_exact(A)
    seq_rel = abs(float(seq) - want) / abs(want)
    smoke.check(seq.is_cuda and seq_rel <= ORACLE_BAR,
                f"perm_ryser_seq on the card at n = 12 within rel "
                f"{ORACLE_BAR:g} of the oracle: {seq_rel:.3e} "
                f"({seq_s:.2f} s)")
    modes = {}
    A = torch.as_tensor(rng.uniform(-1, 1, (N_MAIN, N_MAIN)), device="cuda")
    for dt in (torch.float64, torch.float32):
        for mode in ("baseline", "batched", "schedmat"):
            ms, _ = _time_ms(torch, lambda: ops.permanent_cuda(
                A.to(dt), mode=mode), reps=5)
            modes[f"{str(dt)[6:]} {mode}"] = ms
    print(f"#1 modes at n = {N_MAIN}, permanent_cuda ms (CUDA events, mean "
          f"of 5): {modes}")
    smoke.summary["entry_parity"] = {
        "window_err": err, "launches": launches, "schedmat_vs_oracle":
        sched_rel, "f32_vs_f64": f32_rel, "single_vs_f64": single_rel,
        "seq_rel": seq_rel,
        "seq_s": seq_s, "modes_ms": modes,
        "seconds": time.perf_counter() - t0}
    print(f"entry parity phase: {time.perf_counter() - t0:.1f} s")
    return err, launches


# ---------------------------------------------------------------------------
# Kernel-geometry tuning: the tune CLI on the card, its table in the planner
# ---------------------------------------------------------------------------

N_TUNE_CAMPAIGN = 34                 # one wave of an n = 34 campaign
TUNE_TOP_K, TUNE_REPEATS, TUNE_DENSITY = 6, 5, 0.2
TUNE_ROUTES = {"dense": ("dense", "<f8"), "complex": ("dense", "<c16"),
               "sparse": ("sparse", "<f8"),
               "campaign": ("step_sharded", "<f8")}
ORACLE_CHECKS = 4                    # closed-form members of each bucket
# Another geometry sums the same terms in another order, so a tuned plan's
# values differ from the default geometry's at the rounding level.  The gap
# is held against perm(|A|), the scale of the terms' rounding: on an NVIDIA
# H100 80GB HBM3 it read 1.87e-12 of perm(|A|) at worst over 256
# random-sign n = 24 values (9.2e-12 relative to the value, which cancels).
TUNE_GEOMETRY_BAR = 1e-11
TUNE_ENTRIES = ("ryser_dense_batched", "ryser_complex_batched",
                "ryser_sparse_batched", "ryser_dense_scalar")


def _tune_window(torch, route: str, n: int, tag: str, err: dict) -> bool:
    """One measured candidate at its geometry: its kernel on a window of
    blocks against the plain version, bit for bit -- the batch entry of
    the route on B = 2 matrices over the first two blocks, or for
    ``campaign`` the wave body's launch (the scalar entry, ``batched``
    mode, the campaign's chunk size) on the last block of the space."""
    from repro_torch.core.stepspace import Geometry
    from repro_torch.kernels import ops
    from repro_torch.kernels import ryser_cuda as RC
    from repro_torch.tune.search import _campaign_spec
    g = Geometry.from_tag(tag)
    rng = np.random.default_rng(SEED + 29)
    if route == "campaign":
        _ts, cps, C = _campaign_spec(n)
        TB, Wu = ops.wave_geometry(cps, C, g)
        A_pad, xb_pad, _ = ops.prepare(torch.as_tensor(
            rng.uniform(-1, 1, (n, n)), device="cuda"))
        base = (1 << (n - 1)) // C - TB
        geo = dict(n=n, TB=TB, C=C, Wu=Wu, num_blocks=1, mode="batched")
        got = RC.ryser_cuda_call(A_pad, xb_pad, base, **geo)
        want = RC.block_partials_plain(A_pad[None], xb_pad[None], base,
                                       **geo)[0]
        return _bits_equal(torch, got, want, err, f"{route} {tag}")
    TB, C, Wu, blocks = g.kernel_geometry(n)
    geo = dict(n=n, TB=TB, C=C, Wu=Wu, num_blocks=min(2, blocks))
    if route == "sparse":
        ins = _sparse_inputs(torch, [_circulant_sparse(rng, n, BUCKET_DEGREE)
                                     for _ in range(2)], False, Wu)
        _scalar, batched, plain = _sparse_calls(False)
        got, want = batched(*ins, **geo), plain(*ins, 0, **geo)
    elif route == "complex":
        from repro_torch.kernels import ryser_complex_cuda as RX
        planes = ops.prepare_complex(torch.as_tensor(
            _cgauss(rng, (2, n, n)), device="cuda"))[:4]
        got = RX.ryser_cuda_call_complex_batched(*planes, **geo)
        want = RX.block_partials_plain_complex(*planes, 0, **geo)
    else:
        A_pads, xb_pads, _ = ops.prepare(torch.as_tensor(
            rng.uniform(-1, 1, (2, n, n)), device="cuda"))
        got = RC.ryser_cuda_call_batched(A_pads, xb_pads, mode="batched",
                                         **geo)
        want = RC.block_partials_plain(A_pads, xb_pads, 0, mode="batched",
                                       **geo)
    return _bits_equal(torch, got, want, err, f"{route} {tag}")


def _tune_buckets(rng, n: int) -> dict:
    """route -> (matrices, [(index, exact permanent)]) of the tuned plans:
    256 x n = 24 buckets whose first ORACLE_CHECKS members have closed
    forms -- a J (real n! a^n, complex n! c^n; ``oracle.
    all_ones_permanent``) and I + P on the sparse route (2^cycles) -- and
    the rest U(-1, 1), complex Gaussian and degree-5 bands."""
    import repro_torch.core.oracle as oracle
    k, out = ORACLE_CHECKS, {}
    a = rng.uniform(0.5, 1.5, k)
    dense = [a[i] * np.ones((n, n)) for i in range(k)] + \
        list(rng.uniform(-1, 1, (B_THRU - k, n, n)))
    out["dense"] = (dense, [(i, oracle.all_ones_permanent(n, a[i]))
                            for i in range(k)])
    c = a * np.exp(1j * rng.uniform(-np.pi, np.pi, k))
    cplx = [c[i] * np.ones((n, n)) for i in range(k)] + \
        list(_cgauss(rng, (B_THRU - k, n, n)))
    out["complex"] = (cplx, [(i, oracle.all_ones_permanent(n) * c[i] ** n)
                             for i in range(k)])
    pairs = [_derangement_plus_identity(rng, n) for _ in range(k)]
    sparse = [A for A, _ in pairs] + [
        _circulant_sparse(rng, n, BUCKET_DEGREE) for _ in range(B_THRU - k)]
    out["sparse"] = (sparse, [(i, v) for i, (_, v) in enumerate(pairs)])
    return out


def _plans_recorded():
    """Wrap the solver module's ``build_plan`` so every plan it makes is
    kept; returns (the list, a function that restores it)."""
    import repro_torch.core.solver as S
    plans, build_plan = [], S.build_plan

    def record(*a, **kw):
        plans.append(build_plan(*a, **kw))
        return plans[-1]
    S.build_plan = record
    return plans, lambda: setattr(S, "build_plan", build_plan)


def phase_tune(smoke: Smoke, torch, card: dict) -> dict:
    """The tune CLI (``repro_torch.launch.tune``'s ``tune_main``, in this
    process, so the launch counters read its path) on the card at the
    main path's sizes (dense, complex and sparse at 256 x n = 24, a
    campaign wave at n = 34) into a table under ``chiprun_out/tune``, then
    its table in the planner.  Gates: the path launches #2, #4, #6 and the
    wave body #1 and no plain version; every measured candidate, at its
    plain version bit for bit on a window; each winner measured at most
    the default's time; a solver with the table plans and launches the
    winners (leaf and CampaignSpec geometry, launch counters, values equal
    to the entry's own at the winner's geometry bit for bit), its values
    within TUNE_GEOMETRY_BAR perm(|A|) of the default geometry's and
    within the value bar ORACLE_BAR of the closed forms of
    ``core/oracle.py``; a table whose kernels hash is edited is refused;
    a service with the table warms the tuned geometries and serves a
    first bucket with no library miss."""
    import repro_torch.core.oracle as oracle
    from repro_torch.core.solver import PermanentSolver, SolverConfig
    from repro_torch.kernels import ops
    from repro_torch.kernels import ryser_cuda as RC
    from repro_torch.serve import compile_stats
    from repro_torch.tune.table import TuningTable
    t0 = time.perf_counter()
    out_dir = os.path.join(ROOT, "chiprun_out", "tune")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "table.json")
    from repro_torch.launch.tune import tune_main
    # two runs of the CLI, the bucket routes at the buckets' n and the
    # campaign route at a campaign's, merged into one table
    runs = ((",".join(r for r in TUNE_ROUTES if r != "campaign"), N_THRU),
            ("campaign", N_TUNE_CAMPAIGN))
    table, rows, rc = TuningTable(), [], 0
    RC.reset_counters()
    for k, (routes, n) in enumerate(runs):
        part, part_report = (os.path.join(out_dir, f"{what}{k}.json")
                             for what in ("table", "report"))
        argv = ["--routes", routes, "--n", str(n), "--batch", str(B_THRU),
                "--density", str(TUNE_DENSITY), "--top-k", str(TUNE_TOP_K),
                "--repeats", str(TUNE_REPEATS), "--out", part, "--report",
                part_report]
        print(f"python -m repro_torch.launch.tune {' '.join(argv)}")
        try:
            rc = tune_main(argv)
        except Exception as e:               # noqa: BLE001 -- a failed gate
            rc = repr(e)
        if rc != 0:
            break
        for e in TuningTable.load(part).entries.values():
            table.put(e)
        rows += json.load(open(part_report))["rows"]
    torch.cuda.synchronize()
    launches = {k: v for k, v in RC.counters.items() if v}
    cli_s = time.perf_counter() - t0
    smoke.check(rc == 0, f"tune CLI on the card, routes "
                         f"{','.join(TUNE_ROUTES)}: {rc} in {cli_s:.1f} s")
    if rc != 0:
        return {}
    smoke.check(set(launches) == set(TUNE_ENTRIES) | {RC.FREE_ROWS_COUNTER},
                f"the tune path launched #2, #4, #6 and the campaign wave "
                f"body #1 (its NPAD 40 rows branch-free), and no plain "
                f"version: {launches}")
    table.save(path)
    print(f"tune results on {card['nvidia_smi']} (dq_acc, CUDA events, "
          f"median of {TUNE_REPEATS} after a warm-up):")
    keys = {}
    for route, (plan_route, dtype) in TUNE_ROUTES.items():
        n = N_TUNE_CAMPAIGN if route == "campaign" else N_THRU
        dens = TUNE_DENSITY if route == "sparse" else 1.0
        e = table.get(plan_route, n, dens, dtype, "dq_acc")
        mine = [r for r in rows if r["route"] == route]
        keys[route] = {"key": e.key(), "winner": e.geometry.tag(),
                       "default_ms": e.default_s * 1e3,
                       "winner_ms": e.measured_s * 1e3,
                       "speedup": e.speedup,
                       "model_over_measured": e.mispredict_ratio,
                       "measured": {r["geometry"]: r["measured_s"] * 1e3
                                    for r in mine},
                       "modeled": {r["geometry"]: r["modeled_s"] * 1e3
                                   for r in mine}}
        print(f"  tune {e.key()}: winner {e.geometry.tag()}, default "
              f"{e.default_s * 1e3:.4f} ms, winner {e.measured_s * 1e3:.4f} "
              f"ms, speedup {e.speedup:.4f}x, model/measured "
              f"{e.mispredict_ratio:.3f}; candidates (ms) "
              f"{keys[route]['measured']}")
    smoke.check(all(k["winner_ms"] <= k["default_ms"] and
                    "128x64x16" in k["measured"] for k in keys.values()),
                "each key measured the default geometry and its winner is "
                "no slower")
    err, ok = {}, True
    for r in rows:
        ok &= _tune_window(torch, r["route"], r["n"], r["geometry"], err)
    torch.cuda.synchronize()
    smoke.check(ok, f"every measured candidate ({len(rows)}) equals its "
                    f"plain version bit for bit on a window at its "
                    f"geometry: max abs err {max(err.values()):g}")

    # the table in the planner: the winners planned and launched
    rng = np.random.default_rng(SEED + 31)
    base = dict(cache=False, preprocess=False)
    tuned = PermanentSolver(SolverConfig(tuning_table=path, **base))
    plain = PermanentSolver(SolverConfig(**base))
    vals, rel_default, rel_oracle, ok = {}, {}, {}, True
    for route, (mats, exact) in _tune_buckets(rng, N_THRU).items():
        winner = table.get(*TUNE_ROUTES[route][:1], N_THRU,
                           TUNE_DENSITY if route == "sparse" else 1.0,
                           TUNE_ROUTES[route][1], "dq_acc").geometry
        plan = tuned.plan_batch(mats)
        geoms = {l.geometry for l in plan.leaves}
        RC.reset_counters()
        got = np.asarray(tuned.execute(plan))
        launched = {k: v for k, v in RC.counters.items() if v}
        entry = {"dense": "ryser_dense_batched",
                 "complex": "ryser_complex_batched",
                 "sparse": "ryser_sparse_batched"}[route]
        if route == "sparse":
            from repro_torch.core.sparyser import (SparseMatrix,
                                                   pack_padded_ccs)
            direct = ops.sparse_batched_values_cuda(
                *pack_padded_ccs([SparseMatrix.from_dense(A) for A in mats]),
                geometry=winner)
        else:
            direct = ops.permanent_cuda_batched(np.stack(mats),
                                                geometry=winner)
        want = np.asarray(plain.execute(plain.plan_batch(mats)))
        scale = np.asarray(plain.execute(plain.plan_batch(
            [np.abs(A) for A in mats])))
        rel_default[route] = float(np.max(np.abs(got - want) / scale))
        rel_oracle[route] = max(abs(got[i] - v) / abs(v) for i, v in exact)
        same = bool(np.array_equal(got, direct.cpu().numpy()))
        ok &= (geoms == {winner} and launched == {entry: 1} and same
               and rel_default[route] <= TUNE_GEOMETRY_BAR
               and rel_oracle[route] <= ORACLE_BAR)
        vals[route] = {"winner": winner.tag(), "launched": launched,
                       "equal_direct_entry": same}
        print(f"tuned plan {route} {B_THRU} x n={N_THRU}: leaf geometry "
              f"{sorted(g.tag() for g in geoms)} (winner {winner.tag()}), "
              f"launches {launched}, values == the entry's at the winner: "
              f"{same}, gap to the default geometry's values over "
              f"perm(|A|) {rel_default[route]:.3e}, rel to the closed forms "
              f"{rel_oracle[route]:.3e}")
    n = N_TUNE_CAMPAIGN
    J = np.ones((n, n))
    winner = table.get("step_sharded", n, 1.0, "<f8", "dq_acc").geometry
    plan = tuned.plan(J)
    spec = plan.leaves[0].campaign
    RC.reset_counters()
    got = tuned.execute(plan)
    launched = {k: v for k, v in RC.counters.items() if v}
    want = plain.execute(plain.plan(J))
    exact = oracle.all_ones_permanent(n)
    rel_default["campaign"] = abs(got - want) / abs(want)   # J = |J|
    rel_oracle["campaign"] = abs(got - exact) / exact
    ok &= (spec is not None and spec.geometry == winner
           and set(launched) == {"ryser_dense_scalar", RC.FREE_ROWS_COUNTER}
           and rel_default["campaign"] <= TUNE_GEOMETRY_BAR
           and rel_oracle["campaign"] <= ORACLE_BAR)
    vals["campaign"] = {"winner": winner.tag(), "launched": launched}
    print(f"tuned plan campaign ones({n}): CampaignSpec geometry "
          f"{spec.geometry.tag() if spec and spec.geometry else None} "
          f"(winner {winner.tag()}), launches {launched}, rel to the "
          f"default geometry {rel_default['campaign']:.3e}, to n! "
          f"{rel_oracle['campaign']:.3e}")
    smoke.check(ok, f"a solver with the table plans and launches each "
                    f"winner, values within {TUNE_GEOMETRY_BAR:g} perm(|A|) "
                    f"of the default geometry's and rel {ORACLE_BAR:g} of "
                    f"the closed forms: {rel_default}, {rel_oracle}")

    stale = os.path.join(out_dir, "stale.json")
    doc = json.load(open(path))
    doc["kernels_hash"] = "0" * 16
    json.dump(doc, open(stale, "w"))
    refused = []
    for load in (lambda: TuningTable.load(stale),
                 lambda: PermanentSolver(SolverConfig(
                     tuning_table=stale, **base)).plan(J[:N_THRU, :N_THRU])):
        try:
            load()
            refused.append(False)
        except ValueError:
            refused.append(True)
    smoke.check(all(refused), f"a table with an edited kernels hash is "
                              f"refused (load, planner): {refused}")

    # a service with the table: warm-up plans the winners, first bucket
    from repro_torch.serve import quantized_batches
    before = compile_stats()
    plans, restore = _plans_recorded()
    try:
        svc = _service(SolverConfig(cache=False, tuning_table=path),
                       warmup_ns=(N_THRU,), warmup_complex=True)
        warm = {l.geometry for p in plans for l in p.leaves
                if l.n == N_THRU and l.route == "dense"}
        del plans[:]
        mats = list(rng.uniform(-1, 1, (B_SERVE, N_THRU, N_THRU)))
        tickets = [svc.submit(A) for A in mats]
        svc.drain()
        first = {l.geometry for p in plans for l in p.leaves}
    finally:
        restore()
    values = np.array([t.value for t in tickets])
    direct = ops.permanent_cuda_batched(np.stack(mats), geometry=table.get(
        "dense", N_THRU, 1.0, "<f8", "dq_acc").geometry).cpu().numpy()
    after = compile_stats()
    winners = {table.get("dense", N_THRU, 1.0, dt, "dq_acc").geometry
               for dt in ("<f8", "<c16")}
    misses = after["persistent_misses"] - before["persistent_misses"]
    ok = warm == winners and first <= winners and misses == 0 and \
        np.array_equal(values, direct)
    smoke.check(ok, f"a service with the table warms the tuned geometries "
                    f"({sorted(g.tag() for g in warm)}, ladder "
                    f"{quantized_batches(B_SERVE)}) and serves a first "
                    f"bucket at them ({sorted(g.tag() for g in first)}) with "
                    f"no library miss ({misses}), values equal to the entry's "
                    f"at the winner")
    out = {"cli_s": cli_s, "launches": launches, "keys": keys, "rows": rows,
           "window_err": err,
           "plans": vals, "rel_default": rel_default,
           "rel_oracle": rel_oracle, "stale_refused": refused,
           "seconds": time.perf_counter() - t0}
    print(f"tune phase: {out['seconds']:.1f} s (CLI {cli_s:.1f} s)")
    smoke.summary["tune"] = out
    return out


# ---------------------------------------------------------------------------
# The service: warm-up, open-loop soak, fill_first, campaign, cold start
# ---------------------------------------------------------------------------

N_SERVE, B_SERVE, SERVE_REQUESTS, SERVE_POOL = 24, 64, 2048, 64
# The mixed stream: a third each of dense real, dense complex and sparse,
# interleaved in one seeded order.  Its sparse third is a stand-in:
# permuted circulant bands of BUCKET_DEGREE nonzeros a row and column
# (density 5/24 = 0.208), half real and half complex, which DM/FM leave
# whole, so they reach the sparse buckets (#6, #8).  The soak CLI's sparse
# traffic, random masks at density 0.2, runs as a soak of its own
# (SERVE_DENSITY_*) through run_soak: at n = 24 DM/FM expand such a mask
# into thousands of leaves of n <= 7, all dense, planning for up to
# seconds a matrix (ROADMAP section 3), so it never reaches a sparse
# bucket and a few requests fill the time it may take.
SERVE_KINDS = ("dense real", "dense complex", "sparse real (band)",
               "sparse complex (band)")
SERVE_SHARES = (3, 3, 1.5, 1.5)           # sixths of the stream
EXPIRE_EVERY = 16
SERVE_DENSITY, SERVE_DENSITY_REQUESTS, SERVE_DENSITY_POOL = 0.2, 8, 8
SERVE_DENSITY_EXPIRE = 4
SERVE_CAMPAIGN_N, SERVE_CAMPAIGN_SLICES = 34, 256
COLD_REQUESTS, COLD_RATE = 256, 200.0
# the cold process on density-0.2 traffic: one matrix (repeat pool 1), so
# every dispatch plans the same matrix and the first compares like with
# like; a loose SLO so its seconds of planning shed nothing
COLD_DENSITY_REQUESTS, COLD_DENSITY_RATE, COLD_DENSITY_SLO_MS = 6, 0.5, 6e4
# the cuda backend's batch entries; the campaign's wave body is #1 (#3 for
# a complex campaign).  A bucket of one leaf (a one-request dispatch, or a
# DM/FM leaf alone at its size) runs the scalar entry of its route, as the
# reference's executor runs it ("ragged straggler: scalar path").
SERVE_ENTRIES = ("ryser_dense_batched", "ryser_complex_batched",
                 "ryser_sparse_batched", "ryser_sparse_complex_batched")
STRAGGLER_ENTRIES = ("ryser_dense_scalar", "ryser_complex_scalar",
                     "ryser_sparse_scalar", "ryser_sparse_complex_scalar")


def _mixed_stream(n: int, seed: int, requests: int):
    """(matrices, kind of each) of the mixed stream, in arrival order:
    SERVE_POOL distinct matrices a kind, picked in a seeded interleaving."""
    rng = np.random.default_rng(seed)
    pools = [[rng.uniform(-1.0, 1.0, (n, n)) for _ in range(SERVE_POOL)],
             [rng.uniform(-1.0, 1.0, (n, n))
              + 1j * rng.uniform(-1.0, 1.0, (n, n))
              for _ in range(SERVE_POOL)],
             [_circulant_sparse(rng, n, BUCKET_DEGREE)
              for _ in range(SERVE_POOL)],
             [_circulant_sparse(rng, n, BUCKET_DEGREE, cplx=True)
              for _ in range(SERVE_POOL)]]
    counts = [int(requests * s / sum(SERVE_SHARES)) for s in SERVE_SHARES]
    counts[0] += requests - sum(counts)
    kinds = rng.permutation(np.repeat(np.arange(len(pools)), counts))
    picks = rng.integers(0, SERVE_POOL, requests)
    return ([pools[k][p] for k, p in zip(kinds, picks)],
            [int(k) for k in kinds])


def _density_stream(n: int, seed: int, requests: int) -> list:
    """The matrices ``run_soak(n=n, density=SERVE_DENSITY,
    repeat_pool=SERVE_DENSITY_POOL, seed=seed)`` sends, in arrival order
    (its own draw order: the pool, then the picks)."""
    rng = np.random.default_rng(seed)
    pool = []
    for _ in range(SERVE_DENSITY_POOL):
        M = rng.uniform(-1.0, 1.0, (n, n))
        pool.append(M * (rng.uniform(0, 1, (n, n)) < SERVE_DENSITY))
    return [pool[i] for i in rng.integers(0, len(pool), requests)]


def _open_loop(svc, mats: list, rate_hz: float, seed: int,
               expire_every: int) -> dict:
    """``run_soak``'s open loop over a given stream: seeded exponential
    inter-arrival times at ``rate_hz``, the loop stepped between arrivals,
    lanes round-robin, every ``expire_every``-th request expired on
    arrival, tickets backdated to their arrival.  ``run_soak`` draws one
    kind of matrix a call; a mixed stream goes through the same loop
    here, each request a matrix object of its own."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate_hz, len(mats)))
    lanes = [lane.name for lane in svc.scfg.lanes]
    clock = svc._clock
    t0 = clock()
    tickets = []
    for i, M in enumerate(mats):
        target = t0 + arrivals[i]
        while clock() < target:
            if svc.step() == 0:
                wait = target - clock()
                if wait <= 0:
                    break
                time.sleep(min(wait, 1e-3))
        kw = {"deadline_s": -1.0} \
            if expire_every and i % expire_every == expire_every - 1 else {}
        tickets.append(svc.submit(np.array(M), lane=lanes[i % len(lanes)],
                                  t_submit=min(target, clock()), **kw))
    svc.drain()
    return {"tickets": tickets, "wall_s": clock() - t0}


def _record_dispatches(solver) -> list:
    """Wrap a solver so each plan_batch/execute pair (a service's
    dispatch, a solver queue's flush) leaves (matrices, executor reports,
    complex) in the returned list, in order."""
    log = []
    plan_batch, execute = solver.plan_batch, solver.execute

    def plan(mats):
        log.append([list(mats), None,
                    any(np.iscomplexobj(M) for M in mats)])
        return plan_batch(mats)

    def run(plan, *, return_report=False):
        out, reports = execute(plan, return_report=True)
        log[-1][1] = reports
        return (out, reports) if return_report else out

    solver.plan_batch, solver.execute = plan, run
    return log


_SCALAR_TAG = re.compile(r"^(dense|sparse)\(n=(\d+)(,cuda)?\)$")


def _scalar_launches(log: list) -> dict:
    """Launches of the scalar entries the recorded dispatches made: one a
    leaf that ran alone through the scalar path on a kernel (n >= 4; a
    sparse tag names its producer, and a downgrade is no launch)."""
    out = dict.fromkeys(STRAGGLER_ENTRIES, 0)
    for _, reports, cplx in log:
        for rep in reports:
            for tag in rep.dispatch:
                m = _SCALAR_TAG.match(tag)
                if not m or int(m.group(2)) < 4 or \
                        (m.group(1) == "sparse" and not m.group(3)):
                    continue
                name = {("dense", False): "ryser_dense_scalar",
                        ("dense", True): "ryser_complex_scalar",
                        ("sparse", False): "ryser_sparse_scalar",
                        ("sparse", True): "ryser_sparse_complex_scalar"}[
                    (m.group(1), cplx)]
                out[name] += 1
    return out


def _ticket_reports(log: list, tickets) -> dict:
    """The executor report of each served ticket, by ticket id: the k-th
    dispatch of the run resolved its tickets at one clock reading, the
    k-th in order, and within it a ticket's matrix is the first unclaimed
    entry of the dispatch that is the same object."""
    done = [t for t in tickets if t.done]
    times = sorted({t.t_done for t in done})
    if len(times) != len(log):
        raise RuntimeError(f"{len(log)} dispatches recorded, "
                           f"{len(times)} resolved")
    slot = {tt: k for k, tt in enumerate(times)}
    claimed = [set() for _ in log]
    out = {}
    for t in done:
        k = slot[t.t_done]
        mats, reports, _ = log[k]
        i = next(i for i, M in enumerate(mats)
                 if M is t.matrix and i not in claimed[k])
        claimed[k].add(i)
        out[t.id] = reports[i]
    return out


def _entry_sig(report) -> tuple:
    """The entries a matrix's leaves ran through (bucket sizes dropped)."""
    return tuple(sorted(re.sub(r",b=\d+", "", t) for t in report.dispatch))


def _serve_values(log: list, tickets, logs: list) -> dict:
    """Every served value against the same matrix through
    PermanentSolver.plan_batch/execute (result cache off), one plan for
    the distinct real matrices and one for the complex.  Where a ticket's
    leaves ran through the same entries there as in the service (a batch
    entry for a leaf that shared its bucket in both, the scalar entry for
    one alone in both), the values must be equal bit for bit.  A leaf
    alone in its service dispatch but batched in the one plan (or the
    reverse) ran another entry -- dense real: ``baseline`` mode, not
    ``batched`` -- and is held to rel 1e-12 instead.  The plans' own
    launches go into ``logs``."""
    from repro_torch.core.solver import PermanentSolver, SolverConfig
    reps = _ticket_reports(log, tickets)
    done = [t for t in tickets if t.done]
    solver = PermanentSolver(SolverConfig(cache=False))
    want = {}
    for cplx in (False, True):
        mats = list({id(t.matrix): t.matrix for t in done
                     if t.is_complex == cplx}.values())
        if mats:
            vals, wrep = solver.execute(solver.plan_batch(mats),
                                        return_report=True)
            logs.append([(mats, wrep, cplx)])
            for M, v, r in zip(mats, vals, wrep):
                want[id(M)] = (v.item(), _entry_sig(r))
    out = {"bitwise": 0, "bitwise_required": 0, "other": 0,
           "worst_rel_other": 0.0, "worst_rel_required": 0.0,
           "other_cases": {}}
    for t in done:
        w, wsig = want[id(t.matrix)]
        sig = _entry_sig(reps[t.id])
        rel = abs(t.value - w) / max(abs(w), 1e-300)
        out["bitwise"] += t.value == w
        if sig == wsig:
            out["bitwise_required"] += 1
            out["worst_rel_required"] = max(out["worst_rel_required"], rel)
        else:
            out["other"] += 1
            out["worst_rel_other"] = max(out["worst_rel_other"], rel)
            case = f"{'/'.join(sig)} vs {'/'.join(wsig)}"
            out["other_cases"][case] = out["other_cases"].get(case, 0) + 1
    out["ok"] = out["worst_rel_required"] == 0.0 and \
        out["worst_rel_other"] <= 1e-12
    return out


def _pct(xs, q):
    return float(np.percentile(xs, q)) if len(xs) else float("nan")


def _sheds(tickets, expire_every: int) -> dict:
    """The expired-on-arrival set, the shed set, and whether every shed
    is DEADLINE_EXPIRED."""
    expired = {k for k in range(len(tickets))
               if k % expire_every == expire_every - 1}
    shed = {k for k, t in enumerate(tickets) if t.shed}
    typed = all(tickets[k].shed_reason.value == "deadline_expired"
                for k in shed)
    return {"expired": expired, "shed": shed, "typed": typed}


def _service(cfg=None, **kw):
    from repro_torch.core.solver import SolverConfig
    from repro_torch.serve import PermanentService, ServiceConfig
    return PermanentService(cfg or SolverConfig(cache=False), ServiceConfig(
        max_batch=B_SERVE, log_every_s=float("inf"), **kw), log=None)


def _serve_mixed(smoke: Smoke, torch, svc, log: list, logs: list) -> dict:
    """The mixed stream: a closed-loop drain (submit all, then ``drain()``)
    on a fresh service for its perms/s; then the open loop on the warm
    service at half that rate, with latencies by kind, the values held
    against plan_batch/execute and the sheds against the expired set; then
    the same open loop again under torch.profiler for the device's busy
    share."""
    mats, kinds = _mixed_stream(N_SERVE, SEED + 40, SERVE_REQUESTS)
    closed = _service()
    logs.append(_record_dispatches(closed.solver))
    t0 = time.perf_counter()
    for M in mats:
        closed.submit(M, deadline_s=None)
    closed.drain()
    closed_rate = len(mats) / (time.perf_counter() - t0)
    rate = closed_rate / 2
    first, start = len(svc.dispatch_log), len(log)
    res = _open_loop(svc, mats, rate, SEED + 41, EXPIRE_EVERY)
    dlog, run = svc.dispatch_log[first:], log[start:]
    tickets = res["tickets"]
    done = [t for t in tickets if t.done]
    sh = _sheds(tickets, EXPIRE_EVERY)
    vals = _serve_values(run, tickets, logs)
    ds = [dt for _, _, dt, _ in dlog]
    by_kind = {}
    for k, label in enumerate(SERVE_KINDS):
        lat = [t.latency_s for t, kk in zip(tickets, kinds)
               if kk == k and t.done]
        by_kind[label] = {"served": len(lat), "p50_ms": _pct(lat, 50) * 1e3,
                          "p99_ms": _pct(lat, 99) * 1e3}
    lat = [t.latency_s for t in done]
    _, wall_p, dev_p = _profiled(
        torch, lambda: _open_loop(svc, mats, rate, SEED + 41, EXPIRE_EVERY))
    row = {"requests": len(mats), "closed_perms_s": closed_rate,
           "rate_hz": rate, "wall_s": res["wall_s"],
           "perms_s": len(done) / res["wall_s"],
           "p50_ms": _pct(lat, 50) * 1e3, "p99_ms": _pct(lat, 99) * 1e3,
           "by_kind": by_kind,
           "shed": {"deadline_expired": len(sh["shed"])} if sh["typed"]
           else sorted(tickets[k].shed_reason.value for k in sh["shed"]),
           "dispatches": len(dlog),
           "occupancy": float(np.mean([s / B_SERVE for _, s, _, _ in dlog])),
           "mixed_route_dispatches": sum(
               1 for _, reps, _ in run
               if {tg.split("_batch")[0].split("(")[0]
                   for r in reps for tg in r.dispatch} >= {"dense",
                                                           "sparse"}),
           "first_dispatch_ms": ds[0] * 1e3,
           "median_dispatch_ms": float(np.median(ds)) * 1e3,
           "values": vals, "busy_share_profiled": dev_p / wall_p}
    print(f"serve soak mixed n={N_SERVE} ({len(mats)} requests: "
          f"{', '.join(SERVE_KINDS)}): closed loop {closed_rate:.1f} "
          f"perms/s -> open loop at {rate:.1f}/s: {row['perms_s']:.1f} "
          f"perms/s, p50 {row['p50_ms']:.3f} ms p99 {row['p99_ms']:.3f} ms, "
          f"sheds {row['shed']}, {len(dlog)} dispatches "
          f"({row['mixed_route_dispatches']} planned dense and sparse "
          f"leaves together), occupancy {row['occupancy']:.3f}, first "
          f"dispatch {row['first_dispatch_ms']:.3f} ms vs median "
          f"{row['median_dispatch_ms']:.3f} ms, busy share "
          f"{row['busy_share_profiled']:.3f} (profiled re-run, wall "
          f"{wall_p:.3f} s)")
    for label, r in by_kind.items():
        print(f"  {label}: {r['served']} served, p50 {r['p50_ms']:.3f} ms "
              f"p99 {r['p99_ms']:.3f} ms")
    print(f"  values: {vals}")
    smoke.check(sh["shed"] == sh["expired"] and sh["typed"],
                f"serve mixed: sheds are DEADLINE_EXPIRED on exactly the "
                f"{len(sh['expired'])} expired tickets ({len(sh['shed'])})")
    smoke.check(len(done) == len(mats) - len(sh["expired"]) and vals["ok"],
                f"serve mixed: every other ticket served; "
                f"{vals['bitwise_required']} through the same entries as "
                f"plan_batch/execute, bit for bit (worst rel "
                f"{vals['worst_rel_required']:.3e}), {vals['other']} "
                f"through another entry within rel "
                f"{vals['worst_rel_other']:.3e} <= 1e-12")
    return row


def _serve_density(smoke: Smoke, torch, svc, log: list,
                   logs: list) -> dict:
    """The soak CLI's sparse traffic, random masks at density 0.2, through
    ``run_soak`` itself at SERVE_DENSITY_REQUESTS requests: a closed-loop
    drain of the same stream for its rate, then the open loop at half of
    it.  Each dispatch's seconds are mostly DM/FM planning.  Sheds must be
    typed and cover the expired set; a request queued past its lane's
    deadline behind a long plan is shed too, and counted."""
    from repro_torch.serve import run_soak
    seed, k = SEED + 43, SERVE_DENSITY_REQUESTS
    mats = _density_stream(N_SERVE, seed, k)
    closed = _service()
    logs.append(_record_dispatches(closed.solver))
    t0 = time.perf_counter()
    for M in mats:
        closed.submit(M, deadline_s=None)
    closed.drain()
    closed_s = time.perf_counter() - t0
    rate = k / closed_s / 2
    first, start = len(svc.dispatch_log), len(log)
    res = run_soak(svc, requests=k, rate_hz=rate, n=N_SERVE,
                   density=SERVE_DENSITY, repeat_pool=SERVE_DENSITY_POOL,
                   seed=seed, expire_every=SERVE_DENSITY_EXPIRE)
    dlog, run = svc.dispatch_log[first:], log[start:]
    tickets = res["tickets"]
    done = [t for t in tickets if t.done]
    sh = _sheds(tickets, SERVE_DENSITY_EXPIRE)
    t_v = time.perf_counter()
    vals = _serve_values(run, tickets, logs)
    vals_s = time.perf_counter() - t_v
    lat = [t.latency_s for t in done]
    ds = [dt for _, _, dt, _ in dlog]
    leaves = [sum(len(r.dispatch) for r in reps) for _, reps, _ in run]
    row = {"requests": k, "closed_s": closed_s, "rate_hz": rate,
           "wall_s": res["wall_s"], "perms_s": len(done) / res["wall_s"],
           "p50_ms": _pct(lat, 50) * 1e3, "p99_ms": _pct(lat, 99) * 1e3,
           "shed": len(sh["shed"]), "expired": len(sh["expired"]),
           "late_sheds": len(sh["shed"] - sh["expired"]),
           "dispatch_s": ds, "leaves": leaves, "values": vals,
           "values_check_s": vals_s}
    print(f"serve soak density {SERVE_DENSITY} n={N_SERVE} (run_soak, {k} "
          f"requests, pool {SERVE_DENSITY_POOL}): closed loop "
          f"{closed_s:.3f} s -> open loop at {rate:.3f}/s: "
          f"{row['perms_s']:.3f} perms/s, p50 {row['p50_ms']:.1f} ms p99 "
          f"{row['p99_ms']:.1f} ms, sheds {len(sh['shed'])} "
          f"({row['late_sheds']} queued past their deadline besides the "
          f"{len(sh['expired'])} expired), dispatch seconds "
          f"{[round(d, 3) for d in ds]}, leaves a dispatch (fillers "
          f"included) {leaves}; one plan of the distinct matrices "
          f"for the values {vals_s:.3f} s")
    print(f"  values: {vals}")
    smoke.check(sh["expired"] <= sh["shed"] and sh["typed"],
                f"serve density: every shed is DEADLINE_EXPIRED and the "
                f"{len(sh['expired'])} expired tickets are shed "
                f"({len(sh['shed'])} shed)")
    smoke.check(len(done) == k - len(sh["shed"]) and vals["ok"],
                f"serve density: every other ticket served; "
                f"{vals['bitwise_required']} bit for bit with "
                f"plan_batch/execute, {vals['other']} through another "
                f"entry within rel {vals['worst_rel_other']:.3e} <= 1e-12")
    return row


def _serve_fill_first(smoke: Smoke, torch) -> dict:
    """run_permanent_serving (the service in fill_first mode) against a
    direct drain of the solver queue over the same stream, bit for bit.
    Both flush the same buckets (result cache on: a bucket computes each
    new distinct matrix once), so each launches the scalar entries the
    recorded drain does; returns the count with the figures."""
    from repro_torch.core.solver import PermanentSolver, SolverConfig
    from repro_torch.launch.serve import run_permanent_serving
    n, batch, requests, pool_n, seed = N_SERVE, B_SERVE, 256, 16, SEED + 50
    t0 = time.perf_counter()
    out = run_permanent_serving(n=n, batch=batch, requests=requests,
                                repeat_pool=pool_n, deadline_s=1e9, seed=seed)
    rng = np.random.default_rng(seed)
    pool = [rng.uniform(-1, 1, (n, n)) for _ in range(pool_n)]
    mats = [pool[i] for i in rng.integers(0, pool_n, requests)]
    solver = PermanentSolver(SolverConfig(queue_max_batch=batch,
                                          queue_max_delay_s=1e9))
    log = _record_dispatches(solver)
    reqs = [solver.submit(M) for M in mats]
    solver.flush()
    ref = np.array([r.result() for r in reqs])
    ok = bool(np.array_equal(out["values"], ref))
    print(f"serve fill_first: {requests} requests n={n} batch {batch}: "
          f"{out['batches']} batches, {out['perms_per_s']:.1f} perms/s "
          f"steady, bit for bit with the solver queue {ok} "
          f"({time.perf_counter() - t0:.2f} s)")
    smoke.check(ok, "serve: run_permanent_serving equals a direct drain of "
                    "the solver queue bit for bit")
    return {"batches": out["batches"], "perms_s": out["perms_per_s"],
            "bitwise": ok, "scalar": {k: 2 * v for k, v in
                                      _scalar_launches(log).items()}}


def _serve_campaign(smoke: Smoke, torch) -> dict:
    """All-ones n = 34 at 256 slices interleaved with bucket dispatches
    (3 full buckets of 64: no scalar entry but the wave body), one wave a
    dispatch, run out by drain: bit for bit with run_campaign at the same
    spec, and within 1e-10 of 34!."""
    from repro_torch.core import distributed as Dm
    from repro_torch.core.solver import SolverConfig
    from repro_torch.serve import CampaignSpec, PermanentService, ServiceConfig
    n = SERVE_CAMPAIGN_N
    C = np.ones((n, n))
    svc = PermanentService(
        SolverConfig(cache=False),
        ServiceConfig(max_batch=B_SERVE, log_every_s=float("inf")),
        campaign=CampaignSpec(matrix=C, waves=1,
                              slices=SERVE_CAMPAIGN_SLICES), log=None)
    rng = np.random.default_rng(SEED + 60)
    for _ in range(3 * B_SERVE):
        svc.submit(rng.uniform(-1, 1, (N_SERVE, N_SERVE)), deadline_s=None)
    fractions = []
    t0 = time.perf_counter()
    while svc.pending:
        svc.step()
        fractions.append(svc.campaign_fraction)
    svc.drain()
    dt = time.perf_counter() - t0
    want, _ = Dm.run_campaign(C, **svc.campaign_body())
    exact = float(math.factorial(n))
    rel = abs(svc.campaign_value - exact) / exact
    ok = svc.campaign_value == want
    print(f"serve campaign: all-ones n={n}, {SERVE_CAMPAIGN_SLICES} slices, "
          f"fraction after each dispatch {[round(f, 4) for f in fractions]}, "
          f"value {svc.campaign_value:.17e} (run_campaign {want:.17e}), rel "
          f"to {n}! {rel:.3e}, {dt:.2f} s with {len(fractions)} dispatches")
    smoke.check(ok and rel <= ONES_BAR and 0 < fractions[0] < 1,
                f"serve: the interleaved campaign advances a wave a dispatch "
                f"and ends bit for bit on run_campaign's value, rel "
                f"{rel:.3e} <= {ONES_BAR:g} of {n}!")
    return {"fractions": fractions, "rel": rel, "bitwise": ok}


def cold_band_main(root: str) -> int:
    """``--cold-band ROOT``: one cold process of the service on the sparse
    stand-in stream (the mixed stream's band matrices, real, one object a
    request so every dispatch computes), with the kernel library under
    ROOT: warm-up, then the open loop; prints its first and median
    dispatch and the compile counters as one JSON line."""
    from repro_torch.core.solver import SolverConfig
    from repro_torch.serve import compile_stats
    t0 = time.perf_counter()
    svc = _service(SolverConfig(), compile_cache_dir=root,
                   warmup_ns=(N_SERVE,))
    warm_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 70)
    mats = [_circulant_sparse(rng, N_SERVE, BUCKET_DEGREE)
            for _ in range(COLD_REQUESTS)]
    res = _open_loop(svc, mats, COLD_RATE, SEED + 71, 0)
    ds = [dt for _, _, dt, _ in svc.dispatch_log]
    print(json.dumps({
        "warmup_s": warm_s, "first_ms": ds[0] * 1e3,
        "median_ms": float(np.median(ds)) * 1e3, "dispatches": len(ds),
        "completed": sum(t.done for t in res["tickets"]),
        "compile": compile_stats()}))
    return 0


def _cold_run(cmd: list, env: dict, label: str, js: str | None) -> dict:
    t0 = time.perf_counter()
    r = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    wall = time.perf_counter() - t0
    print(f"cold start {label} (exit {r.returncode}, {wall:.1f} s):")
    print("  " + "\n  ".join(r.stdout.strip().splitlines()[-4:]))
    if r.returncode != 0:
        print(r.stderr[-3000:])
        return {"label": label, "rc": r.returncode}
    if js is None:                       # the --cold-band process
        out = json.loads(r.stdout.strip().splitlines()[-1])
        return {"label": label, "rc": 0, "wall_s": wall, **out}
    m = re.search(r"dispatch: first ([\d.]+)ms, median ([\d.]+)ms",
                  r.stdout)
    with open(js) as f:
        snap = json.load(f)
    return {"label": label, "rc": 0, "wall_s": wall,
            "first_ms": float(m.group(1)), "median_ms": float(m.group(2)),
            "compile": snap["compile_cache"],
            "completed": snap["requests"]["completed"]}


def _serve_cold_start(smoke: Smoke, torch) -> dict:
    """Cold processes sharing a kernel-library root (seeded with a copy of
    this run's build, so none pays the nvcc build again) with an ``nvcc``
    on PATH that fails and leaves a mark: two of the soak CLI on dense
    traffic (pool 4096, so every dispatch computes), one of the CLI on
    density-0.2 traffic (one matrix, SLO loose), and one on the sparse
    stand-in stream (``--cold-band``).  Each must load the library from
    the root without nvcc; all but the first must serve their first
    bucket within 2x of their median dispatch."""
    import shutil
    from repro_torch.kernels import build
    root = tempfile.mkdtemp(prefix="serve-cache-")
    fake = tempfile.mkdtemp(prefix="fake-nvcc-")
    shutil.copytree(build.build_dir(),
                    os.path.join(root, build.build_dir().name))
    mark = os.path.join(fake, "nvcc-ran")
    with open(os.path.join(fake, "nvcc"), "w") as f:
        f.write(f"#!/bin/sh\ntouch {mark}\nexit 1\n")
    os.chmod(os.path.join(fake, "nvcc"), 0o755)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               PATH=fake + os.pathsep + os.environ.get("PATH", ""))
    cli = [sys.executable, "-m", "repro_torch.launch.serve", "--soak",
           "--perm-n", str(N_SERVE), "--batch", str(B_SERVE),
           "--compile-cache", root]
    runs = []
    try:
        for k in (1, 2):
            js = os.path.join(root, f"metrics{k}.json")
            runs.append(_cold_run(
                cli + ["--requests", str(COLD_REQUESTS), "--repeat-pool",
                       "4096", "--rate", str(COLD_RATE), "--metrics-json",
                       js], env, f"{k} (dense)", js))
        js = os.path.join(root, "metrics-density.json")
        runs.append(_cold_run(
            cli + ["--requests", str(COLD_DENSITY_REQUESTS), "--density",
                   str(SERVE_DENSITY), "--repeat-pool", "1", "--rate",
                   str(COLD_DENSITY_RATE), "--slo-ms",
                   str(COLD_DENSITY_SLO_MS), "--metrics-json", js],
            env, f"3 (density {SERVE_DENSITY})", js))
        runs.append(_cold_run(
            [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
             "--cold-band", root], env, "4 (sparse stand-in)", None))
    finally:
        shutil.rmtree(root, ignore_errors=True)
        nvcc_ran = os.path.exists(mark)
        shutil.rmtree(fake, ignore_errors=True)
    ok = all(r["rc"] == 0 for r in runs) and not nvcc_ran
    for k, r in enumerate(runs):
        if r["rc"] != 0:
            continue
        c = r["compile"]
        ok = ok and c["persistent_misses"] == 0 and c["requests"] >= 1 \
            and c["persistent_hits"] == c["requests"] \
            and (k == 0 or r["first_ms"] <= 2 * r["median_ms"])
    smoke.check(ok, f"serve cold start: every process loads the kernel "
                    f"library without nvcc (persistent_misses 0, nvcc ran "
                    f"{nvcc_ran}) and each after the first serves its first "
                    f"bucket within 2x of its median dispatch: {runs}")
    return {"runs": runs, "nvcc_ran": nvcc_ran}


def _deltas(RC, before: dict) -> dict:
    return {k: RC.counters[k] - before.get(k, 0) for k in STRAGGLER_ENTRIES}


def phase_serve(smoke: Smoke, torch) -> None:
    """The always-on service on the card (``repro_torch.serve``): warm-up
    over the ladder at n = 24 (real and complex), the open-loop soak of
    the mixed stream, the density-0.2 soak, fill_first against the solver
    queue, an interleaved campaign, cold processes.  The launch counters
    across the phase (this process) may show only the batch entries #2,
    #4, #6, #8, the scalar entries as often as a leaf ran alone in its
    bucket (warm-up and soaks), and #1 while the campaign runs."""
    from repro_torch.kernels import ryser_cuda as RC
    from repro_torch.serve import compile_stats, quantized_batches
    t0 = time.perf_counter()
    RC.reset_counters()
    svc = _service(warmup_ns=(N_SERVE,), warmup_complex=True)
    wr = svc.warmup_report
    ladder = quantized_batches(B_SERVE)
    print(f"serve warm-up: {wr['geometries']} geometries (n = {N_SERVE}, "
          f"batches {ladder}, real and complex, then one sparse matrix "
          f"each) in {wr['seconds']:.3f} s; compile counters of the pass "
          f"{wr['compile']}, of the process {compile_stats()}")
    # a one-matrix geometry and the sparse matrix of each kind ran alone
    b1 = int(1 in ladder)
    alone = {"ryser_dense_scalar": b1, "ryser_complex_scalar": b1,
             "ryser_sparse_scalar": 1, "ryser_sparse_complex_scalar": 1}
    warm = _deltas(RC, {})
    log = _record_dispatches(svc.solver)
    logs = [log]
    before = dict(RC.counters)
    out = {"warmup": wr,
           "soak": _serve_mixed(smoke, torch, svc, log, logs),
           "density": _serve_density(smoke, torch, svc, log, logs)}
    soaks = _deltas(RC, before)
    recorded = dict.fromkeys(STRAGGLER_ENTRIES, 0)
    for log in logs:
        for k, v in _scalar_launches(log).items():
            recorded[k] += v
    before = dict(RC.counters)
    out["fill_first"] = _serve_fill_first(smoke, torch)
    fill = _deltas(RC, before)
    before = dict(RC.counters)
    out["campaign"] = _serve_campaign(smoke, torch)
    during = _deltas(RC, before)
    launches = {k: v for k, v in RC.counters.items() if v}
    print(f"serve launches (this process): {launches}; scalar entries: "
          f"warm-up {warm} (one-leaf buckets {alone}), soaks {soaks} "
          f"(one-leaf buckets in their executor reports {recorded}), "
          f"fill_first {fill} (twice the recorded drain's "
          f"{out['fill_first']['scalar']}), campaign {during}")
    ok = (set(launches) <= set(SERVE_ENTRIES) | set(STRAGGLER_ENTRIES)
          | {RC.FREE_ROWS_COUNTER}
          and all(RC.counters[k] > 0 for k in SERVE_ENTRIES)
          and warm == alone and soaks == recorded
          and fill == out["fill_first"]["scalar"]
          and during["ryser_dense_scalar"] > 0
          and {k: v for k, v in during.items()
               if k != "ryser_dense_scalar"} ==
          {k: 0 for k in STRAGGLER_ENTRIES if k != "ryser_dense_scalar"})
    smoke.check(ok, f"serve: the four batch entries launch; a scalar entry "
                    f"launches once for each leaf alone in its bucket "
                    f"(warm-up and soaks) and #1 for the campaign's waves; "
                    f"no plain version: {launches}")
    out["cold_start"] = _serve_cold_start(smoke, torch)
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t0
    print(f"serve phase: {out['seconds']:.1f} s")
    smoke.summary["serve"] = out


# ---------------------------------------------------------------------------
# The examples and the invariant gate
# ---------------------------------------------------------------------------

KERNEL_ENTRIES = ("ryser_dense_scalar", "ryser_dense_batched",
                  "ryser_complex_scalar", "ryser_complex_batched",
                  "ryser_sparse_scalar", "ryser_sparse_batched",
                  "ryser_sparse_complex_scalar",
                  "ryser_sparse_complex_batched")
EXAMPLES = ("quickstart", "boson_sampling", "sparse_matchings",
            "large_permanent", "service")
# the examples' own bars on the card (all-ones n = 30 per precision; the
# n = 30 matrix through the kernel and through the torch engine)
ONES_PREC_BAR = {"dd": 1e-6, "dq_acc": 1e-8, "kahan": 1e-8}
ENGINES_BAR = 1e-9
PROVE_EXTENT = (24, 256, 251)      # n, and two batch extents


class _Tee:
    """A stdout that also keeps what it is given."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def _example_checks(name: str, out: dict, printed: str) -> list:
    """(ok, what) pairs of what example ``name`` asserts on the card."""
    oks = printed.count("OK")
    if name == "quickstart":
        rel = abs(out["cuda"] - out["torch"]) / abs(out["torch"])
        return [
            (all(math.isfinite(abs(v)) for v in (
                out["perm_random"], out["perm_sparse"], out["perm_band"],
                out["perm_complex"], out["stack_first"])),
             "quickstart: finite values"),
            (rel <= ENGINES_BAR, f"quickstart: n = 30 kernel #1 vs torch "
                                 f"engine rel {rel:.3e} <= {ENGINES_BAR}"),
            (all(out["precision_rel"][m] <= b
                 for m, b in ONES_PREC_BAR.items()),
             f"quickstart: all-ones n = 30 rel.err {out['precision_rel']} "
             f"within {ONES_PREC_BAR}"),
            ("sparse(n=32,cuda)" in out["band_dispatch"],
             f"quickstart: the n = 32 band ran whole on the sparse route "
             f"{out['band_dispatch']}"),
            (out["matchings"] == 5, "quickstart: 5 matchings of the path")]
    if name == "boson_sampling":
        return [(oks == 3, f"boson_sampling: {oks} of 3 OK lines"),
                (out["tags"] == ["dense_batch(n=24,b=256)"],
                 f"boson_sampling: one bucket of 256 x 24, no downgrade "
                 f"{out['tags']}")]
    if name == "sparse_matchings":
        return [(oks == 3 and out["band_ok"],
                 f"sparse_matchings: {oks} of 3 OK lines; the band n = 32 "
                 f"sparse route vs kernel #1 rel {out['band_rel']:.3e} <= "
                 f"1e-12")]
    if name == "large_permanent":
        return [(oks == 1 and out["bitwise"] and out["rel"] < 1e-9,
                 f"large_permanent: n = 36 resumed campaign equals the "
                 f"uninterrupted one bit for bit, rel {out['rel']:.3e} to "
                 f"the scalar entry #1 (< 1e-9: chunks of 2^15 steps)")]
    return [(out["schema"] == "repro.serve.metrics/v1"
             and out["completed"] == 7
             and out["shed_counts"] == {"deadline_expired": 1},
             f"service: GET /metrics schema {out['schema']}, 7 completed, "
             f"one typed shed {out['shed_counts']}")]


def phase_examples(smoke: Smoke, torch) -> dict:
    """Each example's ``main(device="cuda")`` at its card sizes, with the
    launch counters set to 0 just before it and read just after; returns
    the launches of #1-#8 over the examples."""
    import importlib

    from repro_torch.kernels import ryser_cuda as RC
    t0 = time.perf_counter()
    total = dict.fromkeys(RC.counters, 0)
    per, seconds = {}, {}
    for name in EXAMPLES:
        module = importlib.import_module(f"repro_torch.examples.{name}")
        tee = _Tee(sys.stdout)
        t = time.perf_counter()
        RC.reset_counters()
        try:
            with contextlib.redirect_stdout(tee):
                out = module.main(device="cuda")
            checks = _example_checks(name, out, "".join(tee.parts))
        except Exception as e:   # noqa: BLE001 -- a failed example is a check
            checks = [(False, f"{name}: raised {e!r}")]
        launches = {k: v for k, v in RC.counters.items() if v}
        seconds[name] = time.perf_counter() - t
        for k, v in launches.items():
            total[k] += v
        per[name] = launches
        for ok, what in checks:
            smoke.check(ok, what)
        print(f"example {name}: {seconds[name]:.2f} s, launches {launches}")
    plain = {k: v for k, v in total.items() if k.startswith("block_partials")
             and v}
    smoke.check(not plain, f"examples: no plain version ran on the card "
                           f"{plain}")
    out = {"per_example": per, "seconds_per_example": seconds,
           "launches": {k: v for k, v in total.items() if v},
           "seconds": time.perf_counter() - t0}
    print(f"examples phase: {out['seconds']:.1f} s; launches of #1-#8: "
          f"{ {k: total[k] for k in KERNEL_ENTRIES} }")
    smoke.summary["examples"] = out
    return total


def phase_prove(smoke: Smoke, torch) -> dict:
    """torchprove on the card: the 20 entries at 5 precisions (the cuda
    ones through kernels #1-#8, their f32 twins run twice), held against
    the CPU goldens bit for bit, run twice and at B = 5 and 7; then the
    four batch entries at the main path's width, member i of a 256 x 24
    stack against member i of a 251 x 24 stack, bit for bit."""
    from repro_torch.analysis import prove
    from repro_torch.kernels import ryser_cuda as RC
    t0 = time.perf_counter()
    RC.reset_counters()
    report = prove.run_check(device="cuda")
    print(prove.render(report))
    g = report["goldens"]
    smoke.check(not prove.failed(report),
                f"prove: {len(report['entries'])} entries x "
                f"{len(prove.PRECISIONS)} precisions on the card, "
                f"{len(report['findings'])} finding(s), "
                f"{len(g['drifted'])} value(s) off the CPU goldens, "
                f"{len(g['missing'])} golden(s) missing")
    n, b_a, b_b = PROVE_EXTENT
    extent = prove.extent_invariance(n, b_a, b_b, device="cuda")
    smoke.check(all(v == 0 for v in extent.values()),
                f"prove: member i of a {b_a} x {n} stack equals member i of "
                f"a {b_b} x {n} stack bit for bit in the four batch entries "
                f"(members that differ: {extent})")
    launches = {k: v for k, v in RC.counters.items() if v}
    want = set(KERNEL_ENTRIES) | {f"{k}_f32" for k in KERNEL_ENTRIES}
    smoke.check(want <= set(launches) and not any(
        k.startswith("block_partials") for k in launches),
        f"prove: #1-#8 and their f32 twins launched, no plain version "
        f"{launches}")
    out = {"findings": [f.to_json() for f in report["findings"]],
           "drifted": g["drifted"], "missing": g["missing"],
           "extent": extent, "launches": launches,
           "seconds": time.perf_counter() - t0}
    print(f"prove phase: {out['seconds']:.1f} s")
    smoke.summary["prove"] = out
    return launches


# ---------------------------------------------------------------------------
# Multi-device: the mesh functions over worlds of ranks sharing the card
# ---------------------------------------------------------------------------

MESH_WORLDS = (1, 2, 4)              # ranks, all on the one card
N_MESH_CX = 28                       # the complex step split
# the all-ones campaign timed a world: n = 40 at world 1, 36 at the wider
# worlds (a sixteenth of the time: the smoke's limit)
MESH_ONES = {1: 40, 2: 36, 4: 36}
MESH_RAGGED = 251                    # a ragged bucket at the widest world
MESH_WORLD_TIMEOUT_S = 300.0         # a world that outlives this fails
MESH_CLI_TIMEOUT_S = 300.0
# the campaign CLI chain's slices: the port's default, 1024; a wave fills
# the card (64 slices a rank at n = 36), so 256 would end at world 4
MESH_KILL_SLICES = 1024
# the service over a mesh: the serve phase's mixed stream closed loop at
# every world, an open-loop soak at half that rate at MESH_SOAK_WORLD, a
# 2 x 2 CampaignMesh at world 4 with the serve phase's campaign, and the
# tuner's campaign route at the wider worlds
MESH_SERVE_REQUESTS, MESH_SOAK_REQUESTS, MESH_SOAK_WORLD = 256, 512, 2
MESH_SERVE_ENTRIES = SERVE_ENTRIES


def _mesh_config() -> dict:
    """The mesh phase's sizes and device, sent to every rank (the ranks
    start from a fresh import).  The main path's widths on the card."""
    return dict(device=None, n=N_MAIN, n_cx=N_MESH_CX, b=B_THRU, nb=N_THRU,
                degree=BUCKET_DEGREE, n_leaf=N_SPARSE,
                leaf_degree=SPARSE_DEGREE, ragged=MESH_RAGGED,
                n_ones=MESH_ONES, n_kill=CAMPAIGN_KILL_N,
                kill_slices=MESH_KILL_SLICES, serve_n=N_SERVE,
                serve_batch=B_SERVE, serve_requests=MESH_SERVE_REQUESTS,
                soak_requests=MESH_SOAK_REQUESTS, soak_world=MESH_SOAK_WORLD,
                camp_n=SERVE_CAMPAIGN_N, camp_slices=SERVE_CAMPAIGN_SLICES,
                tune_n=N_TUNE_CAMPAIGN, ckpt=None)


def _mesh_inputs(cfg: dict) -> dict:
    """The mesh paths' matrices, from the seed: dense real n and complex
    n_cx (the step split), b x nb stacks dense real and complex and
    circulant bands of the bucket degree real and complex (the sharded
    buckets), a band leaf n_leaf real and complex (scalar sparse leaves)."""
    rng = np.random.default_rng(SEED + 70)
    b, nb = cfg["b"], cfg["nb"]
    bands = lambda cplx: np.stack([  # noqa: E731
        _circulant_sparse(rng, nb, cfg["degree"], cplx) for _ in range(b)])
    return {"dense": rng.uniform(-1, 1, (cfg["n"], cfg["n"])),
            "complex": _cgauss(rng, (cfg["n_cx"], cfg["n_cx"])),
            "dense_batch": rng.uniform(-1, 1, (b, nb, nb)),
            "complex_batch": _cgauss(rng, (b, nb, nb)),
            "sparse_batch": bands(False), "sparse_complex_batch": bands(True),
            "leaf": _circulant_sparse(rng, cfg["n_leaf"], cfg["leaf_degree"]),
            "leaf_complex": _circulant_sparse(rng, cfg["n_leaf"],
                                              cfg["leaf_degree"], True)}


def _mesh_rank(rank: int, world: int, cfg: dict) -> dict:
    """One rank of a world: the mesh main path through the entry points a
    user calls, with this rank's launch counters set to 0 just before and
    read just after -- the step split of dense n and complex n_cx
    (``permanent(backend="distributed")``), the four b x nb buckets and a
    ragged one at world 4 (``permanent_batch(backend="distributed_batch")``),
    the scalar sparse leaves (``distributed``: #5 / #7 on every rank), and
    the all-ones n_ones campaign, its waves over the ranks, timed from a
    barrier."""
    import torch

    import repro_torch
    from repro_torch.kernels import build
    from repro_torch.kernels import ryser_cuda as RC
    from repro_torch.launch import mesh as M
    mesh = M.make_mesh((world,), ("step",), device=cfg["device"],
                       ranks_per_device=world)
    if mesh.device.type == "cuda":
        build.load_library()     # the parent's build: a load, no nvcc
    ins = _mesh_inputs(cfg)
    kw = dict(distributed_ctx=mesh, device=cfg["device"])
    values, tags = {}, {}
    torch.distributed.barrier()
    RC.reset_counters()
    t0 = time.perf_counter()
    for key in ("dense", "complex", "leaf", "leaf_complex"):
        values[key], rep = repro_torch.permanent(
            ins[key], backend="distributed", return_report=True, **kw)
        tags[key] = rep.dispatch
    batches = ["dense_batch", "complex_batch", "sparse_batch",
               "sparse_complex_batch"]
    if world == max(MESH_WORLDS):
        ins["ragged"] = ins["dense_batch"][:cfg["ragged"]]
        batches.append("ragged")
    for key in batches:
        values[key], reps = repro_torch.permanent_batch(
            ins[key], backend="distributed_batch", return_report=True, **kw)
        tags[key] = sorted({t for r in reps for t in r.dispatch})
    main_s = time.perf_counter() - t0
    torch.distributed.barrier()
    t1 = time.perf_counter()
    m = cfg["n_ones"][world]
    values["ones"], rep = repro_torch.permanent(
        np.ones((m, m)), backend="distributed", return_report=True, **kw)
    tags["ones"] = rep.dispatch
    ones_s = time.perf_counter() - t1
    out = {"values": values, "tags": tags, "counters": dict(RC.counters),
           "main_s": main_s, "ones_s": ones_s, "device": str(mesh.device),
           "shard": mesh.index}
    out["serve"] = _mesh_serve_legs(world, cfg, mesh)
    return out


def _ticket_sizes(log: list, tickets: list) -> list:
    """The size of the dispatch each ticket's matrix went in (padding
    included; None if it never went), from ``_record_dispatches``'s log:
    a request alone in its dispatch runs another entry."""
    sizes = {id(M): len(mats) for mats, _, _ in log for M in mats}
    return [sizes.get(id(t.matrix)) for t in tickets]


def _mesh_serve_legs(world: int, cfg: dict, mesh) -> dict:
    """The service and the tuner over this world, each leg with the
    launch counters set to 0 just before it and read just after: the
    mixed stream closed loop over the ("step",) mesh (every world); the
    open-loop soak at half that rate (world ``soak_world``); a 2 x 2
    CampaignMesh with the serve phase's campaign, run out and stopped
    after its first dispatch with a checkpoint (world 4); the tuner's
    campaign route (the wider worlds), its table saved a rank and planned.
    Shard 0 returns the tickets' values and bucket sizes; every rank its
    launches."""
    import torch

    from repro_torch.core.planner import ROUTE_CAMPAIGN
    from repro_torch.core.solver import PermanentSolver, SolverConfig
    from repro_torch.kernels import ryser_cuda as RC
    from repro_torch.launch import mesh as M
    from repro_torch.serve import CampaignSpec, PermanentService, ServiceConfig
    from repro_torch.tune.search import tune_table
    dev, n, B = cfg["device"], cfg["serve_n"], cfg["serve_batch"]
    scfg = SolverConfig(backend="distributed", cache=False, device=dev)
    out: dict = {"launches": {}}

    def leg(name, ctx, drive, campaign=None, **service):
        """One service over ``ctx``: shard 0 runs ``drive(svc)``, the
        others follow; the leg's launches on every rank."""
        torch.distributed.barrier()
        RC.reset_counters()
        svc = PermanentService(scfg, ServiceConfig(
            max_batch=B, log_every_s=float("inf"), **service),
            distributed_ctx=ctx, campaign=campaign, log=None)
        if svc.leader:
            log = _record_dispatches(svc.solver)
            with svc:
                out[name] = drive(svc, log)
        else:
            svc.follow()
        out["launches"][name] = dict(RC.counters)

    def closed(svc, log):
        mats, kinds = _mixed_stream(n, SEED + 80, cfg["serve_requests"])
        t0 = time.perf_counter()
        ts = [svc.submit(np.array(A), deadline_s=None) for A in mats]
        svc.drain()
        wall = time.perf_counter() - t0
        return {"values": [t.result() for t in ts], "kinds": kinds,
                "sizes": _ticket_sizes(log, ts), "wall_s": wall,
                "perms_s": len(ts) / wall}

    leg("closed", mesh, closed)
    if world == cfg["soak_world"]:
        def soak(svc, log):
            rate = out["closed"]["perms_s"] / 2
            mats, kinds = _mixed_stream(n, SEED + 81, cfg["soak_requests"])
            got = _open_loop(svc, mats, rate, SEED + 82, EXPIRE_EVERY)
            ts = got["tickets"]
            lat = sorted(t.latency_s for t in ts if t.done)
            return {"rate": rate, "kinds": kinds, "wall_s": got["wall_s"],
                    "values": [t.result() if t.done else None for t in ts],
                    "shed": [t.shed_reason.value if t.shed else None
                             for t in ts],
                    "sizes": _ticket_sizes(log, ts),
                    "p50_ms": _pct(lat, 50) * 1e3,
                    "p99_ms": _pct(lat, 99) * 1e3,
                    "requests": svc.snapshot()["requests"]}
        leg("soak", mesh, soak)
    if world == 4:
        cm = M.make_campaign_mesh(2, 2, device=dev, ranks_per_device=world)
        C = np.ones((cfg["camp_n"],) * 2)
        for name, stop in (("campaign", False), ("stopped", True)):
            spec = CampaignSpec(matrix=C, waves=1,
                                slices=cfg["camp_slices"],
                                checkpoint=cfg["ckpt"] if stop else None)

            def camp(svc, log, stop=stop):
                rng = np.random.default_rng(SEED + 60)
                for _ in range(3 * B):
                    svc.submit(rng.uniform(-1, 1, (n, n)), deadline_s=None)
                t0 = time.perf_counter()
                svc.step()
                if not stop:
                    svc.drain()
                return {"value": svc.campaign_value,
                        "fraction": svc.campaign_fraction,
                        "body": {k: v for k, v in svc.campaign_body().items()
                                 if k != "geometry"},
                        "wall_s": time.perf_counter() - t0}
            leg(name, cm, camp, campaign=spec)
    if world > 1:
        step = M.make_mesh((world,), ("step",), device=dev,
                           ranks_per_device=world)
        torch.distributed.barrier()
        RC.reset_counters()
        t0 = time.perf_counter()
        table, rows = tune_table(["campaign"], [cfg["tune_n"]], mesh=step)
        wall = time.perf_counter() - t0
        path = f"{cfg['ckpt']}.tune{torch.distributed.get_rank()}.json"
        table.save(path)
        planned = PermanentSolver(SolverConfig(
            tuning_table=path, device=dev, cache=False,
            campaign_threshold=-1.0)).plan(np.ones((cfg["tune_n"],) * 2))
        geo = [l.campaign.geometry for l in planned.leaves
               if l.route == ROUTE_CAMPAIGN]
        out["tune"] = {"entries": sorted((k, e.geometry.tag(), e.measured_s,
                                          e.default_s)
                                         for k, e in table.entries.items()),
                       "rows": rows, "planned": [g.tag() if g else None
                                                 for g in geo],
                       "wall_s": wall}
        out["launches"]["tune"] = dict(RC.counters)
    return out


def _mesh_references(smoke: Smoke, cfg: dict, ins: dict) -> dict:
    """The one-device values the worlds are held against, computed in
    this process on the card: ``run_campaign`` at each world's slice
    decomposition (what ``permanent_on_mesh`` cuts), the ``cuda``
    backend's buckets and leaves, the all-ones campaign (phase
    ``campaign``'s value when it ran)."""
    import repro_torch
    from repro_torch.core import distributed as D
    from repro_torch.core.stepspace import plan_slices
    dev = cfg["device"]
    ref = {}
    for world in MESH_WORLDS:
        for key in ("dense", "complex"):
            A = ins[key]
            ts, cps, C = plan_slices(A.shape[0], world, 1, D.MESH_LANES)
            ref[world, key] = D.run_campaign(
                A, total_slices=ts, chunks_per_slice=cps, chunk_size=C,
                device=dev)[0]
    for key in ("dense", "leaf", "leaf_complex"):
        ref[key] = repro_torch.permanent(ins[key], device=dev)
    for key in ("dense_batch", "complex_batch", "sparse_batch",
                "sparse_complex_batch"):
        ref[key] = repro_torch.permanent_batch(ins[key], device=dev)
    ref["ragged"] = repro_torch.permanent_batch(
        ins["dense_batch"][:cfg["ragged"]], device=dev)
    main = smoke.summary.get("campaign", {}).get("main", {})
    ones: dict = {}
    for world in MESH_WORLDS:
        m = cfg["n_ones"][world]
        if m not in ones:
            ones[m] = main["value"] if main.get("n") == m else \
                repro_torch.permanent(np.ones((m, m)), device=dev)
        ref[world, "ones"] = ones[m]
    return ref


def _mesh_serve_references(cfg: dict) -> dict:
    """What the service legs are held against, on one device in this
    process: the mixed stream closed loop through the one-device service
    (the ``cuda`` backend, the same mode), the soak stream's distinct
    matrices through the batch entries (a member's value does not depend
    on its bucket), and the campaign through ``run_campaign``."""
    import repro_torch
    from repro_torch.core import distributed as Dm
    from repro_torch.core.solver import SolverConfig
    from repro_torch.serve import CampaignSpec, PermanentService, ServiceConfig
    dev, n, B = cfg["device"], cfg["serve_n"], cfg["serve_batch"]
    scfg = SolverConfig(cache=False, device=dev)
    svc = PermanentService(scfg, ServiceConfig(
        max_batch=B, log_every_s=float("inf")), log=None)
    log = _record_dispatches(svc.solver)
    mats, _ = _mixed_stream(n, SEED + 80, cfg["serve_requests"])
    t0 = time.perf_counter()
    ts = [svc.submit(np.array(A), deadline_s=None) for A in mats]
    svc.drain()
    wall = time.perf_counter() - t0
    out = {"closed": {"values": [t.result() for t in ts],
                      "sizes": _ticket_sizes(log, ts),
                      "perms_s": len(ts) / wall}}
    mats, _ = _mixed_stream(n, SEED + 81, cfg["soak_requests"])
    distinct = {id(A): A for A in mats}
    by_kind: dict = {}
    for k, A in distinct.items():
        by_kind.setdefault((np.iscomplexobj(A), A.dtype), []).append(k)
    soak = {}
    for keys in by_kind.values():
        vals = repro_torch.permanent_batch([distinct[k] for k in keys],
                                           device=dev)
        soak.update(zip(keys, vals))
    out["soak"] = [soak[id(A)] for A in mats]
    C = np.ones((cfg["camp_n"],) * 2)
    camp = PermanentService(scfg, ServiceConfig(log_every_s=float("inf")),
                            campaign=CampaignSpec(
                                matrix=C, slices=cfg["camp_slices"]),
                            log=None)
    out["campaign"] = Dm.run_campaign(C, **camp.campaign_body())[0]
    return out


def _mesh_serve_checks(smoke: Smoke, cfg: dict, world: int, ranks: list,
                       ref: dict) -> dict:
    """The service legs of one world against ``ref``: every member of a
    bucket of more than one request (in both services) bit for bit, a
    request served alone within 1e-12 (a bucket of one runs the scalar
    entry on one device and the batch entry over a mesh); the soak's
    sheds typed and counted, its values bit for bit the batch entries';
    the campaign bit for bit ``run_campaign``'s; every rank's tuning
    table the same, and planned; each leg's kernels launched on the ranks
    that serve it, no plain version."""
    lead = ranks[0]["serve"]
    on_card = cfg["device"] is None

    def held(values, sizes, want, want_sizes=None):
        bad = []
        for i, (v, k, w) in enumerate(zip(values, sizes, want)):
            alone = k == 1 or (want_sizes is not None and want_sizes[i] == 1)
            if v is None:
                continue
            if alone and abs(complex(v) - complex(w)) > \
                    1e-12 * abs(complex(w)):
                bad.append(i)
            if not alone and not _same(v, w):
                bad.append(i)
        return bad

    closed = lead["closed"]
    bad = held(closed["values"], closed["sizes"], ref["closed"]["values"],
               ref["closed"]["sizes"])
    smoke.check(not bad and len(closed["values"]) == cfg["serve_requests"],
                f"mesh: world {world}: the service's {len(closed['values'])} "
                f"mixed requests equal the one-device service's, bucket "
                f"members bit for bit (differ: {bad[:8]})")
    got = {"perms_s": closed["perms_s"], "wall_s": closed["wall_s"]}
    plain = [r["shard"] for r in ranks for c in r["serve"]["launches"].values()
             for k, v in c.items() if k.startswith("block_partials") and v]
    missing = [(r["shard"], k) for r in ranks for k in MESH_SERVE_ENTRIES
               if not r["serve"]["launches"]["closed"].get(k)]
    smoke.check(not on_card or (not missing and not plain),
                f"mesh: world {world}: the service launched #2, #4, #6, #8 "
                f"on every rank, no plain version (not launched: {missing}; "
                f"plain on {sorted(set(plain))})")
    if "soak" in lead:
        sk = lead["soak"]
        expired = sum(1 for i in range(len(sk["shed"]))
                      if i % EXPIRE_EVERY == EXPIRE_EVERY - 1)
        req = sk["requests"]
        sheds = {r for r in sk["shed"] if r}
        bad = held(sk["values"], [k or 1 for k in sk["sizes"]], ref["soak"])
        ok = (not bad and req["admitted"] == cfg["soak_requests"]
              and req["completed"] + req["shed_total"] == req["admitted"]
              and req["shed"].get("deadline_expired", 0) >= expired
              and sheds <= {"deadline_expired", "queue_full"})
        smoke.check(ok, f"mesh: world {world} open-loop soak at "
                        f"{sk['rate']:.1f}/s: shard 0 shed {req['shed']} "
                        f"(at least the {expired} expired on arrival), "
                        f"completed {req['completed']}, values against the "
                        f"batch entries (differ: {bad[:8]})")
        got["soak"] = {k: sk[k] for k in ("rate", "wall_s", "p50_ms",
                                          "p99_ms", "requests")}
        print(f"mesh world {world} soak: {sk['rate']:.1f}/s offered, p50 "
              f"{sk['p50_ms']:.3f} ms, p99 {sk['p99_ms']:.3f} ms, "
              f"{req['shed']}")
    if "campaign" in lead:
        c, st = lead["campaign"], lead["stopped"]
        ok = c["value"] == ref["campaign"] and c["fraction"] == 1.0 and \
            st["value"] is None and 0.0 < st["fraction"] < 1.0
        smoke.check(ok, f"mesh: world {world} 2x2 CampaignMesh: the "
                        f"interleaved all-ones n={cfg['camp_n']} campaign on "
                        f"the step row ends on run_campaign's bits "
                        f"({c['value']!r} vs {ref['campaign']!r}); stopped "
                        f"after one dispatch at {st['fraction']:.3f}")
        steps = [r["shard"] for r in ranks
                 if r["serve"]["launches"]["campaign"].get(
                     "ryser_dense_scalar")]
        smoke.check(not on_card or steps == [0, 1],
                    f"mesh: world {world} 2x2: the campaign's waves ran on "
                    f"the step row, shards {steps} (want [0, 1])")
        got["campaign"] = {"wall_s": c["wall_s"], "fraction_stopped":
                           st["fraction"]}
    if world > 1:
        tables = [r["serve"]["tune"] for r in ranks]
        same = all(t["entries"] == tables[0]["entries"] for t in tables)
        winner = tables[0]["entries"][0][1]
        planned = all(t["planned"] == [winner] for t in tables)
        smoke.check(same and planned and all(
            row["ranks"] == world for row in tables[0]["rows"]),
            f"mesh: world {world}: the tuner's campaign route at "
            f"n={cfg['tune_n']} gave every rank the same table "
            f"({tables[0]['entries']}), and the planner applied its winner "
            f"{winner} on every rank")
        got["tune"] = {"entries": tables[0]["entries"],
                       "wall_s": tables[0]["wall_s"],
                       "rows": tables[0]["rows"]}
    return got


def _mesh_campaign_resume(smoke: Smoke, cfg: dict, ref: dict) -> dict:
    """The campaign stopped in the 2 x 2 world, resumed here at world 1
    (a world of one rank in this process, the spec's mesh) from its
    checkpoint: the same bits as run_campaign."""
    from repro_torch.core.solver import SolverConfig
    from repro_torch.launch import mesh as M
    from repro_torch.serve import CampaignSpec, PermanentService, ServiceConfig
    if not os.path.exists(cfg["ckpt"]):
        smoke.check(False, "mesh: the 2x2 campaign left no checkpoint")
        return {}
    C = np.ones((cfg["camp_n"],) * 2)
    t0 = time.perf_counter()
    with M.world():
        mesh = M.make_mesh((1,), ("step",), device=cfg["device"])
        spec = CampaignSpec(matrix=C, mesh=mesh, slices=cfg["camp_slices"],
                            checkpoint=cfg["ckpt"])
        with PermanentService(SolverConfig(cache=False, device=cfg["device"]),
                              ServiceConfig(log_every_s=float("inf")),
                              campaign=spec, log=None) as svc:
            svc.drain()
    value = svc.campaign_value
    smoke.check(value == ref["campaign"],
                f"mesh: the campaign stopped in the 2x2 world resumed at "
                f"world 1 ends on the same bits ({value!r} vs "
                f"{ref['campaign']!r})")
    return {"value": value, "seconds": time.perf_counter() - t0}


def _same(a, b) -> bool:
    """Bit for bit: floats, complexes or arrays (NaN never equal)."""
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and \
        bool(np.all(a == b))


def _process_tree(pid: int) -> list[int]:
    """``pid`` and every process below it (from /proc): torchrun starts
    each worker in a session of its own, so killing its process group
    would leave the ranks running."""
    children: dict[int, list[int]] = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, IndexError, ValueError):
            continue
        children.setdefault(ppid, []).append(int(entry))
    out, todo = [], [pid]
    while todo:
        p = todo.pop()
        out.append(p)
        todo += children.get(p, [])
    return out


def _kill_tree(pid: int) -> None:
    for p in reversed(_process_tree(pid)):     # the ranks first
        with contextlib.suppress(ProcessLookupError):
            os.kill(p, signal.SIGKILL)


def _torchrun(k: int, module: str, args: list, cfg: dict,
              kill_on: str | None = None) -> tuple[int, str]:
    """``python -m torch.distributed.run --standalone --nproc-per-node k
    -m <module> <args>`` with ``--ranks-per-device k`` (and ``--device``
    when the phase runs off the card); with ``kill_on``, SIGKILL it and
    every rank on the first output line holding it.  (exit code, output);
    a run past MESH_CLI_TIMEOUT_S is killed and fails."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(k), "-m", module, *args,
           "--ranks-per-device", str(k)]
    if cfg["device"]:
        cmd += ["--device", cfg["device"]]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    p = subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    deadline = time.monotonic() + MESH_CLI_TIMEOUT_S
    # a thread reads the output, so the deadline holds while a world
    # prints nothing (a rank stuck in a kernel or waiting on a peer)
    got: queue.Queue = queue.Queue()

    def pump():
        for line in p.stdout:
            got.put(line)
        got.put(None)

    reader = threading.Thread(target=pump, daemon=True)
    reader.start()
    lines, rc = [], None
    try:
        while True:
            left = deadline - time.monotonic()
            if left <= 0:
                lines.append("[chip_smoke] killed at the timeout\n")
                rc = -9
                break
            try:
                line = got.get(timeout=min(left, 1.0))
            except queue.Empty:
                continue
            if line is None:             # the launcher closed its output
                break
            lines.append(line)
            if kill_on and kill_on in line:
                break
    finally:
        _kill_tree(p.pid)                # nothing of it outlives the call
        try:
            code = p.wait(timeout=60)
        except subprocess.TimeoutExpired:
            code = -9
        reader.join(timeout=10)
        p.stdout.close()
    return (code if rc is None else rc), "".join(lines)


def _perm_line(out: str, tag: str) -> list[str]:
    return [ln.split("perm(A) = ")[1].split()[0] for ln in out.splitlines()
            if f"[{tag}] perm(A) = " in ln]


def _mesh_clis(smoke: Smoke, cfg: dict, work: str) -> dict:
    """Both CLIs under torchrun: ``launch/permanent.py --backend
    distributed`` at world 2 (the step split of a U(-1, 1) n; one printed
    value, bit for bit the one-device ``run_campaign`` at the world-2
    decomposition), and ``launch/campaign.py`` on all-ones n_kill
    with kill_slices slices: SIGKILLed after its first wave at world 2,
    resumed for one wave at world 4, finished at world 1, against the
    uninterrupted one-device run and n!."""
    from repro_torch.core import distributed as D
    from repro_torch.core.oracle import all_ones_permanent
    from repro_torch.core.solver import PermanentSolver
    from repro_torch.core.stepspace import plan_slices
    # the matrices go in as --matrix files: torchrun's own parser (Python
    # 3.12.3's argparse) reads a script's "--n" as an ambiguous
    # abbreviation of its --nnodes / --nproc-per-node / ...
    out = {}
    n = cfg["n"]
    A = np.random.default_rng(0).uniform(-1, 1, (n, n))
    np.save(os.path.join(work, "A.npy"), A)
    t = time.perf_counter()
    rc, text = _torchrun(2, "repro_torch.launch.permanent",
                         ["--backend", "distributed", "--matrix",
                          os.path.join(work, "A.npy")], cfg)
    ts, cps, C = plan_slices(n, 2, 1, D.MESH_LANES)
    want = D.run_campaign(A, total_slices=ts, chunks_per_slice=cps,
                          chunk_size=C, device=cfg["device"])[0]
    got = _perm_line(text, "superman")
    out["permanent_cli"] = {"rc": rc, "printed": got, "want": f"{want:+.17e}",
                            "seconds": time.perf_counter() - t}
    smoke.check(rc == 0 and got == [f"{want:+.17e}"],
                f"mesh: launch/permanent.py --backend distributed --n {n} "
                f"under torchrun at world 2 printed {got} once, the "
                f"one-device value {want:+.17e} (rc {rc})")
    if rc != 0 or got != [f"{want:+.17e}"]:
        print(text[-3000:])
    m, slices = cfg["n_kill"], cfg["kill_slices"]
    ckpt = os.path.join(work, "mesh_job.npz")
    np.save(os.path.join(work, "ones.npy"), np.ones((m, m)))
    args = ["--matrix", os.path.join(work, "ones.npy"), "--slices",
            str(slices), "--checkpoint", ckpt]
    solver = PermanentSolver(preprocess=False, campaign_threshold=-1.0,
                             campaign_slices=slices, cache=False,
                             device=cfg["device"])
    whole = solver.execute(solver.plan(np.ones((m, m))))
    legs = []
    for k, extra, kill in ((2, [], "[campaign] wave"),
                           (4, ["--max-waves", "1"], None), (1, [], None)):
        t = time.perf_counter()
        rc, text = _torchrun(k, "repro_torch.launch.campaign", args + extra,
                             cfg, kill_on=kill)
        legs.append({"world": k, "rc": rc, "seconds":
                     time.perf_counter() - t,
                     "waves": text.count("[campaign] wave"),
                     "paused": "[campaign] paused" in text,
                     "printed": _perm_line(text, "campaign")})
        print(f"mesh campaign CLI world {k}: rc {rc}, {legs[-1]}")
        if kill is None and not legs[-1]["paused"] and \
                not legs[-1]["printed"]:
            print(text[-3000:])
    exact = all_ones_permanent(m)
    rel = abs(whole - exact) / exact
    ok = (legs[0]["waves"] == 1 and legs[1]["paused"]
          and legs[1]["waves"] == 1
          and legs[2]["rc"] == 0 and legs[2]["printed"] == [f"{whole:+.17e}"])
    smoke.check(ok and rel <= ONES_BAR,
                f"mesh: launch/campaign.py all-ones n={m} under torchrun, "
                f"killed after its first wave at world 2, one wave at world "
                f"4, finished at world 1: {legs[2]['printed']} against the "
                f"uninterrupted one-device {whole:+.17e}, rel.err to {m}! "
                f"{rel:.3e}")
    out["campaign_cli"] = {"legs": legs, "uninterrupted": f"{whole:+.17e}",
                           "rel_err": rel}
    out.update(_mesh_service_clis(smoke, cfg, work))
    return out


def _mesh_service_clis(smoke: Smoke, cfg: dict, work: str) -> dict:
    """The service and the tuner CLIs under torchrun: ``launch/serve.py
    --mesh 2`` (buckets over two ranks), ``--mesh 2x2 --campaign
    camp_n`` (a CampaignMesh, the campaign's value bit for bit one-device
    run_campaign's at the CLI's spec), ``launch/tune.py --routes campaign
    --sizes tune_n`` at world 2 (``--sizes``: the launcher's parser reads
    a script's ``--n`` as one of its flags); each exits 0 and prints on
    shard 0 only."""
    from repro_torch.core import distributed as Dm
    from repro_torch.core.planner import SolverConfig
    from repro_torch.core.stepspace import plan_slices
    from repro_torch.tune.table import TuningTable
    out = {}
    n, reqs, B = cfg["serve_n"], cfg["serve_requests"], cfg["serve_batch"]
    serve = ["--perm-n", str(n), "--requests", str(reqs), "--batch", str(B)]
    t = time.perf_counter()
    rc, text = _torchrun(2, "repro_torch.launch.serve", [*serve, "--mesh",
                                                          "2"], cfg)
    done = text.count(f"[serve] permanents: {reqs} reqs")
    out["serve_cli"] = {"rc": rc, "seconds": time.perf_counter() - t}
    smoke.check(rc == 0 and done == 1 and "2-rank mesh" in text,
                f"mesh: launch/serve.py --mesh 2 under torchrun at world 2: "
                f"rc {rc}, shard 0's report printed {done} time(s)")
    if rc != 0 or done != 1:
        print(text[-3000:])
    m = cfg["camp_n"]
    C = np.random.default_rng(7).uniform(0.2, 1.2, (m, m))
    sc = SolverConfig()
    ts, cps, C_ = plan_slices(m, sc.campaign_slices, 1, sc.campaign_lanes)
    want = Dm.run_campaign(C, total_slices=ts, chunks_per_slice=cps,
                           chunk_size=C_, device=cfg["device"])[0]
    t = time.perf_counter()
    rc, text = _torchrun(4, "repro_torch.launch.serve",
                         [*serve, "--mesh", "2x2", "--campaign", str(m)], cfg)
    got = [ln.split("perm = ")[1].strip() for ln in text.splitlines()
           if "[serve] campaign: 100.0% done, perm = " in ln]
    out["serve_campaign_cli"] = {"rc": rc, "printed": got,
                                 "want": f"{want:+.17e}",
                                 "seconds": time.perf_counter() - t}
    smoke.check(rc == 0 and got == [f"{want:+.17e}"],
                f"mesh: launch/serve.py --mesh 2x2 --campaign {m} under "
                f"torchrun at world 4 printed {got} once, one-device "
                f"run_campaign's {want:+.17e} (rc {rc})")
    if rc != 0 or got != [f"{want:+.17e}"]:
        print(text[-3000:])
    table = os.path.join(work, "cli_table.json")
    t = time.perf_counter()
    rc, text = _torchrun(2, "repro_torch.launch.tune",
                         ["--routes", "campaign", "--sizes",
                          str(cfg["tune_n"]), "--out", table], cfg)
    saved = text.count("entr(ies) ->")
    entries = len(TuningTable.load(table).entries) \
        if rc == 0 and os.path.exists(table) else 0
    out["tune_cli"] = {"rc": rc, "seconds": time.perf_counter() - t,
                       "lines": [ln for ln in text.splitlines()
                                 if ln.startswith("[tune]")]}
    smoke.check(rc == 0 and saved == 1 and entries == 1 and "ranks=2" in text,
                f"mesh: launch/tune.py --routes campaign --sizes "
                f"{cfg['tune_n']} under torchrun at world 2: rc {rc}, saved "
                f"{saved} time(s), {entries} entry")
    if rc != 0 or saved != 1:
        print(text[-3000:])
    print(f"mesh service CLIs: {out}")
    return out


def _mesh_without_mesh(smoke: Smoke, cfg: dict, ins: dict,
                       total: dict) -> None:
    """Both distributed strategies with no mesh, in this process: on the
    card they run the ``cuda`` body (kernels #1 and #2, never the torch
    engine), bit for bit the ``cuda`` backend's (on the CPU the ``torch``
    engine's); their launches, counted from 0, join the phase's."""
    import repro_torch
    from repro_torch.kernels import ryser_cuda as RC
    dev, A, stack = cfg["device"], ins["dense"], ins["dense_batch"]
    on_card = dev is None
    base = "cuda" if on_card else "torch"     # the CPU's downgrade
    want = (repro_torch.permanent(A, backend=base, device=dev),
            repro_torch.permanent_batch(stack, backend=base, device=dev))
    RC.reset_counters()
    got = {s: (repro_torch.permanent(A, backend=s, device=dev),
               repro_torch.permanent_batch(stack, backend=s, device=dev))
           for s in ("distributed", "distributed_batch")}
    counts = dict(RC.counters)
    for k, v in counts.items():
        total[k] += v
    bad = [s for s, v in got.items()
           if not (_same(v[0], want[0]) and _same(v[1], want[1]))]
    plain = {k: v for k, v in counts.items()
             if k.startswith("block_partials") and v}
    launched = counts["ryser_dense_scalar"] == 2 and \
        counts["ryser_dense_batched"] >= 2 and not plain
    smoke.check(not bad and (launched or not on_card),
                f"mesh: no mesh, distributed and distributed_batch run the "
                f"cuda body on the card, bit for bit (differ: {bad}; "
                f"launches {({k: v for k, v in counts.items() if v})})")


def phase_mesh(smoke: Smoke, torch, card: dict, cfg: dict | None = None
               ) -> dict:
    """The multi-device slice on the one card: worlds of 1, 2 and 4 ranks
    (``ranks_per_device`` = the world; the kernel library built once, by
    this process, and loaded by each rank), each driving the mesh main
    path (``_mesh_rank``) and held bit for bit against the one-device
    ``cuda`` path computed here; then both CLIs under torchrun.  A rank
    that fails or a world past its timeout fails the phase.  Returns the
    launches of every rank of every world."""
    import shutil

    from repro_torch.core.oracle import all_ones_permanent
    from repro_torch.kernels import ryser_cuda as RC
    from repro_torch.launch import mesh as M
    cfg = cfg or _mesh_config()
    t0 = time.perf_counter()
    ins = _mesh_inputs(cfg)
    ref = _mesh_references(smoke, cfg, ins)
    total = dict.fromkeys(RC.counters, 0)
    out = {"worlds": {}, "ranks_per_device": {}}
    _mesh_without_mesh(smoke, cfg, ins, total)
    work = tempfile.mkdtemp(prefix="mesh_")
    cfg = dict(cfg, ckpt=os.path.join(work, "serve_campaign.npz"))
    serve_ref = _mesh_serve_references(cfg)
    try:
        for world in MESH_WORLDS:
            t = time.perf_counter()
            try:
                ranks = M.run_world(_mesh_rank, world,
                                    os.path.join(work, f"w{world}"),
                                    args=(cfg,),
                                    timeout_s=MESH_WORLD_TIMEOUT_S)
            except RuntimeError as e:
                smoke.check(False, f"mesh: world of {world} ranks ran "
                                   f"({str(e)[-2000:]})")
                continue
            seconds = time.perf_counter() - t
            first = ranks[0]
            same = all(_same(r["values"][k], v) for r in ranks
                       for k, v in first["values"].items())
            bad = []
            for key, got in first["values"].items():
                want = ref[world, key] if (world, key) in ref else ref[key]
                if not _same(got, want):
                    bad.append(key)
            smoke.check(same and not bad,
                        f"mesh: world {world} (ranks_per_device {world}): "
                        f"every rank returns the same bits, equal to the "
                        f"one-device cuda path (differ: {bad})")
            m = cfg["n_ones"][world]
            tags_ok = all(r["tags"][k] == [f"dense(n={cfg['n']})"]
                          for r in ranks for k in ("dense",)) and all(
                "->" not in t for r in ranks for k in r["tags"]
                if k.endswith("batch") or k == "ragged"
                for t in r["tags"][k]) and all(
                r["tags"]["ones"] == [
                    f"campaign(n={m},cuda)" if m * 2.0 ** (m - 1) > 2 ** 34
                    else f"dense(n={m})"] for r in ranks)
            smoke.check(tags_ok, f"mesh: world {world} dispatch tags "
                                 f"{first['tags']}")
            exact = all_ones_permanent(m)
            rel = abs(first["values"]["ones"] - exact) / exact
            smoke.check(rel <= ONES_BAR, f"mesh: world {world} all-ones "
                        f"n={m} rel.err {rel:.3e} <= {ONES_BAR:g}")
            # the lone dense leaf: permanent_on_mesh's bits (checked
            # above), the one-device scalar entry's within 1e-12
            lone = abs(first["values"]["dense"] - ref["dense"]) / \
                abs(ref["dense"])
            smoke.check(lone <= 1e-12, f"mesh: world {world}: the dense "
                        f"n={cfg['n']} leaf split over the ranks is "
                        f"{lone:.3e} <= 1e-12 from the one-device value")
            missing = [(r["shard"], k) for r in ranks for k in KERNEL_ENTRIES
                       if not r["counters"].get(k)]
            plain = {k: v for r in ranks for k, v in r["counters"].items()
                     if k.startswith("block_partials") and v}
            on_card = cfg["device"] is None
            smoke.check(not on_card or (not missing and not plain),
                        f"mesh: world {world}: #1-#8 launched on every rank, "
                        f"no plain version (not launched: {missing}; plain "
                        f"{plain})")
            for r in ranks:
                for k, v in r["counters"].items():
                    total[k] += v
                for counts in r["serve"]["launches"].values():
                    for k, v in counts.items():
                        total[k] += v
            w = {"seconds": seconds,
                 "main_s": [r["main_s"] for r in ranks],
                 "ones_n": m, "ones_s": first["ones_s"],
                 "ones_value": first["values"]["ones"], "ones_rel_err": rel,
                 "serve": _mesh_serve_checks(smoke, cfg, world, ranks,
                                             serve_ref),
                 "launches": [{k: v for k, v in r["counters"].items() if v}
                              for r in ranks],
                 "devices": [r["device"] for r in ranks]}
            out["worlds"][world] = w
            out["ranks_per_device"][world] = world
            print(f"mesh world {world} (ranks_per_device {world}, devices "
                  f"{w['devices']}): {seconds:.1f} s, main path "
                  f"{max(w['main_s']):.3f} s, all-ones n={m} "
                  f"{w['ones_s']:.4f} s, launches rank 0 "
                  f"{w['launches'][0]}")
        out["resumed"] = _mesh_campaign_resume(smoke, cfg, serve_ref)
        out["cli"] = _mesh_clis(smoke, cfg, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    walls = {k: (v["ones_n"], v["ones_s"]) for k, v in out["worlds"].items()}
    print(f"mesh all-ones (n, campaign wall seconds) by world: {walls} on "
          f"{card['nvidia_smi']}; the ranks time-slice one card, so no "
          f"scaling is expected or claimed")
    rates = {k: v["serve"]["perms_s"] for k, v in out["worlds"].items()}
    print(f"mesh service closed loop, {cfg['serve_requests']} mixed requests "
          f"n={cfg['serve_n']}: perms/s by world {rates} (one device "
          f"{serve_ref['closed']['perms_s']:.1f}) on {card['nvidia_smi']}; "
          f"no scaling claimed")
    out["seconds"] = time.perf_counter() - t0
    out["launches"] = {k: v for k, v in total.items() if v}
    print(f"mesh phase: {out['seconds']:.1f} s; launches of #1-#8 over "
          f"every rank: { {k: total[k] for k in KERNEL_ENTRIES} }")
    smoke.summary["mesh"] = out
    return total


def time_only(smoke: Smoke, torch, card: dict) -> int:
    """``--time-only``: after the build, only the timing rounds of the timed
    entries (no plain pass, no value check, no result line), for comparing
    versions of a kernel source on one card in one call."""
    entries = _timed_entries(torch, card)
    timed = _time_rounds(torch, {k: e[0] for k, e in entries.items()})
    _print_rounds(timed, {k: e[2] for k, e in entries.items()})
    for t in timed.values():
        del t["got"]
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_timing.json"),
              "a") as f:
        f.write(json.dumps({"card": card, "ptxas": smoke.summary["ptxas"],
                            "timing_rounds": timed}) + "\n")
    return 1 if smoke.failures else 0


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a card",
              file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--cold-band"]:
        return cold_band_main(sys.argv[2])
    smoke = Smoke()
    t_start = time.perf_counter()
    card = phase_card(smoke, torch)
    phase_build(smoke)
    if "--time-only" in sys.argv[1:]:
        return time_only(smoke, torch, card)
    if "--serve-only" in sys.argv[1:]:
        phase_serve(smoke, torch)
        print(f"chip_smoke --serve-only: failures {smoke.failures}")
        return 1 if smoke.failures else 0
    if "--tune-only" in sys.argv[1:]:
        phase_tune(smoke, torch, card)
        print(f"chip_smoke --tune-only: failures {smoke.failures}")
        return 1 if smoke.failures else 0
    if "--examples-only" in sys.argv[1:]:
        phase_examples(smoke, torch)
        print(f"chip_smoke --examples-only: failures {smoke.failures}")
        return 1 if smoke.failures else 0
    if "--prove-only" in sys.argv[1:]:
        phase_prove(smoke, torch)
        print(f"chip_smoke --prove-only: failures {smoke.failures}")
        return 1 if smoke.failures else 0
    if "--mesh-only" in sys.argv[1:]:
        phase_mesh(smoke, torch, card)
        print(f"chip_smoke --mesh-only: failures {smoke.failures}")
        return 1 if smoke.failures else 0
    window_err = {**phase_kernel_vs_plain(smoke, torch),
                  **phase_kernel_vs_plain_complex(smoke, torch)}
    parity_err, parity_launches = phase_entry_parity(smoke, torch)
    window_err.update(parity_err)
    mp = phase_main_path(smoke, torch)
    phase_values(smoke, torch, mp)
    mpc = phase_main_path_complex(smoke, torch)
    phase_values_complex(smoke, torch, mpc)
    window_err.update(phase_kernel_vs_plain_sparse(smoke, torch))
    msp = phase_main_path_sparse(smoke, torch, cplx=False)
    phase_values_sparse(smoke, torch, msp)
    mspc = phase_main_path_sparse(smoke, torch, cplx=True)
    phase_values_sparse(smoke, torch, mspc)
    calls = _main_calls(mp, mpc, msp, mspc)
    phase_profile(smoke, torch, calls)
    phase_host_split(smoke, torch, calls)
    rows = phase_timing(smoke, torch, card,
                        {**mp["launches"], **mpc["launches"],
                         **msp["launches"], **mspc["launches"],
                         **parity_launches}, window_err)
    smoke.summary["dense_at_sparse_shape"] = _dense_at_sparse_shape(
        smoke, torch, msp, mspc)
    campaign_launches = phase_campaign(smoke, torch, card)
    tune_launches = phase_tune(smoke, torch, card).get("launches", {})
    for row in rows:
        row["launches"] += campaign_launches.get(row["name"], 0) + \
            tune_launches.get(row["name"], 0)
    phase_serve(smoke, torch)
    example_launches = phase_examples(smoke, torch)
    prove_launches = phase_prove(smoke, torch)
    ran = {k for k in KERNEL_ENTRIES
           if example_launches.get(k, 0) + prove_launches.get(k, 0)}
    smoke.check(ran == set(KERNEL_ENTRIES),
                f"examples and prove: #1-#8 all launched "
                f"({sorted(set(KERNEL_ENTRIES) - ran)} did not)")
    mesh_launches = phase_mesh(smoke, torch, card)
    for row in rows:
        row["launches"] += example_launches.get(row["name"], 0) + \
            mesh_launches.get(row["name"], 0)
    print(f"phase seconds: serve {smoke.summary['serve']['seconds']:.1f}, "
          f"examples {smoke.summary['examples']['seconds']:.1f}, prove "
          f"{smoke.summary['prove']['seconds']:.1f}, mesh "
          f"{smoke.summary['mesh']['seconds']:.1f}, all "
          f"{time.perf_counter() - t_start:.1f}")
    smoke.summary.update(card=card, kernels=rows,
                         seconds=time.perf_counter() - t_start,
                         failures=smoke.failures)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(smoke.summary, f, indent=1, default=str)
    if smoke.failures:
        print(f"chip_smoke: {len(smoke.failures)} phase(s) failed: "
              f"{smoke.failures}", file=sys.stderr)
        return 1
    print(card["nvidia_smi"])
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
