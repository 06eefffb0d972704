"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

The sources under ``kernels/csrc/`` have a plain C interface, so they are
compiled by ``nvcc`` alone (no PyTorch headers, a few seconds a unit) and
loaded with ``ctypes``.  Each source (``ryser_dense.cu``, real;
``ryser_complex.cu``, split-plane complex; ``ryser_sparse.cu``, padded-CCS
sparse, real and complex) instantiates the block bodies of
``ryser_kernels.cuh`` and is compiled as two units per padded matrix size
(``-DRYSER_NPAD=k``, f64, and with ``-DRYSER_F32`` its f32
instantiations) plus one unit for its C entry points, every unit in its
own ``nvcc`` process, as many at once as this process may use CPUs, the
heaviest first; ``nvcc -shared`` then links them into one library.

The library lands in ``<root>/<hash>/``, keyed by a hash of the sources and
flags, and is built at first use.  The root is ``build/repro_torch/`` at
the repository root unless ``set_build_root`` moved it (the service's
``enable_compile_cache`` does).  ``ptxas -v`` output (registers, spills) is
kept beside it as ``ptxas.log``.  ``load_stats`` counts the loads from the
root: each one found the library on disk (a hit) or built it with
``nvcc`` (a miss).  Without ``nvcc`` this module raises; nothing falls
back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

__all__ = ["CSRC", "ENTRIES", "NPADS", "build_dir", "find_nvcc",
           "load_library", "load_stats", "ptxas_log", "set_build_root",
           "warps_per_sm"]

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("ryser_dense.cu", "ryser_complex.cu", "ryser_sparse.cu")
HEADERS = ("ryser_common.cuh", "ryser_kernels.cuh")
NPADS = (8, 16, 24, 32, 40, 48, 56, 64)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
TOOLKIT_NVCC = "/usr/local/cuda/bin/nvcc"     # the toolkit's default place
# the C entries of the eight kernels; each has an f32 twin, ``<entry>_f32``
ENTRIES = ("ryser_dense_scalar", "ryser_dense_batched",
           "ryser_complex_scalar", "ryser_complex_batched",
           "ryser_sparse_scalar", "ryser_sparse_batched",
           "ryser_sparse_complex_scalar", "ryser_sparse_complex_batched")
_REPO_ROOT = Path(__file__).resolve().parents[3]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_lib_dir: Path | None = None
_build_root = _REPO_ROOT / "build" / "repro_torch"
# loads of the library from the build root: requests = hits + misses
_loads = {"requests": 0, "hits": 0, "misses": 0}


def find_nvcc() -> str:
    """Path of nvcc: PATH first, then the toolkit's default location."""
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists(TOOLKIT_NVCC):
        nvcc = TOOLKIT_NVCC
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of repro_torch are built from "
            "kernels/csrc/*.cu at first use and need the CUDA toolkit; pass "
            "device='cpu' for the plain PyTorch versions")
    return nvcc


@functools.lru_cache(maxsize=1)
def _source_hash() -> str:
    """Hash of the sources and flags, read once a process: load_library
    asks for the build directory at every launch, and reading and hashing
    the sources each time would put host time on every kernel call."""
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(repr(NPADS).encode())
    return h.hexdigest()[:16]


def set_build_root(path) -> Path:
    """Build and load the kernel library under ``path`` from now on
    (created if missing); returns it.  A library loaded from another root
    stays in use until ``load_library`` is called again."""
    global _build_root
    root = Path(path).expanduser().resolve()
    root.mkdir(parents=True, exist_ok=True)
    with _lock:
        _build_root = root
    return root


def build_dir() -> Path:
    return _build_root / _source_hash()


def load_stats() -> dict:
    """Loads of the library from the build root in this process that
    succeeded: ``requests``, of which ``hits`` found it on disk and
    ``misses`` built it with nvcc."""
    return dict(_loads)


def ptxas_log() -> str:
    """The ptxas report of the current build ('' before the first build)."""
    path = build_dir() / "ptxas.log"
    return path.read_text() if path.exists() else ""


def warps_per_sm(registers: int, threads_per_cta: int) -> int:
    """Warps one H100 SM holds at once as the registers allow: 65,536
    registers, allocated per thread in units of 8, at most 64 warps and
    32 CTAs an SM (shared memory not counted).  224 registers x 128
    threads -> 8 warps; 128 x 256 -> 16."""
    regs = -(-registers // 8) * 8
    warps_per_cta = -(-threads_per_cta // 32)
    ctas = min(32, 65536 // (regs * 32) // warps_per_cta,
               64 // warps_per_cta)
    return ctas * warps_per_cta


def _units():
    """(source, object name, extra nvcc defines) of each compile unit, the
    heaviest first: the sparse source's units take the most CPU time, and
    a larger NPAD more (ptxas; on an 8-core H100 host 8 at a time, in this
    order, finish the build in 58 s where all 51 at once take 64-69 s)."""
    for name in sorted(SOURCES, key=lambda n: n != "ryser_sparse.cu"):
        src = CSRC / name
        for k in sorted(NPADS, reverse=True):
            yield src, f"{src.stem}_n{k}.o", [f"-DRYSER_NPAD={k}"]
            yield src, f"{src.stem}_f32_n{k}.o", [f"-DRYSER_NPAD={k}",
                                                  "-DRYSER_F32"]
        yield src, f"{src.stem}_api.o", ["-DRYSER_API_ONLY"]


def _compile(out_dir: Path) -> Path:
    nvcc = find_nvcc()
    out_dir.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=out_dir.parent))
    try:
        def run(unit):
            src, obj, defines = unit
            cmd = [nvcc, *NVCC_FLAGS, *defines, "-c", str(src), "-o",
                   str(tmp / obj)]
            p = subprocess.run(cmd, stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
            return f"$ {' '.join(cmd)}\n{p.stdout}", p.returncode

        cpus = len(os.sched_getaffinity(0))     # the CPUs this process has
        with ThreadPoolExecutor(max_workers=cpus) as pool:
            done = list(pool.map(run, _units()))
        logs = [log for log, _rc in done]
        failed = [log for log, rc in done if rc != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        lib = tmp / "libryser.so"
        objs = sorted(str(p) for p in tmp.glob("*.o"))
        link = subprocess.run([nvcc, "-shared", "-o", str(lib), *objs],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        (tmp / "ptxas.log").write_text("\n".join(logs))
        try:
            os.replace(tmp, out_dir)         # atomic publish of the build
        except OSError:
            if not (out_dir / "libryser.so").exists():
                raise                        # not a concurrent build's win
        return out_dir / "libryser.so"
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ryser_dense_scalar.argtypes = [P, P, P, P, ctypes.c_uint64, I, I, I,
                                       I, I, I, I, I, P]
    lib.ryser_dense_batched.argtypes = [P, P, P, P, I, I, I, I, I, I, I, I,
                                        I, P]
    lib.ryser_complex_scalar.argtypes = [P, P, P, P, P, P, ctypes.c_uint64,
                                         I, I, I, I, I, I, I, P]
    lib.ryser_complex_batched.argtypes = [P, P, P, P, P, P, I, I, I, I, I,
                                          I, I, I, P]
    lib.ryser_sparse_scalar.argtypes = [P, P, P, P, P, P, ctypes.c_uint64,
                                        I, I, I, I, I, I, I, I, P]
    lib.ryser_sparse_batched.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I,
                                         I, I, I, P]
    lib.ryser_sparse_complex_scalar.argtypes = [P] * 9 + [
        ctypes.c_uint64, I, I, I, I, I, I, I, I, P]
    lib.ryser_sparse_complex_batched.argtypes = [P] * 9 + [I] * 9 + [P]
    for entry in ENTRIES:                    # the _f32 twin: same arguments
        getattr(lib, entry).restype = I
        f32 = getattr(lib, f"{entry}_f32")
        f32.argtypes, f32.restype = getattr(lib, entry).argtypes, I
    lib.ryser_dense_occupancy.argtypes = [I, I, I, I, I, P]
    lib.ryser_dense_occupancy.restype = I
    lib.ryser_complex_occupancy.argtypes = [I, I, I, I, P]
    lib.ryser_complex_occupancy.restype = I
    lib.ryser_sparse_occupancy.argtypes = [I, I, I, I, P]
    lib.ryser_sparse_occupancy.restype = I
    lib.ryser_error_string.argtypes = [I]
    lib.ryser_error_string.restype = ctypes.c_char_p
    return lib


def load_library() -> ctypes.CDLL:
    """The kernel library of the current build root, built from the
    sources at its first use there."""
    global _lib, _lib_dir
    with _lock:
        out_dir = build_dir()
        if _lib is None or _lib_dir != out_dir:
            path = out_dir / "libryser.so"
            hit = path.exists()
            if not hit:
                path = _compile(out_dir)
            _lib = _bind(ctypes.CDLL(str(path)))
            _lib_dir = out_dir
            _loads["requests"] += 1          # a load that failed counts not
            _loads["hits" if hit else "misses"] += 1
        return _lib
