"""Cost-model-seeded kernel geometry search on the card.

The port's counterpart of the reference's ``tune/search.py``.  Per
``(route, n, density_bucket, dtype, precision)`` key:

1. **Enumerate** every ``(lanes, steps_per_chunk, window)`` candidate on
   a power-of-two grid, validated by ``analysis/geometry.py::
   validate_tiling`` (the CUDA entries' own limits) and deduplicated by
   the clamped ``(TB, C, Wu, num_blocks)`` it resolves to at this n.
2. **Prune** with the analytic model (:func:`model_cost`, the rates of
   ``utils/roofline.py``): rank by modelled time, keep the top-k, and
   drop those that launch as an earlier one does (the campaign wave takes
   TB and Wu from the geometry, not C).  The default geometry is always
   kept, so the winner never measures slower than untuned.  On the card
   a candidate whose CTA one SM cannot hold (occupancy 0) is dropped
   before launch, with the reason printed; one that passed validation
   and then fails to launch raises.
3. **Measure** survivors through the public entries of ``kernels/ops.py``
   -- ``permanent_cuda_batched`` (#2, #4), ``sparse_batched_values_cuda``
   (#6), one wave of ``campaign_slice_sums`` (#1 in ``batched`` mode) --
   after one warm-up call (which pays the library load and the sparse
   ordering's first call): the median of ``repeats`` calls, each timed
   by CUDA events on the card and by the host clock on the CPU, where
   the entries run their plain versions (as the reference's
   ``--interpret`` runs its kernels interpreted).
   Over a mesh (``mesh=``, a ``launch.mesh.Mesh``; every rank calls with
   the same arguments) the ``campaign`` route measures one collective
   wave, ``distributed.slice_sums_on_mesh`` over the first D x W slice
   ids (W the per-rank width ``run_campaign`` would take over that
   mesh), by the host clock after the wave, since its gather sets its
   pace; without one it is the one-card wave above (a world of one).
   Every rank measures the same survivors in the same order, and one
   gather of the medians lets the slowest shard's decide, so every rank
   picks the same winner and holds the same table.
4. **Persist** the winner as a :class:`~repro_torch.tune.table.TableEntry`
   whose ``predicted_s`` is the model's (no HLO refinement).
"""

from __future__ import annotations

import math
import statistics
import time

import numpy as np
import torch

from ..analysis.geometry import block_smem_bytes, validate_tiling
from ..core.stepspace import DEFAULT_GEOMETRY, Geometry, plan_slices
from ..utils.roofline import HwSpec, detect_hw, get_hw
from .table import TableEntry, TuningTable, density_bucket, host_device_kind

__all__ = ["enumerate_candidates", "model_cost", "measure_candidate",
           "tune_key", "tune_table", "ROUTES"]

ROUTES = ("dense", "complex", "sparse", "campaign")

# Power-of-two candidate grid (requested knobs; kernel_geometry clamps
# them per n, enumerate_candidates dedups the clamped results).
LANES_GRID = (32, 64, 128, 256)
SPC_GRID = (32, 64, 128, 256)
WINDOW_GRID = (8, 16, 32)

_PAD = 8
_MAX_CTAS, _MAX_THREADS = 32, 2048        # an SM's limits (Hopper)
_MODE = {"dense": "dense", "complex": "complex", "sparse": "sparse",
         "campaign": "dense"}


def _pad(n: int) -> int:
    return max(_PAD, -(-n // _PAD) * _PAD)


def enumerate_candidates(n: int) -> list[Geometry]:
    """Valid, deduplicated candidates for matrix size n.

    The default geometry is always first; every other candidate passed
    ``validate_tiling`` and resolves to a distinct clamped
    ``(TB, C, Wu, num_blocks)``.
    """
    out = [DEFAULT_GEOMETRY]
    seen = {DEFAULT_GEOMETRY.kernel_geometry(n)}
    for lanes in LANES_GRID:
        for spc in SPC_GRID:
            for window in WINDOW_GRID:
                if validate_tiling(n, lanes, spc, window):
                    continue
                g = Geometry(lanes, spc, window)
                resolved = g.kernel_geometry(n)
                if resolved in seen:
                    continue
                seen.add(resolved)
                out.append(g)
    return out


def _campaign_spec(n: int) -> tuple[int, int, int]:
    """(total_slices, chunks_per_slice, chunk_size) of an n campaign at the
    planner's default spec (``SolverConfig.campaign_slices`` /
    ``campaign_lanes``), as ``build_plan`` cuts it."""
    from ..core.planner import SolverConfig
    cfg = SolverConfig()
    return plan_slices(n, cfg.campaign_slices, 1, cfg.campaign_lanes)


def _launch(route: str, geometry: Geometry, n: int, batch: int):
    """(TB, C, Wu, CTAs) of one launch of ``route`` at ``geometry``: the
    batch grid's, or for ``campaign`` the wave body's over ``batch``
    slices."""
    if route == "campaign":
        from ..kernels.ops import wave_geometry
        _ts, cps, C = _campaign_spec(n)
        TB, Wu = wave_geometry(cps, C, geometry)
        return TB, C, Wu, batch * cps // TB
    TB, C, Wu, nb = geometry.kernel_geometry(n)
    return TB, C, Wu, batch * nb


def _ctas_per_sm(route: str, geometry: Geometry, n: int, precision: str,
                 hw: HwSpec) -> int:
    """CTAs one SM holds at once: the card's occupancy query of the
    instantiation the route launches, or on the CPU stand-in an estimate
    from threads and shared memory."""
    TB, C, Wu, _ = _launch(route, geometry, n, 1)
    if hw.name == "cpu":
        smem = block_smem_bytes(n, TB, Wu, _MODE[route])
        return min(_MAX_CTAS, _MAX_THREADS // TB, hw.smem_per_sm // smem)
    from ..kernels import ops as K
    from ..kernels.ryser_sparse_cuda import ctas_per_sm_sparse
    prec = K.wave_precision(precision)
    if route == "campaign":
        _ts, cps, C = _campaign_spec(n)
        return K.wave_ctas_per_sm(n, False, chunks_per_slice=cps,
                                  chunk_size=C, precision=prec,
                                  geometry=geometry)
    if route == "complex":
        return K.ctas_per_sm_complex(_pad(n), TB=TB, Wu=Wu, precision=prec)
    if route == "sparse":
        return ctas_per_sm_sparse(_pad(n), TB=TB, Wu=Wu, precision=prec)
    return K.ctas_per_sm(_pad(n), TB=TB, Wu=Wu, precision=prec,
                         mode="batched")


def model_cost(geometry: Geometry, n: int, *, route: str = "dense",
               density: float = 1.0, batch: int = 1,
               hw: HwSpec | None = None, precision: str = "dq_acc",
               dtype: str = "<f8", ctas_per_sm: int | None = None) -> float:
    """Modelled seconds of one launch (``campaign``: one wave of ``batch``
    slices).

    Instructions: per Gray step the route's (2n real, 8n complex,
    density * n adds and n - 1 multiplies sparse; ``utils/roofline.py``),
    per window the boundary step's share (D's last column, the mid
    correction and the boundary column into the n_pad row sums, then the
    product: about 3 n_pad + n, four times that complex), and per chunk
    its init (n columns into n_pad rows).  They run at half the FP64
    data-sheet rate (FP32 for ``<f4`` / ``<c8``), one instruction an
    operation, times the tail-wave factor: the launch's CTAs over the
    card's slots (SMs x ``ctas_per_sm``, default: :func:`_ctas_per_sm`),
    rounded up to whole waves.  A ranking model; the tuner records its
    prediction beside the measured time.
    """
    hw = hw or detect_hw()
    TB, C, Wu, ctas = _launch(route, geometry, n, batch)
    n_pad = _pad(n)
    chunks = ctas * TB
    cplx = route == "complex"
    per_step = {"complex": 8.0 * n, "sparse": density * n + n - 1}.get(
        route, 2.0 * n)
    per_window = (3.0 * n_pad + n) * (4.0 if cplx else 1.0)
    per_chunk = n * n_pad * (2.0 if cplx else 1.0)
    instr = chunks * (C * per_step + C / Wu * per_window + per_chunk)
    rate = (hw.fp32_flops if dtype in ("<f4", "<c8") else hw.fp64_flops) / 2
    if ctas_per_sm is None:
        ctas_per_sm = _ctas_per_sm(route, geometry, n, precision, hw)
    slots = max(1, ctas_per_sm) * hw.sms
    tail = math.ceil(ctas / slots) * slots / ctas
    return instr / rate * tail


def _median_time(call, repeats: int, on_card: bool) -> float:
    call()                                   # warm-up
    if on_card:
        torch.cuda.synchronize()
    times = []
    for _ in range(max(1, repeats)):
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            call()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            call()
            times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _route_callable(route: str, n: int, *, density: float, batch: int,
                    precision: str, device, seed: int, mesh=None):
    """(``call``, its batch): ``call(geometry)`` -> a thunk measuring one
    launch of ``route`` through the public entries of ``kernels/ops.py``
    on inputs made once from ``seed`` on ``device``, ``batch`` matrices
    (dense, complex, sparse), or for ``campaign`` one matrix and its first
    wave of slices, whose width (the slices that fill the card at the
    default geometry) is the batch returned; over ``mesh`` that wave is
    ``slice_sums_on_mesh`` of D x W slices, W (a rank's) returned."""
    from ..core.ryser import resolve_device
    from ..kernels import ops as K
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    if route in ("dense", "complex"):
        As = rng.uniform(-1, 1, (batch, n, n))
        if route == "complex":
            As = As + 1j * rng.uniform(-1, 1, (batch, n, n))
        As = torch.as_tensor(As, device=dev)

        def call(geometry):
            return lambda: K.permanent_cuda_batched(
                As, precision=precision, geometry=geometry, device=dev)
        return call, batch

    if route == "sparse":
        from ..core.sparyser import SparseMatrix, pack_padded_ccs
        sps = []
        for _ in range(batch):
            A = rng.uniform(0.1, 1, (n, n))
            mask = rng.uniform(size=(n, n)) < density
            np.fill_diagonal(mask, True)    # keep the permanent nonzero
            sps.append(SparseMatrix.from_dense(A * mask))
        args = [torch.as_tensor(a, device=dev)
                for a in pack_padded_ccs(sps)]

        def call(geometry):
            return lambda: K.sparse_batched_values_cuda(
                *args, precision=precision, geometry=geometry, device=dev)
        return call, batch

    if route == "campaign":
        from ..core.distributed import default_wave_width
        A_host = rng.uniform(-1, 1, (n, n))
        A = torch.as_tensor(A_host, device=dev)
        ts, cps, C = _campaign_spec(n)
        D = 1 if mesh is None else mesh.size
        width = default_wave_width(A_host, pending=-(-ts // D),
                                   chunks_per_slice=cps, chunk_size=C,
                                   precision=precision, device=dev)
        if mesh is not None:
            from ..core.distributed import slice_sums_on_mesh
            ids = list(range(min(ts, D * width)))

            def call(geometry):
                return lambda: slice_sums_on_mesh(
                    A_host, mesh, ids, chunks_per_slice=cps, chunk_size=C,
                    precision=precision, geometry=geometry)
            return call, width

        def call(geometry):
            return lambda: K.campaign_slice_sums(
                A, 0, width, chunks_per_slice=cps, chunk_size=C,
                precision=precision, geometry=geometry, device=dev)
        return call, width

    raise ValueError(f"unknown tuning route {route!r}")


def measure_candidate(call_factory, geometry: Geometry, *, repeats: int,
                      device=None, host_clock: bool = False) -> float:
    """Median measured seconds of one candidate geometry's launch (CUDA
    events on the card unless ``host_clock``)."""
    from ..core.ryser import resolve_device
    on_card = resolve_device(device).type == "cuda" and not host_clock
    return _median_time(call_factory(geometry), repeats, on_card)


def _slowest(mesh, seconds: list[float]) -> list[float]:
    """Each entry's largest value over the shards of ``mesh``: one gather
    (the mesh functions' ``_gather``), the same list on every rank."""
    from ..core.distributed import _gather
    rows = _gather(mesh, torch.tensor(seconds, dtype=torch.float64))
    return [float(v) for v in rows.max(axis=0)]


def tune_key(route: str, n: int, *, density: float = 1.0,
             dtype: str = "<f8", precision: str = "dq_acc",
             batch: int = 16, top_k: int = 3, repeats: int = 3,
             device=None, seed: int = 0, mesh=None,
             hw: HwSpec | None = None):
    """Tune one table key; returns (TableEntry, candidate report rows).

    The report rows carry every *measured* candidate's launch, modelled
    and measured times and the mesh's ranks (1 without one) -- the raw
    material of the mispredict report.  Over ``mesh`` every rank returns
    the same entry: each candidate's time is the slowest shard's median.
    """
    from ..core.distributed import _mesh_device
    from ..core.ryser import resolve_device
    dev = resolve_device(device) if mesh is None else \
        _mesh_device(mesh, device)
    on_card = dev.type == "cuda"
    hw = hw or (detect_hw() if on_card else get_hw("cpu"))
    call_factory, width = _route_callable(
        route, n, density=density, batch=batch, precision=precision,
        device=dev, seed=seed, mesh=mesh)

    def cost(g, ctas=None):
        return model_cost(g, n, route=route, density=density, batch=width,
                          hw=hw, precision=precision, dtype=dtype,
                          ctas_per_sm=ctas)

    occupancy = {g: _ctas_per_sm(route, g, n, precision, hw)
                 for g in enumerate_candidates(n)}
    if occupancy[DEFAULT_GEOMETRY] < 1:
        raise RuntimeError(f"{route} n={n}: one SM holds no CTA of the "
                           "default geometry")
    ranked = sorted(occupancy, key=lambda g: cost(g, occupancy[g]))
    # the default's launch first: a candidate that launches as it does
    # (the campaign wave ignores steps_per_chunk) is not measured again
    launches = {_launch(route, DEFAULT_GEOMETRY, n, width)}
    survivors = []
    for g in ranked:
        if len(survivors) >= max(1, top_k):
            break
        launch = _launch(route, g, n, width)
        if g != DEFAULT_GEOMETRY and launch in launches:
            continue
        if occupancy[g] < 1:
            print(f"[tune] {route} n={n}: skip {g.tag()}: one SM holds "
                  f"no CTA of TB={launch[0]} Wu={launch[2]} (registers or "
                  "shared memory)")
            continue
        survivors.append(g)
        launches.add(launch)
    if DEFAULT_GEOMETRY not in survivors:
        survivors.append(DEFAULT_GEOMETRY)   # tuned >= untuned floor

    # over a mesh the campaign wave is collective: timed on the host
    wave = mesh is not None and route == "campaign"
    measured = [measure_candidate(call_factory, g, repeats=repeats,
                                  device=dev, host_clock=wave)
                for g in survivors]
    if mesh is not None:
        measured = _slowest(mesh, measured)
    report, results = [], {}
    for g, meas in zip(survivors, measured):
        modeled = cost(g, occupancy[g])
        results[g] = (meas, modeled)
        TB, C, Wu, ctas = _launch(route, g, n, width)
        report.append({"route": route, "n": n, "geometry": g.tag(),
                       "launch": [TB, C, Wu, ctas], "batch": width,
                       "ranks": 1 if mesh is None else mesh.size,
                       "ctas_per_sm": occupancy[g], "modeled_s": modeled,
                       "predicted_s": modeled, "measured_s": meas,
                       "mispredict_ratio": (modeled / meas
                                            if meas else 0.0)})

    winner = min(results, key=lambda g: results[g][0])
    measured_s, predicted_s = results[winner]
    default_s = results[DEFAULT_GEOMETRY][0]
    # planner route names: complex matrices travel the dense route with a
    # complex dtype; campaign wave bodies are the step_sharded route
    plan_route = {"campaign": "step_sharded", "complex": "dense"}.get(
        route, route)
    entry = TableEntry(
        route=plan_route, n=n, density_bucket=density_bucket(density),
        dtype=dtype, precision=precision,
        device_kind=host_device_kind(dev), geometry=winner,
        predicted_s=predicted_s, measured_s=measured_s, default_s=default_s)
    return entry, report


def tune_table(routes, ns, *, density: float = 1.0,
               precision: str = "dq_acc", batch: int = 16, top_k: int = 3,
               repeats: int = 3, device=None, seed: int = 0,
               mesh=None, hw: HwSpec | None = None,
               table: TuningTable | None = None, progress=None):
    """Tune every (route, n) pair into a TuningTable.

    Routes map to dtypes: ``dense``/``sparse``/``campaign`` tune the
    ``<f8`` key, ``complex`` the ``<c16`` key.  Over ``mesh`` every rank
    calls this and gets the same table (:func:`tune_key`).  Returns
    (table, report rows).
    """
    table = table or TuningTable()
    report = []
    for route in routes:
        dtype = "<c16" if route == "complex" else "<f8"
        dens = density if route == "sparse" else 1.0
        for n in ns:
            if n < 4:       # below the kernel floor (executor falls back)
                continue
            entry, rows = tune_key(
                route, n, density=dens, dtype=dtype, precision=precision,
                batch=batch, top_k=top_k, repeats=repeats, device=device,
                seed=seed, mesh=mesh, hw=hw)
            table.put(entry)
            report.extend(rows)
            if progress:
                progress(entry)
    return table, report
