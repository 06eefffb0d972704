"""Who computes a leaf: the executor's producer rule, the dispatch record
of ``execute_plan``, and the service's campaign spec against the
planner's.

* The producer table: every configured strategy (``torch``, ``cuda``,
  ``distributed``, ``distributed_batch``) x route x n in {3, 4, 8} x
  scalar or bucket x no mesh or a world of one rank x the card or the
  CPU, each against its producer's name as a literal.
* The dispatch record: plans of every shape the dispatcher handles (a
  scalar leaf, FM's several leaves, a bucketed batch with inline folds,
  duplicates, a straggler and an n = 3 downgrade, complex ``qq``,
  campaigns scalar and batched with the cache on and off, a batch run
  twice, the ``distributed`` pair with and without a mesh), each run on
  the CPU against literal dispatch tags, ``ExecStats`` counters and
  timing keys, cache keys in LRU order, and values by ``float.hex``.
* The service's ``campaign_body()`` field for field against the
  ``CampaignSpec`` that ``build_plan`` records for the same matrix.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.cache import ResultCache  # noqa: E402
from repro_torch.core.executor import execute_plan, get_backend  # noqa: E402
from repro_torch.core.planner import SolverConfig, build_plan  # noqa: E402
from repro_torch.core.stepspace import Geometry  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402


@pytest.fixture(scope="module")
def mesh():
    """A world of one CPU rank, as ``tests/test_torch_distributed.py``'s
    ``mesh1``, kept for the module."""
    with M.world():
        yield M.make_mesh((1,), ("step",), device="cpu")


# ---------------------------------------------------------------------------
# the producer table
# ---------------------------------------------------------------------------

NS = (3, 4, 8)
# (strategy, mesh, device) -> the producers of n = 3, 4, 8, scalar then
# bucket at each n; dense and sparse differ only where two rows are given
PRODUCERS = {
    ("torch", False, None): "torch torch torch torch torch torch",
    ("torch", False, "cpu"): "torch torch torch torch torch torch",
    ("torch", True, None): "torch torch torch torch torch torch",
    ("torch", True, "cpu"): "torch torch torch torch torch torch",
    ("cuda", False, None): "torch torch cuda cuda cuda cuda",
    ("cuda", False, "cpu"): "torch torch cuda cuda cuda cuda",
    ("cuda", True, None): "torch torch cuda cuda cuda cuda",
    ("cuda", True, "cpu"): "torch torch cuda cuda cuda cuda",
    ("distributed", False, None): "torch torch cuda cuda cuda cuda",
    ("distributed", False, "cpu"): "torch torch torch torch torch torch",
    ("distributed", True, None): (
        "torch torch distributed distributed_batch distributed "
        "distributed_batch",
        "torch torch cuda distributed_batch cuda distributed_batch"),
    ("distributed", True, "cpu"): (
        "torch torch distributed distributed_batch distributed "
        "distributed_batch",
        "torch torch cuda distributed_batch cuda distributed_batch"),
    ("distributed_batch", False, None): "torch torch cuda cuda cuda cuda",
    ("distributed_batch", False, "cpu"):
        "torch torch torch torch torch torch",
    ("distributed_batch", True, None):
        "torch torch cuda distributed_batch cuda distributed_batch",
    ("distributed_batch", True, "cpu"):
        "torch torch cuda distributed_batch cuda distributed_batch",
}


def _table():
    for (strategy, meshed, device), row in PRODUCERS.items():
        rows = row if isinstance(row, tuple) else (row, row)
        for route, names in zip(("dense", "sparse"), rows):
            names = names.split()
            for i, n in enumerate(NS):
                for j, batched in enumerate((False, True)):
                    yield pytest.param(
                        strategy, route, n, batched, meshed, device,
                        names[2 * i + j],
                        id=f"{strategy}-{route}-n{n}-"
                           f"{'bucket' if batched else 'scalar'}-"
                           f"{'mesh' if meshed else 'nomesh'}-{device}")


@pytest.mark.parametrize(
    "strategy,route,n,batched,meshed,device,want", list(_table()))
def test_producer_table(request, strategy, route, n, batched, meshed,
                        device, want):
    ctx = request.getfixturevalue("mesh") if meshed else None
    got = get_backend(strategy).value_backend(route, n, batched=batched,
                                              ctx=ctx, device=device)
    assert got == want


# ---------------------------------------------------------------------------
# the dispatch record
# ---------------------------------------------------------------------------

def _dense(n, seed, cplx=False):
    rng = np.random.default_rng(seed)
    A = rng.uniform(-1, 1, (n, n))
    return A + 1j * rng.uniform(-1, 1, (n, n)) if cplx else A


def _band(n, seed):
    """A density-0.22 band at n = 9: the sparse route."""
    return _dense(n, seed) * (np.eye(n) + np.roll(np.eye(n), 1, axis=1))


def _fm(seed):
    """An 8 x 8 matrix FM cuts into several leaves: two short rows."""
    A = _dense(8, seed)
    A[0, 2:] = 0
    A[5, :5] = 0
    return A


G = Geometry(32, 32, 8)
CPU = SolverConfig(device="cpu")
CAMP = CPU.replace(preprocess=False, campaign_threshold=1.0,
                   campaign_slices=8, campaign_lanes=8)
MIXED = [_dense(2, 1), _dense(6, 2), _dense(6, 2), _dense(6, 3),
         _dense(5, 4), _dense(3, 5), _dense(3, 6), _band(9, 7), _band(9, 8)]

# name -> (config, [(matrices, batched, cache), ...], on a mesh); runs of
# one case share the cache object where they name the same one
CASES = {
    "scalar_dense10": (CPU, [([_dense(10, 11)], False, "c")], False),
    "scalar_fm": (CPU, [([_fm(12)], False, "c")], False),
    "batched_mixed": (CPU.replace(preprocess=False),
                      [(MIXED, True, "c")], False),
    "complex_qq": (CPU.replace(precision="qq"),
                   [([_dense(6, s, True) for s in (13, 13, 14)], True, "c"),
                    ([_dense(7, 15, True)], False, "c")], False),
    "campaign_cache": (CAMP, [([_dense(9, 16)], False, "c"),
                              ([_dense(9, 16), _dense(2, 17), _dense(9, 16),
                                _dense(8, 18)], True, "c")], False),
    "campaign_nocache": (CAMP, [([_dense(9, 16)], False, None),
                                ([_dense(9, 16), _dense(2, 17),
                                  _dense(9, 16), _dense(8, 18)], True, None)],
                         False),
    "batched_twice": (CPU, [([_dense(6, s) for s in (19, 20, 21)]
                             + [_dense(7, 22)], True, "c")] * 2, False),
    "distributed_no_mesh": (
        CPU.replace(backend="distributed", preprocess=False),
        [([_dense(7, s) for s in (23, 24, 25)] + [_band(9, 26)], True, "c"),
         ([_band(9, 27)], False, "c"), ([_dense(7, 28)], False, "c")],
        False),
    "distributed_mesh": (
        CPU.replace(backend="distributed", preprocess=False),
        [([_dense(9, 29)], False, "c"), ([_band(9, 30)], False, "c"),
         ([_dense(3, 31)], False, "c"),
         ([_dense(8, s) for s in (32, 33, 34)] + [_dense(9, 35)]
          + [_dense(3, 36), _dense(3, 37)]
          + [_band(9, s) for s in (38, 39)], True, "c")], True),
    "distributed_batch_mesh": (
        CPU.replace(backend="distributed_batch", preprocess=False),
        [([_dense(9, 29)], False, "c"),
         ([_dense(8, s) for s in (32, 33)] + [_dense(9, 35)], True, "c")],
        True),
    "geometry": (
        CPU.replace(preprocess=False, geometry=G),
        [([_dense(9, 40)], False, "c"),
         ([_dense(6, s) for s in (41, 42)] + [_dense(3, 43), _band(9, 44)],
          True, "c")], False),
    "geometry_campaign": (CAMP.replace(geometry=G),
                          [([_dense(9, 16)], False, "c")], False),
    "geometry_torch_stand_in": (
        CPU.replace(backend="distributed", preprocess=False, geometry=G),
        [([_dense(6, s) for s in (45, 46)], True, "c")], False),
}


def _record(name, mesh=None):
    """Every run of case ``name``: values by ``float.hex``, each report's
    dispatch tags, the ``ExecStats`` counters, downgrades and timing keys
    (count, leaves), and the cache's keys in LRU order (content hash cut
    to 10 characters) with its hit and miss counts."""
    config, runs, _ = CASES[name]
    caches = {}
    out = []
    for mats, batched, cname in runs:
        cache = None if cname is None else \
            caches.setdefault(cname, ResultCache())
        plan = build_plan(mats, config, batched=batched)
        totals, reports, stats = execute_plan(plan, cache=cache,
                                              distributed_ctx=mesh)
        vals = [float.hex(complex(v).real) for v in totals]
        if plan.is_complex:
            vals += [float.hex(complex(v).imag) for v in totals]
        out.append({
            "values": vals,
            "dispatch": [r.dispatch for r in reports],
            "stats": [stats.device_dispatches, stats.batched_leaves,
                      stats.scalar_leaves, stats.inline_leaves,
                      stats.cache_hits, stats.cache_misses],
            "downgrades": stats.downgrades,
            "timings": {k: [t.count, t.leaves]
                        for k, t in sorted(stats.timings.items())},
            "cache": None if cache is None else
                ["|".join(map(str, (k[0][:10],) + k[1:])) for k in cache._data]
                + [cache.hits, cache.misses]})
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_dispatch_record(request, name):
    mesh = request.getfixturevalue("mesh") if CASES[name][2] else None
    assert _record(name, mesh) == GOLDEN[name]


# ---------------------------------------------------------------------------
# the service's campaign against the planner's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [{}, {"geometry": G}, {"backend": "torch"}],
                         ids=["default", "geometry", "torch"])
def test_service_campaign_body_is_the_planners_spec(extra):
    from repro_torch.serve import CampaignSpec, PermanentService, ServiceConfig
    C = _dense(9, 47)
    config = CPU.replace(**extra)
    svc = PermanentService(
        config, ServiceConfig(max_batch=2, log_every_s=float("inf")),
        campaign=CampaignSpec(matrix=C, slices=8, lanes=16), log=None)
    plan = build_plan([C], config.replace(
        campaign_threshold=1.0, campaign_slices=8, campaign_lanes=16),
        batched=False)
    spec = plan.leaves[0].campaign
    assert svc.campaign_body() == dict(
        total_slices=spec.total_slices,
        chunks_per_slice=spec.chunks_per_slice, chunk_size=spec.chunk_size,
        precision=spec.precision, backend=spec.backend,
        geometry=spec.geometry, device="cpu")
    assert spec.backend == ("torch" if extra.get("backend") else "cuda")
    assert spec.geometry == extra.get("geometry")


# Each case's record as the dispatcher gave it before its routing became
# one rule (``producer``) and one loop: the literals it is held to.
GOLDEN = {'scalar_dense10': [{'values': ['0x1.7904c097b2b14p+2'],
                     'dispatch': [['dense(n=10)']],
                     'stats': [1, 0, 1, 0, 0, 1],
                     'downgrades': [],
                     'timings': {'dense(n=10,cuda)': [1, 1]},
                     'cache': ['b8dcef8e77|dense|dq_acc|cuda|4096|<f8|-',
                               0,
                               1]}],
 'scalar_fm': [{'values': ['0x1.980e5c9bab202p+1'],
                'dispatch': [['dense(n=6)', 'dense(n=6)']],
                'stats': [2, 0, 2, 0, 0, 2],
                'downgrades': [],
                'timings': {'dense(n=6,cuda)': [2, 2]},
                'cache': ['789d02bc69|dense|dq_acc|cuda|4096|<f8|-',
                          '82cf7b237d|dense|dq_acc|cuda|4096|<f8|-',
                          0,
                          2]}],
 'batched_mixed': [{'values': ['-0x1.3d6b1693e10bep-1',
                               '0x1.dff0163835e21p-3',
                               '0x1.dff0163835e21p-3',
                               '0x1.abd3956100ebfp-2',
                               '0x1.965f6eec9d327p+0',
                               '0x1.cdc6a9e849bfep-1',
                               '-0x1.79920ff1a964cp-4',
                               '0x1.866bf9998dd0cp-10',
                               '0x1.5c8bba6294a78p-13'],
                    'dispatch': [['dense(n=2)'],
                                 ['dense_batch(n=6,b=2)'],
                                 ['cache(dense,n=6)'],
                                 ['dense_batch(n=6,b=2)'],
                                 ['dense(n=5)'],
                                 ['dense_batch(n=3,b=2,cuda->torch)'],
                                 ['dense_batch(n=3,b=2,cuda->torch)'],
                                 ['sparse_batch(n=9,b=2)'],
                                 ['sparse_batch(n=9,b=2)']],
                    'stats': [4, 6, 1, 1, 1, 7],
                    'downgrades': ['dense_batch(n=3,b=2,cuda->torch)'],
                    'timings': {'dense(n=5,cuda)': [1, 1],
                                'dense_batch(n=3,torch)': [1, 2],
                                'dense_batch(n=6,cuda)': [1, 2],
                                'sparse_batch(n=9,cuda)': [1, 2]},
                    'cache': ['a7595b0187|dense|dq_acc|torch|4096|<f8|-',
                              '63f2fdcda7|dense|dq_acc|torch|4096|<f8|-',
                              'a48887e866|dense|dq_acc|cuda|4096|<f8|-',
                              '2d32bfa613|dense|dq_acc|cuda|4096|<f8|-',
                              'b923254f2a|dense|dq_acc|cuda|4096|<f8|-',
                              '91fb5100cd|sparse|dq_acc|cuda|4096|<f8|-',
                              '15e015c78e|sparse|dq_acc|cuda|4096|<f8|-',
                              1,
                              7]}],
 'complex_qq': [{'values': ['0x1.75050a86d63c1p+1',
                            '0x1.75050a86d63c1p+1',
                            '-0x1.bbe3e4ba2efa1p+3',
                            '0x1.147b199a930c2p+2',
                            '0x1.147b199a930c2p+2',
                            '-0x1.23895feb20f4fp+3'],
                 'dispatch': [['precision(qq->kahan)',
                               'dense_batch(n=6,b=2)'],
                              ['precision(qq->kahan)',
                               'cache(dense,n=6)'],
                              ['precision(qq->kahan)',
                               'dense_batch(n=6,b=2)']],
                 'stats': [1, 2, 0, 0, 1, 2],
                 'downgrades': ['precision(qq->kahan)'],
                 'timings': {'dense_batch(n=6,cuda)': [1, 2]},
                 'cache': ['e9e876e5f7|dense|kahan|cuda|4096|<c16|-',
                           'd0cd4fed8a|dense|kahan|cuda|4096|<c16|-',
                           1,
                           2]},
                {'values': ['-0x1.0a894a50d2cb4p+2',
                            '0x1.928971ef7cc96p+4'],
                 'dispatch': [['precision(qq->kahan)', 'dense(n=7)']],
                 'stats': [1, 0, 1, 0, 0, 1],
                 'downgrades': ['precision(qq->kahan)'],
                 'timings': {'dense(n=7,cuda)': [1, 1]},
                 'cache': ['e9e876e5f7|dense|kahan|cuda|4096|<c16|-',
                           'd0cd4fed8a|dense|kahan|cuda|4096|<c16|-',
                           'eb2a33804e|dense|kahan|cuda|4096|<c16|-',
                           1,
                           3]}],
 'campaign_cache': [{'values': ['0x1.1bfa600523565p+1'],
                     'dispatch': [['campaign(n=9,cuda)']],
                     'stats': [1, 0, 1, 0, 0, 1],
                     'downgrades': [],
                     'timings': {'campaign(n=9,cuda)': [1, 1]},
                     'cache': ['49fa4c50ac|step_sharded|dq_acc|campaign[cuda,8x8x4,-]|4096|<f8|-',
                               0,
                               1]},
                    {'values': ['0x1.1bfa600523565p+1',
                                '-0x1.0aa580c34c2b1p-2',
                                '0x1.1bfa600523565p+1',
                                '-0x1.9b2f3440849bbp+1'],
                     'dispatch': [['cache(step_sharded,n=9)'],
                                  ['dense(n=2)'],
                                  ['cache(step_sharded,n=9)'],
                                  ['campaign(n=8,cuda)']],
                     'stats': [1, 0, 1, 1, 2, 1],
                     'downgrades': [],
                     'timings': {'campaign(n=8,cuda)': [1, 1]},
                     'cache': ['49fa4c50ac|step_sharded|dq_acc|campaign[cuda,8x8x4,-]|4096|<f8|-',
                               '6ddd603dec|step_sharded|dq_acc|campaign[cuda,8x8x2,-]|4096|<f8|-',
                               2,
                               2]}],
 'campaign_nocache': [{'values': ['0x1.1bfa600523565p+1'],
                       'dispatch': [['campaign(n=9,cuda)']],
                       'stats': [1, 0, 1, 0, 0, 0],
                       'downgrades': [],
                       'timings': {'campaign(n=9,cuda)': [1, 1]},
                       'cache': None},
                      {'values': ['0x1.1bfa600523565p+1',
                                  '-0x1.0aa580c34c2b1p-2',
                                  '0x1.1bfa600523565p+1',
                                  '-0x1.9b2f3440849bbp+1'],
                       'dispatch': [['campaign(n=9,cuda)'],
                                    ['dense(n=2)'],
                                    ['campaign(n=9,cuda)'],
                                    ['campaign(n=8,cuda)']],
                       'stats': [3, 0, 3, 1, 0, 0],
                       'downgrades': [],
                       'timings': {'campaign(n=8,cuda)': [1, 1],
                                   'campaign(n=9,cuda)': [2, 2]},
                       'cache': None}],
 'batched_twice': [{'values': ['0x1.47584bc812bd7p-4',
                               '-0x1.c963d265b5fe0p-2',
                               '0x1.2a6c48c0beaaep+0',
                               '0x1.f7a3e6d1b1da5p-1'],
                    'dispatch': [['dense_batch(n=6,b=3)'],
                                 ['dense_batch(n=6,b=3)'],
                                 ['dense_batch(n=6,b=3)'],
                                 ['dense(n=7)']],
                    'stats': [2, 3, 1, 0, 0, 4],
                    'downgrades': [],
                    'timings': {'dense(n=7,cuda)': [1, 1],
                                'dense_batch(n=6,cuda)': [1, 3]},
                    'cache': ['92df19eb60|dense|dq_acc|cuda|4096|<f8|-',
                              '01a42f80eb|dense|dq_acc|cuda|4096|<f8|-',
                              'f6e05906fc|dense|dq_acc|cuda|4096|<f8|-',
                              '52e252fed6|dense|dq_acc|cuda|4096|<f8|-',
                              0,
                              4]},
                   {'values': ['0x1.47584bc812bd7p-4',
                               '-0x1.c963d265b5fe0p-2',
                               '0x1.2a6c48c0beaaep+0',
                               '0x1.f7a3e6d1b1da5p-1'],
                    'dispatch': [['cache(dense,n=6)'],
                                 ['cache(dense,n=6)'],
                                 ['cache(dense,n=6)'],
                                 ['cache(dense,n=7)']],
                    'stats': [0, 0, 0, 0, 4, 0],
                    'downgrades': [],
                    'timings': {},
                    'cache': ['92df19eb60|dense|dq_acc|cuda|4096|<f8|-',
                              '01a42f80eb|dense|dq_acc|cuda|4096|<f8|-',
                              'f6e05906fc|dense|dq_acc|cuda|4096|<f8|-',
                              '52e252fed6|dense|dq_acc|cuda|4096|<f8|-',
                              4,
                              4]}],
 'distributed_no_mesh': [{'values': ['-0x1.16ab1fcb123adp+0',
                                     '-0x1.82b9e2c7d4c62p+0',
                                     '-0x1.3f5309b4c19cfp-4',
                                     '0x1.0d88ff4cd0584p-18'],
                          'dispatch': [['dense_batch(n=7,b=3,distributed->torch)'],
                                       ['dense_batch(n=7,b=3,distributed->torch)'],
                                       ['dense_batch(n=7,b=3,distributed->torch)'],
                                       ['sparse(n=9,distributed->torch)']],
                          'stats': [2, 3, 1, 0, 0, 4],
                          'downgrades': ['dense_batch(n=7,b=3,distributed->torch)',
                                         'sparse(n=9,distributed->torch)'],
                          'timings': {'dense_batch(n=7,torch)': [1,
                                                                 3],
                                      'sparse(n=9,torch)': [1, 1]},
                          'cache': ['4ebc7b5a34|dense|dq_acc|torch|4096|<f8|-',
                                    '05f9e8fd3a|dense|dq_acc|torch|4096|<f8|-',
                                    'e4c4330c53|dense|dq_acc|torch|4096|<f8|-',
                                    '756521c65b|sparse|dq_acc|torch|4096|<f8|-',
                                    0,
                                    4]},
                         {'values': ['-0x1.c71cc7ced5859p-12'],
                          'dispatch': [['sparse(n=9,distributed->torch)']],
                          'stats': [1, 0, 1, 0, 0, 1],
                          'downgrades': ['sparse(n=9,distributed->torch)'],
                          'timings': {'sparse(n=9,torch)': [1, 1]},
                          'cache': ['4ebc7b5a34|dense|dq_acc|torch|4096|<f8|-',
                                    '05f9e8fd3a|dense|dq_acc|torch|4096|<f8|-',
                                    'e4c4330c53|dense|dq_acc|torch|4096|<f8|-',
                                    '756521c65b|sparse|dq_acc|torch|4096|<f8|-',
                                    '35eac4fcc4|sparse|dq_acc|torch|4096|<f8|-',
                                    0,
                                    5]},
                         {'values': ['-0x1.810e4dedfff6fp+1'],
                          'dispatch': [['dense(n=7)']],
                          'stats': [1, 0, 1, 0, 0, 1],
                          'downgrades': [],
                          'timings': {'dense(n=7,torch)': [1, 1]},
                          'cache': ['4ebc7b5a34|dense|dq_acc|torch|4096|<f8|-',
                                    '05f9e8fd3a|dense|dq_acc|torch|4096|<f8|-',
                                    'e4c4330c53|dense|dq_acc|torch|4096|<f8|-',
                                    '756521c65b|sparse|dq_acc|torch|4096|<f8|-',
                                    '35eac4fcc4|sparse|dq_acc|torch|4096|<f8|-',
                                    'be3d2519b4|dense|dq_acc|torch|4096|<f8|-',
                                    0,
                                    6]}],
 'distributed_mesh': [{'values': ['0x1.4f171c19c7c1bp+1'],
                       'dispatch': [['dense(n=9)']],
                       'stats': [1, 0, 1, 0, 0, 1],
                       'downgrades': [],
                       'timings': {'dense(n=9,distributed)': [1, 1]},
                       'cache': ['ea86a22c6b|dense|dq_acc|distributed|4096|<f8|-',
                                 0,
                                 1]},
                      {'values': ['0x1.111170d467819p-11'],
                       'dispatch': [['sparse(n=9,distributed->cuda)']],
                       'stats': [1, 0, 1, 0, 0, 1],
                       'downgrades': ['sparse(n=9,distributed->cuda)'],
                       'timings': {'sparse(n=9,cuda)': [1, 1]},
                       'cache': ['ea86a22c6b|dense|dq_acc|distributed|4096|<f8|-',
                                 '430f0b78d8|sparse|dq_acc|cuda|4096|<f8|-',
                                 0,
                                 2]},
                      {'values': ['-0x1.9dd133606b282p-7'],
                       'dispatch': [['dense(n=3)']],
                       'stats': [1, 0, 1, 0, 0, 1],
                       'downgrades': [],
                       'timings': {'dense(n=3,torch)': [1, 1]},
                       'cache': ['ea86a22c6b|dense|dq_acc|distributed|4096|<f8|-',
                                 '430f0b78d8|sparse|dq_acc|cuda|4096|<f8|-',
                                 'e4b8f1cda3|dense|dq_acc|torch|4096|<f8|-',
                                 0,
                                 3]},
                      {'values': ['0x1.8d5770777e4bbp-3',
                                  '-0x1.16980934d86e4p+0',
                                  '0x1.1baa9f21166c4p+0',
                                  '0x1.33c7cb09f5d32p+2',
                                  '-0x1.8a1d414c84959p-8',
                                  '0x1.3d407f4040c94p-1',
                                  '-0x1.63d283d671dfep-9',
                                  '0x1.c529747f50282p-17'],
                       'dispatch': [['dense_batch(n=8,b=3)'],
                                    ['dense_batch(n=8,b=3)'],
                                    ['dense_batch(n=8,b=3)'],
                                    ['dense_batch(n=9,b=1)'],
                                    ['dense_batch(n=3,b=2,distributed->torch)'],
                                    ['dense_batch(n=3,b=2,distributed->torch)'],
                                    ['sparse_batch(n=9,b=2)'],
                                    ['sparse_batch(n=9,b=2)']],
                       'stats': [4, 8, 0, 0, 0, 8],
                       'downgrades': ['dense_batch(n=3,b=2,distributed->torch)'],
                       'timings': {'dense_batch(n=3,torch)': [1, 2],
                                   'dense_batch(n=8,distributed_batch)': [1,
                                                                          3],
                                   'dense_batch(n=9,distributed_batch)': [1,
                                                                          1],
                                   'sparse_batch(n=9,distributed_batch)': [1,
                                                                           2]},
                       'cache': ['ea86a22c6b|dense|dq_acc|distributed|4096|<f8|-',
                                 '430f0b78d8|sparse|dq_acc|cuda|4096|<f8|-',
                                 'e4b8f1cda3|dense|dq_acc|torch|4096|<f8|-',
                                 '8348de5c00|dense|dq_acc|torch|4096|<f8|-',
                                 '59cef5bbec|dense|dq_acc|torch|4096|<f8|-',
                                 'b2b12cd6c9|dense|dq_acc|distributed_batch|4096|<f8|-',
                                 '25f0553c51|dense|dq_acc|distributed_batch|4096|<f8|-',
                                 'e1bf0e1c53|dense|dq_acc|distributed_batch|4096|<f8|-',
                                 '92e3d6165e|dense|dq_acc|distributed_batch|4096|<f8|-',
                                 'd80da9817e|sparse|dq_acc|distributed_batch|4096|<f8|-',
                                 '556f3b7aa2|sparse|dq_acc|distributed_batch|4096|<f8|-',
                                 0,
                                 11]}],
 'distributed_batch_mesh': [{'values': ['0x1.4f171c19c7bfcp+1'],
                             'dispatch': [['dense(n=9)']],
                             'stats': [1, 0, 1, 0, 0, 1],
                             'downgrades': [],
                             'timings': {'dense(n=9,cuda)': [1, 1]},
                             'cache': ['ea86a22c6b|dense|dq_acc|cuda|4096|<f8|-',
                                       0,
                                       1]},
                            {'values': ['0x1.8d5770777e4bbp-3',
                                        '-0x1.16980934d86e4p+0',
                                        '0x1.33c7cb09f5d32p+2'],
                             'dispatch': [['dense_batch(n=8,b=2)'],
                                          ['dense_batch(n=8,b=2)'],
                                          ['dense_batch(n=9,b=1)']],
                             'stats': [2, 3, 0, 0, 0, 3],
                             'downgrades': [],
                             'timings': {'dense_batch(n=8,distributed_batch)': [1,
                                                                                2],
                                         'dense_batch(n=9,distributed_batch)': [1,
                                                                                1]},
                             'cache': ['ea86a22c6b|dense|dq_acc|cuda|4096|<f8|-',
                                       'b2b12cd6c9|dense|dq_acc|distributed_batch|4096|<f8|-',
                                       '25f0553c51|dense|dq_acc|distributed_batch|4096|<f8|-',
                                       '92e3d6165e|dense|dq_acc|distributed_batch|4096|<f8|-',
                                       0,
                                       4]}],
 'geometry': [{'values': ['-0x1.7725e127652c2p-1'],
               'dispatch': [['dense(n=9)']],
               'stats': [1, 0, 1, 0, 0, 1],
               'downgrades': [],
               'timings': {'dense(n=9,cuda)': [1, 1]},
               'cache': ['15551d41b4|dense|dq_acc|cuda|4096|<f8|32x32x8',
                         0,
                         1]},
              {'values': ['-0x1.70f2a356b2e41p+0',
                          '0x1.e5b6bfddce3cfp-3',
                          '0x1.4af0db6200b3ep-1',
                          '-0x1.8609f4f27e520p-9'],
               'dispatch': [['dense_batch(n=6,b=2)'],
                            ['dense_batch(n=6,b=2)'],
                            ['dense(n=3)'],
                            ['sparse(n=9,cuda)']],
               'stats': [3, 2, 2, 0, 0, 4],
               'downgrades': [],
               'timings': {'dense(n=3,torch)': [1, 1],
                           'dense_batch(n=6,cuda)': [1, 2],
                           'sparse(n=9,cuda)': [1, 1]},
               'cache': ['15551d41b4|dense|dq_acc|cuda|4096|<f8|32x32x8',
                         'b989ad4706|dense|dq_acc|torch|4096|<f8|-',
                         '549d7c3ae3|dense|dq_acc|cuda|4096|<f8|32x32x8',
                         '77242e27d7|dense|dq_acc|cuda|4096|<f8|32x32x8',
                         '6cffa5f000|sparse|dq_acc|cuda|4096|<f8|32x32x8',
                         0,
                         5]}],
 'geometry_campaign': [{'values': ['0x1.1bfa600523565p+1'],
                        'dispatch': [['campaign(n=9,cuda)']],
                        'stats': [1, 0, 1, 0, 0, 1],
                        'downgrades': [],
                        'timings': {'campaign(n=9,cuda)': [1, 1]},
                        'cache': ['49fa4c50ac|step_sharded|dq_acc|campaign[cuda,8x8x4,32x32x8]|4096|<f8|-',
                                  0,
                                  1]}],
 'geometry_torch_stand_in': [{'values': ['0x1.44e70868adf89p+0',
                                         '-0x1.58af89c7e33fdp-2'],
                              'dispatch': [['dense_batch(n=6,b=2,distributed->torch)'],
                                           ['dense_batch(n=6,b=2,distributed->torch)']],
                              'stats': [1, 2, 0, 0, 0, 2],
                              'downgrades': ['dense_batch(n=6,b=2,distributed->torch)'],
                              'timings': {'dense_batch(n=6,torch)': [1,
                                                                     2]},
                              'cache': ['d491be6a8d|dense|dq_acc|torch|4096|<f8|-',
                                        'b82c00766d|dense|dq_acc|torch|4096|<f8|-',
                                        0,
                                        2]}]}
