"""The port's planner screens each group of same-shape inputs as one
stack (``core/planner.py::_screen``) and passes whole the matrices that
DM and FM would hand back unchanged.  Its plans must equal the
reference's per-matrix planner field by field: entries, leaves in order
with their coefficients, routes and keys, buckets and the step estimate,
on inputs the screen passes, inputs it sends on to DM/FM, and mixes.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core.planner import SolverConfig as RefConfig  # noqa: E402
from repro.core.planner import build_plan as ref_build_plan  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core.planner import build_plan  # noqa: E402
from repro_torch.core.solver import PermanentSolver  # noqa: E402

REF_CONFIG = RefConfig(backend="pallas")
CONFIG = interop.config_from_reference(dataclasses.asdict(REF_CONFIG))


def _haar_stack(gen, modes=576, n=24, batch=512):
    """U[S, T] for the first n input modes S and ``batch`` distinct
    collision-free output patterns T of a Haar-random unitary U."""
    z = (gen.normal(size=(modes, modes))
         + 1j * gen.normal(size=(modes, modes))) / np.sqrt(2)
    q, r = np.linalg.qr(z)
    u = q * (np.diag(r) / np.abs(np.diag(r)))
    pats = np.sort(np.argsort(gen.random((batch, modes)), axis=1)[:, :n],
                   axis=1)
    return np.ascontiguousarray(u[:n][:, pats].transpose(1, 0, 2))


def _band(gen, n=32, degree=7):
    """A weighted degree-7 circulant band, rows and columns relabelled."""
    M = np.zeros((n, n))
    for j in range(n):
        M[(j + np.arange(degree)) % n, j] = gen.uniform(0.5, 1.5, degree)
    return M[gen.permutation(n)][:, gen.permutation(n)]


def _thin(gen, n, line, deg):
    """Dense n x n with row (or column) 3 cut to ``deg`` nonzeros."""
    M = gen.uniform(-1, 1, (n, n))
    keep = gen.choice(n, deg, replace=False)
    cut = np.zeros(n)
    cut[keep] = M[3, keep]
    M[3] = cut
    return M if line == "row" else M.T.copy()


def _blocks(gen, half=10, degree=6, spill=30):
    """[[A, B], [0, C]], A and C degree-6 bands: density 0.375 and every
    degree at least 6, so the screen sends it to DM, which removes B's
    ``spill`` entries (they lie in no perfect matching)."""
    M = np.zeros((2 * half, 2 * half))
    for j in range(half):
        rows = (j + np.arange(degree)) % half
        M[rows, j] = gen.uniform(0.5, 1.5, degree)
        M[half + rows, half + j] = gen.uniform(0.5, 1.5, degree)
    cut = gen.choice(half * half, spill, replace=False)
    M[cut // half, half + cut % half] = gen.uniform(0.5, 1.5, spill)
    return M


def _case(name, gen):
    if name == "haar512":
        return _haar_stack(gen)
    if name == "dense_real30":
        return [gen.uniform(-1, 1, (30, 30))]
    if name == "band32":
        return [_band(gen)]
    if name == "density03":
        return [gen.uniform(0.5, 1.5, (12, 12))
                * (gen.random((12, 12)) < 0.3) for _ in range(4)]
    if name == "row_col_4_5":
        return [_thin(gen, 10, line, deg)
                for line in ("row", "col") for deg in (4, 5)]
    if name == "dm_blocks":
        return [_blocks(gen)]
    if name == "zero_row":
        M = gen.uniform(-1, 1, (8, 8))
        M[2] = 0
        return [M]
    if name == "small_n":
        return [gen.uniform(-1, 1, (n, n)) for n in range(1, 7)] + \
            [np.ones((1, 1))]
    if name == "ragged":
        return [gen.uniform(-1, 1, (n, n)) for n in (7, 5, 7, 9, 5, 6)]
    if name == "f32_stack":
        return gen.uniform(-1, 1, (16, 8, 8)).astype(np.float32)
    if name == "c64_stack":
        return (gen.uniform(-1, 1, (16, 8, 8))
                + 1j * gen.uniform(-1, 1, (16, 8, 8))).astype(np.complex64)
    if name.startswith("mixed_"):
        return [gen.uniform(-1, 1, (n, n)) for n in (1, 2, 3, 4, 5)] + \
            [np.ones((1, 1)), _band(gen), _blocks(gen, half=6),
             _thin(gen, 10, "row", 4)]
    if name == "real_and_complex":
        return [gen.uniform(-1, 1, (6, 6)),
                gen.uniform(-1, 1, (6, 6)) + 1j * gen.uniform(-1, 1, (6, 6)),
                gen.uniform(-1, 1, (7, 7))]
    raise KeyError(name)


CASES = ("haar512", "dense_real30", "band32", "density03", "row_col_4_5",
         "dm_blocks", "zero_row", "small_n", "ragged", "f32_stack", "c64_stack",
         "real_and_complex", "mixed_dm_off", "mixed_fm_off",
         "mixed_preprocess_off")
# the knobs a case plans under, on top of the default config
KNOBS = {"mixed_dm_off": dict(dm=False), "mixed_fm_off": dict(fm=False),
         "mixed_preprocess_off": dict(preprocess=False)}
SCREENED = {"haar512": 512, "dense_real30": 1, "band32": 0,
            "dm_blocks": 0}


def _entries(plan):
    return [(e.index, e.n, e.nnz, e.density, e.dm_removed, e.fm_leaves,
             list(e.leaf_sizes), complex(e.const)) for e in plan.entries]


def _leaves(plan):
    return [(l.owner, complex(l.coef), l.route, l.key) for l in plan.leaves]


@pytest.mark.parametrize("batched", [True, False])
@pytest.mark.parametrize("name", CASES)
def test_screened_plan_equals_reference_plan(name, batched):
    mats = _case(name, np.random.default_rng(CASES.index(name)))
    knobs = KNOBS.get(name, {})
    ref = ref_build_plan(list(mats), REF_CONFIG.replace(**knobs),
                         batched=batched)
    got = build_plan(mats, CONFIG.replace(**knobs), batched=batched)
    assert _entries(got) == _entries(ref)
    assert _leaves(got) == _leaves(ref)
    assert got.buckets == ref.buckets
    assert got.estimated_steps == ref.estimated_steps
    assert (got.is_complex, got.precision) == (ref.is_complex, ref.precision)
    if name in SCREENED:
        assert got.screened == SCREENED[name]
        assert f" screened={SCREENED[name]} " in got.summary()
        assert got.to_json()["screened"] == SCREENED[name]


def test_screened_count_is_not_plan_identity():
    stack = _haar_stack(np.random.default_rng(5), modes=64, n=8, batch=16)
    plan = build_plan(stack, CONFIG, batched=True)
    assert plan.screened == 16
    other = dataclasses.replace(plan, screened=0)
    assert other == plan and other.fingerprint() == plan.fingerprint()


@pytest.mark.parametrize("form", ["ndarray", "list"])
def test_plan_does_not_alias_the_callers_stack(form):
    stack = _haar_stack(np.random.default_rng(9), modes=64, n=8, batch=32)
    want = PermanentSolver(CONFIG).plan_batch(stack.copy())
    given = stack if form == "ndarray" else list(stack)
    plan = PermanentSolver(CONFIG).plan_batch(given)
    stack[...] = 7.0
    assert plan.screened == 32
    for got, ref in zip(plan.leaves, want.leaves):
        assert not np.shares_memory(got.matrix, stack)
        np.testing.assert_array_equal(got.matrix, ref.matrix)
        assert got.key == ref.key
