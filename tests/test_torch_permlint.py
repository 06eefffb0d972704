"""torchlint (``repro_torch.analysis.lint``): every PT and PC rule fires on
its red fixture (a string written under ``tmp_path``, never a file of
the tree, which the reference's permlint walks), suppressions are
inventoried and need a reason, the port's own tree lints clean, the
orphan inventory, and the CLI's exit codes and JSON."""

import json
import os

import pytest

from repro_torch.analysis import lint
from repro_torch.analysis.rules import RULES, strip_cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TREE = [os.path.join(REPO, p) for p in lint.DEFAULT_PATHS]

# rule -> (path under the fixture root, source, expected findings)
FIXTURES = {
    "PT001": ("repro_torch/kernels/bad_sum.py", """\
import torch


def partials(x, a, b):
    s = torch.sum(x, dim=0)
    t = x.prod(-1)
    return s + t + (a @ b)
""", 3),
    "PT002": ("repro_torch/core/sparyser.py", """\
import torch


def values_complex(xr, xi):
    return torch.vmap(lambda a: a * 2)(xr)
""", 1),
    "PT003": ("repro_torch/core/passthrough.py", """\
def inner(A, *, device=None, geometry=None):
    return A


def outer(A, *, device=None, geometry=None):
    return inner(A, geometry=geometry)
""", 1),
    "PT004": ("repro_torch/serve/clockbad.py", """\
import time


def stamp():
    return time.monotonic()
""", 1),
    "PT005": ("repro_torch/core/planner.py", """\
from dataclasses import dataclass


@dataclass
class SolverConfig:
    precision: str = "dq_acc"
    new_knob: int = 0


class ExecutionPlan:
    _NUMERIC_FIELDS = ("precision",)
    _POLICY_FIELDS = ()
""", 1),
    "PT006": ("repro_torch/core/cachekey.py", """\
from repro_torch.core.cache import ResultCache


def key(leaf):
    return ResultCache.key(leaf, "dense", "dq_acc")
""", 1),
    "PT008": ("repro_torch/core/leak.py", """\
def engine():
    import jax.numpy as jnp
    from repro.core import ryser
    return jnp, ryser
""", 2),
    "PTF01": ("repro_torch/unused.py", """\
import os
import sys

print(sys.argv)
""", 1),
    "PTE901": ("repro_torch/broken.py", "def f(:\n    pass\n", 1),
    "PC001": ("repro_torch/kernels/csrc/bad_atomic.cu", """\
// atomicAdd in a comment is no call
__global__ void k(double* out, double v) {
  atomicAdd(out, v);
}
""", 1),
    "PC002": ("repro_torch/kernels/csrc/bad_shuffle.cuh", """\
__device__ double lane_sum(double v) {
  v += __shfl_down_sync(0xffffffff, v, 16);
  return cub::WarpReduce<double>(tmp).Sum(v);
}
""", 2),
    "PC003": ("repro_torch/kernels/csrc/bad_fma.cu", """\
__device__ double step(double a, double b, double c) {
  const char* s = "fma(x, y, z) in a string";
  double x = fma(a, b, c);
  return __fma_rn(a, b, x) + fma_rn(a, b, c);
}
""", 3),
    "PC004": ("repro_torch/kernels/build.py", """\
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3")
""", 1),
}


def _write(tmp_path, rel, source):
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(source)
    return str(path)


def test_every_rule_has_a_red_fixture():
    assert set(FIXTURES) == set(RULES) | {"PTE901"}


@pytest.mark.parametrize("rule", sorted(FIXTURES))
def test_rule_fires_on_its_fixture(rule, tmp_path):
    rel, source, count = FIXTURES[rule]
    _write(tmp_path, rel, source)
    report = lint.lint_paths([str(tmp_path)])
    hits = [f for f in report["findings"] if f.rule == rule]
    assert len(hits) == count, [f.render() for f in report["findings"]]
    assert lint.main([str(tmp_path)]) == 1


def test_comments_and_strings_are_blanked_line_for_line():
    src = 'a = 1; // atomicAdd(x)\n/* cub::\n */ b = "fma(1)";\n'
    code = strip_cuda(src)
    assert code.count("\n") == src.count("\n")
    assert "atomic" not in code and "cub" not in code and "fma" not in code


def test_fma_helpers_are_allowed_only_in_ryser_common(tmp_path):
    helper = """\
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
"""
    _write(tmp_path, "repro_torch/kernels/csrc/ryser_common.cuh", helper)
    _write(tmp_path, "repro_torch/kernels/csrc/other.cuh", helper)
    found = lint.lint_paths([str(tmp_path)])["findings"]
    assert {(os.path.basename(f.path), f.rule) for f in found} == \
        {("other.cuh", "PC003")}


def test_suppressions_need_a_reason_and_are_inventoried(tmp_path):
    _write(tmp_path, "repro_torch/kernels/a.py", """\
def f(x, y):
    a = x.sum()  # torchlint: disable=PT001 an integer count
    # torchlint: disable=PT001 the line below, for a reason
    b = y.sum()
    c = x.sum()  # torchlint: disable=PT001
    return a + b + c
""")
    _write(tmp_path, "repro_torch/kernels/csrc/k.cu", """\
__device__ double g(double a, double c) {
  return fma_rn(a, 1.0, c);  // torchlint: disable=PC003 exact: times 1
}
""")
    report = lint.lint_paths([str(tmp_path)])
    assert [(f.rule, f.line) for f in report["findings"]] == [("PT001", 5)]
    assert "no reason" in report["findings"][0].message
    reasons = sorted(s.reason for s in report["suppressions"])
    assert reasons == ["an integer count", "exact: times 1",
                       "the line below, for a reason"]


def test_reference_permlint_ignores_the_torchlint_directive():
    from repro.analysis.lint import parse_suppressions as reference_parse
    src = "x = y.sum()  # torchlint: disable=PT001 a count\n"
    assert reference_parse(src) == {}
    assert lint.parse_suppressions(src) == {1: {"PT001": "a count"}}


def test_port_tree_lints_clean_with_inventoried_suppressions():
    report = lint.lint_paths(TREE)
    assert [f.render() for f in report["findings"]] == []
    supp = report["suppressions"]
    assert {s.rule for s in supp} == {"PT001", "PT004", "PC003"}
    pc003 = [s for s in supp if s.rule == "PC003"]
    assert len(pc003) == 18
    assert all(s.reason.startswith("exact:") for s in pc003)
    assert all(s.reason for s in supp)


def test_orphan_inventory_starts_from_the_clis_and_examples():
    orphans = set(lint.orphan_modules([os.path.join(REPO, "src",
                                                    "repro_torch")]))
    assert orphans == {"repro_torch.interop"}
    for mod in lint.ENTRY_POINTS:
        assert mod not in orphans


def test_cli_exit_codes_and_json(tmp_path, capsys):
    assert lint.main(TREE + ["--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["version"] == "torchlint/1" and doc["findings"] == []
    assert len(doc["suppressions"]) >= 20
    assert lint.main(["--rules", "PL001"]) == 2
    assert lint.main([str(tmp_path / "missing")]) == 2
    assert lint.main(["--list"]) == 0
    rel, source, _ = FIXTURES["PT001"]
    _write(tmp_path, rel, source)
    capsys.readouterr()
    assert lint.main([str(tmp_path), "--json", "--rules", "PT001"]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert {f["rule"] for f in doc["findings"]} == {"PT001"}
