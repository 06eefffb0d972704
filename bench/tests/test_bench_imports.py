"""Nothing of the benchmark imports jax or the JAX package, and the
reference imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
NEVER = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path) -> set[str]:
    """Top-level names (before the first dot) of every import in a file."""
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in
                 p.parts)


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: p.relative_to(BENCH).as_posix())
def test_no_jax_and_no_reference_package(path):
    assert not (_imports(path) & NEVER)


def test_names_are_compared_whole(tmp_path):
    """``repro_torch`` starts with ``repro`` and is allowed; ``repro`` and
    ``jax.numpy`` are not."""
    probe = tmp_path / "probe.py"
    probe.write_text("import repro_torch.core\nfrom repro import x\n"
                     "import jax.numpy as jnp\n")
    assert _imports(probe) & NEVER == {"repro", "jax"}


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not (_imports(path) & (NEVER | {"repro_torch", "bench"}))


def test_harness_modules_load_neither(tmp_path):
    """In a fresh interpreter, loading the harness and the program it
    drives leaves no jax and no ``repro`` module in ``sys.modules``."""
    probe = (
        "import sys\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "import bench.harness, bench.check, bench.control, bench.readers\n"
        "from bench import byname, harness\n"
        "for f in ('calls', 'campaign'):\n"
        "    byname.module(harness.ROOT, 'loops', f)\n"
        "for f in ('uniform', 'haar_submatrices'):\n"
        "    byname.module(harness.ROOT, 'families', f)\n"
        "import repro_torch, repro_torch.launch.mesh\n"
        "from bench.harness import forbidden_modules\n"
        "print(forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_forbidden_modules_compares_top_level_names(monkeypatch):
    from bench import harness
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", object())
    assert "repro_torch_lookalike" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake_probe", object())
    assert "jaxlib.fake_probe" in harness.forbidden_modules()
