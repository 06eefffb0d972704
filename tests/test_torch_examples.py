"""The port's examples (``repro_torch.examples``) at ``device="cpu"``
against the reference's ``examples/*.py``, run as scripts: the same
sizes, seeds and order of draws, so the same lines come out.

Each pair of outputs is compared line by line after the backend names are
mapped (pallas -> cuda, jnp -> torch) and the host-dependent fields are
masked: timings and rates, the service's latency percentiles and compile
counters (the reference counts XLA compiles, the port loads of its
kernel library, none on the CPU), the shed's lateness.  The text must
then be equal and every number must agree to one unit in the last digit
the reference prints; a number printed with 17 digits (the campaign's
values) is held at the port's 1e-12 bar against the reference
(``tests/test_torch_campaign.py``), and an engine-against-engine delta or
error below 1e-9 on both sides.  The OK lines must appear in both.
"""

import importlib
import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("quickstart", "boson_sampling", "sparse_matchings",
         "large_permanent", "service")
NUMBER = re.compile(r"[-+]?\d[\d,]*(?:\.\d+)?(?:e[-+]?\d+)?")
RENAMES = (("pallas vs jnp", "cuda vs torch"), ("backend=pallas",
                                                 "backend=cuda"),
           ("backend=jnp", "backend=torch"), ("backend='jnp'",
                                              "backend='torch'"),
           (",jnp)", ",torch)"))
# (pattern, replacement): fields that depend on the host, not the values
MASKS = (
    (re.compile(r"[\d,]+ perms/s"), "<rate> perms/s"),
    (re.compile(r"in [\d.]+s, persistent compile cache: \{.*\}"),
     "in <s>s, persistent compile cache: <counters>"),
    (re.compile(r"cache now: \{.*\}"), "cache now: <counters>"),
    (re.compile(r"past deadline by \S+s"), "past deadline by <s>s"),
    (re.compile(r"p50=\d+ms p99=\d+ms"), "p50=<ms> p99=<ms>"),
)
# rounding-level figures (an engine against another engine): held below
# SMALL_BAR, not digit for digit
SMALL = (re.compile(r"\(delta (\S+)\)"), re.compile(r"rel\.err: (\S+)"))
SMALL_BAR = 1e-9


@pytest.fixture(scope="module")
def reference_outputs():
    """Every reference example's stdout; the scripts run side by side."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    procs = {name: subprocess.Popen(
        [sys.executable, os.path.join(REPO, "examples", f"{name}.py")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for name in NAMES}
    out = {}
    for name, p in procs.items():
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, f"reference {name}: {stderr[-2000:]}"
        out[name] = stdout
    return out


def _normal(line: str) -> tuple[str, list[str], list[str]]:
    """(text with numbers as '#', the numbers, the small figures)."""
    for a, b in RENAMES:
        line = line.replace(a, b)
    for pat, rep in MASKS:
        line = pat.sub(rep, line)
    small = []
    for pat in SMALL:
        small += pat.findall(line)
        line = pat.sub(lambda m: m.group(0).replace(m.group(1), "<small>"),
                       line)
    return NUMBER.sub("#", line), NUMBER.findall(line), small


def _unit(token: str) -> float:
    """One unit in the last printed digit of a float token."""
    mant, _, exp = token.lower().partition("e")
    decimals = len(mant.split(".")[1]) if "." in mant else 0
    return 10.0 ** ((int(exp) if exp else 0) - decimals)


def _agree(want: str, got: str) -> bool:
    if not re.search(r"[.e]", want):
        return want.replace(",", "") == got.replace(",", "")
    a, b = float(want.replace(",", "")), float(got.replace(",", ""))
    digits = len(re.sub(r"\D", "", want.lower().partition("e")[0]))
    if digits >= 16:
        return abs(a - b) <= 1e-12 * abs(a)
    return abs(a - b) <= 1.01 * _unit(want)


def _compare(ref: str, port: str) -> None:
    ref_lines, port_lines = ref.splitlines(), port.splitlines()
    assert len(ref_lines) == len(port_lines), (ref, port)
    for r, p in zip(ref_lines, port_lines):
        rt, rn, rs = _normal(r)
        pt, pn, ps = _normal(p)
        assert rt == pt, f"text differs:\n  reference: {r}\n  port:      {p}"
        assert len(rn) == len(pn)
        for w, g in zip(rn, pn):
            assert _agree(w, g), f"{w} vs {g}:\n  reference: {r}\n  port: {p}"
        assert all(float(x) < SMALL_BAR for x in rs + ps), (r, p)
    assert [_normal(line)[0] for line in ref_lines if "OK" in line] == \
        [_normal(line)[0] for line in port_lines if "OK" in line]


def _run_port(name: str, capsys) -> tuple[dict, str]:
    module = importlib.import_module(f"repro_torch.examples.{name}")
    capsys.readouterr()
    out = module.main(device="cpu")
    return out, capsys.readouterr().out


@pytest.mark.parametrize("name", NAMES)
def test_example_reproduces_reference(name, reference_outputs, capsys):
    out, printed = _run_port(name, capsys)
    _compare(reference_outputs[name], printed)
    assert isinstance(out, dict) and out


def test_quickstart_returns_what_it_printed(capsys):
    out, printed = _run_port("quickstart", capsys)
    assert f"= {out['perm_random']:+.12e}" in printed
    assert f"= {out['perm_sparse']:+.12e}" in printed
    assert out["matchings"] == 5 and out["flushes"] == 3
    assert set(out["precision_rel"]) == {"dd", "dq_acc", "kahan"}
    assert abs(out["cuda"] - out["torch"]) <= 1e-12 * abs(out["torch"])


def test_large_permanent_resumes_bit_for_bit(capsys):
    out, _ = _run_port("large_permanent", capsys)
    assert out["bitwise"] and out["value"] == out["uninterrupted"]
    assert out["rel"] < 1e-12 and out["route"] == "step_sharded"
    assert out["paused_at"] == pytest.approx(2 / 16)


def test_service_serves_metrics_schema(capsys):
    out, _ = _run_port("service", capsys)
    assert out["schema"] == "repro.serve.metrics/v1"
    assert out["completed"] == 7 and out["shed_counts"] == {
        "deadline_expired": 1}
    assert out["warmup"]["compile"] == {"requests": 0, "persistent_hits": 0,
                                        "persistent_misses": 0}


def test_examples_need_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.examples import quickstart
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        quickstart.main()
