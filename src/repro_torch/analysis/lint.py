"""torchlint walker and CLI:

    python -m repro_torch.analysis.lint src/repro_torch tests chip_smoke.py

Pure standard library, like the rules.

* Two passes over the Python files: the first parses every file and
  builds the signature index PT003 needs (which callees accept which
  guarded kwargs), the second runs the rules per file.  ``.cu`` and
  ``.cuh`` files go to the CUDA rules (PC001-PC003).
* ``# torchlint: disable=RULE[,RULE] <reason>`` (``//`` in CUDA) on a
  flagged line, or alone on the line above it, suppresses the finding.
  The reason is required: a directive without one suppresses nothing.
  Suppressions are inventoried in the report, never hidden.  The
  reference's permlint reads only its own directive, so neither linter
  counts the other's.
* The orphan inventory lists the modules under ``src/repro_torch`` that
  nothing reachable from the port's CLIs, its examples and the gate
  imports.  Informational: orphans never fail the lint.

Exit status: 0 with no unsuppressed finding, 1 otherwise, 2 on a usage
error.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import re
import sys

from .rules import (RULES, CUDA_SUFFIXES, CudaContext, FileContext, Finding,
                    SignatureIndex, run_rules, strip_cuda)

__all__ = ["lint_paths", "lint_file", "parse_suppressions", "orphan_modules",
           "main", "ENTRY_POINTS", "DEFAULT_PATHS"]

DEFAULT_PATHS = ("src/repro_torch", "tests", "chip_smoke.py")
# the reference's red fixtures; its own tests lint them on purpose
DEFAULT_EXCLUDES = ("lint_fixtures",)
ENTRY_POINTS = ("repro_torch.launch.permanent", "repro_torch.launch.campaign",
                "repro_torch.launch.tune", "repro_torch.launch.serve",
                "repro_torch.core.solver", "repro_torch.core.engine",
                "repro_torch.serve.loop", "repro_torch.analysis.check",
                "repro_torch.examples.quickstart",
                "repro_torch.examples.boson_sampling",
                "repro_torch.examples.sparse_matchings",
                "repro_torch.examples.large_permanent",
                "repro_torch.examples.service")
_DIRECTIVE = re.compile(r"(#|//)\s*torchlint:\s*disable=([A-Z0-9]+"
                        r"(?:\s*,\s*[A-Z0-9]+)*)(.*)$")
_SUFFIXES = (".py",) + CUDA_SUFFIXES


def _norm(path: str) -> str:
    return path.replace(os.sep, "/")


def iter_files(paths, excludes=DEFAULT_EXCLUDES) -> list[str]:
    """Every .py, .cu and .cuh file under ``paths`` (files pass through)."""
    out = []
    for path in paths:
        if os.path.isfile(path):
            out.append(path)
            continue
        for root, dirs, files in os.walk(path):
            dirs[:] = sorted(d for d in dirs if d not in excludes
                             and not d.startswith(".") and d != "__pycache__")
            out.extend(os.path.join(root, f) for f in sorted(files)
                       if f.endswith(_SUFFIXES))
    return sorted(set(out))


def parse_suppressions(source: str) -> dict[int, dict[str, str]]:
    """line -> {rule: reason} disabled there.  A directive on a code line
    covers that line; one on a comment-only line covers the next line
    too."""
    out: dict[int, dict[str, str]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _DIRECTIVE.search(line)
        if not m:
            continue
        reason = m.group(3).strip().lstrip("#/ ").strip()
        rules = {r.strip(): reason for r in m.group(2).split(",")}
        out.setdefault(i, {}).update(rules)
        if line.strip().startswith(m.group(1)):
            out.setdefault(i + 1, {}).update(rules)
    return out


def _apply(findings, source: str):
    disabled = parse_suppressions(source)
    active, suppressed = [], []
    for f in findings:
        reason = disabled.get(f.line, {}).get(f.rule)
        if reason:
            f.suppressed, f.reason = True, reason
            suppressed.append(f)
        else:
            if reason == "":
                f.message += " (its suppression gives no reason)"
            active.append(f)
    return active, suppressed


def lint_file(path: str, signatures: SignatureIndex | None = None,
              only: set[str] | None = None, source: str | None = None,
              tree: ast.Module | None = None):
    """(active findings, suppressed findings) of one file."""
    norm = _norm(path)
    if source is None:
        with open(path, encoding="utf-8") as f:
            source = f.read()
    if norm.endswith(CUDA_SUFFIXES):
        ctx = CudaContext(path=norm, code=strip_cuda(source))
        return _apply(run_rules(ctx, only=only), source)
    if tree is None:
        try:
            tree = ast.parse(source, filename=path)
        except SyntaxError as e:
            return [Finding("PTE901", norm, e.lineno or 0, e.offset or 0,
                            f"syntax error: {e.msg}")], []
    if signatures is None:
        signatures = SignatureIndex()
        signatures.add(tree)
    ctx = FileContext(path=norm, tree=tree, source=source,
                      signatures=signatures)
    return _apply(run_rules(ctx, only=only), source)


def lint_paths(paths, only: set[str] | None = None,
               excludes=DEFAULT_EXCLUDES) -> dict:
    """Lint every file under ``paths``; the full report."""
    files = iter_files(paths, excludes)
    parsed, findings, suppressed = {}, [], []
    signatures = SignatureIndex()
    for path in files:
        with open(path, encoding="utf-8") as f:
            source = f.read()
        if path.endswith(".py"):
            try:
                tree = ast.parse(source, filename=path)
            except SyntaxError as e:
                findings.append(Finding("PTE901", _norm(path), e.lineno or 0,
                                        e.offset or 0,
                                        f"syntax error: {e.msg}"))
                continue
            signatures.add(tree)
            parsed[path] = (source, tree)
        else:
            parsed[path] = (source, None)
    for path, (source, tree) in parsed.items():
        active, supp = lint_file(path, signatures, only=only, source=source,
                                 tree=tree)
        findings += active
        suppressed += supp
    return {"version": "torchlint/1", "files": len(files),
            "findings": findings, "suppressions": suppressed,
            "orphans": orphan_modules(paths)}


# ---------------------------------------------------------------------------
# Orphan inventory
# ---------------------------------------------------------------------------

def _module_name(path: str) -> str | None:
    """'src/repro_torch/core/ryser.py' -> 'repro_torch.core.ryser'."""
    norm = _norm(path)
    pos = norm.rfind("src/repro_torch/")
    if pos < 0 or not norm.endswith(".py"):
        return None
    rel = norm[pos + len("src/"):-len(".py")]
    return rel[:-len("/__init__")].replace("/", ".") \
        if rel.endswith("/__init__") else rel.replace("/", ".")


def _import_edges(tree: ast.Module, modname: str) -> set[str]:
    """repro_torch modules a file imports, lazy imports included."""
    parts = modname.split(".")
    edges: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            edges |= {a.name for a in node.names
                      if a.name.startswith("repro_torch")}
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                mod = ".".join(parts[:max(len(parts) - node.level, 0)]
                               + ([node.module] if node.module else []))
            else:
                mod = node.module or ""
            if mod.startswith("repro_torch"):
                edges.add(mod)
                edges |= {f"{mod}.{a.name}" for a in node.names}
    return edges


def orphan_modules(paths, roots=ENTRY_POINTS) -> list[str]:
    """Modules under src/repro_torch that no entry point reaches."""
    graph: dict[str, set[str]] = {}
    for path in iter_files(paths):
        mod = _module_name(path)
        if mod is None:
            continue
        with open(path, encoding="utf-8") as f:
            try:
                tree = ast.parse(f.read(), filename=path)
            except SyntaxError:
                continue
        if _norm(path).endswith("/__init__.py"):
            # a package's relative imports resolve against itself
            graph[mod] = _import_edges(tree, mod + ".__init__")
        else:
            graph[mod] = _import_edges(tree, mod)
    reachable: set[str] = set()
    frontier = [r for r in roots if r in graph]
    while frontier:
        mod = frontier.pop()
        if mod in reachable:
            continue
        reachable.add(mod)
        parts = mod.split(".")
        # importing a module runs every package __init__ above it
        frontier += [p for p in (".".join(parts[:i])
                                 for i in range(1, len(parts)))
                     if p in graph and p not in reachable]
        for edge in graph.get(mod, ()):
            probe = edge
            while probe and probe not in graph and "." in probe:
                probe = probe.rsplit(".", 1)[0]
            if probe in graph and probe not in reachable:
                frontier.append(probe)
    return sorted(m for m in graph if m not in reachable)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def render(report: dict) -> str:
    lines = [f.render() for f in report["findings"]]
    supp = report["suppressions"]
    if supp:
        lines.append(f"suppressions ({len(supp)}):")
        lines += [f"  {s.render()}" for s in supp]
    if report["orphans"]:
        lines.append(f"orphan modules ({len(report['orphans'])}, "
                     f"informational):")
        lines += [f"  {m}" for m in report["orphans"]]
    lines.append(f"torchlint: {len(report['findings'])} finding(s), "
                 f"{len(supp)} suppression(s), {len(report['orphans'])} "
                 f"orphan module(s) in {report['files']} file(s)")
    return "\n".join(lines)


def report_json(report: dict) -> dict:
    return {"version": report["version"], "files": report["files"],
            "findings": [f.to_json() for f in report["findings"]],
            "suppressions": [s.to_json() for s in report["suppressions"]],
            "orphans": report["orphans"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="torchlint: the port's determinism and precision "
                    "contracts as static checks")
    ap.add_argument("paths", nargs="*", default=list(DEFAULT_PATHS))
    ap.add_argument("--json", action="store_true",
                    help="the report as JSON on stdout")
    ap.add_argument("--rules", default=None, metavar="PT001,PC003",
                    help="run only these rules")
    ap.add_argument("--list", action="store_true",
                    help="list the registered rules and exit")
    args = ap.parse_args(argv)
    if args.list:
        for rule in RULES.values():
            scope = ", ".join(rule.scope) or f"every {rule.language} file"
            print(f"{rule.name} [{rule.title}] ({scope})\n    "
                  f"{rule.invariant}")
        return 0
    only = None
    if args.rules:
        only = {r.strip() for r in args.rules.split(",") if r.strip()}
        unknown = only - set(RULES) - {"PTE901"}
        if unknown:
            print(f"unknown rule(s): {sorted(unknown)}; registered: "
                  f"{sorted(RULES)}", file=sys.stderr)
            return 2
    missing = [p for p in args.paths if not os.path.exists(p)]
    if missing:
        print(f"path(s) not found: {missing}", file=sys.stderr)
        return 2
    report = lint_paths(args.paths, only=only)
    if args.json:
        print(json.dumps(report_json(report), indent=1))
    else:
        print(render(report))
    return 1 if report["findings"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
