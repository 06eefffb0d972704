"""torchlint rules: the port's determinism and precision contracts as
static checks on its Python sources (``ast``) and its CUDA sources (text
with comments and strings blanked).  Catalog and postmortems:
``repro_torch/analysis/__init__.py``.

Pure standard library: the linter runs in a bare interpreter, before
torch is imported.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Callable

__all__ = ["Finding", "Rule", "RULES", "SignatureIndex", "GUARDED_KWARGS",
           "FileContext", "CudaContext", "run_rules", "strip_cuda"]

# Kwargs whose silent loss changes what is computed or where.
GUARDED_KWARGS = ("precision", "num_chunks", "backend", "device", "geometry")

# Scopes are path fragments matched against '/'-normalized file paths.
ACCUM_SCOPE = ("core/ryser.py", "core/sparyser.py", "core/distributed.py",
               "kernels/")
CLOCK_SCOPE = ("core/", "serve/")
PLANNER_SCOPE = ("core/planner.py",)
PORT_SCOPE = ("repro_torch/", "chip_smoke.py")
BUILD_SCOPE = ("kernels/build.py",)
CUDA_SCOPE = ("kernels/csrc/",)
CUDA_SUFFIXES = (".cu", ".cuh")

# torch reductions whose association is the library's choice
TORCH_REDUCERS = ("sum", "prod", "matmul", "mm", "bmm", "einsum", "cumsum",
                  "dot")
METHOD_REDUCERS = ("sum", "prod", "cumsum")
# the fma_rn helpers may call the intrinsics; nothing else may
FMA_HELPER_FILE = "kernels/csrc/ryser_common.cuh"


@dataclass
class Finding:
    """One rule violation (or, when ``suppressed``, an inventoried one)."""
    rule: str
    path: str
    line: int
    col: int
    message: str
    suppressed: bool = False
    reason: str = ""

    def to_json(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message,
                "suppressed": self.suppressed, "reason": self.reason}

    def render(self) -> str:
        out = f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"
        return out + (f"  [reason: {self.reason}]" if self.reason else "")


@dataclass
class FileContext:
    """What a Python rule sees of one file."""
    path: str                        # '/'-normalized
    tree: ast.Module
    source: str
    signatures: "SignatureIndex"


@dataclass
class CudaContext:
    """What a CUDA rule sees of one source: ``code`` is the text with
    comments and string literals blanked (line numbers kept)."""
    path: str
    code: str


@dataclass
class Rule:
    name: str
    title: str
    scope: tuple[str, ...]           # () = every file of its language
    invariant: str
    check: Callable
    language: str = "python"         # python | cuda

    def in_scope(self, path: str) -> bool:
        return not self.scope or any(s in path for s in self.scope)


RULES: dict[str, Rule] = {}


def _rule(name: str, title: str, scope: tuple[str, ...] = (),
          invariant: str = "", language: str = "python"):
    def deco(fn):
        RULES[name] = Rule(name, title, tuple(scope), invariant, fn, language)
        return fn
    return deco


# ---------------------------------------------------------------------------
# AST helpers
# ---------------------------------------------------------------------------

def _dotted(node) -> str | None:
    """'torch.sum' / 'time.monotonic' for an attribute chain rooted at a
    Name; None for anything else."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _names_in(node) -> set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


_FUNC_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)


def _func_params(fn) -> list[str]:
    a = fn.args
    return [p.arg for p in (a.posonlyargs + a.args + a.kwonlyargs)]


@dataclass
class SignatureIndex:
    """The guarded kwargs every definition of a function name accepts
    (the intersection over definitions: an ambiguous name is not
    checked)."""
    guarded: dict[str, set[str]] = field(default_factory=dict)

    def add(self, tree: ast.Module) -> None:
        for node in ast.walk(tree):
            if not isinstance(node, _FUNC_DEFS):
                continue
            params = set(_func_params(node)) & set(GUARDED_KWARGS)
            if node.name in self.guarded:
                self.guarded[node.name] &= params
            else:
                self.guarded[node.name] = params

    def accepts(self, name: str) -> set[str]:
        return self.guarded.get(name, set())


# ---------------------------------------------------------------------------
# PT001 -- fixed-order reductions on accumulation paths
# ---------------------------------------------------------------------------

@_rule("PT001", "fixed-order-reduction", scope=ACCUM_SCOPE,
       invariant="no torch.sum/prod/matmul/mm/bmm/einsum/cumsum/dot, no "
                 ".sum()/.prod()/.cumsum() and no @ on the engines' and "
                 "kernels' paths; use the fixed-order twofloat reducers "
                 "(tf_tree_sum, tree_sum, chain_prod, kernel_reduce)")
def _check_reductions(ctx: FileContext) -> list[Finding]:
    out = []
    for node in ast.walk(ctx.tree):
        what = None
        if isinstance(node, ast.Call):
            name = _dotted(node.func)
            head, _, attr = (name or "").rpartition(".")
            if name and head == "torch" and attr in TORCH_REDUCERS:
                what = f"{name}()"
            elif (isinstance(node.func, ast.Attribute)
                  and node.func.attr in METHOD_REDUCERS
                  and _dotted(node.func.value) not in ("torch", "np",
                                                       "numpy")):
                what = f".{node.func.attr}()"
        elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult):
            what = "the @ operator"
        elif isinstance(node, ast.AugAssign) and \
                isinstance(node.op, ast.MatMult):
            what = "the @= operator"
        if what:
            out.append(Finding(
                "PT001", ctx.path, node.lineno, node.col_offset,
                f"{what} on an accumulation path: the library picks its "
                f"association per device and shape, so values would differ "
                f"between the card, the CPU and batch extents; use the "
                f"fixed-order twofloat reducers, or suppress with the reason "
                f"the result is exact"))
    return out


# ---------------------------------------------------------------------------
# PT002 -- no vmap over complex engine bodies
# ---------------------------------------------------------------------------

_VMAPS = ("vmap", "torch.vmap", "torch.func.vmap", "func.vmap",
          "functorch.vmap")


@_rule("PT002", "no-vmap-complex", scope=ACCUM_SCOPE,
       invariant="complex engine bodies carry an explicit batch axis, never "
                 "torch.vmap / torch.func.vmap")
def _check_vmap_complex(ctx: FileContext) -> list[Finding]:
    out = []
    for fn in ast.walk(ctx.tree):
        if not isinstance(fn, _FUNC_DEFS) or "complex" not in fn.name:
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and _dotted(node.func) in _VMAPS:
                out.append(Finding(
                    "PT002", ctx.path, node.lineno, node.col_offset,
                    f"{_dotted(node.func)}() inside complex engine body "
                    f"{fn.name!r}: a vmapped body is another program at "
                    f"every batch extent; keep the batch axis explicit"))
    return out


# ---------------------------------------------------------------------------
# PT003 -- guarded kwarg passthrough
# ---------------------------------------------------------------------------

def _alias_closure(fn, seed: str) -> set[str]:
    """Names assigned, directly or through one more assignment, from
    ``seed`` in ``fn``."""
    aliases = {seed}
    for _ in range(2):
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets, value = [node.target], node.value
            else:
                continue
            if _names_in(value) & aliases:
                for t in targets:
                    aliases |= {leaf.id for leaf in ast.walk(t)
                                if isinstance(leaf, ast.Name)}
    return aliases


def _call_forwards(call: ast.Call, aliases: set[str]) -> bool:
    for arg in call.args:
        if _names_in(arg) & aliases:
            return True
    for kw in call.keywords:
        if kw.arg is None or _names_in(kw.value) & aliases:
            return True              # a **kwargs splat counts as forwarding
    return False


@_rule("PT003", "kwarg-passthrough", scope=PORT_SCOPE,
       invariant="a function of the port accepting precision/num_chunks/"
                 "backend/device/geometry forwards each to every call whose "
                 "callee accepts it too, or binds it there explicitly")
def _check_passthrough(ctx: FileContext) -> list[Finding]:
    out = []
    for fn in ast.walk(ctx.tree):
        if not isinstance(fn, _FUNC_DEFS):
            continue
        own = set(_func_params(fn)) & set(GUARDED_KWARGS)
        if not own:
            continue
        aliases = {g: _alias_closure(fn, g) for g in own}
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            callee = node.func.attr if isinstance(node.func, ast.Attribute) \
                else node.func.id if isinstance(node.func, ast.Name) else None
            if callee is None or callee == fn.name:
                continue
            bound = {kw.arg for kw in node.keywords}
            for g in sorted(ctx.signatures.accepts(callee) & own - bound):
                if not _call_forwards(node, aliases[g]):
                    out.append(Finding(
                        "PT003", ctx.path, node.lineno, node.col_offset,
                        f"call to {callee}() drops {g!r}: both {fn.name}() "
                        f"and {callee}() accept it, so the callee runs at "
                        f"its default; forward it"))
    return out


# ---------------------------------------------------------------------------
# PT004 -- injectable clocks
# ---------------------------------------------------------------------------

@_rule("PT004", "injectable-clock", scope=CLOCK_SCOPE,
       invariant="no time.time/time.monotonic in core/ or serve/ outside the "
                 "SolverConfig.clock default sites")
def _check_wall_clock(ctx: FileContext) -> list[Finding]:
    return [Finding("PT004", ctx.path, node.lineno, node.col_offset,
                    f"{_dotted(node)} in {ctx.path.split('/')[-2]}/: time "
                    f"goes through the injectable SolverConfig.clock")
            for node in ast.walk(ctx.tree)
            if isinstance(node, ast.Attribute)
            and _dotted(node) in ("time.time", "time.monotonic")]


# ---------------------------------------------------------------------------
# PT005 -- SolverConfig fields classified
# ---------------------------------------------------------------------------

def _class_body(tree: ast.Module, name: str) -> ast.ClassDef | None:
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == name:
            return node
    return None


def _str_tuple_assign(cls: ast.ClassDef, name: str) -> set[str] | None:
    for node in cls.body:
        targets = node.targets if isinstance(node, ast.Assign) else \
            [node.target] if isinstance(node, ast.AnnAssign) else []
        if not any(isinstance(t, ast.Name) and t.id == name for t in targets):
            continue
        v = node.value
        if isinstance(v, ast.Tuple) and all(
                isinstance(e, ast.Constant) and isinstance(e.value, str)
                for e in v.elts):
            return {e.value for e in v.elts}
        return None
    return None


@_rule("PT005", "config-classification", scope=PLANNER_SCOPE,
       invariant="every SolverConfig field is in exactly one of "
                 "ExecutionPlan._NUMERIC_FIELDS and _POLICY_FIELDS")
def _check_config_classified(ctx: FileContext) -> list[Finding]:
    cfg = _class_body(ctx.tree, "SolverConfig")
    plan = _class_body(ctx.tree, "ExecutionPlan")
    if cfg is None or plan is None:
        return []
    fields = {n.target.id for n in cfg.body
              if isinstance(n, ast.AnnAssign) and isinstance(n.target,
                                                             ast.Name)}
    numeric = _str_tuple_assign(plan, "_NUMERIC_FIELDS")
    policy = _str_tuple_assign(plan, "_POLICY_FIELDS")
    if numeric is None or policy is None:
        return [Finding("PT005", ctx.path, plan.lineno, plan.col_offset,
                        "ExecutionPlan must declare _NUMERIC_FIELDS and "
                        "_POLICY_FIELDS as literal string tuples")]
    out = []
    for bad, what in ((fields - numeric - policy, "are not classified"),
                      (numeric & policy, "are in both tuples"),
                      ((numeric | policy) - fields,
                       "are classified but are no SolverConfig fields")):
        if bad:
            out.append(Finding("PT005", ctx.path, cfg.lineno, cfg.col_offset,
                               f"SolverConfig field(s) {sorted(bad)} {what}"))
    return out


# ---------------------------------------------------------------------------
# PT006 -- cache keys bind every component
# ---------------------------------------------------------------------------

_CACHE_KEY_PARAMS = ("leaf_key", "route", "precision", "backend",
                     "num_chunks", "dtype", "geometry")


@_rule("PT006", "cache-key-completeness",
       invariant="ResultCache.key call sites bind every component, backend, "
                 "dtype and geometry included")
def _check_cache_key(ctx: FileContext) -> list[Finding]:
    out = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call) or \
                _dotted(node.func) != "ResultCache.key":
            continue
        bound = set(_CACHE_KEY_PARAMS[:len(node.args)])
        bound |= {kw.arg for kw in node.keywords if kw.arg}
        missing = [p for p in _CACHE_KEY_PARAMS if p not in bound]
        if missing:
            out.append(Finding(
                "PT006", ctx.path, node.lineno, node.col_offset,
                f"ResultCache.key() leaves {missing} at their defaults: two "
                f"producers would share an entry"))
    return out


# ---------------------------------------------------------------------------
# PT008 -- the port imports neither jax nor the reference package
# ---------------------------------------------------------------------------

def _foreign(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@_rule("PT008", "port-isolation", scope=PORT_SCOPE,
       invariant="nothing under src/repro_torch and not chip_smoke.py "
                 "imports jax or a repro module")
def _check_isolation(ctx: FileContext) -> list[Finding]:
    out = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            mods = [node.module or ""]
        else:
            continue
        for m in mods:
            if _foreign(m):
                out.append(Finding(
                    "PT008", ctx.path, node.lineno, node.col_offset,
                    f"imports {m!r}: the port keeps its own copy of what it "
                    f"needs and never loads jax or the reference package"))
    return out


# ---------------------------------------------------------------------------
# PC004 -- the build never contracts into FMA
# ---------------------------------------------------------------------------

@_rule("PC004", "no-fmad", scope=BUILD_SCOPE,
       invariant="kernels/build.py::NVCC_FLAGS holds --fmad=false")
def _check_fmad(ctx: FileContext) -> list[Finding]:
    for node in ctx.tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "NVCC_FLAGS"
                for t in node.targets):
            flags = [e.value for e in ast.walk(node.value)
                     if isinstance(e, ast.Constant)]
            if "--fmad=false" in flags:
                return []
            return [Finding("PC004", ctx.path, node.lineno, node.col_offset,
                            "NVCC_FLAGS lacks --fmad=false: nvcc would fuse "
                            "a*b + c and the two-product error terms and "
                            "the chain products would round differently "
                            "from the plain versions")]
    return [Finding("PC004", ctx.path, 1, 0,
                    "no NVCC_FLAGS assignment at module level")]


# ---------------------------------------------------------------------------
# PTF01 -- unused module-level imports
# ---------------------------------------------------------------------------

def _used_names(tree: ast.Module) -> set[str]:
    used = {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            used |= {e.value for e in ast.walk(node.value)
                     if isinstance(e, ast.Constant)
                     and isinstance(e.value, str)}
    return used


@_rule("PTF01", "unused-import",
       invariant="no unused module-level imports")
def _check_unused_imports(ctx: FileContext) -> list[Finding]:
    if ctx.path.endswith("__init__.py"):
        return []                    # the package's re-export surface
    used = _used_names(ctx.tree)
    out = []
    for node in ctx.tree.body:
        if isinstance(node, ast.ImportFrom) and node.module == "__future__":
            continue
        if not isinstance(node, (ast.Import, ast.ImportFrom)):
            continue
        for alias in node.names:
            bound = alias.asname or alias.name.split(".")[0]
            if alias.name != "*" and bound not in used:
                out.append(Finding("PTF01", ctx.path, node.lineno,
                                   node.col_offset,
                                   f"{bound!r} imported but unused"))
    return out


# ---------------------------------------------------------------------------
# CUDA sources
# ---------------------------------------------------------------------------

_CUDA_TOKENS = re.compile(r'//[^\n]*|/\*.*?\*/|"(?:\\.|[^"\\\n])*"'
                          r"|'(?:\\.|[^'\\\n])*'", re.S)


def strip_cuda(source: str) -> str:
    """``source`` with comments and string/char literals replaced by
    spaces, newlines kept, so positions map to the original lines."""
    return _CUDA_TOKENS.sub(
        lambda m: re.sub(r"[^\n]", " ", m.group(0)), source)


def _line_col(text: str, pos: int) -> tuple[int, int]:
    line = text.count("\n", 0, pos) + 1
    return line, pos - (text.rfind("\n", 0, pos) + 1)


def _cuda_hits(ctx: CudaContext, pattern: str, rule: str, what: str,
               skip=()) -> list[Finding]:
    out = []
    for m in re.finditer(pattern, ctx.code):
        if any(a <= m.start() < b for a, b in skip):
            continue
        line, col = _line_col(ctx.code, m.start())
        out.append(Finding(rule, ctx.path, line, col,
                           f"{m.group(0).rstrip('( ')}: {what}"))
    return out


@_rule("PC001", "no-atomics", scope=CUDA_SCOPE, language="cuda",
       invariant="no atomic* call in the kernel sources")
def _check_atomics(ctx: CudaContext) -> list[Finding]:
    return _cuda_hits(ctx, r"\batomic\w*\s*\(", "PC001",
                      "an atomic's order is the scheduler's, so sums would "
                      "differ from run to run; reduce in a fixed-order tree")


@_rule("PC002", "no-warp-reductions", scope=CUDA_SCOPE, language="cuda",
       invariant="no warp shuffle and no cub:: reduction in the kernel "
                 "sources")
def _check_shuffles(ctx: CudaContext) -> list[Finding]:
    return _cuda_hits(ctx, r"\b__shfl\w*\s*\(|\bcub\s*::", "PC002",
                      "a library or shuffle reduction fixes no association "
                      "the plain versions can repeat; use the shared-memory "
                      "lane tree")


_FMA_DEF = re.compile(r"\b(?:double|float)\s+fma_rn\s*\([^)]*\)\s*\{")


def _helper_spans(ctx: CudaContext) -> list[tuple[int, int]]:
    """Spans of the fma_rn helper definitions (their bodies included), in
    the one file allowed to hold them."""
    if not ctx.path.endswith(FMA_HELPER_FILE):
        return []
    spans = []
    for m in _FMA_DEF.finditer(ctx.code):
        depth, pos = 1, m.end()
        while depth and pos < len(ctx.code):
            depth += {"{": 1, "}": -1}.get(ctx.code[pos], 0)
            pos += 1
        spans.append((m.start(), pos))
    return spans


@_rule("PC003", "explicit-fma", scope=CUDA_SCOPE, language="cuda",
       invariant="no fma/fmaf/__fma_rn/__fmaf_rn outside the fma_rn helpers "
                 "of ryser_common.cuh, and every fma_rn call carries a "
                 "suppression that says why its product is exact")
def _check_fma(ctx: CudaContext) -> list[Finding]:
    return _cuda_hits(ctx, r"\b(?:__fmaf?_rn|fmaf?|fma_rn)\s*\(", "PC003",
                      "a fused multiply-add rounds once where the plain "
                      "version rounds twice; it is bit for bit only when "
                      "the product is exact (say why in the suppression)",
                      skip=_helper_spans(ctx))


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------

def run_rules(ctx, only: set[str] | None = None) -> list[Finding]:
    """All findings of the in-scope rules of ``ctx``'s language."""
    language = "cuda" if isinstance(ctx, CudaContext) else "python"
    out: list[Finding] = []
    for rule in RULES.values():
        if only is not None and rule.name not in only:
            continue
        if rule.language == language and rule.in_scope(ctx.path):
            out.extend(rule.check(ctx))
    out.sort(key=lambda f: (f.line, f.col, f.rule))
    return out
