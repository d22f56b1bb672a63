"""``torch-hygiene`` — wall clocks, hot-path host syncs and the port's
boundary rules, caught at lint time (the port's counterpart of
knn_tpu/analysis/check_jax.py).

Three rule families:

1. **Wall clock** (``knn_tpu_torch/`` except ``csrc/probes/``, which are
   measurement scripts, as ``chip_smoke.py`` is): ``time.time()`` is a
   finding.  Durations come from ``time.perf_counter`` /
   ``time.monotonic`` (wall time is not monotonic: an NTP step corrupts
   a latency measurement exactly once, unreproducibly).  The legitimate
   uses — timestamps that are displayed or compared across processes —
   carry suppression entries saying so, so every NEW wall-clock read has
   to argue its case.

2. **Hot-path host syncs** (``knn_tpu_torch/``): inside a function
   marked ``@hot_path`` (knn_tpu_torch.analysis.annotations), calls that
   wait for the card or pull its data to the host — ``.item()``,
   ``.tolist()``, ``.cpu()``, ``.numpy()``, ``torch.cuda.synchronize``
   and ``.synchronize()`` on a stream or event,
   ``np.asarray``/``np.array``/``np.ascontiguousarray``,
   ``float(...)``/``int(...)`` of a call or subscript — are findings.
   The serving engine's dispatch enqueues a graph replay and returns; one
   stray sync serializes it silently.  The decorator's
   ``allow=("np.asarray", ...)`` tuple exempts calls AT the annotation.

3. **The port's boundary rules** (ROADMAP ground rules "Imports" and
   "Kernels"), over the whole lint tree:

   - an ``import`` of ``jax``, ``jaxlib`` or ``knn_tpu`` (the reference
     package, not ``knn_tpu_torch``) — also through
     ``importlib.import_module`` / ``__import__`` with a literal name —
     is a finding (the subprocess import test in
     ``tests/test_torch_job.py`` stays; this adds the file and line);
   - an ``except`` handler whose body calls a function named
     ``*_plain`` is a finding: that is a fallback from a kernel to its
     plain version, which the port never takes on the card.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Sequence, Tuple

from knn_tpu_torch.analysis.core import Context, Finding, checker

#: call names forbidden inside @hot_path functions (dotted-tail match).
#: ``time.time`` is deliberately absent: the wall-clock rule already
#: flags every read ONCE, everywhere, and a hot-path ``allow`` tuple
#: must never be able to whitelist a wall clock
HOT_FORBIDDEN = (
    ".item",
    ".tolist",
    ".cpu",
    ".numpy",
    "torch.cuda.synchronize",
    ".synchronize",
    "np.asarray",
    "np.array",
    "np.ascontiguousarray",
)

#: top-level packages the port never imports
FORBIDDEN_IMPORTS = ("jax", "jaxlib", "knn_tpu")

#: measurement scripts under the package (out of the wall-clock rule's
#: scope)
_PROBES = "knn_tpu_torch/csrc/probes/"


def _call_name(func: ast.AST) -> str:
    """Render a call target as a dotted name: ``time.time``,
    ``torch.cuda.synchronize``, ``.item`` (unknown receiver),
    ``float``."""
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        parts = [func.attr]
        base = func.value
        while isinstance(base, ast.Attribute):
            parts.append(base.attr)
            base = base.value
        if isinstance(base, ast.Name):
            parts.append(base.id)
            return ".".join(reversed(parts))
        return f".{func.attr}"
    return ""


def _matches(name: str, pattern: str) -> bool:
    if pattern.startswith("."):
        return name.endswith(pattern) or name == pattern.lstrip(".")
    return name == pattern or name.endswith("." + pattern)


def _hot_path_allow(dec: ast.AST) -> Optional[Tuple[str, ...]]:
    """The ``allow`` tuple when ``dec`` is a hot_path decorator (bare
    or called), else None."""
    target = dec.func if isinstance(dec, ast.Call) else dec
    name = _call_name(target)
    if not (name == "hot_path" or name.endswith(".hot_path")):
        return None
    allow: List[str] = []
    if isinstance(dec, ast.Call):
        for kw in dec.keywords:
            if kw.arg == "allow" and isinstance(
                    kw.value, (ast.Tuple, ast.List)):
                allow.extend(
                    e.value for e in kw.value.elts
                    if isinstance(e, ast.Constant)
                    and isinstance(e.value, str))
    return tuple(allow)


def _scan_hot_path(relpath: str, fn: ast.FunctionDef,
                   allow: Sequence[str],
                   findings: List[Finding]) -> None:
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        name = _call_name(node.func)
        if not name:
            continue
        hit = None
        for pat in HOT_FORBIDDEN:
            if _matches(name, pat):
                hit = pat
                break
        if hit is None and name in ("float", "int") and node.args and \
                isinstance(node.args[0], (ast.Call, ast.Subscript)):
            hit = name  # float(x.something()) — likely a device fetch
        if hit is None:
            continue
        if any(_matches(name, a) or a == hit for a in allow):
            continue
        findings.append(Finding(
            checker="torch-hygiene", path=relpath, line=node.lineno,
            symbol=fn.name,
            message=f"host-sync call {name}() inside "
                    f"@hot_path function {fn.name}",
            fix_hint="move it off the dispatch path, or whitelist it "
                     "at the annotation: @hot_path(allow=(...,)) with "
                     "the reason in the surrounding code"))


def _forbidden_root(module: str) -> Optional[str]:
    root = module.split(".", 1)[0]
    return root if root in FORBIDDEN_IMPORTS else None


def _scan_imports(relpath: str, tree: ast.Module,
                  findings: List[Finding]) -> None:
    for node in ast.walk(tree):
        mods: List[str] = []
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        elif isinstance(node, ast.Call) and node.args and \
                _call_name(node.func) in ("importlib.import_module",
                                          "import_module", "__import__") \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            mods = [node.args[0].value]
        for mod in mods:
            root = _forbidden_root(mod)
            if root is None:
                continue
            findings.append(Finding(
                checker="torch-hygiene", path=relpath, line=node.lineno,
                symbol=mod,
                message=f"imports {mod}: the port imports neither jax "
                        f"nor anything of knn_tpu",
                fix_hint="keep the port's own copy of what it needs"))


def _scan_plain_fallbacks(relpath: str, tree: ast.Module,
                          findings: List[Finding]) -> None:
    for node in ast.walk(tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        for stmt in node.body:
            for sub in ast.walk(stmt):
                if not isinstance(sub, ast.Call):
                    continue
                name = _call_name(sub.func)
                if name.rsplit(".", 1)[-1].endswith("_plain"):
                    findings.append(Finding(
                        checker="torch-hygiene", path=relpath,
                        line=sub.lineno, symbol=name.lstrip("."),
                        message=f"calls {name.lstrip('.')}() in an "
                                f"except handler: a fallback from a "
                                f"kernel to its plain version",
                        fix_hint="let the kernel's failure raise; the "
                                 "plain version runs only for CPU "
                                 "tensors"))


@checker("torch-hygiene",
         "wall clocks, hot-path host syncs, jax/knn_tpu imports, "
         "plain-version fallbacks")
def check_torch(ctx: Context) -> List[Finding]:
    findings: List[Finding] = []
    for relpath in ctx.py_files():
        tree = ctx.parse(relpath)
        if tree is None:
            continue
        # 3. the boundary rules hold over the whole tree
        _scan_imports(relpath, tree, findings)
        _scan_plain_fallbacks(relpath, tree, findings)
        posix = relpath.replace("\\", "/")
        if not posix.startswith("knn_tpu_torch/"):
            continue  # chip_smoke.py is a measurement script
        # 1. wall-clock reads
        if not posix.startswith(_PROBES):
            for node in ast.walk(tree):
                if isinstance(node, ast.Call) and \
                        _call_name(node.func) == "time.time":
                    findings.append(Finding(
                        checker="torch-hygiene", path=relpath,
                        line=node.lineno, symbol="time.time",
                        message="wall-clock read time.time() — "
                                "durations must come from "
                                "perf_counter/monotonic",
                        fix_hint="if this is a timestamp that is "
                                 "displayed or compared across "
                                 "processes, suppress with that "
                                 "justification"))
        # 2. hot-path host syncs
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in node.decorator_list:
                    allow = _hot_path_allow(dec)
                    if allow is not None:
                        _scan_hot_path(relpath, node, allow, findings)
                        break
    return findings
