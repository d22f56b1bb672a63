"""The static-analysis framework: checker registry, findings,
justification-required suppressions, and reporters — the port's copy of
knn_tpu/analysis/core.py, with the same semantics over the port's tree.

The port's ground rules (no ``jax``, no ``knn_tpu``, no environment
switch, no fallback from a kernel to its plain version, thread-safe
classes that mutate only under their lock, metric names in lockstep with
the catalog, bench blocks in lockstep with their schemas) are each ONE
registered checker here instead of a rule that only review checks.

Everything here is stdlib-only (``ast`` + ``json``): ``cli lint`` parses
the source it judges and never imports it, so it runs on a machine with
no GPU and no JAX and creates no CUDA context.

Vocabulary:

- **Finding** — one violation: checker name, repo-relative path, line,
  message, severity (``error``/``warning`` — both fail the lint; the
  severity only ranks the report), optional symbol and fix hint.
- **Checker** — a registered function ``(Context) -> list[Finding]``.
  Register with :func:`checker`; the registry is what ``cli lint``
  enumerates.
- **Suppression** — one entry in the suppression file
  (``knn_tpu_torch/analysis/suppressions.json``) matching findings by
  (checker, path, substring).  Every entry MUST carry a written
  justification, and an entry that matches nothing is itself a finding
  (``stale suppression``) — the baseline stays zero-unexplained in both
  directions.  The grammar: :func:`load_suppressions`.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import sys
from typing import Callable, Dict, List, Optional, Sequence, Tuple

#: severities, report-rank order (both flip the exit code — a warning
#: is a finding with a softer headline, not a free pass)
SEVERITIES = ("error", "warning")

#: the source tree one lint pass covers, relative to the repo root: the
#: port's package and its one root script.  tests/ is deliberately
#: absent: negative tests seed bad names and switch tokens on purpose.
SOURCE_ROOTS = ("knn_tpu_torch", "chip_smoke.py")

#: default suppression-file location, relative to the repo root
SUPPRESSIONS_PATH = os.path.join("knn_tpu_torch", "analysis",
                                 "suppressions.json")


@dataclasses.dataclass
class Finding:
    """One violation a checker reports."""

    checker: str
    path: str
    line: int
    message: str
    severity: str = "error"
    symbol: str = ""
    fix_hint: str = ""

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        sym = f" [{self.symbol}]" if self.symbol else ""
        hint = f"\n      fix: {self.fix_hint}" if self.fix_hint else ""
        return (f"  {self.severity.upper():7s} {self.checker}: {loc}{sym}\n"
                f"      {self.message}{hint}")


class Context:
    """What every checker sees: the repo root plus cached source/AST
    access.  Checkers never import the CODE they inspect — parsing
    keeps the lint torch-free and side-effect-free by construction.  The
    one sanctioned exception is :meth:`load_module`: the declaration
    CATALOGS (the switch and metric name tables) are data, and the
    lockstep checkers read the lint root's own copy of them so
    ``--root`` judges another checkout against ITS catalog, not the
    imported package's."""

    def __init__(self, root: str,
                 source_roots: Sequence[str] = SOURCE_ROOTS):
        self.root = os.path.abspath(root)
        self.source_roots = tuple(source_roots)
        self._text: Dict[str, str] = {}
        self._ast: Dict[str, ast.Module] = {}
        self._mods: Dict[str, object] = {}

    def load_module(self, relpath: str, fallback):
        """The lint root's copy of a stdlib-only DECLARATION module
        (``analysis/switches.py``, ``obs/names.py``), executed from
        ``<root>/<relpath>`` when that file exists and is not the
        imported package's own copy; ``fallback`` (the imported module)
        otherwise — small fixture trees carry no catalog and lint
        against the imported package's.  A root catalog that fails to
        execute propagates: the caller's checker goes red with a
        ``checker crashed`` finding, never silently green."""
        if relpath in self._mods:
            return self._mods[relpath]
        import importlib.util

        mod = fallback
        full = os.path.join(self.root, relpath)
        own = getattr(fallback, "__file__", None)
        if os.path.exists(full) and not (
                own and os.path.exists(own)
                and os.path.samefile(full, own)):
            spec = importlib.util.spec_from_file_location(
                f"_knn_torch_lint_root_{os.path.basename(relpath)[:-3]}", full)
            mod = importlib.util.module_from_spec(spec)
            # registered while it runs: a dataclass in the catalog looks
            # its module up by name
            sys.modules[spec.name] = mod
            try:
                spec.loader.exec_module(mod)
            finally:
                sys.modules.pop(spec.name, None)
        self._mods[relpath] = mod
        return mod

    def exists(self, relpath: str) -> bool:
        return os.path.exists(os.path.join(self.root, relpath))

    def py_files(self) -> List[str]:
        """Every .py file under the context's source roots, sorted,
        repo-relative, ``__pycache__`` excluded."""
        out: List[str] = []
        for entry in self.source_roots:
            full = os.path.join(self.root, entry)
            if os.path.isfile(full):
                if entry.endswith(".py"):
                    out.append(entry)
                continue
            for dirpath, _dirs, files in os.walk(full):
                if "__pycache__" in dirpath:
                    continue
                for fn in files:
                    if fn.endswith(".py"):
                        out.append(os.path.relpath(
                            os.path.join(dirpath, fn), self.root))
        return sorted(out)

    def read(self, relpath: str) -> str:
        if relpath not in self._text:
            with open(os.path.join(self.root, relpath),
                      encoding="utf-8") as f:
                self._text[relpath] = f.read()
        return self._text[relpath]

    def parse(self, relpath: str) -> Optional[ast.Module]:
        """The file's AST, or None when it doesn't parse (the caller
        gets a syntax-error finding from :func:`run` instead)."""
        if relpath not in self._ast:
            try:
                self._ast[relpath] = ast.parse(self.read(relpath),
                                               filename=relpath)
            except SyntaxError:
                self._ast[relpath] = None
        return self._ast[relpath]


#: name -> (function, one-line description); the registry ``cli lint``
#: enumerates.  Ordered by registration, which is import order of the
#: checker modules (knn_tpu_torch.analysis.__init__ imports them
#: explicitly).
CHECKERS: Dict[str, Tuple[Callable[[Context], List[Finding]], str]] = {}


def checker(name: str, description: str, uses_ast: bool = True):
    """Register a checker.  ``name`` is what ``cli lint --checker`` and
    suppression entries reference; keep it short and kebab-cased.
    ``uses_ast=False`` marks a checker that never reads file ASTs
    (text scans, imported catalogs): a run selecting only such
    checkers skips the whole-tree pre-parse — and its syntax-error
    findings, which would be wrong for a pass no AST checker ran in.
    The default is the conservative True."""

    def wrap(fn):
        if name in CHECKERS:
            raise ValueError(f"duplicate checker name {name!r}")
        CHECKERS[name] = (fn, description)
        fn.checker_name = name
        fn.uses_ast = uses_ast
        return fn

    return wrap


@dataclasses.dataclass
class Suppression:
    checker: str
    path: str
    contains: str
    justification: str
    #: set during apply — a never-matching entry is a stale-suppression
    #: finding, so the file can only shrink toward truth
    used: bool = False

    def matches(self, f: Finding) -> bool:
        if self.checker and self.checker != f.checker:
            return False
        if self.path and self.path != f.path:
            return False
        if self.contains and (self.contains not in f.message
                              and self.contains != f.symbol):
            return False
        return True


_SUPPRESSION_KEYS = {"checker", "path", "contains", "justification"}


def load_suppressions(
        path: str) -> Tuple[List[Suppression], List[Finding]]:
    """Parse the suppression file.  Malformed entries — unknown keys,
    a missing/empty justification, non-list top level — come back as
    findings, not exceptions: a broken suppression file must fail the
    lint loudly, never silently widen it."""
    sups: List[Suppression] = []
    errors: List[Finding] = []
    rel = os.path.basename(path)

    def err(msg: str) -> None:
        errors.append(Finding(
            checker="suppressions", path=rel, line=0, message=msg,
            fix_hint="see knn_tpu_torch/analysis/core.py "
                     "load_suppressions"))

    if not os.path.exists(path):
        return sups, errors
    try:
        with open(path, encoding="utf-8") as f:
            payload = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        err(f"cannot parse suppression file: {e}")
        return sups, errors
    entries = payload.get("suppressions") if isinstance(payload, dict) \
        else None
    if not isinstance(entries, list):
        err("top level must be {\"suppressions\": [...]}")
        return sups, errors
    for i, entry in enumerate(entries):
        if not isinstance(entry, dict):
            err(f"entry {i} is not an object")
            continue
        unknown = set(entry) - _SUPPRESSION_KEYS
        if unknown:
            err(f"entry {i} has unknown keys {sorted(unknown)}")
            continue
        just = str(entry.get("justification") or "").strip()
        if len(just) < 10:
            err(f"entry {i} ({entry.get('checker')!r} / "
                f"{entry.get('path')!r}) lacks a written justification "
                f"(>= 10 chars) — every suppression must say WHY the "
                f"finding is acceptable")
            continue
        if not (entry.get("checker") or "").strip():
            err(f"entry {i} must name the checker it suppresses")
            continue
        sups.append(Suppression(
            checker=str(entry.get("checker") or ""),
            path=str(entry.get("path") or ""),
            contains=str(entry.get("contains") or ""),
            justification=just))
    return sups, errors


@dataclasses.dataclass
class Report:
    findings: List[Finding]
    suppressed: int
    checkers_run: List[str]
    root: str

    @property
    def ok(self) -> bool:
        return not self.findings

    def as_dict(self) -> dict:
        counts: Dict[str, int] = {}
        for f in self.findings:
            counts[f.checker] = counts.get(f.checker, 0) + 1
        return {
            "ok": self.ok,
            "checkers": self.checkers_run,
            "findings": [f.as_dict() for f in self.findings],
            "counts_by_checker": counts,
            "suppressed": self.suppressed,
        }

    def render_text(self) -> str:
        lines = []
        if self.findings:
            lines.append(f"cli lint: {len(self.findings)} finding(s) "
                         f"({self.suppressed} suppressed)")
            order = {s: i for i, s in enumerate(SEVERITIES)}
            for f in sorted(self.findings,
                            key=lambda f: (order.get(f.severity, 9),
                                           f.checker, f.path, f.line)):
                lines.append(f.render())
        else:
            lines.append(
                f"cli lint: OK ({len(self.checkers_run)} checkers, "
                f"{self.suppressed} suppressed finding(s), each with a "
                f"written justification)")
        return "\n".join(lines) + "\n"


def run(root: str, names: Optional[Sequence[str]] = None,
        suppressions_path: Optional[str] = None) -> Report:
    """One lint pass: run the selected checkers over ``root``, apply the
    suppression file, report stale suppressions.  Checker exceptions
    become findings (an analysis crash must fail the gate, not pass
    it)."""
    ctx = Context(root)
    selected = list(CHECKERS) if names is None else list(names)
    unknown = [n for n in selected if n not in CHECKERS]
    if unknown:
        raise ValueError(f"unknown checker(s) {unknown}; "
                         f"registered: {sorted(CHECKERS)}")
    findings: List[Finding] = []
    # a file that doesn't parse breaks every AST checker identically;
    # report it once, up front — but only when an AST checker is
    # actually selected (a metric-lockstep-only pass keeps the text
    # lint's tolerance of unparseable files and skips the whole-tree
    # parse)
    if any(getattr(CHECKERS[n][0], "uses_ast", True) for n in selected):
        for relpath in ctx.py_files():
            if ctx.parse(relpath) is None:
                findings.append(Finding(
                    checker="framework", path=relpath, line=0,
                    message="file does not parse; every AST checker "
                            "skipped it"))
    for name in selected:
        fn, _desc = CHECKERS[name]
        try:
            findings.extend(fn(ctx))
        except Exception as e:  # noqa: BLE001 — crash = red, not green
            findings.append(Finding(
                checker=name, path="", line=0,
                message=f"checker crashed: {type(e).__name__}: {e}"))
    sup_path = suppressions_path if suppressions_path is not None else \
        os.path.join(ctx.root, SUPPRESSIONS_PATH)
    sups, sup_errors = load_suppressions(sup_path)
    findings.extend(sup_errors)
    kept: List[Finding] = []
    suppressed = 0
    for f in findings:
        match = next((s for s in sups if s.matches(f)), None)
        if match is not None and f.checker != "suppressions":
            match.used = True
            suppressed += 1
        else:
            kept.append(f)
    for s in sups:
        # staleness is only judged for checkers that actually ran this
        # pass (a metric-lockstep-only run must not condemn the
        # torch-hygiene suppressions) — except an entry naming a checker
        # that doesn't exist at all, which is stale in every pass
        if not s.used and (s.checker in selected
                           or s.checker not in CHECKERS):
            kept.append(Finding(
                checker="suppressions",
                path=os.path.relpath(sup_path, ctx.root),
                line=0,
                message=f"stale suppression (checker={s.checker!r}, "
                        f"path={s.path!r}, contains={s.contains!r}) "
                        f"matches no current finding — delete it",
                fix_hint="a suppression that outlives its finding hides "
                         "the next regression behind it"))
    return Report(findings=kept, suppressed=suppressed,
                  checkers_run=selected, root=ctx.root)
