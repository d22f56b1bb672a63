"""``locked-mutation`` — thread-safe classes mutate shared state only
under their declared lock (the port's copy of
knn_tpu/analysis/check_concurrency.py: the same rules and grammar).

The serving/obs stack is crossed by worker threads (queue batcher +
completer, HTTP handlers, SLO evaluators) and its classes promise
thread-safety in prose.  Until this checker, the promise was enforced
by review discipline alone — one unlocked ``self._x = ...`` in a new
method is a data race no test reliably catches.  Now the promise is a
machine-readable annotation (knn_tpu_torch.analysis.annotations):

- a class opts in with ``Thread-safety: guarded by ``self._lock``.``
  in its docstring (any attribute name — ``QueryQueue`` declares its
  ``Condition`` ``self._cond``);
- the checker collects the class's shared attributes (every
  ``self.x``/``self._x`` assigned in ``__init__``, minus the lock
  itself) and flags assignments to them — plain, augmented, tuple
  targets, ``self.attr[k] = ...`` subscripts, ``del``, ``for self.x
  in ...:`` loop targets, ``with ... as self.x:`` bindings, and
  comprehension targets — in any other method outside a ``with
  self.<lock>:`` block;
- a helper that REQUIRES the lock held declares it with ``Caller
  holds ``self._lock``.`` in its own docstring (e.g. the registry
  histogram's exemplar note, the SLO engine's transition bookkeeping)
  — the contract is then visible to both the reader and the tool.

Reads are deliberately out of scope (many are benign-by-GIL and the
classes' stats() methods document their snapshot semantics); the
checker targets the mutation races that corrupt state.  The runtime
complement is knn_tpu_torch.analysis.lockorder: instrumented locks
recording acquisition order across the 8-thread hammers (the tests on
the CPU, ``chip_smoke.py`` on the card's CUDA-graph serving stack),
asserting the order graph stays acyclic (deadlock detection).
"""

from __future__ import annotations

import ast
import re
from typing import List, Optional, Set

from knn_tpu_torch.analysis.core import Context, Finding, checker

#: class docstring opt-in: names the lock attribute.  The scan runs to
#: the end of the marker's PARAGRAPH (a blank line), not its line — a
#: routine docstring reflow that wraps "guarded by ``self._lock``" onto
#: the next line must not silently disarm the checker.
MARKER_RE = re.compile(
    r"Thread-safety:(?:(?!\n\s*\n)[\s\S])*?``self\.(?P<attr>_?\w+)``")
#: the opt-in phrase alone: present without a parseable lock name, the
#: class gets a finding instead of silently falling out of scope
MARKER_PHRASE = "Thread-safety:"
#: method docstring opt-out: the lock is already held by every caller
#: (same paragraph-bounded scan; an unparseable marker here just means
#: the method is scanned normally — the safe direction)
HELD_RE = re.compile(
    r"Caller holds(?:(?!\n\s*\n)[\s\S])*?``self\.(?P<attr>_?\w+)``")


def _self_attr(node: ast.AST) -> Optional[str]:
    """The ``X`` of a plain ``self.X`` expression, else None."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _mutated_attrs(target: ast.AST) -> Set[str]:
    """Shared-attr names a single assignment target writes: ``self.x``,
    ``self.x[k]`` (container mutation through the attr), and tuple /
    list destructuring thereof."""
    out: Set[str] = set()
    if isinstance(target, (ast.Tuple, ast.List)):
        for elt in target.elts:
            out |= _mutated_attrs(elt)
        return out
    attr = _self_attr(target)
    if attr is not None:
        out.add(attr)
        return out
    if isinstance(target, ast.Subscript):
        attr = _self_attr(target.value)
        if attr is not None:
            out.add(attr)
    return out


def _init_attrs(cls: ast.ClassDef) -> Set[str]:
    out: Set[str] = set()
    for node in cls.body:
        if isinstance(node, ast.FunctionDef) and node.name == "__init__":
            for stmt in ast.walk(node):
                if isinstance(stmt, (ast.Assign, ast.AnnAssign,
                                     ast.AugAssign)):
                    targets = stmt.targets if isinstance(
                        stmt, ast.Assign) else [stmt.target]
                    for t in targets:
                        a = _self_attr(t)
                        if a is not None:
                            out.add(a)
    return out


class _MethodVisitor(ast.NodeVisitor):
    """Walk one method body tracking whether the declared lock is held
    (``with self.<lock>:`` scopes), flagging unlocked writes."""

    def __init__(self, relpath: str, cls: str, method: str,
                 lock_attr: str, shared: Set[str],
                 findings: List[Finding]):
        self.relpath = relpath
        self.cls = cls
        self.method = method
        self.lock_attr = lock_attr
        self.shared = shared
        self.findings = findings
        self.depth = 0  # with-lock nesting

    def _flag(self, node: ast.AST, attrs: Set[str]) -> None:
        if self.depth > 0:
            return
        for attr in sorted(attrs & self.shared):
            if attr == self.lock_attr:
                continue
            self.findings.append(Finding(
                checker="locked-mutation", path=self.relpath,
                line=node.lineno,
                symbol=f"{self.cls}.{self.method}",
                message=f"writes shared attribute self.{attr} outside "
                        f"`with self.{self.lock_attr}:` in a class "
                        f"declared thread-safe",
                fix_hint=f"take self.{self.lock_attr}, or document the "
                         f"single-writer ownership in a suppression "
                         f"entry / `Caller holds` docstring"))

    def _visit_nested_scope(self, node: ast.AST) -> None:
        # a nested def's body runs when it is CALLED, not where it is
        # defined: a callback built under the lock (e.g. handed to
        # fut.add_done_callback) executes later, on another thread,
        # with no lock held — so the enclosing `with self._lock:`
        # never covers it
        saved, self.depth = self.depth, 0
        self.generic_visit(node)
        self.depth = saved

    visit_FunctionDef = _visit_nested_scope
    visit_AsyncFunctionDef = _visit_nested_scope
    visit_Lambda = _visit_nested_scope

    def _visit_with(self, node) -> None:
        holds = any(_self_attr(item.context_expr) == self.lock_attr
                    for item in node.items)
        if holds:
            self.depth += 1
        # `with ... as self._x:` binds AFTER __enter__ returns — a
        # Store-context write like any assignment (judged inside the
        # lock scope when this with IS the lock)
        for item in node.items:
            if item.optional_vars is not None:
                self._flag(node, _mutated_attrs(item.optional_vars))
        for stmt in node.body:
            self.visit(stmt)
        if holds:
            self.depth -= 1

    visit_With = _visit_with
    visit_AsyncWith = _visit_with

    def _visit_for(self, node) -> None:
        # `for self._x in ...:` rebinds the shared attr every iteration
        self._flag(node, _mutated_attrs(node.target))
        self.generic_visit(node)

    visit_For = _visit_for
    visit_AsyncFor = _visit_for

    def visit_comprehension(self, node: ast.comprehension) -> None:
        self._flag(node.iter, _mutated_attrs(node.target))
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._flag(node, _mutated_attrs(t))
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._flag(node, _mutated_attrs(node.target))
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._flag(node, _mutated_attrs(node.target))
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        for t in node.targets:
            self._flag(node, _mutated_attrs(t))
        self.generic_visit(node)


@checker("locked-mutation",
         "thread-safe classes mutate shared attributes under their lock")
def check_concurrency(ctx: Context) -> List[Finding]:
    findings: List[Finding] = []
    for relpath in ctx.py_files():
        tree = ctx.parse(relpath)
        if tree is None:
            continue
        for cls in ast.walk(tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            doc = ast.get_docstring(cls) or ""
            m = MARKER_RE.search(doc)
            if not m:
                if MARKER_PHRASE in doc:
                    findings.append(Finding(
                        checker="locked-mutation", path=relpath,
                        line=cls.lineno, symbol=cls.name,
                        message=f"class docstring says "
                                f"{MARKER_PHRASE!r} but names no lock "
                                f"the checker can parse — the class "
                                f"would silently fall out of "
                                f"locked-mutation scope",
                        fix_hint="write the full marker: Thread-safety:"
                                 " guarded by ``self._lock``. (the lock"
                                 " name may wrap, but must stay in the"
                                 " marker's paragraph)"))
                continue
            lock_attr = m.group("attr")
            shared = _init_attrs(cls) - {lock_attr}
            if not shared:
                findings.append(Finding(
                    checker="locked-mutation", path=relpath,
                    line=cls.lineno, symbol=cls.name,
                    message=f"class declares thread-safety under "
                            f"self.{lock_attr} but __init__ assigns no "
                            f"shared attributes — marker on the wrong "
                            f"class, or a lock that guards nothing"))
                continue
            for node in cls.body:
                if not isinstance(node, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                if node.name in ("__init__", "__new__"):
                    continue  # construction happens-before publication
                mdoc = ast.get_docstring(node) or ""
                held = HELD_RE.search(mdoc)
                if held and held.group("attr") == lock_attr:
                    continue  # every caller holds the lock, by contract
                _MethodVisitor(relpath, cls.name, node.name, lock_attr,
                               shared, findings).visit(node)
    return findings
