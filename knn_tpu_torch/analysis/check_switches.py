"""``switch-lockstep`` — the port reads no environment switch, and says
which argument stands in for each of the JAX package's (the port's
recast of knn_tpu/analysis/check_switches.py, with its AST scan).

Four invariants over the catalog (knn_tpu_torch.analysis.switches):

1. a ``KNN_TPU_*``/``KNN_BENCH_*`` string literal in port CODE (not a
   docstring) is a finding: the port reads no switch, so such a string
   either reads one or tells an operator to set one the port ignores;
2. a switch-shaped token in a port docstring is a cataloged row (or a
   declared family prefix): it names the JAX switch that an argument
   replaces;
3. every catalog row names its ``port`` counterpart — the argument, or
   ``not ported:`` and why;
4. the README's port section (from ``## PyTorch/CUDA port`` to the next
   ``## `` heading), the verify skill's port section
   (``.claude/skills/verify/SKILL.md``, from ``## The PyTorch/CUDA
   port`` to the next ``## `` heading) and ``PERF.md`` hold no switch
   token.

Invariant 4 judges only the files that exist under the lint root, so the
checker also works over small fixture trees.  The catalog is read from
the lint ROOT's ``knn_tpu_torch/analysis/switches.py`` when present
(``--root`` on another checkout judges that tree against ITS
declarations); fixture trees without a catalog lint against the
imported package's.
"""

from __future__ import annotations

import ast
import os
from typing import List, Optional, Set, Tuple

from knn_tpu_torch.analysis import switches as _imported_sw
from knn_tpu_torch.analysis.core import Context, Finding, checker

#: the catalog module itself holds every declaration as a literal
_CATALOG_REL = os.path.join("knn_tpu_torch", "analysis", "switches.py")
_SKIP = {_CATALOG_REL}

#: (doc file, heading that opens its port section or None for the whole
#: file) — the documents that describe the port and must name no switch
PORT_DOCS: Tuple[Tuple[str, Optional[str]], ...] = (
    ("README.md", "## PyTorch/CUDA port"),
    (os.path.join(".claude", "skills", "verify", "SKILL.md"),
     "## The PyTorch/CUDA port"),
    ("PERF.md", None),
)


def _docstring_consts(tree: ast.Module) -> Set[int]:
    """``id()`` of every Constant node sitting in docstring position
    (first statement of a module/class/function body)."""
    out: Set[int] = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and \
                    isinstance(body[0].value, ast.Constant) and \
                    isinstance(body[0].value.value, str):
                out.add(id(body[0].value))
    return out


def _source_literals(ctx: Context, sw):
    """(relpath, line, token, is_docstring) for every switch-shaped
    string constant in the source tree (AST-based: comments can't trip
    it, but docstrings can)."""
    for relpath in ctx.py_files():
        if relpath in _SKIP:
            continue
        tree = ctx.parse(relpath)
        if tree is None:
            continue
        doc_ids = _docstring_consts(tree)
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and \
                    isinstance(node.value, str):
                for token in sw.tokens_in_source(node.value):
                    yield relpath, node.lineno, token, \
                        id(node) in doc_ids


def section_lines(text: str, heading: Optional[str]):
    """(line number, line) of the section opened by the line starting
    with ``heading`` and closed by the next ``## `` heading (the whole
    text when ``heading`` is None)."""
    lines = text.splitlines()
    if heading is None:
        return list(enumerate(lines, 1))
    out = []
    inside = False
    for i, line in enumerate(lines, 1):
        if line.startswith(heading):
            inside = True
            continue
        if inside and line.startswith("## "):
            break
        if inside:
            out.append((i, line))
    return out


@checker("switch-lockstep",
         "no env switch in port code or port docs; every JAX switch "
         "cataloged with its port argument")
def check_switches(ctx: Context) -> List[Finding]:
    sw = ctx.load_module(_CATALOG_REL, _imported_sw)
    findings: List[Finding] = []

    # 1 + 2: code literals are findings; docstring tokens are cataloged
    for relpath, line, token, is_doc in _source_literals(ctx, sw):
        if not is_doc:
            row = sw.lookup(token)
            findings.append(Finding(
                checker="switch-lockstep", path=relpath, line=line,
                symbol=token,
                message=f"code literal {token!r}: the port reads no "
                        f"environment switch"
                        + (f" (its argument: {row.port})"
                           if row is not None else ""),
                fix_hint="take the knob as an argument, and name the "
                         "argument in any message to the operator"))
        elif sw.lookup(token) is None:
            kind = ("family prefix" if token.endswith("_")
                    else "switch")
            findings.append(Finding(
                checker="switch-lockstep", path=relpath, line=line,
                symbol=token,
                message=f"docstring names {kind} {token!r}, which is "
                        f"not in the switch catalog "
                        f"(knn_tpu_torch/analysis/switches.py)",
                fix_hint="name a cataloged JAX switch, or the port's "
                         "argument"))

    # 3. every row names its port counterpart
    for s in sw.SWITCHES:
        if len((s.port or "").strip()) < 10:
            findings.append(Finding(
                checker="switch-lockstep", path=_CATALOG_REL, line=0,
                symbol=s.name,
                message=f"catalog row {s.name} names no port "
                        f"counterpart (the argument that stands in for "
                        f"it, or 'not ported:' and why)"))

    # 4. the port's documents hold no switch token
    for rel, heading in PORT_DOCS:
        if not ctx.exists(rel):
            continue
        for i, line in section_lines(ctx.read(rel), heading):
            for token in sw.tokens_in_source(line):
                findings.append(Finding(
                    checker="switch-lockstep", path=rel, line=i,
                    symbol=token,
                    message=f"the port's documentation names switch "
                            f"{token}: the port reads no switch",
                    fix_hint="name the argument that stands in for it"))
    return findings
