"""``metric-lockstep`` — the metric catalog in lockstep with the
registry's grammar, the docs, the source and the names the port never
writes (the port's copy of knn_tpu/analysis/check_metrics.py).

The JAX package's three invariants, over
``knn_tpu_torch.obs.names.CATALOG``:

1. every catalog name matches ``knn_tpu_[a-z0-9_]+`` (the registry's
   ``NAME_RE``);
2. every catalog name appears in the docs/OBSERVABILITY.md catalog
   table — the port's catalog holds the JAX catalog's names one for one,
   with an equal ``catalog_version``, so the JAX package's table
   documents both (reading a doc imports nothing);
3. every metric-shaped literal in source is a catalog name, and every
   doc mention resolves to a catalog name modulo the Prometheus summary
   suffixes ``_sum``/``_count``.  The package's own name
   (``knn_tpu_torch``, in import paths and cache directories) is not a
   metric token.

And one of the port's own:

4. ``names.UNWRITTEN`` is exactly the set of catalog names no port code
   writes — none of its code literals (docstrings excluded) and none of
   its references to the name's catalog constant (``mn.SERVING_ERRORS``)
   outside names.py.  Judged only when the lint root carries its own
   names.py (a fixture tree with a lone module names no package).

The scan of invariant 3 is text-based (not AST) on purpose, preserving
the original lint's semantics: a phantom metric in a comment or
docstring misleads exactly like one in code.
"""

from __future__ import annotations

import ast
import os
import re
from typing import List, Set

from knn_tpu_torch.analysis.core import Context, Finding, checker

TOKEN = re.compile(r"\bknn_tpu_[a-z0-9_]+\b")
#: Prometheus renders histogram series with these suffixes; the doc may
#: (and does) show them in examples
SUFFIXES = ("_sum", "_count")

DOC = os.path.join("docs", "OBSERVABILITY.md")

_NAMES_REL = os.path.join("knn_tpu_torch", "obs", "names.py")

#: the catalog itself
_SKIP = {_NAMES_REL}

#: the package's own name, which the metric token's shape also matches
_PACKAGE = "knn_tpu_torch"


def _base(token: str, catalog) -> str:
    for suf in SUFFIXES:
        if token.endswith(suf) and token[: -len(suf)] in catalog:
            return token[: -len(suf)]
    return token


def _docstring_ids(tree: ast.Module) -> Set[int]:
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


def written_names(ctx: Context, names_mod) -> Set[str]:
    """The catalog names the port's code writes: code string literals
    (docstrings excluded) holding the name, and references to its
    catalog constant (``Attribute`` or ``Name``) outside names.py."""
    catalog = names_mod.CATALOG
    const_of = {attr: val for attr, val in vars(names_mod).items()
                if attr.isupper() and isinstance(val, str)
                and val in catalog}
    out: Set[str] = set()
    for relpath in ctx.py_files():
        if relpath in _SKIP:
            continue
        tree = ctx.parse(relpath)
        if tree is None:
            continue
        docs = _docstring_ids(tree)
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute) and node.attr in const_of:
                out.add(const_of[node.attr])
            elif isinstance(node, ast.Name) and node.id in const_of:
                out.add(const_of[node.id])
            elif isinstance(node, ast.alias) and node.name in const_of:
                out.add(const_of[node.name])
            elif isinstance(node, ast.Constant) and \
                    isinstance(node.value, str) and id(node) not in docs:
                for token in TOKEN.findall(node.value):
                    base = _base(token, catalog)
                    if base in catalog:
                        out.add(base)
    return out


@checker("metric-lockstep",
         "metric catalog <-> registry regex <-> docs <-> source literals "
         "<-> names.UNWRITTEN",
         uses_ast=False)
def check_metrics(ctx: Context) -> List[Finding]:
    from knn_tpu_torch.obs import names as _imported_names
    from knn_tpu_torch.obs.registry import NAME_RE

    # the lint root's own catalog when it carries one (see
    # Context.load_module); the name GRAMMAR (NAME_RE) is the
    # framework's own contract and stays the imported package's
    names_mod = ctx.load_module(_NAMES_REL, _imported_names)
    CATALOG = names_mod.CATALOG

    findings: List[Finding] = []

    def err(path: str, line: int, msg: str, symbol: str = "") -> None:
        findings.append(Finding(checker="metric-lockstep", path=path,
                                line=line, message=msg, symbol=symbol))

    # 1. catalog names are well-formed
    for name in CATALOG:
        if not NAME_RE.match(name):
            err(_NAMES_REL, 0,
                f"catalog name {name!r} does not match "
                f"{NAME_RE.pattern}", name)

    # 2. every catalog name is documented
    doc_tokens = set()
    if ctx.exists(DOC):
        doc_text = ctx.read(DOC)
        doc_tokens = set(TOKEN.findall(doc_text)) - {_PACKAGE}
        for name in CATALOG:
            if name not in doc_tokens:
                err(DOC, 0,
                    f"{name} is registrable but missing from "
                    f"docs/OBSERVABILITY.md", name)
        # 3a. doc tokens resolve to catalog names (no phantom metrics)
        for token in sorted(doc_tokens):
            if _base(token, CATALOG) not in CATALOG:
                err(DOC, 0,
                    f"docs/OBSERVABILITY.md mentions {token}, which is "
                    f"not a catalog metric", token)

    # 3b. source literals resolve to catalog names (no catalog bypass).
    # tokens ending in "_" are prefixes (docstring brace shorthand,
    # tempdir prefixes), not metric names — a real metric never ends in
    # underscore.
    for relpath in ctx.py_files():
        if relpath in _SKIP:
            continue
        for i, line in enumerate(ctx.read(relpath).splitlines(), 1):
            for token in TOKEN.findall(line):
                if token.endswith("_") or token == _PACKAGE:
                    continue
                if _base(token, CATALOG) not in CATALOG:
                    err(relpath, i,
                        f"literal {token} is not a catalog metric "
                        f"(declare it in knn_tpu_torch/obs/names.py, "
                        f"with docs, before instrumenting)", token)

    # 4. UNWRITTEN is exactly the catalog names no port code writes
    if ctx.exists(_NAMES_REL):
        unwritten = set(getattr(names_mod, "UNWRITTEN", ()))
        written = written_names(ctx, names_mod)
        for name in sorted(unwritten - set(CATALOG)):
            err(_NAMES_REL, 0,
                f"names.UNWRITTEN lists {name}, which is not a catalog "
                f"metric", name)
        for name in sorted(unwritten & written):
            err(_NAMES_REL, 0,
                f"{name} is in names.UNWRITTEN but port code writes it "
                f"— take it out of UNWRITTEN", name)
        for name in sorted(set(CATALOG) - unwritten - written):
            err(_NAMES_REL, 0,
                f"no port code writes {name} — list it in "
                f"names.UNWRITTEN, or write it", name)
    return findings
