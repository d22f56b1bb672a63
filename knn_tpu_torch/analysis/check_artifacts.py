"""``artifact-lockstep`` — the artifact pipeline in lockstep with its
schema catalog (:mod:`knn_tpu_torch.analysis.artifacts`); the port's
copy of knn_tpu/analysis/check_artifacts.py.

Six invariants over the catalog:

1. **emitter keys resolve** — every string key an emitter writes into a
   cataloged block literal (a dict literal matching one of the
   schema's fingerprints, in one of its declared emitter files)
   resolves in that schema.  An emitted-but-undeclared key is invisible
   to the validator, the refresher, and the sentinel — half-wired by
   construction;
2. **schema fields are emitted** — every declared field's leaf name
   appears in at least one emitter file, or carries a written
   ``emit_note`` justification (>= 10 chars, the suppression
   discipline).  The catalog can't rot into fiction;
3. **refresher hoist lockstep** —
   ``knn_tpu_torch/scripts/refresh_bench_artifacts.py`` either speaks the
   catalog (imports ``analysis.artifacts`` /
   calls ``curate_line``) — in which case every declared hoist is
   performed by construction — or names every refresher-scope hoist
   key literally.  A hand-rolled refresher that drops a declared hoist
   goes red;
4. **sentinel curated lockstep** — ``knn_tpu_torch/obs/sentinel.py`` derives
   ``CURATED_FIELDS`` from ``artifacts.curated_fields()`` (the hand
   list can't come back), or at minimum names every curated field;
5. **version tokens** — every declared version token resolves to an
   int constant and is consumed by exactly one schema, whose own field
   list declares it;
6. **docs anchors** — every block type's ``doc`` anchor names a real
   heading in a real doc file (in README.md, a heading of its port
   section), and every hoist destination / curated field is a declared
   ``bench_line`` key (hoists land on cataloged ground).

Checks 1–4 and 6 only run against files that exist under the lint root
(fixture trees stay green); check 5 judges the catalog itself.  In this
checkout the refresher and ``obs/sentinel.py`` exist, so checks 3 and 4
judge them on every lint.  The catalog is read from the lint ROOT's copy
when present (``Context.load_module``) so ``--root`` judges another
checkout against ITS declarations.
"""

from __future__ import annotations

import ast
import os
from typing import List, Set

from knn_tpu_torch.analysis import artifacts as _imported_artifacts
from knn_tpu_torch.analysis.check_switches import section_lines
from knn_tpu_torch.analysis.core import Context, Finding, checker

_CATALOG_REL = os.path.join("knn_tpu_torch", "analysis", "artifacts.py")
_REFRESHER_REL = os.path.join("knn_tpu_torch", "scripts",
                              "refresh_bench_artifacts.py")
_SENTINEL_REL = os.path.join("knn_tpu_torch", "obs", "sentinel.py")

#: the README's port section: the only part of README.md whose headings
#: anchor the port's block types
_README_PORT = ("README.md", "## PyTorch/CUDA port")


def _string_constants(tree: ast.Module) -> Set[str]:
    return {node.value for node in ast.walk(tree)
            if isinstance(node, ast.Constant)
            and isinstance(node.value, str)}


def _dict_literals(tree: ast.Module):
    """(node, string-key set) for every dict literal with at least one
    string key (``**``-unpacked entries have no key and are skipped —
    their contents are separate literals of their own)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            keys = {k.value for k in node.keys
                    if isinstance(k, ast.Constant)
                    and isinstance(k.value, str)}
            if keys:
                yield node, keys


def _calls_name(tree: ast.Module, name: str) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            fn = node.func
            if (getattr(fn, "id", None) or
                    getattr(fn, "attr", None)) == name:
                return True
    return False


def _imports_artifacts(tree: ast.Module) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if mod.endswith("analysis.artifacts") or (
                    mod.endswith("analysis")
                    and any(a.name == "artifacts"
                            for a in node.names)):
                return True
        if isinstance(node, ast.Import):
            if any(a.name.endswith("analysis.artifacts")
                   for a in node.names):
                return True
    return False


@checker("artifact-lockstep",
         "artifact-schema catalog <-> emitters <-> refresher hoists "
         "<-> sentinel curated fields <-> docs")
def check_artifacts(ctx: Context) -> List[Finding]:
    arts = ctx.load_module(_CATALOG_REL, _imported_artifacts)
    findings: List[Finding] = []

    def err(path: str, msg: str, symbol: str = "",
            fix: str = "") -> None:
        findings.append(Finding(
            checker="artifact-lockstep", path=path, line=0,
            message=msg, symbol=symbol, fix_hint=fix))

    # --- 5. version tokens: unique, resolvable, self-declared ----------
    seen_versions = {}
    for schema in arts.CATALOG:
        if not schema.version_field:
            continue
        owner = seen_versions.setdefault(schema.version_field,
                                         schema.name)
        if owner != schema.name:
            err(_CATALOG_REL,
                f"version token {schema.version_field!r} is consumed "
                f"by two validators ({owner} and {schema.name}) — "
                f"every version token must belong to exactly one "
                f"block schema", schema.version_field)
        try:
            v = arts.version_value(schema.name)
        except Exception as e:  # noqa: BLE001 — unresolvable = finding
            err(_CATALOG_REL,
                f"schema {schema.name}: version_ref "
                f"{schema.version_ref!r} does not resolve: "
                f"{type(e).__name__}: {e}", schema.name)
            continue
        if not isinstance(v, int):
            err(_CATALOG_REL,
                f"schema {schema.name}: version_ref resolves to "
                f"{v!r}, not an int version token", schema.name)
        if schema.version_field not in {f.path for f
                                        in schema.fields}:
            err(_CATALOG_REL,
                f"schema {schema.name}: version field "
                f"{schema.version_field!r} is not among its own "
                f"declared fields", schema.name)

    # --- 1. emitter block literals resolve in their schemas ------------
    emitter_files = sorted({rel for s in arts.CATALOG
                            for rel in s.emitters})
    strings_of = {}
    for rel in emitter_files:
        if not ctx.exists(rel):
            continue
        tree = ctx.parse(rel)
        if tree is None:
            continue  # the framework already reported the parse error
        strings_of[rel] = _string_constants(tree)
        for node, keys in _dict_literals(tree):
            owners = [s for s in arts.CATALOG
                      if rel in s.emitters
                      and any(fp <= keys for fp in s.fingerprints)]
            if not owners:
                continue
            known = set()
            for s in owners:
                known |= arts.known_keys(s.name)
            for key in sorted(keys - known):
                err(rel,
                    f"emitter writes key {key!r} into a "
                    f"{'/'.join(s.name for s in owners)} block "
                    f"literal (line {node.lineno}), but no artifact "
                    f"schema declares it — the validator, refresher, "
                    f"and sentinel are all blind to it", key,
                    fix="declare the field in the block's schema "
                        "entry (knn_tpu_torch/analysis/artifacts.py)")

    # --- 2. every schema field emitted somewhere, or justified ---------
    # judged only when EVERY declared emitter file is present under the
    # lint root — a fixture tree carrying one emitter must not condemn
    # fields the absent emitters own.  Hoist destinations are emitted
    # BY the catalog-driven hoist loops themselves (check 3 proves the
    # refresher runs them), so they count as emitted by construction —
    # without listing the catalog as its own emitter, which would make
    # this check vacuous (every declared field is a string in it).
    hoist_dsts = {h.dst for s in arts.CATALOG for h in s.hoists}
    for schema in arts.CATALOG:
        present = [rel for rel in schema.emitters if rel in strings_of]
        complete = bool(schema.emitters) and \
            len(present) == len(schema.emitters)
        emitted: Set[str] = set()
        for rel in present:
            emitted |= strings_of[rel]
        for f in schema.fields:
            if f.emit_note:
                if len(f.emit_note.strip()) < 10:
                    err(_CATALOG_REL,
                        f"schema {schema.name}: field {f.path!r} "
                        f"suppresses the emitted check without a "
                        f"written justification (>= 10 chars)",
                        f.path)
                continue
            if f.leaf in hoist_dsts:
                continue
            if complete and f.leaf not in emitted:
                err(_CATALOG_REL,
                    f"schema {schema.name}: field {f.path!r} is "
                    f"declared but no emitter "
                    f"({', '.join(schema.emitters)}) ever names it — "
                    f"phantom schema field", f.path,
                    fix="delete the field, or set emit_note with a "
                        "written justification")

    # --- 3. refresher performs every declared refresher hoist ----------
    if ctx.exists(_REFRESHER_REL):
        tree = ctx.parse(_REFRESHER_REL)
        if tree is not None:
            catalog_driven = _imports_artifacts(tree) or \
                _calls_name(tree, "curate_line")
            if not catalog_driven:
                literals = _string_constants(tree)
                for schema in arts.CATALOG:
                    for h in schema.hoists:
                        if h.refresher and h.dst not in literals:
                            err(_REFRESHER_REL,
                                f"declared hoist {h.dst!r} "
                                f"({schema.name}.{h.src}) is not "
                                f"performed by the refresher — the "
                                f"curated line silently loses a "
                                f"sentinel baseline field", h.dst,
                                fix="drive the refresher through "
                                    "artifacts.curate_line (or hoist "
                                    "the key explicitly)")

    # --- 4. sentinel derives (or at least names) the curated fields ----
    if ctx.exists(_SENTINEL_REL):
        tree = ctx.parse(_SENTINEL_REL)
        if tree is not None:
            derived = _calls_name(tree, "curated_fields")
            if not derived:
                literals = _string_constants(tree)
                for fname, _direction in arts.curated_fields():
                    if fname not in literals:
                        err(_SENTINEL_REL,
                            f"curated field {fname!r} is absent from "
                            f"the sentinel — regressions in it are "
                            f"never baselined", fname,
                            fix="derive CURATED_FIELDS from "
                                "knn_tpu_torch.analysis.artifacts."
                                "curated_fields()")

    # --- 6. docs anchors + hoists/curated land on cataloged keys -------
    bench_known = (arts.known_keys("bench_line")
                   if "bench_line" in arts.BY_NAME else None)
    for schema in arts.CATALOG:
        doc_file, anchor = schema.doc.split("#", 1)
        if ctx.exists(doc_file):
            text = ctx.read(doc_file)
            lines = (section_lines(text, _README_PORT[1])
                     if doc_file == _README_PORT[0]
                     else list(enumerate(text.splitlines(), 1)))
            heading_hit = any(
                line.lstrip().startswith("#")
                and anchor.lower() in line.lower()
                for _i, line in lines)
            if not heading_hit:
                err(doc_file,
                    f"schema {schema.name}: docs anchor "
                    f"{schema.doc!r} names no heading in {doc_file} — "
                    f"every block type must keep its documentation "
                    f"anchor", schema.name)
        if bench_known is None:
            continue
        for h in schema.hoists:
            if h.dst not in bench_known:
                err(_CATALOG_REL,
                    f"schema {schema.name}: hoist destination "
                    f"{h.dst!r} is not a declared bench_line key — "
                    f"hoists must land on cataloged ground", h.dst)
        for c in schema.curated:
            if c.field not in bench_known:
                err(_CATALOG_REL,
                    f"schema {schema.name}: curated field "
                    f"{c.field!r} is not a declared bench_line key",
                    c.field)
    return findings
