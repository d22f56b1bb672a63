"""The artifact-schema registry — ONE declarative catalog for every
bench block the port emits, and the generic engine that validates,
hoists, curates and prints them (the port's copy of
knn_tpu/analysis/artifacts.py).

- :data:`CATALOG` — one :class:`BlockSchema` per artifact block, each
  declaring its fields (types/required/ranges), version token, top-level
  hoist keys, sentinel curated-field direction, emitters + fingerprints
  (for the ``artifact-lockstep`` checker), and docs anchor.  The blocks
  the port shares with the JAX package (``bench_line``, ``calibration``,
  ``campaign``, ``loadgen_knee``, ``mutation``, ``ivf``, ``pq``,
  ``multihost``, ``join``, ``quality``, ``fleet``, ``sentinel``,
  ``multichip_record``) keep the JAX schemas' checks and legacy strings
  byte for byte; where the port's block really differs the schema
  declares the port's (the calibration factors are the H100's five
  terms, ROADMAP divergence 49; the campaign's stage records carry no
  ``grid_level``, divergence 50; a bench line may carry the campaign's
  ``device_trace_qps``, divergence 66).  ``roofline`` and
  ``tuning_cache_entry`` are the port's own blocks (the H100 bound
  classes; the tuner's entry with the Hopper resource gate's record and
  the ``rl<token>`` key);
- :func:`validate` — the generic engine.  ``style="legacy"`` reproduces
  each hand validator's error strings BYTE-IDENTICALLY (the port's
  ``validate_*`` entry points are one-line shims over it);
  ``style="normalized"`` is the engine's one canonical phrasing
  (``missing field: X`` / ``field X must be ..., got ...``);
- :func:`curate_line` / :func:`apply_hoists` / :func:`line_summary` —
  the table-driven validate/refuse/hoist/print loop the refresher
  (``knn_tpu_torch/scripts/refresh_bench_artifacts.py``) runs;
- :func:`curated_fields` — the sentinel's ``CURATED_FIELDS``, derived;
- :func:`sweep_records` / :func:`sweep_multichip` — the
  ``perf_sentinel --lint`` history sweep: every block on every
  checked-in history line and every ``MULTICHIP_r*.json`` record
  validated against the catalog (exact-version schemas exempt blocks
  stamped with a strictly older version token).

Everything here is stdlib-only: the catalog loads where ``cli lint``
runs, with no GPU and no JAX.  Version tokens and choice sets stay in
their owning modules and are referenced lazily through :class:`Ref` —
the catalog declares, it never duplicates.
"""

from __future__ import annotations

import dataclasses
import glob
import importlib
import json
import os
from typing import Dict, List, Optional, Tuple

__all__ = [
    "CATALOG",
    "BY_NAME",
    "BlockSchema",
    "Field",
    "Gate",
    "Rule",
    "Hoist",
    "Curated",
    "Ref",
    "validate",
    "version_value",
    "required_keys",
    "element_required",
    "known_keys",
    "curated_fields",
    "apply_hoists",
    "apply_scope_hoists",
    "curate_line",
    "line_summary",
    "sweep_records",
    "sweep_multichip",
]


# --------------------------------------------------------------------------
# declaration primitives
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Ref:
    """A lazy pointer to a constant in its owning module (the version
    token, a choice tuple).  The catalog references the single source
    of truth instead of copying it — ``MODEL_VERSION`` still lives with
    the model whose bump invalidates caches."""

    module: str
    attr: str


_REF_MEMO: Dict[Tuple[str, str], object] = {}


def _resolve(ref):
    if not isinstance(ref, Ref):
        return ref
    key = (ref.module, ref.attr)
    if key not in _REF_MEMO:
        _REF_MEMO[key] = getattr(importlib.import_module(ref.module),
                                 ref.attr)
    return _REF_MEMO[key]


@dataclasses.dataclass(frozen=True)
class Field:
    """One declared block field.

    ``path`` is dotted into the block; ``kind`` is the value contract
    (``any`` declares the key without constraining it — the lockstep
    checker still tracks it).  ``legacy`` is the byte-identical message
    template of the hand validator this field migrated from
    (placeholders: ``{value!r}``, ``{path}``, ``{leaf}``, ``{vtype}``,
    ``{choices}``, ``{version}``); absent, the normalized phrasing is
    used in both styles.  ``emit_note`` is a written justification
    (>= 10 chars) for a field no emitter writes — the suppression
    discipline of the lint framework.  ``strict`` (the port's own
    blocks) refuses a bool where a number or int is declared, as the
    port's hand validators did; the shared schemas leave it off, so they
    judge what the JAX package's judge."""

    path: str
    kind: str = "any"  # any|int|number|str|bool|dict|list|version|nested
    required: bool = False
    nullable: bool = False
    #: the value must additionally be truthy (legacy ``if not
    #: block.get(...)`` semantics — campaign's ``arm``)
    truthy: bool = False
    ge: Optional[float] = None
    gt: Optional[float] = None
    le: Optional[float] = None
    choices: object = None  # tuple or Ref
    legacy: Optional[str] = None
    stop_on_error: bool = False
    nonempty: bool = False
    nested: Optional[str] = None
    element_style: str = ""  # "knee_steps" | "campaign_stages"
    element_required: Tuple[str, ...] = ()
    element_optional: Tuple[str, ...] = ()
    emit_note: str = ""
    strict: bool = False

    @property
    def leaf(self) -> str:
        return self.path.rsplit(".", 1)[-1]


@dataclasses.dataclass(frozen=True)
class Gate:
    """Stop validating the remaining checks when ``path`` is falsy —
    an unapplied calibration carries no factors to judge."""

    path: str


@dataclasses.dataclass(frozen=True)
class Rule:
    """A named cross-field rule (see ``_RULES``) — the residue a
    per-field declaration cannot express (a knee claimed with no
    SLO-meeting step, a mutation line that never compacted)."""

    name: str


@dataclasses.dataclass(frozen=True)
class Hoist:
    """One block field hoisted to a top-level line key (setdefault
    semantics).  ``gate`` (default: ``src``) must be non-null — or
    truthy with ``truthy=True`` — for the hoist to fire; ``numeric``
    additionally requires the hoisted value to be a number.  ``bench``
    / ``refresher`` scope which loop performs it (bench flags
    ``roofline_estimated``; only the refresher back-fills
    ``multihost_hosts``)."""

    src: str
    dst: str
    gate: Optional[str] = None
    truthy: bool = False
    numeric: bool = False
    bench: bool = True
    refresher: bool = True


@dataclasses.dataclass(frozen=True)
class Curated:
    """One sentinel curated field contributed by this block: the
    hoisted top-level key, its good direction, and its rank in the
    legacy ``CURATED_FIELDS`` order (preserved so derived == hand
    list, element for element)."""

    field: str
    direction: str  # "higher" | "lower"
    rank: int


@dataclasses.dataclass(frozen=True)
class BlockSchema:
    """One cataloged artifact block."""

    name: str
    #: dotted path of the block on a bench line ("" = the line itself /
    #: a block that never rides bench lines)
    block_path: str
    #: docs anchor "docs/FILE.md#Heading text" — the artifact-lockstep
    #: checker requires the heading to exist
    doc: str
    #: ordered validation program: Field / Gate / Rule items
    checks: Tuple = ()
    version_field: Optional[str] = None
    version_ref: Optional[Ref] = None
    #: True: the version field must EQUAL the referenced constant;
    #: False: any int version token is accepted (the validator is
    #: version-tolerant, like roofline's)
    version_exact: bool = False
    #: legacy template for a non-dict block
    not_dict_legacy: Optional[str] = None
    #: "validator": an "error" key exempts inside validate() (knee,
    #: mutation); "curation": the refresher skips error blocks but the
    #: validator itself does not (roofline); "parent": exempt when the
    #: PARENT block carries "error" (calibration under roofline)
    error_exempt: str = "none"
    #: exact key-presence pass run first; ANY miss short-circuits
    #: (mutation's legacy contract) — also the public required list
    missing_order: Tuple[str, ...] = ()
    missing_legacy: Optional[str] = None
    hoists: Tuple[Hoist, ...] = ()
    curated: Tuple[Curated, ...] = ()
    #: repo-relative source files whose dict literals build this block
    emitters: Tuple[str, ...] = ()
    #: key sets identifying a dict literal as this block in an emitter
    fingerprints: Tuple[frozenset, ...] = ()
    #: the label in the refresher's refusal message ("malformed
    #: {refusal_label} block: ...")
    refusal_label: str = ""
    #: participates in the refresher's validate/refuse/hoist loop
    curate: bool = False
    #: participates in the perf_sentinel --lint history sweep
    sweep: bool = False
    #: name of the per-line print segment function (``_SUMMARIES``)
    summary: Optional[str] = None
    #: name of the pre-curation hook (``_PREPARES``) — roofline's
    #: back-derivation for lines that carry no block
    prepare: Optional[str] = None
    #: legacy validator entry point, "module:function" (the shim)
    validator: str = ""

    @property
    def fields(self) -> Tuple[Field, ...]:
        return tuple(c for c in self.checks if isinstance(c, Field))


# --------------------------------------------------------------------------
# the validation engine
# --------------------------------------------------------------------------
_KIND_TYPES = {
    "int": int,
    "number": (int, float),
    "str": str,
    "bool": bool,
    "dict": dict,
    "list": list,
}


def _resolve_path(obj, path: str) -> Tuple[bool, object]:
    """Walk a dotted path; ``(present, value)`` with the legacy
    ``dict.get`` semantics (a missing/non-dict ancestor reads as an
    absent ``None``)."""
    cur = obj
    parts = path.split(".")
    for part in parts[:-1]:
        if not isinstance(cur, dict) or part not in cur:
            return False, None
        cur = cur[part]
    if not isinstance(cur, dict) or parts[-1] not in cur:
        return False, None
    return True, cur[parts[-1]]


def _fmt(template: Optional[str], normalized: str, style: str,
         **kw) -> str:
    if style == "legacy" and template is not None:
        return template.format(**kw)
    return normalized.format(**kw)


def _type_desc(f: Field, version) -> str:
    if f.kind == "version":
        return f"version {version}" if version is not None \
            else "an int version token"
    if f.choices is not None:
        return "one of {choices}"
    if f.kind == "int":
        if f.ge == 0:
            return "a non-negative int"
        if f.ge == 1:
            return "a positive int"
        if f.ge is not None:
            return f"an int >= {int(f.ge)}"
        if f.gt == 0:
            return "a positive int"
        return "an int"
    if f.kind == "number":
        if f.ge == 0 and f.le == 1:
            return "a number in [0, 1]"
        if f.gt == 0:
            return "a positive number"
        if f.ge == 0:
            return "a non-negative number"
        return "a number"
    if f.kind == "list":
        return "a non-empty list" if f.nonempty else "a list"
    if f.kind == "dict" and f.nonempty:
        return "a non-empty dict"
    return {"str": "a string", "bool": "a bool",
            "dict": "a dict"}.get(f.kind, "well-formed")


def _check_value(f: Field, value, version) -> bool:
    """True when ``value`` satisfies the field's contract (None already
    handled by the caller)."""
    if f.strict and isinstance(value, bool) and \
            f.kind in ("version", "int", "number"):
        return False
    if f.kind == "version":
        if version is not None:
            return value == version
        return isinstance(value, int)
    if f.choices is not None:
        return value in _resolve(f.choices)
    if f.truthy and not value:
        return False
    t = _KIND_TYPES.get(f.kind)
    if t is not None and not isinstance(value, t):
        return False
    if f.kind in ("list", "dict") and f.nonempty and not value:
        return False
    if f.kind in ("int", "number"):
        if f.ge is not None and not value >= f.ge:
            return False
        if f.gt is not None and not value > f.gt:
            return False
        if f.le is not None and not value <= f.le:
            return False
    return True


def _field_error(schema: "BlockSchema", f: Field, value, style: str
                 ) -> str:
    version = version_value(schema.name) \
        if (f.kind == "version" and schema.version_exact) else None
    choices = _resolve(f.choices) if f.choices is not None else None
    desc = _type_desc(f, version)
    normalized = ("field {path} must be " + desc + ", got {value!r}")
    return _fmt(f.legacy, normalized, style, value=value, path=f.path,
                leaf=f.leaf, vtype=type(value).__name__,
                choices=choices, version=version)


def validate(name: str, block, style: str = "normalized") -> List[str]:
    """Validate one block against its schema; the list of violations
    (empty = valid).  ``style="legacy"`` renders each migrated
    validator's byte-identical error strings; ``"normalized"`` the
    engine's canonical phrasing."""
    schema = BY_NAME[name]
    if not isinstance(block, dict):
        return [_fmt(schema.not_dict_legacy,
                     "{name} block must be a dict, got {vtype}", style,
                     name=name, vtype=type(block).__name__)]
    errors: List[str] = []
    if schema.error_exempt == "validator" and "error" in block:
        return errors
    if schema.missing_order:
        for key in schema.missing_order:
            if key not in block:
                errors.append(_fmt(schema.missing_legacy,
                                   "missing field: {key}", style,
                                   key=key))
        if errors:
            return errors
    state: Dict[str, str] = {}
    for check in schema.checks:
        if isinstance(check, Gate):
            _, gval = _resolve_path(block, check.path)
            if not gval:
                break
            continue
        if isinstance(check, Rule):
            errors.extend(_RULES[check.name](block, style))
            continue
        f = check
        # a field under an errored (or optional-and-absent) declared
        # ancestor is skipped — the ancestor already told the story
        prefix_dead = False
        for p, st in state.items():
            if f.path.startswith(p + ".") and st in ("error", "absent"):
                prefix_dead = True
                break
        if prefix_dead:
            continue
        present, value = _resolve_path(block, f.path)
        if value is None:
            if f.nullable and f.required and not present:
                # null is allowed but ABSENCE is not: a required
                # nullable field must still be spelled out (mutation's
                # admitted_p99_ms reaches here only when present — its
                # missing_order pass already owns absence)
                errors.append(_fmt(schema.missing_legacy,
                                   "missing field: {key}", style,
                                   key=f.path))
                state[f.path] = "error"
                if f.stop_on_error:
                    return errors
                continue
            if f.nullable or not f.required:
                state[f.path] = "ok" if (present and f.nullable) \
                    else "absent"
                if f.nested is not None and present:
                    errors.extend(validate(f.nested, value, style))
                continue
            errors.append(_field_error(schema, f, value, style))
            state[f.path] = "error"
            if f.stop_on_error:
                return errors
            continue
        if f.nested is not None:
            state[f.path] = "ok"
            errors.extend(validate(f.nested, value, style))
            continue
        if not _check_value(f, value,
                            version_value(schema.name)
                            if (f.kind == "version"
                                and schema.version_exact) else None):
            errors.append(_field_error(schema, f, value, style))
            state[f.path] = "error"
            if f.stop_on_error:
                return errors
            continue
        state[f.path] = "ok"
        if f.kind == "list" and f.element_style:
            errors.extend(
                _ELEMENT_RULES[f.element_style](f, value, style))
    return errors


def version_value(name: str):
    """The resolved version constant a schema's version field is
    checked against (None when the schema declares no version)."""
    schema = BY_NAME[name]
    if schema.version_ref is None:
        return None
    return _resolve(schema.version_ref)


def required_keys(name: str) -> Tuple[str, ...]:
    """The exact key-presence list of a ``missing_order`` schema — the
    public ``MUTATION_REQUIRED`` tuple is derived from this."""
    return BY_NAME[name].missing_order


def element_required(name: str, path: str) -> Tuple[str, ...]:
    """The required per-element keys of a list field — the public
    ``STEP_FIELDS`` tuple is derived from this."""
    for f in BY_NAME[name].fields:
        if f.path == path:
            return f.element_required
    raise KeyError(f"{name} has no list field {path!r}")


# --- element rules --------------------------------------------------------
def _elements_knee_steps(f: Field, steps: list, style: str) -> List[str]:
    errs: List[str] = []
    for i, s in enumerate(steps):
        if not isinstance(s, dict):
            errs.append(f"rate_steps[{i}] must be a dict")
            continue
        for fld in f.element_required:
            if fld not in s:
                errs.append(f"rate_steps[{i}] missing {fld!r}")
    return errs


def _elements_campaign_stages(f: Field, stages: list, style: str
                              ) -> List[str]:
    for s in stages:
        if not isinstance(s, dict) or not s.get("stage") or \
                s.get("status") not in ("ok", "error", "skipped"):
            return [f"malformed stage record {s!r}"]
    return []


_ELEMENT_RULES = {
    "knee_steps": _elements_knee_steps,
    "campaign_stages": _elements_campaign_stages,
}


# --- cross-field rules ----------------------------------------------------
def _rule_knee_consistency(block: dict, style: str) -> List[str]:
    knee = block.get("knee_qps")
    steps = block.get("rate_steps")
    steps = steps if isinstance(steps, list) else []
    if knee is not None and steps:
        ok_steps = [s for s in steps
                    if isinstance(s, dict) and s.get("within_slo")]
        if not ok_steps:
            return ["knee_qps set but no step is within_slo"]
    return []


def _rule_mutation_compactions(block: dict, style: str) -> List[str]:
    # the acceptance bar the block exists to pin: a mixed-traffic line
    # that never swapped proves nothing about swap behavior
    if isinstance(block.get("compactions"), int) \
            and block["compactions"] < 1 \
            and "compactions_waived" not in block:
        return ["compactions must be >= 1 (a mutation line that "
                "never compacted measured nothing; set "
                "compactions_waived to curate one anyway)"]
    return []


def _rule_roofline_terms(block: dict, style: str) -> List[str]:
    # the port's roofline carries the H100's terms by name, whichever of
    # them the block's shape needs: every term but the IVF probe record
    # must hold a non-negative time
    terms = block.get("terms")
    if not isinstance(terms, dict):
        return []
    errs = []
    for name, term in terms.items():
        if name == "probe":
            continue
        t = term.get("time_s") if isinstance(term, dict) else None
        if isinstance(t, bool) or not isinstance(t, (int, float)) \
                or t < 0:
            errs.append(_fmt(
                "terms.{name}.time_s must be a non-negative number, got "
                "{value!r}",
                "field terms.{name}.time_s must be a non-negative number, "
                "got {value!r}", style, name=name, value=t))
    return errs


def _rule_tuning_cache_key(block: dict, style: str) -> List[str]:
    # a tuner entry is valid under one roofline model only: its key
    # carries the model's token (tuning.cache.roofline_token)
    key = block.get("cache_key")
    if not isinstance(key, str):
        return []
    token = _resolve(Ref("knn_tpu_torch.tuning.cache", "roofline_token"))()
    if f"|rl{token}|" in key:
        return []
    return [f"cache_key {key!r} does not carry the roofline token "
            f"rl{token}"]


_RULES = {
    "knee_consistency": _rule_knee_consistency,
    "mutation_compactions": _rule_mutation_compactions,
    "roofline_terms": _rule_roofline_terms,
    "tuning_cache_key": _rule_tuning_cache_key,
}


# --------------------------------------------------------------------------
# hoists, curation, printing
# --------------------------------------------------------------------------
def apply_hoists(rec: dict, block: dict, schema: BlockSchema,
                 scope: str) -> None:
    """Apply one schema's ``scope`` hoists from ``block`` onto ``rec``
    (setdefault semantics — an existing top-level value always wins)."""
    for h in schema.hoists:
        if scope == "bench" and not h.bench:
            continue
        if scope == "refresher" and not h.refresher:
            continue
        _, gval = _resolve_path(block, h.gate or h.src)
        if (not gval) if h.truthy else (gval is None):
            continue
        _, val = _resolve_path(block, h.src)
        if h.numeric and not isinstance(val, (int, float)):
            continue
        rec.setdefault(h.dst, val)


def _block_on_line(rec: dict, schema: BlockSchema):
    cur = rec
    for part in schema.block_path.split("."):
        if not isinstance(cur, dict):
            return None
        cur = cur.get(part)
    return cur


def _parent_block(rec: dict, schema: BlockSchema):
    parts = schema.block_path.split(".")
    if len(parts) < 2:
        return None
    cur = rec
    for part in parts[:-1]:
        if not isinstance(cur, dict):
            return None
        cur = cur.get(part)
    return cur


def _curation_exempt(rec: dict, schema: BlockSchema, block) -> bool:
    if schema.error_exempt == "curation":
        return isinstance(block, dict) and "error" in block
    if schema.error_exempt == "parent":
        parent = _parent_block(rec, schema)
        return isinstance(parent, dict) and "error" in parent
    return False


def apply_scope_hoists(rec: dict, scope: str = "bench") -> None:
    """The one hoist loop a benchmark runs over its assembled line: for
    every cataloged block present, hoist the declared keys."""
    for schema in CATALOG:
        if not schema.block_path or not schema.hoists:
            continue
        block = _block_on_line(rec, schema)
        if isinstance(block, dict):
            apply_hoists(rec, block, schema, scope)


def curate_line(rec: dict) -> Optional[str]:
    """The refresher's per-line loop: prepare (back-derive), validate
    (legacy error strings — the refusal message is byte-stable),
    and hoist every cataloged block on a fresh curated line.  Returns
    the refusal message for the first malformed block, None when the
    line curates clean."""
    for schema in CATALOG:
        if not schema.curate:
            continue
        needs_validation = True
        if schema.prepare is not None:
            block, needs_validation = _PREPARES[schema.prepare](rec)
        else:
            block = _block_on_line(rec, schema)
        if not isinstance(block, dict):
            continue
        if _curation_exempt(rec, schema, block):
            continue
        if needs_validation:
            errs = validate(schema.name, block, style="legacy")
            if errs:
                return (f"malformed {schema.refusal_label} block: "
                        f"{'; '.join(errs)}")
        apply_hoists(rec, block, schema, "refresher")
    return None


def _prepare_roofline(rec: dict):
    """A line that carries no roofline block back-derives one from its own
    config fields (``obs.roofline.block_for_bench_line``: the H100 model,
    or the generic estimate for a kind it has no peaks for); a derived
    block is trusted (the model built it), never re-validated."""
    block = rec.get("roofline")
    if block is not None:
        return block, True
    from knn_tpu_torch.obs import roofline

    derived = roofline.block_for_bench_line(rec)
    if derived is not None:
        rec["roofline"] = dict(derived, derived=True)
        return rec["roofline"], False
    return None, False


_PREPARES = {"roofline_derive": _prepare_roofline}


# --- per-line print segments (the refresher's readout) --------------------
def _summary_roofline(r: dict) -> str:
    # percent-of-roofline + bound class beside the sentinel verdict
    if isinstance(r.get("roofline_pct"), (int, float)):
        return (f" roofline={r['roofline_pct'] * 100:.1f}%"
                f"/{r.get('bound_class')}")
    return ""


def _summary_calibration(r: dict) -> str:
    # the analytic model's measured residual, when the line's roofline
    # block carries an applied calibration overlay
    if isinstance(r.get("model_residual_pct"), (int, float)):
        return f" calib={r['model_residual_pct']}%"
    return ""


def _summary_knee(r: dict) -> str:
    # the measured serving knee: max SLO-meeting sustained request rate
    if isinstance(r.get("knee_qps"), (int, float)):
        return f" knee={r['knee_qps']}q/s"
    return ""


def _summary_mutation(r: dict) -> str:
    # the mixed-traffic admitted-read p99 beside read-only numbers
    if isinstance(r.get("mutation_admitted_p99_ms"), (int, float)):
        return f" mutation={r['mutation_admitted_p99_ms']}ms/p99"
    return ""


def _summary_ivf(r: dict) -> str:
    # the probe-pruned tier: certified qps beside the measured recall
    if isinstance(r.get("ivf_qps"), (int, float)):
        seg = f" ivf={r['ivf_qps']}q/s"
        if isinstance(r.get("recall_at_k"), (int, float)):
            seg += f"@recall{r['recall_at_k']}"
        return seg
    return ""


def _summary_multihost(r: dict) -> str:
    # host count x DCN merge strategy + host-RAM tier sweep count
    if isinstance(r.get("multihost_hosts"), int):
        return (f" multihost={r['multihost_hosts']}x"
                f"{r.get('multihost_merge')}"
                + (f"/{r['hosttier_sweeps']}sweeps"
                   if isinstance(r.get("hosttier_sweeps"), int) else ""))
    return ""


_SUMMARIES = {
    "roofline": _summary_roofline,
    "calibration": _summary_calibration,
    "knee": _summary_knee,
    "mutation": _summary_mutation,
    "ivf": _summary_ivf,
    "multihost": _summary_multihost,
}


def line_summary(rec: dict) -> str:
    """The per-line artifact readout the refresher prints beside the
    sentinel verdict, one segment per cataloged block, catalog order."""
    return "".join(_SUMMARIES[s.summary](rec) for s in CATALOG
                   if s.summary is not None)


def curated_fields() -> Tuple[Tuple[str, str], ...]:
    """The sentinel's ``CURATED_FIELDS``, derived from the catalog in
    the legacy hand-list's exact order (each block's contribution
    carries its rank)."""
    rows = [c for s in CATALOG for c in s.curated]
    rows.sort(key=lambda c: c.rank)
    return tuple((c.field, c.direction) for c in rows)


def known_keys(name: str) -> set:
    """Every key name a schema legitimizes in an emitter's block
    literal: all declared path segments plus per-element keys — the
    artifact-lockstep checker's resolution set."""
    schema = BY_NAME[name]
    out: set = set()
    for f in schema.fields:
        out.update(f.path.split("."))
        out.update(f.element_required)
        out.update(f.element_optional)
    out.update(schema.missing_order)
    return out


# --------------------------------------------------------------------------
# the history sweep (perf_sentinel --lint)
# --------------------------------------------------------------------------
def sweep_records(records, style: str = "normalized"):
    """Validate every cataloged block on every history record.  Returns
    ``(counts, problems)``: per-schema ``validated`` /
    ``advisory_error`` / ``version_exempt`` counts and a list of
    ``{"schema", "label", "metric", "source", "error"}`` violations.

    A block whose exact-version schema finds an int version token
    STRICTLY below the current constant predates the schema: it is
    counted, not condemned.  Version-tolerant schemas (roofline accepts
    any int ``model_version``) validate every round."""
    counts = {s.name: {"validated": 0, "advisory_error": 0,
                       "version_exempt": 0}
              for s in CATALOG if s.sweep}
    problems: List[dict] = []
    for rec in records:
        if not isinstance(rec, dict):
            continue
        for schema in CATALOG:
            if not schema.sweep:
                continue
            if schema.block_path:
                block = _block_on_line(rec, schema)
                if block is None:
                    continue
            else:
                if schema.name != "bench_line":
                    continue
                block = rec
            if isinstance(block, dict) and "error" in block and \
                    schema.error_exempt == "curation":
                # a benchmark's advisory degradation ({"error": ...}) is
                # a designed outcome, not a lint hit
                counts[schema.name]["advisory_error"] += 1
                continue
            if _curation_exempt(rec, schema, block):
                continue
            if schema.version_exact and schema.version_field and \
                    isinstance(block, dict):
                tok = block.get(schema.version_field)
                if isinstance(tok, int) and \
                        tok < version_value(schema.name):
                    counts[schema.name]["version_exempt"] += 1
                    continue
            counts[schema.name]["validated"] += 1
            for err in validate(schema.name, block, style=style):
                problems.append({
                    "schema": schema.name,
                    "label": schema.refusal_label or schema.name,
                    "metric": rec.get("metric"),
                    "source": rec.get("_source"),
                    "error": err,
                })
    return counts, problems


def sweep_multichip(repo_dir: str):
    """Validate every checked-in ``MULTICHIP_r*.json`` driver record
    against its schema.  Returns ``(n_validated, problems)``."""
    n = 0
    problems: List[dict] = []
    for path in sorted(glob.glob(
            os.path.join(repo_dir, "MULTICHIP_r*.json"))):
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            problems.append({"schema": "multichip_record",
                             "label": "multichip",
                             "metric": None,
                             "source": os.path.basename(path),
                             "error": f"unreadable: {e}"})
            continue
        n += 1
        for err in validate("multichip_record", doc):
            problems.append({"schema": "multichip_record",
                             "label": "multichip", "metric": None,
                             "source": os.path.basename(path),
                             "error": err})
    return n, problems


# --------------------------------------------------------------------------
# THE CATALOG
# --------------------------------------------------------------------------
_RL = "knn_tpu_torch.obs.roofline"
_CAL = "knn_tpu_torch.obs.calibrate"
_XO = "knn_tpu_torch.parallel.crossover"

#: every schema's documentation: the README's port section heading that
#: lists the cataloged blocks
_DOC = "README.md#Artifact blocks"

#: sentinel verdict vocabulary ("error": the verdict computation raised —
#: a designed degradation, part of the contract)
SENTINEL_VERDICTS = ("ok", "warn", "regress", "no_baseline", "error")

CATALOG: Tuple[BlockSchema, ...] = (
    # --- bench top-level lines -----------------------------------------
    BlockSchema(
        name="bench_line",
        block_path="",
        doc=_DOC,
        # the JAX package's bench.py emits it; the port's benchmark will
        # (the campaign's rehearse lines and the refresher's curated lines
        # are bench lines too, held against this schema by their tests)
        emitters=(),
        fingerprints=(frozenset({"metric", "value", "unit"}),),
        sweep=True,
        curated=(
            Curated("value", "higher", 0),
            Curated("device_phase_qps", "higher", 1),
            Curated("serving_sustained_qps", "higher", 2),
            Curated("mfu", "higher", 3),
            Curated("mfu_device", "higher", 4),
        ),
        checks=(
            Field("metric", "str", required=True),
            Field("value", "number", nullable=True),
            Field("unit", "str", nullable=True),
            Field("vs_baseline", "number", nullable=True),
            Field("mode", "str", nullable=True),
            Field("device_phase_qps", "number", nullable=True),
            # the port's campaign line: the rate its device trace read
            # (divergence 66)
            Field("device_trace_qps", "number", nullable=True),
            Field("serving_sustained_qps", "number", nullable=True),
            Field("serving_latency_ms", "dict", nullable=True),
            Field("obs_overhead_pct", "number", nullable=True),
            # the artifact blocks themselves (each validated under its
            # own schema; declared here so the emitters' line literals
            # resolve)
            Field("roofline", "any"),
            Field("loadgen_knee", "any"),
            Field("mutation", "any"),
            Field("ivf", "any"),
            Field("pq", "any"),
            Field("join", "any"),
            Field("quality", "any"),
            Field("multihost", "any"),
            Field("campaign", "any"),
            Field("sentinel", "any"),
            Field("tuning", "any"),
            # the hoisted keys (every Hoist dst is a declared line key)
            Field("roofline_pct", "number", nullable=True),
            Field("bound_class", "str", nullable=True),
            Field("roofline_estimated", "bool", nullable=True),
            Field("model_residual_pct", "number", nullable=True),
            Field("knee_qps", "number", nullable=True),
            Field("mutation_admitted_p99_ms", "number", nullable=True),
            Field("ivf_qps", "number", nullable=True),
            Field("bytes_streamed_ratio", "number", nullable=True),
            Field("join_rows_per_s", "number", nullable=True),
            Field("audit_recall_at_k", "number", nullable=True),
            Field("multihost_hosts", "int", nullable=True),
            Field("multihost_merge", "str", nullable=True),
            Field("multihost_qps", "number", nullable=True),
            Field("hosttier_sweeps", "int", nullable=True),
            # soundness gate + recall provenance
            Field("pallas_gate_ok", "bool", nullable=True),
            Field("gate_note", "str", nullable=True),
            Field("gate_queries", "int", nullable=True),
            Field("gate_rows", "int", nullable=True),
            Field("gate_stats", "dict", nullable=True),
            Field("session_gate_ok", "bool", nullable=True,
                  emit_note="stamped by the archived round-5 session "
                            "driver (scripts/archive/tpu_session.py); "
                            "declared so r05 history lines sweep "
                            "clean, no live emitter writes it"),
            Field("recall_at_k", "number", nullable=True),
            Field("recall_unverified", "bool", nullable=True),
            Field("recall_below_one", "bool", nullable=True),
            # run shape / environment
            Field("compute_dtype", "str", nullable=True),
            Field("metric_fn", "str", nullable=True),
            Field("runs", "int", nullable=True),
            Field("qps_std", "number", nullable=True),
            Field("qps_labels_only", "number", nullable=True),
            Field("mfu", "number", nullable=True),
            Field("mfu_device", "number", nullable=True),
            Field("mfu_reason", "str", nullable=True),
            Field("peak_flops_assumed", "number", nullable=True),
            Field("selectors", "dict", nullable=True),
            Field("cpu_baseline_qps", "number", nullable=True),
            Field("cpu_baseline_cached", "bool", nullable=True),
            Field("cpu_queries", "int", nullable=True),
            Field("cpu_per_query_s", "number", nullable=True),
            Field("devices", "int", nullable=True),
            Field("device_kind", "str", nullable=True),
            Field("backend", "str", nullable=True),
            Field("cpu_fallback_shrunk", "bool", nullable=True),
            Field("curated_tpu_line", "dict", nullable=True),
            Field("batch", "int", nullable=True),
            Field("train_tile", "int", nullable=True),
            Field("pallas_knobs", "dict", nullable=True),
            Field("approx_knobs", "dict", nullable=True),
            Field("precision", "str", nullable=True),
            Field("quant_bound_max", "number", nullable=True),
            Field("quant_scales_dtype", "str", nullable=True),
            Field("quant_bound_error", "str", nullable=True),
            Field("error", "str", nullable=True),
            # curation provenance (stamped by the refresher)
            Field("measured_round", "int", nullable=True),
            Field("measured_at_commit", "str", nullable=True),
            Field("stale", "bool", nullable=True),
        ),
    ),
    # --- roofline (the port's own block: the H100 model) -----------------
    BlockSchema(
        name="roofline",
        block_path="roofline",
        doc=_DOC,
        validator="knn_tpu_torch.obs.roofline:validate_block",
        emitters=("knn_tpu_torch/obs/roofline.py",),
        fingerprints=(frozenset({"model_version", "terms"}),),
        version_field="model_version",
        version_ref=Ref(_RL, "MODEL_VERSION"),
        version_exact=False,
        not_dict_legacy="roofline block is {vtype}, not a dict",
        error_exempt="curation",
        refusal_label="roofline",
        curate=True,
        sweep=True,
        summary="roofline",
        prepare="roofline_derive",
        missing_order=("model_version", "bound_class", "ceiling_qps",
                       "terms", "estimated"),
        missing_legacy="missing field: {key}",
        hoists=(
            Hoist("roofline_pct", "roofline_pct"),
            Hoist("bound_class", "bound_class", gate="roofline_pct",
                  bench=False),
            Hoist("bound_class", "bound_class", truthy=True,
                  refresher=False),
            Hoist("estimated", "roofline_estimated", truthy=True,
                  refresher=False),
        ),
        curated=(Curated("roofline_pct", "higher", 5),),
        checks=(
            Field("model_version", "version", required=True, strict=True,
                  legacy="model_version must be an int, got {value!r}"),
            Field("bound_class", required=True,
                  choices=Ref(_RL, "BOUND_CLASSES"),
                  legacy="bound_class {value!r} not in {choices}"),
            Field("ceiling_qps", "number", required=True, nullable=True,
                  gt=0, strict=True,
                  legacy="ceiling_qps must be a positive number, got "
                         "{value!r}"),
            Field("terms", "dict", required=True, nonempty=True,
                  legacy="terms must be a non-empty dict"),
            # every term the block's shape priced (hbm, tensor_core,
            # cuda_core, smem, h2d; probe is the IVF record)
            Rule("roofline_terms"),
            Field("estimated", "bool", required=True,
                  legacy="estimated must be a bool, got {value!r}"),
            Field("roofline_pct", "number", ge=0, strict=True,
                  legacy="roofline_pct must be a non-negative number, "
                         "got {value!r}"),
            Field("calibration", nested="calibration"),
            # declared, engine-filled / advisory keys (unconstrained)
            Field("selector", "any"),
            Field("device_kind", "any"),
            Field("peaks", "any"),
            Field("estimated_peaks", "any"),
            Field("config", "any"),
            Field("join", "any"),
            Field("measured_qps", "any"),
            Field("ceiling_qps_analytic", "any"),
            Field("term_times_s", "any"),
            Field("term_times_calibrated_s", "any"),
            Field("error", "any"),
        ),
    ),
    # --- calibration (nested under roofline) ------------------------------
    BlockSchema(
        name="calibration",
        block_path="roofline.calibration",
        doc=_DOC,
        validator="knn_tpu_torch.obs.calibrate:validate_calibration",
        emitters=("knn_tpu_torch/obs/roofline.py",
                  "knn_tpu_torch/obs/calibrate.py"),
        fingerprints=(frozenset({"applied", "factors"}),),
        not_dict_legacy="calibration is {vtype}, not dict",
        error_exempt="parent",
        refusal_label="calibration",
        curate=True,
        sweep=True,
        summary="calibration",
        hoists=(
            Hoist("model_residual_pct", "model_residual_pct",
                  gate="applied", truthy=True, numeric=True),
        ),
        curated=(Curated("model_residual_pct", "lower", 7),),
        checks=(
            Field("applied", "bool", required=True, stop_on_error=True,
                  legacy="calibration.applied {value!r} is not a bool"),
            Gate("applied"),
            Field("factors", "dict", required=True,
                  legacy="applied calibration missing factors dict"),
            # the H100's five terms (calibrate.TERMS), where the JAX
            # package's are hbm / mxu / vpu_select (divergence 49); the
            # port refuses a bool factor or residual, as its validator did
            Field("factors.hbm", "number", required=True, gt=0,
                  strict=True,
                  legacy="calibration factor {leaf} {value!r} is not "
                         "a positive number"),
            Field("factors.tensor_core", "number", required=True, gt=0,
                  strict=True,
                  legacy="calibration factor {leaf} {value!r} is not "
                         "a positive number"),
            Field("factors.cuda_core", "number", required=True, gt=0,
                  strict=True,
                  legacy="calibration factor {leaf} {value!r} is not "
                         "a positive number"),
            Field("factors.smem", "number", required=True, gt=0,
                  strict=True,
                  legacy="calibration factor {leaf} {value!r} is not "
                         "a positive number"),
            Field("factors.h2d", "number", required=True, gt=0,
                  strict=True,
                  legacy="calibration factor {leaf} {value!r} is not "
                         "a positive number"),
            Field("source", required=True,
                  choices=Ref(_CAL, "SOURCES"),
                  legacy="calibration source {value!r} not in "
                         "{choices}"),
            Field("model_residual_pct", "number", required=True,
                  strict=True,
                  legacy="calibration.model_residual_pct {value!r} is "
                         "not a number"),
            # provenance the overlay carries (unconstrained)
            Field("method", "any"),
            Field("age_s", "any"),
            Field("samples", "any"),
            Field("term_residual_pct", "any"),
            Field("measured_at", "any"),
            Field("provenance", "any"),
            Field("note", "any"),
            Field("error", "any"),
        ),
    ),
    # --- campaign ---------------------------------------------------------
    BlockSchema(
        name="campaign",
        block_path="campaign",
        doc=_DOC,
        validator="knn_tpu_torch.obs.calibrate:validate_campaign_block",
        emitters=("knn_tpu_torch/campaign.py",),
        fingerprints=(frozenset({"campaign_version", "stages"}),),
        version_field="campaign_version",
        version_ref=Ref("knn_tpu_torch.campaign", "CAMPAIGN_VERSION"),
        version_exact=False,
        not_dict_legacy="campaign block is {vtype}, not dict",
        refusal_label="campaign",
        curate=True,
        sweep=True,
        checks=(
            # a bool is no version token (the port's validator refused
            # one; the JAX package's accepts it)
            Field("campaign_version", "version", required=True,
                  strict=True,
                  legacy="missing/non-int campaign_version"),
            Field("arm", "any", required=True, truthy=True,
                  legacy="missing arm name"),
            # the port's stage records: the rehearse arm's, with no
            # grid_level (the hardware arm's) and no sentinel verdict
            # (divergences 48, 50)
            Field("stages", "list", required=True, nonempty=True,
                  element_style="campaign_stages",
                  element_required=("stage", "status"),
                  element_optional=("error", "device", "device_kind",
                                    "calibration_store", "trace_dir",
                                    "rehearse_note", "winner", "winner_ms",
                                    "candidates", "pruned",
                                    "resource_gate", "refused", "tiles",
                                    "n_queries", "cache_path", "device_s",
                                    "device_qps", "place_s", "tile_n",
                                    "certified", "fallback_queries",
                                    "live_capture", "live_capture_error",
                                    "factors", "method",
                                    "model_residual_pct", "source", "fits",
                                    "store", "key", "applied",
                                    "ceiling_qps", "measured_qps",
                                    "reconstruction_residual_pct",
                                    "ceiling_below", "tolerance_pct",
                                    "artifact", "validation_errors"),
                  legacy="missing stages list"),
            Field("rehearse", "bool", required=True,
                  legacy="missing/non-bool rehearse flag"),
            Field("round", "any"),
        ),
    ),
    # --- loadgen knee -----------------------------------------------------
    BlockSchema(
        name="loadgen_knee",
        block_path="loadgen_knee",
        doc=_DOC,
        validator="knn_tpu_torch.loadgen.knee:validate_knee_block",
        emitters=("knn_tpu_torch/loadgen/knee.py",),
        fingerprints=(frozenset({"rate_steps", "slo_p99_ms"}),
                      frozenset({"rate_qps", "within_slo"})),
        version_field="version",
        version_ref=Ref("knn_tpu_torch.loadgen.knee", "BLOCK_VERSION"),
        version_exact=True,
        not_dict_legacy="knee block must be a dict, got {vtype}",
        error_exempt="validator",
        refusal_label="loadgen_knee",
        curate=True,
        sweep=True,
        summary="knee",
        hoists=(Hoist("knee_qps", "knee_qps"),),
        curated=(Curated("knee_qps", "higher", 6),),
        checks=(
            Field("version", "version", required=True,
                  legacy="version must be {version}, got {value!r}"),
            Field("slo_p99_ms", "number", required=True, gt=0,
                  legacy="slo_p99_ms must be a positive number, got "
                         "{value!r}"),
            Field("rate_steps", "list", required=True, nonempty=True,
                  element_style="knee_steps",
                  element_required=("rate_qps", "offered", "ok",
                                    "achieved_qps", "shed_fraction",
                                    "within_slo"),
                  element_optional=("rejected", "shed", "errors",
                                    "offered_qps", "admitted_p50_ms",
                                    "admitted_p95_ms",
                                    "admitted_p99_ms", "per_tenant",
                                    "slowest", "empty_schedule"),
                  legacy="rate_steps must be a non-empty list"),
            Field("knee_qps", "number",
                  legacy="knee_qps must be a number or null, got "
                         "{value!r}"),
            Rule("knee_consistency"),
            Field("knee_rate_qps", "any"),
        ),
    ),
    # --- mutation ---------------------------------------------------------
    BlockSchema(
        name="mutation",
        block_path="mutation",
        doc=_DOC,
        validator="knn_tpu_torch.index.artifact:validate_mutation_block",
        # the JAX package's bench.py emits it; the port's benchmark will
        emitters=(),
        fingerprints=(frozenset({"mutation_version", "write_mix"}),),
        version_field="mutation_version",
        version_ref=Ref("knn_tpu_torch.index.artifact",
                        "MUTATION_VERSION"),
        version_exact=True,
        not_dict_legacy="mutation block must be a dict, got {vtype}",
        error_exempt="validator",
        refusal_label="mutation",
        curate=True,
        sweep=True,
        summary="mutation",
        missing_order=("mutation_version", "write_mix", "rate_qps",
                       "duration_s", "admitted_p99_ms", "compactions",
                       "epoch", "reads", "writes",
                       "slo_breach_transitions"),
        missing_legacy="missing {key!r}",
        hoists=(Hoist("admitted_p99_ms", "mutation_admitted_p99_ms"),),
        curated=(Curated("mutation_admitted_p99_ms", "lower", 8),),
        checks=(
            Field("mutation_version", "version", required=True,
                  legacy="mutation_version must be {version}, got "
                         "{value!r}"),
            Field("write_mix", "dict", required=True,
                  legacy="write_mix must be a dict, got {value!r}"),
            Field("write_mix.insert_fraction", "number", required=True,
                  ge=0, le=1,
                  legacy="write_mix.{leaf} must be a number in [0, 1],"
                         " got {value!r}"),
            Field("write_mix.delete_fraction", "number", required=True,
                  ge=0, le=1,
                  legacy="write_mix.{leaf} must be a number in [0, 1],"
                         " got {value!r}"),
            Field("rate_qps", "number", required=True, gt=0,
                  legacy="{path} must be a positive number, got "
                         "{value!r}"),
            Field("duration_s", "number", required=True, gt=0,
                  legacy="{path} must be a positive number, got "
                         "{value!r}"),
            Field("admitted_p99_ms", "number", required=True,
                  nullable=True, ge=0,
                  legacy="admitted_p99_ms must be a non-negative "
                         "number or null, got {value!r}"),
            Field("compactions", "int", required=True, ge=0,
                  legacy="{path} must be a non-negative int, got "
                         "{value!r}"),
            Field("epoch", "int", required=True, ge=0,
                  legacy="{path} must be a non-negative int, got "
                         "{value!r}"),
            Field("slo_breach_transitions", "int", required=True, ge=0,
                  legacy="{path} must be a non-negative int, got "
                         "{value!r}"),
            Rule("mutation_compactions"),
            Field("reads", "dict", required=True,
                  legacy="{path} must be a dict, got {value!r}"),
            Field("writes", "dict", required=True,
                  legacy="{path} must be a dict, got {value!r}"),
            Field("index_rows", "any"),
            Field("admitted_p50_ms", "any"),
            Field("achieved_qps", "any"),
            Field("swap_seconds_max", "any"),
            Field("validation_errors", "any"),
            Field("error", "any"),
            Field("compactions_waived", "any",
                  emit_note="operator escape hatch named only by the "
                            "validator's refusal message; never "
                            "machine-emitted"),
        ),
    ),
    # --- ivf --------------------------------------------------------------
    BlockSchema(
        name="ivf",
        block_path="ivf",
        doc=_DOC,
        validator="knn_tpu_torch.ivf.artifact:validate_ivf_block",
        emitters=(),
        fingerprints=(frozenset({"ivf_version", "nprobe"}),),
        version_field="ivf_version",
        version_ref=Ref("knn_tpu_torch.ivf.artifact", "IVF_VERSION"),
        version_exact=True,
        not_dict_legacy="ivf block must be a dict, got {vtype}",
        error_exempt="validator",
        refusal_label="ivf",
        curate=True,
        sweep=True,
        summary="ivf",
        missing_order=("ivf_version", "ncentroids", "nprobe", "queries",
                       "k", "probe_fraction", "recall_at_k",
                       "fallback_rate", "bytes_streamed_ratio", "qps"),
        missing_legacy="missing {key!r}",
        hoists=(
            Hoist("qps", "ivf_qps"),
            Hoist("bytes_streamed_ratio", "bytes_streamed_ratio"),
        ),
        curated=(
            Curated("recall_at_k", "higher", 9),
            Curated("ivf_qps", "higher", 10),
            Curated("bytes_streamed_ratio", "lower", 11),
        ),
        checks=(
            Field("ivf_version", "version", required=True,
                  legacy="ivf_version must be {version}, got "
                         "{value!r}"),
            Field("ncentroids", "int", required=True, ge=1,
                  legacy="{path} must be a positive int, got "
                         "{value!r}"),
            Field("nprobe", "int", required=True, ge=1,
                  legacy="{path} must be a positive int, got "
                         "{value!r}"),
            Field("queries", "int", required=True, ge=1,
                  legacy="{path} must be a positive int, got "
                         "{value!r}"),
            Field("k", "int", required=True, ge=1,
                  legacy="{path} must be a positive int, got "
                         "{value!r}"),
            Field("probe_fraction", "number", required=True, ge=0,
                  le=1,
                  legacy="{path} must be a number in [0, 1], got "
                         "{value!r}"),
            Field("recall_at_k", "number", required=True, ge=0, le=1,
                  legacy="{path} must be a number in [0, 1], got "
                         "{value!r}"),
            Field("fallback_rate", "number", required=True, ge=0,
                  le=1,
                  legacy="{path} must be a number in [0, 1], got "
                         "{value!r}"),
            Field("bytes_streamed_ratio", "number", required=True,
                  ge=0,
                  legacy="{path} must be a non-negative number, got "
                         "{value!r}"),
            Field("qps", "number", required=True, nullable=True, ge=0,
                  legacy="qps must be a non-negative number or null, "
                         "got {value!r}"),
            Field("selector", "any"),
            Field("fallback_queries", "any"),
            Field("certified_queries", "any"),
            Field("genuine_misses", "any"),
            Field("epoch", "any"),
            Field("compactions", "any"),
            Field("validation_errors", "any"),
            Field("error", "any"),
        ),
    ),
    # --- pq (codebook-geometry provenance of precision="pq" lines) --------
    BlockSchema(
        name="pq",
        block_path="pq",
        doc=_DOC,
        validator="knn_tpu_torch.ops.pq_artifact:validate_pq_block",
        emitters=(),
        fingerprints=(frozenset({"pq_version", "dsub"}),),
        version_field="pq_version",
        version_ref=Ref("knn_tpu_torch.ops.pq_artifact", "PQ_VERSION"),
        version_exact=True,
        not_dict_legacy="pq block must be a dict, got {vtype}",
        error_exempt="validator",
        refusal_label="pq",
        curate=True,
        sweep=True,
        missing_order=("pq_version", "dsub", "ncodes", "nsub",
                       "lut_bytes", "bound_max", "queries"),
        missing_legacy="missing {key!r}",
        checks=(
            Field("pq_version", "version", required=True,
                  legacy="pq_version must be {version}, got {value!r}"),
            Field("dsub", "int", required=True, ge=1,
                  legacy="{path} must be a positive int, got "
                         "{value!r}"),
            Field("ncodes", "int", required=True, ge=2,
                  legacy="{path} must be an int >= 2, got {value!r}"),
            Field("nsub", "int", required=True, ge=1,
                  legacy="{path} must be a positive int, got "
                         "{value!r}"),
            Field("lut_bytes", "int", required=True, ge=0,
                  legacy="{path} must be a non-negative int, got "
                         "{value!r}"),
            Field("bound_max", "number", required=True, nullable=True,
                  ge=0,
                  legacy="bound_max must be a non-negative number or "
                         "null, got {value!r}"),
            Field("queries", "int", required=True, ge=1,
                  legacy="{path} must be a positive int, got "
                         "{value!r}"),
            Field("error", "any"),
        ),
    ),
    # --- the multi-host merge and host-RAM tier block ----------------------
    BlockSchema(
        name="multihost",
        block_path="multihost",
        doc=_DOC,
        validator="knn_tpu_torch.parallel.crossover:validate_multihost_block",
        # the JAX package's bench.py emits it; the port's benchmark will
        emitters=(),
        fingerprints=(frozenset({"hosts", "merge"}),
                      frozenset({"sweeps", "budget_bytes",
                                 "segment_rows"})),
        not_dict_legacy="multihost block is {vtype}, not dict",
        refusal_label="multihost",
        curate=True,
        sweep=True,
        summary="multihost",
        hoists=(
            Hoist("hosts", "multihost_hosts", truthy=True, bench=False),
            Hoist("merge.dcn.strategy", "multihost_merge", truthy=True,
                  bench=False),
            Hoist("hosttier.sweeps", "hosttier_sweeps", truthy=True),
        ),
        checks=(
            Field("hosts", "int", required=True, ge=1,
                  legacy="hosts {value!r} is not a positive int"),
            Field("chips_per_host", "int", ge=1,
                  legacy="chips_per_host {value!r} is not a positive "
                         "int"),
            Field("merge", "dict", required=True,
                  legacy="missing merge breakdown"),
            Field("merge.intra", "dict",
                  legacy="merge.intra is not a dict"),
            Field("merge.intra.strategy", required=True,
                  choices=Ref(_XO, "STRATEGIES"),
                  legacy="merge.intra.strategy {value!r} not in "
                         "{choices}"),
            Field("merge.intra.source", required=True,
                  choices=Ref(_XO, "SOURCES"),
                  legacy="merge.intra.source {value!r} not in "
                         "{choices}"),
            Field("merge.dcn", "dict",
                  legacy="merge.dcn is not a dict"),
            Field("merge.dcn.strategy", required=True,
                  choices=Ref(_XO, "STRATEGIES"),
                  legacy="merge.dcn.strategy {value!r} not in "
                         "{choices}"),
            Field("merge.dcn.source", required=True,
                  choices=Ref(_XO, "SOURCES"),
                  legacy="merge.dcn.source {value!r} not in "
                         "{choices}"),
            Field("dcn_merge_bytes", "int", ge=0,
                  legacy="dcn_merge_bytes {value!r} is not a "
                         "non-negative int"),
            Field("hosttier", "dict",
                  legacy="hosttier is not a dict"),
            Field("hosttier.sweeps", "int", required=True, ge=1,
                  legacy="hosttier.sweeps {value!r} is not a positive "
                         "int"),
            Field("hosttier.budget_bytes", "int", required=True, gt=0,
                  legacy="hosttier.budget_bytes {value!r} is not a "
                         "positive int"),
            Field("hosttier.segment_rows", "int", required=True, ge=1,
                  legacy="hosttier.segment_rows {value!r} is not a "
                         "positive int"),
            Field("hosttier.bytes_per_sweep", "any"),
            Field("hosttier.sweep_walls_s", "any"),
            Field("hosttier.qps", "any"),
            Field("error", "any"),
        ),
    ),
    # --- bulk kNN-join ----------------------------------------------------
    BlockSchema(
        name="join",
        block_path="join",
        doc=_DOC,
        validator="knn_tpu_torch.join.artifact:validate_join_block",
        emitters=(),
        fingerprints=(frozenset({"join_version", "superblock_rows"}),),
        version_field="join_version",
        version_ref=Ref("knn_tpu_torch.join.artifact", "JOIN_VERSION"),
        version_exact=True,
        not_dict_legacy="join block must be a dict, got {vtype}",
        error_exempt="validator",
        refusal_label="join",
        curate=True,
        sweep=True,
        missing_order=("join_version", "mode", "rows", "k",
                       "superblock_rows", "depth", "order",
                       "superblocks", "db_segments", "dispatches",
                       "rows_per_s", "overlap_ratio"),
        missing_legacy="missing {key!r}",
        hoists=(Hoist("rows_per_s", "join_rows_per_s"),),
        curated=(Curated("join_rows_per_s", "higher", 12),),
        checks=(
            Field("join_version", "version", required=True,
                  legacy="join_version must be {version}, got "
                         "{value!r}"),
            Field("mode", required=True,
                  choices=Ref("knn_tpu_torch.join.engine",
                              "JOIN_MODES"),
                  legacy="mode {value!r} not in {choices}"),
            Field("rows", "int", required=True, ge=1,
                  legacy="{path} must be a positive int, got "
                         "{value!r}"),
            Field("k", "int", required=True, ge=1,
                  legacy="{path} must be a positive int, got "
                         "{value!r}"),
            Field("superblock_rows", "int", required=True, ge=1,
                  legacy="{path} must be a positive int, got "
                         "{value!r}"),
            Field("depth", "int", required=True, ge=1,
                  legacy="{path} must be a positive int, got "
                         "{value!r}"),
            Field("order", required=True,
                  choices=("query_major", "db_major"),
                  legacy="order {value!r} not in {choices}"),
            Field("superblocks", "int", required=True, ge=1,
                  legacy="{path} must be a positive int, got "
                         "{value!r}"),
            Field("db_segments", "int", required=True, ge=1,
                  legacy="{path} must be a positive int, got "
                         "{value!r}"),
            Field("dispatches", "int", required=True, ge=1,
                  legacy="{path} must be a positive int, got "
                         "{value!r}"),
            Field("rows_per_s", "number", required=True, nullable=True,
                  ge=0,
                  legacy="rows_per_s must be a non-negative number or "
                         "null, got {value!r}"),
            Field("overlap_ratio", "number", required=True,
                  nullable=True, ge=0, le=1,
                  legacy="overlap_ratio must be a number in [0, 1] or "
                         "null, got {value!r}"),
            Field("baseline_rows_per_s", "any"),
            Field("speedup_vs_serving", "any"),
            Field("wall_s", "any"),
            Field("plan", "any"),
            Field("fallback_queries", "any"),
            Field("validation_errors", "any"),
            Field("error", "any"),
        ),
    ),
    # --- quality (shadow audit) -------------------------------------------
    BlockSchema(
        name="quality",
        block_path="quality",
        doc=_DOC,
        emitters=(),
        fingerprints=(frozenset({"quality_version",
                                 "audit_recall_at_k"}),),
        version_field="quality_version",
        version_ref=Ref("knn_tpu_torch.obs.audit", "QUALITY_VERSION"),
        version_exact=True,
        not_dict_legacy="quality block must be a dict, got {vtype}",
        error_exempt="validator",
        refusal_label="quality",
        curate=True,
        sweep=True,
        missing_order=("quality_version", "audit_rate",
                       "audit_sampled_requests",
                       "audit_replayed_queries",
                       "audit_deficient_queries",
                       "audit_dropped_records", "audit_recall_at_k"),
        missing_legacy="missing {key!r}",
        hoists=(Hoist("audit_recall_at_k", "audit_recall_at_k"),),
        curated=(Curated("audit_recall_at_k", "higher", 13),),
        checks=(
            Field("quality_version", "version", required=True,
                  legacy="quality_version must be {version}, got "
                         "{value!r}"),
            Field("audit_rate", "number", required=True, ge=0, le=1,
                  legacy="audit_rate must be a number in [0, 1], got "
                         "{value!r}"),
            Field("audit_sampled_requests", "int", required=True,
                  ge=0,
                  legacy="{path} must be a non-negative int, got "
                         "{value!r}"),
            Field("audit_replayed_queries", "int", required=True,
                  ge=0,
                  legacy="{path} must be a non-negative int, got "
                         "{value!r}"),
            Field("audit_deficient_queries", "int", required=True,
                  ge=0,
                  legacy="{path} must be a non-negative int, got "
                         "{value!r}"),
            Field("audit_dropped_records", "int", required=True, ge=0,
                  legacy="{path} must be a non-negative int, got "
                         "{value!r}"),
            Field("audit_recall_at_k", "number", required=True,
                  nullable=True, ge=0, le=1,
                  legacy="audit_recall_at_k must be a number in "
                         "[0, 1] or null, got {value!r}"),
            Field("audit_rank_displacement_p99", "number",
                  nullable=True),
            Field("audit_distance_rel_error_p99", "number",
                  nullable=True),
            Field("wall_s", "any"),
            Field("error", "any"),
        ),
    ),
    # --- fleet observability (cross-host merge) ---------------------------
    BlockSchema(
        name="fleet",
        block_path="fleet",
        doc=_DOC,
        emitters=("knn_tpu_torch/obs/fleet.py",),
        fingerprints=(frozenset({"fleet_version", "member_count"}),),
        version_field="fleet_version",
        version_ref=Ref("knn_tpu_torch.obs.fleet", "FLEET_VERSION"),
        version_exact=True,
        not_dict_legacy="fleet block must be a dict, got {vtype}",
        error_exempt="validator",
        refusal_label="fleet",
        sweep=True,
        checks=(
            Field("fleet_version", "version", required=True),
            Field("catalog_version", "str", required=True),
            Field("member_count", "int", required=True, ge=0),
            Field("expected_members", "int", required=True, ge=0),
            Field("unreachable_count", "int", required=True, ge=0),
            Field("skewed_count", "int", required=True, ge=0),
            Field("partial", "bool", required=True),
            Field("staleness_s", "number", required=True, ge=0),
            Field("straggler_host", "int", nullable=True),
            Field("straggler_gap_s", "number", nullable=True, ge=0),
            Field("stitched_requests", "int", required=True, ge=0),
            Field("slo_breached", "int", required=True, ge=0),
            Field("wall_s", "any",
                  emit_note="the JAX package's bench.py times its fleet "
                            "block; obs.fleet.artifact_block writes "
                            "none, and the port's benchmark will"),
            Field("error", "any"),
        ),
    ),
    # --- sentinel verdict ------------------------------------------------
    BlockSchema(
        name="sentinel",
        block_path="sentinel",
        doc=_DOC,
        # the verdict, and the campaign line's {"verdict": "error", ...}
        # when the sentinel raised
        emitters=("knn_tpu_torch/obs/sentinel.py",
                  "knn_tpu_torch/campaign.py"),
        fingerprints=(frozenset({"verdict", "baseline_key"}),),
        sweep=True,
        checks=(
            Field("verdict", "str", required=True,
                  choices=SENTINEL_VERDICTS),
            Field("baseline_key", "str", nullable=True),
            Field("fields", "dict", nullable=True),
            Field("error", "str", nullable=True),
        ),
    ),
    # --- tuning-cache entries (the port's own shape) ----------------------
    BlockSchema(
        name="tuning_cache_entry",
        block_path="",
        doc=_DOC,
        emitters=("knn_tpu_torch/tuning/autotune.py",),
        fingerprints=(frozenset({"knobs", "winner", "timings_ms"}),),
        checks=(
            Field("knobs", "dict", required=True),
            Field("winner", "str", required=True),
            Field("winner_ms", "number", nullable=True),
            Field("timings_ms", "dict", required=True),
            Field("errors", "dict", nullable=True),
            Field("roofline_per_candidate", "dict", nullable=True),
            Field("gate", "str", required=True),
            Field("runs", "int", required=True, ge=1),
            Field("n_queries", "int", required=True, ge=1),
            Field("margin", "int", nullable=True),
            Field("device_kind", "str", nullable=True),
            Field("backend", "str", nullable=True),
            # the port's in place of the JAX entry's jax_version
            Field("torch_version", "str", nullable=True),
            Field("measured_at", "str", nullable=True),
            Field("pruning", "dict", nullable=True),
            # the Hopper resource gate's record, where the JAX entry
            # carries the TPU's vmem verdict
            Field("smem", "dict", nullable=True),
            Field("selector", "str", nullable=True),
            Field("stats_per_candidate", "dict", nullable=True),
            Field("roofline", nested="roofline"),
            Field("roofline_pct", "number", nullable=True),
            Field("bound_class", "str", nullable=True),
            Field("cached", "bool", nullable=True),
            Field("cache_key", "str", nullable=True),
            Field("cache_path", "str", nullable=True),
            # the key carries rl<token>: an entry is valid under one
            # roofline model (divergence 20)
            Rule("tuning_cache_key"),
        ),
    ),
    # --- a multi-chip run record (MULTICHIP_r*.json) -----------------------
    BlockSchema(
        name="multichip_record",
        block_path="",
        doc=_DOC,
        emitters=(),
        checks=(
            Field("n_devices", "int", required=True, ge=1),
            Field("rc", "int", required=True),
            Field("ok", "bool", required=True),
            Field("skipped", "bool", required=True),
            Field("tail", "str", required=True, nullable=True),
        ),
    ),
)

#: name -> schema, for the engine and the checker
BY_NAME: Dict[str, BlockSchema] = {s.name: s for s in CATALOG}


def _validate_catalog() -> None:
    seen_versions: Dict[str, str] = {}
    for s in CATALOG:
        if len(BY_NAME) != len(CATALOG):
            raise ValueError("duplicate schema names")
        if s.version_field:
            if s.version_ref is None:
                raise ValueError(
                    f"{s.name}: version_field without version_ref")
            owner = seen_versions.setdefault(s.version_field, s.name)
            if owner != s.name:
                raise ValueError(
                    f"version token {s.version_field!r} consumed by "
                    f"both {owner} and {s.name}")
        if "#" not in s.doc:
            raise ValueError(f"{s.name}: doc anchor must be "
                             f"'file#heading'")


_validate_catalog()
