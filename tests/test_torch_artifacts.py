"""The port's artifact-schema catalog (knn_tpu_torch.analysis.artifacts)
against the JAX package's (knn_tpu.analysis.artifacts), and the port's
validators as shims over it.

For every schema the two packages share, a valid block and its generated
mutations (each required field dropped or null, each typed field given a
wrong type, each ranged field out of range, a non-dict block, an
``error`` key) go through both ``validate``s in both styles; the strings
must be equal, one for one.  Exact: the engine does no arithmetic.  The
listed divergences (ROADMAP queue C) are the fields where the port's
block really differs: the calibration factors are the H100's five terms
(divergence 49), and the port refuses a bool where a number or version
token is declared on its calibration and campaign blocks, as its
validators always did; a bench line may carry the campaign's
``device_trace_qps`` (divergence 66); each has its own test, as do the
port's own schemas (``roofline``, ``tuning_cache_entry``).

The bench-line half: ``curate_line``, ``apply_hoists``, ``line_summary``,
``sweep_records`` and ``sweep_multichip`` against the JAX package's on
the repo's history (``TPU_BENCH_r*.jsonl``, ``BENCH_r*.json``,
``MULTICHIP_r*.json``) for every block the two catalogs declare alike
(the roofline block a line without one back-derives is the H100 model's,
``obs.roofline.block_for_bench_line``, and is compared with that), and
the ``artifact-lockstep`` checker's invariants 3 and 4, armed by the
port's refresher and sentinel.
"""

import copy
import dataclasses
import json

import numpy as np
import pytest

from knn_tpu.analysis import artifacts as jart
from knn_tpu.index import artifact as jmut
from knn_tpu.ivf import artifact as jivf
from knn_tpu.join import artifact as jjoin
from knn_tpu.loadgen import knee as jknee
from knn_tpu.ops import pq_artifact as jpq
from knn_tpu.parallel import crossover as jxo

from knn_tpu_torch.analysis import artifacts as art
from knn_tpu_torch.index import artifact as mut
from knn_tpu_torch.ivf import artifact as ivf
from knn_tpu_torch.join import artifact as join
from knn_tpu_torch.loadgen import knee
from knn_tpu_torch.obs import calibrate, roofline
from knn_tpu_torch.ops import pq_artifact as pq
from knn_tpu_torch.parallel import crossover as xo

from test_torch_cuda import empty_default_tune_cache  # noqa: F401 (autouse)

STYLES = ("legacy", "normalized")

#: calibration factors of one package and not the other (divergence 49)
JAX_ONLY_FACTORS = {"factors.mxu", "factors.vpu_select"}
PORT_ONLY_FACTORS = {"factors.tensor_core", "factors.cuda_core",
                     "factors.smem", "factors.h2d"}

_STEP = {"rate_qps": 10.0, "offered": 5, "ok": 5, "achieved_qps": 9.0,
         "shed_fraction": 0.0, "within_slo": True}

#: one block per shared schema, valid in both packages
VALID = {
    "calibration": {
        "applied": True,
        "factors": {t: 1.25 for t in ("hbm", "mxu", "vpu_select",
                                      "tensor_core", "cuda_core", "smem",
                                      "h2d")},
        "source": "device_trace", "model_residual_pct": 3.5,
        "method": "bound_term", "age_s": 1.0, "samples": 1},
    "campaign": {
        "campaign_version": 1, "arm": "bf16x3_tiled", "round": 19,
        "rehearse": True,
        "stages": [{"stage": "gates", "status": "ok"},
                   {"stage": "tune", "status": "skipped"}]},
    "loadgen_knee": {
        "version": 1, "slo_p99_ms": 50.0, "rate_steps": [dict(_STEP)],
        "knee_qps": 9.0, "knee_rate_qps": 10.0},
    "mutation": {
        "mutation_version": 1,
        "write_mix": {"insert_fraction": 0.5, "delete_fraction": 0.25},
        "rate_qps": 100.0, "duration_s": 2.0, "admitted_p99_ms": 4.5,
        "compactions": 1, "epoch": 1, "reads": {"n": 1}, "writes": {"n": 1},
        "slo_breach_transitions": 0},
    "ivf": {
        "ivf_version": 1, "ncentroids": 64, "nprobe": 8, "queries": 128,
        "k": 10, "probe_fraction": 0.125, "recall_at_k": 1.0,
        "fallback_rate": 0.0, "bytes_streamed_ratio": 0.2, "qps": 900.0},
    "pq": {
        "pq_version": 1, "dsub": 4, "ncodes": 256, "nsub": 32,
        "lut_bytes": 4096, "bound_max": 1.5, "queries": 64},
    "join": {
        "join_version": 1, "mode": "stream", "rows": 4096, "k": 10,
        "superblock_rows": 1024, "depth": 2, "order": "query_major",
        "superblocks": 4, "db_segments": 1, "dispatches": 4,
        "rows_per_s": 1e5, "overlap_ratio": 0.5},
    "quality": {
        "quality_version": 1, "audit_rate": 0.5,
        "audit_sampled_requests": 8, "audit_replayed_queries": 40,
        "audit_deficient_queries": 0, "audit_dropped_records": 1,
        "audit_recall_at_k": 1.0, "audit_rank_displacement_p99": 0.0,
        "audit_distance_rel_error_p99": 0.0},
    "fleet": {
        "fleet_version": 1, "catalog_version": "abc123",
        "member_count": 2, "expected_members": 2, "unreachable_count": 0,
        "skewed_count": 0, "partial": False, "staleness_s": 0.5,
        "straggler_host": 1, "straggler_gap_s": 0.25,
        "stitched_requests": 3, "slo_breached": 0},
    "multihost": {
        "hosts": 2, "chips_per_host": 4,
        "merge": {"intra": {"strategy": "ring", "source": "measured"},
                  "dcn": {"strategy": "allgather", "source": "explicit"}},
        "dcn_merge_bytes": 6553600,
        "hosttier": {"sweeps": 4, "budget_bytes": 134217728,
                     "segment_rows": 260111, "bytes_per_sweep": 1,
                     "sweep_walls_s": [0.1], "qps": 1.0}},
    "multichip_record": {"n_devices": 4, "rc": 0, "ok": True,
                         "skipped": False, "tail": "done"},
    "sentinel": {"verdict": "no_baseline",
                 "baseline_key": "knn_qps_x|cuda|default",
                 "fields": {"value": {"verdict": "no_baseline"}}},
    "bench_line": {
        "metric": "knn_qps_main_n1000000_d128_k100", "value": 60000.0,
        "unit": "queries/s", "mode": "certified_pallas", "backend": "cuda",
        "device_kind": "NVIDIA H100 80GB HBM3", "batch": 4096,
        "device_phase_qps": 61000.0, "device_trace_qps": 62000.0,
        "pallas_knobs": {"tile_n": 16384},
        "roofline_pct": 0.05, "bound_class": "tensor_core_bound",
        "recall_at_k": 1.0, "runs": 2, "devices": 1, "pallas_gate_ok": True,
        "measured_round": 1, "measured_at_commit": "abc1234",
        "stale": False, "sentinel": {"verdict": "ok"}},
}

SHARED = sorted(VALID)

_WRONG = {"int": "x", "number": "x", "str": 5, "bool": "yes", "dict": "x",
          "list": "x", "version": "x"}
_DROP = object()


def _with(block, path, value):
    """``block`` with ``path`` set to ``value`` (``_DROP``: removed); None
    when an ancestor is absent."""
    out = copy.deepcopy(block)
    cur = out
    parts = path.split(".")
    for p in parts[:-1]:
        if not isinstance(cur, dict) or p not in cur:
            return None
        cur = cur[p]
    if not isinstance(cur, dict):
        return None
    if value is _DROP:
        if parts[-1] not in cur:
            return None
        del cur[parts[-1]]
    else:
        cur[parts[-1]] = value
    return out


def mutations(name):
    """(label, touched path or None, block) for the generated mutations of
    ``VALID[name]`` over the union of both packages' declared fields."""
    valid = VALID[name]
    fields = {}
    for schema in (jart.BY_NAME[name], art.BY_NAME[name]):
        for f in schema.fields:
            fields.setdefault(f.path, f)
    out = [("valid", None, valid), ("not a dict", None, "nope"),
           ("none", None, None), ("list", None, [1]),
           ("error key", None, {**valid, "error": "boom"}),
           ("empty", None, {})]
    for key in jart.BY_NAME[name].missing_order:
        out.append((f"missing {key}", key, _with(valid, key, _DROP)))
    for path, f in sorted(fields.items()):
        cases = [("dropped", _DROP), ("null", None)]
        if f.kind in _WRONG:
            cases.append(("wrong type", _WRONG[f.kind]))
        if f.kind == "int":
            cases.append(("float for int", 1.5))
        if f.choices is not None:
            cases.append(("not a choice", "no-such-choice"))
        if f.ge is not None:
            cases.append(("below ge", f.ge - 1))
        if f.gt is not None:
            cases.append(("at gt", f.gt))
        if f.le is not None:
            cases.append(("above le", f.le + 1))
        if f.kind == "list" and f.nonempty:
            cases.append(("empty list", []))
        if f.truthy:
            cases.append(("falsy", ""))
        for label, value in cases:
            b = _with(valid, path, value)
            if b is not None:
                out.append((f"{path} {label}", path, b))
    if name == "loadgen_knee":
        out += [("step not a dict", "rate_steps",
                 {**valid, "rate_steps": ["x", dict(_STEP)]}),
                ("step missing a field", "rate_steps",
                 {**valid, "rate_steps": [{"rate_qps": 1.0}]}),
                ("knee with no step within", "rate_steps",
                 {**valid, "rate_steps": [{**_STEP, "within_slo": False}]})]
    if name == "campaign":
        out += [("malformed stage", "stages",
                 {**valid, "stages": [{"stage": "tune", "status": "won"}]})]
    if name == "mutation":
        out += [("never compacted", "compactions",
                 {**valid, "compactions": 0}),
                ("compaction waived", "compactions",
                 {**valid, "compactions": 0, "compactions_waived": True})]
    if name == "calibration":
        out += [("unapplied", "applied", {"applied": False}),
                ("unapplied with junk", "applied",
                 {"applied": False, "factors": "x"})]
    return out


#: bench-line fields of the port's schema alone (divergence 66)
PORT_ONLY_LINE = {"device_trace_qps"}


def _divergent(name, path):
    return (name == "calibration" and path in (JAX_ONLY_FACTORS
                                               | PORT_ONLY_FACTORS)) or \
        (name == "bench_line" and path in PORT_ONLY_LINE)


@pytest.mark.parametrize("name", SHARED)
def test_shared_schema_equals_jax_on_every_mutation(name):
    cases = mutations(name)
    # the sentinel block declares four fields; every other schema five or
    # more
    n_fields = len(art.BY_NAME[name].fields)
    assert len(cases) > min(20, 4 * n_fields)
    refused = 0
    for label, path, block in cases:
        for style in STYLES:
            got = art.validate(name, block, style=style)
            want = jart.validate(name, block, style=style)
            if _divergent(name, path):
                # each package refuses its own fields' faults only
                port_field = path in PORT_ONLY_FACTORS | PORT_ONLY_LINE
                if name == "bench_line":
                    # optional and nullable: the port refuses a wrong type
                    assert bool(got) == label.endswith("wrong type"), label
                    assert want == [], (label, want)
                elif label.endswith(("dropped", "null", "wrong type",
                                     "at gt")):
                    assert bool(got) == port_field, (label, got)
                    assert bool(want) == (not port_field), (label, want)
                continue
            assert got == want, (name, label, style)
            refused += bool(got)
    assert art.validate(name, VALID[name]) == []
    assert refused > min(10, n_fields)


@pytest.mark.parametrize("name", SHARED)
def test_shared_schema_declarations_equal_jax(name):
    p, j = art.BY_NAME[name], jart.BY_NAME[name]
    assert p.version_field == j.version_field
    assert art.version_value(name) == jart.version_value(name)
    assert p.version_exact == j.version_exact
    assert p.missing_order == j.missing_order
    assert p.missing_legacy == j.missing_legacy
    assert p.not_dict_legacy == j.not_dict_legacy
    assert p.error_exempt == j.error_exempt
    assert [dataclasses.astuple(h) for h in p.hoists] == \
        [dataclasses.astuple(h) for h in j.hoists]
    assert [dataclasses.astuple(c) for c in p.curated] == \
        [dataclasses.astuple(c) for c in j.curated]
    assert p.fingerprints == j.fingerprints
    pf = {f.path: f for f in p.fields}
    jf = {f.path: f for f in j.fields}
    diverge = set()
    if name == "calibration":
        diverge = JAX_ONLY_FACTORS | PORT_ONLY_FACTORS
    if name == "bench_line":
        diverge = PORT_ONLY_LINE
    assert set(pf) ^ set(jf) == diverge
    assert (p.block_path, p.sweep, p.curate, p.summary, p.prepare,
            p.refusal_label) == (j.block_path, j.sweep, j.curate, j.summary,
                                 j.prepare, j.refusal_label)
    for path in set(pf) & set(jf):
        a, b = pf[path], jf[path]
        assert (a.kind, a.required, a.nullable, a.truthy, a.ge, a.gt, a.le,
                a.legacy, a.nonempty, a.nested, a.element_style,
                a.element_required) == \
            (b.kind, b.required, b.nullable, b.truthy, b.ge, b.gt, b.le,
             b.legacy, b.nonempty, b.nested, b.element_style,
             b.element_required), path


def test_bools_the_port_refuses_and_jax_accepts():
    """Divergence: the port's calibration factors, its residual and the
    campaign's version token refuse a bool, as the port's validators did
    before they were shims; the JAX package's accept ``True``."""
    cal = VALID["calibration"]
    for path in ("factors.hbm", "model_residual_pct"):
        b = _with(cal, path, True)
        assert art.validate("calibration", b, style="legacy")
        assert calibrate.validate_calibration(b)
    assert jart.validate("calibration", _with(cal, "factors.hbm", True)) \
        == []
    b = {**VALID["campaign"], "campaign_version": True}
    assert calibrate.validate_campaign_block(b) == \
        ["missing/non-int campaign_version"]
    assert jart.validate("campaign", b, style="legacy") == []


def test_calibration_factors_are_the_h100_terms():
    """Divergence 49: the calibration schema's factors are
    ``calibrate.TERMS``; the port refuses a missing tensor_core factor the
    JAX package does not know, and accepts a block without mxu."""
    paths = [f.path for f in art.BY_NAME["calibration"].fields
             if f.path.startswith("factors.")]
    assert paths == [f"factors.{t}" for t in calibrate.TERMS]
    port_only = {"applied": True, "source": "host_phase",
                 "model_residual_pct": 0.0,
                 "factors": dict.fromkeys(calibrate.TERMS, 1.0)}
    assert calibrate.validate_calibration(port_only) == []
    assert jart.validate("calibration", port_only, style="legacy") == [
        "calibration factor mxu None is not a positive number",
        "calibration factor vpu_select None is not a positive number"]
    no_tc = _with(port_only, "factors.tensor_core", _DROP)
    assert calibrate.validate_calibration(no_tc) == [
        "calibration factor tensor_core None is not a positive number"]


# --- the shims ----------------------------------------------------------
SHIMS = [
    ("mutation", mut.validate_mutation_block, jmut.validate_mutation_block,
     (mut.MUTATION_VERSION, mut.MUTATION_REQUIRED),
     (jmut.MUTATION_VERSION, jmut.MUTATION_REQUIRED)),
    ("ivf", ivf.validate_ivf_block, jivf.validate_ivf_block,
     (ivf.IVF_VERSION, ivf.IVF_REQUIRED),
     (jivf.IVF_VERSION, jivf.IVF_REQUIRED)),
    ("join", join.validate_join_block, jjoin.validate_join_block,
     (join.JOIN_VERSION, join.JOIN_REQUIRED),
     (jjoin.JOIN_VERSION, jjoin.JOIN_REQUIRED)),
    ("pq", pq.validate_pq_block, jpq.validate_pq_block,
     (pq.PQ_VERSION, pq.PQ_REQUIRED), (jpq.PQ_VERSION, jpq.PQ_REQUIRED)),
    ("loadgen_knee", knee.validate_knee_block, jknee.validate_knee_block,
     (knee.BLOCK_VERSION, knee.STEP_FIELDS),
     (jknee.BLOCK_VERSION, jknee.STEP_FIELDS)),
    ("multihost", xo.validate_multihost_block, jxo.validate_multihost_block,
     (xo.STRATEGIES, xo.SOURCES), (jxo.STRATEGIES, jxo.SOURCES)),
]


@pytest.mark.parametrize("shim", SHIMS, ids=[s[0] for s in SHIMS])
def test_shims_equal_the_jax_shims(shim):
    name, port_fn, jax_fn, port_consts, jax_consts = shim
    assert port_consts == jax_consts
    for label, _path, block in mutations(name):
        assert port_fn(block) == jax_fn(block), label
    assert port_fn(VALID[name]) == []


def test_shim_modules_import_no_torch():
    import ast
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for rel in ("index/artifact.py", "ivf/artifact.py", "join/artifact.py",
                "ops/pq_artifact.py", "analysis/artifacts.py",
                "parallel/crossover.py",
                "analysis/core.py", "analysis/switches.py",
                "analysis/lockorder.py", "analysis/annotations.py"):
        tree = ast.parse(open(os.path.join(repo, "knn_tpu_torch", rel)).read())
        top = [n for n in tree.body
               if isinstance(n, (ast.Import, ast.ImportFrom))]
        names = {a.name.split(".")[0] for n in top if isinstance(n, ast.Import)
                 for a in n.names}
        names |= {(n.module or "").split(".")[0] for n in top
                  if isinstance(n, ast.ImportFrom)}
        assert not names & {"torch", "jax", "knn_tpu", "numpy"}, (rel, names)


# --- the port's own schemas ------------------------------------------------
def _hand_validate_calibration(cal):
    """The port's hand validator before the catalog (obs/calibrate.py),
    kept here as the reference the catalog's legacy strings are held
    to."""
    def number(v):
        return isinstance(v, (int, float)) and not isinstance(v, bool)

    if not isinstance(cal, dict):
        return [f"calibration is {type(cal).__name__}, not dict"]
    if not isinstance(cal.get("applied"), bool):
        return [f"calibration.applied {cal.get('applied')!r} is not a bool"]
    if not cal["applied"]:
        return []
    errs = []
    factors = cal.get("factors")
    if not isinstance(factors, dict):
        errs.append("applied calibration missing factors dict")
    else:
        for t in calibrate.TERMS:
            f = factors.get(t)
            if not number(f) or f <= 0:
                errs.append(f"calibration factor {t} {f!r} is not a "
                            f"positive number")
    if cal.get("source") not in calibrate.SOURCES:
        errs.append(f"calibration source {cal.get('source')!r} not in "
                    f"{calibrate.SOURCES}")
    if not number(cal.get("model_residual_pct")):
        errs.append(f"calibration.model_residual_pct "
                    f"{cal.get('model_residual_pct')!r} is not a number")
    return errs


def _hand_validate_block(block):
    """The port's hand roofline validator before the catalog
    (obs/roofline.py)."""
    def number(v):
        return isinstance(v, (int, float)) and not isinstance(v, bool)

    if not isinstance(block, dict):
        return [f"roofline block is {type(block).__name__}, not a dict"]
    errs = []
    for key in ("model_version", "bound_class", "ceiling_qps", "terms",
                "estimated"):
        if key not in block:
            errs.append(f"missing field: {key}")
    if errs:
        return errs
    if not isinstance(block["model_version"], int) \
            or isinstance(block["model_version"], bool):
        errs.append(f"model_version must be an int, got "
                    f"{block['model_version']!r}")
    if block["bound_class"] not in roofline.BOUND_CLASSES:
        errs.append(f"bound_class {block['bound_class']!r} not in "
                    f"{roofline.BOUND_CLASSES}")
    cq = block["ceiling_qps"]
    if cq is not None and (not number(cq) or cq <= 0):
        errs.append(f"ceiling_qps must be a positive number, got {cq!r}")
    terms = block["terms"]
    if not isinstance(terms, dict) or not terms:
        errs.append("terms must be a non-empty dict")
    else:
        for name, term in terms.items():
            if name == "probe":
                continue
            t = term.get("time_s") if isinstance(term, dict) else None
            if not number(t) or t < 0:
                errs.append(f"terms.{name}.time_s must be a non-negative "
                            f"number, got {t!r}")
    if not isinstance(block["estimated"], bool):
        errs.append(f"estimated must be a bool, got {block['estimated']!r}")
    pct = block.get("roofline_pct")
    if pct is not None and (not number(pct) or pct < 0):
        errs.append(f"roofline_pct must be a non-negative number, got "
                    f"{pct!r}")
    if "calibration" in block:
        errs.extend(_hand_validate_calibration(block["calibration"]))
    return errs


def _roofline_blocks():
    h100 = "NVIDIA H100 80GB HBM3"
    cal = {"applied": True, "factors": dict.fromkeys(calibrate.TERMS, 1.1),
           "source": "host_phase", "model_residual_pct": 10.0}
    base = roofline.attribute(roofline.pallas_cost_model(
        n=1000, d=16, k=5, nq=8), 50.0)
    return [
        base,
        roofline.pallas_cost_model(n=10**6, d=128, k=100, nq=4096,
                                   device_kind=h100),
        roofline.counted_cost_model(n=10**6, d=128, k=100, nq=4096),
        roofline.join_cost_model(n_a=100, n_b=1000, d=16, k=5,
                                 superblock_rows=32),
        roofline.pallas_cost_model(n=10**6, d=128, k=100, nq=4096,
                                   nprobe=2, ncentroids=64, precision="pq"),
        {**base, "calibration": cal},
    ]


def _roofline_mutations(block):
    out = [block, "nope", [1], None, {}]
    for key in list(block):
        out.append({k: v for k, v in block.items() if k != key})
        for value in (None, "x", True, -1, 0, 1.5, [], {}):
            out.append({**block, key: value})
    for term in block["terms"]:
        for value in (None, -1.0, "x", True, 0):
            t = copy.deepcopy(block)
            t["terms"][term]["time_s"] = value
            out.append(t)
        t = copy.deepcopy(block)
        t["terms"][term] = "not a dict"
        out.append(t)
    cal = block.get("calibration") or {"applied": True}
    for key in ("applied", "factors", "source", "model_residual_pct"):
        for value in (None, "x", True, -1.0, {}):
            out.append({**block, "calibration": {**cal, key: value}})
    for t in calibrate.TERMS:
        f = dict((cal.get("factors") or {}))
        for value in (None, 0, -2.0, True, "x"):
            out.append({**block, "calibration": {
                **cal, "applied": True, "factors": {**f, t: value}}})
    return out


@pytest.mark.parametrize("i", range(6))
def test_roofline_legacy_equals_the_hand_validator(i):
    """The port's own ``roofline`` schema reproduces its hand validator's
    strings byte for byte on real blocks and their mutations (NaN aside:
    the catalog refuses a NaN ceiling, time or share, which the hand
    validator let through)."""
    block = _roofline_blocks()[i]
    assert roofline.validate_block(block) == []
    for b in _roofline_mutations(block):
        assert roofline.validate_block(b) == _hand_validate_block(b), b
        assert art.validate("roofline", b, style="legacy") == \
            _hand_validate_block(b)
        assert bool(art.validate("roofline", b, style="normalized")) == \
            bool(_hand_validate_block(b))
    nan = {**block, "roofline_pct": float("nan")}
    assert roofline.validate_block(nan) and not _hand_validate_block(nan)


def test_roofline_is_the_ports_own_block():
    """Divergence: the port's roofline has the H100 bound classes and the
    terms its shape priced; the JAX schema refuses it, and the port
    refuses a TPU class."""
    block = _roofline_blocks()[1]
    assert block["bound_class"] in roofline.BOUND_CLASSES
    assert art.validate("roofline", block) == []
    assert jart.validate("roofline", block, style="legacy")
    assert art.validate("roofline", {**block, "bound_class": "mxu_bound"},
                        style="legacy") == [
        f"bound_class 'mxu_bound' not in {roofline.BOUND_CLASSES}"]


def test_tuning_cache_entry_is_the_ports_own_block(tmp_path):
    """Divergence 20: a real tuner entry (the plain versions on the CPU)
    validates, its key carries ``rl<token>``, and an entry whose key lacks
    the token is refused, where the JAX schema has no such rule."""
    from knn_tpu_torch import tuning
    from knn_tpu_torch.tuning.cache import roofline_token

    rng = np.random.default_rng(3)
    db = (rng.random((600, 8)) * 64).astype(np.float32)
    q = (rng.random((8, 8)) * 64).astype(np.float32)
    entry = tuning.autotune(db, q, 3, margin=4, runs=1, grid=[{}],
                            cache_path=str(tmp_path / "t.json"),
                            device="cpu")
    again = tuning.autotune(db, q, 3, margin=4, runs=1, grid=[{}],
                            cache_path=str(tmp_path / "t.json"),
                            device="cpu")
    assert again["cached"]
    for e in (entry, again, json.loads(json.dumps(entry))):
        for style in STYLES:
            assert art.validate("tuning_cache_entry", e, style=style) == []
    assert f"|rl{roofline_token()}|" in entry["cache_key"]
    bad = {**entry, "cache_key": entry["cache_key"].replace(
        f"|rl{roofline_token()}", "")}
    assert art.validate("tuning_cache_entry", bad) == [
        f"cache_key {bad['cache_key']!r} does not carry the roofline "
        f"token rl{roofline_token()}"]
    assert not any("cache_key" in e
                   for e in jart.validate("tuning_cache_entry", bad))
    assert art.validate("tuning_cache_entry", {**entry, "runs": 0}) == \
        ["field runs must be a positive int, got 0"]
    fields = {f.path for f in art.BY_NAME["tuning_cache_entry"].fields}
    assert {"smem", "torch_version"} <= fields
    assert not fields & {"jax_version", "vmem", "profile"}


def test_campaign_sentinel_is_the_ports_absent_verdict():
    """Divergence 48 is closed: a campaign line's ``sentinel`` is
    obs.sentinel's verdict, validated by the ``sentinel`` schema the two
    packages declare alike; the placeholder the port carried before, an
    ``absent`` verdict, is refused by both."""
    from knn_tpu_torch import campaign

    assert not hasattr(campaign, "SENTINEL_ABSENT")
    absent = {"verdict": "absent", "note": "not ported"}
    for style in STYLES:
        assert art.validate("sentinel", absent, style=style) == \
            jart.validate("sentinel", absent, style=style) != []
    assert art.SENTINEL_VERDICTS == jart.SENTINEL_VERDICTS
    assert art.BY_NAME["sentinel"].block_path == "sentinel"
    assert "sentinel" not in art.known_keys("campaign")
    assert "sentinel" in art.known_keys("bench_line")


def test_rehearse_line_validates_through_the_catalog(tmp_path):
    """A rehearse campaign arm on the CPU: its artifact line's roofline,
    calibration, campaign block and sentinel each validate in both
    styles, and the stage records carry no ``grid_level`` (divergence
    50)."""
    from knn_tpu_torch import campaign

    calibrate.configure(str(tmp_path / "cal.json"))
    try:
        s = campaign.run_campaign(rehearse=True, arms=("bf16x3_tiled",),
                                  out_dir=str(tmp_path), device="cpu",
                                  shape=dict(n=2048, d=32, k=5, nq=64))
    finally:
        calibrate.configure(None)
    line = s["results"][0]["line"]
    for name, block in (("roofline", line["roofline"]),
                        ("calibration", line["roofline"]["calibration"]),
                        ("campaign", line["campaign"]),
                        ("sentinel", line["sentinel"]),
                        ("bench_line", line)):
        for style in STYLES:
            assert art.validate(name, block, style=style) == [], name
    assert line["sentinel"]["verdict"] == "no_baseline"
    assert line["sentinel"]["baseline_key"] == \
        "knn_qps_rehearse_n2048_d32_k5|cpu|default"
    stage_keys = {k for st in line["campaign"]["stages"] for k in st}
    assert "grid_level" not in stage_keys
    assert stage_keys <= art.known_keys("campaign")


def test_catalog_surface():
    assert [s.name for s in art.CATALOG] == [s.name for s in jart.CATALOG]
    for s in art.CATALOG:
        if s.version_field:
            assert isinstance(art.version_value(s.name), int)
    assert art.required_keys("mutation") == jart.required_keys("mutation")
    assert art.element_required("loadgen_knee", "rate_steps") == \
        jart.element_required("loadgen_knee", "rate_steps")
    with pytest.raises(KeyError):
        art.element_required("loadgen_knee", "no_such_list")
    assert art.curated_fields() == jart.curated_fields()
    assert art.known_keys("ivf") == jart.known_keys("ivf")
    assert set(jart.BY_NAME) == set(art.BY_NAME)
    assert art.__all__ == jart.__all__


# --- the bench-line half: curation, hoists, print, sweeps ----------------
def _history():
    from knn_tpu_torch.obs import sentinel

    recs = list(sentinel.iter_history_lines(REPO))
    assert len(recs) == 12
    return recs


REPO = __file__.rsplit("/tests/", 1)[0]

#: the keys a back-derived roofline block sets on a curated line: the
#: port's is the H100 model, the JAX package's the TPU one
_ROOFLINE_KEYS = ("roofline", "roofline_pct", "bound_class")

#: the schemas the two catalogs declare alike (the port's roofline and
#: tuning_cache_entry are its own; the bench line's one extra field is
#: divergence 66)
ALIKE = sorted(set(SHARED) - {"bench_line"})


def test_curate_line_equals_jax_on_the_history():
    """Every history line through both ``curate_line``s: the same refusal
    (none), the same hoists and fields, a roofline derived where the JAX
    package derives one — the H100 model's, estimated for a TPU or CPU
    kind — and every line's refusal byte-equal once a block is broken."""
    from knn_tpu_torch.obs import roofline

    derived = 0
    for rec in _history():
        p, j = copy.deepcopy(rec), copy.deepcopy(rec)
        assert art.curate_line(p) == jart.curate_line(j) is None
        assert ("roofline" in p) == ("roofline" in j)
        if "roofline" in p:
            derived += 1
            block = p["roofline"]
            assert block["derived"] is True and block["estimated"] is True
            assert block == dict(roofline.block_for_bench_line(rec),
                                 derived=True)
            assert p["roofline_pct"] == block["roofline_pct"]
            assert p["bound_class"] == block["bound_class"]
        strip = {k: v for k, v in p.items() if k not in _ROOFLINE_KEYS}
        assert strip == {k: v for k, v in j.items()
                         if k not in _ROOFLINE_KEYS}
        for name in ALIKE:
            schema = art.BY_NAME[name]
            if not schema.curate or "." in schema.block_path:
                continue
            for bad in ({"version": "x"}, "nope"):
                a = {**copy.deepcopy(rec), schema.block_path: bad}
                b = copy.deepcopy(a)
                assert art.curate_line(a) == jart.curate_line(b), name
    assert derived == 11


@pytest.mark.parametrize("name", ALIKE)
def test_apply_hoists_equals_jax(name):
    ps, js = art.BY_NAME[name], jart.BY_NAME[name]
    for label, _path, block in mutations(name):
        if not isinstance(block, dict):
            continue
        for scope in ("bench", "refresher"):
            p, j = {}, {}
            art.apply_hoists(p, block, ps, scope)
            jart.apply_hoists(j, block, js, scope)
            assert p == j, (label, scope)
        line = {ps.block_path: block} if ps.block_path else dict(block)
        p, j = copy.deepcopy(line), copy.deepcopy(line)
        art.apply_scope_hoists(p)
        jart.apply_scope_hoists(j)
        assert p == j, label


def test_line_summary_equals_jax():
    lines = [dict(r) for r in _history()]
    lines.append({"roofline_pct": 0.0512, "bound_class": "hbm_bound",
                  "model_residual_pct": -1.5, "knee_qps": 171.3,
                  "mutation_admitted_p99_ms": 14.2, "ivf_qps": 900.0,
                  "recall_at_k": 1.0, "multihost_hosts": 2,
                  "multihost_merge": "ring", "hosttier_sweeps": 4})
    lines.append({"ivf_qps": 5, "multihost_hosts": 2})
    for rec in lines:
        assert art.line_summary(rec) == jart.line_summary(rec)
    assert art.line_summary(lines[-2]) == (
        " roofline=5.1%/hbm_bound calib=-1.5% knee=171.3q/s "
        "mutation=14.2ms/p99 ivf=900.0q/s@recall1.0 "
        "multihost=2xring/4sweeps")


def test_sweeps_equal_jax_on_the_history():
    """The ``perf_sentinel --lint`` sweep of the repo's history: the same
    counts and problems as the JAX package's (roofline: no history line
    carries one), the counts ``chip_smoke.py`` checks on the card, and
    the same MULTICHIP records."""
    import chip_smoke

    recs = _history()
    for style in STYLES:
        got, got_problems = art.sweep_records(recs, style=style)
        want, want_problems = jart.sweep_records(recs, style=style)
        assert got == want and got_problems == want_problems == []
    assert {name: c["validated"] for name, c in got.items()
            if c["validated"]} == chip_smoke.HISTORY_SWEEP
    assert got["roofline"] == {"validated": 0, "advisory_error": 0,
                               "version_exempt": 0}
    assert art.sweep_multichip(REPO) == jart.sweep_multichip(REPO) == \
        (chip_smoke.HISTORY_MULTICHIP, [])


def test_sweeps_equal_jax_on_every_alike_block(tmp_path):
    """Lines carrying each alike block, valid and mutated, an advisory
    error and a pre-schema version: the same counts and problems; a torn
    MULTICHIP record is one problem in both."""
    lines = []
    for name in ALIKE:
        schema = art.BY_NAME[name]
        if not schema.block_path or "." in schema.block_path:
            continue
        for label, _path, block in mutations(name):
            lines.append({"metric": f"knn_qps_{name}", "value": 1.0,
                          schema.block_path: block, "_source": label})
        if schema.version_exact:
            old = {**VALID[name], schema.version_field: 0}
            lines.append({"metric": "knn_qps_old", schema.block_path: old})
    lines.append({"metric": 5, "value": "x"})
    for style in STYLES:
        got = art.sweep_records(lines, style=style)
        assert got == jart.sweep_records(lines, style=style)
    counts, problems = got
    on_lines = [n for n in ALIKE if art.BY_NAME[n].block_path
                and "." not in art.BY_NAME[n].block_path]
    assert problems and all(counts[n]["validated"] for n in on_lines)
    assert len(on_lines) == 10
    assert sum(c["version_exempt"] for c in counts.values()) > 3
    (tmp_path / "MULTICHIP_r01.json").write_text(
        json.dumps(VALID["multichip_record"]))
    (tmp_path / "MULTICHIP_r02.json").write_text("{torn")
    (tmp_path / "MULTICHIP_r03.json").write_text(json.dumps({"rc": "x"}))
    n, probs = art.sweep_multichip(str(tmp_path))
    assert (n, probs) == jart.sweep_multichip(str(tmp_path))
    assert n == 2 and len(probs) > 2


def test_block_for_bench_line_is_the_h100_attribution():
    """A port-shaped line (``bench.py``'s line shape, the port's knobs)
    is priced as ``attribute(pallas_cost_model(...), value)`` on the same
    inputs; ``exact`` / ``certified_approx`` through the counted model;
    no ``block_q``; None where the reference gives None."""
    knobs = {"tile_n": 16384, "precision": "bf16x3", "bin_w": 128,
             "survivors": 2, "final_select": "exact", "binning": "grouped",
             "final_recall_target": None, "grid_order": "query_major",
             "kernel": "tiled"}
    line = {"metric": "knn_qps_main_n1000000_d128_k100", "value": 61234.5,
            "mode": "certified_pallas", "backend": "cuda",
            "device_kind": roofline.H100, "pallas_knobs": knobs,
            "batch": 4096}
    want = roofline.attribute(roofline.pallas_cost_model(
        n=1_000_000, d=128, k=100, nq=4096, precision="bf16x3",
        kernel="tiled", grid_order="query_major", binning="grouped",
        tile_n=16384, survivors=2, bin_w=128, device_kind=roofline.H100,
        backend="cuda"), 61234.5)
    assert roofline.block_for_bench_line(line) == want
    assert want["estimated"] is False
    assert roofline.block_for_bench_line(
        {**line, "pallas_knobs": {**knobs, "block_q": 512}}) == want
    assert roofline.block_for_bench_line(
        {**line, "device_phase_qps": 70000.0})["measured_qps"] == 70000.0
    exact = {**line, "mode": "exact", "compute_dtype": "bfloat16"}
    assert roofline.block_for_bench_line(exact) == roofline.attribute(
        roofline.counted_cost_model(
            n=1_000_000, d=128, k=100, nq=4096, selector="exact",
            dtype="bfloat16", device_kind=roofline.H100, backend="cuda"),
        61234.5)
    approx = roofline.block_for_bench_line({**line,
                                            "mode": "certified_approx"})
    assert approx["selector"] == "approx"
    tpu = roofline.block_for_bench_line({**line, "device_kind": "TPU v5 lite",
                                         "backend": "tpu"})
    assert tpu["estimated"] is True
    assert tpu["peaks"] == roofline.GENERIC_CPU_PEAKS
    for bad in ({**line, "mode": "campaign_rehearse"},
                {**line, "metric": "knn_qps_main"},
                {**line, "pallas_knobs": {"precision": "f64"}},
                {**line, "mode": "exact", "compute_dtype": "int2"}):
        assert roofline.block_for_bench_line(bad) is None
    assert roofline._METRIC_RE.pattern == __import__(
        "knn_tpu.obs.roofline", fromlist=["_METRIC_RE"])._METRIC_RE.pattern


# --- the artifact-lockstep checker, invariants 3 and 4 armed ----------------
def test_lint_green_with_the_refresher_and_sentinel_armed():
    import os

    from knn_tpu_torch import analysis
    from knn_tpu_torch.analysis import check_artifacts as ca

    for rel in (ca._REFRESHER_REL, ca._SENTINEL_REL):
        assert os.path.exists(os.path.join(REPO, rel)), rel
    rep = analysis.run(REPO, names=["artifact-lockstep"])
    assert rep.ok, [f.message for f in rep.findings]


def _lockstep(tmp_path, files):
    import os
    import textwrap

    from knn_tpu_torch import analysis

    for rel, text in files.items():
        path = os.path.join(tmp_path, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(textwrap.dedent(text))
    return analysis.run(str(tmp_path), names=["artifact-lockstep"]).findings


def test_sentinel_hand_list_missing_a_field_goes_red(tmp_path):
    fields = [f for f, _ in art.curated_fields()]
    hand = ", ".join(repr(f) for f in fields if f != "knee_qps")
    findings = _lockstep(tmp_path, {
        "knn_tpu_torch/obs/sentinel.py":
            f"CURATED_FIELDS = ({hand},)\n"})
    assert [(f.path, f.symbol) for f in findings] == [
        ("knn_tpu_torch/obs/sentinel.py", "knee_qps")]
    full = ", ".join(repr(f) for f in fields)
    assert _lockstep(tmp_path, {
        "knn_tpu_torch/obs/sentinel.py": f"CURATED_FIELDS = ({full},)\n"}) \
        == []


def test_refresher_dropping_a_hoist_goes_red(tmp_path):
    hoists = sorted({h.dst for s in art.CATALOG for h in s.hoists
                     if h.refresher})
    kept = [h for h in hoists if h != "multihost_merge"]
    findings = _lockstep(tmp_path, {
        "knn_tpu_torch/scripts/refresh_bench_artifacts.py":
            f"HOISTED = {kept!r}\n"})
    assert [(f.path, f.symbol) for f in findings] == [
        ("knn_tpu_torch/scripts/refresh_bench_artifacts.py",
         "multihost_merge")]
    # a refresher that curates through the catalog performs every hoist
    assert _lockstep(tmp_path, {
        "knn_tpu_torch/scripts/refresh_bench_artifacts.py":
            "from knn_tpu_torch.analysis import artifacts\n"
            "artifacts.curate_line({})\n"}) == []


def test_chip_smoke_bench_line_checks_on_a_cpu_call():
    """chip_smoke's catalog checks of the main call's bench line, run here
    on a small CPU call's resolved knobs under the card's kind (the
    record's shape is the checks' input, not the device): they pass and
    report the block's bound, and a record the block does not price
    fails them; the history sweep gives the pinned counts."""
    import chip_smoke
    from knn_tpu_torch.parallel.sharded import ShardedKNN

    rng = np.random.default_rng(5)
    db = (rng.random((3000, 16)) * 50).astype(np.float32)
    q = (rng.random((64, 16)) * 50).astype(np.float32)
    _, _, st = ShardedKNN(db, k=10, device="cpu").search_certified(q)
    block = roofline.attribute(roofline.pallas_cost_model(
        n=3000, d=16, k=10, nq=64, device_kind=roofline.H100), 1234.5)
    record = chip_smoke.bench_line_record(
        n=3000, dim=16, k=10, n_q=64, qps=1234.5, knobs=st["pallas_knobs"],
        kind=roofline.H100, recall=1.0, commit=None)
    assert record["metric"] == "knn_qps_main_n3000_d16_k10"
    out = chip_smoke.bench_line_checks(record, block)
    assert out["bound_s"] == max(block["term_times_s"].values())
    assert out["sentinel"] == "no_baseline"
    assert out["baseline_key"] == "knn_qps_main_n3000_d16_k10|cuda|default"
    assert out["sentinel_fields"] == ["recall_at_k", "value"]
    assert out["line_summary"].startswith(" roofline=")
    with pytest.raises(AssertionError, match="block_for_bench_line"):
        chip_smoke.bench_line_checks(dict(record, batch=128), block)
    assert chip_smoke.history_sweep() == {
        "validated": chip_smoke.HISTORY_SWEEP,
        "multichip_records": chip_smoke.HISTORY_MULTICHIP}
