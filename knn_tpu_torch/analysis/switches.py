"""The env-switch catalog, recast for a package that reads no switch —
the port's copy of knn_tpu/analysis/switches.py.

The JAX package reads ~100 ``KNN_TPU_*`` / ``KNN_BENCH_*`` environment
switches and declares each one here.  The port reads none: every knob is
an argument (ROADMAP ground rule "Env switches").  So each row keeps the
JAX package's name, kind and description and gains a ``port`` field: the
argument that stands in for the switch, with its ROADMAP divergence
number, or ``not ported:`` and why.  The ``switch-lockstep`` checker
(knn_tpu_torch.analysis.check_switches) holds the port to it:

1. a switch-shaped string literal in port CODE is a finding (the port
   reads no switch);
2. a switch-shaped token in a port docstring names a cataloged row (it
   names the JAX switch an argument replaces);
3. every row names its ``port`` counterpart;
4. the README's port section, the verify skill's port section and
   ``PERF.md`` hold no switch token.

There is no ``isolation_names``: the port's tests need no environment
scrub, because the port reads no switch.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Iterable, Optional, Tuple

#: the shape every switch name (and family prefix) must have; the
#: checker also uses it to find switch-shaped literals in source
SWITCH_RE = re.compile(r"^KNN_(TPU|BENCH)_[A-Z0-9_]*$")


@dataclasses.dataclass(frozen=True)
class Switch:
    """One JAX switch and what stands in for it in the port.

    ``port`` names the argument that replaces the switch (with its
    ROADMAP divergence number), or starts with ``not ported:`` and says
    why.  ``family=True`` declares a PREFIX (name ends with ``_``);
    ``reserved=True`` marks a family the JAX package holds for isolation
    only."""

    name: str
    kind: str  # "flag" | "int" | "float" | "str" | "path" | "spec"
    description: str
    port: str
    family: bool = False
    reserved: bool = False


def _s(name, kind, description, port, **kw) -> Switch:
    return Switch(name, kind, description, port, **kw)


_BENCH = ("not ported: a knob of the JAX package's bench.py; the port's "
          "benchmark (ROADMAP queue A item 1) is not written yet, and its "
          "knobs will be arguments")
SWITCHES: Tuple[Switch, ...] = (
    # --- root namespaces -------------------------------------------------
    _s("KNN_TPU_", "family",
       "Root library-switch namespace: the flight recorder captures "
       "every member into postmortem bundles, and conftest scrubs any "
       "ambient member before the suite runs.",
       "not ported: the port reads no switch, so it has no namespace to "
       "capture or scrub; a bundle's env holds the obs arguments "
       "(divergence 41)", family=True, reserved=True),
    _s("KNN_BENCH_", "family",
       "Root bench-switch namespace (same capture/scrub contract).",
       _BENCH, family=True, reserved=True),
    # --- telemetry / obs -------------------------------------------------
    _s("KNN_TPU_OBS", "flag",
       "0/false/off disables the telemetry subsystem (default on).",
       "obs.reset(enabled=) (divergence 34)"),
    _s("KNN_TPU_OBS_LOG", "path",
       "JSONL sink for structured events (spans, alerts).",
       "obs.reset_event_log(path=) (divergence 34)"),
    _s("KNN_TPU_OBS_LOG_MAX_BYTES", "int",
       "Rotation cap for the JSONL sink (default 64 MiB).",
       "obs.reset_event_log(max_bytes=) (divergence 34)"),
    _s("KNN_TPU_SLO_CONFIG", "path",
       "JSON objective list replacing the default SLOs.",
       "slo.load_objectives(path) with obs.reset_slo_engine(objectives=) "
       "(divergence 38)"),
    _s("KNN_TPU_PROFILE_DIR", "path",
       "Ambient device-trace gate: bench/tune winners capture one "
       "jax.profiler.trace run here.",
       "obs.profiler.device_trace(section, out_dir=) (divergence 34)"),
    _s("KNN_TPU_POSTMORTEM_DIR", "path",
       "Arms the flight recorder: one postmortem bundle per "
       "edge-triggered SLO breach.",
       "blackbox.configure(postmortem_dir=) (divergence 40)"),
    _s("KNN_TPU_POSTMORTEM_KEEP", "int",
       "Postmortem bundle retention cap (default 8).",
       "blackbox.configure(keep=) (divergence 40)"),
    _s("KNN_TPU_OBS_EXEMPLAR_CAP", "int",
       "Worst-recent exemplars retained per histogram series "
       "(default 8; 0 disables retention).",
       "obs.reset(exemplar_cap=) (divergence 34)"),
    _s("KNN_TPU_OBS_EXEMPLAR_AGE_S", "float",
       "Exemplar age-out horizon in seconds (default 600).",
       "obs.reset(exemplar_age_s=) (divergence 34)"),
    # --- fleet observability plane ---------------------------------------
    _s("KNN_TPU_FLEET_MEMBERS", "spec",
       "Comma/space-separated host:port list of fleet member metric "
       "endpoints the aggregator collects /metrics.json + /statusz "
       "from (/fleetz, cli fleet); unset = fleet plane unconfigured.",
       "fleet.configure(members=) (divergence 44)"),
    _s("KNN_TPU_FLEET_STALE_S", "float",
       "Staleness refusal threshold (seconds, default 120): a member "
       "snapshot older than the newest by more than this is refused "
       "as a different collection round and listed loudly under "
       "unreachable instead of silently understating the merge.",
       "fleet.configure(stale_s=) (divergence 44)"),
    # --- shadow audit sampler --------------------------------------------
    _s("KNN_TPU_AUDIT_RATE", "float",
       "Fraction of live requests the shadow audit sampler replays "
       "against the f64 exact oracle, selected deterministically by "
       "trace-id hash (unset/0 = off; KNN_TPU_OBS=0 pins it off).",
       "audit.reset_auditor(rate=) (divergence 39)"),
    _s("KNN_TPU_AUDIT_BUDGET_ROWS_S", "float",
       "Hard oracle row budget for audit replays (rows/second "
       "token bucket, default 5e6); over-budget records are dropped "
       "and counted.",
       "audit.reset_auditor(budget_rows_s=) (divergence 39)"),
    # --- measured-term calibration ---------------------------------------
    _s("KNN_TPU_CALIBRATION", "path",
       "Calibration store JSON: per-term roofline scale factors "
       "reconciled from measured device time (atomic writes, "
       "model-version-token keys); unset = analytic model only.",
       "calibrate.configure(store=) (divergence 43)"),
    # --- measured-ceiling campaign ---------------------------------------
    _s("KNN_TPU_CAMPAIGN_", "family",
       "Measured-ceiling campaign knob family (cli campaign); "
       "namespace scrubbed by conftest.",
       "run_campaign(...) arguments and cli campaign flags "
       "(divergence 45)", family=True, reserved=True),
    _s("KNN_TPU_CAMPAIGN_DIR", "path",
       "Campaign artifact directory (one validated JSONL per arm; "
       "default artifacts/campaign).",
       "run_campaign(out_dir=), cli campaign --out (divergence 45)"),
    _s("KNN_TPU_CAMPAIGN_ARMS", "spec",
       "Comma list of campaign arms to run (bf16x3_tiled, "
       "bf16x3_streaming, int8_streaming, int8_fused).",
       "run_campaign(arms=), cli campaign --arms (divergence 45)"),
    _s("KNN_TPU_CAMPAIGN_ROUND", "int",
       "Measurement-round stamp carried into campaign artifact "
       "provenance.",
       "run_campaign(round_no=), cli campaign --round (divergence 45)"),
    # --- tuning ----------------------------------------------------------
    _s("KNN_TPU_TUNE_CACHE", "path",
       "Autotuner winner-cache file (default "
       "~/.cache/knn_tpu/autotune.json).",
       "search_certified(tune_cache=) and autotune(cache_path=); the "
       "default file is ~/.cache/knn_tpu_torch/autotune.json "
       "(divergence 20's tuner)"),
    _s("KNN_TPU_TUNE_PRUNE", "float",
       "Roofline-model candidate-pruning fraction in (0, 1]; unset = "
       "exhaustive search.",
       "autotune(prune=) (divergence 34)"),
    # --- certified pipeline overlap --------------------------------------
    _s("KNN_TPU_PIPELINE_OVERLAP", "flag",
       "1 runs search_certified as the two-stage coarse/rescore "
       "pipeline (bitwise-identical results).",
       "search_certified(overlap=) (divergence 6)"),
    _s("KNN_TPU_PIPELINE_DEPTH", "int",
       "Bounded in-flight batch depth of the pipelined path "
       "(default 2).",
       "search_certified(overlap_depth=) (divergence 6)"),
    # --- multi-host merge tree -------------------------------------------
    _s("KNN_TPU_MERGE", "str",
       "Override the measured ring/allgather crossover for the "
       "flat / per-host ICI merge level (explicit caller arg still "
       "wins; malformed values raise).",
       "ShardedKNN(merge=) (divergence 56)"),
    _s("KNN_TPU_DCN_MERGE", "str",
       "Same override for the cross-host DCN merge level of "
       "hierarchical placements.",
       "ShardedKNN(dcn_merge=) (divergence 56)"),
    # --- host-RAM shard tier ---------------------------------------------
    _s("KNN_TPU_HOSTTIER_BUDGET_BYTES", "int",
       "Per-host HBM byte budget: a corpus placing past it serves "
       "from host RAM, streamed segment-by-segment (unset = "
       "unbounded, everything resident).",
       "ShardedKNN(hbm_budget_bytes=) (divergence 35)"),
    _s("KNN_TPU_HOSTTIER_DEPTH", "int",
       "Bounded in-flight sweep depth of the host-RAM tier's "
       "dispatch-ahead stream (default 2).",
       "ShardedKNN(hosttier_depth=) (divergence 35)"),
    # --- PQ compressed tier ----------------------------------------------
    _s("KNN_TPU_PQ_DSUB", "int",
       "Dims per PQ subspace for the precision=\"pq\" placement "
       "(default 4); row code bytes = ceil(dim / dsub).",
       "search_certified(pq_dsub=) (divergence 15)"),
    _s("KNN_TPU_PQ_NCODES", "int",
       "Codebook size per PQ subspace (default 256, one uint8 "
       "code); larger books shrink the certified bound but widen the "
       "per-query LUT.",
       "search_certified(pq_ncodes=) (divergence 15)"),
    # --- mutable index ---------------------------------------------------
    _s("KNN_TPU_DELTA_MIN_ROWS", "int",
       "Smallest delta-tail capacity ladder rung (rows, "
       "default 256); the tail re-places within a rung without "
       "recompiling.",
       "MutableIndex(delta_min_rows=) (divergence 23)"),
    _s("KNN_TPU_DELTA_MAX_ROWS", "int",
       "Top delta-tail ladder rung: insert refuses loudly past "
       "it until compaction folds the tail in (default 65536).",
       "MutableIndex(delta_max_rows=) (divergence 23)"),
    _s("KNN_TPU_DELTA_RESERVE", "int",
       "Certify-widening reserve: searches select k + reserve "
       "so up to this many tombstones can be masked exactly "
       "(default 32); delete refuses past it.",
       "MutableIndex(reserve=) (divergence 23)"),
    _s("KNN_TPU_COMPACT_TAIL_ROWS", "int",
       "Auto-compaction threshold on delta-tail rows (unset = "
       "manual/interval compaction only).",
       "MutableIndex(compact_tail_rows=) (divergence 23)"),
    _s("KNN_TPU_COMPACT_TOMBSTONES", "int",
       "Auto-compaction threshold on pending tombstones "
       "(unset = manual/interval compaction only).",
       "MutableIndex(compact_tombstones=) (divergence 23)"),
    _s("KNN_TPU_COMPACT_INTERVAL_S", "float",
       "Background compactor period: fold pending writes in every "
       "this-many seconds even below the thresholds (unset = "
       "threshold-triggered only).",
       "MutableIndex.start_compactor(interval_s=) (divergence 23)"),
    # --- IVF tier --------------------------------------------------------
    _s("KNN_TPU_IVF_", "family",
       "IVF-tier knob family (coarse quantizer + probe defaults); any "
       "ambient member is scrubbed by conftest.",
       "IVFIndex(...) arguments (divergence 23)", family=True),
    _s("KNN_TPU_IVF_NCENTROIDS", "int",
       "Default k-means list count of an IVFIndex (unset = "
       "round(sqrt(n))).",
       "IVFIndex(ncentroids=) (divergence 23)"),
    _s("KNN_TPU_IVF_NPROBE", "int",
       "Default probed-list count per query (unset = ncentroids/4); "
       "nprobe = ncentroids reproduces exact brute force bitwise.",
       "IVFIndex(nprobe=) (divergence 23)"),
    _s("KNN_TPU_IVF_TRAIN_ITERS", "int",
       "Lloyd iterations of the seeded coarse-quantizer training "
       "(default 5).",
       "IVFIndex(train_iters=) (divergence 23)"),
    _s("KNN_TPU_IVF_SEED", "int",
       "Deterministic k-means init seed (default 0); same seed + data "
       "=> same placement.",
       "IVFIndex(seed=) (divergence 23)"),
    # --- bulk kNN-join engine --------------------------------------------
    _s("KNN_TPU_JOIN_", "family",
       "Bulk kNN-join knob family (superblock sizing + dispatch "
       "depth); any ambient member is scrubbed by conftest.",
       "knn_join(...) arguments (divergence 23)", family=True),
    _s("KNN_TPU_JOIN_SUPERBLOCK", "int",
       "Query superblock rows of knn_join (unset = the h2d "
       "staging-budget model, else 4096); explicit call args win.",
       "knn_join(superblock_rows=) (divergence 23)"),
    _s("KNN_TPU_JOIN_DEPTH", "int",
       "Bounded dispatch-ahead depth of the double-buffered query "
       "stream (default 2; 1 disables the overlap).",
       "knn_join(depth=) (divergence 23)"),
    _s("KNN_TPU_JOIN_QUERY_BUDGET_BYTES", "int",
       "Host->device staging budget the superblock resolution sizes "
       "against (analysis.hbm.plan_superblocks).",
       "knn_join(query_budget_bytes=) (divergence 23)"),
    # --- admission control -----------------------------------------------
    _s("KNN_TPU_ADMISSION_", "family",
       "Admission-control knob family (ANY set member is an "
       "opt-in; a typo'd member raises).",
       "AdmissionConfig(...) fields; there is no from_env "
       "(divergence 29)", family=True),
    _s("KNN_TPU_ADMISSION_MAX_DEPTH", "int",
       "Bounded outstanding-work depth (explicit rejection past it).",
       "AdmissionConfig(max_depth=) (divergence 29)"),
    _s("KNN_TPU_ADMISSION_SHED", "flag",
       "Deadline-aware load shedding at submit and dispatch.",
       "AdmissionConfig(shed=) (divergence 29)"),
    _s("KNN_TPU_ADMISSION_DEFAULT_DEADLINE_MS", "float",
       "Deadline applied to requests that don't carry one.",
       "AdmissionConfig(default_deadline_ms=) (divergence 29)"),
    _s("KNN_TPU_ADMISSION_QUOTAS", "spec",
       "Per-tenant token-bucket quotas, tenant:rate[:burst],...",
       "AdmissionConfig(quotas=) (divergence 29)"),
    _s("KNN_TPU_ADMISSION_PRIORITIES", "spec",
       "Per-tenant dispatch priorities, tenant:level,...",
       "AdmissionConfig(priorities=) (divergence 29)"),
    _s("KNN_TPU_ADMISSION_AGING_MS", "float",
       "Priority aging constant (starvation safety).",
       "AdmissionConfig(aging_s=), in seconds (divergence 29)"),
    # --- loadgen ---------------------------------------------------------
    _s("KNN_TPU_LOADGEN_", "family",
       "Reserved loadgen namespace — scrubbed by conftest so future "
       "knobs are isolated from day one.",
       "not ported: a reserved namespace with no member; the port's "
       "loadgen takes its knobs as arguments and cli loadgen flags",
       family=True, reserved=True),
    # --- bench.py: problem shape & run shape -----------------------------
    _s("KNN_BENCH_CONFIG", "str",
       "Named benchmark config: sift1m (default) | glove | gist1m.",
       _BENCH),
    _s("KNN_BENCH_MODES", "spec",
       "Comma list of modes to run (exact, certified_approx, "
       "certified_pallas, serving, knee, multihost, mutation, ivf, "
       "join).", _BENCH),
    _s("KNN_BENCH_MULTIHOST_HOSTS", "int",
       "Host-axis size of the multihost mode's hierarchical mesh "
       "(default 2).", _BENCH),
    _s("KNN_BENCH_MULTIHOST_SWEEPS", "int",
       "Target host-RAM tier sweep count of the multihost mode's "
       "budget-forced stream (default 4).", _BENCH),
    _s("KNN_BENCH_RUNS", "int", "Timed repetitions per mode (default 5).",
       _BENCH),
    _s("KNN_BENCH_N", "int", "Database rows.", _BENCH),
    _s("KNN_BENCH_DIM", "int", "Feature dim.", _BENCH),
    _s("KNN_BENCH_K", "int", "Neighbor count.", _BENCH),
    _s("KNN_BENCH_METRIC", "str",
       "Distance metric of the synthetic config.", _BENCH),
    _s("KNN_BENCH_NQ", "int", "Query count.", _BENCH),
    _s("KNN_BENCH_BATCH", "int", "Queries per device step.", _BENCH),
    _s("KNN_BENCH_TILE", "int",
       "HBM train-tile rows for the streamed distance matrix.", _BENCH),
    _s("KNN_BENCH_CPU_QUERIES", "int",
       "Query count of the CPU-oracle pass.", _BENCH),
    _s("KNN_BENCH_MARGIN", "int", "Certified-mode candidate margin.",
       _BENCH),
    _s("KNN_BENCH_DTYPE", "str",
       "Placement compute dtype (bfloat16 | float32).", _BENCH),
    # --- bench.py: environment/bring-up ----------------------------------
    _s("KNN_BENCH_PLATFORM", "str",
       "Force a JAX platform (e.g. cpu) instead of auto-detect.", _BENCH),
    _s("KNN_BENCH_PEAK_FLOPS", "float",
       "Override the per-chip peak FLOP/s used for MFU.", _BENCH),
    _s("KNN_BENCH_INIT_TIMEOUT", "int",
       "Seconds before backend init is declared hung (default 480).",
       _BENCH),
    _s("KNN_BENCH_INIT_ATTEMPTS", "int", "Backend-init retry attempts.",
       _BENCH),
    _s("KNN_BENCH_INIT_WAIT", "int",
       "Seconds between backend-init retries.", _BENCH),
    _s("KNN_BENCH_FALLBACK_CPU", "flag",
       "Run on CPU when accelerator init fails (default on).", _BENCH),
    _s("KNN_BENCH_CPU_CACHE", "flag",
       "0 forces a fresh CPU-oracle measurement instead of the cached "
       "one.", _BENCH),
    _s("KNN_BENCH_GATE", "flag",
       "0 skips the exactness gate on huge dims.", _BENCH),
    _s("KNN_BENCH_VERBOSE", "flag", "1 prints stage progress on stderr.",
       _BENCH),
    _s("KNN_BENCH_TRACE", "path",
       "Write a jax.profiler trace of one extra per-mode run here.",
       _BENCH),
    _s("KNN_BENCH_TUNE_CACHE", "path",
       "Autotuner cache the bench resolves knobs through.", _BENCH),
    _s("KNN_BENCH_OBS_OVERHEAD", "flag",
       "1 A/Bs the serving sweep with telemetry off/on and emits "
       "obs_overhead_pct.", _BENCH),
    # --- bench.py: XLA-selector knobs ------------------------------------
    _s("KNN_BENCH_APPROX_RT", "float",
       "ApproxTopK recall target of the certified_approx mode.", _BENCH),
    _s("KNN_BENCH_APPROX_MARGIN", "int",
       "Margin override of the certified_approx mode.", _BENCH),
    # --- bench.py: pallas knob overrides ---------------------------------
    _s("KNN_BENCH_PALLAS_", "family",
       "Pallas knob-override family; unset members resolve through the "
       "autotuner cache.", _BENCH, family=True),
    _s("KNN_BENCH_PALLAS_PRECISION", "str",
       "Kernel matmul precision (bf16x3 | bf16x3f | int8 | highest).",
       _BENCH),
    _s("KNN_BENCH_PALLAS_TILE", "int", "Kernel db tile rows (tile_n).",
       _BENCH),
    _s("KNN_BENCH_PALLAS_BIN_W", "int", "Kernel bin width.", _BENCH),
    _s("KNN_BENCH_PALLAS_SURVIVORS", "int", "Per-bin survivor count.",
       _BENCH),
    _s("KNN_BENCH_PALLAS_BLOCK_Q", "int", "Query block rows (block_q).",
       _BENCH),
    _s("KNN_BENCH_PALLAS_FINAL", "str", "Final select: exact | approx.",
       _BENCH),
    _s("KNN_BENCH_PALLAS_FINAL_RT", "float",
       "Approx final-select recall target.", _BENCH),
    _s("KNN_BENCH_PALLAS_BINNING", "str",
       "Binning strategy: grouped | lane.", _BENCH),
    _s("KNN_BENCH_PALLAS_GRID", "str",
       "Grid order: query_major | db_major.", _BENCH),
    _s("KNN_BENCH_PALLAS_KERNEL", "str",
       "Db-streaming strategy: tiled | streaming | fused.", _BENCH),
    _s("KNN_BENCH_PALLAS_BATCH", "int",
       "Queries per kernel launch in the pallas mode.", _BENCH),
    # --- bench.py: serving sweep -----------------------------------------
    _s("KNN_BENCH_SERVING_REQUESTS", "int",
       "Replayed request count of the serving mode.", _BENCH),
    _s("KNN_BENCH_SERVING_DEPTH", "int",
       "Dispatch-ahead depth of the serving mode.", _BENCH),
    _s("KNN_BENCH_SERVING_MIN_BUCKET", "int",
       "Smallest bucket rung of the serving mode's ladder.", _BENCH),
    # --- bench.py: mutation sweep ----------------------------------------
    _s("KNN_BENCH_MUTATION_", "family",
       "Mutation-sweep knob family of the opt-in mutation mode.", _BENCH,
       family=True),
    _s("KNN_BENCH_MUTATION_RATE", "float",
       "Offered request rate (req/s) of the mixed read+write "
       "scenario.", _BENCH),
    _s("KNN_BENCH_MUTATION_SECONDS", "float",
       "Duration of the mixed-traffic run.", _BENCH),
    _s("KNN_BENCH_MUTATION_WRITE_FRACTION", "float",
       "Fraction of scheduled requests that are writes "
       "(split between inserts and deletes).", _BENCH),
    # --- bench.py: knee sweep --------------------------------------------
    _s("KNN_BENCH_KNEE_", "family",
       "Knee-sweep knob family of the opt-in knee mode.", _BENCH,
       family=True),
    _s("KNN_BENCH_KNEE_RATES", "spec",
       "Offered-rate ladder, comma-separated q/s.", _BENCH),
    _s("KNN_BENCH_KNEE_STEP_S", "float", "Seconds per rate step.", _BENCH),
    _s("KNN_BENCH_KNEE_SLO_MS", "float",
       "Admitted-p99 bound defining the knee.", _BENCH),
    _s("KNN_BENCH_KNEE_TENANTS", "spec",
       "Tenant mix spec, name[:weight[:priority]],...", _BENCH),
    _s("KNN_BENCH_KNEE_SEED", "int", "Workload-schedule seed.", _BENCH),
    # --- bench.py: bulk kNN-join sweep -----------------------------------
    _s("KNN_BENCH_JOIN_", "family",
       "Join-sweep knob family of the opt-in join mode.", _BENCH,
       family=True),
    _s("KNN_BENCH_JOIN_ROWS", "int",
       "Query rows of the join line's host-resident set A (0 = sized "
       "from NQ/BATCH).", _BENCH),
    _s("KNN_BENCH_JOIN_SUPERBLOCK", "int",
       "Superblock rows of the join sweep (0 = the engine's "
       "resolution ladder).", _BENCH),
    _s("KNN_BENCH_JOIN_DEPTH", "int",
       "Dispatch-ahead depth of the join sweep (default 2).", _BENCH),
    # --- bench.py: shadow-audit replay -----------------------------------
    _s("KNN_BENCH_QUALITY_REQUESTS", "int",
       "Serving requests of the opt-in quality mode's shadow-audit "
       "replay (default 8; each pays one full f64 oracle scan).", _BENCH),
)

#: name -> Switch for exact lookups
BY_NAME: Dict[str, Switch] = {s.name: s for s in SWITCHES}

#: declared family prefixes (names ending in ``_``)
FAMILY_PREFIXES: Tuple[str, ...] = tuple(
    s.name for s in SWITCHES if s.family)


def _validate() -> None:
    for s in SWITCHES:
        if not SWITCH_RE.match(s.name):
            raise ValueError(f"switch {s.name!r} does not match "
                             f"{SWITCH_RE.pattern}")
        if s.family != s.name.endswith("_"):
            raise ValueError(
                f"switch {s.name!r}: family declarations (and only "
                f"those) must end with '_'")
    if len(BY_NAME) != len(SWITCHES):
        raise ValueError("duplicate switch declarations")


_validate()


def lookup(token: str) -> Optional[Switch]:
    """The declaration covering ``token``: an exact catalog row, or the
    family row when ``token`` IS a declared prefix.  A concrete member
    of a family must still be declared individually — the family only
    legitimizes the prefix itself, never an undeclared concrete
    switch."""
    hit = BY_NAME.get(token)
    if hit is not None:
        return hit
    if token.endswith("_") and token in FAMILY_PREFIXES:
        return BY_NAME[token]
    return None


def tokens_in_source(text: str) -> Iterable[str]:
    """Every switch-shaped token in ``text``."""
    return re.findall(r"\bKNN_(?:TPU|BENCH)_[A-Z0-9_]*\b", text)
