"""The metric catalog — the one home of every metric name the port's
registry may hand out, copied name for name from knn_tpu/obs/names.py so
that a snapshot of either package compares with the other's by name.

Every metric the registry can register is declared here with its type,
label names and help string, and the registry refuses any name outside
this catalog (knn_tpu_torch.obs.registry).  Names follow the Prometheus
conventions the exporters assume: a ``knn_tpu_`` prefix, ``_total`` on
counters, ``_seconds`` on times, base units throughout.

:func:`catalog_version` digests the catalog's (name, kind, labels)
triples into a short token; it equals the JAX package's, since the two
catalogs hold the same triples (help strings do not move it).

Names this package never writes (they stay in the catalog so the two
catalogs stay one, and :data:`UNWRITTEN` lists them): ``JAX_COMPILES`` /
``JAX_COMPILE_SECONDS`` (there is no XLA here; a CUDA graph capture counts
under ``SERVING_COMPILES``) and the ``MERGE_*`` names (multi-GPU, ROADMAP
queue A item 6).  The SLO engine, the flight recorder, the audit sampler
and the drift monitor write ``SLO_*``, ``POSTMORTEMS_WRITTEN``,
``AUDIT_*``, ``DRIFT_*`` and ``INDEX_LIST_IMBALANCE`` /
``INDEX_TAIL_FRACTION`` / ``INDEX_TOMBSTONE_DENSITY``; the calibration
overlay, the campaign and the fleet plane write ``CALIBRATION_*``,
``CAMPAIGN_*`` and ``FLEET_*``.
"""

from __future__ import annotations

import hashlib
from functools import lru_cache


@lru_cache(maxsize=1)
def catalog_version() -> str:
    """A 12-hex digest of every (name, kind, labels) triple in the
    catalog — help-string edits don't move it, but adding/removing a
    metric or changing its kind/labels does."""
    h = hashlib.sha256()
    for name in sorted(CATALOG):
        kind, labels, _help = CATALOG[name]
        h.update(f"{name}|{kind}|{','.join(sorted(labels))}\n".encode())
    return h.hexdigest()[:12]

# --- serving engine (knn_tpu_torch.serving.engine) ---------------------------
SERVING_REQUESTS = "knn_tpu_serving_requests_total"
SERVING_QUERIES = "knn_tpu_serving_queries_total"
SERVING_ERRORS = "knn_tpu_serving_errors_total"
SERVING_DISPATCHES = "knn_tpu_serving_dispatches_total"
SERVING_COMPILES = "knn_tpu_serving_compiles_total"
SERVING_REQUEST_LATENCY = "knn_tpu_serving_request_latency_seconds"

# --- micro-batching queue (knn_tpu_torch.serving.queue) ----------------------
QUEUE_DEPTH_REQUESTS = "knn_tpu_queue_depth_requests"
QUEUE_DEPTH_ROWS = "knn_tpu_queue_depth_rows"
QUEUE_REQUESTS = "knn_tpu_queue_requests_total"
QUEUE_DISPATCHES = "knn_tpu_queue_dispatches_total"
QUEUE_COALESCED_ROWS = "knn_tpu_queue_coalesced_rows_total"
QUEUE_ERRORS = "knn_tpu_queue_errors_total"
QUEUE_WAIT = "knn_tpu_queue_wait_seconds"
QUEUE_REQUEST_LATENCY = "knn_tpu_queue_request_latency_seconds"

# --- admission control (knn_tpu_torch.serving.admission / queue) -------------
ADMISSION_ADMITTED = "knn_tpu_admission_admitted_total"
ADMISSION_REJECTED = "knn_tpu_admission_rejected_total"
ADMISSION_SHED = "knn_tpu_admission_shed_total"
ADMISSION_WAIT_ESTIMATE = "knn_tpu_admission_queue_wait_estimate_seconds"

# --- per-tenant serving attribution (knn_tpu_torch.serving) ------------------
TENANT_REQUESTS = "knn_tpu_tenant_requests_total"
TENANT_ERRORS = "knn_tpu_tenant_errors_total"
TENANT_REQUEST_LATENCY = "knn_tpu_tenant_request_latency_seconds"

# --- certified search (knn_tpu_torch.parallel.sharded) -----------------------
CERTIFIED_QUERIES = "knn_tpu_certified_queries_total"
CERTIFIED_FALLBACKS = "knn_tpu_certified_fallback_queries_total"
CERTIFIED_GENUINE_MISSES = "knn_tpu_certified_fallback_genuine_misses_total"
CERTIFIED_FALSE_ALARMS = "knn_tpu_certified_fallback_false_alarms_total"
CERTIFIED_HOST_EXACT = "knn_tpu_certified_host_exact_queries_total"
CERTIFIED_RANK_CORRECTED = "knn_tpu_certified_rank_corrected_queries_total"
CERTIFIED_QUANT_BOUND = "knn_tpu_certified_quant_bound"

# --- autotuner (knn_tpu_torch.tuning) ----------------------------------------
TUNING_RESOLVES = "knn_tpu_tuning_resolve_total"
TUNING_CACHE_HITS = "knn_tpu_tuning_cache_hits_total"
TUNING_CACHE_MISSES = "knn_tpu_tuning_cache_misses_total"
TUNING_SEARCHES = "knn_tpu_tuning_searches_total"
TUNING_CANDIDATES_TIMED = "knn_tpu_tuning_candidates_timed_total"
TUNING_GATE_FAILURES = "knn_tpu_tuning_gate_failures_total"
TUNING_CANDIDATES_PRUNED = "knn_tpu_tuning_candidates_pruned_total"
TUNING_CANDIDATES_VMEM_REFUSED = \
    "knn_tpu_tuning_candidates_vmem_refused_total"

# --- certified pipeline overlap (knn_tpu_torch.parallel.sharded) -------------
PIPELINE_OVERLAP_RATIO = "knn_tpu_pipeline_overlap_ratio"

# --- JAX compile events (knn_tpu_torch.obs.jax_hooks) ------------------------
JAX_COMPILES = "knn_tpu_jax_compiles_total"
JAX_COMPILE_SECONDS = "knn_tpu_jax_compile_seconds_total"

# --- pipeline / spans (knn_tpu_torch.utils.timing, knn_tpu_torch.obs.trace) --------
PHASE_SECONDS = "knn_tpu_phase_seconds"
SPAN_SECONDS = "knn_tpu_span_seconds"
EVENTS_DROPPED = "knn_tpu_events_dropped_total"

# --- SLO engine (knn_tpu_torch.obs.slo) --------------------------------------
SLO_BURN_RATE = "knn_tpu_slo_burn_rate"
SLO_BREACHED = "knn_tpu_slo_breached"
SLO_BREACH_TRANSITIONS = "knn_tpu_slo_breach_transitions_total"
SLO_EVALUATIONS = "knn_tpu_slo_evaluations_total"

# --- health introspection (knn_tpu_torch.obs.health) -------------------------
HEALTH_READY = "knn_tpu_health_ready"

# --- flight recorder (knn_tpu_torch.obs.blackbox) ----------------------------
POSTMORTEMS_WRITTEN = "knn_tpu_postmortems_written_total"

# --- roofline model (knn_tpu_torch.obs.roofline) -----------------------------
ROOFLINE_PCT = "knn_tpu_roofline_pct"
ROOFLINE_CEILING_QPS = "knn_tpu_roofline_ceiling_qps"
ROOFLINE_BOUND = "knn_tpu_roofline_bound"
ROOFLINE_EVALUATIONS = "knn_tpu_roofline_evaluations_total"

# --- measured-term calibration (knn_tpu_torch.obs.calibrate) -----------------
CALIBRATION_APPLIED = "knn_tpu_calibration_applied"
CALIBRATION_AGE = "knn_tpu_calibration_age_seconds"
CALIBRATION_RESIDUAL = "knn_tpu_calibration_residual_pct"

# --- measured-ceiling campaign (knn_tpu_torch.campaign) ----------------------
CAMPAIGN_ARMS = "knn_tpu_campaign_arms_total"
CAMPAIGN_STAGES = "knn_tpu_campaign_stages_total"

# --- multi-host merge tree (knn_tpu_torch.parallel.sharded / .multihost) -----
MERGE_SELECTED = "knn_tpu_merge_strategy_selected_total"
MERGE_BYTES = "knn_tpu_merge_bytes_total"
MERGE_STRAGGLER_GAP = "knn_tpu_merge_straggler_gap_seconds"

# --- host-RAM shard tier (knn_tpu_torch.parallel.sharded) --------------------
HOSTTIER_SWEEPS = "knn_tpu_hosttier_sweeps_total"
HOSTTIER_SEGMENT_ROWS = "knn_tpu_hosttier_segment_rows"
HOSTTIER_SWEEP_SECONDS = "knn_tpu_hosttier_sweep_seconds"

# --- mutable index (knn_tpu_torch.index.mutable) -----------------------------
INDEX_EPOCH = "knn_tpu_index_epoch"
INDEX_TAIL_ROWS = "knn_tpu_index_tail_rows"
INDEX_TOMBSTONES = "knn_tpu_index_tombstones"
INDEX_COMPACTIONS = "knn_tpu_index_compactions_total"
INDEX_SWAP_SECONDS = "knn_tpu_index_swap_seconds"

# --- shadow audit sampler (knn_tpu_torch.obs.audit) --------------------------
AUDIT_SAMPLED = "knn_tpu_audit_sampled_requests_total"
AUDIT_REPLAYED = "knn_tpu_audit_replayed_queries_total"
AUDIT_DEFICIENT = "knn_tpu_audit_deficient_queries_total"
AUDIT_DROPPED = "knn_tpu_audit_dropped_total"
AUDIT_ROWS_SCORED = "knn_tpu_audit_rows_scored_total"
AUDIT_RECALL = "knn_tpu_audit_recall_at_k"
AUDIT_RANK_DISPLACEMENT = "knn_tpu_audit_rank_displacement"
AUDIT_DISTANCE_ERROR = "knn_tpu_audit_distance_rel_error"

# --- certificate-margin telemetry (sharded / ivf certified paths) ------
CERTIFIED_MARGIN = "knn_tpu_certified_margin_ratio"

# --- IVF per-search quality (knn_tpu_torch.ivf.index) ------------------------
IVF_FALLBACK_RATE = "knn_tpu_ivf_fallback_rate"
IVF_RECALL_AT_K = "knn_tpu_ivf_recall_at_k"
IVF_PROBE_FRACTION = "knn_tpu_ivf_probe_fraction"
IVF_BYTES_STREAMED_RATIO = "knn_tpu_ivf_bytes_streamed_ratio"

# --- query-distribution drift (knn_tpu_torch.obs.drift) ----------------------
DRIFT_NORM_PSI = "knn_tpu_drift_query_norm_psi"
DRIFT_ASSIGN_PSI = "knn_tpu_drift_centroid_assign_psi"
DRIFT_QUERIES = "knn_tpu_drift_queries_observed_total"

# --- index-health gauges (knn_tpu_torch.obs.drift) ---------------------------
INDEX_LIST_IMBALANCE = "knn_tpu_index_list_imbalance"
INDEX_TAIL_FRACTION = "knn_tpu_index_delta_tail_fraction"
INDEX_TOMBSTONE_DENSITY = "knn_tpu_index_tombstone_density"

# --- fleet observability plane (knn_tpu_torch.obs.fleet) ---------------------
FLEET_MEMBERS = "knn_tpu_fleet_members"
FLEET_UNREACHABLE = "knn_tpu_fleet_unreachable"
FLEET_MERGE_STALENESS = "knn_tpu_fleet_merge_staleness_seconds"
FLEET_STRAGGLER_HOST = "knn_tpu_fleet_straggler_host"

#: the catalog names this package never writes (see the module docstring):
#: the JAX package's XLA compile events and the multi-GPU merge names
UNWRITTEN = frozenset({
    JAX_COMPILES, JAX_COMPILE_SECONDS,
    MERGE_SELECTED, MERGE_BYTES, MERGE_STRAGGLER_GAP,
})

#: name -> (type, label names, help).  Types: "counter" (monotone,
#: float-valued so second-counters work), "gauge", "histogram" (bounded
#: sample window + lifetime count/sum; exported as a Prometheus summary).
CATALOG = {
    SERVING_REQUESTS: (
        "counter", ("op",),
        "Lifetime requests accepted by ServingEngine.submit()."),
    SERVING_QUERIES: (
        "counter", ("op",),
        "Lifetime query rows accepted by ServingEngine.submit()."),
    SERVING_ERRORS: (
        "counter", ("op",),
        "Requests that raised through dispatch or result join."),
    SERVING_DISPATCHES: (
        "counter", ("op", "bucket"),
        "Bucketed chunk dispatches, by op and bucket rung."),
    SERVING_COMPILES: (
        "counter", ("op", "bucket"),
        "Executable builds per (op, bucket) — the bucket ladder's "
        "compile-bound proof."),
    SERVING_REQUEST_LATENCY: (
        "histogram", ("op",),
        "Arrival-to-result request latency through the engine (seconds)."),
    QUEUE_DEPTH_REQUESTS: (
        "gauge", (),
        "Requests currently waiting in the micro-batching queue."),
    QUEUE_DEPTH_ROWS: (
        "gauge", (),
        "Query rows currently waiting in the micro-batching queue."),
    QUEUE_REQUESTS: (
        "counter", (),
        "Lifetime requests accepted by QueryQueue.submit()."),
    QUEUE_DISPATCHES: (
        "counter", (),
        "Coalesced batches the queue dispatched to the engine."),
    QUEUE_COALESCED_ROWS: (
        "counter", (),
        "Query rows dispatched through coalesced batches."),
    QUEUE_ERRORS: (
        "counter", (),
        "Queued requests resolved with an exception."),
    QUEUE_WAIT: (
        "histogram", (),
        "Per-request wait from arrival to batch dispatch (seconds)."),
    QUEUE_REQUEST_LATENCY: (
        "histogram", (),
        "Per-request arrival-to-result latency through the queue "
        "(seconds) — includes the micro-batching wait."),
    ADMISSION_ADMITTED: (
        "counter", ("tenant",),
        "Requests admitted past the admission controller, by tenant "
        "('-' for untagged traffic)."),
    ADMISSION_REJECTED: (
        "counter", ("tenant", "reason"),
        "Requests rejected AT SUBMIT with an explicit outcome "
        "(queue_full / quota / deadline) instead of unbounded queue "
        "growth."),
    ADMISSION_SHED: (
        "counter", ("tenant", "reason"),
        "Admitted requests shed before device dispatch (expired: the "
        "deadline passed while queued) — load the controller dropped "
        "instead of wasting device time on."),
    ADMISSION_WAIT_ESTIMATE: (
        "gauge", (),
        "Current wait estimate (seconds) the deadline-aware shedding "
        "decision uses: outstanding rows (queued + in flight) x EWMA "
        "per-row service time + the micro-batching deadline."),
    TENANT_REQUESTS: (
        "counter", ("tenant",),
        "Lifetime requests per tenant through the serving layer (only "
        "tenant-tagged submissions produce series)."),
    TENANT_ERRORS: (
        "counter", ("tenant",),
        "Per-tenant requests resolved with an exception (admission "
        "rejections/sheds count separately, not here)."),
    TENANT_REQUEST_LATENCY: (
        "histogram", ("tenant",),
        "Per-tenant arrival-to-result latency (seconds) of ADMITTED "
        "requests — the per-tenant SLO objectives read this."),
    CERTIFIED_QUERIES: (
        "counter", ("selector",),
        "Queries processed by ShardedKNN.search_certified."),
    CERTIFIED_FALLBACKS: (
        "counter", ("selector",),
        "Queries that failed certification and took the widened "
        "re-select fallback."),
    CERTIFIED_GENUINE_MISSES: (
        "counter", ("selector",),
        "Fallbacks where the repair CHANGED the answer (the coarse pass "
        "really missed a neighbor)."),
    CERTIFIED_FALSE_ALARMS: (
        "counter", ("selector",),
        "Fallbacks that reproduced the original answer (the tolerance "
        "cried wolf)."),
    CERTIFIED_HOST_EXACT: (
        "counter", ("selector",),
        "Fallbacks escalated to the unconditional float64 host scan."),
    CERTIFIED_RANK_CORRECTED: (
        "counter", (),
        "Pallas-selector queries whose near-tie runs were re-ranked in "
        "float64."),
    CERTIFIED_QUANT_BOUND: (
        "histogram", (),
        "Per-query int8 certified quantization error bound epsilon "
        "(score units) — the quality signal the int8 coarse pass "
        "computes."),
    TUNING_RESOLVES: (
        "counter", (), "tuning.resolve() invocations."),
    TUNING_CACHE_HITS: (
        "counter", (), "Knob resolutions served from the persisted "
        "winner cache."),
    TUNING_CACHE_MISSES: (
        "counter", (), "Knob resolutions that fell back to defaults."),
    TUNING_SEARCHES: (
        "counter", (), "autotune() runs that actually searched the "
        "grid."),
    TUNING_CANDIDATES_TIMED: (
        "counter", (), "Autotuner candidates built and timed (0 on a "
        "warm cache)."),
    TUNING_GATE_FAILURES: (
        "counter", (), "Autotuner candidates rejected by the bitwise "
        "end-result gate."),
    TUNING_CANDIDATES_PRUNED: (
        "counter", (), "Autotuner candidates skipped before timing by "
        "the roofline-model pruning gate (autotune's prune=; every "
        "skip is recorded in the tune entry's pruning provenance)."),
    TUNING_CANDIDATES_VMEM_REFUSED: (
        "counter", (), "Autotuner candidates refused before timing by "
        "the device's resource gate (on the H100 the Hopper build check, tuning.autotune): their "
        "per-launch footprint exceeds what the device can launch, "
        "so they would fail at launch; every refusal is "
        "recorded in the tune entry's vmem provenance."),
    PIPELINE_OVERLAP_RATIO: (
        "gauge", (),
        "Fraction of the last certified pipeline-overlap run's wall "
        "time with >= 2 batches in flight (coarse-dispatch start to "
        "result-repair end) — the two-stage coarse/rescore pipeline's "
        "measured dispatch-timeline overlap."),
    JAX_COMPILES: (
        "counter", ("event",),
        "JAX/XLA compile events observed via jax.monitoring."),
    JAX_COMPILE_SECONDS: (
        "counter", ("event",),
        "Cumulative seconds spent in observed JAX/XLA compile events."),
    PHASE_SECONDS: (
        "histogram", ("phase",),
        "PhaseTimer phase durations (seconds), by phase name."),
    SPAN_SECONDS: (
        "histogram", ("span",),
        "Trace span durations (seconds), by span name."),
    EVENTS_DROPPED: (
        "counter", (),
        "Structured events dropped because the JSONL sink raised."),
    SLO_BURN_RATE: (
        "gauge", ("objective", "window"),
        "Error-budget burn rate per SLO objective and evaluation window "
        "(ratio objectives: window error ratio / budget; quantile "
        "objectives: window quantile / threshold, window label 'hist')."),
    SLO_BREACHED: (
        "gauge", ("objective",),
        "1 while the objective's multi-window burn-rate policy is "
        "breached, 0 otherwise (edge transitions emit slo.alert events)."),
    SLO_BREACH_TRANSITIONS: (
        "counter", ("objective",),
        "Healthy-to-breached transitions per objective (each one also "
        "emits exactly one firing slo.alert event)."),
    SLO_EVALUATIONS: (
        "counter", (),
        "SLO engine evaluation passes (each appends one counter sample "
        "to the burn-rate window ring)."),
    HEALTH_READY: (
        "gauge", (),
        "1 when the readiness probe passes (warmup complete, worker "
        "threads live), 0 otherwise; set on every /healthz or report()."),
    POSTMORTEMS_WRITTEN: (
        "counter", ("objective",),
        "Flight-recorder postmortem bundles written to "
        "the postmortem directory, one per edge-triggered SLO breach "
        "transition, by the objective that fired."),
    ROOFLINE_PCT: (
        "gauge", ("config",),
        "Measured throughput as a fraction of the analytic roofline "
        "ceiling for the labeled config (knn_tpu_torch.obs.roofline)."),
    ROOFLINE_CEILING_QPS: (
        "gauge", ("config",),
        "Predicted roofline ceiling q/s for the labeled config — the "
        "slowest of the HBM / MXU / VPU-select terms at device peaks."),
    ROOFLINE_BOUND: (
        "gauge", ("config", "class"),
        "1 for the config's active bound class (hbm_bound / mxu_bound "
        "/ vpu_select_bound), 0 for the others."),
    ROOFLINE_EVALUATIONS: (
        "counter", (),
        "Roofline attributions published to the registry (autotuner "
        "winners, warm-cache resolves, bench runs)."),
    CALIBRATION_APPLIED: (
        "gauge", ("config",),
        "1 when the labeled config's published roofline block carried "
        "an APPLIED measured-term calibration overlay "
        "(knn_tpu_torch.obs.calibrate), 0 when it rendered analytic-only."),
    CALIBRATION_AGE: (
        "gauge", ("config",),
        "Age (seconds) of the calibration entry applied to the "
        "labeled config — how stale the measured factors are."),
    CALIBRATION_RESIDUAL: (
        "gauge", ("config",),
        "Signed percent by which the ANALYTIC model mispredicted the "
        "measured device time for the labeled config (the reconciled "
        "model_residual_pct) — the calibration-drift signal the "
        "sentinel baselines."),
    CAMPAIGN_ARMS: (
        "counter", ("status",),
        "Measured-ceiling campaign arms completed (cli campaign), by "
        "terminal status (ok / error)."),
    CAMPAIGN_STAGES: (
        "counter", ("stage",),
        "Campaign pipeline stages executed (gates / tune / bench / "
        "capture / reconcile / calibrate / curate), across arms."),
    MERGE_SELECTED: (
        "counter", ("level", "strategy", "source"),
        "Merge-strategy resolutions at placement time, by merge level "
        "(intra = per-host ICI db axis, dcn = cross-host) x chosen "
        "strategy (ring / allgather) x provenance (explicit caller / "
        "env switch / measured crossover table)."),
    MERGE_BYTES: (
        "counter", ("level", "strategy"),
        "Modeled candidate bytes moved by top-k merges "
        "(parallel.crossover.merge_bytes), by level and strategy — "
        "the DCN volume the roofline's dcn term prices."),
    MERGE_STRAGGLER_GAP: (
        "gauge", (),
        "Max-minus-min per-host local search wall time of the last "
        "cross-host merge (parallel.multihost) — the straggler signal "
        "/statusz and doctor attribute."),
    HOSTTIER_SWEEPS: (
        "counter", (),
        "Host-RAM tier segment sweeps executed: one per super-HBM "
        "db segment streamed through the device placement."),
    HOSTTIER_SEGMENT_ROWS: (
        "gauge", (),
        "Padded rows per host-RAM tier segment of the last planned "
        "sweep (every sweep reuses this one compiled shape)."),
    HOSTTIER_SWEEP_SECONDS: (
        "histogram", (),
        "Wall seconds per host-RAM tier sweep (dispatch to fetch of "
        "one segment) — flat across sweeps when the stream overlaps."),
    INDEX_EPOCH: (
        "gauge", (),
        "Current snapshot epoch of the mutable index — bumps once per "
        "compaction swap (knn_tpu_torch.index.mutable)."),
    INDEX_TAIL_ROWS: (
        "gauge", (),
        "Rows currently in the mutable index's delta tail (searched "
        "alongside the main placement; compaction folds them in)."),
    INDEX_TOMBSTONES: (
        "gauge", (),
        "Ids currently tombstoned in the mutable index — masked out of "
        "every merged select under the certify reserve; compaction "
        "drops the rows and resets this."),
    INDEX_COMPACTIONS: (
        "counter", (),
        "Completed compaction cycles (tail merged + tombstones "
        "dropped into a fresh placement, snapshot-swapped in)."),
    INDEX_SWAP_SECONDS: (
        "histogram", (),
        "Seconds the compaction's atomic pointer swap held the index "
        "lock — the only slice of a compaction that can contend with "
        "the serving path (the build/warm runs off it)."),
    AUDIT_SAMPLED: (
        "counter", ("tenant",),
        "Live requests selected by the shadow audit sampler's "
        "trace-id hash (the audit rate), by tenant ('-' for "
        "untagged traffic) — includes records later dropped by the "
        "budget or backlog."),
    AUDIT_REPLAYED: (
        "counter", ("tenant",),
        "Query rows replayed against the f64 exact oracle by the "
        "audit worker, by tenant — the denominator of the "
        "audit_recall SLO objective."),
    AUDIT_DEFICIENT: (
        "counter", ("tenant",),
        "Audited query rows whose served neighbors missed the exact "
        "top-k (recall@k < 1), by tenant — the numerator of the "
        "audit_recall SLO objective."),
    AUDIT_DROPPED: (
        "counter", ("reason",),
        "Sampled audit records dropped WITHOUT replay, by reason "
        "(budget: over the audit row-budget token bucket; "
        "queue_full: the bounded replay backlog; error: the oracle "
        "replay raised) — a silent drop would read as a healthy "
        "audit."),
    AUDIT_ROWS_SCORED: (
        "counter", (),
        "Oracle rows scanned by completed audit replays — the spend "
        "the row budget meters."),
    AUDIT_RECALL: (
        "histogram", ("tenant",),
        "Per-audited-query recall@k of the served answer against the "
        "f64 exact oracle (1.0 = the exact set, tie-tolerant), by "
        "tenant."),
    AUDIT_RANK_DISPLACEMENT: (
        "histogram", ("tenant",),
        "Per-served-neighbor displacement from its exact oracle rank "
        "(0 = served in its true position), by tenant."),
    AUDIT_DISTANCE_ERROR: (
        "histogram", ("tenant",),
        "Relative error of each served distance against its own f64 "
        "recompute — arithmetic drift, independent of ranking."),
    CERTIFIED_MARGIN: (
        "histogram", ("path",),
        "Per-certified-query relative margin between the k-th result "
        "distance and the exclusion bound that certified it, by "
        "certification path (sharded / ivf).  Margins crowding 0 are "
        "the leading indicator that fallback rate is about to grow."),
    IVF_FALLBACK_RATE: (
        "gauge", ("selector",),
        "Fraction of the last IVF search's queries that failed the "
        "probe-pruning certificate and fell back to wider scans."),
    IVF_RECALL_AT_K: (
        "gauge", ("selector",),
        "Measured recall@k of the last IVF search against its own "
        "exact rescore (1.0 when every certificate held)."),
    IVF_PROBE_FRACTION: (
        "gauge", ("selector",),
        "Fraction of trained IVF lists probed by the last search — "
        "the pruning the tier exists to deliver."),
    IVF_BYTES_STREAMED_RATIO: (
        "gauge", ("selector",),
        "Bytes streamed by the last IVF search as a fraction of the "
        "brute-force full-corpus stream."),
    DRIFT_NORM_PSI: (
        "gauge", (),
        "Population-stability index of the live query-norm histogram "
        "against the train-time baseline (0 = identical; > 0.2 "
        "investigate, > 0.5 act)."),
    DRIFT_ASSIGN_PSI: (
        "gauge", (),
        "Population-stability index of the live IVF "
        "centroid-assignment histogram against the k-means training "
        "assignment counts."),
    DRIFT_QUERIES: (
        "counter", (),
        "Query rows folded into the drift sketches."),
    INDEX_LIST_IMBALANCE: (
        "gauge", (),
        "Max/mean trained IVF list size of the current snapshot "
        "(1.0 = perfectly balanced; growth concentrates probe cost)."),
    INDEX_TAIL_FRACTION: (
        "gauge", (),
        "Fraction of all index rows sitting in the unindexed delta "
        "tail — the slice every search brute-forces until "
        "compaction."),
    INDEX_TOMBSTONE_DENSITY: (
        "gauge", (),
        "Fraction of all index rows tombstoned — dead bytes diluting "
        "every stream until compaction drops them."),
    FLEET_MEMBERS: (
        "gauge", (),
        "Members the last fleet collection merged (knn_tpu_torch.obs.fleet) "
        "— live endpoints reached or snapshot files read."),
    FLEET_UNREACHABLE: (
        "gauge", (),
        "Members the last fleet collection could NOT merge "
        "(unreachable endpoint, torn/unreadable snapshot, or "
        "catalog-version skew) — nonzero marks the report partial."),
    FLEET_MERGE_STALENESS: (
        "gauge", (),
        "Spread (seconds) between the oldest and newest member "
        "snapshot the last fleet collection merged — how far apart in "
        "time the merged numbers are."),
    FLEET_STRAGGLER_HOST: (
        "gauge", ("host",),
        "1 on the member whose per-host DCN-merge wall time was the "
        "fleet maximum in the last collection (the named straggler), "
        "0 on the others."),
}
