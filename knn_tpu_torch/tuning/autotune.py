"""The port's kernel autotuner — knn_tpu/tuning/autotune.py for the CUDA
kernels: enumerate a bounded knob grid, gate each candidate by its end
result against the default configuration's, time the survivors fenced,
persist the winner (:mod:`knn_tpu_torch.tuning.cache`).

Why a gate per candidate: every knob changes kernel geometry or arithmetic,
and the certified pipeline's contract is that the FINAL (distances,
indices) are exact for any knob set; a candidate whose answer differs
bitwise from the default configuration's is broken, not merely different,
and can never win, however fast it timed.

The public entry points:

- :func:`resolve_full` / :func:`resolve` — the one call every knob consumer
  goes through (``ShardedKNN.search_certified``): the cached winner for
  this ``(device kind, n, d, k, metric)``, else ``DEFAULT_KNOBS``,
  with explicit caller values beating both;
- :func:`autotune` — the search for one problem shape; a cache entry
  short-circuits it with zero re-timing (``counters()["candidates_timed"]``
  pins that in the tests and in the CLI's JSON record);
- ``python -m knn_tpu_torch.cli tune`` — the command that runs it.

What differs from the JAX package:

- ``block_q`` is not a knob: it re-blocks the query rows of the TPU grid,
  and every CUDA kernel takes its own 32-row query block.  The grid is the
  JAX package's with that axis removed (the throughput profile's block_q
  512 / 1024 ladder collapses into the default geometry), duplicates
  dropped in first-seen order.
- One regime: winners are keyed and searched for latency (serving).  The
  JAX package's ``throughput`` profile keys winners for its kNN join,
  which the port does not have yet; :func:`knob_grid` keeps the profile's
  grid only so it can be held against the JAX package's.  A search keys
  its winner at float32 (it tunes an f32 placement); a resolve reads the
  placement's own compute dtype, as the JAX package's does.
- A Hopper resource gate replaces the VMEM gate (knn_tpu/analysis/vmem.py):
  each candidate's build is read from the built kernel
  (``coarse_knn.kernel_resources``: registers, shared and local bytes,
  CTAs per SM), and one the card cannot launch is recorded as
  ``smem-refused: ...`` in ``errors`` with its provenance in
  ``entry["smem"]``.  On the CPU (the plain versions) it is disarmed.
- Timing is fenced by ``torch.cuda.synchronize`` around each run, one warm
  run outside the clock; the timed program is the certified coarse pass
  and its select / rescore / certificate tail on the placement
  (``ShardedKNN._pallas_setup``), whose quantized, highest and pq
  placements are built once per call and shared by every candidate of
  their precision (pq trains its codebooks once).
- :func:`autotune_ivf` searches the IVF tier's (ncentroids, nprobe) grid
  (:func:`ivf_grid`) under the same bitwise gate, against float64 brute
  force; a candidate is recorded ineligible only for a ``ValueError``
  (the JAX package records every exception), so a device fault raises.
- Roofline (knn_tpu_torch.obs.roofline, the H100 model): every timed
  candidate gets its attribution (``roofline_per_candidate``), the
  winner's block rides its cache entry (``roofline_pct`` /
  ``bound_class`` hoisted) and is published once per process — by the
  search and by a warm-cache :func:`resolve_full`; ``prune=`` runs
  :func:`prune_candidates` before any timing.  ``prune`` is an argument
  only (the JAX package's ``KNN_TPU_TUNE_PRUNE`` has no counterpart).
- The module counters are mirrored into the registry (``TUNING_*``); the
  Hopper gate's refusals count under
  ``TUNING_CANDIDATES_VMEM_REFUSED``, the JAX package's VMEM gate's name.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from knn_tpu_torch import obs
from knn_tpu_torch.obs import names as _mn
from knn_tpu_torch.tuning.cache import TuneCache, cache_key

#: the JAX package's tuning profiles, as grids (:func:`knob_grid`)
PROFILES = ("latency", "throughput")

#: the knob names resolve() returns — the kernel-shaping keyword arguments
#: of ShardedKNN.search_certified.  Values are the library defaults (None =
#: the ops.coarse_knn default at the use site), so a cache miss with no
#: overrides runs the default configuration bit for bit.
DEFAULT_KNOBS: Dict[str, object] = {
    "kernel": "tiled",
    "tile_n": None,
    "bin_w": None,
    "survivors": None,
    "precision": "bf16x3",
    "final_select": "exact",
    "binning": "grouped",
    "grid_order": "query_major",
    "final_recall_target": None,
}

_counters_lock = threading.Lock()
_COUNTERS = {
    "resolve_calls": 0,      # resolve() invocations
    "cache_hits": 0,         # resolve/autotune served from the cache
    "cache_misses": 0,       # resolve fell back to defaults
    "tune_searches": 0,      # autotune() runs that actually searched
    "candidates_timed": 0,   # candidates timed (0 on a warm cache)
    "candidates_gated_out": 0,  # candidates rejected by the bitwise gate
    "candidates_pruned": 0,  # skipped before timing by the roofline model
    "candidates_smem_refused": 0,  # refused by the Hopper resource gate
}

#: module counter -> registry twin: the dict above stays the in-process
#: surface (reset_counters() and all), the registry series are the
#: scrapable lifetime mirror (never reset by reset_counters)
_OBS_TWIN = {
    "resolve_calls": _mn.TUNING_RESOLVES,
    "cache_hits": _mn.TUNING_CACHE_HITS,
    "cache_misses": _mn.TUNING_CACHE_MISSES,
    "tune_searches": _mn.TUNING_SEARCHES,
    "candidates_timed": _mn.TUNING_CANDIDATES_TIMED,
    "candidates_gated_out": _mn.TUNING_GATE_FAILURES,
    "candidates_pruned": _mn.TUNING_CANDIDATES_PRUNED,
    "candidates_smem_refused": _mn.TUNING_CANDIDATES_VMEM_REFUSED,
}


def counters() -> Dict[str, int]:
    """Snapshot of the module counters — the zero re-timing evidence (a
    second tune of a warm cache must not move ``candidates_timed``)."""
    with _counters_lock:
        return dict(_COUNTERS)


def reset_counters() -> None:
    with _counters_lock:
        for key in _COUNTERS:
            _COUNTERS[key] = 0


def _bump(name: str, by: int = 1) -> None:
    with _counters_lock:
        _COUNTERS[name] += by
    obs.counter(_OBS_TWIN[name]).inc(by)


def device_kind_of(device=None) -> str:
    """The cache keys' device kind: ``torch.cuda.get_device_name`` of a
    CUDA ``device`` (None: the current card, when there is one), else
    ``"cpu"``."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    return torch.cuda.get_device_name(device)


def resolve_full(
    n: int, d: int, k: int, *, metric: str = "l2",
    dtype: Optional[str] = None, device_kind: Optional[str] = None,
    overrides: Optional[Dict[str, object]] = None,
    cache_path: Optional[str] = None,
) -> Tuple[Dict[str, object], Dict[str, object]]:
    """(knobs, info): the knob set for one problem shape and its
    provenance.  Precedence: explicit overrides (non-None values) > the
    cached winner > ``DEFAULT_KNOBS``.  ``info`` carries ``source``
    ("cache" | "default"), the cache key and path, and which
    knobs an override pinned.  ``device_kind`` None reads the current
    card's (:func:`device_kind_of`); ``dtype`` is the placement's compute
    dtype name (None = float32), a field of the cache key."""
    _bump("resolve_calls")
    if device_kind is None:
        device_kind = device_kind_of()
    key = cache_key(device_kind, n, d, k, metric, dtype)
    cache = TuneCache(cache_path)
    knobs = dict(DEFAULT_KNOBS)
    entry = cache.get(key)
    if entry is not None and isinstance(entry.get("knobs"), dict):
        # unknown keys of a newer cache are dropped, known ones win
        knobs.update({kk: v for kk, v in entry["knobs"].items()
                      if kk in DEFAULT_KNOBS})
        source = "cache"
        _bump("cache_hits")
    else:
        source = "default"
        _bump("cache_misses")
    overridden = []
    for kk, v in (overrides or {}).items():
        if kk not in DEFAULT_KNOBS:
            raise ValueError(f"unknown pallas knob {kk!r}; "
                             f"expected one of {sorted(DEFAULT_KNOBS)}")
        if v is not None:
            knobs[kk] = v
            overridden.append(kk)
    info = {
        "source": source,
        "cache_key": key,
        "cache_path": cache.path,
        "overridden": sorted(overridden),
    }
    if source == "cache":
        info["winner_ms"] = entry.get("winner_ms")
        info["measured_at"] = entry.get("measured_at")
        # the winner's roofline verdict rides the resolve and is published
        # once per (process, config): a warm-cache hot path must not
        # re-emit it every call
        for fld in ("roofline_pct", "bound_class"):
            if entry.get(fld) is not None:
                info[fld] = entry[fld]
        rl_block = entry.get("roofline")
        if isinstance(rl_block, dict):
            from knn_tpu_torch.obs import roofline as _roofline

            label = _roofline.config_label(n, d, k, metric=metric,
                                           dtype=dtype,
                                           device_kind=device_kind)
            info["roofline_ceiling_qps"] = rl_block.get("ceiling_qps")
            if not _roofline.was_published(label):
                _roofline.publish(label, rl_block)
    return knobs, info


def resolve(n: int, d: int, k: int, **kwargs) -> Dict[str, object]:
    """The knob set alone — see :func:`resolve_full`."""
    return resolve_full(n, d, k, **kwargs)[0]


def _label(knobs: Dict[str, object]) -> str:
    """Stable candidate label: only the knobs that deviate from the
    defaults, in sorted order ("defaults" when none do)."""
    parts = [f"{kk}={knobs[kk]}" for kk in sorted(DEFAULT_KNOBS)
             if knobs[kk] != DEFAULT_KNOBS[kk]]
    return ",".join(parts) or "defaults"


def knob_grid(level: str = "standard",
              profile: str = "latency") -> List[Dict[str, object]]:
    """The bounded, deterministic candidate grid: the JAX package's
    ``knob_grid`` (autotune.py:214-382) at every level and profile with
    its ``block_q`` axis removed, in its first-seen order.

    - ``"quick"``: kernel x grid_order at the default geometry, plus the
      approx final select.
    - ``"standard"``: quick + one-at-a-time deviations of tile_n and
      precision (every arm with a certificate, int8 / int4 / pq under
      streaming too), and the fused crosses.
    - ``"full"``: the bounded product tile_n x grid_order x precision x
      kernel, each with the exact and the approx final select.

    Invalid combinations (streaming / fused with db_major, fused with
    approx or lane binning, pq under fused) are skipped as the kernels
    refuse them.  The JAX package's full product enumerates block_q 256
    before 128 and reaches bf16x3f under streaming / fused at tile_n
    32,768 only at 128 (its VMEM rule); without the axis those arms come
    after the rest of their tile, where the JAX order has them.
    ``profile="throughput"`` (:data:`PROFILES`; no consumer in the port
    yet, only :func:`autotune`'s latency grid is searched) adds what remains of the JAX package's block_q 512 / 1024
    ladder once the axis is gone: tiled tile_n and precision deviations,
    and int8 at tile_n 32,768.  ``survivors`` and ``bin_w`` are not axes
    here, as there: they reach a search through a grid passed to
    :func:`autotune`, or a cache entry."""
    if level not in ("quick", "standard", "full"):
        raise ValueError(f"grid level {level!r} not in "
                         f"('quick', 'standard', 'full')")
    if profile not in PROFILES:
        raise ValueError(f"unknown tuning profile {profile!r}; "
                         f"expected one of {PROFILES}")
    out: List[Dict[str, object]] = []
    seen = set()

    def add(**deviations):
        knobs = dict(DEFAULT_KNOBS)
        knobs.update(deviations)
        if (knobs["kernel"] in ("streaming", "fused")
                and knobs["grid_order"] != "query_major"):
            return  # no db grid axis to reorder (the kernels refuse it)
        if knobs["kernel"] == "fused" and (
                knobs["final_select"] == "approx"
                or knobs["binning"] != "grouped"):
            return  # the early-out's bitwise contract is exact + grouped
        if knobs["precision"] == "pq" and knobs["kernel"] == "fused":
            return  # refused: carry soundness unproven for pq scores
        lbl = _label(knobs)
        if lbl not in seen:
            seen.add(lbl)
            out.append(knobs)

    def extend_throughput():
        add(tile_n=8192)
        for prec in ("bf16x3f", "int8", "int4"):
            add(precision=prec)
        add(tile_n=32768)
        add(precision="int8", tile_n=32768)

    for kern in ("tiled", "streaming", "fused"):
        for order in ("query_major", "db_major"):
            add(kernel=kern, grid_order=order)
    add(final_select="approx")
    if level == "quick":
        if profile == "throughput":
            extend_throughput()
        return out
    for tile in (8192, 32768):
        add(tile_n=tile)
    add(tile_n=32768, final_select="approx")
    for prec in ("bf16x3f", "highest", "int8", "int4"):
        add(precision=prec)
    add(precision="int8", kernel="streaming")
    add(precision="int4", kernel="streaming")
    add(precision="pq", kernel="streaming")
    add(precision="pq")
    add(precision="int8", kernel="fused")
    add(kernel="fused", tile_n=32768)
    if level == "standard":
        if profile == "throughput":
            extend_throughput()
        return out
    for tile in (None, 8192, 32768):
        # the JAX package's VMEM rule held these back to its block_q 128
        # pass over the tile
        late = []
        for order in ("query_major", "db_major"):
            for prec in ("bf16x3", "bf16x3f", "int8", "int4"):
                for kern in ("tiled", "streaming", "fused"):
                    cand = dict(tile_n=tile, grid_order=order,
                                precision=prec, kernel=kern)
                    if (prec == "bf16x3f" and kern != "tiled"
                            and (tile or 0) >= 32768):
                        late.append(cand)
                        continue
                    add(**cand)
                    add(**cand, final_select="approx")
        for cand in late:
            add(**cand)
            add(**cand, final_select="approx")
    if profile == "throughput":
        extend_throughput()
    return out


def _resource_gate(knn, candidates, n: int, d: int, k: int, margin: int):
    """The Hopper resource gate: for each candidate the build its first
    launch would take (the tile :func:`coarse_knn.effective_tile` resolves,
    its survivors, the padded dims) read from the built kernel; returns
    ``(refused {label: record}, info)``.  Candidates whose geometry does
    not resolve are kept: their search raises, and is recorded, later."""
    from knn_tpu_torch.ops import coarse_knn as ck

    refused: Dict[str, dict] = {}
    checked = {}
    dp = -(-d // ck.DIM_CHUNK) * ck.DIM_CHUNK
    m = min(k + margin, n)
    for cand in candidates:
        knobs = {**DEFAULT_KNOBS, **cand}
        label = _label(knobs)
        bin_w = knobs["bin_w"] or ck.BIN_W
        try:
            eff = ck.effective_tile(n, knobs["tile_n"] or ck.TILE_N, bin_w,
                                    knobs["survivors"], knobs["binning"],
                                    m + 2)
            surv = ck._geometry(eff, bin_w, knobs["survivors"],
                                knobs["binning"])[1]
        except ValueError:
            continue
        prec = knobs["precision"]
        build = (knobs["kernel"], prec,
                 0 if knobs["binning"] == "grouped" else bin_w, surv,
                 # pq: its default placement's subspaces (4 dims each)
                 -(-d // 4) if prec == "pq" else dp, eff)
        if build not in checked:
            try:
                checked[build] = ck.kernel_resources(
                    build[0], prec, bin_w=build[2], survivors=build[3],
                    dp=build[4], tile_n=build[5], device=knn.device)
            except RuntimeError as e:
                checked[build] = {"error": str(e)}
        res = checked[build]
        if "error" in res or res["ctas_per_sm"] < 1:
            refused[label] = {"kernel": build[0], "precision": prec,
                              "bin_w": build[2], "survivors": build[3],
                              "dp": build[4], **res}
    info = {"device": str(knn.device), "builds_checked": len(checked),
            "candidates_refused": len(refused), "refused": refused}
    return refused, info


def _cost_model(knobs: Dict[str, object], n: int, d: int, k: int, nq: int,
                margin: int, device_kind: str, backend: str) -> dict:
    from knn_tpu_torch.obs import roofline

    return roofline.pallas_cost_model(
        n=n, d=d, k=k, nq=nq, precision=knobs["precision"],
        kernel=knobs["kernel"], grid_order=knobs["grid_order"],
        binning=knobs["binning"], tile_n=knobs["tile_n"],
        survivors=knobs["survivors"], bin_w=knobs["bin_w"], margin=margin,
        device_kind=device_kind, backend=backend)


def prune_candidates(
    candidates: Sequence[Dict[str, object]], *, n: int, d: int, k: int,
    nq: int, threshold: float, device_kind: Optional[str] = None,
    backend: Optional[str] = None, margin: int = 28,
) -> Tuple[List[Dict[str, object]], Dict[str, dict], Optional[float]]:
    """Roofline pruning for :func:`autotune` (autotune.py:402-459 of the
    JAX package, on the H100 model): ``(kept, pruned, best_ceiling_qps)``.
    Each candidate's modeled ceiling is computed before any timing;
    candidates below ``threshold x best`` leave the timing loop, each with
    its ceiling recorded in ``pruned``.  The best-modeled candidate is
    always kept; a candidate the model cannot price is kept (a model gap
    widens the search, never hides a candidate); every pruned record
    carries ``ceiling_qps < threshold * best``."""
    models: List[Tuple[Dict[str, object], Optional[dict]]] = []
    for cand in candidates:
        knobs = {**DEFAULT_KNOBS, **cand}
        try:
            model = _cost_model(knobs, n, d, k, nq, margin, device_kind,
                                backend)
            if not model.get("ceiling_qps"):
                model = None
        except Exception:  # noqa: BLE001 — a model gap never prunes
            model = None
        models.append((cand, model))
    ceilings = [m["ceiling_qps"] for _, m in models if m is not None]
    best = max(ceilings) if ceilings else None
    kept: List[Dict[str, object]] = []
    pruned: Dict[str, dict] = {}
    for cand, model in models:
        if best is None or model is None or \
                model["ceiling_qps"] >= threshold * best:
            kept.append(cand)
            continue
        pruned[_label({**DEFAULT_KNOBS, **cand})] = {
            "ceiling_qps": model["ceiling_qps"],
            "bound_class": model.get("bound_class"),
            "best_ceiling_qps": best,
            "threshold": threshold,
        }
    return kept, pruned, best


def _candidate_roofline(knobs: Dict[str, object], n: int, d: int, k: int,
                        nq: int, margin: int, ms: float, device_kind: str,
                        backend: str) -> dict:
    """One timed candidate's attribution: its modeled ceiling on this
    device kind, the measured fraction of it and its bound class."""
    from knn_tpu_torch.obs import roofline

    model = _cost_model(knobs, n, d, k, nq, margin, device_kind, backend)
    return roofline.attribute(model, nq / (ms / 1e3) if ms > 0 else None)


def _search_once(queries, knn, k, margin, knobs):
    """Full certified search under one knob set: (d, i) — the bitwise
    gate's surface (the final answers every knob must keep)."""
    from knn_tpu_torch.ops.coarse_knn import TILE_N

    d, i, _ = knn.search_certified(
        queries, margin=margin,
        tile_n=knobs["tile_n"] or TILE_N,
        precision=knobs["precision"], bin_w=knobs["bin_w"],
        survivors=knobs["survivors"],
        final_select=knobs["final_select"], binning=knobs["binning"],
        final_recall_target=knobs["final_recall_target"],
        grid_order=knobs["grid_order"], kernel=knobs["kernel"])
    return d, i


def _timed_program(knn, queries, margin: int, knobs: Dict[str, object]):
    """The device hot path one candidate is timed on: the certified
    coarse pass and its tail (select, rescore, certificate) on the
    placement's device queries, as ``search_certified`` runs them for one
    batch (``ShardedKNN._pallas_setup``)."""
    from knn_tpu_torch.ops.coarse_knn import TILE_N

    (coarse, tail), _, _ = knn._pallas_setup(
        margin, knobs["tile_n"] or TILE_N, knobs["precision"],
        bin_w=knobs["bin_w"], survivors=knobs["survivors"],
        final_select=knobs["final_select"], binning=knobs["binning"],
        grid_order=knobs["grid_order"], kernel=knobs["kernel"],
        final_recall_target=knobs["final_recall_target"])
    q = knn._to_device(queries)

    def run():
        return tail(q, *coarse(q))

    return run


def _fence(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def autotune(
    db, queries, k: int, *, metric: str = "l2", margin: int = 28,
    grid: Optional[Sequence[Dict[str, object]]] = None,
    grid_level: str = "standard", runs: int = 2,
    cache_path: Optional[str] = None, device_kind: Optional[str] = None,
    force: bool = False, prune: Optional[float] = None, device=None,
) -> Dict[str, object]:
    """Searches the knob grid for ``(db, queries, k, metric)`` on
    ``device`` (default ``cuda``; ``"cpu"`` runs the plain versions) and
    persists the winner; returns the cache entry (plus ``"cached": True``
    when an existing entry short-circuited the search with zero
    re-timing).

    Per candidate, in grid order:

    1. **bitwise gate** — the candidate's full certified search must give
       the default configuration's final (distances, indices) exactly
       (``np.array_equal``); a mismatch marks it ineligible
       (``timings_ms[label] = None``), and it can never win.
    2. **fenced timing** — the device hot path (:func:`_timed_program`)
       runs once outside the clock, then ``runs`` times between
       ``torch.cuda.synchronize`` fences; the mean wall ms is its score.

    Candidates that raise (a geometry invalid for this shape) are recorded
    ineligible with the error, not fatal.  Before any timing, the **Hopper
    resource gate** (:func:`_resource_gate`, CUDA only) refuses a
    candidate whose build the card cannot launch: ``smem-refused: ...`` in
    ``errors``, the builds read in ``entry["smem"]``.

    **Roofline pruning** (``prune``, a threshold in (0, 1]; None: off):
    before the gate and any timing, :func:`prune_candidates` drops the
    candidates whose modeled ceiling sits below ``prune x`` the best one,
    recorded in ``entry["pruning"]`` and as ``roofline-pruned: ...`` in
    ``errors``.  Every timed candidate's attribution is in
    ``entry["roofline_per_candidate"]``, the winner's in
    ``entry["roofline"]``."""
    from knn_tpu_torch.parallel.sharded import ShardedKNN

    if prune is not None and not 0 < float(prune):
        raise ValueError(f"prune must be a threshold > 0, got {prune}")
    if metric.lower() not in ("l2", "sql2", "euclidean"):
        raise ValueError(
            f"autotune runs the squared-L2 kernel; metric {metric!r} is "
            f"not in its family (cosine callers tune on unit vectors "
            f"with metric='l2')")
    db = np.asarray(db, dtype=np.float32)
    queries = np.asarray(queries, dtype=np.float32)
    n, d = db.shape
    knn = ShardedKNN(db, k=k, device=device)
    if device_kind is None:
        device_kind = device_kind_of(knn.device)
    key = cache_key(device_kind, n, d, k, metric)
    cache = TuneCache(cache_path)
    if not force:
        entry = cache.get(key)
        if entry is not None:
            _bump("cache_hits")
            return {**entry, "cached": True, "cache_key": key,
                    "cache_path": cache.path}

    _bump("tune_searches")
    candidates = (list(grid) if grid is not None
                  else knob_grid(grid_level))
    for c in candidates:
        unknown = set(c) - set(DEFAULT_KNOBS)
        if unknown:
            raise ValueError(f"unknown knobs in grid candidate: {unknown}")

    # the reference: the default configuration, whose final answer every
    # candidate must reproduce bitwise to be eligible
    ref_d, ref_i = _search_once(queries, knn, k, margin, dict(DEFAULT_KNOBS))

    timings: Dict[str, Optional[float]] = {}
    errors: Dict[str, str] = {}
    rooflines: Dict[str, dict] = {}
    backend = knn.device.type
    n_q = queries.shape[0]
    pruning_info = None
    if prune is not None:
        # before any timing: pre-seeded timings keep the pruned candidates
        # out of the loop below, with the audit trail in the entry
        threshold = min(float(prune), 1.0)
        candidates, pruned_rec, best_ceiling = prune_candidates(
            candidates, n=n, d=d, k=k, nq=n_q, threshold=threshold,
            device_kind=device_kind, backend=backend, margin=margin)
        for label, rec in pruned_rec.items():
            timings[label] = None
            errors[label] = (
                f"roofline-pruned: modeled ceiling {rec['ceiling_qps']} "
                f"< {threshold} x best {rec['best_ceiling_qps']}")
        if pruned_rec:
            _bump("candidates_pruned", len(pruned_rec))
        pruning_info = {"threshold": threshold,
                        "best_ceiling_qps": best_ceiling,
                        "candidates_modeled": len(candidates)
                        + len(pruned_rec),
                        "candidates_pruned": len(pruned_rec),
                        "pruned": pruned_rec}
    smem_info = None
    if knn.device.type == "cuda":
        refused, smem_info = _resource_gate(knn, candidates, n, d, k,
                                            margin)
        for label, rec in refused.items():
            timings[label] = None
            why = rec.get("error") or f"{rec['ctas_per_sm']} CTAs per SM"
            errors[label] = (
                f"smem-refused: the {rec['kernel']} {rec['precision']} "
                f"build cannot launch on {device_kind}: {why}")
        if refused:
            _bump("candidates_smem_refused", len(refused))

    best_label, best_ms, best_knobs = None, None, None
    for cand in candidates:
        knobs = dict(DEFAULT_KNOBS)
        knobs.update(cand)
        label = _label(knobs)
        if label in timings:
            continue  # refused, or a duplicate
        try:
            if knobs != DEFAULT_KNOBS:
                d_c, i_c = _search_once(queries, knn, k, margin, knobs)
                if not (np.array_equal(i_c, ref_i)
                        and np.array_equal(d_c, ref_d)):
                    _bump("candidates_gated_out")
                    timings[label] = None
                    errors[label] = "bitwise gate: result != reference"
                    continue
            prog = _timed_program(knn, queries, margin, knobs)
            prog()
            _fence(knn.device)  # warm: builds and allocations off the clock
            reps = []
            for _ in range(max(1, runs)):
                _fence(knn.device)
                t0 = time.perf_counter()
                prog()
                _fence(knn.device)
                reps.append(time.perf_counter() - t0)
            _bump("candidates_timed")
            ms = float(np.mean(reps)) * 1e3
            timings[label] = round(ms, 3)
            try:
                rooflines[label] = _candidate_roofline(
                    knobs, n, d, k, n_q, margin, ms, device_kind, backend)
            except Exception as e:  # noqa: BLE001 — advisory only
                rooflines[label] = {"error": f"{type(e).__name__}: {e}"}
            if best_ms is None or ms < best_ms:
                best_label, best_ms, best_knobs = label, ms, knobs
        except Exception as e:  # noqa: BLE001 — per candidate, recorded
            timings[label] = None
            errors[label] = f"{type(e).__name__}: {e}"
    if best_knobs is None:
        raise RuntimeError(
            f"autotune: no eligible candidate for {key} (errors: {errors})")
    winner_rl = rooflines.get(best_label)
    if not isinstance(winner_rl, dict) or "ceiling_qps" not in winner_rl:
        winner_rl = None
    entry = {
        "knobs": best_knobs,
        "winner": best_label,
        "winner_ms": round(best_ms, 3),
        "timings_ms": timings,
        "errors": errors,
        "roofline_per_candidate": rooflines,
        "gate": "bitwise-vs-reference",
        "runs": int(runs),
        "n_queries": int(queries.shape[0]),
        "margin": int(margin),
        "device_kind": device_kind,
        "backend": knn.device.type,
        "torch_version": torch.__version__,
        "measured_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    if pruning_info is not None:
        entry["pruning"] = pruning_info
    if smem_info is not None:
        entry["smem"] = smem_info
    if winner_rl is not None:
        entry["roofline"] = winner_rl
        entry["roofline_pct"] = winner_rl["roofline_pct"]
        entry["bound_class"] = winner_rl["bound_class"]
    cache.put(key, entry)
    if winner_rl is not None:
        from knn_tpu_torch.obs import roofline as _roofline

        _roofline.publish(
            _roofline.config_label(n, d, k, metric=metric,
                                   device_kind=device_kind), winner_rl)
    return {**entry, "cached": False, "cache_key": key,
            "cache_path": cache.path}


def ivf_label(cand: Dict[str, int]) -> str:
    """Stable IVF candidate label: ``c{ncentroids}p{nprobe}``."""
    return f"c{cand['ncentroids']}p{cand['nprobe']}"


def ivf_grid(n: int) -> List[Dict[str, int]]:
    """The bounded, deterministic (ncentroids, nprobe) grid of
    :func:`autotune_ivf` (knn_tpu/tuning/autotune.py:905-926): ncentroids
    at half, once and twice the ``round(sqrt(n))`` heuristic (clamped so
    lists average >= 8 rows), nprobe at 1/8, 1/4, 1/2 and all of each.
    The ``nprobe == ncentroids`` arm of every ncentroids is always present:
    it must reproduce exact brute force bitwise, anchoring the gate."""
    import math

    base = max(2, int(round(math.sqrt(max(1, int(n))))))
    cap = max(2, int(n) // 8)
    cands: List[Dict[str, int]] = []
    seen = set()
    for cc in (base // 2, base, base * 2):
        cc = max(2, min(int(cc), cap))
        if cc in seen:
            continue
        seen.add(cc)
        for pp in sorted({max(1, cc // 8), max(1, cc // 4),
                          max(1, cc // 2), cc}):
            cands.append({"ncentroids": cc, "nprobe": pp})
    return cands


def autotune_ivf(
    db, queries, k: int, *, metric: str = "l2", runs: int = 2,
    grid: Optional[Sequence[Dict[str, int]]] = None,
    selector: str = "exact", train_iters: int = 5, seed: int = 0,
    device_kind: Optional[str] = None, device=None, mesh=None,
) -> Dict[str, object]:
    """Searches the IVF (ncentroids, nprobe) grid on ``device`` (default
    ``cuda``) or ``mesh`` (not both; ``IVFIndex(mesh=)``, as the JAX
    package's builds it) under the same bitwise end-result gate as
    :func:`autotune`:
    a candidate's certified search must reproduce exact brute force
    (``ops.refine.refine_shared_exact`` over every row) exactly or it is
    marked ineligible — the certified fallback makes every sound candidate
    pass, so a mismatch means a broken placement.  The score is the mean
    wall ms over ``runs`` (the IVF search is host-orchestrated), each run
    between ``torch.cuda.synchronize`` fences, with each candidate's
    probe_fraction / fallback_rate / bytes_streamed_ratio recorded.  One
    index is trained per ncentroids and shared by its nprobe ladder.  A
    candidate that raises ``ValueError`` (a shape its geometry refuses) is
    recorded ineligible; any other exception — a device fault — raises."""
    from knn_tpu_torch.index.tier import tier_mesh
    from knn_tpu_torch.ivf import IVFIndex
    from knn_tpu_torch.ops.refine import refine_shared_exact

    mesh = tier_mesh(mesh, device)
    dev = mesh.devices.flat[0]
    db = np.asarray(db, dtype=np.float32)
    queries = np.asarray(queries, dtype=np.float32)
    n, d = db.shape
    if device_kind is None:
        device_kind = device_kind_of(dev)
    _bump("tune_searches")
    candidates = list(grid) if grid is not None else ivf_grid(n)
    for c in candidates:
        unknown = set(c) - {"ncentroids", "nprobe"}
        if unknown:
            raise ValueError(f"unknown knobs in ivf candidate: {unknown}")

    # the reference: exact brute force over the full corpus — the f64
    # refine anchor IVFIndex.search_certified resolves to
    ref_d, ref_i = refine_shared_exact(
        db, queries, np.arange(n, dtype=np.int64), k, metric=metric)

    timings: Dict[str, Optional[float]] = {}
    errors: Dict[str, str] = {}
    stats_per: Dict[str, dict] = {}
    best_label, best_ms, best_knobs = None, None, None
    by_cc: Dict[int, List[int]] = {}
    for cand in candidates:
        by_cc.setdefault(int(cand["ncentroids"]), []).append(
            int(cand["nprobe"]))
    for cc, probes in sorted(by_cc.items()):
        try:
            index = IVFIndex(db, k=k, ncentroids=cc, nprobe=max(probes),
                             metric=metric, train_iters=train_iters,
                             seed=seed, mesh=mesh)
        except ValueError as e:  # per arm, recorded
            for pp in probes:
                label = ivf_label({"ncentroids": cc, "nprobe": pp})
                timings[label] = None
                errors[label] = f"{type(e).__name__}: {e}"
            continue
        for pp in sorted(set(probes)):
            label = ivf_label({"ncentroids": cc, "nprobe": pp})
            if label in timings:
                continue  # duplicate candidate
            try:
                d_c, i_c, st = index.search_certified(
                    queries, k=k, nprobe=pp, selector=selector)
                if not (np.array_equal(i_c, ref_i)
                        and np.array_equal(d_c, ref_d)):
                    _bump("candidates_gated_out")
                    timings[label] = None
                    errors[label] = "bitwise gate: result != reference"
                    continue
                reps = []
                for _ in range(max(1, runs)):
                    _fence(dev)
                    t0 = time.perf_counter()
                    _, _, st = index.search_certified(
                        queries, k=k, nprobe=pp, selector=selector)
                    _fence(dev)
                    reps.append(time.perf_counter() - t0)
            except ValueError as e:  # per candidate, recorded
                timings[label] = None
                errors[label] = f"{type(e).__name__}: {e}"
                continue
            _bump("candidates_timed")
            ms = float(np.mean(reps)) * 1e3
            timings[label] = round(ms, 3)
            stats_per[label] = {
                kk: st[kk] for kk in
                ("probe_fraction", "fallback_rate", "recall_at_k",
                 "bytes_streamed_ratio", "certified_queries",
                 "fallback_queries")}
            if best_ms is None or ms < best_ms:
                best_label, best_ms = label, ms
                best_knobs = {"ncentroids": cc, "nprobe": pp}
    if best_knobs is None:
        raise RuntimeError(
            f"autotune_ivf: no eligible candidate for n={n} d={d} k={k} "
            f"(errors: {errors})")
    return {
        "knobs": best_knobs,
        "winner": best_label,
        "winner_ms": round(best_ms, 3),
        "timings_ms": timings,
        "errors": errors,
        "stats_per_candidate": stats_per,
        "gate": "bitwise-vs-reference",
        "runs": int(runs),
        "n_queries": int(queries.shape[0]),
        "selector": selector,
        "device_kind": device_kind,
        "backend": dev.type,
        "measured_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
