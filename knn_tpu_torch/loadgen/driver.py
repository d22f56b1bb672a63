"""Open-loop load driver: submit a generated schedule against a serving
target and record what happened to every request — the port of
knn_tpu/loadgen/driver.py.

Arrival times come from the schedule (knn_tpu_torch.loadgen.workload),
never from completions.  Requests are partitioned round-robin across
dedicated **submitter threads** that sleep until each request's arrival
time and call ``target.submit(...)``, while separate **waiter threads**
block on the returned futures — so a saturated target slows
completions, never arrivals.

Every request lands one record in a bounded result log with an explicit
outcome:

- ``ok`` — admitted and completed;
- ``rejected:<reason>`` — refused at submit by admission control
  (``queue_full`` / ``quota`` / ``deadline``);
- ``shed:<reason>`` — admitted, then dropped before device dispatch;
- ``error`` — resolved with a non-admission exception.

:func:`report` aggregates the log: offered/admitted counts, the outcome
breakdown, admitted-request latency percentiles, achieved q/s and the
shed fraction, with write and bulk lanes in sections of their own.

The target is anything with a ``QueryQueue``-shaped ``submit``
(``submit(queries, tenant=..., deadline_ms=..., priority=...)`` ->
``Future``): the micro-batching queue, or
:class:`~knn_tpu_torch.loadgen.synthetic.SyntheticTarget`.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np

from knn_tpu_torch.loadgen.workload import Request
from knn_tpu_torch.serving.admission import AdmissionError

#: result-log bound: a long sweep must not grow per-request state
#: forever (the report counts EVERY request; only detail records are
#: bounded — dropped ones are counted, never silently lost)
DEFAULT_LOG_CAP = 65536


class ResultLog:
    """Bounded per-request record store + unbounded outcome counters:
    aggregate truth is always complete, detail is recent."""

    def __init__(self, cap: int = DEFAULT_LOG_CAP):
        self._lock = threading.Lock()
        self._records: deque = deque(maxlen=int(cap))
        self._dropped = 0
        self._outcomes: Dict[str, int] = {}
        self._by_tenant: Dict[str, Dict[str, int]] = {}
        #: write-op outcome counts, kind -> outcome -> n (kept apart
        #: from the read outcomes above: a write's latency must never
        #: pollute the ADMITTED-read percentiles the SLO judges)
        self._writes: Dict[str, Dict[str, int]] = {}
        #: bulk-join lane: outcome counts + ok latencies for ``bulk``
        #: requests (offline join superblocks riding the schedule).
        #: Same isolation contract as writes — the batch lane gets its
        #: own section, the admitted-read percentiles stay query-only.
        self._bulk: Dict[str, int] = {}
        self._bulk_lat: deque = deque(maxlen=int(cap))
        #: (tenant, latency_s, trace_id) of ok-outcome requests, bounded
        #: with the records (percentiles are window truth, counts are
        #: lifetime); the trace id is what joins a knee artifact's tail
        #: requests back to their spans/waterfalls
        self._lat: deque = deque(maxlen=int(cap))

    def add(self, rec: dict) -> None:
        kind = rec.get("kind", "query")
        with self._lock:
            if len(self._records) == self._records.maxlen:
                self._dropped += 1
            self._records.append(rec)
            out = rec["outcome"]
            if kind == "bulk":
                self._bulk[out] = self._bulk.get(out, 0) + 1
                if out == "ok" and rec.get("latency_s") is not None:
                    self._bulk_lat.append(rec["latency_s"])
                return
            if kind != "query":
                slot = self._writes.setdefault(kind, {})
                slot[out] = slot.get(out, 0) + 1
                return
            self._outcomes[out] = self._outcomes.get(out, 0) + 1
            slot = self._by_tenant.setdefault(rec["tenant"], {})
            slot[out] = slot.get(out, 0) + 1
            if out == "ok" and rec.get("latency_s") is not None:
                self._lat.append((rec["tenant"], rec["latency_s"],
                                  rec.get("trace_id")))

    def records(self) -> List[dict]:
        with self._lock:
            return list(self._records)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "outcomes": dict(self._outcomes),
                "by_tenant": {t: dict(v)
                              for t, v in self._by_tenant.items()},
                "writes": {k: dict(v)
                           for k, v in self._writes.items()},
                "bulk": dict(self._bulk),
                "bulk_latencies": list(self._bulk_lat),
                "records_kept": len(self._records),
                "records_dropped": self._dropped,
                "latencies": list(self._lat),
            }


def _percentiles_ms(vals: Sequence[float]) -> Optional[dict]:
    """Millisecond latency summary — the serving layer's latency_summary,
    so the knee block's quantiles round as the engine's stats() do."""
    from knn_tpu_torch.serving.engine import latency_summary

    return latency_summary(list(vals))


def _outcome_of(exc: Exception) -> str:
    if isinstance(exc, AdmissionError):
        return f"shed:{exc.reason}"
    return "error"


#: base for the driver's deterministic write-id series — far above any
#: realistic corpus id, so generated inserts can't collide with base ids
WRITE_ID_BASE = 1 << 40


def run_workload(target, requests: Sequence[Request], *, queries,
                 submitters: int = 2, waiters: int = 2,
                 log_cap: int = DEFAULT_LOG_CAP,
                 time_scale: float = 1.0,
                 include_records: bool = False,
                 write_id_base: int = WRITE_ID_BASE) -> dict:
    """Drive ``requests`` against ``target`` open-loop and return the
    :func:`report`.  ``queries`` is the row pool requests slice their
    payload from (content is irrelevant to load; shape fidelity is
    what matters).  ``time_scale`` stretches (>1) or compresses (<1)
    the schedule — compressing a recorded trace is how a replay
    becomes a stress test.

    Write requests (``Request.kind`` insert/delete — the TenantSpec
    write-stream mix) go through ``target.submit_write``: inserts
    allocate ids from a monotone series starting at ``write_id_base``
    (fresh target per run, or pass a disjoint base), deletes retire the
    oldest still-live inserted id (none live yet -> the explicit
    ``skipped:no_live_id`` outcome, never an error).  Their outcomes
    land in the log's ``writes`` section and NEVER in the admitted-read
    latency percentiles.

    Bulk requests (``Request.kind`` == ``bulk`` — the TenantSpec
    ``bulk_fraction`` lane, offline join superblocks mixed into the
    serving schedule) are READS: they ride ``target.submit`` and the
    same admission control as queries, but their outcomes and latencies
    land in the report's ``bulk`` section — the interactive read-side
    percentiles stay query-only either way."""
    if not requests:
        raise ValueError("empty request schedule")
    if submitters < 1 or waiters < 1:
        raise ValueError("submitters and waiters must be >= 1")
    pool = np.ascontiguousarray(np.asarray(queries, np.float32))
    if pool.ndim != 2:
        raise ValueError(f"queries pool must be 2-D, got {pool.shape}")
    max_rows = max(r.rows for r in requests)
    if pool.shape[0] < max_rows:
        raise ValueError(
            f"queries pool has {pool.shape[0]} rows; schedule needs "
            f"{max_rows}")
    has_writes = any(r.kind in ("insert", "delete") for r in requests)
    if has_writes and not hasattr(target, "submit_write"):
        raise ValueError(
            f"schedule carries write ops but target "
            f"{type(target).__name__} has no submit_write (drive a "
            f"MutableServingEngine-backed queue, or the synthetic "
            f"target)")
    log = ResultLog(log_cap)
    import itertools
    import queue as _q

    inflight: _q.Queue = _q.Queue()
    #: monotone insert-id series + the live-id pool deletes draw from
    #: (pushed by the waiter on confirmed inserts)
    id_seq = itertools.count(int(write_id_base))
    id_lock = threading.Lock()
    live_ids: deque = deque()
    t0 = time.monotonic()

    def _submit_write(r: Request, t_sub: float, base: dict) -> None:
        base["kind"] = r.kind
        if r.kind == "insert":
            with id_lock:
                ids = [next(id_seq) for _ in range(r.rows)]
            base["write_ids"] = ids
            kwargs = {"vectors": pool[: r.rows], "ids": ids}
        else:
            with id_lock:
                wid = live_ids.popleft() if live_ids else None
            if wid is None:
                log.add({**base, "outcome": "skipped:no_live_id",
                         "dispatch_s": None, "completion_s": None,
                         "latency_s": None})
                return
            base["write_ids"] = [wid]
            kwargs = {"ids": [wid]}
        try:
            fut = target.submit_write(r.kind, tenant=r.tenant,
                                      **kwargs)
        except Exception as e:  # noqa: BLE001 — recorded, not fatal
            log.add({**base, "outcome": "error",
                     "error": f"{type(e).__name__}: {e}",
                     "dispatch_s": None, "completion_s": None,
                     "latency_s": None})
            return
        base["trace_id"] = getattr(fut, "trace_id", None)
        fut.add_done_callback(
            lambda f: setattr(f, "done_t", time.monotonic()))
        inflight.put((base, fut, t_sub))

    def _submit(part: List[Request]) -> None:
        for r in part:
            due = t0 + r.t * time_scale
            delay = due - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            t_sub = time.monotonic()
            base = {
                "tenant": r.tenant, "rows": r.rows,
                "arrival_s": round(t_sub - t0, 6),
                "scheduled_s": round(r.t * time_scale, 6),
                "deadline_ms": r.deadline_ms,
                "priority": r.priority,
            }
            if r.kind in ("insert", "delete"):
                _submit_write(r, t_sub, base)
                continue
            if r.kind == "bulk":
                # a bulk-join superblock is a READ — it rides the same
                # submit path and admission control as queries, only its
                # outcome is logged into the batch lane, never the
                # admitted-read percentiles
                base["kind"] = "bulk"
            try:
                fut = target.submit(
                    pool[: r.rows], tenant=r.tenant,
                    deadline_ms=r.deadline_ms, priority=r.priority)
            except AdmissionError as e:
                log.add({**base, "outcome": f"rejected:{e.reason}",
                         "dispatch_s": None, "completion_s": None,
                         "latency_s": None})
                continue
            except Exception as e:  # noqa: BLE001 — recorded, not fatal
                log.add({**base, "outcome": "error",
                         "error": f"{type(e).__name__}: {e}",
                         "dispatch_s": None, "completion_s": None,
                         "latency_s": None})
                continue
            # the queue stamps its trace id on the future at submit
            # (alongside the dispatch_t contract): recorded so a knee
            # artifact's shed/tail requests can be joined against
            # traces and waterfalls
            base["trace_id"] = getattr(fut, "trace_id", None)
            # completion is stamped by the RESOLVING thread, not by the
            # waiter: the waiters drain a FIFO, so a request completing
            # out of order (priority scheduling) would otherwise have
            # its head-of-line wait billed as latency
            fut.add_done_callback(
                lambda f: setattr(f, "done_t", time.monotonic()))
            inflight.put((base, fut, t_sub))

    def _wait() -> None:
        while True:
            item = inflight.get()
            if item is None:
                break
            base, fut, t_sub = item
            outcome = "ok"
            err = None
            try:
                fut.result()
            except Exception as e:  # noqa: BLE001 — outcome, not crash
                outcome = _outcome_of(e)
                if outcome == "error":
                    err = f"{type(e).__name__}: {e}"
            if outcome == "ok" and base.get("kind") == "insert":
                # confirmed inserts feed the delete-id pool: a delete
                # can only ever target a row the target acknowledged
                with id_lock:
                    live_ids.extend(base["write_ids"])
            t_done = getattr(fut, "done_t", None) or time.monotonic()
            disp = getattr(fut, "dispatch_t", None)
            log.add({
                **base, "outcome": outcome,
                **({"error": err} if err else {}),
                "dispatch_s": (None if disp is None
                               else round(disp - t0, 6)),
                "completion_s": round(t_done - t0, 6),
                "latency_s": (round(t_done - t_sub, 6)
                              if outcome == "ok" else None),
            })

    parts: List[List[Request]] = [[] for _ in range(submitters)]
    for i, r in enumerate(requests):
        parts[i % submitters].append(r)
    sub_threads = [threading.Thread(target=_submit, args=(p,),
                                    name=f"loadgen-submit-{i}", daemon=True)
                   for i, p in enumerate(parts) if p]
    wait_threads = [threading.Thread(target=_wait,
                                     name=f"loadgen-wait-{i}", daemon=True)
                    for i in range(waiters)]
    for t in wait_threads:
        t.start()
    for t in sub_threads:
        t.start()
    for t in sub_threads:
        t.join()
    for _ in wait_threads:
        inflight.put(None)
    for t in wait_threads:
        t.join()
    wall = time.monotonic() - t0
    rep = report(log, offered=len(requests), wall_s=wall)
    if include_records:
        rep["records"] = log.records()
    return rep


def report(log: ResultLog, *, offered: int, wall_s: float) -> dict:
    """Aggregate the log: overall + per-tenant outcome counts, ADMITTED
    latency percentiles, achieved q/s, shed fraction.  Schedules with a
    write stream also carry a ``writes`` section (per-kind outcome
    counts), and schedules with a bulk-join lane a ``bulk`` section
    (outcomes + the batch lane's own latency summary); every read-side
    number — offered, shed fraction, percentiles — covers QUERIES
    only, so neither mix can dilute the admitted-read latency story."""
    snap = log.snapshot()
    writes = snap.get("writes") or {}
    n_writes = sum(sum(v.values()) for v in writes.values())
    bulk = snap.get("bulk") or {}
    n_bulk = sum(bulk.values())
    offered -= n_writes + n_bulk  # read-side offered: queries only
    outcomes = snap["outcomes"]
    ok = outcomes.get("ok", 0)
    rejected = sum(v for k, v in outcomes.items()
                   if k.startswith("rejected:"))
    shed = sum(v for k, v in outcomes.items() if k.startswith("shed:"))
    errors = outcomes.get("error", 0)
    lat_all = [s for _, s, _ in snap["latencies"]]
    per_tenant = {}
    for tenant, outs in sorted(snap["by_tenant"].items()):
        t_ok = outs.get("ok", 0)
        t_total = sum(outs.values())
        t_lat = [s for t, s, _ in snap["latencies"] if t == tenant]
        per_tenant[tenant] = {
            "offered": t_total,
            "ok": t_ok,
            "outcomes": outs,
            "latency_ms": _percentiles_ms(t_lat),
            "shed_fraction": (round(1.0 - t_ok / t_total, 4)
                              if t_total else None),
        }
    return {
        "offered": offered,
        "ok": ok,
        "rejected": rejected,
        "shed": shed,
        "errors": errors,
        "outcomes": outcomes,
        "wall_s": round(wall_s, 4),
        "offered_qps": (round(offered / wall_s, 2) if wall_s > 0
                        else None),
        "achieved_qps": round(ok / wall_s, 2) if wall_s > 0 else None,
        #: fraction of offered requests that did NOT complete ok —
        #: rejections, sheds, and errors all count (they are all load
        #: the server declined)
        "shed_fraction": (round((offered - ok) / offered, 4)
                          if offered else None),
        "latency_ms": _percentiles_ms(lat_all),
        #: the worst ADMITTED requests by latency, with the trace ids
        #: the queue stamped at submit — the knee sweep's tail becomes
        #: cross-examinable against spans/waterfalls (cli waterfall)
        "slowest": [
            {"tenant": t, "latency_ms": round(s * 1e3, 3),
             "trace_id": tid}
            for t, s, tid in sorted(snap["latencies"],
                                    key=lambda x: -x[1])[:5]
        ],
        "per_tenant": per_tenant,
        # write-stream outcome counts (kind -> outcome -> n), present
        # only when the schedule carried writes — the replayable
        # mixed-scenario record beside the read-side numbers
        **({"writes": {
            **{k: dict(v) for k, v in writes.items()},
            "total": n_writes,
            "ok": sum(v.get("ok", 0) for v in writes.values()),
        }} if writes else {}),
        # bulk-join batch lane (kind == "bulk"): its own outcome
        # counts and latency summary, present only when the schedule
        # carried bulk superblocks — the join/serving interference
        # record, kept beside (never inside) the read-side percentiles
        **({"bulk": {
            "outcomes": dict(bulk),
            "total": n_bulk,
            "ok": bulk.get("ok", 0),
            "latency_ms": _percentiles_ms(snap.get("bulk_latencies")
                                          or []),
        }} if bulk else {}),
        "records_kept": snap["records_kept"],
        "records_dropped": snap["records_dropped"],
    }
