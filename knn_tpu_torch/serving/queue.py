"""Dynamic micro-batching: coalesce concurrent small requests into one
bucketed dispatch — the port of knn_tpu/serving/queue.py.

:class:`QueryQueue` holds arriving requests for at most ``max_wait_ms``
and concatenates everything that accumulates into ONE engine dispatch
(padded up the bucket ladder), then scatters the result rows back to
each caller's future.  Every query row's result is independent of its
batchmates (see serving.engine), so the scattered results are bitwise
the coalesced batch submitted directly.

Two threads: the **batcher** collects and enqueues (the engine returns
before the device finishes), the **completer** waits on each batch and
resolves its futures, so the batcher keeps enqueueing batch N+1 while
batch N runs.

**Admission control** (knn_tpu_torch.serving.admission) layers on top and
is off by default: with ``max_depth``/``admission`` unset the queue's
results and ``stats()`` are those of the queue without admission.
Enabled, ``submit()`` can raise an
:class:`~knn_tpu_torch.serving.admission.AdmissionError` (bounded depth,
per-tenant quota, unmeetable deadline), queued requests whose deadline
expires are shed before dispatch, and dispatch order becomes aged
priority instead of FIFO.

Telemetry (knn_tpu_torch.obs; queue.py:157-175, 204, 246-252, 278,
290-307, 504-611 of the JAX package): each request gets its own trace id
at submit (``fut.trace_id``), kept through coalescing — the batch's
engine dispatch has an id of its own, and the ``queue.dispatch`` event
lists its members' ids; the ``serving.admission``, ``serving.queue_wait``,
``serving.deliver``, ``serving.queued_request`` and ``serving.write``
spans, the depth gauges, the ``QUEUE_*`` counters, the wait and latency
histograms and the tenant series follow each request, and the queue
registers with obs.health (its worker threads feed readiness).  The
batcher, the completer, the client threads and a compactor write the
registry at once; its locks keep the counts exact.
"""

from __future__ import annotations

import dataclasses
import queue as _queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import List, Optional

import numpy as np

from knn_tpu_torch import obs
from knn_tpu_torch.analysis.annotations import hot_path
from knn_tpu_torch.obs import names as mn
from knn_tpu_torch.serving.admission import (
    AdmissionConfig,
    AdmissionController,
    DeadlineError,
)


class _Pending:
    """One queued request: the payload plus the admission fields that ride
    with it (each request keeps its own arrival time, so the max-wait
    deadline is per request)."""

    __slots__ = ("q", "fut", "t_arr", "tid", "tenant", "deadline",
                 "priority")

    def __init__(self, q, fut, t_arr, tid=None, tenant=None, deadline=None,
                 priority=0):
        self.q = q
        self.fut = fut
        self.t_arr = t_arr
        self.tid = tid  # this request's trace id, coalescing-proof
        self.tenant = tenant
        self.deadline = deadline  # absolute monotonic seconds, or None
        self.priority = priority


class QueryQueue:
    """Micro-batching frontend over a :class:`~knn_tpu_torch.serving.
    engine.ServingEngine` (or any engine with its ``buckets``, ``_dim``,
    ``submit() -> handle`` and ``stats()``: the index tiers' frontends).

    ``submit(queries)`` returns a ``concurrent.futures.Future`` resolving
    to ``(distances, indices)`` (op="search") or ``labels``
    (op="predict") for exactly the submitted rows.  A batch dispatches as
    soon as ``max_rows`` rows accumulate, or when the oldest pending
    request has waited ``max_wait_ms``.

    ``max_depth`` bounds OUTSTANDING work — queued plus in flight
    (``submit`` raises :class:`~knn_tpu_torch.serving.admission.
    QueueFullError` past it); ``admission`` is the full policy.  Both
    default off.

    Thread-safety: guarded by ``self._cond``; the completer thread's
    service-rate state is its own.  Use as a context manager, or call
    :meth:`close` (flushes pending requests, then joins both threads).
    """

    def __init__(
        self,
        engine,
        *,
        max_wait_ms: float = 2.0,
        max_rows: Optional[int] = None,
        op: str = "search",
        max_depth: Optional[int] = None,
        admission: Optional[AdmissionConfig] = None,
    ):
        from knn_tpu_torch.serving.engine import OPS

        if op not in OPS:
            raise ValueError(f"unknown op {op!r}; expected one of {OPS}")
        if max_wait_ms < 0:
            raise ValueError(f"max_wait_ms must be >= 0, got {max_wait_ms}")
        if max_depth is not None and admission is not None \
                and admission.max_depth is not None \
                and admission.max_depth != max_depth:
            raise ValueError(
                f"conflicting depth bounds: max_depth={max_depth} vs "
                f"admission.max_depth={admission.max_depth}")
        self.engine = engine
        self.op = op
        self.max_wait_s = max_wait_ms / 1e3
        self.max_rows = int(max_rows or engine.buckets[-1])
        if admission is None and max_depth is not None:
            # a bare depth bound is the smallest possible policy
            admission = AdmissionConfig(max_depth=max_depth)
        elif admission is not None and max_depth is not None \
                and admission.max_depth is None:
            admission = dataclasses.replace(admission, max_depth=max_depth)
        #: None = admission off = the queue without admission
        self._ctrl: Optional[AdmissionController] = (
            None if admission is None else
            AdmissionController(admission, base_wait_s=self.max_wait_s))
        self._cond = threading.Condition()
        self._pending: List[_Pending] = []
        self._pending_rows = 0
        #: OUTSTANDING work = admitted and not yet resolved (queued or in
        #: flight); admission's depth bound and wait estimate judge this
        self._out_req = 0
        self._out_rows = 0
        #: previous batch-completion time (completer thread only)
        self._last_done_t: Optional[float] = None
        self._closed = False
        self._stats = {"requests": 0, "dispatches": 0, "coalesced_rows": 0,
                       "errors": 0}
        #: queue-depth gauges: the backlog the max-wait deadline holds
        self._g_depth_req = obs.gauge(mn.QUEUE_DEPTH_REQUESTS)
        self._g_depth_rows = obs.gauge(mn.QUEUE_DEPTH_ROWS)
        #: arrival-to-result latency of queued requests, a bounded window
        #: of (monotonic ts, seconds) pairs (deque.append is atomic)
        self._lat: deque = deque(maxlen=4096)
        self._done: _queue.Queue = _queue.Queue()
        self._batcher_t = threading.Thread(
            target=self._batcher, name="knn-serving-batcher", daemon=True)
        self._completer_t = threading.Thread(
            target=self._completer, name="knn-serving-completer", daemon=True)
        self._batcher_t.start()
        self._completer_t.start()
        # worker-thread liveness feeds the readiness probe (/healthz)
        obs.health.register_queue(self)

    # -- client side -------------------------------------------------------
    @hot_path(allow=("np.asarray", "np.ascontiguousarray", "int"))
    def submit(self, queries, *, tenant: Optional[str] = None,
               deadline_ms: Optional[float] = None,
               priority: Optional[int] = None) -> Future:
        """Queue ``queries`` for a coalesced dispatch.  ``tenant`` tags the
        request for quota accounting; ``deadline_ms`` (relative to now)
        enables deadline-aware shedding when the policy has it on;
        ``priority`` overrides the tenant's configured level (lower
        dispatches first; ignored without admission).  Raises
        :class:`~knn_tpu_torch.serving.admission.AdmissionError` on an
        explicit rejection."""
        q = np.ascontiguousarray(np.asarray(queries, dtype=np.float32))
        if q.ndim != 2 or q.shape[1] != self.engine._dim:
            # refused here: a malformed request would otherwise fail the
            # whole coalesced batch it rode in with
            raise ValueError(
                f"queries must be [N, {self.engine._dim}], got shape "
                f"{q.shape}")
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError(
                f"deadline_ms must be > 0, got {deadline_ms}")
        fut: Future = Future()
        tid = obs.new_trace_id()  # this request's id, coalescing-proof
        fut.trace_id = tid
        # arrival is stamped before the cond: lock wait is part of what
        # the caller experiences
        now = time.monotonic()
        with self._cond:
            if self._closed:
                raise RuntimeError("QueryQueue is closed")
            deadline = (None if deadline_ms is None
                        else now + deadline_ms / 1e3)
            prio = 0
            if self._ctrl is not None:
                # decided inside the lock: the depth read and the append
                # are one judgment (the controller never takes the cond)
                deadline = self._ctrl.admit(
                    tenant=tenant, depth=self._out_req,
                    rows=self._out_rows, deadline_s=deadline, now=now)
                prio = (self._ctrl.priority_of(tenant)
                        if priority is None else int(priority))
            self._pending.append(_Pending(q, fut, now, tid, tenant, deadline,
                                          prio))
            self._pending_rows += q.shape[0]
            self._out_req += 1
            self._out_rows += q.shape[0]
            self._stats["requests"] += 1
            self._g_depth_req.set(len(self._pending))
            self._g_depth_rows.set(self._pending_rows)
            self._cond.notify_all()
        if tid is not None:
            # lock wait and the admit decision, inside the queue-wait window
            obs.record_span(
                "serving.admission", tid, time.monotonic() - now,
                rows=int(q.shape[0]),
                **({"tenant": tenant} if tenant is not None else {}))
        obs.counter(mn.QUEUE_REQUESTS).inc()
        if tenant is not None:
            obs.counter(mn.TENANT_REQUESTS, tenant=tenant).inc()
        return fut

    def submit_write(self, kind: str, *, vectors=None, ids=None,
                     tenant: Optional[str] = None) -> Future:
        """Writes beside queries: route an ``insert``/``delete`` to the
        engine's index (``apply_write`` of a
        :class:`~knn_tpu_torch.index.mutable.MutableServingEngine` or an
        :class:`~knn_tpu_torch.ivf.index.IVFServingEngine`) and return a
        resolved Future carrying the write report (or the index's
        refusal).  Writes apply at once under the index's own lock —
        snapshot pinning, not queue order, makes them atomic against
        micro-batches in flight.  ``stats()`` gains a ``writes`` section
        once a write passed through."""
        apply = getattr(self.engine, "apply_write", None)
        if apply is None:
            raise ValueError(
                f"this queue's engine ({type(self.engine).__name__}) "
                f"serves an immutable placement — writes need a "
                f"MutableServingEngine (knn_tpu_torch.index)")
        with self._cond:
            if self._closed:
                raise RuntimeError("QueryQueue is closed")
        fut: Future = Future()
        tid = obs.new_trace_id()
        fut.trace_id = tid
        t0 = time.monotonic()
        try:
            out = apply(kind, vectors=vectors, ids=ids)
        except Exception as e:  # noqa: BLE001 — an outcome, not a crash
            self._count_write(kind, error=True, tenant=tenant)
            fut.set_exception(e)
        else:
            self._count_write(kind, error=False, tenant=tenant)
            fut.set_result(out)
        fut.dispatch_t = time.monotonic()
        obs.record_span(
            "serving.write", tid, time.monotonic() - t0, kind=kind,
            **({"tenant": tenant} if tenant is not None else {}))
        return fut

    def _count_write(self, kind: str, *, error: bool,
                     tenant: Optional[str] = None) -> None:
        with self._cond:
            w = self._stats.setdefault(
                "writes", {"insert": 0, "delete": 0, "errors": 0})
            if error:
                w["errors"] += 1
            elif kind in ("insert", "delete"):
                w[kind] += 1
        if tenant is not None:
            obs.counter(mn.TENANT_REQUESTS, tenant=tenant).inc()
            if error:
                obs.counter(mn.TENANT_ERRORS, tenant=tenant).inc()

    def close(self) -> None:
        """Flush every pending request, then stop both threads."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        self._batcher_t.join()
        self._completer_t.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def stats(self) -> dict:
        from knn_tpu_torch.serving.engine import latency_summary

        with self._cond:
            out = dict(self._stats)
            if "writes" in out:
                out["writes"] = dict(out["writes"])
        out["latency_ms"] = latency_summary(list(self._lat))
        # present only with admission: the admission-off stats() shape is
        # the queue's without it
        if self._ctrl is not None:
            out["admission"] = self._ctrl.stats()
        out["engine"] = self.engine.stats()
        return out

    # -- worker threads ----------------------------------------------------
    @staticmethod
    def _resolve(fut: Future, value=None, exc: Optional[Exception] = None):
        """Resolve a future, tolerating client-side cancellation."""
        if fut.cancelled():
            return
        try:
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(value)
        except Exception:  # noqa: BLE001 — cancelled in the race window
            pass

    def _select_indices(self, now: float) -> List[int]:
        """Indices (into ``_pending``) of the next batch, in dispatch
        order.  FIFO without admission; with it, aged priority — lower
        ``priority - waited/aging_s`` first, arrival-stable among ties.
        Requests stay whole, and the batch stops at the first candidate
        that would overflow ``max_rows`` (no skip-scan: size never becomes
        a starvation channel)."""
        if self._ctrl is None or (
                not self._ctrl.config.priorities
                and all(p.priority == 0 for p in self._pending)):
            order = range(len(self._pending))
        else:
            order = sorted(
                range(len(self._pending)),
                key=lambda i: (self._ctrl.effective_priority(
                    self._pending[i].priority,
                    now - self._pending[i].t_arr), i))
        picked: List[int] = []
        rows = 0
        for i in order:
            r = self._pending[i].q.shape[0]
            if picked and rows + r > self.max_rows:
                break
            picked.append(i)
            rows += r
            if rows >= self.max_rows:
                break
        return picked

    def _take_batch(self):
        """Block until a batch is due (rows >= max_rows, the oldest
        request's max-wait hit, or closing with work pending); returns
        ``(batch, shed)`` — ``shed`` are expired requests to resolve
        outside the lock.  ``(None, shed)`` means closed and drained."""
        shed: List[_Pending] = []
        with self._cond:
            while True:
                # shed expired requests before judging batch readiness: an
                # expired request must neither ride a batch nor hold the
                # max-wait clock
                if (self._ctrl is not None and self._ctrl.config.shed
                        and self._pending):
                    now = time.monotonic()
                    live = []
                    for p in self._pending:
                        if p.deadline is not None and p.deadline < now:
                            shed.append(p)
                            self._pending_rows -= p.q.shape[0]
                        else:
                            live.append(p)
                    if shed and len(live) != len(self._pending):
                        self._pending = live
                        self._g_depth_req.set(len(self._pending))
                        self._g_depth_rows.set(self._pending_rows)
                        return [], shed
                if self._pending:
                    if self._closed or self._pending_rows >= self.max_rows:
                        break
                    # a request left behind by a full earlier batch keeps
                    # its own deadline: max_wait_ms is a real bound
                    wake = self._pending[0].t_arr + self.max_wait_s
                    if self._ctrl is not None and self._ctrl.config.shed:
                        # never sleep past a request deadline
                        for p in self._pending:
                            if p.deadline is not None and p.deadline < wake:
                                wake = p.deadline
                    wait = wake - time.monotonic()
                    if wait <= 0:
                        if wake < self._pending[0].t_arr + self.max_wait_s:
                            continue  # a deadline fired, not the batch
                            # clock: re-sweep and keep coalescing
                        break
                    self._cond.wait(timeout=wait)
                elif self._closed:
                    return None, shed
                else:
                    self._cond.wait()
            now = time.monotonic()
            batch = [self._pending[i] for i in self._select_indices(now)]
            taken = set(id(p) for p in batch)
            self._pending = [p for p in self._pending
                             if id(p) not in taken]
            self._pending_rows -= sum(p.q.shape[0] for p in batch)
            self._g_depth_req.set(len(self._pending))
            self._g_depth_rows.set(self._pending_rows)
            return batch, shed

    def _retire(self, items: List[_Pending]) -> None:
        """Resolved requests leave the outstanding count, whatever the
        outcome."""
        with self._cond:
            for p in items:
                self._out_req -= 1
                self._out_rows -= p.q.shape[0]

    def _shed_expired(self, shed: List[_Pending]) -> None:
        for p in shed:
            self._ctrl.record_shed(p.tenant, "expired")
            self._resolve(p.fut, exc=DeadlineError(
                "deadline expired while queued (shed before dispatch)",
                tenant=p.tenant, reason="expired"))
        self._retire(shed)

    @hot_path(allow=("int",))
    def _batcher(self) -> None:
        while True:
            batch, shed = self._take_batch()
            if shed:
                self._shed_expired(shed)
            if batch is None:
                break
            if not batch:
                continue
            try:
                # inside the guard: any failure resolves this batch's
                # futures and never kills the batcher
                arrays = [p.q for p in batch]
                cat = arrays[0] if len(arrays) == 1 else np.concatenate(arrays)
                offsets = np.cumsum([0] + [a.shape[0] for a in arrays])
                # every member's queue-wait span closes at dispatch, under
                # its own trace id; the coalesced engine request gets a
                # batch id of its own, linked in the event below
                t_disp = time.monotonic()
                for p in batch:
                    obs.record_span(
                        "serving.queue_wait", p.tid, t_disp - p.t_arr,
                        rows=int(p.q.shape[0]),
                        **({"tenant": p.tenant}
                           if p.tenant is not None else {}))
                    obs.histogram(mn.QUEUE_WAIT).observe(
                        t_disp - p.t_arr, exemplar=p.tid)
                    # the loadgen driver reads the dispatch time
                    p.fut.dispatch_t = t_disp
                handle = self.engine.submit(cat, op=self.op)
                obs.emit_event(
                    "queue.dispatch", op=self.op,
                    batch_trace_id=handle.trace_id,
                    member_trace_ids=[p.tid for p in batch],
                    rows=int(offsets[-1]), requests=len(batch))
            except Exception as e:  # noqa: BLE001 — resolve, don't kill
                self._record_errors(batch)
                for p in batch:
                    self._resolve(p.fut, exc=e)
                self._retire(batch)
                continue
            with self._cond:
                self._stats["dispatches"] += 1
                self._stats["coalesced_rows"] += int(offsets[-1])
            obs.counter(mn.QUEUE_DISPATCHES).inc()
            obs.counter(mn.QUEUE_COALESCED_ROWS).inc(int(offsets[-1]))
            self._done.put((handle, batch, offsets, t_disp))
        self._done.put(None)

    def _completer(self) -> None:
        while True:
            item = self._done.get()
            if item is None:
                break
            handle, batch, offsets, t_disp = item
            try:
                res = handle.result()
            except Exception as e:  # noqa: BLE001 — per-batch isolation
                self._record_errors(batch)
                for p in batch:
                    self._resolve(p.fut, exc=e)
                self._retire(batch)
                continue
            done_t = time.monotonic()
            if self._ctrl is not None:
                # the wait estimator's feed: the smaller of dispatch-to-done
                # (inflated by in-flight predecessors under load) and the
                # inter-completion gap (inflated by idle time at low load)
                span = done_t - t_disp
                prev = self._last_done_t
                if prev is not None:
                    span = min(span, done_t - prev)
                self._last_done_t = done_t
                self._ctrl.observe_service(int(offsets[-1]), span)
            for j, p in enumerate(batch):
                lo, hi = int(offsets[j]), int(offsets[j + 1])
                if self.op == "search":
                    d, i = res
                    self._resolve(p.fut, (d[lo:hi], i[lo:hi]))
                else:
                    self._resolve(p.fut, res[lo:hi])
                self._lat.append((done_t, done_t - p.t_arr))
                # arrival to result under the request's own trace id
                obs.histogram(mn.QUEUE_REQUEST_LATENCY).observe(
                    done_t - p.t_arr, exemplar=p.tid)
                if p.tenant is not None:
                    obs.histogram(mn.TENANT_REQUEST_LATENCY,
                                  tenant=p.tenant).observe(
                        done_t - p.t_arr, exemplar=p.tid)
                if p.tid is not None:
                    # deliver: batch completion to this member's future;
                    # the request span ends here, at delivery
                    t_res = time.monotonic()
                    ten = ({"tenant": p.tenant}
                           if p.tenant is not None else {})
                    obs.record_span("serving.deliver", p.tid,
                                    t_res - done_t, **ten)
                    obs.record_span("serving.queued_request", p.tid,
                                    t_res - p.t_arr, op=self.op,
                                    rows=int(p.q.shape[0]),
                                    batch_trace_id=handle.trace_id, **ten)
            self._retire(batch)

    def _record_errors(self, batch: List[_Pending]) -> None:
        with self._cond:
            self._stats["errors"] += len(batch)
        obs.counter(mn.QUEUE_ERRORS).inc(len(batch))
        for p in batch:
            if p.tenant is not None:
                obs.counter(mn.TENANT_ERRORS, tenant=p.tenant).inc()
