"""A synthetic serving target with a known capacity — the device-free
test double for the loadgen harness; the port of
knn_tpu/loadgen/synthetic.py.

A single-server FIFO queue with a configured capacity: latency stays
near one service time below ``capacity_qps`` and grows without bound
above it, so its knee is known by construction.  ``submit`` has the
:class:`~knn_tpu_torch.serving.queue.QueryQueue` surface the driver
targets (``tenant``/``deadline_ms``/``priority``, a Future,
``dispatch_t`` stamped at service start), and the optional ``max_depth``
/ ``shed_deadlines`` knobs mimic admission.  Each future's ``trace_id``
is minted as the queue's is (knn_tpu_torch.obs; None with obs off).
"""

from __future__ import annotations

import queue as _queue
import threading
import time
from concurrent.futures import Future
from typing import Optional

from knn_tpu_torch.obs import new_trace_id
from knn_tpu_torch.serving.admission import DeadlineError, QueueFullError


class SyntheticTarget:
    """Single-server FIFO queue: service time ``1/capacity_qps`` per
    request, one worker thread — so an unloaded request's latency is
    one service time and the knee sits at ``capacity_qps`` by
    construction.  Close it (or use as a context manager) to join the
    worker."""

    def __init__(self, capacity_qps: float, *,
                 max_depth: Optional[int] = None,
                 shed_deadlines: bool = False):
        if capacity_qps <= 0:
            raise ValueError(
                f"capacity_qps must be > 0, got {capacity_qps}")
        self.capacity_qps = float(capacity_qps)
        self.max_depth = max_depth
        self.shed_deadlines = bool(shed_deadlines)
        self._q: _queue.Queue = _queue.Queue()
        self._depth = 0  # tracked explicitly: Queue.qsize is advisory
        #: write-op counts by kind (submit_write — the driver's
        #: write-stream accounting exercises against this)
        self.writes: dict = {}
        self._lock = threading.Lock()
        self._worker = threading.Thread(
            target=self._serve, name="synthetic-target", daemon=True)
        self._worker.start()

    def submit(self, queries, *, tenant: Optional[str] = None,
               deadline_ms: Optional[float] = None,
               priority: Optional[int] = None) -> Future:
        now = time.monotonic()
        with self._lock:
            if self.max_depth is not None and self._depth >= self.max_depth:
                raise QueueFullError(
                    f"synthetic queue at max_depth {self.max_depth}",
                    tenant=tenant)
            self._depth += 1
        fut: Future = Future()
        fut.trace_id = new_trace_id()
        deadline = None if deadline_ms is None else now + deadline_ms / 1e3
        self._q.put((fut, tenant, deadline))
        return fut

    def submit_write(self, kind: str, *, vectors=None, ids=None,
                     tenant: Optional[str] = None) -> Future:
        """Write-path double (the QueryQueue.submit_write surface): a
        synthetic index applies writes instantly, so the future
        resolves at submit and the counts land in ``self.writes`` —
        enough to exercise the driver's write-stream accounting without
        a device."""
        if kind not in ("insert", "delete"):
            raise ValueError(
                f"unknown write kind {kind!r}; expected insert|delete")
        fut: Future = Future()
        fut.trace_id = new_trace_id()
        with self._lock:
            self.writes[kind] = self.writes.get(kind, 0) + 1
        fut.dispatch_t = time.monotonic()
        fut.set_result({"op": kind,
                        "rows": 0 if ids is None else len(ids)})
        return fut

    def _serve(self) -> None:
        service_s = 1.0 / self.capacity_qps
        while True:
            item = self._q.get()
            if item is None:
                break
            fut, tenant, deadline = item
            now = time.monotonic()
            if (self.shed_deadlines and deadline is not None
                    and now > deadline):
                if not fut.cancelled():
                    fut.set_exception(DeadlineError(
                        "deadline expired in synthetic queue",
                        tenant=tenant, reason="expired"))
                with self._lock:
                    self._depth -= 1
                continue
            fut.dispatch_t = now
            time.sleep(service_s)
            if not fut.cancelled():
                fut.set_result(None)
            # retire AFTER service, matching the real queue's
            # outstanding (queued + in flight) depth semantics — a
            # dequeue-time decrement would admit one extra request at
            # every depth bound
            with self._lock:
                self._depth -= 1

    def close(self) -> None:
        self._q.put(None)
        self._worker.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
