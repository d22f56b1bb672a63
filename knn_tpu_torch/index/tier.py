"""What both index tiers (MutableIndex, IVFIndex) share: the id rules of
their writes, the compaction thresholds, their serving frontends' query
check and write routing, and the background compactor —
one thread that compacts whenever the tier says a compaction is due,
under the contract that a failure never vanishes: the last exception is
kept (``stats()["last_compaction_error"]``) and :meth:`Compactor.close`
re-raises it after waiting for the thread, however long a compaction in
flight takes, and each failure is also an ``index.compact_error`` event
(knn_tpu_torch.obs, as the JAX package's loop emits it).  The JAX
package's loops swallow every exception; a CUDA fault here must reach
the caller."""

from __future__ import annotations

import threading
from typing import Callable, Optional, Tuple

import numpy as np

from knn_tpu_torch import obs

#: pause after a failed compaction, so a persistent fault does not spin
FAILURE_BACKOFF_S = 0.25


def checked_rows(vectors, ids, dim: int) -> Tuple[np.ndarray, np.ndarray]:
    """An insert's ``(rows [N, dim] f32, ids [N] int64)``, refusing a
    shape mismatch and repeated ids with ``ValueError``."""
    v = np.ascontiguousarray(np.asarray(vectors, np.float32))
    if v.ndim != 2 or v.shape[1] != dim:
        raise ValueError(f"vectors must be [N, {dim}], got {v.shape}")
    ids_arr = np.asarray(ids, dtype=np.int64).reshape(-1)
    if ids_arr.shape[0] != v.shape[0]:
        raise ValueError(f"{ids_arr.shape[0]} ids for {v.shape[0]} rows")
    if np.unique(ids_arr).shape[0] != ids_arr.shape[0]:
        raise ValueError("insert ids must be unique")
    return v, ids_arr


def check_fresh(ids_arr: np.ndarray, live: set, tombstones: set) -> None:
    """Refuses (``ValueError``) an insert id that is live, or tombstoned
    this epoch (its mask would shadow the new row; compaction frees it).
    Caller holds the tier's lock."""
    for i in ids_arr.tolist():
        if i in live:
            raise ValueError(f"id {i} is already live")
        if i in tombstones:
            raise ValueError(
                f"id {i} was deleted this epoch; compact() before reusing "
                f"the id")


def check_live(ids_arr: np.ndarray, live: set) -> None:
    """Refuses (``KeyError``) a delete of an unknown or dead id.  Caller
    holds the tier's lock."""
    for i in ids_arr.tolist():
        if i not in live:
            raise KeyError(f"id {i} is not live")


def thresholds_tripped(tail_rows: int, tombstones: int,
                       compact_tail_rows: Optional[int],
                       compact_tombstones: Optional[int]) -> bool:
    """Whether a tier's delta tail or tombstone count has reached its
    compaction threshold (None: that threshold is off)."""
    return ((compact_tail_rows is not None
             and tail_rows >= compact_tail_rows)
            or (compact_tombstones is not None
                and tombstones >= compact_tombstones))


class Frontend:
    """What both tiers' serving frontends share besides ``submit``: the
    request check, ``search`` over ``submit``, and the write routing
    ``QueryQueue.submit_write`` reaches through :meth:`apply_write`."""

    def __init__(self, index):
        self.index = index
        self.k = index.k
        self._dim = index.dim

    def _checked(self, queries, op: str) -> np.ndarray:
        """A request's queries as ``[Q, dim]`` f32, refusing (``ValueError``)
        any op but ``search`` and a shape mismatch."""
        if op != "search":
            raise ValueError(
                f"{type(self).__name__} serves op='search' only, got {op!r}")
        q = np.ascontiguousarray(np.asarray(queries, np.float32))
        if q.ndim != 2 or q.shape[1] != self._dim:
            raise ValueError(
                f"queries shape {q.shape} incompatible with database "
                f"dim {self._dim}")
        return q

    def search(self, queries, *, return_sqrt: bool = False):
        d, ids = self.submit(queries).result()
        if return_sqrt:
            d = np.sqrt(d)
        return d, ids

    def apply_write(self, kind: str, *, vectors=None, ids=None) -> dict:
        """The write op the queue routes (insert / delete)."""
        if kind == "insert":
            return self.index.insert(vectors, ids)
        if kind == "delete":
            return self.index.delete(ids)
        raise ValueError(
            f"unknown write kind {kind!r}; expected insert|delete")


class Compactor:
    """A tier's compaction thread.  ``lock`` is the tier's Condition (its
    writers notify it); ``due()`` runs under it and says whether to
    compact now; ``compact()`` runs outside it.  While nothing is due the
    thread waits on the condition, for at most ``poll_s`` seconds when
    given (None: until notified)."""

    def __init__(self, lock: threading.Condition, name: str):
        self._lock = lock
        self._name = name
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        #: the last compaction's exception, None after a clean run
        self.error: Optional[BaseException] = None

    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def error_text(self) -> Optional[str]:
        err = self.error
        return None if err is None else f"{type(err).__name__}: {err}"

    def start(self, compact: Callable[[], object],
              due: Callable[[], bool], poll_s: Optional[float]) -> None:
        """Starts the thread; a no-op while one runs."""
        def loop():
            while True:
                with self._lock:
                    while not self._closed and not due():
                        self._lock.wait(timeout=poll_s)
                    if self._closed:
                        return
                try:
                    compact()
                except Exception as e:  # noqa: BLE001 — kept, re-raised by close()
                    obs.emit_event("index.compact_error",
                                   error=f"{type(e).__name__}: {e}")
                    with self._lock:
                        self.error = e
                        self._lock.wait(timeout=FAILURE_BACKOFF_S)

        with self._lock:
            if self.alive:
                return
            self._closed = False
            self._thread = threading.Thread(target=loop, name=self._name,
                                            daemon=True)
            self._thread.start()

    def close(self) -> None:
        """Stops the thread, waiting out a compaction in flight, and
        re-raises the last recorded exception."""
        with self._lock:
            self._closed = True
            self._lock.notify_all()
            t = self._thread
        if t is not None:
            t.join()
        if self.error is not None:
            raise self.error
