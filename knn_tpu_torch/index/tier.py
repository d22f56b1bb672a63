"""What both index tiers (MutableIndex, IVFIndex) share: their placement
on a device or a mesh (:func:`tier_mesh`), the ladder of padded shapes
their device searches run at (:func:`ladder_rung`), the id rules of
their writes, the compaction thresholds, their serving frontends' query
check and write routing, the agreement that keeps a compaction one epoch
across processes (:class:`AgreedCompaction`), and the background
compactor —
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


def tier_mesh(mesh, device):
    """The mesh a tier places on: ``mesh`` (a parallel.mesh.Mesh, one that
    spans processes included), else the one-device (1, 1) mesh on
    ``device`` (None: cuda, raising without a GPU); both given raises, as
    ``ShardedKNN`` does."""
    from knn_tpu_torch.device import resolve_device
    from knn_tpu_torch.parallel.mesh import make_mesh

    if mesh is not None and device is not None:
        raise ValueError("pass mesh= or device=, not both")
    if mesh is None:
        mesh = make_mesh(1, 1, devices=[resolve_device(device)])
    return mesh


def ladder_rung(rows: int, floor: int, multiple: int = 1) -> int:
    """The smallest rung of a doubling ladder that holds ``rows``: rungs
    double from ``floor`` rounded up to a multiple of ``multiple`` (a
    tier's db shards, so a rung divides evenly across them; the JAX
    package's ``_capacity_for`` / ``_seg_rung``), so a growing tail or a
    new probe set meets a handful of shapes, never one per size."""
    cap = -(-int(floor) // int(multiple)) * int(multiple)
    while cap < rows:
        cap *= 2
    return cap


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
        from knn_tpu_torch.parallel.mesh import require_one_process

        # serving over processes is queued: a queue cuts its batches by
        # wall time, which no two processes share
        require_one_process(index.mesh, type(self).__name__)
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


class AgreedCompaction:
    """A tier's compaction on a mesh that spans processes, where every
    process makes the same calls (inserts, deletes, reads, ``compact()``)
    in the same order and must answer each read from the same epoch.

    - **The cut is agreed.**  A compaction folds the state at a point of
      the call sequence, never at a wall time: ``compact()``'s call, or
      (with the compactor on) the write that trips a threshold, or the
      swap after which one is still tripped.  Every process sees the
      same writes, so every process cuts the same rows.
    - **The build has a group of its own.**  The build (:meth:`build`,
      on the compactor's thread or inside ``compact()``) issues its
      collectives (an IVF retrain's k-means searches) on a process group
      made for this tier (multihost.new_group, in the same order in every
      process), never on the readers' group.
    - **The swap is agreed.**  A finished build is staged, not swapped.
      A read starts with an agreement on the readers' group (one
      ``all_gather`` of each process's state, while a cut is pending):
      the staged build swaps in, in every process at once, only when
      every process has finished it; until then every process answers
      from the old epoch.  A build that failed anywhere is dropped
      everywhere (its process keeps the error for the compactor's
      ``close()``), and the cut is taken again while a threshold is
      tripped.

    ``lock`` is the tier's Condition; the tier supplies ``cut()`` (under
    the lock: the state a compaction folds), ``build(cut)`` (off the
    lock: the new placement), ``swap(cut, built)`` (takes the lock: the
    swap and its report) and ``tripped()`` (under the lock: a threshold
    is tripped).

    Thread-safety: guarded by ``self._lock`` (the tier's)."""

    #: one process's state in the agreement: its build still running,
    #: staged, or failed
    _PENDING, _READY, _FAILED = 1, 2, 3

    def __init__(self, lock: threading.Condition, tag: str, *, cut, build,
                 swap, tripped):
        self._lock = lock
        self._tag = tag
        self._cut_fn, self._build_fn = cut, build
        self._swap_fn, self._tripped = swap, tripped
        #: the compaction group, made at the first compaction
        self._group = None
        #: the cut a compaction folds (None: none pending), whether a
        #: thread builds it, and its build: ("ok", built) | ("error", e)
        self.cut = None
        self.building = False
        self.staged: Optional[tuple] = None
        #: the compactor is on: a write that trips a threshold cuts
        self.auto = False

    def _ensure_group(self) -> None:
        """The compaction group, made on the caller's (the foreground)
        thread at the same point of every process's calls."""
        from knn_tpu_torch.parallel import multihost

        if self._group is None:
            group = multihost.new_group(f"{self._tag}-compaction")
            with self._lock:
                self._group = group

    def start(self) -> None:
        """The compactor turns on (every process at the same call): from
        here a tripped threshold cuts, this call first."""
        self._ensure_group()
        with self._lock:
            self.auto = True
            self.note_write()

    def stop(self) -> None:
        with self._lock:
            self.auto = False

    def note_write(self) -> None:
        """After a write or a swap: with the compactor on, a tripped
        threshold cuts here unless a compaction is pending.  Caller holds
        ``self._lock``."""
        if self.auto and self.cut is None and self._tripped():
            self.cut = self._cut_fn()
            self._lock.notify_all()

    def due(self) -> bool:
        """A cut waits for its build.  Caller holds ``self._lock``."""
        return (self.cut is not None and not self.building
                and self.staged is None)

    def build(self) -> None:
        """Builds the pending cut on the compaction group and stages it (a
        no-op when none waits or another thread builds it); re-raises a
        failed build after staging it."""
        from knn_tpu_torch.parallel import multihost

        with self._lock:
            if not self.due():
                return
            self.building = True
            cut = self.cut
        try:
            with multihost.group_scope(self._group):
                built = self._build_fn(cut)
        except BaseException as e:
            with self._lock:
                self.building, self.staged = False, ("error", e)
                self._lock.notify_all()
            raise
        with self._lock:
            self.building, self.staged = False, ("ok", built)
            self._lock.notify_all()

    def agree(self) -> Optional[dict]:
        """At the start of a read, in every process: swaps the staged
        build in when every process has finished it, drops it when one
        failed; returns the swap's report (None: no swap).  No collective
        while no cut is pending, which every process knows alike."""
        from knn_tpu_torch.parallel import multihost

        with self._lock:
            if self.cut is None:
                return None
            state = (self._PENDING if self.staged is None else
                     self._READY if self.staged[0] == "ok" else self._FAILED)
        states = multihost.all_gather_ints([state])[:, 0]
        if (states < self._READY).any():
            return None
        with self._lock:
            built, cut = self.staged[1], self.cut
            self.cut, self.staged = None, None
            report = (self._swap_fn(cut, built)
                      if (states == self._READY).all() else None)
            self.note_write()
        return report

    def compact_now(self) -> dict:
        """``compact()`` over processes: folds the pending cut, or cuts
        here; builds it on this thread unless the compactor builds it,
        waits for this process's build, then agrees (every process has
        finished it: it swaps).  A pending cut older than this call is
        folded first, then this call's.  Raises a failed build's error."""
        self._ensure_group()
        while True:
            with self._lock:
                ours = self.cut is None
                if ours:
                    self.cut = self._cut_fn()
            try:
                self.build()
            except Exception:  # noqa: BLE001 - staged, raised below
                pass
            with self._lock:  # the compactor's thread may build it
                while self.staged is None:
                    self._lock.wait()
                kind, built = self.staged
            report = self.agree()
            if kind == "error":
                raise built
            if ours:
                return report
