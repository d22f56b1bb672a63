"""Mutable index on one GPU: delta-tail inserts, tombstone deletes and
snapshot-swap compaction over an immutable placement, and its serving
frontend — the port of knn_tpu/index/mutable.py (``MutableIndex``,
``MutableServingEngine``).

- **Delta tail** — :meth:`MutableIndex.insert` appends rows to a small
  device-resident tail searched beside the main placement.  The tail pads
  up a geometric capacity ladder and is searched by
  :func:`~knn_tpu_torch.parallel.sharded.segment_search_program`, whose
  valid-row count is a runtime argument, so a growing tail keeps its
  shape while it stays on its rung.
- **Tombstone deletes** — :meth:`MutableIndex.delete` marks ids dead.  The
  main placement selects ``k_eff = k + reserve``, so after dead rows are
  masked out of the merged candidate list the surviving top-k is the
  exact top-k of the live rows: at most ``reserve`` tombstones can precede
  them.  A delete past the reserve is refused (compaction resets it).
- **Snapshot-swap compaction** — :meth:`MutableIndex.compact` builds a
  fresh placement from the surviving rows off the search path and swaps
  it in under the index lock: the epoch bumps, searches already running
  finish on the snapshot they pinned.  With a serving frontend, the
  replacement :class:`~knn_tpu_torch.serving.engine.ServingEngine` is
  built and warmed (on the card: its CUDA graphs captured) before the
  swap, off the serving path.
- **Serving** — :meth:`MutableIndex.serving_engine` returns a
  :class:`MutableServingEngine`, the ``QueryQueue``-facing frontend: each
  request pins one snapshot, rides the snapshot's bucketed engine for the
  main placement, and searches the delta tail padded to the same rung;
  writes enter through :meth:`MutableServingEngine.apply_write`
  (``QueryQueue.submit_write``).

Exactness contract: after any interleaving of inserts, deletes and
compactions, :meth:`MutableIndex.search_certified` is bitwise-identical to
a fresh index built from the surviving rows, whatever the coarse
precision and kernel — each part's candidate set is certified exact, the
final distances are float64-refined per pair (ops.refine) and the
cross-part merge is the lexicographic (distance, position) order.

Where the port differs from the JAX package (ROADMAP queue C): every knob
is an argument (no ``KNN_TPU_DELTA_*`` / ``KNN_TPU_COMPACT_*`` switch);
``search_certified`` defaults to the ``"pallas"`` selector, as the port's
``ShardedKNN`` does (the final ``(d, ids)`` are the same); no transient
retry (a CUDA error raises at once); the background compactor records its
last exception (``stats()["last_compaction_error"]``) and
:meth:`MutableIndex.close` re-raises it, beside the JAX package's
``index.compact_error`` event; and the drift monitor and ``index_health``
gauges wait for the second obs slice (ROADMAP divergence 22).

Telemetry (knn_tpu_torch.obs, mutable.py:302-305, 405, 439, 716-722, 903,
969 of the JAX package): the ``INDEX_EPOCH`` / ``INDEX_TAIL_ROWS`` /
``INDEX_TOMBSTONES`` gauges follow every write and swap, a compaction
counts ``INDEX_COMPACTIONS``, observes its swap into
``INDEX_SWAP_SECONDS`` and records an ``index.compact`` span, the
frontend adds ``serving.request`` slices for its snapshot pin and its
merge, and the index registers with obs.health.

Threads and streams: compaction builds its placement on the compactor
thread while searches run on others.  Every tier works on the default
CUDA stream, so a search enqueued after the swap is ordered after the new
placement's copies and kernels.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from knn_tpu_torch import obs
from knn_tpu_torch.obs import names as _mn

from knn_tpu_torch.device import DeviceLike, resolve_device
from knn_tpu_torch.index.artifact import (MutationBudgetError,
                                          MutationUnsupportedError)
from knn_tpu_torch.index.tier import (Compactor, Frontend, check_fresh,
                                     check_live, checked_rows,
                                     thresholds_tripped)
from knn_tpu_torch.ops.topk import I32MAX

#: delta-tail capacity ladder defaults (rows)
DELTA_MIN_ROWS = 256
DELTA_MAX_ROWS = 65536
#: certify-widening reserve: the main placement selects k + reserve so up
#: to ``reserve`` tombstones can be masked without losing exactness
DELTA_RESERVE = 32

#: int64 sentinel for "no candidate" positions in the merged list — larger
#: than any real global position, so it sorts last and maps to id -1
_SENT64 = np.int64(1) << 62


class _Snapshot:
    """One immutable, search-consistent view of the index, pinned at
    :meth:`MutableIndex._snapshot` time.  Swaps replace the index's current
    snapshot; searches in flight keep theirs (and through it the old
    placement) alive until they finish — the epoch visibility rule."""

    __slots__ = ("epoch", "main", "base_ids", "tail", "tail_ids",
                 "tail_len", "tail_parts_count", "tomb_ids", "n_base",
                 "all_ids", "engine", "k_eff")

    def __init__(self, epoch, main, base_ids, tail, tail_ids,
                 tail_parts_count, tomb_ids, engine, k_eff):
        self.epoch = epoch
        self.main = main
        #: the serving engine over ``main`` (None without a frontend)
        self.engine = engine
        self.base_ids = base_ids
        self.tail = tail  # [T, D] f32 or None
        self.tail_ids = tail_ids
        self.tail_len = 0 if tail is None else tail.shape[0]
        self.tail_parts_count = tail_parts_count
        self.tomb_ids = tomb_ids  # sorted int64 array
        self.n_base = base_ids.shape[0]
        self.all_ids = (base_ids if tail is None
                        else np.concatenate([base_ids, tail_ids]))
        self.k_eff = k_eff

    def live_rows(self) -> int:
        return self.n_base + self.tail_len - self.tomb_ids.shape[0]

    def ids_of(self, pos: np.ndarray) -> np.ndarray:
        """External ids for global positions; sentinel / out-of-range
        positions map to -1 (dead)."""
        n_total = self.all_ids.shape[0]
        valid = (pos >= 0) & (pos < n_total)
        safe = np.clip(pos, 0, n_total - 1)
        return np.where(valid, self.all_ids[safe], np.int64(-1))


class _TailHandle:
    """An enqueued tail search: its device outputs, fetched and mapped to
    global positions on demand."""

    __slots__ = ("out", "rows", "n_base")

    def __init__(self, out, rows: int, n_base: int):
        self.out = out
        self.rows = rows
        self.n_base = n_base

    def fetch(self) -> Tuple[np.ndarray, np.ndarray]:
        """(d [rows, k_t] f32, pos [rows, k_t] int64 global positions);
        masked slots carry +inf / the int64 sentinel."""
        d = self.out[0].cpu().numpy()[: self.rows]
        i = self.out[1].cpu().numpy()[: self.rows].astype(np.int64)
        pos = np.where(i == I32MAX, _SENT64, i + self.n_base)
        return d, pos


class MutableIndex:
    """A mutable KNN index over an immutable main placement (a port
    :class:`~knn_tpu_torch.parallel.sharded.ShardedKNN` on ``device``,
    default ``cuda``) plus a device-resident delta tail and an id
    tombstone set (see the module docstring).  ``search`` /
    ``search_certified`` return ``(distances, ids)`` in external id space
    (``ids`` at construction, ``insert``'s ids afterwards).

    Thread-safety: guarded by ``self._lock`` (a Condition: writers notify
    the background compactor).  Searches pin a consistent snapshot under
    the lock and run lock-free on it; the lock is never held across a
    device launch."""

    def __init__(
        self,
        train,
        ids: Optional[Sequence[int]] = None,
        *,
        k: int,
        metric: str = "l2",
        train_tile: Optional[int] = None,
        compute_dtype=None,
        reserve: int = DELTA_RESERVE,
        delta_min_rows: int = DELTA_MIN_ROWS,
        delta_max_rows: int = DELTA_MAX_ROWS,
        compact_tail_rows: Optional[int] = None,
        compact_tombstones: Optional[int] = None,
        device: DeviceLike = None,
        hbm_budget_bytes: Optional[int] = None,
    ):
        from knn_tpu_torch.parallel.sharded import ShardedKNN

        if metric.lower() not in ("l2", "sql2", "euclidean"):
            raise MutationUnsupportedError(
                f"MutableIndex supports the l2 metric family only, got "
                f"{metric!r} (cosine re-normalizes rows at placement "
                f"and L1 has no certified bound)")
        self.device = resolve_device(device)
        train = np.ascontiguousarray(np.asarray(train, np.float32))
        if train.ndim != 2:
            raise ValueError(f"train must be 2-D, got {train.shape}")
        n, dim = train.shape
        if ids is None:
            ids_arr = np.arange(n, dtype=np.int64)
        else:
            ids_arr = np.asarray(ids, dtype=np.int64).reshape(-1)
            if ids_arr.shape[0] != n:
                raise ValueError(
                    f"ids length {ids_arr.shape[0]} != rows {n}")
            if np.unique(ids_arr).shape[0] != n:
                raise ValueError("ids must be unique")
        self.k = int(k)
        self.dim = int(dim)
        self.metric = metric.lower()
        self._reserve = int(reserve)
        if self._reserve < 1:
            raise ValueError(f"reserve must be >= 1, got {self._reserve}")
        self._delta_min = int(delta_min_rows)
        self._delta_max = int(delta_max_rows)
        self._compact_tail_rows = compact_tail_rows
        self._compact_tombstones = compact_tombstones
        #: constructor args replayed by compaction when it builds the fresh
        #: placement — one home, so a compacted placement can never differ
        #: from the original's configuration
        self._ctor = dict(metric=self.metric, train_tile=train_tile,
                          compute_dtype=compute_dtype, device=self.device,
                          hbm_budget_bytes=hbm_budget_bytes)
        if self.k > n:
            raise ValueError(f"k={k} > {n} database rows")
        self._main = ShardedKNN(train, k=self._k_eff_for(n), **self._ctor)
        #: tail searches always select k + reserve
        self._k_tail = self.k + self._reserve
        if self._delta_min < 1 or self._delta_max < self._delta_min:
            raise ValueError(
                f"delta ladder [{self._delta_min}, {self._delta_max}] "
                f"is not a valid range")
        self._lock = threading.Condition()
        self._epoch = 0
        self._base_ids = ids_arr
        self._tail_parts: List[np.ndarray] = []
        self._tail_id_parts: List[np.ndarray] = []
        self._tail_len = 0
        self._tombstones: set = set()
        self._live: set = set(ids_arr.tolist())
        self._snap_cache: Optional[_Snapshot] = None
        self._tail_place: Optional[dict] = None
        self._compactions = 0
        self._last_compaction: Optional[dict] = None
        #: the background compaction thread and its last exception
        self._compactor = Compactor(self._lock, "knn-index-compactor")
        #: serializes compactions (taken before _lock, which compact()
        #: holds only for the snapshot and the swap)
        self._compact_lock = threading.Lock()
        #: the serving frontend's engine over the main placement and the
        #: kwargs compaction rebuilds it with (None until serving_engine())
        self._inner_engine = None
        self._engine_kwargs: Optional[dict] = None
        obs.gauge(_mn.INDEX_EPOCH).set(0.0)
        obs.gauge(_mn.INDEX_TAIL_ROWS).set(0.0)
        obs.gauge(_mn.INDEX_TOMBSTONES).set(0.0)
        obs.health.register_index(self)

    # -- construction helpers ---------------------------------------------
    def _k_eff_for(self, n_rows: int) -> int:
        """The widened select width for an ``n_rows`` main placement:
        k + reserve, capped by the rows."""
        return min(self.k + self._reserve, n_rows)

    @property
    def budget(self) -> int:
        """Tombstones the current epoch can absorb before exactness would
        need a wider select than the placement's — delete() refuses past
        it, compaction resets it."""
        return self._main.k - self.k

    # -- snapshots ---------------------------------------------------------
    def _snapshot(self) -> _Snapshot:
        """The current consistent view (cached; invalidated by every
        mutation and swap)."""
        with self._lock:
            snap = self._snap_cache
            if snap is not None:
                return snap
            tail = (None if self._tail_len == 0 else
                    np.concatenate(self._tail_parts))
            tail_ids = (None if self._tail_len == 0 else
                        np.concatenate(self._tail_id_parts))
            snap = _Snapshot(
                self._epoch, self._main, self._base_ids, tail, tail_ids,
                len(self._tail_parts),
                np.asarray(sorted(self._tombstones), np.int64),
                self._inner_engine, self._main.k)
            self._snap_cache = snap
            return snap

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    # -- refusals ------------------------------------------------------------
    def _require_mutable(self, what: str) -> None:
        if self._main._host_tier is not None:
            raise MutationUnsupportedError(
                f"{what}: this placement runs the host-RAM shard tier "
                f"(corpus exceeds the HBM budget); the delta tail has no "
                f"resident placement to merge against — compact offline "
                f"and rebuild, or raise the budget")

    # -- writes ------------------------------------------------------------
    def insert(self, vectors, ids) -> dict:
        """Append rows to the delta tail under fresh unique ids, visible to
        every search started after this returns.  Raises
        :class:`MutationBudgetError` past the tail's top ladder rung and
        ``ValueError`` on id reuse — including ids tombstoned this epoch
        (their mask would shadow the new row; compaction frees the id)."""
        self._require_mutable("insert")
        v, ids_arr = checked_rows(vectors, ids, self.dim)
        with self._lock:
            check_fresh(ids_arr, self._live, self._tombstones)
            if self._tail_len + v.shape[0] > self._delta_max:
                raise MutationBudgetError(
                    f"delta tail full: {self._tail_len} + {v.shape[0]} "
                    f"rows exceeds the {self._delta_max}-row top ladder "
                    f"rung; compact() (or raise delta_max_rows)")
            self._tail_parts.append(v)
            self._tail_id_parts.append(ids_arr)
            self._tail_len += v.shape[0]
            self._live.update(ids_arr.tolist())
            self._snap_cache = None
            tail_len = self._tail_len
            epoch = self._epoch
            self._lock.notify_all()  # wake the compactor
        obs.gauge(_mn.INDEX_TAIL_ROWS).set(float(tail_len))
        return {"epoch": epoch, "tail_rows": tail_len}

    def delete(self, ids) -> dict:
        """Tombstone live ids.  The rows stay placed until compaction;
        every search masks them out of the merged candidate list, the
        certify reserve guaranteeing the masked select is still the exact
        live top-k.  Refuses past the reserve budget
        (:class:`MutationBudgetError`) and on unknown or dead ids
        (``KeyError``)."""
        self._require_mutable("delete")
        ids_arr = np.asarray(ids, dtype=np.int64).reshape(-1)
        with self._lock:
            check_live(ids_arr, self._live)
            if len(self._tombstones) + ids_arr.shape[0] > self.budget:
                raise MutationBudgetError(
                    f"tombstone budget exhausted: "
                    f"{len(self._tombstones)} + {ids_arr.shape[0]} "
                    f"exceeds the certify reserve {self.budget} "
                    f"(k_eff={self._main.k} - k={self.k}); compact() "
                    f"to drop the dead rows")
            live_after = (self._base_ids.shape[0] + self._tail_len
                          - len(self._tombstones) - ids_arr.shape[0])
            if live_after < self.k:
                raise MutationBudgetError(
                    f"delete would leave {live_after} live rows < "
                    f"k={self.k}")
            self._tombstones.update(ids_arr.tolist())
            self._live.difference_update(ids_arr.tolist())
            self._snap_cache = None
            n_tombs = len(self._tombstones)
            epoch = self._epoch
            self._lock.notify_all()
        obs.gauge(_mn.INDEX_TOMBSTONES).set(float(n_tombs))
        return {"epoch": epoch, "tombstones": n_tombs}

    # -- delta-tail device search -----------------------------------------
    def _capacity_for(self, tail_len: int) -> int:
        """Smallest ladder rung holding ``tail_len`` rows: rungs double
        from a floor that lets the tail rank k + reserve rows."""
        cap = max(self._delta_min, self._k_tail)
        while cap < tail_len:
            cap *= 2
        return cap

    def _tail_device(self, snap: _Snapshot) -> dict:
        """The snapshot's tail placed on the device at its ladder-rung
        capacity (cached per (epoch, tail_len): inserts re-place, a stable
        tail is copied once)."""
        key = (snap.epoch, snap.tail_len)
        with self._lock:
            tp = self._tail_place
            if tp is not None and tp["key"] == key:
                return tp
        capacity = self._capacity_for(snap.tail_len)
        arr = np.zeros((capacity, self.dim), np.float32)
        if snap.tail_len:
            arr[: snap.tail_len] = snap.tail
        placed = {"key": key, "capacity": capacity,
                  "tp": torch.from_numpy(arr).to(self.device),
                  "nv": snap.tail_len}
        with self._lock:
            self._tail_place = placed
        return placed

    def _dispatch_tail(self, snap: _Snapshot, q_np: np.ndarray
                       ) -> _TailHandle:
        """Enqueues the tail search — the segment program at the tail's
        rung, its valid-row count a runtime argument — over the snapshot's
        placed tail; the handle's fetch merges on the host."""
        from knn_tpu_torch.parallel.sharded import segment_search_program

        dev = self._tail_device(snap)
        prog = segment_search_program(
            self._k_tail, snap.main.metric,
            train_tile=self._ctor["train_tile"],
            compute_dtype=snap.main._dtype_key, device=self.device)
        qp, n_q = snap.main._place_queries(q_np)
        return _TailHandle(prog(qp, dev["tp"], dev["nv"]), n_q, snap.n_base)

    # -- merged, masked selection -----------------------------------------
    @staticmethod
    def _merge_filter(snap: _Snapshot, d_parts, p_parts, k: int):
        """Lexicographic (distance, global position) merge of per-part
        candidate lists, tombstones and sentinels masked out, first k
        survivors kept — an order a monotone position remap (compaction,
        the fresh oracle) preserves."""
        cd = (d_parts[0] if len(d_parts) == 1
              else np.concatenate(d_parts, axis=1))
        cp = (p_parts[0] if len(p_parts) == 1
              else np.concatenate(p_parts, axis=1))
        order = np.lexsort((cp, cd), axis=-1)
        cd = np.take_along_axis(cd, order, axis=-1)
        cp = np.take_along_axis(cp, order, axis=-1)
        ids = snap.ids_of(cp)
        dead = ids < 0
        if snap.tomb_ids.size:
            dead |= np.isin(ids, snap.tomb_ids)
        # stable partition: live candidates keep their merged order
        sel = np.argsort(dead, kind="stable", axis=-1)[:, :k]
        if bool(np.take_along_axis(dead, sel, axis=-1).any()):
            raise RuntimeError(
                "masked merge ran out of live candidates — the certify "
                "reserve no longer covers the tombstone count (index "
                "invariant violated)")
        return (np.take_along_axis(cd, sel, axis=-1),
                np.take_along_axis(ids, sel, axis=-1))

    def _check_queries(self, queries) -> np.ndarray:
        q = np.ascontiguousarray(np.asarray(queries, np.float32))
        if q.ndim != 2 or q.shape[1] != self.dim:
            raise ValueError(
                f"queries must be [N, {self.dim}], got {q.shape}")
        return q

    def search(self, queries, *, k: Optional[int] = None,
               return_sqrt: bool = False):
        """(distances [Q, k] f32, ids [Q, k] int64) of the k nearest live
        rows: the widened main select merged with the delta-tail select,
        tombstones masked at merge time.  ``k`` may only shrink below the
        construction k (the reserve was sized for it)."""
        k = self.k if k is None else int(k)
        if not 0 < k <= self.k:
            raise ValueError(
                f"k={k} outside (0, {self.k}] — the certify reserve "
                f"was sized for the construction k")
        snap = self._snapshot()
        if k > snap.live_rows():
            raise ValueError(f"k={k} > {snap.live_rows()} live rows")
        q = self._check_queries(queries)
        tail_h = self._dispatch_tail(snap, q) if snap.tail_len else None
        d_m, i_m = snap.main.search(q)
        d_parts = [d_m.cpu().numpy()]
        p_parts = [i_m.cpu().numpy().astype(np.int64)]
        if tail_h is not None:
            d_t, p_t = tail_h.fetch()
            d_parts.append(d_t)
            p_parts.append(p_t)
        d, ids = self._merge_filter(snap, d_parts, p_parts, k)
        if return_sqrt:
            d = np.sqrt(d)
        return d, ids

    def search_certified(self, queries, *, margin: int = 28,
                         selector: str = "pallas",
                         timings: Optional[dict] = None, **knobs):
        """Certified-exact live top-k: ``(distances_f64, ids, stats)``.

        The main part runs the placement's certified search at the widened
        ``k_eff`` (``selector`` — default ``"pallas"``, the JAX package's
        is ``"approx"``, ROADMAP divergence 5 — and the coarse knobs pass
        through: ``precision="int8"``, ``kernel="fused"``, ...), so its
        candidate list is the exact top-k_eff; the delta tail is scanned
        in float64 on the host (small by construction).  Both parts'
        distances are float64-refined per pair, merged lexicographically,
        and tombstones masked under the reserve guarantee: bitwise a fresh
        index of the surviving rows.  ``timings``, when given a dict,
        receives the call's host-clock seconds by step: ``main_certified``
        (the placement's certified search, its kernel and repair),
        ``main_refine`` (the float64 refine of its candidates),
        ``tail_refine`` (the tail's float64 scan), ``merge`` (the masked
        merge) and ``other``."""
        from knn_tpu_torch.ops.refine import refine_exact

        t0 = time.perf_counter()
        steps = {}

        def lap(step: str, t: float) -> float:
            now = time.perf_counter()
            steps[step] = now - t
            return now

        snap = self._snapshot()
        if self.k > snap.live_rows():
            raise ValueError(f"k={self.k} > {snap.live_rows()} live rows")
        q = self._check_queries(queries)
        knobs.pop("return_distances", None)
        return_sqrt = bool(knobs.pop("return_sqrt", False))
        t = time.perf_counter()
        _, i_m, stats = snap.main.search_certified(
            q, margin=margin, selector=selector, return_distances=False,
            **knobs)
        t = lap("main_certified", t)
        # the float64 per-pair refine of the proven-exact candidate set:
        # independent of placement shape, coarse precision and kernel
        d64_m, i64_m = refine_exact(snap.main._host_train(), q, i_m,
                                    snap.k_eff)
        t = lap("main_refine", t)
        d_parts = [d64_m]
        p_parts = [i64_m]
        if snap.tail_len:
            k_t = min(self._k_tail, snap.tail_len)
            cand = np.broadcast_to(
                np.arange(snap.tail_len, dtype=np.int64),
                (q.shape[0], snap.tail_len))
            d64_t, i64_t = refine_exact(snap.tail, q, cand, k_t)
            d_parts.append(d64_t)
            p_parts.append(i64_t + snap.n_base)
        t = lap("tail_refine", t)
        d, ids = self._merge_filter(snap, d_parts, p_parts, self.k)
        lap("merge", t)
        if timings is not None:
            timings.update(steps, other=time.perf_counter() - t0
                           - sum(steps.values()))
        if return_sqrt:
            d = np.sqrt(d)
        stats = dict(stats)
        stats["index"] = {
            "epoch": snap.epoch,
            "k_eff": snap.k_eff,
            "tail_rows": snap.tail_len,
            "tombstones": int(snap.tomb_ids.shape[0]),
            "tail_certified": "host_f64",
        }
        return d, ids, stats

    # -- compaction --------------------------------------------------------
    def compact(self) -> dict:
        """Merge the tail and drop tombstoned rows into a fresh placement,
        then swap it in snapshot-consistently.  The build runs off the
        search path; only the final pointer swap takes the index lock, so
        searches in flight finish on the old epoch.  Writes that landed
        during the build carry over: rows inserted after the cut stay in
        the new tail, ids deleted after the cut stay tombstoned against
        the new placement."""
        from knn_tpu_torch.parallel.sharded import ShardedKNN

        self._require_mutable("compact")
        t0 = time.perf_counter()
        with self._compact_lock:
            snap = self._snapshot()
            tomb_snap = set(snap.tomb_ids.tolist())
            base_host = snap.main._host_train()
            keep_b = (~np.isin(snap.base_ids, snap.tomb_ids)
                      if snap.tomb_ids.size
                      else np.ones(snap.n_base, bool))
            parts = [base_host[keep_b]]
            id_parts = [snap.base_ids[keep_b]]
            dropped = int(snap.n_base - parts[0].shape[0])
            merged = 0
            if snap.tail_len:
                keep_t = (~np.isin(snap.tail_ids, snap.tomb_ids)
                          if snap.tomb_ids.size
                          else np.ones(snap.tail_len, bool))
                parts.append(snap.tail[keep_t])
                id_parts.append(snap.tail_ids[keep_t])
                dropped += int(snap.tail_len - parts[1].shape[0])
                merged = int(parts[1].shape[0])
            new_base = (parts[0] if len(parts) == 1
                        else np.concatenate(parts))
            new_ids = (id_parts[0] if len(id_parts) == 1
                       else np.concatenate(id_parts))
            if new_base.shape[0] < self.k:
                raise MutationBudgetError(
                    f"compaction would leave {new_base.shape[0]} rows "
                    f"< k={self.k}")
            new_main = ShardedKNN(new_base,
                                  k=self._k_eff_for(new_base.shape[0]),
                                  **self._ctor)
            from knn_tpu_torch.serving.engine import ServingEngine

            new_engine = None
            with self._lock:
                kw = self._engine_kwargs
                old_engine = self._inner_engine
            if kw is not None:
                # built and warmed off the serving path (on the card its
                # graphs are captured here, beside live replays): the first
                # request after the swap finds every rung ready
                new_engine = ServingEngine(new_main, **kw)
                new_engine.warmup(tuple(
                    sorted(getattr(old_engine, "warmed_ops", ()))
                    or ("search",)))
            t_swap = time.perf_counter()
            with self._lock:
                self._main = new_main
                self._base_ids = new_ids
                self._tail_parts = self._tail_parts[snap.tail_parts_count:]
                self._tail_id_parts = self._tail_id_parts[
                    snap.tail_parts_count:]
                self._tail_len = int(sum(p.shape[0]
                                         for p in self._tail_parts))
                self._tombstones = {t for t in self._tombstones
                                    if t not in tomb_snap}
                self._epoch += 1
                if new_engine is None and self._engine_kwargs is not None:
                    # a frontend made during the build: its rungs build
                    # at their first requests
                    new_engine = ServingEngine(new_main,
                                               **self._engine_kwargs)
                if new_engine is not None:
                    self._inner_engine = new_engine
                self._snap_cache = None
                self._tail_place = None
                self._compactions += 1
                report = self._last_compaction = {
                    "epoch": self._epoch,
                    "rows": int(new_base.shape[0]),
                    "rows_dropped": dropped,
                    "tail_rows_merged": merged,
                    "carry_tail_rows": self._tail_len,
                    "carry_tombstones": len(self._tombstones),
                    "wall_s": round(time.perf_counter() - t0, 4),
                    "swap_s": round(time.perf_counter() - t_swap, 6),
                }
        obs.counter(_mn.INDEX_COMPACTIONS).inc()
        obs.histogram(_mn.INDEX_SWAP_SECONDS).observe(report["swap_s"])
        obs.gauge(_mn.INDEX_EPOCH).set(float(report["epoch"]))
        obs.gauge(_mn.INDEX_TAIL_ROWS).set(float(report["carry_tail_rows"]))
        obs.gauge(_mn.INDEX_TOMBSTONES).set(
            float(report["carry_tombstones"]))
        obs.record_span("index.compact", None, report["wall_s"],
                        epoch=report["epoch"], rows=report["rows"],
                        rows_dropped=dropped, tail_rows_merged=merged,
                        swap_s=report["swap_s"])
        return dict(report)

    def _compact_due(self) -> bool:
        """Caller holds ``self._lock``."""
        return thresholds_tripped(self._tail_len, len(self._tombstones),
                                  self._compact_tail_rows,
                                  self._compact_tombstones)

    def start_compactor(self, interval_s: Optional[float] = None) -> None:
        """Start the background compaction thread: compacts whenever a
        threshold (``compact_tail_rows`` / ``compact_tombstones``) trips,
        or every ``interval_s`` while there is anything to fold in.  A
        failed compaction is recorded (``stats()["last_compaction_error"]``,
        re-raised by :meth:`close`) and the loop goes on.  Idempotent;
        ``close()`` stops it."""
        deadline = (None if interval_s is None
                    else time.monotonic() + interval_s)

        def due() -> bool:  # under self._lock
            nonlocal deadline
            if not self._compact_due() and not (
                    deadline is not None and time.monotonic() >= deadline
                    and (self._tail_len or self._tombstones)):
                return False
            if deadline is not None:
                deadline = time.monotonic() + interval_s
            return True

        # without an interval every state change notifies the condition
        self._compactor.start(
            self.compact, due,
            None if interval_s is None else min(0.05, interval_s))

    def close(self) -> None:
        """Stops the compactor, waiting out a compaction in flight;
        re-raises its last recorded exception."""
        self._compactor.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- serving -----------------------------------------------------------
    def serving_engine(self, **engine_kwargs) -> "MutableServingEngine":
        """A :class:`MutableServingEngine` over this index — the
        ``QueryQueue``-facing frontend that searches the delta tail beside
        every bucketed main dispatch and applies writes.  The engine kwargs
        (``buckets``, ``min_bucket``, ``max_bucket``, ``aot``, ...) are
        kept, so compaction builds and warms the replacement engine with
        them.  One frontend per index."""
        from knn_tpu_torch.serving.engine import ServingEngine

        with self._lock:
            if self._engine_kwargs is not None:
                raise RuntimeError(
                    "serving_engine() was already called for this index")
            # construction builds nothing, so it runs under the lock: the
            # engine and the placement it serves change together
            self._inner_engine = ServingEngine(self._main, **engine_kwargs)
            self._engine_kwargs = dict(engine_kwargs)
            self._snap_cache = None
        return MutableServingEngine(self)

    # -- reporting ---------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {
                "epoch": self._epoch,
                "k": self.k,
                "k_eff": self._main.k,
                "reserve": self._reserve,
                "budget": self._main.k - self.k,
                "rows": int(self._base_ids.shape[0]),
                "tail_rows": self._tail_len,
                "tail_capacity": self._capacity_for(self._tail_len),
                "tombstones": len(self._tombstones),
                "live_rows": (self._base_ids.shape[0] + self._tail_len
                              - len(self._tombstones)),
                "compactions": self._compactions,
                "compact_tail_rows": self._compact_tail_rows,
                "compact_tombstones": self._compact_tombstones,
                "compactor_alive": self._compactor.alive,
                "metric": self.metric,
                "last_compaction_error": self._compactor.error_text(),
                **({"last_compaction": dict(self._last_compaction)}
                   if self._last_compaction else {}),
            }


class _MutablePending:
    """An in-flight index-serving request: the inner engine's bucketed
    main dispatch plus the delta-tail search, merged and masked at result
    time (the tail's outputs are fetched first)."""

    __slots__ = ("_snap", "_pending", "_tail", "_k", "_result")

    def __init__(self, snap: _Snapshot, pending,
                 tail: Optional[_TailHandle], k: int):
        self._snap = snap
        self._pending = pending
        self._tail = tail
        self._k = k
        self._result = None

    @property
    def trace_id(self):
        return self._pending.trace_id

    @property
    def tenant(self):
        return self._pending.tenant

    def result(self):
        if self._result is not None:
            return self._result
        tail_parts = None
        if self._tail is not None:
            tail_parts = self._tail.fetch()
        d_m, i_m = self._pending.result()
        t0 = time.perf_counter()
        d_parts = [np.asarray(d_m)]
        p_parts = [np.asarray(i_m).astype(np.int64)]
        if tail_parts is not None:
            d_parts.append(tail_parts[0])
            p_parts.append(tail_parts[1])
        self._result = MutableIndex._merge_filter(
            self._snap, d_parts, p_parts, self._k)
        # the merge runs after the engine's request span closed: a slice of
        # its own keeps the request's spans tiling its latency
        obs.record_span("serving.request", self._pending.trace_id,
                        time.perf_counter() - t0, op="index_merge")
        return self._result


class MutableServingEngine(Frontend):
    """The serving frontend of a :class:`MutableIndex`: the ``ServingEngine``
    surface ``QueryQueue`` drives (``buckets``, ``_dim``, ``submit() ->
    handle``, ``stats()``), each request pinned to one index snapshot — a
    swap is atomic from a request's view — with the delta tail searched
    beside each bucketed main dispatch, padded to the same rung.  Writes
    enter through :meth:`apply_write` (``QueryQueue.submit_write``).  A
    request's ``(d, ids)`` is bitwise :meth:`MutableIndex.search` of its
    snapshot's padded batch (the main placement's and the tail's rows are
    ranked per query)."""

    @property
    def buckets(self):
        return self.index._snapshot().engine.buckets

    @property
    def warmed_ops(self):
        return getattr(self.index._snapshot().engine, "warmed_ops", set())

    def warmup(self, ops: Sequence[str] = ("search",)) -> dict:
        """Build the inner engine's executables and run the delta-tail
        program at every rung, so neither the first request nor the first
        request after an insert pays a first launch's set-up."""
        snap = self.index._snapshot()
        counts = snap.engine.warmup(ops)
        warmed = 0
        for b in snap.engine.buckets:
            q = np.zeros((int(b), self._dim), np.float32)
            self.index._dispatch_tail(snap, q).fetch()
            warmed += 1
        counts["tail_buckets"] = warmed
        return counts

    def submit(self, queries, *, op: str = "search",
               trace_id=None, tenant=None) -> _MutablePending:
        from knn_tpu_torch.serving.buckets import bucket_for

        t_ent = time.perf_counter()
        q = self._checked(queries, op)
        snap = self.index._snapshot()
        t_pre = time.perf_counter()
        pending = snap.engine.submit(q, op="search", trace_id=trace_id,
                                     tenant=tenant)
        # the prologue (checks, snapshot pin) before the engine's clock
        obs.record_span("serving.request", pending.trace_id,
                        t_pre - t_ent, op="index_snapshot")
        tail_h = None
        if snap.tail_len:
            b = bucket_for(snap.engine.buckets, q.shape[0])
            rows = int(b) if b is not None else q.shape[0]
            if rows > q.shape[0]:
                padded = np.zeros((rows, self._dim), np.float32)
                padded[: q.shape[0]] = q
            else:
                padded = q
            tail_h = self.index._dispatch_tail(snap, padded)
            tail_h.rows = q.shape[0]
        return _MutablePending(snap, pending, tail_h, self.k)

    def stats(self, **kw) -> dict:
        out = self.index._snapshot().engine.stats(**kw)
        out["index"] = self.index.stats()
        return out
