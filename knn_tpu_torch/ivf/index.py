"""The approximate-first IVF tier with a certified escape hatch on one GPU —
the port of knn_tpu/ivf/index.py (``IVFIndex`` and its serving frontend
``IVFServingEngine``).

- **Coarse quantizer**: the seeded k-means of :mod:`knn_tpu_torch.ivf.
  kmeans` (host float64 init and update, k=1 assign on the device).
- **List-major placement**: corpus rows permuted into centroid-contiguous
  extents.  A search gathers only the probed lists' live rows (plus their
  delta-tail rows) into one block per probe set and ranks it on the
  device: ``selector="exact"`` through the padded segment program
  (:func:`knn_tpu_torch.parallel.sharded.segment_search_program`, the
  block padded up a ladder of rungs, its valid rows a runtime argument),
  ``selector="pallas"`` through
  :func:`knn_tpu_torch.ops.coarse_knn.knn_search_pallas` (one coarse
  kernel launch per probe group: K2 at the default ``precision=
  "highest"``, K1 / K10 / K11 / K5 ... through ``precision=`` and
  ``kernel=``), which certifies itself over the block.
- **Certificate**: for a row ``x`` of an unprobed list ``l`` with centroid
  ``c_l`` and residual radius ``r_l = max ||x - c_l||``, ``||q - x|| >=
  ||q - c_l|| - r_l``.  If the refined k-th distance beats that bound for
  every unprobed non-empty list, the probed answer is the exact answer;
  otherwise the query is repaired by a float64 re-score of every live row
  on the host (``ops.refine.refine_shared_exact``).  The final ``(d, i)``
  is always anchored in ``ops.refine.refine_exact`` over the canonical
  corpus, so results are selector-, precision- and kernel-independent
  (``nprobe == ncentroids`` is exact brute force bitwise) and bitwise the
  JAX package's.
- **Mutability**: delta tails per list absorb inserts (epoch visibility,
  id tombstones, budgeted refusal); compaction re-clusters the survivors
  and swaps the snapshot atomically.
- **Serving**: :meth:`IVFIndex.serving_engine` returns an
  :class:`IVFServingEngine`, the ``QueryQueue``-facing frontend: each
  request runs ``search_certified`` against the snapshot it pins, so a
  served answer is bitwise the direct certified search; writes enter
  through ``apply_write``.

The probe, the gathers, the float64 refine and the repair run on the
host, as in the JAX package (their arithmetic is what the bitwise
contract rests on).  Where the port differs (ROADMAP queue C): every knob
is an argument (no environment switch), the query block is not padded up a
rung (a new query count compiles nothing here), and the background
compactor records its last exception (``stats()["last_compaction_error"]``,
re-raised by :meth:`IVFIndex.close`); the serving frontend takes the
search knobs (``selector``, ``precision``) its requests run with, where
the JAX package's runs the defaults.

Telemetry (knn_tpu_torch.obs, ivf/index.py:218, 243-256, 465-468,
485-513, 571-586, 717, 794-795, 862-923 of the JAX package): each
certified query's margin to the unprobed lists' bound goes to
``CERTIFIED_MARGIN{path="ivf"}``, every search sets the ``IVF_*`` gauges
by selector and the ``index_health`` gauges (list imbalance, delta-tail
fraction, tombstone density), a compaction records an ``index.compact``
span, a frontend request a ``serving.request`` span, and the index
registers with obs.health.  While telemetry is on, each placement (the
first and every compaction's) builds a drift monitor (obs.drift) over its
rows' norms and its k-means counts; every search observes its queries'
norms and nearest centroids, and ``stats()["drift"]`` reports the PSIs.
The frontend's audit sampler pins the snapshot before the search and
replays a sampled request over that snapshot's live rows on the audit
worker (a compaction between the pin and the search drops the record as
``epoch_moved``).
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Sequence, Tuple

import numpy as np

from knn_tpu_torch import obs

from knn_tpu_torch.device import DeviceLike, resolve_device
from knn_tpu_torch.index.artifact import MutationBudgetError
from knn_tpu_torch.index.tier import (Compactor, Frontend, check_fresh,
                                     check_live, checked_rows,
                                     thresholds_tripped)
from knn_tpu_torch.ivf.kmeans import train_kmeans
from knn_tpu_torch.ops.certified import certification_tolerance
from knn_tpu_torch.ops.refine import refine_exact, refine_shared_exact
from knn_tpu_torch.ops.topk import I32MAX

#: coarse selectors this tier accepts: "exact" routes the gathered block
#: through the segment program (f32; the counted tolerance below assumes
#: it), "pallas" through knn_search_pallas (which certifies itself over
#: the block, any precision / kernel)
SELECTORS = ("exact", "pallas")

#: relative slack on the unprobed-list lower bound: the certificate
#: compares f64 values computed from exactly-representable f32 inputs, so
#: a sliver of multiplicative headroom dwarfs the f64 rounding while
#: erring only toward extra fallback (never a wrong certification)
_BOUND_SLACK = 1e-9


class _IVFSnapshot:
    """One immutable view of the index: searches pin a snapshot, so
    compaction swaps are atomic from a request's point of view."""

    __slots__ = (
        "epoch", "ncentroids", "centroids", "cent64", "residuals",
        "list_base_pos", "list_sizes", "tail_assign", "n_base",
        "all_rows", "all_ids", "live_mask", "live_positions", "n_live",
        "_pos_cache", "_norm2",
    )

    def __init__(self, **kw):
        for name in self.__slots__:
            setattr(self, name, kw.get(name))
        self._pos_cache = {}
        self._norm2 = None

    @property
    def n_all(self) -> int:
        return self.all_rows.shape[0]

    def norm2(self) -> np.ndarray:
        """[n_all] f64 squared row norms (lazy, shared by every group's
        within-block tolerance)."""
        if self._norm2 is None:
            r = self.all_rows.astype(np.float64)
            self._norm2 = np.einsum("nd,nd->n", r, r)
        return self._norm2

    def positions_for(self, key: Tuple[int, ...]) -> np.ndarray:
        """Sorted canonical positions of every live row in the probed
        lists ``key`` — base extents plus matching delta-tail rows,
        tombstones filtered; ascending, so block-local lexicographic tie
        order equals canonical tie order."""
        hit = self._pos_cache.get(key)
        if hit is not None:
            return hit
        parts = [self.list_base_pos[l] for l in key]
        if self.tail_assign.size:
            sel = np.isin(self.tail_assign, np.asarray(key, np.int64))
            parts.append(self.n_base + np.flatnonzero(sel))
        pos = (np.concatenate(parts) if parts
               else np.empty(0, np.int64)).astype(np.int64)
        pos = np.sort(pos[self.live_mask[pos]])
        self._pos_cache[key] = pos
        return pos


class IVFIndex:
    """A mutable, certified IVF placement over one canonical corpus, on
    ``device`` (default ``cuda``).

    ``search_certified`` returns ``(d, ids, stats)`` with ``d`` the exact
    squared-L2 float64 distances (``return_sqrt=True`` for Euclidean) —
    exact for every query, because certified probes are proven exact and
    flagged probes are repaired.  L2 only: the residual bound is a
    Euclidean triangle inequality.  Defaults are the JAX package's:
    ``ncentroids = round(sqrt(n))``, ``nprobe = ncentroids // 4``, 5
    k-means iterations, seed 0.
    """

    def __init__(
        self,
        train,
        ids=None,
        *,
        k: int,
        ncentroids: Optional[int] = None,
        nprobe: Optional[int] = None,
        train_iters: int = 5,
        seed: int = 0,
        metric: str = "l2",
        margin: int = 8,
        train_tile: Optional[int] = None,
        seg_min_rows: int = 256,
        delta_max_rows: int = 65536,
        compact_tail_rows: Optional[int] = None,
        compact_tombstones: Optional[int] = None,
        device: DeviceLike = None,
    ):
        if metric.lower() != "l2":
            raise ValueError(
                f"IVFIndex supports metric='l2' only (the residual "
                f"certificate is a Euclidean triangle inequality), got "
                f"{metric!r}")
        self.device = resolve_device(device)
        base = np.ascontiguousarray(np.asarray(train, np.float32))
        if base.ndim != 2:
            raise ValueError(f"train must be [N, D], got {base.shape}")
        n = base.shape[0]
        self.metric = "l2"
        self.dim = int(base.shape[1])
        self.k = int(k)
        self.margin = int(margin)
        self.train_tile = train_tile
        self.ncentroids = (int(ncentroids) if ncentroids is not None
                           else max(1, int(round(n ** 0.5))))
        self.ncentroids = max(1, min(self.ncentroids, n))
        self.nprobe = (int(nprobe) if nprobe is not None
                       else max(1, self.ncentroids // 4))
        self.nprobe = max(1, min(self.nprobe, self.ncentroids))
        self.train_iters = int(train_iters)
        self.seed = int(seed)
        if self.k > n:
            raise ValueError(f"k={self.k} > n={n}")
        ids_arr = (np.arange(n, dtype=np.int64) if ids is None
                   else np.asarray(ids, np.int64).reshape(-1))
        if ids_arr.shape[0] != n:
            raise ValueError(f"{ids_arr.shape[0]} ids for {n} rows")
        if np.unique(ids_arr).shape[0] != n:
            raise ValueError("ids must be unique")
        self._seg_min = int(seg_min_rows)
        self._delta_max = int(delta_max_rows)
        self._compact_tail_rows = compact_tail_rows
        self._compact_tombstones = compact_tombstones
        self._lock = threading.Condition()
        self._compact_lock = threading.Lock()
        self._compactions = 0
        self._last_compaction: Optional[dict] = None
        #: the background compaction thread and its last exception
        self._compactor = Compactor(self._lock, "ivf-compactor")
        self._last_search: Optional[dict] = None
        self.epoch = 0
        self._tail_parts: list = []
        self._tail_id_parts: list = []
        self._tail_assign_parts: list = []
        self._tail_len = 0
        self._tombstones: set = set()
        self._snap_cache: Optional[_IVFSnapshot] = None
        self._install(base, ids_arr, self._train(base))
        self._live = set(ids_arr.tolist())
        obs.health.register_index(self)

    # -- placement ---------------------------------------------------------
    def _train(self, rows: np.ndarray):
        return train_kmeans(rows, self.ncentroids, device=self.device,
                            iters=self.train_iters, seed=self.seed,
                            train_tile=self.train_tile)

    def _install(self, base: np.ndarray, base_ids: np.ndarray, km) -> None:
        """Install ``base`` clustered by ``km`` as the list-major
        placement: a stable sort gives centroid-contiguous extents whose
        in-extent order is the canonical (insertion) order, so block-local
        tie ranking equals canonical tie ranking.  The caller holds the
        lock, or no other thread can see the index yet."""
        perm = np.argsort(km.assign, kind="stable").astype(np.int64)
        starts = np.zeros(self.ncentroids + 1, np.int64)
        np.cumsum(km.counts, out=starts[1:])
        self._base = base
        self._base_ids = base_ids
        self._centroids = km.centroids
        self._residuals = km.residuals.copy()
        self._base_counts = km.counts.copy()
        self._list_base_pos = tuple(
            perm[starts[l]:starts[l + 1]] for l in range(self.ncentroids))
        # the train-time drift baseline: built only while telemetry is on
        # (obs off builds no sketch at all)
        self._drift = None
        if obs.enabled():
            from knn_tpu_torch.obs.drift import QueryDriftMonitor

            b64 = base.astype(np.float64)
            self._drift = QueryDriftMonitor(
                train_norms=np.sqrt(np.einsum("nd,nd->n", b64, b64)),
                assign_baseline=km.counts)

    def _assign_host(self, rows: np.ndarray) -> np.ndarray:
        """Nearest-centroid assignment of delta-tail rows, host f64 with
        lexicographic ties — any assignment is valid for the certificate
        as long as the residual radius covers it, which
        :meth:`_add_tail` maintains."""
        r64 = rows.astype(np.float64)
        c64 = self._centroids.astype(np.float64)
        d = ((r64[:, None, :] - c64[None, :, :]) ** 2).sum(-1)
        return np.argmin(d, axis=1).astype(np.int64)

    def _add_tail(self, v: np.ndarray, ids_arr: np.ndarray) -> None:
        """Append ``v`` to the delta tails by nearest centroid, widening
        the residual radii to cover it.  Caller holds the lock."""
        assign = self._assign_host(v)
        diff = v.astype(np.float64) - \
            self._centroids.astype(np.float64)[assign]
        dist = np.sqrt(np.einsum("nd,nd->n", diff, diff))
        np.maximum.at(self._residuals, assign, dist)
        self._tail_parts.append(v)
        self._tail_id_parts.append(ids_arr)
        self._tail_assign_parts.append(assign)
        self._tail_len += v.shape[0]

    def _snapshot(self) -> _IVFSnapshot:
        with self._lock:
            if self._snap_cache is not None:
                return self._snap_cache
            n_base = self._base.shape[0]
            tail = (np.concatenate(self._tail_parts) if self._tail_parts
                    else np.empty((0, self.dim), np.float32))
            tail_ids = (np.concatenate(self._tail_id_parts)
                        if self._tail_id_parts else np.empty(0, np.int64))
            tail_assign = (np.concatenate(self._tail_assign_parts)
                           if self._tail_assign_parts
                           else np.empty(0, np.int64))
            all_rows = np.concatenate([self._base, tail])
            all_ids = np.concatenate([self._base_ids, tail_ids])
            live_mask = np.ones(all_rows.shape[0], bool)
            if self._tombstones:
                live_mask &= ~np.isin(
                    all_ids, np.fromiter(self._tombstones, np.int64,
                                         len(self._tombstones)))
            live_positions = np.flatnonzero(live_mask).astype(np.int64)
            sizes = self._base_counts + np.bincount(
                tail_assign, minlength=self.ncentroids)
            snap = _IVFSnapshot(
                epoch=self.epoch,
                ncentroids=self.ncentroids,
                centroids=self._centroids,
                cent64=self._centroids.astype(np.float64),
                residuals=self._residuals.copy(),
                list_base_pos=self._list_base_pos,
                list_sizes=sizes,
                tail_assign=tail_assign,
                n_base=n_base,
                all_rows=all_rows,
                all_ids=all_ids,
                live_mask=live_mask,
                live_positions=live_positions,
                n_live=int(live_positions.shape[0]),
            )
            self._snap_cache = snap
            return snap

    # -- search ------------------------------------------------------------
    def _seg_rung(self, rows: int, m: int) -> int:
        """Smallest segment ladder rung holding ``rows``: rungs double from
        a floor that can rank ``m`` rows, so steady-state probing reuses a
        handful of block shapes, never one per probe set."""
        cap = max(self._seg_min, m)
        while cap < rows:
            cap *= 2
        return cap

    def _probe(self, q64: np.ndarray, snap: _IVFSnapshot, nprobe: int):
        """(probes [Q, P] sorted list ids, unprobed_lb [Q] f64, nearest [Q]
        int64): the probe pick, each query's lower bound over every
        unprobed non-empty list, ``min_l (||q - c_l|| - r_l)``, in f64 with
        the direct-difference form (no cancellation), and the nearest
        centroid (the drift sketch's assignment stream)."""
        n_q = q64.shape[0]
        c = snap.ncentroids
        cd = np.empty((n_q, c))
        for lo in range(0, n_q, 128):
            diff = q64[lo:lo + 128, None, :] - snap.cent64[None, :, :]
            cd[lo:lo + 128] = np.sqrt(np.einsum("qcd,qcd->qc", diff, diff))
        order = np.lexsort(
            (np.broadcast_to(np.arange(c), cd.shape), cd), axis=-1)
        probes = np.sort(order[:, :nprobe], axis=-1)
        lb = cd - snap.residuals[None, :]
        np.put_along_axis(lb, order[:, :nprobe], np.inf, axis=-1)
        lb[:, snap.list_sizes == 0] = np.inf
        return probes, lb.min(axis=-1), order[:, 0]

    def _coarse_counted(self, q_grp: np.ndarray, pos: np.ndarray,
                        snap: _IVFSnapshot, kk: int, m: int, steps: dict):
        """Gathered-block coarse pass through the segment program (the
        block padded to its rung, its valid rows a runtime argument),
        refined to exact f64 finals; returns ``(d_ref, p_ref, complete)``
        where ``complete`` certifies the refined top-kk is the exact block
        top-kk (the f32-tolerance exclusion bound applied to the block).

        Queries whose exclusion bound fails (an f32 cancellation artifact
        of the coarse pass, not a probe miss) escalate within the block:
        every gathered row re-scores in f64, complete by construction."""
        from knn_tpu_torch.parallel.sharded import segment_search_program

        real = int(pos.shape[0])
        n_g = q_grp.shape[0]
        prog = segment_search_program(m, self.metric,
                                      train_tile=self.train_tile,
                                      device=self.device)
        t0 = time.perf_counter()
        seg = np.zeros((self._seg_rung(real, m), self.dim), np.float32)
        seg[:real] = snap.all_rows[pos]
        t1 = time.perf_counter()
        d32, i32 = prog(q_grp, seg, real)
        d32 = d32.cpu().numpy()
        i32 = i32.cpu().numpy()
        t2 = time.perf_counter()
        steps["gather"] += t1 - t0
        steps["device"] += t2 - t1
        valid = i32 != I32MAX
        cand = np.where(valid, pos[np.clip(i32, 0, real - 1)], snap.n_all)
        d_ref, p_ref = refine_exact(snap.all_rows, q_grp, cand, kk)
        if real <= m:
            # every block row was a candidate: complete by construction
            steps["refine"] += time.perf_counter() - t2
            return d_ref, p_ref, np.ones(n_g, bool)
        # rows outside the coarse top-m have f32 distance >= d32[:, m-1];
        # the tolerance converts that into an f64 exclusion bound
        tol = certification_tolerance(
            q_grp, snap.all_rows,
            db_norm_max=float(snap.norm2()[pos].max()))
        outsider_lb = d32[:, m - 1].astype(np.float64) - tol
        complete = d_ref[:, kk - 1] < outsider_lb
        bad = np.flatnonzero(~complete)
        if bad.size:
            d_ref[bad], p_ref[bad] = refine_shared_exact(
                snap.all_rows, q_grp[bad], pos, kk)
            complete[bad] = True
        steps["refine"] += time.perf_counter() - t2
        return d_ref, p_ref, complete

    def _coarse_pallas(self, q_grp: np.ndarray, pos: np.ndarray,
                       snap: _IVFSnapshot, kk: int, margin: int,
                       pallas_kw: dict, steps: dict):
        """Gathered-block coarse pass through knn_search_pallas (a
        placement of the block and one certified search through its
        coarse kernel): its own certificate and repair make the block
        top-kk exact, so the re-refine here only re-anchors values and
        ties to the canonical f64 form."""
        from knn_tpu_torch.ops.coarse_knn import knn_search_pallas

        t0 = time.perf_counter()
        rows = snap.all_rows[pos]
        t1 = time.perf_counter()
        _, i_c, _stats = knn_search_pallas(
            q_grp, rows, kk, margin=margin, device=self.device, **pallas_kw)
        t2 = time.perf_counter()
        cand = pos[np.asarray(i_c)]
        d_ref, p_ref = refine_exact(snap.all_rows, q_grp, cand, kk)
        steps["gather"] += t1 - t0
        steps["device"] += t2 - t1
        steps["refine"] += time.perf_counter() - t2
        return d_ref, p_ref, np.ones(q_grp.shape[0], bool)

    def search_certified(
        self,
        queries,
        *,
        k: Optional[int] = None,
        nprobe: Optional[int] = None,
        selector: str = "exact",
        margin: Optional[int] = None,
        precision: str = "highest",
        kernel: str = "tiled",
        tile_n: Optional[int] = None,
        return_sqrt: bool = False,
        timings: Optional[dict] = None,
    ):
        """(d [Q, k] f64, ids [Q, k] int64, stats): exact nearest
        neighbors of the live corpus — probed lists answer, the residual
        certificate checks, flagged queries repair through the exact f64
        fallback.  ``selector="pallas"`` runs each probe group's block
        through ``knn_search_pallas(precision=, kernel=, tile_n=)``.
        ``timings``, when given a dict, receives the call's host-clock
        seconds by step: ``probe``, ``gather`` (the probed lists' live
        positions and the block's host copy), ``device`` (the segment
        program with its copies, or ``knn_search_pallas`` with the block's
        placement and its own certificate), ``refine`` (the float64
        re-anchoring and the within-block escalation), ``repair`` (the
        flagged queries' float64 scan of every live row) and ``other``."""
        if selector not in SELECTORS:
            raise ValueError(f"selector {selector!r} not in {SELECTORS}")
        q = np.ascontiguousarray(np.asarray(queries, np.float32))
        if q.ndim != 2 or q.shape[1] != self.dim:
            raise ValueError(
                f"queries shape {q.shape} incompatible with dim {self.dim}")
        k = self.k if k is None else int(k)
        margin = self.margin if margin is None else int(margin)
        snap = self._snapshot()
        if snap.n_live < k:
            raise ValueError(f"k={k} exceeds live rows {snap.n_live}")
        nprobe_r = self.nprobe if nprobe is None else int(nprobe)
        nprobe_r = max(1, min(nprobe_r, snap.ncentroids))
        n_q = q.shape[0]
        steps = dict.fromkeys(("probe", "gather", "device", "refine",
                               "repair"), 0.0)
        t0 = time.perf_counter()
        q64 = q.astype(np.float64)
        probes, unprobed_lb, nearest = self._probe(q64, snap, nprobe_r)
        steps["probe"] = time.perf_counter() - t0
        drift = self._drift
        if drift is not None:
            drift.observe(norms=np.sqrt(np.einsum("qd,qd->q", q64, q64)),
                          assignments=nearest)
        d_out = np.full((n_q, k), np.inf)
        pos_out = np.full((n_q, k), snap.n_all, np.int64)
        flagged = np.zeros(n_q, bool)
        rows_gathered = 0
        m = k + margin
        pallas_kw = {"precision": precision, "kernel": kernel}
        if tile_n is not None:
            pallas_kw["tile_n"] = tile_n
        groups: dict = {}
        for qi in range(n_q):
            groups.setdefault(tuple(probes[qi].tolist()), []).append(qi)
        # each certified answer's headroom to the unprobed lists' bound
        # (relative; ~0 is one insert away from a fallback)
        margins: Optional[list] = [] if obs.enabled() else None
        for key, members in groups.items():
            qi = np.asarray(members, np.int64)
            t1 = time.perf_counter()
            pos = snap.positions_for(key)
            steps["gather"] += time.perf_counter() - t1
            rows_gathered += int(pos.shape[0]) * qi.shape[0]
            if pos.shape[0] < k:
                flagged[qi] = True  # the probe cannot even fill k: repair
                continue
            q_grp = q[qi]
            if selector == "pallas":
                d_ref, p_ref, complete = self._coarse_pallas(
                    q_grp, pos, snap, k, margin, pallas_kw, steps)
            else:
                d_ref, p_ref, complete = self._coarse_counted(
                    q_grp, pos, snap, k, m, steps)
            d_out[qi] = d_ref
            pos_out[qi] = p_ref
            s_k = np.sqrt(d_ref[:, k - 1])
            lb = unprobed_lb[qi]
            bound_ok = s_k < lb * (1.0 - _BOUND_SLACK)
            flagged[qi] = ~(complete & bound_ok)
            if margins is not None:
                fin = np.isfinite(lb)
                if fin.any():
                    margins.extend(
                        ((lb[fin] - s_k[fin])
                         / np.maximum(np.abs(lb[fin]), 1e-30)).tolist())
        if margins:
            obs.histogram(obs.names.CERTIFIED_MARGIN,
                          path="ivf").observe_many(margins)
        n_bad = int(flagged.sum())
        misses = 0
        recall_sum = float(n_q - n_bad)  # certified queries: exactly 1.0
        if n_bad:
            t1 = time.perf_counter()
            bad = np.flatnonzero(flagged)
            d_fb, p_fb = refine_shared_exact(
                snap.all_rows, q[bad], snap.live_positions, k)
            for row, qi in enumerate(bad):
                before = pos_out[qi][pos_out[qi] < snap.n_all]
                hit = int(np.isin(p_fb[row], before).sum())
                recall_sum += hit / k
                if hit < k:
                    misses += 1
            d_out[bad] = d_fb
            pos_out[bad] = p_fb
            steps["repair"] = time.perf_counter() - t1
        ids_out = snap.all_ids[np.clip(pos_out, 0, snap.n_all - 1)]
        wall = time.perf_counter() - t0
        stats = self._search_stats(
            snap, n_q=n_q, k=k, nprobe=nprobe_r, selector=selector,
            precision=precision, n_groups=len(groups),
            rows_gathered=rows_gathered, n_bad=n_bad, misses=misses,
            recall_sum=recall_sum, wall=wall)
        if timings is not None:
            timings.update(steps, other=wall - sum(steps.values()))
        if return_sqrt:
            d_out = np.sqrt(d_out)
        return d_out, ids_out, stats

    def _search_stats(self, snap, *, n_q, k, nprobe, selector, precision,
                      n_groups, rows_gathered, n_bad, misses, recall_sum,
                      wall) -> dict:
        from knn_tpu_torch.analysis.widths import db_operand_nbytes

        prec = precision if precision else "default"
        per_row = sum(db_operand_nbytes(1, self.dim, prec).values())
        brute_b = float(n_q) * snap.n_live * per_row
        probed_b = float(rows_gathered) * per_row
        stats = {
            "epoch": snap.epoch,
            "queries": n_q,
            "k": k,
            "ncentroids": snap.ncentroids,
            "nprobe": nprobe,
            "selector": selector,
            "groups": n_groups,
            "certified_queries": n_q - n_bad,
            "fallback_queries": n_bad,
            "fallback_rate": n_bad / n_q if n_q else 0.0,
            "genuine_misses": misses,
            "recall_at_k": recall_sum / n_q if n_q else 1.0,
            "rows_gathered": rows_gathered,
            "probe_fraction": (rows_gathered / (n_q * snap.n_live)
                               if n_q and snap.n_live else 0.0),
            "bytes_streamed_ratio": (probed_b / brute_b
                                     if brute_b else 0.0),
            "wall_s": round(wall, 6),
        }
        if obs.enabled():
            for name, key in (
                (obs.names.IVF_FALLBACK_RATE, "fallback_rate"),
                (obs.names.IVF_RECALL_AT_K, "recall_at_k"),
                (obs.names.IVF_PROBE_FRACTION, "probe_fraction"),
                (obs.names.IVF_BYTES_STREAMED_RATIO,
                 "bytes_streamed_ratio"),
            ):
                obs.gauge(name, selector=selector).set(stats[key])
            from knn_tpu_torch.obs.drift import index_health

            index_health(snap.list_sizes, int(snap.tail_assign.shape[0]),
                         snap.n_all, snap.n_live)
        with self._lock:
            self._last_search = stats
        return stats

    # -- mutation ----------------------------------------------------------
    def insert(self, vectors, ids) -> dict:
        """Append rows to the delta tails (by nearest centroid, the
        residual radius widened to keep the certificate sound).  Epoch
        visibility, unique fresh ids, budgeted refusal."""
        v, ids_arr = checked_rows(vectors, ids, self.dim)
        with self._lock:
            check_fresh(ids_arr, self._live, self._tombstones)
            if self._tail_len + v.shape[0] > self._delta_max:
                raise MutationBudgetError(
                    f"delta tail full: {self._tail_len} + {v.shape[0]} "
                    f"rows exceeds delta_max_rows={self._delta_max}; "
                    f"compact()")
            self._add_tail(v, ids_arr)
            self._live.update(ids_arr.tolist())
            self._snap_cache = None
            tail_len = self._tail_len
            epoch = self.epoch
            self._lock.notify_all()
        return {"epoch": epoch, "tail_rows": tail_len}

    def delete(self, ids) -> dict:
        """Tombstone live ids: rows stay placed until compaction but every
        gather filters them (the conservative residual radius keeps the
        unprobed-list bounds sound).  ``KeyError`` on unknown or dead
        ids."""
        ids_arr = np.asarray(ids, dtype=np.int64).reshape(-1)
        with self._lock:
            check_live(ids_arr, self._live)
            n_base = self._base_ids.shape[0]
            live_after = (n_base + self._tail_len
                          - len(self._tombstones) - ids_arr.shape[0])
            if live_after < self.k:
                raise MutationBudgetError(
                    f"delete would leave {live_after} live rows < "
                    f"k={self.k}")
            self._tombstones.update(ids_arr.tolist())
            self._live.difference_update(ids_arr.tolist())
            self._snap_cache = None
            n_tombs = len(self._tombstones)
            epoch = self.epoch
            self._lock.notify_all()
        return {"epoch": epoch, "tombstones": n_tombs}

    # -- compaction --------------------------------------------------------
    def compact(self) -> dict:
        """Re-cluster the surviving rows into a fresh list-major placement
        off the search path, then swap under the lock — searches in
        flight keep their snapshot; writes after the cut carry over into
        the new epoch's delta tails."""
        t0 = time.perf_counter()
        with self._compact_lock:
            with self._lock:
                snap = self._snapshot()
                cut_parts = len(self._tail_parts)
                tomb_cut = set(self._tombstones)
            survivors = np.ascontiguousarray(
                snap.all_rows[snap.live_positions])
            surv_ids = snap.all_ids[snap.live_positions]
            km = self._train(survivors)
            with self._lock:
                carried_rows = self._tail_parts[cut_parts:]
                carried_ids = self._tail_id_parts[cut_parts:]
                self._install(survivors, surv_ids, km)
                self._tail_parts = []
                self._tail_id_parts = []
                self._tail_assign_parts = []
                self._tail_len = 0
                for part, part_ids in zip(carried_rows, carried_ids):
                    self._add_tail(part, part_ids)
                self._tombstones -= tomb_cut
                self.epoch += 1
                self._compactions += 1
                self._snap_cache = None
                report = {
                    "epoch": self.epoch,
                    "rows": int(survivors.shape[0]),
                    "carried_tail_rows": self._tail_len,
                    "tombstones_dropped": len(tomb_cut),
                    "tombstones_carried": len(self._tombstones),
                    "wall_s": round(time.perf_counter() - t0, 4),
                }
                self._last_compaction = report
        obs.record_span("index.compact", f"ivf-compact-{report['epoch']}",
                        report["wall_s"], rows=report["rows"])
        return report

    def _compact_due(self) -> bool:
        """Caller holds ``self._lock``."""
        return thresholds_tripped(self._tail_len, len(self._tombstones),
                                  self._compact_tail_rows,
                                  self._compact_tombstones)

    def start_compactor(self, interval_s: float = 0.05) -> None:
        """Background compaction on the constructor's thresholds, checked
        every ``interval_s`` and on every write: writes keep landing, the
        compactor re-clusters off the search path, snapshots swap
        atomically.  A failed compaction is recorded
        (``stats()["last_compaction_error"]``, re-raised by :meth:`close`)
        and the loop goes on.  Idempotent; ``close()`` stops it."""
        self._compactor.start(self.compact, self._compact_due, interval_s)

    def close(self) -> None:
        """Stops the compactor, waiting out a compaction in flight;
        re-raises its last recorded exception."""
        self._compactor.close()

    def __enter__(self) -> "IVFIndex":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- serving -----------------------------------------------------------
    def serving_engine(self, **kw) -> "IVFServingEngine":
        """An :class:`IVFServingEngine` over this index (``buckets``, and
        the ``selector`` and ``precision`` its requests run with)."""
        return IVFServingEngine(self, **kw)

    # -- reporting ---------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            n_base = self._base_ids.shape[0]
            return {
                "epoch": self.epoch,
                "ncentroids": self.ncentroids,
                "nprobe": self.nprobe,
                "train_iters": self.train_iters,
                "seed": self.seed,
                "base_rows": int(n_base),
                "tail_rows": self._tail_len,
                "tombstones": len(self._tombstones),
                "live_rows": (n_base + self._tail_len
                              - len(self._tombstones)),
                "compactions": self._compactions,
                "compactor_alive": self._compactor.alive,
                "metric": self.metric,
                "last_compaction_error": self._compactor.error_text(),
                **({"last_compaction": dict(self._last_compaction)}
                   if self._last_compaction else {}),
                **({"last_search": dict(self._last_search)}
                   if self._last_search else {}),
                **({"drift": self._drift.status()}
                   if self._drift is not None else {}),
            }


class _IVFPending:
    """A completed IVF serving request: the probed search runs at submit
    time against the snapshot it pins; ``result()`` hands the arrays back
    (the handle surface the queue drives)."""

    __slots__ = ("trace_id", "tenant", "_result")

    def __init__(self, trace_id, tenant, result):
        self.trace_id = trace_id
        self.tenant = tenant
        self._result = result

    def result(self):
        return self._result


class IVFServingEngine(Frontend):
    """The serving frontend of an :class:`IVFIndex`: the ``ServingEngine``
    surface ``QueryQueue`` drives (``buckets``, ``_dim``, ``submit() ->
    handle``, ``apply_write``, ``stats``), each request pinned to one
    index snapshot so a background compaction's swap is atomic from its
    view.  ``selector`` and ``precision`` are what every request's
    ``search_certified`` runs with (None: the index defaults, the JAX
    package's frontend)."""

    def __init__(self, index: IVFIndex, *, buckets: Sequence[int] = (8, 16),
                 selector: Optional[str] = None,
                 precision: Optional[str] = None):
        import itertools

        super().__init__(index)
        self._buckets = tuple(int(b) for b in buckets)
        self._search_kwargs = {
            name: value for name, value in (("selector", selector),
                                            ("precision", precision))
            if value is not None}
        self._seq = itertools.count()

    @property
    def buckets(self):
        return self._buckets

    @property
    def warmed_ops(self):
        return {"search"}

    def warmup(self, ops: Sequence[str] = ("search",)) -> dict:
        """One probed search per bucket before live traffic arrives."""
        for b in self._buckets:
            q = np.zeros((int(b), self._dim), np.float32)
            self.index.search_certified(q, **self._search_kwargs)
        return {"search": len(self._buckets)}

    def submit(self, queries, *, op: str = "search",
               trace_id=None, tenant=None) -> _IVFPending:
        q = self._checked(queries, op)
        tid = trace_id if trace_id is not None else f"ivf-{next(self._seq)}"
        # audit sampling: the snapshot is pinned before the search, so the
        # replay judges the served answer against the corpus it came from
        audit_q = q.copy() if obs.audit.sampled(tid) else None
        snap = self.index._snapshot() if audit_q is not None else None
        t0 = time.perf_counter()
        d, ids, _stats = self.index.search_certified(
            q, k=self.k, **self._search_kwargs)
        obs.record_span("serving.request", tid, time.perf_counter() - t0,
                        op="ivf_search")
        if audit_q is not None:
            self._submit_audit(tid, tenant, audit_q, d, ids, snap,
                               _stats.get("epoch"))
        return _IVFPending(tid, tenant, (d, ids))

    def _submit_audit(self, tid, tenant, q_audit, d, ids, snap,
                      search_epoch) -> None:
        """Enqueue one sampled, already-served request for the audit
        worker's exact replay (obs.audit): its oracle scans every live
        row of the pinned snapshot in float64, on the worker only.  The
        request was served already, so a failure here drops the record
        with an ``audit.submit_error`` event."""
        try:
            if search_epoch != snap.epoch:
                # a compaction swapped between the pin and the search: the
                # evidence cannot be judged, and is dropped loudly
                obs.counter(obs.names.AUDIT_DROPPED,
                            reason="epoch_moved").inc()
                return
            k = self.k

            def oracle(queries, served_ids):
                from knn_tpu_torch.ops.refine import _pairwise_f64

                od, o_pos = refine_shared_exact(
                    snap.all_rows, queries, snap.live_positions, k)
                oi = snap.all_ids[np.clip(o_pos, 0, snap.n_all - 1)]
                order = np.argsort(snap.all_ids, kind="stable")
                sorted_ids = snap.all_ids[order]
                sid = np.asarray(served_ids, np.int64)[:, :k]
                j = np.clip(np.searchsorted(sorted_ids, sid), 0,
                            sorted_ids.shape[0] - 1)
                pos = order[j]
                valid = (sorted_ids[j] == sid) & snap.live_mask[pos]
                se = _pairwise_f64(
                    queries, snap.all_rows[np.where(valid, pos, 0)], "l2")
                return od, oi, np.where(valid, se, np.inf)

            obs.audit.submit(obs.audit.AuditRecord(
                trace_id=tid,
                tenant=tenant,
                k=k,
                queries=q_audit,
                served_d=np.asarray(d),
                served_ids=np.asarray(ids),
                epoch=int(snap.epoch),
                cost_rows=int(q_audit.shape[0]) * int(snap.n_live),
                oracle=oracle,
            ))
        except Exception:  # noqa: BLE001 - audit must not fail serving
            obs.emit_event("audit.submit_error", op="ivf_search",
                           trace_id=tid)

    def stats(self, **kw) -> dict:
        return {"index": self.index.stats()}
