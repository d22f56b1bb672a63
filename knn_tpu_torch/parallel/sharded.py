"""Placed KNN program on one GPU — the port of knn_tpu/parallel/sharded.py
(``ShardedKNN``) for one device and no mesh.

The database is placed once (knn_tpu_torch.convert.placement_from_numpy)
and every :meth:`ShardedKNN.search` / :meth:`~ShardedKNN.predict` /
:meth:`~ShardedKNN.search_certified` call reuses the placement.  With one
db shard the JAX package's merge tree and ``pmin`` are identities, so
they are absent here; everything else follows the JAX code path:

- ``search`` — exact f32 expanded-square distances and a stable top-k
  (ties to the lower index);
- ``search_certified(selector="pallas")`` — the one-pass certificate:
  the coarse kernel K1 (knn_tpu_torch.ops.coarse_knn) emits per-bin
  survivors and exclusion bounds, the exact top-(m+2) and the
  direct-difference f32 rescore rank the candidates, the device
  certificate :func:`_certify_pack` flags queries whose k-th distance is
  not provably below the exclusion bound (``bad``) and marks near-tie
  pairs, the host repairs tie runs in float64
  (ops.refine.rank_correct_runs), and flagged queries rerun through the
  widened exact select + float64 refine (ops.certified.repair_uncertified).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from knn_tpu_torch import tuning
from knn_tpu_torch.convert import Placement, placement_from_numpy, row_normalize_f64
from knn_tpu_torch.device import DeviceLike
from knn_tpu_torch.ops.coarse_knn import (
    RANK_SLACK,
    TILE_N,
    _geometry,
    _round_up,
    check_knobs,
    effective_tile,
    local_certified_candidates,
    prepare_db,
)
from knn_tpu_torch.ops.metrics import L2_FAMILY
from knn_tpu_torch.ops.topk import I32MAX, knn_search_tiled
from knn_tpu_torch.ops.vote import majority_vote
from knn_tpu_torch.utils.config import SELECTORS

#: upper bound on the elements of one [queries, rows] f32 distance block
#: of the exact path; larger query sets run in row chunks (each query's
#: result does not depend on the chunking)
_EXACT_BLOCK_ELEMS = 1 << 27


def _analysis_window(k: int, m: int) -> int:
    """Width of the device rank-analysis window — one home for the
    certify output's column count and its unpack."""
    return min(k + 17, m + 1)


class ShardedKNN:
    """A database placed once on one device (default ``cuda``) with k.

    ``train`` is a host [N, D] array or a :class:`~knn_tpu_torch.convert.
    Placement`; ``labels`` [N] with ``num_classes`` enable the predict
    methods.  Metrics: the l2 family and cosine (cosine rows are
    normalized at placement, so the certificate runs on unit vectors)."""

    def __init__(self, train, *, k: int, metric: str = "l2",
                 train_tile: Optional[int] = None, labels=None,
                 num_classes: Optional[int] = None,
                 device: DeviceLike = None):
        if isinstance(train, Placement):
            if labels is not None or device is not None:
                raise ValueError(
                    "a Placement already carries its labels and device")
            asked = "l2" if metric.lower() in L2_FAMILY else metric.lower()
            if asked != train.metric:
                raise ValueError(
                    f"metric {metric!r} does not match the placement's "
                    f"{train.metric!r}")
            pl = train
        else:
            pl = placement_from_numpy(train, labels, num_classes,
                                      metric=metric, device=device)
        if k > pl.n_train:
            raise ValueError(f"k={k} > n_train={pl.n_train}")
        self.placement = pl
        self.device = pl.device
        self.k = k
        self.metric = pl.metric
        self.train_tile = train_tile
        self.n_train = pl.n_train
        self.num_classes = pl.num_classes
        #: coarse-pass db parts for tiles whose padding differs from the
        #: placement's, built on first use
        self._parts = {}

    # -- exact path --------------------------------------------------------
    def _to_device(self, queries) -> torch.Tensor:
        if isinstance(queries, torch.Tensor):
            return queries.to(self.device, torch.float32)
        return torch.from_numpy(
            np.ascontiguousarray(np.asarray(queries, np.float32))).to(self.device)

    def _exact_topk(self, q: torch.Tensor, k: int, metric: str):
        rows = max(1, _EXACT_BLOCK_ELEMS // max(1, self.n_train))
        outs = [knn_search_tiled(q[lo : lo + rows], self.placement.db, k,
                                 metric, train_tile=self.train_tile)
                for lo in range(0, q.shape[0], rows)]
        return (torch.cat([o[0] for o in outs]),
                torch.cat([o[1] for o in outs]))

    def search(self, queries, *, k: Optional[int] = None,
               return_sqrt: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """(distances, indices) [Q, k] of the k nearest rows, as tensors on
        the device.  L2 distances are SQUARED unless ``return_sqrt``."""
        k = self.k if k is None else k
        if k > self.n_train:
            raise ValueError(f"k={k} exceeds n_train={self.n_train}")
        d, i = self._exact_topk(self._to_device(queries), k, self.metric)
        if return_sqrt:
            from knn_tpu_torch.ops.distance import metric_values

            d = metric_values(d, self.metric)
        return d, i

    def predict(self, queries) -> torch.Tensor:
        """Predicted labels [Q] int32 — needs ``labels`` at construction."""
        if self.placement.labels is None:
            raise RuntimeError("ShardedKNN built without labels; predict unavailable")
        _, gi = self.search(queries)
        safe = torch.clamp(gi, max=self.n_train - 1)
        return majority_vote(self.placement.labels[safe], self.num_classes)

    # -- certified path ----------------------------------------------------
    def _coarse_parts(self, tile: int):
        """The bf16x3 db parts padded for ``tile``: the placement's own
        when its padding matches, else prepared once and kept."""
        pl = self.placement
        rows = _round_up(self.n_train, tile)
        if pl.th.shape[0] == rows:
            return pl.th, pl.tl, pl.tnorm
        if rows not in self._parts:
            self._parts[rows] = prepare_db(pl.db, tile)
        return self._parts[rows]

    def _pallas_setup(self, margin: int, tile_n: Optional[int],
                      precision: str, bin_w: Optional[int] = None,
                      survivors: Optional[int] = None,
                      final_select: str = "exact",
                      include_distances: bool = True,
                      binning: str = "grouped",
                      grid_order: str = "query_major",
                      kernel: str = "tiled"):
        """(run, m, analysis_window) for the one-pass certified path: the
        one home of the kernel-geometry margin cap.  ``run(q)`` takes a
        [B, D] device batch and returns :func:`_certify_pack`'s tensors."""
        check_knobs(precision=precision, binning=binning,
                    grid_order=grid_order, kernel=kernel,
                    final_select=final_select, bin_w=bin_w,
                    survivors=survivors)
        rows = self.n_train
        eff_tile = effective_tile(rows, tile_n or TILE_N,
                                  min(self.k + margin, rows) + 2)
        _, _, out_w, _ = _geometry(eff_tile)
        # m is bounded by the db and by the kernel's candidate width minus
        # the two slots the exclusion value needs
        m = min(self.k + margin, rows, -(-rows // eff_tile) * out_w - 2)
        if m <= self.k:
            raise ValueError(
                f"pallas selector: margin headroom m={m} <= k={self.k} on "
                f"{rows} rows; lower tile_n")
        w = _analysis_window(self.k, m)
        parts = self._coarse_parts(eff_tile)
        db = self.placement.db
        db_norm_max = float(np.float32(self.placement.db_norm_max))

        def run(q: torch.Tensor):
            # the RESOLVED tile goes to the kernel: m was capped so that
            # width(eff_tile) >= m+2, which makes the kernel's own
            # effective_tile(min_width=m+2) a fixpoint
            d32, li, lb = local_certified_candidates(
                q, db, m, tile_n=eff_tile, precision=precision,
                binning=binning, grid_order=grid_order, kernel=kernel,
                final_select=final_select, db_parts=parts)
            return _certify_pack(q, d32, li, lb, db_norm_max=db_norm_max,
                                 m=m, k=self.k, w=w, n_train=rows,
                                 include_distances=include_distances)

        return run, m, w

    def _certify_pallas(self, batches, bs, m, d, i, q_np, db_np, *,
                        tile_n, precision, want_distances=True, bin_w=None,
                        survivors=None, final_select="exact",
                        binning="grouped", final_recall_target=None,
                        grid_order="query_major", kernel="tiled"):
        """One-pass certificate, host side: dispatch every batch, then per
        batch fetch the windowed indices, the near-tie mask and the bad
        flags (plus the top-k distances when ``want_distances``) and
        repair tie runs in float64.  Returns (flagged query indices,
        rank-corrected query count)."""
        from knn_tpu_torch.ops.refine import rank_correct_runs

        if final_recall_target is not None:
            raise ValueError(
                "final_recall_target tunes final_select='approx', which is "
                "not ported")
        k = self.k
        run, m, w = self._pallas_setup(
            m - k, tile_n, precision, bin_w=bin_w, survivors=survivors,
            final_select=final_select,
            include_distances=want_distances, binning=binning,
            grid_order=grid_order, kernel=kernel)
        # stage 1: dispatch every batch (asynchronous on the GPU)
        outs = [run(self._to_device(chunk)) for _, chunk, _ in batches]
        # stage 2: per batch, fetch + float64 tie-run repair
        bad_mask = np.zeros(q_np.shape[0], dtype=bool)
        n_corrected = 0
        for (lo, _, pad), packed in zip(batches, outs):
            take = bs - pad
            gi_np, tight_np, bad_np, dk_np = unpack_certified(
                packed, k, w, want_distances)
            dc, ic, n_c = rank_correct_runs(
                gi_np[:take], tight_np[:take], k, q_np[lo : lo + take], db_np,
                d32k=None if dk_np is None else dk_np[:take].astype(np.float64))
            n_corrected += n_c
            if dc is not None:
                d[lo : lo + take] = dc
            i[lo : lo + take] = ic
            bad_mask[lo : lo + take] = bad_np[:take]
        return np.flatnonzero(bad_mask), n_corrected

    def search_certified(self, queries, *, margin: int = 28,
                         selector: str = "pallas",
                         batch_size: Optional[int] = None,
                         tile_n: Optional[int] = None,
                         precision: Optional[str] = None,
                         return_distances: bool = True,
                         bin_w: Optional[int] = None,
                         survivors: Optional[int] = None,
                         final_select: Optional[str] = None,
                         binning: Optional[str] = None,
                         final_recall_target: Optional[float] = None,
                         grid_order: Optional[str] = None,
                         kernel: Optional[str] = None,
                         return_sqrt: bool = False):
        """Exact lexicographic top-k via the one-pass certificate.  Returns
        ``(dists_f64 [Q, k] or None, idx [Q, k] int64, stats)`` on host.

        Indices are the exact lexicographic top-k.  Distances are the
        device's f32 direct-difference values (relative error <
        RANK_SLACK) except near-tied or repaired entries, which are
        float64-exact.  Cosine runs the certificate on unit vectors and
        returns ``1 - similarity``.  Knobs left at None take the library
        defaults (knn_tpu_torch.tuning); ``stats`` carries
        ``certified``, ``fallback_queries``, ``rank_corrected_queries``,
        the repair counts and ``pallas_knobs``.  Queries must be finite."""
        from knn_tpu_torch.ops.certified import repair_uncertified

        if selector not in SELECTORS:
            raise ValueError(
                f"selector {selector!r} is not ported; expected {SELECTORS}")
        q_np = np.asarray(queries, dtype=np.float32)
        if not np.isfinite(q_np).all():
            # a NaN score has no place in the certificate's order
            raise ValueError("search_certified: queries must be finite")
        if self.metric == "cosine":
            q_np = row_normalize_f64(q_np)
        n_q = q_np.shape[0]
        m = min(self.k + margin, self.n_train)
        db_np = self.placement.db_host
        if batch_size is not None and batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        bs = n_q if batch_size is None else batch_size
        batches = []
        for lo in range(0, n_q, bs):
            chunk = q_np[lo : lo + bs]
            pad = bs - chunk.shape[0]
            if pad:  # the tail runs at the batch shape too
                chunk = np.pad(chunk, ((0, pad), (0, 0)))
            batches.append((lo, chunk, pad))
        d = np.empty((n_q, self.k))
        i = np.empty((n_q, self.k), dtype=np.int64)
        knobs = tuning.resolve(
            tile_n=tile_n, precision=precision, bin_w=bin_w,
            survivors=survivors, final_select=final_select,
            binning=binning, final_recall_target=final_recall_target,
            grid_order=grid_order, kernel=kernel)
        bad, n_corrected = self._certify_pallas(
            batches, bs, m, d, i, q_np, db_np,
            want_distances=return_distances, **knobs)

        def _select(qb, widen):
            # widened exact re-select in f32 squared L2 (cosine: on the
            # unit vectors of the placement)
            fs, fi = self._exact_topk(self._to_device(qb), widen, "l2")
            return fs.cpu().numpy(), fi.cpu().numpy()

        repair = repair_uncertified(
            d, i, self.k, m, bad, q_np, db_np, select_fn=_select,
            max_widen=self.n_train, db_norm_max=self.placement.db_norm_max)
        stats = {
            "fallback_queries": int(bad.size),
            "certified": n_q - int(bad.size),
            **repair,
            "rank_corrected_queries": n_corrected,
            "pallas_knobs": knobs,
        }
        if return_distances and self.metric == "cosine":
            d *= 0.5  # unit-vector squared L2 -> 1 - cosine similarity
        if return_distances and return_sqrt:
            from knn_tpu_torch.ops.distance import metric_values

            d = metric_values(d, self.metric)
        return (d if return_distances else None), i, stats

    def predict_certified(self, queries, *, margin: int = 28,
                          selector: str = "pallas",
                          batch_size: Optional[int] = None,
                          tile_n: Optional[int] = None,
                          precision: Optional[str] = None,
                          kernel: Optional[str] = None):
        """Certified-exact classification: exact neighbor sets from
        :meth:`search_certified`, then the reference vote.  Returns
        (labels [Q] int32 numpy, stats)."""
        if self.placement.labels is None:
            raise RuntimeError("ShardedKNN built without labels; predict unavailable")
        _, idx, stats = self.search_certified(
            queries, margin=margin, selector=selector, batch_size=batch_size,
            tile_n=tile_n, precision=precision, kernel=kernel,
            return_distances=False)
        labels = self.placement.labels[torch.from_numpy(idx).to(self.device)]
        return majority_vote(labels, self.num_classes).cpu().numpy(), stats


def _certify_pack(q, d32, li, lb, *, db_norm_max: float, m: int, k: int,
                  w: int, n_train: int, include_distances: bool):
    """The certify tail of the JAX package's ``_certify_pack_spmd`` for one
    shard, from ranked candidates ``(d32 [Q, m+1], li [Q, m+1], lb [Q])``:

    - the rank window [0, w): ``tight`` marks adjacent pairs closer than
      RANK_SLACK; ``stop`` is the first big gap at or after the top-k
      boundary; rows without one (or with non-finite values in the top
      k+1) are ``unresolved``;
    - the bf16x3 tolerance ``tol = 2^-14 (||q||^2 + db_norm_max)`` in f32;
    - ``bad = s_k + RANK_SLACK d_k + tol >= lb`` (plus unresolved rows),
      with ``s_k = d_k - ||q||^2`` the k-th distance in kernel space.

    Returns separate tensors ``(gi [Q, w], tight [Q, w-1], bad [Q],
    dk [Q, k] or None)`` in place of the packed int32 array the JAX
    package built for its TPU relay; :func:`unpack_certified` reads them."""
    gi = torch.where(li >= n_train, I32MAX, li)
    d32 = torch.where(li >= n_train, torch.inf, d32)
    dw = d32[:, :w]
    gaps = dw[:, 1:] - dw[:, :-1]
    # an (x, inf-sentinel) pair gives inf <= inf, which is no near-tie
    tight = (gaps <= RANK_SLACK * dw[:, 1:]) & torch.isfinite(dw[:, 1:])
    pair = torch.arange(w - 1, device=d32.device)[None, :]
    big_after = (~tight) & (pair >= k - 1)
    has_stop = big_after.any(-1)
    first = torch.argmax(big_after.to(torch.uint8), dim=-1)
    stop = torch.where(has_stop, first, w - 1)
    unresolved = (~has_stop) | ~torch.isfinite(dw[:, : k + 1]).all(-1)
    tight_use = tight & (pair < stop[:, None]) & ~unresolved[:, None]
    q32 = q.float()
    q_norm = (q32 * q32).sum(-1)
    tol = 2.0 ** -14 * (q_norm + db_norm_max)
    d_k = dw[:, k - 1]
    s_k = d_k - q_norm
    bad = (s_k + RANK_SLACK * d_k + tol >= lb) | unresolved
    return gi[:, :w], tight_use, bad, (d32[:, :k] if include_distances else None)


def unpack_certified(packed, k: int, w: int, with_distances: bool):
    """Host view of :func:`_certify_pack`'s output, with the JAX package's
    ``unpack_certified`` semantics: ``(gi [Q, w] int32, tight [Q, w-1]
    bool, bad [Q] bool, dk [Q, k] f32 or None)`` as numpy arrays."""
    gi, tight, bad, dk = packed
    if gi.shape[1] != w or tight.shape[1] != w - 1:
        raise ValueError(f"certify output window {gi.shape[1]} != {w}")
    dk_np = None
    if with_distances:
        if dk is None:
            raise ValueError("distances were not computed for this batch")
        dk_np = dk[:, :k].cpu().numpy()
    return (gi.to(torch.int32).cpu().numpy(), tight.cpu().numpy(),
            bad.cpu().numpy(), dk_np)
