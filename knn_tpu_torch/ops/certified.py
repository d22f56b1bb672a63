"""Certified-exact KNN — the port of knn_tpu/ops/certified.py.

Two certificates share the fallback repair here:

- the one-pass exclusion-bound certificate of
  ``ShardedKNN.search_certified`` takes ``certification_tolerance``,
  ``host_exact_knn`` and ``repair_uncertified`` from this module;
- the counted certificate, :func:`knn_search_certified`: a coarse pass
  fetches ``m = k + margin`` candidates per query (``candidate_fn``, e.g.
  :func:`pallas_candidate_fn` over a coarse kernel of any precision), a
  float64 refine ranks them, and one f32 pass over the whole database
  (:func:`count_below`) counts the rows below the k-th refined distance
  plus the f32 tolerance.  A count of at most k proves the top-k exact,
  whatever the coarse pass's precision; the rest go to the fallback
  repair.

The fallback repair is the exactness escalation shared by every certified
pipeline: widened exact re-select + float64 refine, re-certified by the
widened selection's own exclusion value, and an unconditional float64
host scan only for the queries whose k-th/widen-th gap sits inside the
f32 tolerance.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from knn_tpu_torch.device import DeviceLike, resolve_device
from knn_tpu_torch.ops.refine import refine_exact
from knn_tpu_torch.ops.topk import knn_search_tiled

#: upper bound on the elements of one [query rows, db rows] block of
#: :func:`count_below` (1 GB of f32): 4,096 queries x 1M rows run in
#: blocks of 2,048 queries x 131,072 rows
_COUNT_BLOCK_ELEMS = 1 << 28

#: float32 squared-distance error bound factor: |err| <~ eps * (||q||^2+||t||^2)
_F32_EPS = float(np.finfo(np.float32).eps)


def certification_tolerance(
    queries_np: np.ndarray, db_np: np.ndarray,
    *, db_norm_max: Optional[float] = None, q_norm: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Per-query additive slack [Q] covering the float32 distance error of
    an expanded-square f32 pass (8 eps (||q||^2 + max||t||^2))."""
    if q_norm is None:
        q_norm = (queries_np.astype(np.float64) ** 2).sum(-1)
    if db_norm_max is None:
        db_norm_max = float((db_np.astype(np.float64) ** 2).sum(-1).max())
    return 8.0 * _F32_EPS * (q_norm + db_norm_max)


def host_exact_knn(
    db_np: np.ndarray, q_np: np.ndarray, k: int, *, tile: Optional[int] = None,
    q_chunk: int = 8,
) -> Tuple[np.ndarray, np.ndarray]:
    """Unconditional last-resort exact KNN: tiled float64 direct-difference
    full scan on host, lexicographic (distance, index) order."""
    n = db_np.shape[0]
    n_q = q_np.shape[0]
    k = min(k, n)
    if tile is None:
        # bound the [q_chunk, tile, D] float64 temporaries at ~128 MB
        tile = max(128, (1 << 24) // (q_chunk * max(1, db_np.shape[1])))
    bd = np.full((n_q, k), np.inf)
    bi = np.full((n_q, k), np.iinfo(np.int64).max, dtype=np.int64)
    for qlo in range(0, n_q, q_chunk):
        qf = q_np[qlo : qlo + q_chunk].astype(np.float64)
        cd, ci = bd[qlo : qlo + q_chunk], bi[qlo : qlo + q_chunk]
        for lo in range(0, n, tile):
            t = db_np[lo : lo + tile].astype(np.float64)
            dt = ((qf[:, None, :] - t[None, :, :]) ** 2).sum(-1)
            it = np.broadcast_to(
                np.arange(lo, lo + t.shape[0], dtype=np.int64)[None, :], dt.shape
            )
            alld = np.concatenate([cd, dt], axis=-1)
            alli = np.concatenate([ci, it], axis=-1)
            srt = np.lexsort((alli, alld), axis=-1)[:, :k]
            cd = np.take_along_axis(alld, srt, -1)
            ci = np.take_along_axis(alli, srt, -1)
        bd[qlo : qlo + q_chunk], bi[qlo : qlo + q_chunk] = cd, ci
    return bd, bi


def repair_uncertified(
    d: np.ndarray,
    i: np.ndarray,
    k: int,
    m: int,
    bad: np.ndarray,
    q_np: np.ndarray,
    db_np: np.ndarray,
    *,
    select_fn,
    max_widen: int,
    db_norm_max: Optional[float] = None,
) -> dict:
    """Fallback repair of the rows ``bad`` of ``d``/``i`` (mutated in place):

    1. widened exact re-select (``widen = min(max(2m, m+64), max_widen)``)
       + float64 refine;
    2. re-certification by the widened selection's exclusion value: every
       row NOT selected has f32 score >= the widen-th selected score v_w,
       so ``d_k + tol < v_w`` proves the repair exact;
    3. float64 host scan (:func:`host_exact_knn`) for the rest.

    ``select_fn(q_bad [B, D], widen) -> (f32 scores [B, widen] ascending,
    indices [B, widen])``.  Returns ``fallback_genuine_misses`` (the repair
    changed the answer), ``fallback_false_alarms`` (it did not) and, when
    nonzero, ``host_exact_queries``."""
    if not bad.size:
        return {"fallback_genuine_misses": 0, "fallback_false_alarms": 0}
    orig_i = i[bad].copy()
    widen = min(max(2 * m, m + 64), max_widen)
    fs, fi = select_fn(q_np[bad], widen)
    fs = np.asarray(fs, dtype=np.float64)
    fd2, fi2 = refine_exact(db_np, q_np[bad], np.asarray(fi), k)
    d[bad], i[bad] = fd2, fi2
    tol = certification_tolerance(q_np[bad], db_np, db_norm_max=db_norm_max)
    v_w = fs[:, -1]  # exclusion value of the widened f32 selection
    still = np.flatnonzero(fd2[:, k - 1] + tol >= v_w)
    host_exact = 0
    if still.size:
        sb = bad[still]
        d[sb], i[sb] = host_exact_knn(db_np, q_np[sb], k)
        host_exact = int(sb.size)
    genuine = int((i[bad] != orig_i).any(axis=-1).sum())
    out = {
        "fallback_genuine_misses": genuine,
        "fallback_false_alarms": int(bad.size) - genuine,
    }
    if host_exact:
        out["host_exact_queries"] = host_exact
    return out


def count_below(db: torch.Tensor, queries: torch.Tensor,
                thresholds: torch.Tensor, *, tile: int = 131072,
                n_valid: Optional[int] = None) -> torch.Tensor:
    """Per query, how many database rows have squared-L2 distance strictly
    below the query's threshold — the port of certified.count_below:56-101.

    ``[Q]`` int32.  Distances are the fast path's f32 expanded square
    ``max(||q||^2 + ||t||^2 - 2 q.t, 0)``, the product a plain f32 matmul
    (TF32 off), so thresholds must already include the tolerance the
    caller wants.  Rows at index >= ``n_valid`` are padding and never
    counted.  The db runs in tiles of ``tile`` rows (as the reference's
    scan) and the queries in row blocks that keep one [rows, tile] block
    within ``_COUNT_BLOCK_ELEMS``; neither changes a count."""
    n = db.shape[0]
    tile = max(1, min(tile, n))
    limit = n if n_valid is None else min(n, int(n_valid))
    q32 = queries.float()
    thr = thresholds.to(device=q32.device, dtype=torch.float32)[:, None]
    q_norm = (q32 * q32).sum(-1, keepdim=True)
    rows = max(1, _COUNT_BLOCK_ELEMS // tile)
    acc = torch.zeros(q32.shape[0], dtype=torch.int32, device=q32.device)
    for lo in range(0, min(n, limit), tile):
        t32 = db[lo : min(lo + tile, limit)].float()
        t_norm = (t32 * t32).sum(-1)[None, :]
        for r0 in range(0, q32.shape[0], rows):
            qb = slice(r0, r0 + rows)
            d = torch.clamp_min(q_norm[qb] + t_norm - 2.0 * (q32[qb] @ t32.T),
                                0.0)
            acc[qb] += (d < thr[qb]).sum(-1, dtype=torch.int32)
    return acc


def _approx_candidates(queries: torch.Tensor, db: torch.Tensor, m: int, *,
                       compute_dtype=None, recall_target: float = 0.99
                       ) -> torch.Tensor:
    """[Q, m] candidate indices of the ``approx`` selector
    (certified._approx_candidates:104-122): ops.topk.knn_search_approx's
    MIPS-form squared L2 and its top-m, which is exact on this backend
    (``recall_target`` without effect, ROADMAP divergence 21)."""
    from knn_tpu_torch.ops.topk import knn_search_approx

    _, idx = knn_search_approx(queries, db, m, recall_target=recall_target,
                               compute_dtype=compute_dtype)
    return idx


def pallas_candidate_fn(**knobs):
    """A ``candidate_fn`` for :func:`knn_search_certified` that runs the
    port's coarse kernel (ops.coarse_knn.pallas_knn_candidates) at any
    ported precision — ``default`` (K3) among them, which the one-pass
    certificate refuses.  The counted certificate does not depend on the
    coarse pass's precision: it counts every database row against the
    float64-refined threshold, so a coarse pass that errs can raise the
    fallback rate but never cost exactness."""
    from knn_tpu_torch.ops.coarse_knn import pallas_knn_candidates

    def fn(q, db, m):
        return pallas_knn_candidates(q, db, m, **knobs)

    return fn


def knn_search_certified(queries, db, k: int, *, margin: int = 28,
                         tile: int = 131072, candidate_fn=None,
                         device: DeviceLike = None
                         ) -> Tuple[np.ndarray, np.ndarray, dict]:
    """Exact lexicographic (distance, index) top-k through the counted
    certificate (certified.knn_search_certified:268-328).  Returns
    ``(dists_f64 [Q, k], idx [Q, k], stats)``; ``queries`` and ``db`` are
    host arrays, placed on ``device`` (None: cuda) for the call.

    ``candidate_fn(queries, db, m) -> [Q, m] indices`` (device tensors in,
    indices out) is the coarse pass, e.g. :func:`pallas_candidate_fn`.
    None runs an exact f32 top-m (ops.topk.knn_search_tiled) where the
    reference runs ApproxTopK (``_approx_candidates:104``; ROADMAP queue
    C, divergence 13).  ``stats`` reports ``fallback_queries`` (counted
    more than k rows below the threshold and reran through the repair),
    ``certified`` and the repair counts."""
    queries_np = np.asarray(queries, dtype=np.float32)
    db_np = np.asarray(db, dtype=np.float32)
    n_q, n = queries_np.shape[0], db_np.shape[0]
    if k > n:
        raise ValueError(f"k={k} > n_db={n}")
    m = min(k + margin, n)
    dev = resolve_device(device)
    q_t = torch.from_numpy(queries_np).to(dev)
    db_t = torch.from_numpy(db_np).to(dev)
    if candidate_fn is None:
        _, cand = knn_search_tiled(q_t, db_t, m, "l2",
                                   train_tile=min(tile, n))
    else:
        cand = candidate_fn(q_t, db_t, m)
    d, i = refine_exact(db_np, queries_np, cand.cpu().numpy(), k)

    # certification threshold: the k-th true distance plus the f32 bound
    db_norm_max = float((db_np.astype(np.float64) ** 2).sum(-1).max())
    thresholds = d[:, k - 1] + certification_tolerance(
        queries_np, db_np, db_norm_max=db_norm_max)
    counts = count_below(db_t, q_t, torch.from_numpy(thresholds), tile=tile)
    bad = np.flatnonzero(counts.cpu().numpy() > k)

    def _select(qb, widen):
        fs, fi = knn_search_tiled(torch.from_numpy(qb).to(dev), db_t, widen,
                                  "l2", train_tile=min(tile, n))
        return fs.cpu().numpy(), fi.cpu().numpy()

    repair = repair_uncertified(d, i, k, m, bad, queries_np, db_np,
                                select_fn=_select, max_widen=n,
                                db_norm_max=db_norm_max)
    stats = {"fallback_queries": int(bad.size),
             "certified": n_q - int(bad.size), **repair}
    return d, i, stats
