"""Exact candidate refinement: restore recall@k = 1.0 after a fast coarse
pass.  A numpy-only copy of knn_tpu/ops/refine.py (rank_correct_runs,
refine_exact); the port never imports the JAX package.

The TPU path ranks with float32 (or bfloat16) distances; at 1M-database
scale a handful of near-boundary neighbors can swap order vs the float64
oracle (the expanded-square cancellation SURVEY.md §7 hard part (c)).  The
fix is the classic two-phase scheme: take k + margin candidates from the
fast pass, re-score JUST those in float64 on host (O(Q·m·D), trivial next
to the O(Q·N·D) coarse pass), and re-select the exact lexicographic top-k.

Exactness condition: every true top-k member appears in the coarse
top-(k+margin).  The coarse pass's worst-case distance error is a few
float32 ulps of the squared-norm magnitude, so a margin of a few dozen
covers it at SIFT1M scale; recall checks in bench.py verify empirically.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _pairwise_f64(queries: np.ndarray, cand: np.ndarray, metric: str) -> np.ndarray:
    """[Q, m] float64 distances between each query and its own candidate
    rows (cand is [Q, m, D])."""
    q = queries.astype(np.float64)[:, None, :]
    c = cand.astype(np.float64)
    m = metric.lower()
    if m in ("l2", "sql2", "euclidean"):
        diff = c - q
        return np.einsum("qmd,qmd->qm", diff, diff)
    if m in ("l1", "manhattan"):
        return np.abs(c - q).sum(-1)
    if m == "cosine":
        qn = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-24)
        cn = c / np.maximum(np.linalg.norm(c, axis=-1, keepdims=True), 1e-24)
        return 1.0 - np.einsum("qmd,qmd->qm", cn, qn)
    if m == "dot":
        return -np.einsum("qmd,qmd->qm", c, q)
    raise ValueError(f"unknown metric {metric!r}")


def rank_correct_runs(
    gi: np.ndarray,
    tight: np.ndarray,
    k: int,
    queries_np: np.ndarray,
    db_np: np.ndarray,
    d32k: Optional[np.ndarray] = None,
) -> Tuple[Optional[np.ndarray], np.ndarray, int]:
    """Float64 repair of a device-ranked candidate list from the near-tie
    mask ALONE — no distance matrix crosses the device->host link.

    ``gi`` [Q, m1] device-ranked candidate indices; ``tight`` [Q, W-1]
    bool marks adjacent pairs closer than the f32 rank slack, already
    restricted by the device program to finite values before the top-k
    boundary's first big gap (rows with no provable boundary were flagged
    ``bad`` there and rerun exactly — they never reach this function's
    fast path).  Members of each maximal run of tight pairs are re-scored
    in float64 and re-sorted lexicographically IN PLACE: a correction can
    never cross an uninvolved neighbor, because the gap there exceeds the
    slack while corrections move less than a third of it.

    ``d32k`` [Q, k] float64 (optional): the device's top-k distances;
    when given, corrected positions < k get their exact float64 values
    patched in and the array is returned — None skips distance output
    entirely (callers that only need indices save the transfer).

    Returns (d_out or None, i_out [Q, k] int64, corrected_row_count).
    """
    n_q, m1 = gi.shape
    w = tight.shape[1] + 1
    if w < k:
        raise ValueError(f"tie mask window {w} < k={k}")
    inv = np.zeros((n_q, w), dtype=bool)
    inv[:, :-1] |= tight
    inv[:, 1:] |= tight
    d_out = d32k.copy() if d32k is not None else None
    rows, cols = np.nonzero(inv)
    if rows.size == 0:
        return d_out, gi[:, :k].astype(np.int64), 0
    gw = gi[:, :w].astype(np.int64).copy()
    cand = gw[rows, cols]
    safe = np.clip(cand, 0, db_np.shape[0] - 1)
    diff = db_np[safe].astype(np.float64) - queries_np[rows].astype(
        np.float64
    )
    d64 = np.einsum("nd,nd->n", diff, diff)
    d64 = np.where(cand < db_np.shape[0], d64, np.inf)
    # maximal runs of consecutive involved positions; (rows, cols) comes
    # position-sorted from nonzero, so each run is one contiguous block
    new_run = np.ones(rows.size, dtype=bool)
    new_run[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1] + 1)
    run_id = np.cumsum(new_run) - 1
    # lexicographic sort within each run; runs are contiguous ascending in
    # both the original flat order and the (run_id-primary) sorted order,
    # so flat positions realign block-for-block
    order = np.lexsort((cand, d64, run_id))
    gw[rows, cols] = cand[order]
    if d_out is not None:
        in_k = cols < k
        d_sorted = d64[order]
        d_out[rows[in_k], cols[in_k]] = d_sorted[in_k]
    return d_out, gw[:, :k], int(len(np.unique(rows)))


def refine_exact(
    db: np.ndarray,
    queries: np.ndarray,
    cand_idx: np.ndarray,
    k: int,
    metric: str = "l2",
) -> Tuple[np.ndarray, np.ndarray]:
    """(distances [Q, k] float64, indices [Q, k] int64): the exact
    lexicographic (distance, index) top-k among each query's candidates.

    ``cand_idx`` is [Q, m] with m >= k, from the coarse device pass.
    Duplicate or sentinel (>= len(db)) candidate indices are tolerated:
    duplicates keep one copy ranked by index, sentinels rank last.
    """
    cand_idx = np.asarray(cand_idx, dtype=np.int64)
    n_q, m = cand_idx.shape
    if m < k:
        raise ValueError(f"need >= {k} candidates, got {m}")
    valid = cand_idx < db.shape[0]
    safe_idx = np.where(valid, cand_idx, 0)
    # chunk the [Qc, m, D] float64 gather+diff temporaries to a ~8 MB
    # budget so they live in cache: at SIFT bench shape the unchunked
    # form allocated ~1 GB twice over and ran ~40% slower (measured
    # chunk sweep, 2026-07)
    d = np.empty((n_q, m))
    chunk = max(1, (1 << 20) // max(1, m * db.shape[1]))
    for lo in range(0, n_q, chunk):
        d[lo : lo + chunk] = _pairwise_f64(
            queries[lo : lo + chunk], db[safe_idx[lo : lo + chunk]], metric
        )
    d = np.where(valid, d, np.inf)
    # kill duplicate candidates (keep lowest occurrence by (d, idx) order)
    srt = np.lexsort((cand_idx, d), axis=-1)
    d_sorted = np.take_along_axis(d, srt, axis=-1)
    i_sorted = np.take_along_axis(cand_idx, srt, axis=-1)
    dup = np.zeros_like(i_sorted, dtype=bool)
    dup[:, 1:] = i_sorted[:, 1:] == i_sorted[:, :-1]
    d_sorted = np.where(dup, np.inf, d_sorted)
    srt2 = np.lexsort((i_sorted, d_sorted), axis=-1)[:, :k]
    return (
        np.take_along_axis(d_sorted, srt2, axis=-1),
        np.take_along_axis(i_sorted, srt2, axis=-1),
    )

