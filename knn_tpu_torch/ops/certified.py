"""Host side of the certified-exact path — a numpy-only copy of the parts
of knn_tpu/ops/certified.py the one-pass certificate needs:
``certification_tolerance``, ``host_exact_knn`` and
``repair_uncertified``.  (The counted two-pass certificate, ``count_below``
and ``knn_search_certified``, is a later slice of the port.)

The fallback repair is the exactness escalation shared by every certified
pipeline: widened exact re-select + float64 refine, re-certified by the
widened selection's own exclusion value, and an unconditional float64
host scan only for the queries whose k-th/widen-th gap sits inside the
f32 tolerance.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from knn_tpu_torch.ops.refine import refine_exact

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
