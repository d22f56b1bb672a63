"""Top-k neighbor selection in PyTorch — the port of knn_tpu/ops/topk.py
(``topk_smallest``, ``topk_pairs``, ``merge_topk``, ``knn_search``,
``knn_search_tiled``, ``knn_search_approx``).

Tie-breaking is the JAX package's: ties go to the **lower train index**,
i.e. the k-nearest set is the lexicographic smallest k pairs
``(distance, index)``.  ``torch.topk`` promises no tie order, so every
select here is built on ``torch.sort(..., stable=True)``: a stable sort by
value keeps the lower position first (``lax.top_k``'s order), and
``topk_pairs`` is a stable sort on the index followed by a stable sort on
the distance (``lax.sort`` with two keys).

Indices are int64 tensors; the "no row" sentinel is int32 max, as in the
JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from knn_tpu_torch.ops.distance import _dot, pairwise_distance

#: index sentinel for "no candidate" (jnp.iinfo(jnp.int32).max)
I32MAX = 2 ** 31 - 1


def topk_smallest(dists: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k smallest entries along the last axis,
    ascending; ties broken toward the lower index.  Both are copies of the
    k columns, so the whole row's sort is freed with the call (a view
    would keep it alive as long as the result)."""
    vals, idx = torch.sort(dists, dim=-1, stable=True)
    return vals[..., :k].contiguous(), idx[..., :k].contiguous()


def topk_pairs(d: torch.Tensor, i: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lexicographic-smallest k ``(distance, index)`` pairs along the last
    axis, ascending — value ties resolve to the lower index whatever the
    input order."""
    by_i = torch.argsort(i, dim=-1, stable=True)
    d1 = torch.gather(d, -1, by_i)
    i1 = torch.gather(i, -1, by_i)
    by_d = torch.argsort(d1, dim=-1, stable=True)
    return (torch.gather(d1, -1, by_d)[..., :k],
            torch.gather(i1, -1, by_d)[..., :k])


def merge_topk(best_d, best_i, new_d, new_i, k: int):
    """Merge a running top-k with new candidates along the last axis
    (associative and commutative, so any merge order agrees)."""
    return topk_pairs(torch.cat([best_d, new_d], dim=-1),
                      torch.cat([best_i, new_i], dim=-1), k)


def _mask_padding(d: torch.Tensor, n_valid: Optional[int], fill: float,
                  lo: int = 0) -> torch.Tensor:
    """Columns at global index >= ``n_valid`` (``lo`` the first column's)
    are padding: their values become ``fill`` before any select."""
    if n_valid is None:
        return d
    cols = lo + torch.arange(d.shape[-1], device=d.device)[None, :]
    return torch.where(cols < n_valid, d, fill)


def knn_search(queries: torch.Tensor, train: torch.Tensor, k: int,
               metric: str = "l2", *, compute_dtype=None,
               n_valid: Optional[int] = None, prepared=None):
    """Exact KNN with the full [Q, T] distance matrix: [Q, k] dists + idx.
    Rows at index >= ``n_valid`` are padding, forced to +inf before the
    select.  ``prepared``: ops.distance.prepare_train of ``train``, made
    once for many query blocks."""
    d = pairwise_distance(queries, train, metric, compute_dtype=compute_dtype,
                          prepared=prepared)
    return topk_smallest(_mask_padding(d, n_valid, torch.inf), k)


def knn_search_tiled(queries: torch.Tensor, train: torch.Tensor, k: int,
                     metric: str = "l2", *, train_tile: Optional[int] = None,
                     compute_dtype=None, n_valid: Optional[int] = None):
    """Exact KNN streaming over train tiles with a running top-k merge —
    the Python loop takes the place of the JAX package's ``lax.scan``.
    The last tile pads with zero rows masked to +inf, so every tile
    selects from ``train_tile`` columns as in the JAX package; ``n_valid``
    masks trailing rows as well.  Results equal :func:`knn_search`,
    lower-index tie-breaks included."""
    n_train = train.shape[0]
    if k > n_train:
        raise ValueError(f"k={k} > n_train={n_train}")
    if train_tile is None or train_tile >= n_train:
        return knn_search(queries, train, k, metric,
                          compute_dtype=compute_dtype, n_valid=n_valid)
    limit = n_train if n_valid is None else min(n_train, int(n_valid))
    n_q = queries.shape[0]
    dev = queries.device
    best_d = torch.full((n_q, k), torch.inf, dtype=torch.float32, device=dev)
    best_i = torch.full((n_q, k), I32MAX, dtype=torch.int64, device=dev)
    for lo in range(0, n_train, train_tile):
        tile = train[lo : lo + train_tile]
        if tile.shape[0] < train_tile:
            tile = torch.nn.functional.pad(
                tile, (0, 0, 0, train_tile - tile.shape[0]))
        d = pairwise_distance(queries, tile, metric,
                              compute_dtype=compute_dtype)
        d = _mask_padding(d, limit, torch.inf, lo)
        gidx = lo + torch.arange(train_tile, device=dev)[None, :]
        if train_tile > k:
            # reduce the tile to its own top-k first (exact: every global
            # top-k member inside the tile is in the tile's top-k)
            td, ti = topk_smallest(d, k)
            best_d, best_i = merge_topk(best_d, best_i, td, lo + ti, k)
        else:
            best_d, best_i = merge_topk(
                best_d, best_i, d, gidx.expand_as(d), k)
    return best_d, best_i


def knn_search_approx(queries: torch.Tensor, train: torch.Tensor, k: int, *,
                      recall_target: float = 0.95, compute_dtype=None):
    """L2 KNN through the MIPS score ``q.t - ||t||^2 / 2`` (topk.py:158-188):
    its k largest, then ``max(||q||^2 - 2 score, 0)``.  The JAX package
    selects with ``lax.approx_max_k``, which is an exact top-k on every
    backend but the TPU; CUDA has no ApproxTopK, so this is the exact
    top-k of the score (ties to the lower index) and ``recall_target`` is
    accepted without effect (ROADMAP divergence 21)."""
    del recall_target  # no approximate selector on this backend
    t32 = train.float()
    half_t_norm = 0.5 * (t32 * t32).sum(-1)[None, :]
    score = _dot(queries, train, compute_dtype) - half_t_norm
    # a stable descending sort keeps the lower index first among ties
    top, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    top, idx = top[..., :k], idx[..., :k].contiguous()
    q32 = queries.float()
    q_norm = (q32 * q32).sum(-1, keepdim=True)
    return torch.clamp_min(q_norm - 2.0 * top, 0.0), idx
