"""Top-k neighbor selection in PyTorch — the port of knn_tpu/ops/topk.py
(``topk_smallest``, ``topk_pairs``, ``merge_topk``, ``knn_search``,
``knn_search_tiled``).

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

from knn_tpu_torch.ops.distance import pairwise_distance

#: index sentinel for "no candidate" (jnp.iinfo(jnp.int32).max)
I32MAX = 2 ** 31 - 1


def topk_smallest(dists: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k smallest entries along the last axis,
    ascending; ties broken toward the lower index."""
    vals, idx = torch.sort(dists, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


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


def knn_search(queries: torch.Tensor, train: torch.Tensor, k: int,
               metric: str = "l2"):
    """Exact KNN with the full [Q, T] distance matrix: [Q, k] dists + idx."""
    return topk_smallest(pairwise_distance(queries, train, metric), k)


def knn_search_tiled(queries: torch.Tensor, train: torch.Tensor, k: int,
                     metric: str = "l2", *, train_tile: Optional[int] = None):
    """Exact KNN streaming over train tiles with a running top-k merge —
    the Python loop takes the place of the JAX package's ``lax.scan``.
    The last tile pads with zero rows masked to +inf, so every tile
    selects from ``train_tile`` columns as in the JAX package.  Results
    equal :func:`knn_search`, lower-index tie-breaks included."""
    n_train = train.shape[0]
    if k > n_train:
        raise ValueError(f"k={k} > n_train={n_train}")
    if train_tile is None or train_tile >= n_train:
        return knn_search(queries, train, k, metric)
    n_q = queries.shape[0]
    dev = queries.device
    best_d = torch.full((n_q, k), torch.inf, dtype=torch.float32, device=dev)
    best_i = torch.full((n_q, k), I32MAX, dtype=torch.int64, device=dev)
    for lo in range(0, n_train, train_tile):
        tile = train[lo : lo + train_tile]
        if tile.shape[0] < train_tile:
            tile = torch.nn.functional.pad(
                tile, (0, 0, 0, train_tile - tile.shape[0]))
        d = pairwise_distance(queries, tile, metric)
        gidx = lo + torch.arange(train_tile, device=dev)[None, :]
        d = torch.where(gidx < n_train, d, torch.inf)
        if train_tile > k:
            # reduce the tile to its own top-k first (exact: every global
            # top-k member inside the tile is in the tile's top-k)
            td, ti = topk_smallest(d, k)
            best_d, best_i = merge_topk(best_d, best_i, td, lo + ti, k)
        else:
            best_d, best_i = merge_topk(
                best_d, best_i, d, gidx.expand_as(d), k)
    return best_d, best_i
