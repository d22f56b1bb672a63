"""Top-K majority vote with the reference's tie-break — the port of
knn_tpu/ops/vote.py (``majority_vote``, ``vote_counts``).

The reference votes with a per-query class histogram and a running argmax
with strict ``>`` over neighbors in ascending-distance order
(knn_mpi.cpp:324-336): the winner is the first label to *reach* the final
maximum count.  Vectorized as one-hot -> cumsum -> first position where a
label's cumulative count reaches the global max.  Out-of-range labels are
dropped (their one-hot row is zero), as ``jax.nn.one_hot`` drops them.
"""

from __future__ import annotations

import torch


def majority_vote(neighbor_labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Winner label per query: ``neighbor_labels`` [..., K] in
    ascending-distance order -> int32 [...]."""
    k = neighbor_labels.shape[-1]
    classes = torch.arange(num_classes, device=neighbor_labels.device)
    onehot = (neighbor_labels[..., None] == classes).to(torch.int32)  # [..., K, C]
    counts = onehot.sum(-2)  # [..., C]
    max_count = counts.amax(-1, keepdim=True)  # [..., 1]
    cum = onehot.cumsum(-2)
    # the step at which a label's count becomes the final max
    reach = (cum == max_count[..., None, :]) & (onehot == 1)
    steps = torch.arange(k, device=neighbor_labels.device)[:, None]
    first_reach = torch.where(reach, steps, k).amin(-2)  # [..., C]
    # labels that never reach the max get sentinel k; among reachers the
    # reach steps are distinct, so the argmin is unique
    masked = torch.where(counts == max_count, first_reach, k + 1)
    return torch.argmin(masked, dim=-1).to(torch.int32)


def vote_counts(neighbor_labels: torch.Tensor,
                num_classes: int) -> torch.Tensor:
    """Class histogram over the K neighbors, [..., num_classes] int32
    (out-of-range labels count nowhere, as ``jax.nn.one_hot`` drops
    them)."""
    classes = torch.arange(num_classes, device=neighbor_labels.device)
    return (neighbor_labels[..., None] == classes).sum(-2, dtype=torch.int32)
