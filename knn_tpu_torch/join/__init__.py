"""knn_tpu_torch.join — the bulk kNN join on one GPU (the port of
knn_tpu/join): the top-k of every row of a query set A against a corpus B,
with the placed db streamed once per query superblock.

Entry points: :func:`knn_join` (a port ``ShardedKNN`` placement, or an
``IVFIndex`` in certified mode) and :func:`default_plan` (the superblock
and sweep-nesting plan the engine would run).  The host-RAM tier's
``_stream_tiered`` and the ``join`` bench-block validator are later
slices."""

from knn_tpu_torch.join.engine import JOIN_MODES, default_plan, knn_join

__all__ = ["JOIN_MODES", "default_plan", "knn_join"]
