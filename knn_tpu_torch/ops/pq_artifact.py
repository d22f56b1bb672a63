"""The PQ compressed tier's artifact pieces: the version token and the
``pq`` bench-artifact validator — the port's copy of
knn_tpu/ops/pq_artifact.py.

Apart from :mod:`knn_tpu_torch.ops.pq` so that whatever validates
curated artifacts imports no torch of its own: a shim over the
artifact-schema catalog (:mod:`knn_tpu_torch.analysis.artifacts`, the
``pq`` entry).
"""

from __future__ import annotations

from typing import List

#: version stamp of the ``pq`` bench block (the JAX package's value);
#: bump on any schema change so a refresher refuses half-migrated lines
#: — the version token the catalog's ``pq`` entry consumes
PQ_VERSION = 1


def _required_fields():
    from knn_tpu_torch.analysis.artifacts import required_keys

    return required_keys("pq")


#: fields every valid pq block must carry — DERIVED from the
#: artifact-schema catalog, the one declaration the validator and the
#: lockstep checker both read
PQ_REQUIRED = _required_fields()


def validate_pq_block(block) -> List[str]:
    """Structural validation of a ``pq`` block: the list of violations
    (empty = valid), in the JAX package's words.  Blocks that recorded
    their own failure (an ``error`` key) are exempt."""
    from knn_tpu_torch.analysis.artifacts import validate

    return validate("pq", block, style="legacy")
