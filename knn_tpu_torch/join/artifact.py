"""The join's artifact pieces: the version token and the ``join``
bench-artifact validator — the port's copy of knn_tpu/join/artifact.py.

Apart from :mod:`knn_tpu_torch.join.engine` so that whatever validates
curated artifacts imports no torch of its own: a shim over the
artifact-schema catalog (:mod:`knn_tpu_torch.analysis.artifacts`, the
``join`` entry).
"""

from __future__ import annotations

from typing import List

#: version stamp of the ``join`` bench block (the JAX package's value);
#: bump on any schema change so a refresher refuses half-migrated lines
#: — the version token the catalog's ``join`` entry consumes
JOIN_VERSION = 1


def _required_fields():
    from knn_tpu_torch.analysis.artifacts import required_keys

    return required_keys("join")


#: fields every valid join block must carry — DERIVED from the
#: artifact-schema catalog, the one declaration the validator and the
#: lockstep checker both read
JOIN_REQUIRED = _required_fields()


def validate_join_block(block) -> List[str]:
    """Structural validation of a ``join`` block: the list of violations
    (empty = valid), in the JAX package's words.  Blocks that recorded
    their own failure (an ``error`` key) are exempt."""
    from knn_tpu_torch.analysis.artifacts import validate

    return validate("join", block, style="legacy")
