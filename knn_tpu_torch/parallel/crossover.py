"""The ring / allgather merge crossover — the port of
knn_tpu/parallel/crossover.py, merge-strategy selection as data.

- :data:`MEASURED_CROSSOVER` is the JAX package's table: the argmin-wall
  strategy at every ``(k, shards)`` point of ``SCALING.json``, measured by
  the JAX package on 8 virtual CPU devices of one core (its protocol
  block says so).  It is not a measurement of this port or of any card;
  a table measured on several cards waits for a machine with more than
  one.  Both strategies return bitwise the same result, so the table
  moves only speed.  tests/test_torch_mesh.py pins it against the JSON,
  as tests/test_collectives.py pins the JAX package's copy.
- :func:`choose_merge` / :func:`resolve_merge`: the nearest measured
  point's strategy, with the precedence explicit argument > table.  The
  JAX package reads ``KNN_TPU_MERGE`` / ``KNN_TPU_DCN_MERGE`` between the
  two; the port takes ``ShardedKNN(merge=, dcn_merge=)`` only (ROADMAP
  queue C), so a resolved strategy's source is "explicit" or "measured".
- :func:`merge_bytes`: the candidate volume one merge moves (allgather
  ``Q·k·8·P``, ring ``Q·k·8·(P-1)``; 8 = an f32 distance and an i32
  index), which ``MERGE_BYTES`` counts and the roofline's DCN term
  prices.  On one controller (parallel.sharded) the allgather writes
  the P lists into one buffer on the output device and the ring moves
  its accumulator P-1 hops: the same volumes.
- :func:`validate_multihost_block`: a shim over the artifact catalog's
  ``multihost`` schema (knn_tpu_torch.analysis.artifacts), with the JAX
  package's error strings.

Plain arithmetic on plain numbers: nothing here imports torch.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

#: the two db-axis merge strategies
STRATEGIES = ("allgather", "ring")

#: where a resolved strategy came from, in the JAX package's precedence
#: order; the port never resolves "env" (it reads no switch), and keeps the
#: name so a bench block of either package validates alike
SOURCES = ("explicit", "env", "measured")

#: bytes one (distance f32, index i32) candidate pair moves
CANDIDATE_BYTES = 8

#: ``(k, shards) -> strategy``: the JAX package's argmin-wall_s strategy
#: at every SCALING.json point (mesh column "QxP" gives P)
MEASURED_CROSSOVER: Dict[Tuple[int, int], str] = {
    (10, 2): "allgather",
    (10, 4): "ring",
    (10, 8): "allgather",
    (100, 2): "ring",
    (100, 4): "ring",
    (100, 8): "allgather",
}


def _nearest(value: int, measured) -> int:
    """The measured grid point nearest ``value`` in log space; ties take
    the smaller point."""
    v = math.log(max(1, int(value)))
    return min(sorted(set(measured)), key=lambda m: (abs(math.log(m) - v), m))


def choose_merge(k: int, shards: int) -> str:
    """The table's strategy for a ``(k, shards)`` merge (the nearest
    measured point's).  ``shards <= 1`` needs no merge: allgather."""
    if shards <= 1:
        return "allgather"
    ks = {mk for mk, _ in MEASURED_CROSSOVER}
    ps = {mp for _, mp in MEASURED_CROSSOVER}
    return MEASURED_CROSSOVER[(_nearest(k, ks), _nearest(shards, ps))]


def resolve_merge(explicit: Optional[str], k: int,
                  shards: int) -> Tuple[str, str]:
    """``(strategy, source)``: the caller's ``explicit`` strategy, else
    the measured table's."""
    if explicit is not None:
        if explicit not in STRATEGIES:
            raise ValueError(
                f"unknown merge {explicit!r}; expected one of {STRATEGIES}")
        return explicit, "explicit"
    return choose_merge(k, shards), "measured"


def merge_bytes(n_queries: int, k: int, shards: int, strategy: str) -> int:
    """Candidate bytes one merge of a ``[n_queries, k]`` result moves
    across ``shards``: allgather ships every list to every shard
    (``Q·k·8·P``), the ring passes one buffer P-1 hops (``Q·k·8·(P-1)``).
    SCALING.json's ``merge_bytes_per_sweep`` column exactly."""
    if strategy not in STRATEGIES:
        raise ValueError(
            f"unknown merge {strategy!r}; expected one of {STRATEGIES}")
    if shards <= 1:
        return 0
    hops = shards if strategy == "allgather" else shards - 1
    return int(n_queries) * int(k) * CANDIDATE_BYTES * hops


def validate_multihost_block(block) -> list:
    """Errors of a ``multihost`` bench block (empty when well-formed): the
    artifact catalog's ``multihost`` schema in the legacy style, its error
    strings byte for byte the JAX package's."""
    from knn_tpu_torch.analysis.artifacts import validate

    return validate("multihost", block, style="legacy")


__all__ = [
    "STRATEGIES",
    "SOURCES",
    "CANDIDATE_BYTES",
    "MEASURED_CROSSOVER",
    "choose_merge",
    "resolve_merge",
    "merge_bytes",
    "validate_multihost_block",
]
