"""Analytic host-to-device byte accounting for the bulk join — the port's
copy of the parts of knn_tpu/analysis/hbm.py the join engine reads over a
device-resident corpus: query block bytes, the query superblock plan under
a byte budget, and the sweep-nesting plan (:func:`plan_join`).  Queries
are float32 rows on one card.  The host-RAM tier's planning (the corpus
placement bytes, ``plan_segments`` and the join's streamed-segment sweep)
waits for that tier."""

from __future__ import annotations

from typing import List, Tuple

#: bytes per query element: the join moves float32 rows
QUERY_ITEMSIZE = 4


def query_block_bytes(n_rows: int, dim: int) -> int:
    """Host->device bytes one ``[n_rows, dim]`` float32 query block
    transfers (no aux column)."""
    n_rows, dim = int(n_rows), int(dim)
    if n_rows < 0 or dim <= 0:
        raise ValueError(f"bad query block shape ({n_rows}, {dim})")
    return n_rows * dim * QUERY_ITEMSIZE


def superblock_rows_for_budget(budget_bytes: int, dim: int) -> int:
    """The largest query-superblock row count whose h2d block fits
    ``budget_bytes``."""
    if budget_bytes <= 0:
        raise ValueError(f"budget_bytes must be > 0, got {budget_bytes}")
    return int(budget_bytes) // (int(dim) * QUERY_ITEMSIZE)


def plan_superblocks(n_a: int, dim: int,
                     budget_bytes: int) -> List[Tuple[int, int]]:
    """``[(lo, hi), ...]`` query-superblock extents covering ``[0, n_a)``,
    every superblock the same padded width.  Raises when the budget cannot
    hold even one query row."""
    n_a = int(n_a)
    if n_a <= 0:
        raise ValueError(f"n_a must be > 0, got {n_a}")
    sb = superblock_rows_for_budget(budget_bytes, dim)
    if sb < 1:
        raise ValueError(
            f"query budget {budget_bytes} B cannot hold even 1 query row "
            f"of dim {dim} at {QUERY_ITEMSIZE} B/elem; raise the budget")
    sb = min(sb, n_a)
    return [(lo, min(lo + sb, n_a)) for lo in range(0, n_a, sb)]


def plan_join(n_a: int, n_b: int, dim: int, *, superblock_rows: int) -> dict:
    """The bulk kNN-join plan over a device-resident corpus B: ``s =
    ceil(n_a / superblock_rows)`` superblocks, one db segment, so the
    order is query_major, A moves h2d once and B streams nothing; ``s``
    dispatches.  The keys are the JAX package's, whose ``db_major`` total
    equals ``A_bytes`` here."""
    n_a, n_b = int(n_a), int(n_b)
    sb = int(superblock_rows)
    if n_a <= 0 or n_b <= 0 or sb <= 0:
        raise ValueError(
            f"bad join shape n_a={n_a} n_b={n_b} "
            f"superblock_rows={superblock_rows}")
    s = -(-n_a // sb)
    a_bytes = query_block_bytes(n_a, dim)
    return {
        "order": "query_major",
        "superblocks": s,
        "db_segments": 1,
        "dispatches": s,
        "h2d_bytes": {"query_major": a_bytes, "db_major": a_bytes},
        "a_bytes": a_bytes,
        "b_stream_bytes": 0,
    }
