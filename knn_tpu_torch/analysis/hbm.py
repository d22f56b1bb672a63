"""Analytic device-memory and host-to-device byte accounting — the port's
copy of knn_tpu/analysis/hbm.py for one card: the bytes a database
placement holds (:func:`placement_bytes`), the host-RAM tier's segment plan
under a byte budget (:func:`plan_segments`, :func:`n_sweeps`), query block
bytes and the join's superblock plan (:func:`plan_superblocks`), and the
join's sweep-nesting plan (:func:`plan_join`, with a resident or a
streamed corpus).  Queries are float32 rows.

The placement bytes are the JAX package's model (the f32 rows plus one
f32 aux value per row): the tier streams the f32 rows, and plans the same
segments as the JAX package for the same budget.
"""

from __future__ import annotations

from typing import List, Tuple

from knn_tpu_torch.analysis import widths as _widths

#: bytes per element: the placements and the join's queries are float32
QUERY_ITEMSIZE = 4

#: f32 aux bytes the placement model keeps beside each row (the hoisted
#: squared norm; analysis.widths)
AUX_BYTES_PER_ROW = _widths.AUX_BYTES_PER_ROW


def placement_bytes(n_rows: int, dim: int) -> int:
    """Device bytes a ``[n_rows, dim]`` float32 placement occupies: the
    value matrix plus the per-row aux value."""
    n_rows, dim = int(n_rows), int(dim)
    if n_rows < 0 or dim <= 0:
        raise ValueError(f"bad placement shape ({n_rows}, {dim})")
    return n_rows * (dim * QUERY_ITEMSIZE + AUX_BYTES_PER_ROW)


def rows_for_budget(budget_bytes: int, dim: int) -> int:
    """The largest row count whose placement fits ``budget_bytes``."""
    if budget_bytes <= 0:
        raise ValueError(f"budget_bytes must be > 0, got {budget_bytes}")
    return int(budget_bytes) // placement_bytes(1, dim)


def plan_segments(n_rows: int, dim: int,
                  budget_bytes: int) -> List[Tuple[int, int]]:
    """``[(lo, hi), ...]`` row segments covering ``[0, n_rows)``, every
    segment's placed bytes within ``budget_bytes`` and every segment the
    same padded width (``segment_rows``: the ragged tail pads up, so every
    sweep has one shape).  Raises when the budget cannot hold one row."""
    n_rows = int(n_rows)
    if n_rows <= 0:
        raise ValueError(f"n_rows must be > 0, got {n_rows}")
    seg = rows_for_budget(budget_bytes, dim)
    if seg < 1:
        raise ValueError(
            f"hbm budget {budget_bytes} B cannot hold even 1 row of dim "
            f"{dim} at {QUERY_ITEMSIZE} B/elem; raise the budget")
    seg = min(seg, n_rows)
    return [(lo, min(lo + seg, n_rows)) for lo in range(0, n_rows, seg)]


def n_sweeps(n_rows: int, dim: int, budget_bytes: int) -> int:
    """The sweep count the plan implies."""
    return len(plan_segments(n_rows, dim, budget_bytes))


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


def n_superblocks(n_a: int, dim: int, budget_bytes: int) -> int:
    """The superblock count the plan implies."""
    return len(plan_superblocks(n_a, dim, budget_bytes))


def plan_join(n_a: int, n_b: int, dim: int, *, superblock_rows: int,
              db_segment_rows: int = 0) -> dict:
    """The bulk kNN-join sweep-nesting plan: which loop goes outer when the
    query set A and the corpus B both stream from host RAM.

    With ``s = ceil(n_a / superblock_rows)`` superblocks and ``g =
    ceil(n_b / db_segment_rows)`` db segments (``db_segment_rows = 0``: B
    is device-resident, ``g = 1`` and it streams nothing):

    - **query_major** (superblocks outer): each superblock moves h2d once,
      each db segment once per superblock — ``A_bytes + s * B_bytes``;
    - **db_major** (db segments outer): each db segment moves once and
      serves every superblock, each superblock once per segment —
      ``B_bytes + g * A_bytes``.

    ``order`` is the one with fewer h2d bytes (a tie, and a resident B,
    take query_major: it needs no per-superblock carry across segments);
    ``s * g`` dispatches either way."""
    n_a, n_b = int(n_a), int(n_b)
    sb = int(superblock_rows)
    if n_a <= 0 or n_b <= 0 or sb <= 0:
        raise ValueError(
            f"bad join shape n_a={n_a} n_b={n_b} "
            f"superblock_rows={superblock_rows}")
    s = -(-n_a // sb)
    a_bytes = query_block_bytes(n_a, dim)
    seg = int(db_segment_rows)
    if seg <= 0:  # resident corpus: placed once, nothing streamed a sweep
        g, b_bytes = 1, 0
    else:
        g = -(-n_b // seg)
        b_bytes = placement_bytes(n_b, dim)
    qm_bytes = a_bytes + s * b_bytes
    dm_bytes = b_bytes + g * a_bytes
    return {
        "order": ("db_major" if seg > 0 and dm_bytes < qm_bytes
                  else "query_major"),
        "superblocks": s,
        "db_segments": g,
        "dispatches": s * g,
        "h2d_bytes": {"query_major": qm_bytes, "db_major": dm_bytes},
        "a_bytes": a_bytes,
        "b_stream_bytes": b_bytes,
    }
