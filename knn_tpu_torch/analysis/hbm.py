"""Analytic device-memory and host-to-device byte accounting — the port's
copy of knn_tpu/analysis/hbm.py: the bytes a database placement holds
(:func:`placement_bytes`), the host-RAM tier's segment plan under a
per-host byte budget, each segment a multiple of the db shards
(:func:`plan_segments`, :func:`n_sweeps`), query block
bytes and the join's superblock plan (:func:`plan_superblocks`), and the
join's sweep-nesting plan (:func:`plan_join`, with a resident or a
streamed corpus).  Queries are float32 rows.  On one device
(``hosts=1``, ``shard_multiple=1``) the plan is the one-card plan.

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


def placement_bytes(n_rows: int, dim: int, itemsize: int = 4) -> int:
    """Device bytes a ``[n_rows, dim]`` placement occupies across the mesh:
    the value matrix at ``itemsize`` bytes an element plus the per-row aux
    value."""
    n_rows, dim = int(n_rows), int(dim)
    if n_rows < 0 or dim <= 0:
        raise ValueError(f"bad placement shape ({n_rows}, {dim})")
    return n_rows * (dim * int(itemsize) + AUX_BYTES_PER_ROW)


def rows_for_budget(budget_bytes: int, dim: int, *, itemsize: int = 4,
                    hosts: int = 1, shard_multiple: int = 1) -> int:
    """The largest row count whose per-host placement share fits
    ``budget_bytes`` (the budget is per host: ``hosts`` of them hold a
    segment), rounded down to ``shard_multiple`` (the db shards: a
    segment divides evenly over them)."""
    if budget_bytes <= 0:
        raise ValueError(f"budget_bytes must be > 0, got {budget_bytes}")
    per_row = int(dim) * int(itemsize) + AUX_BYTES_PER_ROW
    rows = (int(budget_bytes) * max(1, int(hosts))) // per_row
    return (rows // shard_multiple) * shard_multiple


def plan_segments(n_rows: int, dim: int, budget_bytes: int, *,
                  itemsize: int = 4, hosts: int = 1,
                  shard_multiple: int = 1) -> List[Tuple[int, int]]:
    """``[(lo, hi), ...]`` row segments covering ``[0, n_rows)``, every
    segment's per-host placed bytes within ``budget_bytes``, every segment
    the same padded width (``segment_rows``, a multiple of
    ``shard_multiple``: the ragged tail pads up, so every sweep has one
    shape).  Raises when the budget cannot hold one ``shard_multiple`` of
    rows."""
    n_rows = int(n_rows)
    if n_rows <= 0:
        raise ValueError(f"n_rows must be > 0, got {n_rows}")
    seg = rows_for_budget(budget_bytes, dim, itemsize=itemsize, hosts=hosts,
                          shard_multiple=shard_multiple)
    if seg < shard_multiple or seg < 1:
        raise ValueError(
            f"hbm budget {budget_bytes} B/host cannot hold even "
            f"{shard_multiple} rows of dim {dim} at {itemsize} B/elem; "
            f"raise the budget or use fewer db shards")
    seg = min(seg, -(-n_rows // shard_multiple) * shard_multiple)
    return [(lo, min(lo + seg, n_rows)) for lo in range(0, n_rows, seg)]


def n_sweeps(n_rows: int, dim: int, budget_bytes: int, *, itemsize: int = 4,
             hosts: int = 1, shard_multiple: int = 1) -> int:
    """The sweep count the plan implies."""
    return len(plan_segments(n_rows, dim, budget_bytes, itemsize=itemsize,
                             hosts=hosts, shard_multiple=shard_multiple))


def query_block_bytes(n_rows: int, dim: int) -> int:
    """Host->device bytes one ``[n_rows, dim]`` float32 query block
    transfers (no aux column)."""
    n_rows, dim = int(n_rows), int(dim)
    if n_rows < 0 or dim <= 0:
        raise ValueError(f"bad query block shape ({n_rows}, {dim})")
    return n_rows * dim * QUERY_ITEMSIZE


def superblock_rows_for_budget(budget_bytes: int, dim: int, *,
                               query_multiple: int = 1) -> int:
    """The largest query-superblock row count whose h2d block fits
    ``budget_bytes``, rounded down to ``query_multiple`` (a mesh's query
    shards: a placed block divides evenly across the query axis)."""
    if budget_bytes <= 0:
        raise ValueError(f"budget_bytes must be > 0, got {budget_bytes}")
    rows = int(budget_bytes) // (int(dim) * QUERY_ITEMSIZE)
    return (rows // query_multiple) * query_multiple


def plan_superblocks(n_a: int, dim: int, budget_bytes: int, *,
                     query_multiple: int = 1) -> List[Tuple[int, int]]:
    """``[(lo, hi), ...]`` query-superblock extents covering ``[0, n_a)``,
    every superblock the same padded width, a multiple of
    ``query_multiple`` rows.  Raises when the budget cannot hold even
    ``query_multiple`` query rows."""
    n_a = int(n_a)
    if n_a <= 0:
        raise ValueError(f"n_a must be > 0, got {n_a}")
    sb = superblock_rows_for_budget(budget_bytes, dim,
                                    query_multiple=query_multiple)
    if sb < 1:
        rows = ("1 query row" if query_multiple == 1
                else f"{query_multiple} query rows")
        raise ValueError(
            f"query budget {budget_bytes} B cannot hold even {rows} "
            f"of dim {dim} at {QUERY_ITEMSIZE} B/elem; raise the budget"
            + ("" if query_multiple == 1 else " or use fewer query shards"))
    sb = min(sb, -(-n_a // query_multiple) * query_multiple)
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
