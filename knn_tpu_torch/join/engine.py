"""The bulk kNN-join engine on one GPU or a mesh — the port of
knn_tpu/join/engine.py (``knn_join``, ``default_plan``).  Query-side
double buffering over the existing search programs; no new kernels.

Two modes (:data:`JOIN_MODES`):

- ``"stream"``: the throughput path.  A splits into fixed-width query
  superblocks (explicit rows > a query-byte budget through
  :func:`knn_tpu_torch.analysis.hbm.plan_superblocks` > the library
  default); each superblock is placed on the card and searched by
  :func:`knn_tpu_torch.parallel.sharded.query_stream_program` (the program
  ``ShardedKNN.search`` runs), its outputs copied back into pinned host
  memory behind an event of their own, with at most ``depth`` superblocks
  in flight, the oldest drained first: block i+1's copy and search are
  enqueued while the host waits for block i.  ``overlap_ratio`` is the
  dispatch-timeline concurrency the certified pipeline also reports.
  Results are bitwise the looped ``ShardedKNN.search`` at the same padded
  block shape.  On a mesh the program is the mesh's (the superblock split
  over the query shards, the placement's db shards merged; a
  query-byte budget sizes superblocks in query-shard multiples), and
  ``k`` may not exceed a db shard's rows.
- ``"certified"``: each superblock runs the placement's unmodified
  ``search_certified`` (any selector, precision and kernel; kwargs
  forwarded; an :class:`~knn_tpu_torch.ivf.index.IVFIndex` works the same
  way), so the join equals the looped certified path bitwise; on a mesh
  each superblock launches the coarse kernel once a db shard.

A stream join over a host-RAM-tier placement (``ShardedKNN(...,
hbm_budget_bytes=)``) sweeps both A and B through the tier's segment
program in the order the byte model picks (``plan_join``): ``db_major``
copies each db segment up once and runs every superblock against it,
``query_major`` places each superblock once and streams every segment
past it; each superblock's top-k carry merges on the card in the
lexicographic ``(distance, index)`` order, so the join is bitwise the
looped host-tier ``search`` at the same block shape.  On a mesh the
tier's segment program is the mesh's (each segment's blocks over the db
shards, the queries over the query shards, the shards' lists merged onto
the first device, where the carry merges).

On a mesh that spans processes (parallel.multihost.global_mesh) every
process calls the join with the same queries: the resident stream and
the certified loop run the mesh's programs, each process its own
positions, and every process returns the whole ``(d, i)``.  The tiered
join does not run there (its host-RAM tier is refused by name on such a
mesh).

Every run returns ``(d, i, stats)``; ``stats`` carries the executed
superblock / segment / dispatch counts (checked against the
:mod:`knn_tpu_torch.analysis.hbm` plan), ``rows_per_s`` and
``overlap_ratio``; each run records a ``join.bulk`` span
(knn_tpu_torch.obs).  Where the port differs (ROADMAP queue C): the knobs
are arguments (no ``KNN_TPU_JOIN_*`` switch) and there is no transient
retry.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np

from knn_tpu_torch import obs
from knn_tpu_torch.analysis import hbm

#: query-superblock width when neither explicit rows nor a query-byte
#: budget decides
DEFAULT_SUPERBLOCK_ROWS = 4096

#: bounded in-flight superblock depth of the drain-oldest stream
DEFAULT_DEPTH = 2

JOIN_MODES = ("stream", "certified")


def _is_sharded(program) -> bool:
    return hasattr(program, "_place_queries")


def _query_dim(program) -> int:
    if _is_sharded(program):
        return int(program.dim_in)
    return int(program.dim)  # IVFIndex


def _query_multiple(program) -> int:
    """The query shards of the program's mesh (1 on one device)."""
    from knn_tpu_torch.parallel.mesh import QUERY_AXIS

    return int(program.mesh.shape[QUERY_AXIS])


def _resolve_superblock(program, n_a: int, superblock_rows: Optional[int],
                        query_budget_bytes: Optional[int]) -> int:
    """Superblock width: explicit rows > a query-byte budget through the
    hbm model > the library default — clamped to ``n_a``, at least 1."""
    rows = superblock_rows
    if rows is None:
        if query_budget_bytes is not None:
            segs = hbm.plan_superblocks(
                n_a, _query_dim(program), query_budget_bytes,
                query_multiple=_query_multiple(program))
            rows = segs[0][1] - segs[0][0]
        else:
            rows = DEFAULT_SUPERBLOCK_ROWS
    rows = int(rows)
    if rows < 1:
        raise ValueError(f"superblock_rows must be >= 1, got {rows}")
    return min(rows, int(n_a))


def default_plan(program, n_a: int, *,
                 superblock_rows: Optional[int] = None,
                 query_budget_bytes: Optional[int] = None) -> dict:
    """The plan :func:`knn_join` would execute for ``n_a`` query rows
    against ``program``'s corpus: superblock width, sweep nesting order and
    h2d byte totals (analysis.hbm.plan_join; ``db_segment_rows`` is 0 for a
    device-resident corpus, the segment width of a host-RAM-tier one)."""
    sb = _resolve_superblock(program, n_a, superblock_rows,
                             query_budget_bytes)
    tier = getattr(program, "_host_tier", None)
    seg_rows = 0 if tier is None else int(tier["segment_rows"])
    n_b = int(program.n_train if _is_sharded(program)
              else program.stats()["live_rows"])
    plan = hbm.plan_join(n_a, n_b, _query_dim(program), superblock_rows=sb,
                         db_segment_rows=seg_rows)
    plan["superblock_rows"] = sb
    plan["db_segment_rows"] = seg_rows
    return plan


def _pad_block(q: np.ndarray, lo: int, hi: int, rows: int) -> np.ndarray:
    """One fixed-width query block (the ragged tail zero-pads up; pad rows
    are ordinary queries whose outputs are sliced away)."""
    blk = q[lo:hi]
    if blk.shape[0] < rows:
        blk = np.pad(blk, ((0, rows - blk.shape[0]), (0, 0)))
    return blk


class _CopyBack:
    """The drain-oldest copy-back both stream joins share: each finished
    superblock's device ``(d, i)`` (``return_sqrt``: mapped to the
    metric's values first, as ``ShardedKNN.search`` maps them) is copied
    into pinned host memory behind an event of its own; once ``depth`` are
    pending, the oldest is waited for and written into the outputs."""

    def __init__(self, depth: int, metric: str, return_sqrt: bool,
                 d_out, i_out):
        self.depth, self.metric, self.return_sqrt = depth, metric, return_sqrt
        self.d_out, self.i_out = d_out, i_out
        self.pending: list = []
        self.intervals: list = []

    def wait_room(self) -> None:
        """Drains the oldest until fewer than ``depth`` are pending."""
        while len(self.pending) >= self.depth:
            self._collect()

    def put(self, lo: int, hi: int, t0: float, d, i) -> None:
        from knn_tpu_torch.ops.distance import metric_values
        from knn_tpu_torch.parallel.sharded import _host_copies

        if self.return_sqrt:
            d = metric_values(d, self.metric)
        self.pending.append((lo, hi, t0, _host_copies((d, i))))

    def _collect(self) -> None:
        lo, hi, t0, ((d, i), event) = self.pending.pop(0)
        if event is not None:
            event.synchronize()
        self.intervals.append((t0, time.perf_counter()))
        self.d_out[lo:hi] = d[: hi - lo].numpy()
        self.i_out[lo:hi] = i[: hi - lo].numpy()

    def drain(self) -> float:
        """Collects every pending block; the dispatch-timeline overlap."""
        from knn_tpu_torch.parallel.sharded import _overlap_ratio

        while self.pending:
            self._collect()
        return round(_overlap_ratio(self.intervals), 4)


def _stream_resident(program, q: np.ndarray, k: int, sb_rows: int,
                     depth: int, return_sqrt: bool, d_out, i_out) -> dict:
    """Resident-B stream: query superblocks through the search program
    (the mesh's on a mesh), each block's results copied back behind its
    own event, drain-oldest at ``depth``."""
    prog = program._stream_program(k, program.metric, program._dtype_key)
    db = program.placed_db() if program._on_mesh() \
        else program.placement.db
    n_a = q.shape[0]
    blocks = [(lo, min(lo + sb_rows, n_a)) for lo in range(0, n_a, sb_rows)]
    back = _CopyBack(depth, program.metric, return_sqrt, d_out, i_out)
    for lo, hi in blocks:
        back.wait_room()
        t0 = time.perf_counter()
        qp, _ = program._place_queries(_pad_block(q, lo, hi, sb_rows))
        back.put(lo, hi, t0, *prog(qp, db))
    return {
        "superblocks": len(blocks),
        "db_segments": 1,
        "dispatches": len(blocks),
        "overlap_ratio": back.drain(),
    }


def _stream_tiered(program, q: np.ndarray, k: int, sb_rows: int,
                   depth: int, order: str, return_sqrt: bool,
                   d_out, i_out) -> dict:
    """Host-RAM-tier B: superblocks and db segments through the tier's
    segment program in ``order`` (the JAX package's ``_stream_tiered``,
    join/engine.py:218-335), the segments streamed as the tier's search
    streams them (``ShardedKNN._stream_segments``, under the tier's lock).
    ``db_major``: one pass over the segments, each copied up once, every
    superblock placed and run against it; ``query_major``: each superblock
    placed once, one pass over the segments for each.  Each superblock's
    carry merges on the card (ops.topk.merge_topk) and, after its last
    segment, is copied back as the resident stream's blocks are."""
    import torch

    from knn_tpu_torch.ops.topk import I32MAX, merge_topk

    prog = program._hosttier_program(k)
    n_a = q.shape[0]
    blocks = [(lo, min(lo + sb_rows, n_a)) for lo in range(0, n_a, sb_rows)]
    n_seg = len(program._host_tier["segments"])
    carry = [None] * len(blocks)
    started = [None] * len(blocks)
    back = _CopyBack(depth, program.metric, return_sqrt, d_out, i_out)
    dispatches = 0

    def run(bi: int, qp, lo: int, hi: int, seg) -> None:
        nonlocal dispatches
        if started[bi] is None:
            started[bi] = time.perf_counter()
        d, i = prog(qp, seg, hi - lo)
        gi = torch.where(i == I32MAX, i, i + lo)
        carry[bi] = (d, gi) if carry[bi] is None else \
            merge_topk(*carry[bi], d, gi, k)
        dispatches += 1

    def finish(bi: int) -> None:
        back.wait_room()
        back.put(*blocks[bi], started[bi], *carry[bi])
        carry[bi] = None

    def place_q(lo: int, hi: int):
        return program._place_queries(_pad_block(q, lo, hi, sb_rows))[0]

    with program._tier_lock:
        if order == "db_major":
            for s, (lo, hi, seg) in enumerate(program._stream_segments()):
                for bi, (qlo, qhi) in enumerate(blocks):
                    run(bi, place_q(qlo, qhi), lo, hi, seg)
                    if s == n_seg - 1:
                        finish(bi)
        else:  # query_major
            for bi, (qlo, qhi) in enumerate(blocks):
                qp = place_q(qlo, qhi)
                for lo, hi, seg in program._stream_segments():
                    run(bi, qp, lo, hi, seg)
                finish(bi)
        overlap = back.drain()
    return {
        "superblocks": len(blocks),
        "db_segments": n_seg,
        "dispatches": dispatches,
        "overlap_ratio": overlap,
    }


def _certified_loop(program, q: np.ndarray, k: int, sb_rows: int,
                    d_out, i_out, kw: dict) -> dict:
    """The unmodified certified path per superblock (ragged tail as it
    is), so the join equals the looped certified path bitwise."""
    n_a = q.shape[0]
    blocks = [(lo, min(lo + sb_rows, n_a)) for lo in range(0, n_a, sb_rows)]
    fallbacks = 0
    for lo, hi in blocks:
        if _is_sharded(program):
            d, i, st = program.search_certified(q[lo:hi], **kw)
        else:  # IVFIndex — same surface, k rides as a kwarg
            d, i, st = program.search_certified(q[lo:hi], k=k, **kw)
        d_out[lo:hi] = d
        i_out[lo:hi] = i
        fallbacks += int(st.get("fallback_queries", 0))
    return {
        "superblocks": len(blocks),
        "db_segments": 1,
        "dispatches": len(blocks),
        "fallback_queries": fallbacks,
        "overlap_ratio": None,  # the certified loop has no pipeline
    }


def knn_join(
    program,
    queries,
    *,
    k: Optional[int] = None,
    mode: str = "stream",
    superblock_rows: Optional[int] = None,
    depth: Optional[int] = None,
    query_budget_bytes: Optional[int] = None,
    return_sqrt: bool = False,
    **certified_kw,
) -> Tuple[np.ndarray, np.ndarray, dict]:
    """Top-k of every row of ``queries`` (A) against ``program``'s corpus
    (B): ``(d [N_A, k], i [N_A, k], stats)`` host arrays.

    ``program`` is a port :class:`~knn_tpu_torch.parallel.sharded.
    ShardedKNN` or an :class:`~knn_tpu_torch.ivf.index.IVFIndex`
    (certified mode only); the work runs on its device.
    ``mode="stream"`` is the double-buffered throughput path;
    ``mode="certified"`` loops the certified path per superblock and
    forwards ``certified_kw`` (selector, precision, kernel, margin, ...).
    ``superblock_rows`` (default 4096, or from ``query_budget_bytes``) and
    ``depth`` (default 2) are arguments only.  ``stats`` reports the
    executed superblock / db-segment / dispatch counts (checked against
    the plan), ``rows_per_s``, ``overlap_ratio`` (stream mode) and the
    byte-model ``plan``."""
    if mode not in JOIN_MODES:
        raise ValueError(f"unknown join mode {mode!r}; expected one of "
                         f"{JOIN_MODES}")
    sharded = _is_sharded(program)
    if not sharded and mode != "certified":
        raise ValueError(
            "IVF joins run mode='certified' only (the probed tier has no "
            "resident placement to stream queries against)")
    q = np.ascontiguousarray(np.asarray(queries, np.float32))
    dim = _query_dim(program)
    if q.ndim != 2 or q.shape[1] != dim:
        raise ValueError(
            f"queries shape {q.shape} incompatible with corpus dim {dim}")
    k = int(k) if k is not None else int(program.k)
    if sharded:
        if mode == "certified" and k != int(program.k):
            raise ValueError(
                f"certified joins run the program's own certified path: "
                f"k={k} != program.k={program.k}; construct the placement "
                f"with the join k")
        tier = program._host_tier
        placed = (int(program.n_train) if tier is None
                  else min(int(program.n_train), int(tier["segment_rows"])))
        if mode == "stream" and k > placed:
            raise ValueError(f"k={k} exceeds the {placed} placed rows")
        shard_rows = program._shard_rows()
        if mode == "stream" and k > shard_rows:
            raise ValueError(
                f"k={k} exceeds db shard size {shard_rows}; use fewer db "
                f"shards")
    n_a = q.shape[0]
    if n_a < 1:
        raise ValueError("knn_join needs at least one query row")
    sb_rows = _resolve_superblock(program, n_a, superblock_rows,
                                  query_budget_bytes)
    dep = DEFAULT_DEPTH if depth is None else max(1, int(depth))
    plan = default_plan(program, n_a, superblock_rows=sb_rows)
    i_out = np.empty((n_a, k), np.int64)
    d_out = np.empty((n_a, k),
                     np.float64 if mode == "certified" else np.float32)
    t0 = time.perf_counter()
    if mode == "certified":
        # the certified path owns its metric->value mapping: it applies
        # return_sqrt, so joined values equal the looped call's
        if return_sqrt:
            certified_kw = {**certified_kw, "return_sqrt": True}
        executed = _certified_loop(program, q, k, sb_rows, d_out, i_out,
                                   certified_kw)
    elif program._host_tier is not None:
        executed = _stream_tiered(program, q, k, sb_rows, dep,
                                  plan["order"], return_sqrt, d_out, i_out)
    else:
        executed = _stream_resident(program, q, k, sb_rows, dep,
                                    return_sqrt, d_out, i_out)
    wall = time.perf_counter() - t0
    # the executed sweep counts must match the plan: a drift means the
    # engine and the byte model disagree about what ran
    for key in ("superblocks", "db_segments", "dispatches"):
        if mode == "stream" and executed[key] != plan[key]:
            raise RuntimeError(
                f"join executed {key}={executed[key]} but the byte model "
                f"planned {plan[key]} — engine/model drift")
    stats = {
        "mode": mode,
        "k": k,
        "rows": n_a,
        "superblock_rows": sb_rows,
        "depth": dep,
        "order": plan["order"] if mode == "stream" else "query_major",
        "wall_s": round(wall, 6),
        "rows_per_s": round(n_a / wall, 3) if wall > 0 else float("inf"),
        "plan": plan,
        **executed,
    }
    obs.record_span("join.bulk", f"join-{id(program):x}", wall,
                    rows=n_a, mode=mode)
    return d_out, i_out, stats
