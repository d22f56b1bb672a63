"""Placed KNN program on a device mesh — the port of
knn_tpu/parallel/sharded.py (``ShardedKNN``).

The database is placed once (knn_tpu_torch.convert.placement_from_numpy)
and every :meth:`ShardedKNN.search` / :meth:`~ShardedKNN.predict` /
:meth:`~ShardedKNN.search_certified` call reuses the placement.  On the
one-device mesh (the default; ``device=`` names it) the JAX package's merge
tree and ``pmin`` are identities; on any other mesh (parallel.mesh) the
queries split over the query axis, each db shard is a one-device
placement of its block of rows (PAD_VAL rows pad the last, masked by
index), each runs the programs below on its rows and device, and the
shards' lists merge (:func:`_merge_shards`: ring or allgather over each
host's shards, then across hosts), the exclusion bounds take their
minimum and the counts their sum (sharded.py:71-129, 2162-2540).  The
programs follow the JAX code path:

- ``search`` — exact distances of the placement's metric in its
  ``compute_dtype`` (f32 accumulation) and a stable top-k (ties to the
  lower index);
- ``search_certified(selector="exact" | "approx")`` — the counted
  certificate (:meth:`ShardedKNN._certify_counted`): a coarse top-m, the
  float64 refine of all m candidates, and one f32 count of the rows below
  an adaptive threshold (ops.certified.count_below);
- ``search_certified(selector="pallas")`` — the one-pass certificate:
  the coarse kernel (of knn_tpu_torch.ops.coarse_knn, by ``kernel``,
  ``precision``, ``grid_order`` and ``binning``: the tiled, streaming or
  fused entry of the bf16x3, bf16x3f, highest, int8, int4 or pq arm, in
  grouped or lane binning) emits per-bin survivors and exclusion bounds,
  the exact
  top-(m+2) and the direct-difference f32 rescore rank the candidates,
  the device certificate :func:`_certify_pack` flags queries whose k-th
  distance is not provably below the exclusion bound (``bad``) and marks
  near-tie pairs, the host repairs tie runs in float64
  (ops.refine.rank_correct_runs), and flagged queries rerun through the
  widened exact select + float64 refine (ops.certified.repair_uncertified).

The host-RAM tier (the JAX package's, sharded.py:650-975): with
``hbm_budget_bytes`` a database whose placement (analysis.hbm's byte
model) exceeds the budget a host is never placed.  Its prepared rows stay
on the host, split into segments of at most a budget a host, each a
multiple of the db shards (``hbm.plan_segments``), and ``search`` sweeps
them through :func:`segment_search_program` on the placement's device or
mesh, every segment padded to one shape with ``PAD_VAL``: each segment is
copied into one of ``hosttier_depth`` pinned staging buffers, up to every
distinct device of the mesh on a side stream of its own behind an event
into that slot's buffer there (the blocks of the db shards the device
holds), searched, and its top-k merged into a carry on the first device
in the lexicographic ``(distance, index)`` order (ops.topk.merge_topk).
At most ``hosttier_depth`` sweeps are in flight: a staging buffer is
refilled once its copies have finished, a device buffer once the sweep
that read it has.  The budget bounds a segment, not the card: the tier
keeps its ``hosttier_depth`` device buffers from its first search on, and
a sweep's search adds a workspace sized to at most one budget (its query
blocks, the segment's norms), so a search holds about ``hosttier_depth +
1`` budgets on the card (cosine one more: its normalized segment),
besides the queries and the top-k carry.  The paths that read the whole
database (certified search, predict, radius search, bucketed serving)
refuse such a placement by name.

Batches run on the card while the host repairs earlier ones: each batch's
certify output is copied into pinned host memory behind a CUDA event of
its own, and the host waits on that event alone.  ``overlap=True`` runs
the two-stage pipeline of the JAX package (sharded.py:1966-2011) on any
mesh: every shard's coarse kernel on a coarse CUDA stream of its device,
the select/rescore/merge/certify tail on a tail stream, at most
``overlap_depth`` batches in flight.

Telemetry (knn_tpu_torch.obs, sharded.py:1632-1642, 1767-1769,
1923-1942, 2007-2008 of the JAX package): every certified call adds its
queries and repair counts to the ``CERTIFIED_*`` counters by selector,
the counted certificate observes each certified query's margin into
``CERTIFIED_MARGIN{path="sharded"}``, the int and pq arms their per-query
ε into ``CERTIFIED_QUANT_BOUND`` (recomputed on the host from the
queries and the placement's host stats), and the pipeline sets
``PIPELINE_OVERLAP_RATIO`` and records a ``certified.pipeline`` span.
Only values already on the host are recorded: no obs line reads a
device tensor.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Optional, Tuple

import numpy as np
import torch

from knn_tpu_torch import obs, tuning
from knn_tpu_torch.analysis import hbm
from knn_tpu_torch.convert import (HostRows, Placement, host_rows,
                                   place_host_rows, row_normalize_f64)
from knn_tpu_torch.device import DeviceLike, resolve_device
from knn_tpu_torch.ops.coarse_knn import (
    BIN_W,
    DIM_CHUNK,
    INT_ARMS,
    PAD_VAL,
    RANK_SLACK,
    TILE_N,
    _geometry,
    _round_up,
    bf16_tolerance_scale,
    check_knobs,
    effective_tile,
    local_coarse_candidates,
    local_select_rescore,
    prepare_db,
    prepare_db_f32,
    prepare_db_pq,
    prepare_db_quant,
)
from knn_tpu_torch.ops.distance import dtype_name, prepare_train
from knn_tpu_torch.ops.metrics import canonical_metric
from knn_tpu_torch.ops.pq import (PQ_DSUB_DEFAULT, PQ_NCODES_DEFAULT,
                                  bound_consts_pq, score_error_bound_pq_t)
from knn_tpu_torch.ops.quantize import (bound_consts, db_bound_stats_t,
                                        pack_nibbles_t, quantize_rows,
                                        quantize_rows_int4,
                                        score_error_bound_device)
from knn_tpu_torch.ops.topk import (I32MAX, knn_search, knn_search_approx,
                                   knn_search_tiled, merge_topk, topk_pairs)
from knn_tpu_torch.obs import names as _mn
from knn_tpu_torch.ops.vote import majority_vote
from knn_tpu_torch.parallel.collectives import (Placed, gather, reduce_min,
                                                reduce_sum, shard)
from knn_tpu_torch.parallel.crossover import merge_bytes, resolve_merge
from knn_tpu_torch.parallel.mesh import (QUERY_AXIS, Mesh, db_axes,
                                         db_topology, grid3, make_mesh,
                                         pad_to_multiple)
from knn_tpu_torch.utils.config import CERTIFIED_PRECISIONS, SELECTORS

#: upper bound on the elements of one [queries, rows] f32 distance block
#: of the exact path; larger query sets run in row chunks (each query's
#: result does not depend on the chunking)
_EXACT_BLOCK_ELEMS = 1 << 27

#: device bytes a host-tier sweep's search keeps per score of its [rows,
#: segment rows] block at its peak (the f32 scores, their masked copy, the
#: sort's values, int64 order and own buffers; 52.3-52.5 on an H100 at 16
#: and 64 rows against 260,111 x 128, csrc/probes/hosttier_memory.py): the
#: sweep sizes its query blocks so this workspace stays within one budget
_HOSTTIER_SCORE_BYTES = 56


def _row_blocked(fn, q: torch.Tensor, n_rows: int,
                 block_elems: int = _EXACT_BLOCK_ELEMS):
    """``fn(q_rows) -> tuple of tensors`` over row blocks of ``q`` that
    keep one [rows, n_rows] distance block within ``block_elems`` (each
    query's result does not depend on its block), each output
    concatenated."""
    rows = max(1, block_elems // max(1, n_rows))
    outs = [fn(q[lo : lo + rows]) for lo in range(0, q.shape[0], rows)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def _on_device(x, device: torch.device) -> torch.Tensor:
    """``x`` (host array or tensor) as f32 on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device, torch.float32)
    return torch.from_numpy(
        np.ascontiguousarray(np.asarray(x, np.float32))).to(device)


def query_stream_program(k: int, metric: str = "l2", *,
                         train_tile: Optional[int] = None,
                         compute_dtype=None, n_valid: Optional[int] = None,
                         mesh: Optional[Mesh] = None,
                         merge: Optional[str] = None,
                         dcn_merge: Optional[str] = None):
    """The resident exact search over one query block — the JAX package's
    ``query_stream_program`` / ``_knn_program`` (sharded.py:239-272,
    348-380): ``prog(q, db) -> (d [Q, k], i [Q, k])`` device tensors, the
    placement's metric in ``compute_dtype`` (f32 accumulation) and a
    stable top-k, in query row blocks of ``_EXACT_BLOCK_ELEMS``; rows at
    index >= ``n_valid`` are padding, masked before the select.

    Without ``mesh`` ``db`` is one device's tensor.  With ``mesh`` it is
    the rows placed over the mesh's db axes (a
    :class:`~knn_tpu_torch.parallel.collectives.Placed`, one block a db
    shard on each of its devices: ``ShardedKNN.placed_db``): the queries
    split over the query axis (zero rows pad them to a multiple of the
    query shards), each db shard searches its block on its own device
    with the rows at or past ``n_valid`` masked at its global offset, and
    the shards' lists merge by ``merge`` / ``dcn_merge`` (None: the
    measured crossover; every strategy gives one result bitwise).  The
    outputs lie on the mesh's first device.  :meth:`ShardedKNN.search`
    runs this program, so a join that streams query blocks through it is
    bitwise the looped search at the same block shape."""
    if mesh is not None:
        hosts, chips = db_topology(mesh)
        merge = resolve_merge(merge, k, chips)[0]
        one = {}

        def prog(q: torch.Tensor, db):
            shard_rows = db.shape[0] // (hosts * chips)
            total = db.shape[0] if n_valid is None else int(n_valid)
            if k > shard_rows:
                raise ValueError(
                    f"k={k} exceeds db shard size {shard_rows}; use fewer "
                    f"db shards")

            def local(j, pos, qb):
                n_local = min(max(total - j * shard_rows, 0), shard_rows)
                if n_local not in one:
                    one[n_local] = query_stream_program(
                        k, metric, train_tile=train_tile,
                        compute_dtype=compute_dtype, n_valid=n_local)
                return one[n_local](qb, db.parts[pos])

            return _run_on_mesh(mesh, q, local, k, merge, dcn_merge,
                                shard_rows=shard_rows, n_valid=total)

        return prog

    def prog(q: torch.Tensor, db: torch.Tensor):
        return _row_blocked(
            lambda qb: knn_search_tiled(qb, db, k, metric,
                                        train_tile=train_tile,
                                        compute_dtype=compute_dtype,
                                        n_valid=n_valid),
            q, db.shape[0])

    return prog


def segment_search_program(k: int, metric: str = "l2", *,
                           train_tile: Optional[int] = None,
                           compute_dtype=None, device: DeviceLike = None,
                           block_elems: int = _EXACT_BLOCK_ELEMS,
                           mesh: Optional[Mesh] = None,
                           merge: Optional[str] = None,
                           dcn_merge: Optional[str] = None):
    """The exact tiled search of one padded db segment — the JAX package's
    ``_hosttier_program`` / ``segment_search_program`` (sharded.py:275-346):
    ``prog(q, seg, n_valid) -> (d [Q, k], i [Q, k])``.
    Rows at or above the runtime ``n_valid`` are padding: they are masked
    to +inf before the select, and any of them still in the top-k (fewer
    than k valid rows) come back as ``+inf`` with the int32-max sentinel
    index.  A new ``n_valid`` (a grown delta tail, another probe set)
    never changes the segment's shape.  Untiled, the segment's side of
    the distance (its norms) is made once a call for every query block;
    ``block_elems`` bounds one block's [rows, segment rows] scores (the
    host-RAM tier sizes it from its budget).

    One device (``device``, None = cuda; host arrays are placed there), or
    ``mesh`` (not both): the segment (a host array or tensor whose rows
    divide into the db shards, or a
    :class:`~knn_tpu_torch.parallel.collectives.Placed` over the mesh's db
    axes) splits over the db shards, each shard searches its block on its
    devices with the rows at or past ``n_valid`` masked at its global
    offset (:func:`_mask_shard`), the queries split over the query axis,
    and the shards' lists merge by ``merge`` / ``dcn_merge``
    (:func:`_merge_shards`); the outputs lie on the mesh's first
    device.  A one-position mesh runs the one-device body on its device
    (a :class:`~knn_tpu_torch.parallel.collectives.Placed` segment gives
    its one block)."""
    if mesh is not None and device is not None:
        raise ValueError("pass mesh= or device=, not both")
    if mesh is not None and mesh.size == 1:
        device, mesh = mesh.devices.flat[0], None
    if mesh is not None:
        hosts, chips = db_topology(mesh)
        n_shards = hosts * chips
        merge = resolve_merge(merge, k, chips)[0]
        first = mesh.devices.flat[0]
        one = {}

        def prog(q, seg, n_valid: int):
            n_valid = int(n_valid)
            if not 0 <= n_valid <= seg.shape[0]:
                raise ValueError(
                    f"n_valid={n_valid} outside [0, {seg.shape[0]}] segment "
                    f"rows")
            if seg.shape[0] % n_shards:
                raise ValueError(
                    f"{seg.shape[0]} segment rows do not divide into "
                    f"{n_shards} db shards")
            shard_rows = seg.shape[0] // n_shards
            if k > shard_rows:
                raise ValueError(
                    f"k={k} exceeds db shard size {shard_rows}; use fewer "
                    f"db shards")
            if not isinstance(seg, Placed):
                seg = shard(seg if isinstance(seg, torch.Tensor) else
                            _on_device(seg, torch.device("cpu")),
                            mesh, db_axes(mesh))

            def local(j, pos, qb):
                dev = mesh.devices[pos]
                if dev not in one:
                    one[dev] = segment_search_program(
                        k, metric, train_tile=train_tile,
                        compute_dtype=compute_dtype, device=dev,
                        block_elems=block_elems)
                n_local = min(max(n_valid - j * shard_rows, 0), shard_rows)
                return one[dev](qb, seg.parts[pos], n_local)

            return _run_on_mesh(mesh, _on_device(q, first), local, k, merge,
                                dcn_merge, shard_rows=shard_rows,
                                n_valid=n_valid)

        return prog
    dev = resolve_device(device)

    def prog(q, seg, n_valid: int):
        if isinstance(seg, Placed):
            seg = seg.block(0)
        q, seg = _on_device(q, dev), _on_device(seg, dev)
        n_valid = int(n_valid)
        if not 0 <= n_valid <= seg.shape[0]:
            raise ValueError(
                f"n_valid={n_valid} outside [0, {seg.shape[0]}] segment rows")
        if train_tile is None or train_tile >= seg.shape[0]:
            prepared = prepare_train(seg, metric)

            def block(qb):
                return knn_search(qb, seg, k, metric,
                                  compute_dtype=compute_dtype,
                                  n_valid=n_valid, prepared=prepared)
        else:
            def block(qb):
                return knn_search_tiled(qb, seg, k, metric,
                                        train_tile=train_tile,
                                        compute_dtype=compute_dtype,
                                        n_valid=n_valid)
        d, i = _row_blocked(block, q, seg.shape[0], block_elems)
        pad = i >= n_valid
        return (torch.where(pad, torch.inf, d),
                torch.where(pad, torch.full_like(i, I32MAX), i))

    return prog


def _analysis_window(k: int, m: int) -> int:
    """Width of the device rank-analysis window — one home for the
    certify output's column count and its unpack."""
    return min(k + 17, m + 1)


def _overlap_ratio(intervals) -> float:
    """Fraction of the pipeline's wall time during which >= 2 batches
    were in flight (interval = coarse-dispatch start to result-repair
    end) — a copy of the JAX package's measure (sharded.py:161-182): it
    reports dispatch-timeline concurrency, not device-internal overlap
    (which needs a device trace).  0.0 for < 2 batches."""
    if len(intervals) < 2:
        return 0.0
    events = []
    for s, e in intervals:
        events.append((s, 1))
        events.append((e, -1))
    events.sort()
    in_flight, overlapped, prev = 0, 0.0, None
    for t, delta in events:
        if prev is not None and in_flight >= 2:
            overlapped += t - prev
        in_flight += delta
        prev = t
    wall = max(e for _, e in intervals) - min(s for s, _ in intervals)
    return overlapped / wall if wall > 0 else 0.0


def _host_copies(tensors):
    """Starts the device->host copies of ``tensors`` (None entries pass)
    on the current stream into pinned host buffers and records an event
    behind them.  Returns the host tensors and the event: the host waits
    on that event alone, not on the work enqueued after it.  On the CPU:
    the tensors and None."""
    if tensors[0].device.type != "cuda":
        return tuple(tensors), None
    host = []
    for t in tensors:
        if t is None:
            host.append(None)
            continue
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        host.append(h)
    event = torch.cuda.Event()
    event.record()
    return tuple(host), event


def _fetch_async(packed):
    """:func:`_host_copies` of one batch's certify output ``(gi, tight,
    bad, dk or None)``, gi as int32."""
    return _host_copies((packed[0].to(torch.int32), *packed[1:]))


def _ring_merge(ds, is_, k: int):
    """The ring over the per-shard lists ``ds`` / ``is_`` (one a shard,
    each on its device): one accumulator starts at shard 1 and takes P-1
    hops, 1 → 2 → … → P-1 → 0, merging into each shard's list on that
    shard's device, so the global top-k lands on shard 0's device.  The
    JAX package's ring (sharded.py:71-84) runs P such accumulators at
    once, one a device, because every device reads its own; a single
    controller reads position 0's alone, so it runs that one."""
    n = len(ds)
    acc_d, acc_i = ds[1], is_[1]
    for j in list(range(2, n)) + [0]:
        dev = ds[j].device
        acc_d, acc_i = merge_topk(ds[j], is_[j],
                                  acc_d.to(dev, non_blocking=True),
                                  acc_i.to(dev, non_blocking=True), k)
    return acc_d, acc_i


def _allgather_merge(ds, is_, k: int):
    """Every list gathered onto shard 0's device ([Qs, P·k]) and one top-k
    of the union there.  The JAX package's allgather (sharded.py:87-93)
    gathers onto every device; a single controller reads position 0's
    result alone, so it gathers once."""
    dev = ds[0].device
    return topk_pairs(gather(ds, dev, axis=1), gather(is_, dev, axis=1), k)


def _merge_shards(d, gi, keep: int, merge: str, dcn_merge: Optional[str]):
    """The two-level top-k merge tree over one query shard's lists ``d[h][c]``
    / ``gi[h][c]`` (host h, device c; sharded.py:107-129): each host's
    lists merge by ``merge`` onto its first device, then the hosts' by
    ``dcn_merge`` (or ``merge``) onto position (0, 0), once each.  The
    lexicographic ``(distance, index)`` merge is associative and
    commutative, so every strategy pair and the flat merge agree bitwise.
    Returns the merged list, on position (0, 0)'s device."""
    level = {"ring": _ring_merge, "allgather": _allgather_merge}
    host_d, host_i = [], []
    for row_d, row_i in zip(d, gi):
        if len(row_d) > 1:
            row_d, row_i = level[merge](row_d, row_i, keep)
        else:
            row_d, row_i = row_d[0], row_i[0]
        host_d.append(row_d)
        host_i.append(row_i)
    if len(host_d) > 1:
        return level[dcn_merge or merge](host_d, host_i, keep)
    return host_d[0], host_i[0]


def _mask_shard(d, li, n_valid: int, offset: int):
    """A shard's local top list with global indices: local rows at or past
    ``n_valid`` are pad rows, ``+inf`` with the int32-max sentinel
    (sharded.py:222-225)."""
    pad = li >= n_valid
    return (torch.where(pad, torch.inf, d),
            torch.where(pad, torch.full_like(li, I32MAX), li + offset))


def _run_on_mesh(mesh: Mesh, q: torch.Tensor, local, keep: int, merge: str,
                 dcn_merge: Optional[str], *, shard_rows: int, n_valid: int):
    """The mesh programs' shared body (the JAX package's ``shard_map`` over
    ``(P(QUERY_AXIS), P(db_axes))``): ``q`` (on the mesh's first device)
    padded with zero rows to a multiple of the query shards and split one
    block a query shard; per query shard, every db shard j's
    ``local(j, position, q block on its device) -> (d, local indices)`` on
    its own device (its current stream: nothing waits for the host between
    shards), its rows at or past ``n_valid`` masked at its global offset
    ``j * shard_rows`` (:func:`_mask_shard`), then the merge tree
    (``keep`` wide).  Returns ``(d, gi)`` on the first device, the query
    padding cut."""
    first = mesh.devices.flat[0]
    n_qs = mesh.shape[QUERY_AXIS]
    qp, n_q = pad_to_multiple(q, n_qs)
    grid = grid3(mesh)
    hosts, chips = grid.shape[1], grid.shape[2]
    outs_d, outs_i = [], []
    for r, qb in enumerate(torch.chunk(qp, n_qs)):
        d = [[None] * chips for _ in range(hosts)]
        gi = [[None] * chips for _ in range(hosts)]
        for h in range(hosts):
            for c in range(chips):
                j = h * chips + c
                dev = grid[r, h, c]
                dl, li = local(j, _position(mesh, r, h, c),
                               qb.to(dev, non_blocking=True))
                n_local = min(max(n_valid - j * shard_rows, 0), shard_rows)
                d[h][c], gi[h][c] = _mask_shard(dl, li, n_local,
                                                j * shard_rows)
        md, mi = _merge_shards(d, gi, keep, merge, dcn_merge)
        outs_d.append(md.to(first, non_blocking=True))
        outs_i.append(mi.to(first, non_blocking=True))
    return torch.cat(outs_d)[:n_q], torch.cat(outs_i)[:n_q]


def _tensors(x):
    """Every tensor in the nested tuples / lists ``x`` (None passes)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for y in x for t in _tensors(y)]
    return []


@contextlib.contextmanager
def _current_streams(streams: dict, which: int, first: torch.device):
    """Makes stream ``which`` of each device's pair in ``streams`` its
    device's current stream, ``first``'s last, so that ``first`` is the
    current device inside (where the host copies record their events)."""
    with contextlib.ExitStack() as stack:
        for dev in sorted(streams, key=lambda d: d == first):
            stack.enter_context(torch.cuda.stream(streams[dev][which]))
        yield


def _position(mesh: Mesh, r: int, h: int, c: int) -> tuple:
    """The mesh index of grid3's position ``[r, h, c]``."""
    return (r, h, c) if len(mesh.axis_names) == 3 else (r, c)


class ShardedKNN:
    """A database placed once on a device mesh (default: one device,
    ``cuda``) with k.

    ``train`` is a host [N, D] array, a :class:`~knn_tpu_torch.convert.
    Placement` (one device), or rows placed over ``mesh`` along its db
    axes (parallel.collectives.shard; ``n_train`` the leading rows that
    are real, the rest the caller's padding); ``labels`` [N] with
    ``num_classes`` enable the predict methods.  Metrics: every name of
    ops.metrics.METRICS (cosine rows are normalized at placement, so the
    certificate runs on unit vectors; dot rows are norm-augmented, so it
    runs on the augmented rows; l1 has no certificate).  ``compute_dtype``
    (None / "float32", "bfloat16", "float16" or their torch dtypes) is the
    input dtype of the matmuls ``search``, ``predict`` and the counted
    selectors' coarse pass rank with (ops.distance._dot: f32
    accumulation); the certificates' counts and repairs stay f32.

    ``mesh`` (parallel.mesh.make_mesh / make_host_mesh; ``device=`` is
    shorthand for the one-device mesh on it) shards the queries over its
    query axis and the rows over its db axes, as the JAX package's
    ``ShardedKNN(mesh=)`` does: the rows are padded with ``PAD_VAL`` to a
    multiple of the db shards (the pad rows masked by index), each db
    shard is placed on its devices once, each shard runs the one-device
    programs on its rows (the exact search, the coarse kernel of the
    one-pass certificate, the counted selectors' passes), and the
    per-shard top-k lists merge in the lexicographic ``(distance, index)``
    order — ``merge`` over each host's shards, ``dcn_merge`` across hosts,
    "ring" (an accumulator hops shard to shard, merging on each) or
    "allgather" (every list gathered onto the first device, one top-k);
    None: the measured crossover, parallel.crossover.  Each level merges
    once a query shard, onto its first device, bitwise the same result
    either way.  The
    certificate's exclusion bounds take the minimum across db shards, the
    counts the sum.  The tiers (index.MutableIndex, ivf.IVFIndex, the
    join, streaming, serving.ServingEngine, ``search_bucketed``) run on
    such a placement through :func:`query_stream_program` /
    :func:`segment_search_program` on its mesh and its certified search;
    ``precision="pq"`` trains its codebooks once on every row and places
    each db shard's codes on it, and the pipeline (``overlap=True``) runs
    every shard's coarse kernel on its device's coarse stream.

    ``hbm_budget_bytes`` (None: no budget) runs a host array whose
    placement would exceed it a host in the host-RAM tier on any mesh
    (module docstring; ``hbm.placement_bytes`` of the prepared rows,
    padded to the db shards), with ``hosttier_depth`` sweeps in flight;
    rows already placed (a :class:`Placement`, a tensor, rows placed over
    the mesh) beyond the budget are refused, ones within it placed as
    without a budget.  The budget sizes the tier's segments: a search
    holds about ``hosttier_depth + 1`` budgets on the card (module
    docstring).  One tier search runs at a
    time; concurrent callers wait for each other."""

    def __init__(self, train, *, k: int, metric: str = "l2",
                 mesh: Optional[Mesh] = None, merge: Optional[str] = None,
                 dcn_merge: Optional[str] = None,
                 train_tile: Optional[int] = None, compute_dtype=None,
                 labels=None, num_classes: Optional[int] = None,
                 n_train: Optional[int] = None,
                 device: DeviceLike = None,
                 hbm_budget_bytes: Optional[int] = None,
                 hosttier_depth: int = 2, _shard: Optional[tuple] = None):
        #: the compute dtype's name, the JAX package's ``_dtype_key``
        #: (None: float32)
        self._dtype_key = dtype_name(compute_dtype)
        budget = hbm_budget_bytes
        if budget is not None and budget <= 0:
            raise ValueError(f"hbm_budget_bytes must be > 0, got {budget}")
        if int(hosttier_depth) < 1:
            raise ValueError(
                f"hosttier_depth must be >= 1, got {hosttier_depth}")
        if mesh is not None and device is not None:
            raise ValueError("pass mesh= or device=, not both")
        if isinstance(train, Placement) and device is not None:
            raise ValueError(
                "a Placement already carries its labels and device")
        if mesh is None:
            mesh = make_mesh(1, 1, devices=[
                train.device if isinstance(train, Placement) else device])
        hosts, chips = db_topology(mesh)
        self.mesh = mesh
        # strategies resolve explicit > the measured crossover table;
        # ``merge`` is the level over each host's shards, ``dcn_merge``
        # the cross-host level, each by its own shard count
        self.merge, self.merge_source = resolve_merge(merge, k, chips)
        self.dcn_merge, self.dcn_merge_source = (
            resolve_merge(dcn_merge, k, hosts) if hosts > 1 else (None, None))
        if _shard is None:
            obs.counter(_mn.MERGE_SELECTED, level="intra",
                        strategy=self.merge, source=self.merge_source).inc()
            if self.dcn_merge is not None:
                obs.counter(_mn.MERGE_SELECTED, level="dcn",
                            strategy=self.dcn_merge,
                            source=self.dcn_merge_source).inc()
        #: a db shard of a mesh placement: its real rows (the rest are
        #: pad rows) and its first row's global index
        self._n_valid, self._row_offset = None, 0
        #: the mesh's shard placements by (db shard, device), and the rows
        #: of one db shard (pad rows included)
        self._shards: dict = {}
        self._rows_per_shard = None
        #: the rows as the mesh holds them (placed_db), made at first use
        self._placed: Optional[Placed] = None
        #: the host rows of a mesh placement with several db shards
        self._rows = None
        self._labels_t = None
        #: the host-RAM tier's plan (None: the database is placed)
        self._host_tier: Optional[dict] = None
        #: its prepared host rows; on the card its slots (a pinned staging
        #: buffer, a device buffer a distinct device of the mesh and their
        #: last events) and a copy stream a device, made at the first search
        self._host_rows = None
        self._slots = None
        self._copy_streams = None
        self._last_hosttier: Optional[dict] = None
        #: one tier search or tiered join at a time: they share the slots
        self._tier_lock = threading.Lock()
        if isinstance(train, Placed):
            if canonical_metric(metric) not in ("l2", "l1"):
                raise ValueError(
                    f"rows placed over a mesh carry no placement-time "
                    f"normalization or augmentation; metric {metric!r} "
                    f"needs a host array")
            if budget is not None:
                self._refuse_placed_over_budget(*train.shape, budget)
            rows_all = train.gather().numpy()
            n_train = rows_all.shape[0] if n_train is None else int(n_train)
            if not 0 < n_train <= rows_all.shape[0]:
                raise ValueError(
                    f"n_train={n_train} outside (0, {rows_all.shape[0]}]")
            train = rows_all[:n_train]
        elif n_train is not None:
            raise ValueError("n_train is only for rows placed over a mesh")
        self.k = k
        self.train_tile = train_tile
        if hosts * chips > 1:
            self._init_db_sharded(train, k, metric, labels, num_classes,
                                  budget, int(hosttier_depth))
        else:
            self._init_one_shard(train, k, metric, labels, num_classes,
                                 budget, int(hosttier_depth))
        if _shard is not None:
            self._n_valid, self._row_offset = _shard
        elif self.placement is not None:
            self._n_valid = self.n_train
        #: coarse-pass db parts of each arm for tiles whose padding differs
        #: from the placement's, built on first use
        self._parts = {}
        #: the int8 / int4 placements, by precision, built on first use
        self._quant = {}
        #: the highest arm's padded f32 rows, built on first use
        self._t32 = None
        #: the pq placements, by (dsub, ncodes), trained on first use
        self._pq = {}
        #: the overlap pipeline's (coarse, tail) CUDA streams, made on first
        #: use and kept: the caching allocator reuses a freed block only on
        #: the stream it was made on, so new streams per call allocate anew
        self._streams = None
        #: (k, placed rows) -> search() calls of that shape
        self._dispatch_shapes: dict = {}
        #: search_bucketed's serving engines, by ladder
        self._serving_engines: dict = {}
        #: guards both dicts above: the queue's batcher, the compactor and
        #: the join may search at once
        self._engines_lock = threading.Lock()

    def _init_one_shard(self, train, k, metric, labels, num_classes, budget,
                        depth) -> None:
        """The placement of a mesh with one db shard, on its first device
        (the other query shards' devices get theirs at first use)."""
        device = self.mesh.devices.flat[0]
        if budget is not None and isinstance(train, (Placement,
                                                     torch.Tensor)):
            self._refuse_placed_over_budget(
                *((train.n_train, train.db.shape[1])
                  if isinstance(train, Placement) else train.shape), budget)
        if isinstance(train, Placement):
            if labels is not None:
                raise ValueError(
                    "a Placement already carries its labels and device")
            asked = canonical_metric(metric)
            if asked != train.metric:
                raise ValueError(
                    f"metric {metric!r} does not match the placement's "
                    f"{train.metric!r}")
            pl = train
        else:
            rows = host_rows(train, metric)
            if budget is not None and \
                    hbm.placement_bytes(*rows.rows.shape) > budget:
                pl = None
                self._plan_host_tier(rows, int(budget), depth, k, labels,
                                     num_classes)
            else:
                pl = place_host_rows(rows, labels, num_classes, device=device)
        if pl is not None:
            if k > pl.n_train:
                raise ValueError(f"k={k} > n_train={pl.n_train}")
            self.device = pl.device
            self.metric = pl.metric
            self.n_train = pl.n_train
            self.num_classes = pl.num_classes
            #: the caller's row width (a dot placement holds one more)
            self.dim_in = pl.dim_in
            self._rows_per_shard = pl.n_train
        self.placement = pl

    def _init_db_sharded(self, train, k, metric, labels, num_classes,
                         budget, depth) -> None:
        """The placement of a mesh with several db shards (the JAX
        package's sharded.py:596-648): the prepared host rows padded with
        ``PAD_VAL`` to a multiple of the db shards, shard j's block placed
        on every device at db position j — or, past ``budget`` a host
        (sharded.py:672-724), the host-RAM tier's plan."""
        if isinstance(train, Placement):
            raise ValueError(
                "a Placement holds one device's rows; pass the host rows to "
                "shard them over the mesh")
        if budget is not None and isinstance(train, torch.Tensor):
            self._refuse_placed_over_budget(*train.shape, budget)
        rows = host_rows(train, metric)
        n = rows.rows.shape[0]
        n_shards = self.db_shards
        padded, _ = pad_to_multiple(rows.rows, n_shards, fill=PAD_VAL)
        if budget is not None and hbm.placement_bytes(*padded.shape) > \
                budget * db_topology(self.mesh)[0]:
            self.placement = None
            self._plan_host_tier(rows, int(budget), depth, k, labels,
                                 num_classes)
            return
        per = padded.shape[0] // n_shards
        if k > per:
            raise ValueError(
                f"k={k} exceeds db shard size {per}; use fewer db shards")
        if k > n:
            raise ValueError(f"k={k} > n_train={n}")
        lab = None
        if labels is not None:
            if num_classes is None:
                raise ValueError("labels given without num_classes")
            labels = np.asarray(labels, dtype=np.int32)
            if labels.shape != (n,):
                raise ValueError(
                    f"labels shape {labels.shape} != (n_train,) = ({n},)")
            lab = labels
        self.device = self.mesh.devices.flat[0]
        self.metric = rows.metric
        self.n_train = n
        self.num_classes = num_classes
        self.dim_in = rows.dim_in
        self.placement = None
        self._rows = rows
        self._rows_per_shard = per
        if lab is not None:
            self._labels_t = torch.from_numpy(lab).to(self.device)
        grid = grid3(self.mesh)
        chips = grid.shape[2]
        for pos in np.ndindex(*grid.shape):
            j = pos[1] * chips + pos[2]
            dev = grid[pos]
            if (j, dev) in self._shards:
                continue
            block = padded[j * per:(j + 1) * per]
            self._shards[(j, dev)] = self._shard_knn(
                block, dev, k, n_valid=int(np.clip(n - j * per, 0, per)),
                offset=j * per)

    def _refuse_placed_over_budget(self, n: int, width: int,
                                   budget: int) -> None:
        """Rows already placed (a :class:`Placement` or a tensor) have no
        host copy for the tier to stream from: over the budget a host they
        are refused (sharded.py:672-689)."""
        if hbm.placement_bytes(n, width) > budget * db_topology(self.mesh)[0]:
            raise ValueError(
                f"hbm_budget_bytes={budget} cannot hold this {n}-row "
                f"placement, and the host-RAM tier needs a host-array "
                f"construction to stream from; pass the rows as a numpy "
                f"array (or raise the budget)")

    def _shard_knn(self, block: np.ndarray, dev: torch.device, k: int, *,
                   n_valid: int, offset: int) -> "ShardedKNN":
        """One db shard's one-device placement: ``block`` (pad rows
        included) on ``dev``, with the whole database's certificate terms,
        of which the first ``n_valid`` rows are real."""
        rows = self._host_rows_of()
        db = torch.from_numpy(np.ascontiguousarray(block)).to(dev)
        th, tl, tnorm = prepare_db(db, TILE_N)
        pl = Placement(db=db, db_host=block, th=th, tl=tl, tnorm=tnorm,
                       db_norm_max=rows.db_norm_max, metric=rows.metric,
                       uint8_source=rows.uint8_source,
                       dot_shift=rows.dot_shift)
        return ShardedKNN(pl, k=k, metric=pl.metric,
                          train_tile=self.train_tile,
                          compute_dtype=self._dtype_key,
                          _shard=(n_valid, offset))

    def _host_rows_of(self) -> HostRows:
        """The prepared host rows of the whole database."""
        if self._rows is not None:
            return self._rows
        if self._host_rows is not None:
            return self._host_rows
        pl = self.placement
        return HostRows(rows=pl.db_host, metric=pl.metric,
                        db_norm_max=pl.db_norm_max,
                        uint8_source=pl.uint8_source, dot_shift=pl.dot_shift)

    # -- the mesh -----------------------------------------------------------
    @property
    def db_shards(self) -> int:
        """Total db shards: hosts x devices per host."""
        hosts, chips = db_topology(self.mesh)
        return hosts * chips

    def _shard_rows(self) -> int:
        """Rows of one db shard, pad rows included (the JAX package's
        ``_shard_rows``)."""
        return self._rows_per_shard

    def _on_mesh(self) -> bool:
        """Whether calls run the mesh programs: on every mesh but the
        one-device (1, 1)."""
        return self.mesh.size > 1

    def _shard_at(self, j: int, dev: torch.device) -> "ShardedKNN":
        """Db shard ``j``'s placement on ``dev``.  With one db shard it is
        this placement (on its device) or its replica on another query
        shard's device, made at first use."""
        sub = self._shards.get((j, dev))
        if sub is None:
            self._require_resident("a query shard")
            with self._engines_lock:
                sub = self._shards.get((j, dev))
                if sub is None:
                    if dev == self.device:
                        sub = ShardedKNN(self.placement, k=self.k,
                                         metric=self.metric,
                                         train_tile=self.train_tile,
                                         compute_dtype=self._dtype_key,
                                         _shard=(self.n_train, 0))
                    else:
                        sub = self._shard_knn(self.placement.db_host, dev,
                                              self.k, n_valid=self.n_train,
                                              offset=0)
                    self._shards[(j, dev)] = sub
        return sub

    def _mesh_shards(self):
        """Every (query shard, host, device) position's ``(device,
        shard placement)``, as ``[r][h][c]`` lists."""
        grid = grid3(self.mesh)
        chips = grid.shape[2]
        return [[[(grid[r, h, c], self._shard_at(h * chips + c, grid[r, h, c]))
                  for c in range(chips)] for h in range(grid.shape[1])]
                for r in range(grid.shape[0])]

    def _mesh_queries(self, queries):
        """``(blocks, n_q, placed rows)``: the queries on the first device
        (:meth:`_to_device`), padded with zero rows to a multiple of the
        query shards and split one block a query shard (the JAX package's
        ``_place_queries``)."""
        q = self._to_device(queries)
        n_qs = self.mesh.shape[QUERY_AXIS]
        qp, n_q = pad_to_multiple(q, n_qs)
        return torch.chunk(qp, n_qs), n_q, qp.shape[0]

    def _mesh_run(self, queries, local, keep: int):
        """Per query shard, every db shard's ``local(shard, q) -> (d, li)``
        on its own device, its indices made global and its pad rows masked,
        then the merge tree (``keep`` wide) — :func:`_run_on_mesh` over
        this placement's shards.  Returns ``(d, gi)`` on the first device,
        the query padding cut."""
        def on_shard(j, pos, qb):
            return local(self._shard_at(j, self.mesh.devices[pos]), qb)

        return _run_on_mesh(self.mesh, self._to_device(queries), on_shard,
                            keep, self.merge, self.dcn_merge,
                            shard_rows=self._shard_rows(),
                            n_valid=self.n_train)

    def placed_db(self) -> Placed:
        """The f32 rows as the mesh holds them: a
        :class:`~knn_tpu_torch.parallel.collectives.Placed` over the
        mesh's db axes whose position p holds its db shard's rows (pad
        rows included) on p's device — the operand of
        :func:`query_stream_program` on this mesh (the JAX package's
        ``_tp``)."""
        if self._placed is None:
            self._require_resident("placed_db")
            parts = np.empty(self.mesh.devices.shape, dtype=object)
            grid = grid3(self.mesh)
            chips = grid.shape[2]
            for r, h, c in np.ndindex(*grid.shape):
                dev = grid[r, h, c]
                parts[_position(self.mesh, r, h, c)] = self._shard_at(
                    h * chips + c, dev).placement.db
            rows = self._shard_rows() * self.db_shards
            self._placed = Placed(self.mesh, parts, db_axes(self.mesh), 0,
                                  (rows, parts.flat[0].shape[1]))
        return self._placed

    def _stream_program(self, k: int, metric: str, compute_dtype=None):
        """:func:`query_stream_program` for this placement: on the mesh
        with its strategies and rows (operand :meth:`placed_db`), else on
        the one device (operand ``placement.db``)."""
        if not self._on_mesh():
            return query_stream_program(k, metric,
                                        train_tile=self.train_tile,
                                        compute_dtype=compute_dtype)
        return query_stream_program(
            k, metric, train_tile=self.train_tile,
            compute_dtype=compute_dtype, n_valid=self.n_train,
            mesh=self.mesh, merge=self.merge, dcn_merge=self.dcn_merge)

    def _mesh_topk(self, queries, k: int, metric: str, compute_dtype=None,
                   selector: str = "exact"):
        """The exact (or the counted ``approx`` selector's) top-k over the
        mesh: each db shard's search of its rows, pad rows masked inside
        the select, merged (sharded.py:197-236)."""
        if selector == "approx":
            def local(sub, q):
                return _row_blocked(
                    lambda qb: knn_search_approx(
                        qb, sub.placement.db, k,
                        compute_dtype=compute_dtype),
                    q, sub.n_train)
            return self._mesh_run(queries, local, k)
        return self._stream_program(k, metric, compute_dtype)(
            self._to_device(queries), self.placed_db())

    def _count(self, q: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
        """Per query, the db rows strictly below its threshold
        (ops.certified.count_below): on a mesh each db shard counts its
        real rows and the counts sum across db shards (the JAX package's
        ``_count_program``, sharded.py:2508-2540).  ``q`` lies on the first
        device; returns int32 counts there."""
        from knn_tpu_torch.ops.certified import count_below

        tile = self.train_tile or 131072
        if not self._on_mesh():
            return count_below(self.placement.db, q, thr, tile=tile)
        blocks, n_q, _ = self._mesh_queries(q)
        thr_p, _ = pad_to_multiple(thr.to(self.device, torch.float32),
                                   len(blocks), fill=-np.inf)
        outs = []
        for qb, tb, row in zip(blocks, torch.chunk(thr_p, len(blocks)),
                               self._mesh_shards()):
            parts = [count_below(sub.placement.db,
                                 qb.to(dev, non_blocking=True),
                                 tb.to(dev, non_blocking=True), tile=tile,
                                 n_valid=sub._n_valid)
                     for host in row for dev, sub in host]
            outs.append(reduce_sum(parts, self.device))
        return torch.cat(outs)[:n_q]

    def _record_merge_bytes(self, n_rows: int, k: int) -> None:
        """The modeled merge volume of each level into ``MERGE_BYTES``
        (crossover.merge_bytes, sharded.py:804-816)."""
        hosts, chips = db_topology(self.mesh)
        if chips > 1:
            obs.counter(_mn.MERGE_BYTES, level="intra",
                        strategy=self.merge).inc(
                merge_bytes(n_rows, k, chips, self.merge))
        if hosts > 1 and self.dcn_merge is not None:
            obs.counter(_mn.MERGE_BYTES, level="dcn",
                        strategy=self.dcn_merge).inc(
                merge_bytes(n_rows, k, hosts, self.dcn_merge))

    def _labels(self) -> Optional[torch.Tensor]:
        return self._labels_t if self.placement is None \
            else self.placement.labels

    # -- the host-RAM tier --------------------------------------------------
    def _plan_host_tier(self, rows, budget: int, depth: int, k: int,
                        labels, num_classes) -> None:
        """The tier's plan for prepared host ``rows`` over ``budget`` a host
        (sharded.py:693-723): the segments, each a multiple of the db
        shards, their padded width and bytes."""
        hosts, chips = db_topology(self.mesh)
        n, width = rows.rows.shape
        segments = hbm.plan_segments(n, width, budget, hosts=hosts,
                                     shard_multiple=hosts * chips)
        seg_rows = segments[0][1] - segments[0][0]
        per = seg_rows // (hosts * chips)
        if k > min(n, per):
            raise ValueError(
                f"k={k} exceeds the {seg_rows}-row host-tier segment; "
                f"raise hbm_budget_bytes" if per == seg_rows else
                f"k={k} exceeds db shard size {per} of the {seg_rows}-row "
                f"host-tier segment; use fewer db shards or raise "
                f"hbm_budget_bytes")
        if labels is not None:
            if num_classes is None:
                raise ValueError("labels given without num_classes")
            if np.asarray(labels).shape != (n,):
                raise ValueError(
                    f"labels shape {np.asarray(labels).shape} != "
                    f"(n_train,) = ({n},)")
        self.device = self.mesh.devices.flat[0]
        self.metric = rows.metric
        self.n_train = n
        self.num_classes = num_classes
        self.dim_in = rows.dim_in
        self._host_rows = rows
        self._rows_per_shard = per
        self._host_tier = {
            "segments": segments,
            "segment_rows": seg_rows,
            "budget_bytes": budget,
            "bytes_per_sweep": hbm.placement_bytes(seg_rows, width),
            "depth": depth,
            "itemsize": 4,
        }
        obs.gauge(_mn.HOSTTIER_SEGMENT_ROWS).set(float(seg_rows))

    def _require_resident(self, what: str) -> None:
        """The paths that read the whole placed database refuse the
        host-RAM tier, which only ever has one segment on the devices
        (sharded.py:766-775)."""
        if self._host_tier is not None:
            raise ValueError(
                f"{what} needs the full database resident on device, but "
                f"this placement runs the host-RAM shard tier (corpus "
                f"exceeds the {self._host_tier['budget_bytes']}-byte "
                f"per-host HBM budget); use search(), or raise the budget")

    def hosttier_stats(self) -> Optional[dict]:
        """The host-RAM tier's plan and its last search's measurements
        (``sweeps``, per-sweep walls, bytes a sweep; on the card the
        copies' seconds and GB/s); None when the database is placed."""
        if self._host_tier is None:
            return None
        out = {k: v for k, v in self._host_tier.items() if k != "segments"}
        out["sweeps"] = len(self._host_tier["segments"])
        if self._last_hosttier is not None:
            out["last_search"] = dict(self._last_hosttier)
        return out

    def _hosttier_slots(self):
        """The tier's ``depth`` slots and a copy stream a distinct device
        of the mesh, made at the first search on the card and kept.  A slot
        is a pinned staging buffer of one segment, one device buffer a
        distinct device holding the blocks of the db shards placed there
        (one block a shard, shared by its query shards: a logical mesh of
        one card holds one segment), the views the segment program reads
        (a :class:`~knn_tpu_torch.parallel.collectives.Placed` over the
        mesh's db axes, one block on the (1, 1) mesh), and per device the events of its last copy (``copied``) and of the
        last work that read it (``done``).  The device buffers may reuse
        blocks that work still queued on a device's current stream reads,
        so each copy stream waits for that work once, here."""
        if self._slots is None:
            width = self._host_rows.rows.shape[1]
            seg_rows = self._host_tier["segment_rows"]
            per = self._shard_rows()
            grid = grid3(self.mesh)
            chips = grid.shape[2]
            # the db shards each distinct device holds, in shard order
            held: dict = {}
            for r, h, c in np.ndindex(*grid.shape):
                held.setdefault(grid[r, h, c], set()).add(h * chips + c)
            self._copy_streams = {dev: torch.cuda.Stream(dev) for dev in held}
            self._slots = []
            for _ in range(self._host_tier["depth"]):
                slot = {"host": torch.empty((seg_rows, width),
                                            dtype=torch.float32,
                                            pin_memory=True),
                        "dev": {}, "copies": {}, "copied": {}, "done": {}}
                block = {}
                for dev, js in held.items():
                    buf = torch.empty((len(js) * per, width),
                                      dtype=torch.float32, device=dev)
                    slot["dev"][dev] = buf
                    slot["copies"][dev] = []
                    for b, j in enumerate(sorted(js)):
                        block[(j, dev)] = buf[b * per:(b + 1) * per]
                        slot["copies"][dev].append(
                            (block[(j, dev)], j * per, (j + 1) * per))
                parts = np.empty(self.mesh.devices.shape, dtype=object)
                for r, h, c in np.ndindex(*grid.shape):
                    parts[_position(self.mesh, r, h, c)] = block[
                        (h * chips + c, grid[r, h, c])]
                slot["seg"] = Placed(self.mesh, parts, db_axes(self.mesh),
                                     0, (seg_rows, width))
                self._slots.append(slot)
            for dev, stream in self._copy_streams.items():
                stream.wait_stream(torch.cuda.current_stream(dev))
        return self._slots, self._copy_streams

    def _hosttier_program(self, k: int):
        """The tier's segment program on this placement's mesh (the JAX
        package's ``_hosttier_program``; the (1, 1) mesh runs the one-device
        body): its query blocks keep one sweep's search workspace within
        the budget (``_HOSTTIER_SCORE_BYTES`` a score)."""
        kw = dict(train_tile=self.train_tile, compute_dtype=self._dtype_key,
                  block_elems=max(1, self._host_tier["budget_bytes"]
                                  // _HOSTTIER_SCORE_BYTES))
        return segment_search_program(k, self.metric, mesh=self.mesh,
                                      merge=self.merge,
                                      dcn_merge=self.dcn_merge, **kw)

    def _stream_segments(self, marks: Optional[list] = None):
        """Yields ``(lo, hi, seg)`` for every host-tier segment, ``seg`` its
        rows padded to the segment width with ``PAD_VAL``: on the card the
        slot's :class:`~knn_tpu_torch.parallel.collectives.Placed` blocks,
        on the CPU a host array.  The caller holds ``_tier_lock`` and enqueues the
        work that reads ``seg`` on the devices' current streams before it
        asks for the next segment.  On the card segment s goes through slot
        s % depth: its rows are written into the slot's staging buffer once
        the slot's last copies have finished, and copied up on each
        device's copy stream once the last work that read that device's
        buffer (in this call or an earlier one) has, behind an event the
        device's current stream waits for; so at most ``depth`` segments
        are in flight on every device.  ``marks`` gains each segment's CUDA
        events (``start``, ``copied``, ``done``) by device on the card, its
        host seconds on the CPU."""
        ht = self._host_tier
        rows = self._host_rows.rows
        seg_rows, depth = ht["segment_rows"], ht["depth"]
        marks = [] if marks is None else marks
        if self.device.type != "cuda":
            for lo, hi in ht["segments"]:
                t0 = time.perf_counter()
                seg = np.full((seg_rows, rows.shape[1]), PAD_VAL, np.float32)
                seg[: hi - lo] = rows[lo:hi]
                yield lo, hi, seg
                marks.append(time.perf_counter() - t0)
            return
        slots, copy_streams = self._hosttier_slots()
        compute = {dev: torch.cuda.current_stream(dev) for dev in copy_streams}
        for s, (lo, hi) in enumerate(ht["segments"]):
            slot = slots[s % depth]
            for copied in slot["copied"].values():
                copied.synchronize()
            host = slot["host"].numpy()
            host[: hi - lo] = rows[lo:hi]
            host[hi - lo:] = PAD_VAL
            ev = {dev: {name: torch.cuda.Event(enable_timing=True)
                        for name in ("start", "copied", "done")}
                  for dev in copy_streams}
            for dev, stream in copy_streams.items():
                with torch.cuda.stream(stream):
                    if dev in slot["done"]:
                        stream.wait_event(slot["done"][dev])
                    ev[dev]["start"].record(stream)
                    for dst, a, b in slot["copies"][dev]:
                        dst.copy_(slot["host"][a:b], non_blocking=True)
                    ev[dev]["copied"].record(stream)
                slot["copied"][dev] = ev[dev]["copied"]
                compute[dev].wait_event(ev[dev]["copied"])
            try:
                yield lo, hi, slot["seg"]
            finally:  # also when the caller stops early
                for dev, stream in compute.items():
                    ev[dev]["done"].record(stream)
                    slot["done"][dev] = ev[dev]["done"]
            marks.append(ev)

    def _search_host_tier(self, queries, k: int, return_sqrt: bool):
        """One search over every host-tier segment (sharded.py:882-975):
        device ``(d, i)`` [Q, k], bitwise the placed search wherever the
        segment's per-pair distances are (always on the CPU with integer
        rows; on the card the GEMM may pick another kernel for the
        segment's shape)."""
        ht = self._host_tier
        prog = self._hosttier_program(k)
        q = self._to_device(queries)
        n_qs = self.mesh.shape[QUERY_AXIS]
        placed = -(-q.shape[0] // n_qs) * n_qs
        with self._engines_lock:
            key = (k, placed)
            self._dispatch_shapes[key] = self._dispatch_shapes.get(key, 0) + 1
        best = None
        marks: list = []
        with self._tier_lock:
            t_wall0 = time.perf_counter()
            for lo, hi, seg in self._stream_segments(marks):
                # on a mesh the carry merges on its first device, where
                # the segment program's merged lists land
                d, i = prog(q, seg, hi - lo)
                self._record_merge_bytes(placed, k)
                # segment-local indices made global; the pad rows'
                # sentinel stays put
                gi = torch.where(i == I32MAX, i, i + lo)
                best = (d, gi) if best is None else \
                    merge_topk(*best, d, gi, k)
            last = {"sweeps": len(marks), "k": k,
                    "queries": int(q.shape[0])}
            if self.device.type == "cuda":
                for ev in marks[-1].values():
                    ev["done"].synchronize()
                # a sweep's wall on the first device; its copies' seconds
                # the slowest device's
                walls = [ev[self.device]["start"].elapsed_time(
                    ev[self.device]["done"]) / 1e3 for ev in marks]
                h2d = [max(e["start"].elapsed_time(e["copied"]) / 1e3
                           for e in ev.values()) for ev in marks]
                last["h2d_s"] = h2d
                last["h2d_gbps"] = (ht["bytes_per_sweep"] * len(h2d)
                                    / sum(h2d) / 1e9 if sum(h2d) > 0
                                    else None)
                last["device_buffer_bytes"] = sum(
                    buf.nbytes for slot in self._slots
                    for buf in slot["dev"].values())
            else:
                walls = marks
            last["wall_s"] = time.perf_counter() - t_wall0
            last["sweep_walls_s"] = walls
            self._last_hosttier = last
        for w in walls:
            obs.counter(_mn.HOSTTIER_SWEEPS).inc()
            obs.histogram(_mn.HOSTTIER_SWEEP_SECONDS).observe(w)
        d, i = best
        if return_sqrt:
            from knn_tpu_torch.ops.distance import metric_values

            d = metric_values(d, self.metric)
        return d, i

    # -- exact path --------------------------------------------------------
    def _to_device(self, queries) -> torch.Tensor:
        """Queries on the device.  A host array goes up from pinned memory
        on the current stream without waiting for the work queued there
        (a pageable copy would synchronize the stream).  A dot placement's
        queries of the caller's width gain the zero column of the
        augmentation (q'.t' = q.t, sharded.py:828-842); augmented ones
        pass as they are."""
        if isinstance(queries, torch.Tensor):
            q = queries.to(self.device, torch.float32)
        else:
            q = torch.from_numpy(
                np.ascontiguousarray(np.asarray(queries, np.float32)))
            if self.device.type == "cuda":
                q = q.pin_memory().to(self.device, non_blocking=True)
        if self.metric == "dot" and q.ndim == 2 and \
                q.shape[1] == self.dim_in:
            q = torch.nn.functional.pad(q, (0, 1))
        return q

    def _place_queries(self, queries) -> Tuple[torch.Tensor, int]:
        """``(queries on the device, their count)`` — the JAX package's
        ``_place_queries`` (sharded.py:830-843) on one device, the dot
        placement's zero column included (:meth:`_to_device`); the index
        tiers and the join place their query blocks through it."""
        q = self._to_device(queries)
        return q, q.shape[0]

    def _host_train(self) -> np.ndarray:
        """The placement's unpadded rows on the host, for float64
        refinement (the JAX package's ``_host_train``, sharded.py:1178)."""
        return self._host_rows_of().rows

    def _exact_topk(self, q: torch.Tensor, k: int, metric: str,
                    compute_dtype=None):
        if self._on_mesh():
            return self._mesh_topk(q, k, metric, compute_dtype)
        return self._stream_program(k, metric, compute_dtype)(
            q, self.placement.db)

    def search(self, queries, *, k: Optional[int] = None,
               return_sqrt: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """(distances, indices) [Q, k] of the k nearest rows, as tensors on
        the device.  L2 distances are SQUARED unless ``return_sqrt``."""
        k = self.k if k is None else k
        if k > self.n_train:
            raise ValueError(f"k={k} exceeds n_train={self.n_train}")
        if self._host_tier is not None:
            seg, per = self._host_tier["segment_rows"], self._shard_rows()
            if k > per:
                raise ValueError(
                    f"k={k} exceeds the {seg}-row host-tier segment"
                    if per == seg else
                    f"k={k} exceeds db shard size {per} of the {seg}-row "
                    f"host-tier segment; use fewer db shards")
            return self._search_host_tier(queries, k, return_sqrt)
        if k > self._shard_rows():
            raise ValueError(
                f"k={k} exceeds shard rows {self._shard_rows()}")
        q = self._to_device(queries)
        n_qs = self.mesh.shape[QUERY_AXIS]
        placed = -(-q.shape[0] // n_qs) * n_qs
        shape_key = (k, placed)
        with self._engines_lock:
            self._dispatch_shapes[shape_key] = (
                self._dispatch_shapes.get(shape_key, 0) + 1)
        self._record_merge_bytes(placed, k)
        d, i = self._exact_topk(q, k, self.metric, self._dtype_key)
        if return_sqrt:
            from knn_tpu_torch.ops.distance import metric_values

            d = metric_values(d, self.metric)
        return d, i

    def search_bucketed(self, queries, *, buckets=None, min_bucket: int = 32,
                        max_bucket: int = 4096, return_sqrt: bool = False):
        """Bucketed exact search (numpy results, bitwise a :meth:`search`
        of the same padded batch): the batch pads up a geometric ladder of
        bucket sizes, so any traffic pattern of batch shapes meets at most
        ``len(buckets)`` executables (on the card, CUDA graphs) — the JAX
        package's ``search_bucketed`` (sharded.py:985-1024).  The engine
        behind it is built once per ladder and kept; see
        :meth:`compile_cache_stats` and knn_tpu_torch.serving.  On a mesh
        the engine runs the mesh's search program; the host-RAM tier is
        refused."""
        from knn_tpu_torch.serving.buckets import normalize_ladder
        from knn_tpu_torch.serving.engine import ServingEngine

        self._require_resident("search_bucketed")
        ladder = None if buckets is None else normalize_ladder(buckets)
        # an explicit ladder determines the engine: min/max do not key
        # duplicate engines with identical executables
        key = ladder if ladder is not None else (None, min_bucket, max_bucket)
        with self._engines_lock:
            engine = self._serving_engines.get(key)
            if engine is None:
                engine = ServingEngine(self, buckets=ladder,
                                       min_bucket=min_bucket,
                                       max_bucket=max_bucket)
                self._serving_engines[key] = engine
        return engine.search(queries, return_sqrt=return_sqrt)

    def compile_cache_stats(self) -> dict:
        """Executable-cache reporting for serving — the JAX package's
        ``compile_cache_stats`` (sharded.py:1026-1052).  ``program_cache``
        counts the serving engines' executables (the port has no cached
        program family of its own: ``size`` the executables, ``misses``
        their builds, ``hits`` the lookups that found one built);
        ``distinct_shapes`` / ``dispatches`` / ``shape_counts`` are this
        placement's :meth:`search` calls by ``(k, placed rows)``."""
        with self._engines_lock:
            engines = list(self._serving_engines.values())
            shapes = dict(self._dispatch_shapes)
        stats = [e.stats() for e in engines]
        out = {
            "program_cache": {
                "hits": int(sum(e.cache_hits for e in engines)),
                "misses": int(sum(s["compile_count"] for s in stats)),
                "size": int(sum(s["executables"] for s in stats)),
            },
            "distinct_shapes": len(shapes),
            "dispatches": int(sum(shapes.values())),
            "shape_counts": {
                f"k{k}xq{q}": int(c) for (k, q), c in sorted(shapes.items())
            },
        }
        if stats:
            out["serving_engines"] = stats
        return out

    def predict(self, queries) -> torch.Tensor:
        """Predicted labels [Q] int32 — needs ``labels`` at construction."""
        self._require_resident("predict")
        if self._on_mesh():
            if self._labels() is None:
                raise RuntimeError(
                    "ShardedKNN built without labels; predict unavailable")
            _, gi = self._exact_topk(self._to_device(queries), self.k,
                                     self.metric, self._dtype_key)
        else:
            if self.placement.labels is None:
                raise RuntimeError(
                    "ShardedKNN built without labels; predict unavailable")
            _, gi = self.search(queries)
        safe = torch.clamp(gi, max=self.n_train - 1)
        return majority_vote(self._labels()[safe], self.num_classes)

    def radius_search(self, queries, radius: float, *, max_neighbors: int):
        """All db rows within ``radius`` per query, bounded at
        ``max_neighbors`` — the JAX package's ``radius_search``
        (sharded.py:1053-1175).  Returns host arrays ``(dists [Q, M], idx
        [Q, M], counts [Q])``: the nearest-M select masked to the radius
        (beyond-radius slots ``+inf`` / ``-1``) and the within-radius
        count, so truncation (``counts > M``, ``M = min(max_neighbors,
        n_train)``) is visible.  l2 (Euclidean radius, squared values) and
        cosine (cosine-distance radius; the count runs on unit vectors
        against ``2 * radius``) count with ops.certified.count_below at the
        threshold lifted by one f32 ulp to ``<=``; the mask and the count
        are two computations, so a row within an ulp of the radius may
        fall on different sides of each.  l1 runs ops.radius.radius_search
        on the placement (mask and count from one pairwise pass).  dot has
        no radius; a placement with a compute dtype other than f32 is
        refused (its bf16 mask would disagree with the f32 count)."""
        from knn_tpu_torch.ops.radius import SENTINEL_IDX, radius_threshold

        self._require_resident("radius_search")
        if self._dtype_key not in (None, "float32"):
            raise ValueError(
                f"radius_search needs a float32 placement; this program "
                f"was built with compute_dtype={self._dtype_key!r} and "
                f"its mask/count arithmetics would disagree at the "
                f"radius boundary")
        if self.metric == "l1":
            from knn_tpu_torch.ops.radius import radius_search as _single

            if int(max_neighbors) < 1:
                raise ValueError(
                    f"max_neighbors must be >= 1, got {max_neighbors}")
            # no sharded l1 count: mask and count from one pairwise pass
            # over the whole database (sharded.py:1093-1115)
            db = (self.placement.db if self.placement is not None else
                  torch.from_numpy(self._host_train()).to(self.device))
            out = _single(self._to_device(queries), db, radius,
                          max_neighbors=min(int(max_neighbors), self.n_train),
                          metric="l1", train_tile=self.train_tile)
            return tuple(t.cpu().numpy() for t in out)
        thr = radius_threshold(radius, self.metric)  # ranking space
        if self.metric == "cosine":
            count_thr = 2.0 * thr  # unit rows: ||q^-t^||^2 = 2 (1 - sim)
            q_count = row_normalize_f64(np.asarray(queries, np.float32))
        elif self.metric == "l2":
            count_thr, q_count = thr, queries
        else:
            raise ValueError(
                f"radius_search supports l2/cosine/l1, not {self.metric!r}")
        m = min(int(max_neighbors), self.n_train)
        if m < 1:
            raise ValueError(f"max_neighbors must be >= 1, got {max_neighbors}")
        if m > self._shard_rows():
            # never narrow silently: counts > M must mean truncation
            raise ValueError(
                f"max_neighbors={m} exceeds db shard size "
                f"{self._shard_rows()}; use fewer db shards")
        d, i = self.search(queries, k=m)
        d, i = d.cpu().numpy(), i.cpu().numpy()
        # strictly below the next f32 above the threshold: <= in f32
        qc = self._to_device(q_count)
        thr_vec = torch.full(
            (qc.shape[0],),
            float(np.nextafter(np.float32(count_thr), np.float32(np.inf))),
            dtype=torch.float32)
        counts = self._count(qc, thr_vec).cpu().numpy()
        within = d <= thr
        return (np.where(within, d, np.inf), np.where(within, i, SENTINEL_IDX),
                counts)

    # -- certified path ----------------------------------------------------
    def _coarse_parts(self, tile: int, precision: str = "bf16x3",
                      pq: Optional[dict] = None):
        """The db operands of arm ``precision`` padded for ``tile``: the
        placement's own — the f32 placement's bf16 parts ``(th, tl,
        tnorm)`` (``(th, tnorm)`` for default), the padded f32 rows ``(t,
        tnorm)`` for highest, the quantized placement's ``(t, aux)``, or
        the pq placement ``pq``'s ``(codes, tnorm)`` — when their padding
        matches, else padded anew once and kept."""
        rows = _round_up(self.n_train, tile)
        pl = self.placement
        if precision == "pq":
            if rows == pq["parts"][0].shape[0]:
                return pq["parts"]
            key = ("pq", pq["dsub"], pq["ncodes"], rows)
            if key not in self._parts:
                self._parts[key] = prepare_db_pq(pq["codes"], tile)
            return self._parts[key]
        if rows == pl.th.shape[0]:  # every placement is padded alike
            if precision in INT_ARMS:
                parts = self._quant_placement(precision)["parts"]
            elif precision == "highest":
                parts = self._f32_parts()
            else:
                parts = (pl.th, pl.tl, pl.tnorm)
        else:
            # the bf16 arms share one set of parts
            key = (precision if precision in (*INT_ARMS, "highest")
                   else "bf16", rows)
            if key not in self._parts:
                if precision in INT_ARMS:
                    n = self._n_valid
                    t, aux = self._quant_placement(precision)["parts"]
                    self._parts[key] = prepare_db_quant(t[:n], aux[1, :n],
                                                        aux[0, :n], tile)
                elif precision == "highest":
                    self._parts[key] = prepare_db_f32(pl.db, tile)
                else:
                    self._parts[key] = prepare_db(pl.db, tile)
            parts = self._parts[key]
        return (parts[0], parts[-1]) if precision == "default" else parts

    def _f32_parts(self):
        """The highest arm's operands ``(t, tnorm)``: the f32 rows padded as
        the bf16 parts are (coarse_knn.prepare_db_f32), built on the
        placement's device at first use and kept (~512 MB at 1M x 128),
        with the placement's norm rows."""
        if self._t32 is None:
            self._t32 = prepare_db_f32(self.placement.db,
                                       self.placement.th.shape[0])[0]
        return self._t32, self.placement.tnorm

    def _quant_placement(self, precision: str) -> dict:
        """The int8 or int4 db placement, built on first use and kept —
        the JAX package's ``_int8_placement`` / ``_int4_placement``
        (sharded.py:1203-1299) — from the f32 placement's rows, on their
        device: int8 per row symmetric (uint8 sources byte-exact at unit
        scale, offset 128), int4 per row to [-7, 7] with dims zero-padded
        to a DIM_CHUNK multiple and packed two per byte.  Values and
        scales are bitwise the reference's numpy functions'
        (ops.quantize.quantize_rows with ``eager``); the db-side bound
        statistics and the shifted-space row norms are float64 over the
        actual residuals (ops.quantize.db_bound_stats_t).  Returns
        ``parts``, the kernel operands ``(t, aux)`` padded as the f32
        placement's bf16 parts are (coarse_knn.prepare_db_quant), and
        ``consts`` (ops.quantize.bound_consts) on the device, ``offset``
        and ``stats``.  The f32 placement stays for the rescore and the
        fallback repair."""
        if precision not in self._quant:
            pl = self.placement
            # a db shard's pad rows take prepare_db_quant's pad fill
            real = pl.db[: self._n_valid]
            byte_exact = precision == "int8" and pl.uint8_source
            offset = 128.0 if byte_exact else 0.0
            shifted = real - offset
            if byte_exact:  # ops.quantize.from_uint8 on the device
                values = shifted.to(torch.int8)
                scales = torch.ones(real.shape[0], device=self.device)
            elif not real.shape[0]:  # a shard of pad rows only
                values = torch.zeros(real.shape, dtype=torch.int8,
                                     device=self.device)
                scales = torch.zeros(0, device=self.device)
            elif precision == "int8":
                values, scales = quantize_rows(shifted, eager=True)
            else:
                values, scales = quantize_rows_int4(shifted, eager=True)
            del shifted
            stats, norms = db_bound_stats_t(values, scales, real, offset)
            if precision == "int4":
                dpad = _round_up(values.shape[1], DIM_CHUNK) - values.shape[1]
                values = pack_nibbles_t(
                    torch.nn.functional.pad(values, (0, dpad)), DIM_CHUNK)
            self._quant[precision] = {
                "parts": prepare_db_quant(values, scales, norms,
                                          pl.th.shape[0]),
                "consts": torch.from_numpy(bound_consts(stats)).to(self.device),
                "offset": offset,
                "stats": stats,
            }
        return self._quant[precision]

    def _pq_placement(self, dsub: Optional[int] = None,
                      ncodes: Optional[int] = None) -> dict:
        """The product-quantized db placement of the pq arm, trained on
        first use and kept per ``(dsub, ncodes)`` — the JAX package's
        ``_pq_placement`` (sharded.py:1301-1355): per-subspace codebooks
        trained on every host row with the seeded k-means
        (ops.pq.train_pq, its assign steps on this placement's device or
        mesh) and the rows encoded as uint8 codes [N, m], placed by
        :meth:`_place_pq`.  Defaults (4, 256); the JAX package reads them
        from environment switches (ROADMAP queue C).  On one device
        returns ``parts``, the kernel operands ``(codes, tnorm)`` padded as
        the f32 placement's bf16 parts are (zero codes, PAD_VAL norm rows;
        coarse_knn.prepare_db_pq), ``codes`` (the unpadded rows of it),
        ``books`` (f32 [m, C, dsub]) and ``consts``
        (ops.pq.bound_consts_pq) on the device; every placement returns
        ``stats``, ``dsub``, ``ncodes`` and ``train_s`` (the training's
        seconds)."""
        from knn_tpu_torch.ops.pq import train_pq

        dsub = int(dsub or PQ_DSUB_DEFAULT)
        ncodes = int(ncodes or PQ_NCODES_DEFAULT)
        key = (dsub, ncodes)
        if key not in self._pq:
            t0 = time.perf_counter()
            res = train_pq(self._host_train(), dsub=dsub, ncodes=ncodes,
                           mesh=self.mesh)
            entry = self._place_pq(res.codebooks, res.codes, res.stats,
                                   dsub=dsub, ncodes=ncodes)
            entry["train_s"] = time.perf_counter() - t0
        return self._pq[key]

    def _place_pq(self, codebooks: np.ndarray, codes: np.ndarray,
                  stats: dict, *, dsub: int,
                  ncodes: Optional[int] = None) -> dict:
        """Places trained pq state — codebooks f32 [m, C, dsub], the rows'
        codes uint8 [N, m] and their ``ops.pq.pq_bound_stats`` — as the pq
        placement of geometry ``(dsub, ncodes)`` (``ncodes`` None: the
        codebooks' C; training keeps the requested C even where fewer rows
        capped the codebooks, as the JAX package keys its cache), and
        returns it (knn_tpu_torch.convert.pq_from_numpy carries a JAX
        ``PQResult`` across with it).  On a mesh (the JAX package's
        sharded.py:1335-1353) each db shard's placement takes its block of
        the codes as its operand (zero codes on its pad rows) and the
        codebooks and bound constants of the whole database; the entry
        returned here keeps ``stats``, ``dsub``, ``ncodes``, ``train_s``
        and ``books`` (host f32)."""
        codebooks = np.asarray(codebooks, np.float32)
        codes = np.ascontiguousarray(np.asarray(codes, np.uint8))
        if codes.shape != (self.n_train, codebooks.shape[0]):
            raise ValueError(
                f"codes {codes.shape} do not match {self.n_train} rows of "
                f"{codebooks.shape[0]} subspaces")
        ncodes = int(ncodes or codebooks.shape[1])
        if self._on_mesh():
            per = self._shard_rows()
            padded = np.zeros((per * self.db_shards, codes.shape[1]),
                              np.uint8)
            padded[: self.n_train] = codes
            for sub in self._distinct_shards():
                lo = sub._row_offset
                sub._place_pq(codebooks, padded[lo:lo + per], stats,
                              dsub=dsub, ncodes=ncodes)
            entry = {"stats": stats, "dsub": int(dsub), "ncodes": ncodes,
                     "books": codebooks, "train_s": None}
            self._pq[(int(dsub), ncodes)] = entry
            return entry
        codes_t = torch.from_numpy(codes).to(self.device)
        parts = prepare_db_pq(codes_t, self.placement.th.shape[0])
        entry = {"parts": parts, "codes": parts[0][: self.n_train],
                 "books": torch.from_numpy(codebooks).to(self.device),
                 "consts": torch.from_numpy(
                     bound_consts_pq(stats)).to(self.device),
                 "stats": stats, "dsub": int(dsub), "ncodes": ncodes,
                 "train_s": None}
        self._pq[(int(dsub), ncodes)] = entry
        return entry

    def _pallas_setup(self, margin: int, tile_n: Optional[int],
                      precision: str, bin_w: Optional[int] = None,
                      survivors: Optional[int] = None,
                      final_select: str = "exact",
                      include_distances: bool = True,
                      binning: str = "grouped",
                      grid_order: str = "query_major",
                      kernel: str = "tiled",
                      pq_dsub: Optional[int] = None,
                      pq_ncodes: Optional[int] = None,
                      final_recall_target: Optional[float] = None,
                      split: bool = False):
        """((coarse, tail), m, analysis_window) for the one-pass certified
        path — the one home of the kernel-geometry margin cap.  The pair
        is the JAX package's program split at the candidate boundary
        (sharded.py:1840-1862): ``coarse(q)`` takes a [B, D] device batch
        and returns the coarse kernel's ``(cd, ci, bounds)``; ``tail(q,
        cd, ci, bounds)`` the select/rescore/certify, returning
        :func:`_certify_pack`'s tensors.  The sequential path and the
        pipeline run the same pair, so their outputs are bitwise equal.
        ``split`` returns ``(coarse, rescore, pack)`` in place of the pair:
        a mesh merges the shards' ranked candidates between the two
        halves of the tail, and ``pack(q, d32, gi, lb, n_train=,
        db_shards=)`` certifies the merged lists."""
        if precision not in CERTIFIED_PRECISIONS:
            # default has no certified tolerance model: refuse rather than
            # certify with one (sharded.py:1799-1806)
            raise ValueError(
                f"precision {precision!r} has no certified tolerance "
                f"model; use one of {CERTIFIED_PRECISIONS}")
        check_knobs(precision=precision, binning=binning,
                    grid_order=grid_order, kernel=kernel,
                    final_select=final_select, bin_w=bin_w,
                    survivors=survivors)
        rows = self.n_train
        eff_bin = bin_w or BIN_W
        eff_tile = effective_tile(rows, tile_n or TILE_N, eff_bin, survivors,
                                  binning, min(self.k + margin, rows) + 2)
        _, _, out_w, _ = _geometry(eff_tile, eff_bin, survivors, binning)
        # m is bounded by the db and by the kernel's candidate width minus
        # the two slots the exclusion value needs
        m = min(self.k + margin, rows, -(-rows // eff_tile) * out_w - 2)
        if m <= self.k:
            raise ValueError(
                f"pallas selector: margin headroom m={m} <= k={self.k} on "
                f"{rows} rows; lower tile_n")
        w = _analysis_window(self.k, m)
        db = self.placement.db
        db_norm_max = float(np.float32(self.placement.db_norm_max))
        # the int arms: the quantized placement's translation shift and
        # bound constants (sharded.py:1807-1812); pq: its codes and
        # codebooks, bound constants and subspace width
        consts, offset, db_pq, dsub = None, 0.0, None, None
        pq = None
        if precision in INT_ARMS:
            qp = self._quant_placement(precision)
            consts, offset = qp["consts"], qp["offset"]
        elif precision == "pq":
            pq = self._pq_placement(pq_dsub, pq_ncodes)
            consts, dsub = pq["consts"], pq["dsub"]
            db_pq = (pq["codes"], pq["books"])
        parts = self._coarse_parts(eff_tile, precision, pq)

        def coarse(q: torch.Tensor):
            # the RESOLVED tile goes to the kernel: m was capped so that
            # width(eff_tile) >= m+2, which makes the kernel's own
            # effective_tile(min_width=m+2) a fixpoint
            return local_coarse_candidates(
                q, db, m, tile_n=eff_tile, precision=precision,
                binning=binning, bin_w=bin_w, survivors=survivors,
                grid_order=grid_order, kernel=kernel,
                final_select=final_select, db_parts=parts, offset=offset,
                db_pq=db_pq)

        def rescore(q: torch.Tensor, cd, ci, bounds):
            return local_select_rescore(
                q, db, cd, ci, bounds, m, final_select=final_select,
                final_recall_target=final_recall_target)

        def pack(q: torch.Tensor, d32, li, lb, *, n_train: int = rows,
                 db_shards: int = 1):
            return _certify_pack(q, d32, li, lb, db_norm_max=db_norm_max,
                                 m=m, k=self.k, w=w, n_train=n_train,
                                 include_distances=include_distances,
                                 precision=precision, consts=consts,
                                 offset=offset, pq_dsub=dsub,
                                 db_shards=db_shards)

        if split:
            return (coarse, rescore, pack), m, w

        def tail(q: torch.Tensor, cd, ci, bounds):
            return pack(q, *rescore(q, cd, ci, bounds))

        return (coarse, tail), m, w

    def _certify_pallas(self, batches, bs, m, d, i, q_np, db_np, *,
                        tile_n, precision, want_distances=True, bin_w=None,
                        survivors=None, final_select="exact",
                        binning="grouped", final_recall_target=None,
                        grid_order="query_major", kernel="tiled",
                        overlap=False, overlap_depth=2, pq_dsub=None,
                        pq_ncodes=None):
        """One-pass certificate, host side: per batch, fetch the windowed
        indices, the near-tie mask and the bad flags (plus the top-k
        distances when ``want_distances``) and repair tie runs in float64.
        Sequential: every batch is enqueued first, and the host repairs
        batch b as soon as its own event fires, while later batches run.
        ``overlap``: the two-stage pipeline (coarse stream, tail stream,
        at most ``overlap_depth`` batches in flight, the oldest drained
        first).  Returns (flagged query indices, rank-corrected query
        count, pipeline stats or None)."""
        from knn_tpu_torch.ops.refine import rank_correct_runs

        k = self.k
        setup = dict(bin_w=bin_w, survivors=survivors,
                     final_select=final_select,
                     include_distances=want_distances, binning=binning,
                     grid_order=grid_order, kernel=kernel, pq_dsub=pq_dsub,
                     pq_ncodes=pq_ncodes,
                     final_recall_target=final_recall_target)
        if self._on_mesh():
            (coarse, tail), m, w = self._mesh_pallas(m - k, tile_n,
                                                     precision, setup)
            src = self._mesh_shards()[0][0][0][1]
        else:
            (coarse, one_tail), m, w = self._pallas_setup(
                m - k, tile_n, precision, **setup)

            def tail(q, cand):
                return one_tail(q, *cand)

            src = self
        if precision in ("int8", "int4", "pq") and obs.enabled():
            # the certificate's per-query quantization bound, recomputed on
            # the host (O(Q D)) from the placement's host stats: the device
            # copy stays on the device
            if precision == "pq":
                from knn_tpu_torch.ops.pq import score_error_bound_pq

                eps = score_error_bound_pq(
                    q_np, src._pq_placement(pq_dsub, pq_ncodes)["stats"])
            else:
                from knn_tpu_torch.ops.quantize import score_error_bound

                pl = src._quant_placement(precision)
                eps = score_error_bound(q_np, pl["stats"],
                                        offset=pl["offset"])
            obs.histogram(_mn.CERTIFIED_QUANT_BOUND).observe_many(eps)
        bad_mask = np.zeros(q_np.shape[0], dtype=bool)
        n_corrected = 0

        def repair(lo, pad, fetched):
            """Waits for this batch's own copies, then the float64 tie-run
            repair — shared by the sequential and pipelined paths."""
            nonlocal n_corrected
            host, event = fetched
            if event is not None:
                event.synchronize()
            take = bs - pad
            gi_np, tight_np, bad_np, dk_np = unpack_certified(
                host, k, w, want_distances)
            dc, ic, n_c = rank_correct_runs(
                gi_np[:take], tight_np[:take], k, q_np[lo : lo + take], db_np,
                d32k=None if dk_np is None else dk_np[:take].astype(np.float64))
            n_corrected += n_c
            if dc is not None:
                d[lo : lo + take] = dc
            i[lo : lo + take] = ic
            bad_mask[lo : lo + take] = bad_np[:take]

        if not overlap:
            # enqueue every batch (asynchronous on the GPU), then repair
            # each as its own copies land
            fetched = []
            for _, chunk, _ in batches:
                q = self._to_device(chunk)
                fetched.append(_fetch_async(tail(q, coarse(q))))
            for (lo, _, pad), f in zip(batches, fetched):
                repair(lo, pad, f)
            return np.flatnonzero(bad_mask), n_corrected, None

        depth = max(1, int(overlap_depth))
        cuda = self.device.type == "cuda"
        if cuda:
            # a (coarse, tail) stream pair a distinct device of the mesh
            # (one pair on a logical mesh of one card)
            if self._streams is None:
                self._streams = {dev: (torch.cuda.Stream(dev),
                                       torch.cuda.Stream(dev))
                                 for dev in self.mesh.distinct_devices}
            for dev, pair in self._streams.items():
                # the placement and anything queued before this call
                for stream in pair:
                    stream.wait_stream(torch.cuda.current_stream(dev))
        intervals = []
        pending = deque()
        t_wall0 = time.perf_counter()

        def finalize(rec):
            lo, pad, fetched, t0 = rec
            repair(lo, pad, fetched)
            intervals.append((t0, time.perf_counter()))

        for lo, chunk, pad in batches:
            # the bounded in-flight window: drain the oldest batch (its
            # tail ran while later coarse passes streamed the db) before
            # admitting a new one
            while len(pending) >= depth:
                finalize(pending.popleft())
            t0 = time.perf_counter()
            if not cuda:
                q = self._to_device(chunk)
                fetched = _fetch_async(tail(q, coarse(q)))
            else:
                with _current_streams(self._streams, 0, self.device):
                    q = self._to_device(chunk)
                    cand = coarse(q)
                    coarse_done = []
                    for dev, (cs, _) in self._streams.items():
                        coarse_done.append(torch.cuda.Event())
                        coarse_done[-1].record(cs)
                with _current_streams(self._streams, 1, self.device):
                    for _, ts in self._streams.values():
                        for ev in coarse_done:
                            ts.wait_event(ev)
                    # made on a coarse stream, read on its device's tail
                    # stream: the allocator must not hand them out again
                    # before the tail is done with them
                    for t in _tensors((q, cand)):
                        t.record_stream(self._streams[t.device][1])
                    fetched = _fetch_async(tail(q, cand))
            pending.append((lo, pad, fetched, t0))
        while pending:
            finalize(pending.popleft())
        if cuda:
            # work queued after this call (the fallback repair's widened
            # select) starts after every batch of both streams
            for dev, pair in self._streams.items():
                for stream in pair:
                    torch.cuda.current_stream(dev).wait_stream(stream)
        wall = time.perf_counter() - t_wall0
        ratio = _overlap_ratio(intervals)
        pipeline = {"depth": depth, "batches": len(batches),
                    "overlap_ratio": round(ratio, 4),
                    "wall_s": round(wall, 4)}
        obs.gauge(_mn.PIPELINE_OVERLAP_RATIO).set(ratio)
        obs.record_span("certified.pipeline", None, wall,
                        batches=len(batches), depth=depth,
                        overlap_ratio=round(ratio, 4))
        return np.flatnonzero(bad_mask), n_corrected, pipeline

    def _distinct_shards(self) -> list:
        """Every shard placement of the mesh once (positions that share a
        device and a db shard share one), in grid order."""
        return list({id(sub): sub for row in self._mesh_shards()
                     for host in row for _, sub in host}.values())

    def _mesh_quant(self, precision: str) -> None:
        """Every db shard's int8 / int4 placement built, with the bound
        statistics of the whole database: each statistic is a maximum over
        rows (ops.quantize.db_bound_stats_t), so the shards' maxima give
        the JAX package's values (sharded.py:1203-1299), and every shard's
        certificate reads the same constants."""
        entries = [(sub, sub._quant_placement(precision))
                   for sub in self._distinct_shards()]
        if all(e.get("merged") for _, e in entries):
            return
        stats = dict(entries[0][1]["stats"])
        for key in ("t2hat_max", "et2_max", "db_norm_max"):
            stats[key] = max(e["stats"][key] for _, e in entries)
        consts = bound_consts(stats)
        for sub, e in entries:
            e.update(stats=stats, merged=True,
                     consts=torch.from_numpy(consts).to(sub.device))

    def _mesh_pallas(self, margin: int, tile_n, precision: str, setup: dict):
        """``((coarse, tail), m, w)`` of the one-pass certificate on the
        mesh — the JAX package's ``_pallas_certified_program``
        (sharded.py:2162-2258) split at the candidate boundary as its
        ``_pallas_coarse_program`` / ``_pallas_tail_program``
        (sharded.py:2388-2480) split it: ``coarse(q)`` runs, per query
        shard, every db shard's coarse kernel on its own rows and device;
        ``tail(q, cand)`` runs each shard's select/rescore, masks its pad
        rows and makes its indices global, merges the ranked candidates
        (``m + 1`` wide) by the merge tree, takes the minimum of the
        exclusion bounds across db shards, and certifies the merged lists
        on the query shard's first device (:func:`_certify_pack` with the
        merge-drop check of several db shards).  The query shards' outputs
        join on the first device.  ``tail(q, coarse(q))`` is the
        sequential run; the pipeline runs the halves on two streams."""
        if precision in INT_ARMS:
            self._mesh_quant(precision)
        elif precision == "pq":
            # trained once on every row, placed on every shard
            self._pq_placement(setup["pq_dsub"], setup["pq_ncodes"])
        shards = self._mesh_shards()
        setups = {}
        for sub in self._distinct_shards():
            setups[id(sub)] = sub._pallas_setup(margin, tile_n, precision,
                                                split=True, **setup)
        _, m, w = next(iter(setups.values()))

        def coarse(q: torch.Tensor):
            blocks, n_q, _ = self._mesh_queries(q)
            cand = []
            for qb, row in zip(blocks, shards):
                per = []
                for host in row:
                    for dev, sub in host:
                        qd = qb.to(dev, non_blocking=True)
                        per.append((qd, setups[id(sub)][0][0](qd)))
                cand.append((qb, per))
            return n_q, cand

        def tail(q: torch.Tensor, cand):
            n_q, blocks = cand
            outs = []
            for (qb, per), row in zip(blocks, shards):
                chips = len(row[0])
                d = [[None] * chips for _ in row]
                gi = [[None] * chips for _ in row]
                lbs = []
                for j, (qd, c) in enumerate(per):
                    h, cc = divmod(j, chips)
                    sub = row[h][cc][1]
                    d32, li, lb = setups[id(sub)][0][1](qd, *c)
                    d[h][cc], gi[h][cc] = _mask_shard(
                        d32, li, sub._n_valid, sub._row_offset)
                    lbs.append(lb)
                md, mi = _merge_shards(d, gi, m + 1, self.merge,
                                       self.dcn_merge)
                dev0, sub0 = row[0][0]
                pack = setups[id(sub0)][0][2]
                outs.append(pack(qb.to(dev0, non_blocking=True), md, mi,
                                 reduce_min(lbs, dev0), n_train=self.n_train,
                                 db_shards=self.db_shards))
            return tuple(
                None if outs[0][t] is None else torch.cat(
                    [o[t].to(self.device, non_blocking=True)
                     for o in outs])[:n_q]
                for t in range(len(outs[0])))

        return (coarse, tail), m, w

    def search_certified(self, queries, *, margin: int = 28,
                         selector: str = "pallas",
                         batch_size: Optional[int] = None,
                         tile_n: Optional[int] = None,
                         precision: Optional[str] = None,
                         return_distances: bool = True,
                         bin_w: Optional[int] = None,
                         survivors: Optional[int] = None,
                         final_select: Optional[str] = None,
                         binning: Optional[str] = None,
                         final_recall_target: Optional[float] = None,
                         grid_order: Optional[str] = None,
                         kernel: Optional[str] = None,
                         overlap: Optional[bool] = None,
                         overlap_depth: Optional[int] = None,
                         return_sqrt: bool = False,
                         pq_dsub: Optional[int] = None,
                         pq_ncodes: Optional[int] = None,
                         tune_cache: Optional[str] = None,
                         recall_target: Optional[float] = None):
        """Exact lexicographic top-k via a certificate.  Returns
        ``(dists_f64 [Q, k] or None, idx [Q, k] int64, stats)`` on host.

        ``selector`` picks the certificate (sharded.py:1374-1660):

        - ``"pallas"`` (the default; the JAX package's is ``"approx"``,
          ROADMAP divergence 5): the one-pass certificate through a coarse
          kernel, below;
        - ``"exact"`` / ``"approx"``: the counted certificate
          (:meth:`_certify_counted`) — a coarse top-m in the placement's
          compute dtype (``exact``: ops.topk.knn_search_tiled; ``approx``:
          the MIPS-form ops.topk.knn_search_approx, whose top-m is exact on
          this backend, ``recall_target`` without effect, ROADMAP
          divergence 21), the float64 refine of all m candidates, and one
          f32 count pass against an adaptive threshold; two passes over
          the db, float64-exact distances.

        Indices are the exact lexicographic top-k whatever the selector.
        The pallas selector's distances are the device's f32
        direct-difference values (relative error < RANK_SLACK) except
        near-tied or repaired entries, which are float64-exact.  Cosine
        runs the certificate on unit vectors and returns ``1 -
        similarity``; dot runs it on the norm-augmented rows (queries gain
        a zero column) and maps the values back to ``-q.t`` in float64; l1
        has no certificate.  The coarse-kernel knobs (``tile_n``,
        ``bin_w``, ``survivors``, ``precision``, ``final_select``,
        ``binning``, ``grid_order``, ``final_recall_target``, ``kernel``)
        left at None resolve through ``knn_tpu_torch.tuning.resolve_full``:
        the autotuner's persisted winner for this card and ``(n, d, k,
        metric)`` when there is one (``python -m knn_tpu_torch.cli
        tune``; ``tune_cache`` names the cache file, default
        ``tuning.default_cache_path()``), else the library defaults;
        explicit values win over both, and ``stats["pallas_knobs"]`` /
        ``stats["tuning"]`` carry the resolved set and its provenance.
        ``kernel`` picks the coarse
        kernel: "tiled", "streaming" or "fused", and ``grid_order`` the
        tiled kernel's grid ("query_major" or "db_major"), with bitwise
        the same result; ``precision`` its arm: "bf16x3" (K1, K10, K11),
        "bf16x3f" (K4), "highest" (K2), "int8" (K5), "int4" (K6), "pq"
        (K7; its placement trained on first use at ``pq_dsub`` dims per
        subspace and ``pq_ncodes`` codes, default 4 and 256), each
        certified with its own tolerance ("default", K3, has none and is
        refused); ``binning`` the emitter: "grouped" (``survivors`` per
        lane bin, default 2, at most 8) or "lane" (K8: bins of ``bin_w``
        rows, ``survivors`` each); ``final_select`` "exact" or "approx"
        (an exact top-(m+1) stands in for the reference's approximate one:
        ``final_recall_target`` has no effect, ROADMAP divergence 19).
        ``stats`` carries ``certified``,
        ``fallback_queries``, ``rank_corrected_queries``, the repair
        counts and ``pallas_knobs``.  Queries must be finite.

        ``overlap=True`` runs the batches (``batch_size``) through the
        two-stage pipeline with at most ``overlap_depth`` (default 2) in
        flight; the result is bitwise the sequential one, and
        ``stats["pipeline"]`` reports ``depth``, ``batches``,
        ``overlap_ratio`` and ``wall_s``.  None means off and depth 2:
        the port reads no environment switch for them."""
        from knn_tpu_torch.ops.certified import repair_uncertified

        del recall_target  # no approximate top-k here (divergence 21)
        self._require_resident("search_certified")
        if self.metric not in ("l2", "cosine", "dot"):
            # |q-t|_1 has no gram-matrix form for either certificate to bound
            raise ValueError(
                "search_certified supports the l2, cosine and dot "
                "metrics only")
        if selector not in SELECTORS:
            raise ValueError(
                f"unknown selector {selector!r}; expected {SELECTORS}")
        q_np = np.asarray(queries, dtype=np.float32)
        if not np.isfinite(q_np).all():
            # a NaN score has no place in the certificate's order
            raise ValueError("search_certified: queries must be finite")
        if self.metric == "cosine":
            q_np = row_normalize_f64(q_np)
        q_norm2 = None
        if self.metric == "dot":
            # the zero column of the augmentation, and the f64 ||q||^2 of
            # the values' back-map (sharded.py:1493-1501)
            q64 = q_np.astype(np.float64)
            q_norm2 = np.einsum("nd,nd->n", q64, q64)
            q_np = np.concatenate(
                [q_np, np.zeros((q_np.shape[0], 1), np.float32)], axis=1)
        n_q = q_np.shape[0]
        # the margin is bounded by the db and by the shard rows the coarse
        # and fallback selects draw from
        shard_rows = self._shard_rows()
        m = min(self.k + margin, self.n_train, shard_rows)
        rows = self._host_rows_of()
        db_np = rows.rows
        if batch_size is not None and batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        bs = n_q if batch_size is None else batch_size
        batches = []
        for lo in range(0, n_q, bs):
            chunk = q_np[lo : lo + bs]
            pad = bs - chunk.shape[0]
            if pad:  # the tail runs at the batch shape too
                chunk = np.pad(chunk, ((0, pad), (0, 0)))
            batches.append((lo, chunk, pad))
        d = np.empty((n_q, self.k))
        i = np.empty((n_q, self.k), dtype=np.int64)
        if selector == "pallas":
            # one knob-resolution home: explicit args > the persisted
            # winner for this placement's shape and compute dtype on this
            # card > library defaults (the certificate runs in squared-L2
            # space: cosine on unit vectors, dot on augmented rows)
            knobs, tune_info = tuning.resolve_full(
                self.n_train, db_np.shape[1], self.k,
                metric="l2", dtype=self._dtype_key,
                device_kind=tuning.device_kind_of(self.device),
                cache_path=tune_cache,
                overrides=dict(
                    tile_n=tile_n, precision=precision, bin_w=bin_w,
                    survivors=survivors, final_select=final_select,
                    binning=binning, final_recall_target=final_recall_target,
                    grid_order=grid_order, kernel=kernel))
            bad, n_corrected, pipeline = self._certify_pallas(
                batches, bs, m, d, i, q_np, db_np,
                want_distances=return_distances, overlap=bool(overlap),
                overlap_depth=2 if overlap_depth is None else overlap_depth,
                pq_dsub=pq_dsub, pq_ncodes=pq_ncodes, **knobs)
        else:
            bad = self._certify_counted(batches, bs, m, d, i, q_np, db_np,
                                        selector)

        def _select(qb, widen):
            # widened exact re-select in f32 squared L2 whatever the
            # compute dtype: its scores carry the re-certification's
            # exclusion value, and certification_tolerance covers f32
            # error only (cosine: unit vectors; dot: augmented rows)
            fs, fi = self._exact_topk(self._to_device(qb), widen, "l2")
            return fs.cpu().numpy(), fi.cpu().numpy()

        repair = repair_uncertified(
            d, i, self.k, m, bad, q_np, db_np, select_fn=_select,
            max_widen=min(self.n_train, shard_rows),
            db_norm_max=rows.db_norm_max)
        stats = {
            "fallback_queries": int(bad.size),
            "certified": n_q - int(bad.size),
            **repair,
        }
        if selector == "pallas":
            stats.update(rank_corrected_queries=n_corrected,
                         pallas_knobs=knobs, tuning=tune_info)
            if pipeline is not None:
                stats["pipeline"] = pipeline
        # the per-call stats stay the API; the registry accumulates the
        # process-lifetime counts a scraper reads
        obs.counter(_mn.CERTIFIED_QUERIES, selector=selector).inc(n_q)
        obs.counter(_mn.CERTIFIED_FALLBACKS, selector=selector).inc(
            int(bad.size))
        obs.counter(_mn.CERTIFIED_GENUINE_MISSES, selector=selector).inc(
            repair.get("fallback_genuine_misses", 0))
        obs.counter(_mn.CERTIFIED_FALSE_ALARMS, selector=selector).inc(
            repair.get("fallback_false_alarms", 0))
        obs.counter(_mn.CERTIFIED_HOST_EXACT, selector=selector).inc(
            repair.get("host_exact_queries", 0))
        if selector == "pallas":
            obs.counter(_mn.CERTIFIED_RANK_CORRECTED).inc(n_corrected)
        if return_distances and self.metric == "cosine":
            d *= 0.5  # unit-vector squared L2 -> 1 - cosine similarity
        if return_distances and self.metric == "dot":
            # augmented squared L2 -> -q.t: ||q'-t'||^2 = ||q||^2 + M - 2 q.t
            d -= q_norm2[:, None] + rows.dot_shift
            d *= 0.5
        if return_distances and return_sqrt:
            from knn_tpu_torch.ops.distance import metric_values

            d = metric_values(d, self.metric)
        return (d if return_distances else None), i, stats

    def exact_pair_distances(self, queries, rows, idx,
                             return_sqrt: bool = False) -> np.ndarray:
        """float64 distances of query ``rows[j]`` to db row ``idx[j]``, in
        the values :meth:`search_certified` returns for them (cosine: the
        unit-vector squared L2 halved; dot: the augmented squared L2 mapped
        back to ``-q.t``), with rank_correct_runs' and the back-map's
        arithmetic step for step — a float64 distance of a certified result
        and this one are bitwise equal."""
        q = np.asarray(queries, dtype=np.float32)
        hr = self._host_rows_of()
        if self.metric == "cosine":
            q = row_normalize_f64(q)
        if self.metric == "dot":
            q64 = q.astype(np.float64)
            q_norm2 = np.einsum("nd,nd->n", q64, q64)
            q = np.concatenate([q, np.zeros((q.shape[0], 1), np.float32)], 1)
        rows, idx = np.asarray(rows), np.asarray(idx)
        diff = hr.rows[idx].astype(np.float64) - q[rows].astype(np.float64)
        d = np.einsum("nd,nd->n", diff, diff)
        if self.metric == "cosine":
            d *= 0.5
        if self.metric == "dot":
            d -= q_norm2[rows] + hr.dot_shift
            d *= 0.5
        if return_sqrt:
            from knn_tpu_torch.ops.distance import metric_values

            d = metric_values(d, self.metric)
        return d

    def certify_space(self, queries, d: np.ndarray,
                      return_sqrt: bool = False) -> np.ndarray:
        """``d`` [Q, k] as :meth:`search_certified` returns it, mapped back
        to the squared-L2 space its rank analysis runs in (the inverse of
        the cosine and dot back-maps, and of ``return_sqrt``): the values
        whose relative gaps the rank slack judges."""
        d = np.asarray(d, np.float64)
        if return_sqrt and self.metric != "dot":
            d = d * d
        if self.metric == "cosine":
            return 2.0 * d
        if self.metric == "dot":
            q64 = np.asarray(queries, np.float32).astype(np.float64)
            q_norm2 = np.einsum("nd,nd->n", q64, q64)
            return 2.0 * d + (q_norm2 + self._host_rows_of().dot_shift)[:, None]
        return d

    def _certify_counted(self, batches, bs, m, d, i, q_np, db_np, selector):
        """The counted certificate, the JAX package's ``_certify_counted``
        (sharded.py:1665-1769) on one device; fills ``d``/``i`` and returns
        the flagged query indices.

        1. every batch's coarse top-m is enqueued (``exact``: the f32 or
           ``compute_dtype`` expanded square and a stable top-m; ``approx``:
           ops.certified._approx_candidates);
        2. per batch, the host takes its candidates, refines all m in
           float64 (ranks k..m feed the gap search) and enqueues its count:
           each query counts the db rows strictly below an ADAPTIVE
           threshold, the midpoint of the first gap past rank k that
           clears ``2 tol + 4 eps_f32 |d|`` (``js`` that rank), else ``d_k
           + tol`` (``js = k``);
        3. a query whose count exceeds its ``js`` is flagged: an outsider
           may sit at or below its ``js``-th candidate; each certified
           query's relative margin ``(threshold - d_k) / |threshold|``
           goes to ``CERTIFIED_MARGIN{path="sharded"}``."""
        from knn_tpu_torch.ops.certified import (_approx_candidates,
                                                 certification_tolerance)
        from knn_tpu_torch.ops.refine import refine_exact

        k = self.k
        if selector == "exact":
            def coarse(q):
                return self._exact_topk(q, m, "l2", self._dtype_key)[1]
        elif self._on_mesh():
            def coarse(q):
                return self._mesh_topk(q, m, "l2", self._dtype_key,
                                       selector="approx")[1]
        else:
            db = self.placement.db

            def coarse(q):
                return _row_blocked(
                    lambda qb: (_approx_candidates(
                        qb, db, m, compute_dtype=self._dtype_key),), q,
                    self.n_train)[0]

        # stage 1: every batch's coarse select, enqueued on the device
        coarse_out = []
        for _, chunk, _ in batches:
            q = self._to_device(chunk)
            coarse_out.append((q, coarse(q)))
        # stage 2: per batch, the float64 refine and its count, enqueued
        eps = float(np.finfo(np.float32).eps)
        count_out = []
        for (lo, _, pad), (q, ci_t) in zip(batches, coarse_out):
            take = bs - pad
            ci = ci_t.cpu().numpy()[:take]
            m_avail = ci.shape[1]
            d_m, i_m = refine_exact(db_np, q_np[lo : lo + take], ci, m_avail)
            d[lo : lo + take], i[lo : lo + take] = d_m[:, :k], i_m[:, :k]
            tol = certification_tolerance(
                q_np[lo : lo + take], db_np,
                db_norm_max=self._host_rows_of().db_norm_max)
            gaps = d_m[:, k:] - d_m[:, k - 1 : -1]
            # the midpoint is cast to f32 for the count: the gap must also
            # clear that rounding, and never end at a sentinel (+inf) rank
            f32_round = 4.0 * eps * np.abs(d_m[:, k:])
            open_gap = (gaps > 2.0 * tol[:, None] + f32_round) & np.isfinite(
                d_m[:, k:])
            if open_gap.shape[1] == 0:  # m == k: the fixed threshold
                has = np.zeros(take, dtype=bool)
                js = np.full(take, k)
            else:
                has = open_gap.any(axis=-1)
                js = np.where(has, k + open_gap.argmax(axis=-1), k)
            dj = np.take_along_axis(d_m, js[:, None] - 1, axis=-1)[:, 0]
            d_js = np.take_along_axis(
                d_m, np.minimum(js, m_avail - 1)[:, None], axis=-1)[:, 0]
            mid = np.where(has, 0.5 * (dj + d_js), dj + tol)
            thr = np.full(q.shape[0], -np.inf, dtype=np.float32)
            thr[:take] = mid
            counts = self._count(q, torch.from_numpy(thr))
            count_out.append((lo, take, js, counts, mid, d_m[:, k - 1]))
        # stage 3: the certificates (count <= the query's rank bound)
        flagged = []
        for lo, take, js, c, mid, d_k in count_out:
            over = c.cpu().numpy()[:take] > js
            flagged.append(lo + np.flatnonzero(over))
            ok = ~over
            if obs.enabled() and ok.any():
                denom = np.maximum(np.abs(mid[ok]), 1e-30)
                obs.histogram(_mn.CERTIFIED_MARGIN, path="sharded"
                              ).observe_many(
                    ((mid[ok] - d_k[ok]) / denom).tolist())
        return np.concatenate(flagged) if flagged else np.empty(0, np.int64)

    def predict_certified(self, queries, *, margin: int = 28,
                          selector: str = "pallas",
                          batch_size: Optional[int] = None,
                          tile_n: Optional[int] = None,
                          precision: Optional[str] = None,
                          kernel: Optional[str] = None,
                          tune_cache: Optional[str] = None):
        """Certified-exact classification: exact neighbor sets from
        :meth:`search_certified` (any selector; the pallas kernel's knobs
        left at None resolve through ``tune_cache`` as there), then the
        reference vote.  Returns (labels [Q] int32 numpy, stats)."""
        self._require_resident("predict")
        if self._labels() is None:
            raise RuntimeError("ShardedKNN built without labels; predict unavailable")
        _, idx, stats = self.search_certified(
            queries, margin=margin, selector=selector, batch_size=batch_size,
            tile_n=tile_n, precision=precision, kernel=kernel,
            tune_cache=tune_cache, return_distances=False)
        labels = self._labels()[torch.from_numpy(idx).to(self.device)]
        return majority_vote(labels, self.num_classes).cpu().numpy(), stats


def _certify_pack(q, d32, li, lb, *, db_norm_max: float, m: int, k: int,
                  w: int, n_train: int, include_distances: bool,
                  precision: str = "bf16x3",
                  consts: Optional[torch.Tensor] = None,
                  offset: float = 0.0, pq_dsub: Optional[int] = None,
                  db_shards: int = 1):
    """The certify tail of the JAX package's ``_certify_pack_spmd``, from
    ranked candidates ``(d32 [Q, m+1], li [Q, m+1], lb [Q])`` (one shard's,
    or the merged lists of ``db_shards`` shards with global indices and
    the minimum of their bounds):

    - the rank window [0, w): ``tight`` marks adjacent pairs closer than
      RANK_SLACK; ``stop`` is the first big gap at or after the top-k
      boundary; rows without one (or with non-finite values in the top
      k+1) are ``unresolved``;
    - the tolerance of ``precision`` in f32 (sharded.py:2361-2367):
      ``coarse_knn.bf16_tolerance_scale (||q||^2 + db_norm_max)`` for
      bf16x3 and bf16x3f (the reference's ``2^-14`` or the proved slack,
      whichever is larger: ROADMAP divergence 18), ``32
      eps_f32 (||q||^2 + db_norm_max)`` for highest; for the int arms
      (``consts`` given, sharded.py:2350-2355) the
      per-query provable quantization bound ε and the query norm, both in
      the ``offset``-shifted space the kernel scores in
      (ops.quantize.score_error_bound_device); for pq the per-subspace
      bound of its ``consts`` at ``pq_dsub`` dims per subspace
      (ops.pq.score_error_bound_pq_t, sharded.py:2356-2360);
    - ``bad = s_k + RANK_SLACK d_k + tol >= lb`` (plus unresolved rows),
      with ``s_k = d_k - ||q||^2`` the k-th distance in kernel space; with
      several db shards also ``d_k (1 + RANK_SLACK) >= d32_m (1 -
      RANK_SLACK)`` (sharded.py:2370-2373): a candidate the merge dropped
      has direct-difference distance at least the (m+1)-th kept.

    Returns separate tensors ``(gi [Q, w], tight [Q, w-1], bad [Q],
    dk [Q, k] or None)`` in place of the packed int32 array the JAX
    package built for its TPU relay; :func:`unpack_certified` reads them."""
    gi = torch.where(li >= n_train, I32MAX, li)
    d32 = torch.where(li >= n_train, torch.inf, d32)
    dw = d32[:, :w]
    gaps = dw[:, 1:] - dw[:, :-1]
    # an (x, inf-sentinel) pair gives inf <= inf, which is no near-tie
    tight = (gaps <= RANK_SLACK * dw[:, 1:]) & torch.isfinite(dw[:, 1:])
    pair = torch.arange(w - 1, device=d32.device)[None, :]
    big_after = (~tight) & (pair >= k - 1)
    has_stop = big_after.any(-1)
    first = torch.argmax(big_after.to(torch.uint8), dim=-1)
    stop = torch.where(has_stop, first, w - 1)
    unresolved = (~has_stop) | ~torch.isfinite(dw[:, : k + 1]).all(-1)
    tight_use = tight & (pair < stop[:, None]) & ~unresolved[:, None]
    q32 = q.float()
    if precision == "pq":
        q_norm, tol = score_error_bound_pq_t(q32, consts, dsub=pq_dsub)
    elif consts is not None:
        q_norm, tol = score_error_bound_device(q32 - offset, consts)
    else:
        q_norm = (q32 * q32).sum(-1)
        scale = (bf16_tolerance_scale(precision,
                                      -(-q.shape[1] // DIM_CHUNK))
                 if precision in ("bf16x3", "bf16x3f")
                 else 32.0 * float(np.finfo(np.float32).eps))
        tol = scale * (q_norm + db_norm_max)
    d_k = dw[:, k - 1]
    s_k = d_k - q_norm
    bad = (s_k + RANK_SLACK * d_k + tol >= lb) | unresolved
    if db_shards > 1:
        bad = bad | (d_k + RANK_SLACK * d_k >= d32[:, m] * (1.0 - RANK_SLACK))
    return gi[:, :w], tight_use, bad, (d32[:, :k] if include_distances else None)


def unpack_certified(packed, k: int, w: int, with_distances: bool):
    """Host view of :func:`_certify_pack`'s output, with the JAX package's
    ``unpack_certified`` semantics: ``(gi [Q, w] int32, tight [Q, w-1]
    bool, bad [Q] bool, dk [Q, k] f32 or None)`` as numpy arrays."""
    gi, tight, bad, dk = packed
    if gi.shape[1] != w or tight.shape[1] != w - 1:
        raise ValueError(f"certify output window {gi.shape[1]} != {w}")
    dk_np = None
    if with_distances:
        if dk is None:
            raise ValueError("distances were not computed for this batch")
        dk_np = dk[:, :k].cpu().numpy()
    return (gi.to(torch.int32).cpu().numpy(), tight.cpu().numpy(),
            bad.cpu().numpy(), dk_np)


def sharded_knn(queries, train, k: int, *, mesh: Mesh, metric: str = "l2",
                merge: Optional[str] = None,
                train_tile: Optional[int] = None, compute_dtype=None):
    """Exact KNN over ``mesh``: ``(distances, global indices)`` [Q, k] on
    the mesh's first device — a one-shot :class:`ShardedKNN`
    (sharded.py:2065-2089)."""
    return ShardedKNN(train, mesh=mesh, k=k, metric=metric, merge=merge,
                      train_tile=train_tile,
                      compute_dtype=compute_dtype).search(queries)


def sharded_knn_predict(train, train_labels, queries, *, k: int,
                        num_classes: int, mesh: Mesh, metric: str = "l2",
                        merge: Optional[str] = None,
                        train_tile: Optional[int] = None,
                        compute_dtype=None) -> torch.Tensor:
    """Distributed classify — distance, select and vote over ``mesh``
    (knn_mpi.cpp:308-393; sharded.py:2135-2159): one-shot."""
    return ShardedKNN(train, mesh=mesh, k=k, metric=metric, merge=merge,
                      train_tile=train_tile, compute_dtype=compute_dtype,
                      labels=train_labels,
                      num_classes=num_classes).predict(queries)


def sharded_minmax(arrays, *, mesh: Mesh):
    """Per-dimension ``(min, max)`` over the union of several [N_i, D]
    arrays, each split over every mesh position (edge rows pad it to a
    multiple of the mesh size, which leaves the extrema alone), the local
    extrema reduced onto the first device by the min / max pair of
    knn_mpi.cpp:276-277 (sharded.py:2569-2600).  Returns f32 tensors on the mesh's first
    device; empty arrays are the reduce identity (+inf, -inf)."""
    from knn_tpu_torch.ops.normalize import local_minmax

    from knn_tpu_torch.parallel.collectives import reduce_max

    arrays = list(arrays)
    if not arrays:
        raise ValueError("sharded_minmax needs at least one array")
    first = mesh.devices.flat[0]
    dim = arrays[0].shape[-1]
    nonempty = [a for a in arrays if a.shape[0] > 0]
    if not nonempty:
        return (torch.full((dim,), torch.inf, device=first),
                torch.full((dim,), -torch.inf, device=first))
    devices = list(mesh.devices.flat)
    lows, highs = [None] * len(devices), [None] * len(devices)
    for a in nonempty:
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(a))
        target = max(-(-t.shape[0] // len(devices)) * len(devices),
                     len(devices))
        if target != t.shape[0]:
            t = torch.cat([t, t[-1:].expand(target - t.shape[0], -1)])
        for p, (dev, block) in enumerate(zip(devices,
                                             torch.chunk(t, len(devices)))):
            lo, hi = local_minmax(block.to(dev, non_blocking=True))
            lows[p] = lo if lows[p] is None else torch.minimum(lows[p], lo)
            highs[p] = hi if highs[p] is None else torch.maximum(highs[p], hi)
    return reduce_min(lows, first), reduce_max(highs, first)


def sharded_normalize_transductive(train, test=None, val=None, *,
                                   mesh: Mesh):
    """The reference's normalize phase (knn_mpi.cpp:229-306) over
    ``mesh``: joint extrema over train ∪ test ∪ val, then the rescale with
    constant dims passed through.  Returns ``(train', test', val')`` as
    tensors on the mesh's first device, None passed through."""
    from knn_tpu_torch.ops.normalize import minmax_apply

    present = [a for a in (train, test, val) if a is not None]
    lo, hi = sharded_minmax(present, mesh=mesh)
    first = mesh.devices.flat[0]
    return tuple(
        None if a is None else minmax_apply(
            (a if isinstance(a, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(a))).to(first), lo, hi)
        for a in (train, test, val))
