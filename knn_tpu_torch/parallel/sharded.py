"""Placed KNN program on one GPU — the port of knn_tpu/parallel/sharded.py
(``ShardedKNN``) for one device and no mesh.

The database is placed once (knn_tpu_torch.convert.placement_from_numpy)
and every :meth:`ShardedKNN.search` / :meth:`~ShardedKNN.predict` /
:meth:`~ShardedKNN.search_certified` call reuses the placement.  With one
db shard the JAX package's merge tree and ``pmin`` are identities, so
they are absent here; everything else follows the JAX code path:

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
model) exceeds the budget is never placed.  Its prepared rows stay on the
host, split into budget-sized segments (``hbm.plan_segments``), and
``search`` sweeps them through :func:`segment_search_program`, every
segment padded to one shape with ``PAD_VAL``: each segment is copied into
one of ``hosttier_depth`` pinned staging buffers, up to the card on a side
stream behind an event into that slot's device buffer, searched, and its
top-k merged into a carry on the card in the lexicographic ``(distance,
index)`` order (ops.topk.merge_topk).  At most ``hosttier_depth`` sweeps
are in flight: a staging buffer is refilled once its copy has finished, a
device buffer once the sweep that read it has.  The budget bounds a
segment, not the card: the tier keeps its ``hosttier_depth`` device
buffers from its first search on, and a sweep's search adds a workspace
sized to at most one budget (its query blocks, the segment's norms), so a
search holds about ``hosttier_depth + 1`` budgets on the card (cosine one
more: its normalized segment), besides the queries and the top-k carry.
The paths that read the whole database (certified search, predict, radius
search, bucketed serving) refuse such a placement by name.

Batches run on the card while the host repairs earlier ones: each batch's
certify output is copied into pinned host memory behind a CUDA event of
its own, and the host waits on that event alone.  ``overlap=True`` runs
the two-stage pipeline of the JAX package (sharded.py:1966-2011): the
coarse kernel on one CUDA stream, the select/rescore/certify tail on a
second, at most ``overlap_depth`` batches in flight.

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

import threading
import time
from collections import deque
from typing import Optional, Tuple

import numpy as np
import torch

from knn_tpu_torch import obs, tuning
from knn_tpu_torch.analysis import hbm
from knn_tpu_torch.convert import (Placement, host_rows, place_host_rows,
                                   row_normalize_f64)
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
from knn_tpu_torch.ops.topk import (I32MAX, knn_search, knn_search_tiled,
                                   merge_topk)
from knn_tpu_torch.obs import names as _mn
from knn_tpu_torch.ops.vote import majority_vote
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
                         compute_dtype=None):
    """The resident exact search over one query block — the JAX package's
    ``query_stream_program`` (sharded.py:348-380) on one device:
    ``prog(q, db) -> (d [Q, k], i [Q, k])`` device tensors, the
    placement's metric in ``compute_dtype`` (f32 accumulation) and a
    stable top-k, in query row blocks of ``_EXACT_BLOCK_ELEMS``.
    :meth:`ShardedKNN.search` runs this program, so a join that streams
    query blocks through it is bitwise the looped search at the same
    block shape."""
    def prog(q: torch.Tensor, db: torch.Tensor):
        return _row_blocked(
            lambda qb: knn_search_tiled(qb, db, k, metric,
                                        train_tile=train_tile,
                                        compute_dtype=compute_dtype),
            q, db.shape[0])

    return prog


def segment_search_program(k: int, metric: str = "l2", *,
                           train_tile: Optional[int] = None,
                           compute_dtype=None, device: DeviceLike = None,
                           block_elems: int = _EXACT_BLOCK_ELEMS):
    """The exact tiled search of one padded db segment — the one-device
    form of the JAX package's ``_hosttier_program`` / ``segment_search_program``
    (sharded.py:275-346): ``prog(q, seg, n_valid) -> (d [Q, k], i [Q,
    k])`` on ``device`` (None = cuda; host arrays are placed there).
    Rows at or above the runtime ``n_valid`` are padding: they are masked
    to +inf before the select, and any of them still in the top-k (fewer
    than k valid rows) come back as ``+inf`` with the int32-max sentinel
    index.  A new ``n_valid`` (a grown delta tail, another probe set)
    never changes the segment's shape.  Untiled, the segment's side of
    the distance (its norms) is made once a call for every query block;
    ``block_elems`` bounds one block's [rows, segment rows] scores (the
    host-RAM tier sizes it from its budget)."""
    dev = resolve_device(device)

    def prog(q, seg, n_valid: int):
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


class ShardedKNN:
    """A database placed once on one device (default ``cuda``) with k.

    ``train`` is a host [N, D] array or a :class:`~knn_tpu_torch.convert.
    Placement`; ``labels`` [N] with ``num_classes`` enable the predict
    methods.  Metrics: every name of ops.metrics.METRICS (cosine rows are
    normalized at placement, so the certificate runs on unit vectors; dot
    rows are norm-augmented, so it runs on the augmented rows; l1 has no
    certificate).  ``compute_dtype`` (None / "float32", "bfloat16",
    "float16" or their torch dtypes) is the input dtype of the matmuls
    ``search``, ``predict`` and the counted selectors' coarse pass rank
    with (ops.distance._dot: f32 accumulation); the certificates' counts
    and repairs stay f32.

    ``hbm_budget_bytes`` (None: no budget) runs a host array whose
    placement would exceed it in the host-RAM tier (module docstring;
    ``hbm.placement_bytes`` of the prepared rows), with ``hosttier_depth``
    sweeps in flight; a :class:`Placement` or a tensor over the budget is
    refused, one within it placed as without a budget.  The budget sizes
    the tier's segments: a search holds about ``hosttier_depth + 1``
    budgets on the card (module docstring).  One tier search runs at a
    time; concurrent callers wait for each other."""

    def __init__(self, train, *, k: int, metric: str = "l2",
                 train_tile: Optional[int] = None, compute_dtype=None,
                 labels=None, num_classes: Optional[int] = None,
                 device: DeviceLike = None,
                 hbm_budget_bytes: Optional[int] = None,
                 hosttier_depth: int = 2):
        #: the compute dtype's name, the JAX package's ``_dtype_key``
        #: (None: float32)
        self._dtype_key = dtype_name(compute_dtype)
        budget = hbm_budget_bytes
        if budget is not None and budget <= 0:
            raise ValueError(f"hbm_budget_bytes must be > 0, got {budget}")
        if int(hosttier_depth) < 1:
            raise ValueError(
                f"hosttier_depth must be >= 1, got {hosttier_depth}")
        #: the host-RAM tier's plan (None: the database is placed)
        self._host_tier: Optional[dict] = None
        #: its prepared host rows; on the card its slots (a pinned staging
        #: buffer, a device segment buffer and their last events each) and
        #: copy stream, made at the first search
        self._host_rows = None
        self._slots = None
        self._copy_stream = None
        self._last_hosttier: Optional[dict] = None
        #: one tier search or tiered join at a time: they share the slots
        self._tier_lock = threading.Lock()
        if budget is not None and isinstance(train, (Placement,
                                                     torch.Tensor)):
            n, width = ((train.n_train, train.db.shape[1])
                        if isinstance(train, Placement) else
                        tuple(train.shape))
            if hbm.placement_bytes(n, width) > budget:
                raise ValueError(
                    f"hbm_budget_bytes={budget} cannot hold this {n}-row "
                    f"placement, and the host-RAM tier needs a host-array "
                    f"construction to stream from; pass the rows as a "
                    f"numpy array (or raise the budget)")
        if isinstance(train, Placement):
            if labels is not None or device is not None:
                raise ValueError(
                    "a Placement already carries its labels and device")
            asked = canonical_metric(metric)
            if asked != train.metric:
                raise ValueError(
                    f"metric {metric!r} does not match the placement's "
                    f"{train.metric!r}")
            pl = train
        else:
            resolve_device(device)  # no host work for a missing device
            rows = host_rows(train, metric)
            if budget is not None and \
                    hbm.placement_bytes(*rows.rows.shape) > budget:
                pl = None
                self._plan_host_tier(rows, int(budget), int(hosttier_depth),
                                     k, labels, num_classes, device)
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
        self.placement = pl
        self.k = k
        self.train_tile = train_tile
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

    # -- the host-RAM tier --------------------------------------------------
    def _plan_host_tier(self, rows, budget: int, depth: int, k: int,
                        labels, num_classes, device: DeviceLike) -> None:
        """The tier's plan for prepared host ``rows`` over ``budget``
        (sharded.py:693-723): the segments, their padded width and bytes."""
        n, width = rows.rows.shape
        segments = hbm.plan_segments(n, width, budget)
        seg_rows = segments[0][1] - segments[0][0]
        if k > min(n, seg_rows):
            raise ValueError(
                f"k={k} exceeds the {seg_rows}-row host-tier segment; "
                f"raise hbm_budget_bytes")
        if labels is not None:
            if num_classes is None:
                raise ValueError("labels given without num_classes")
            if np.asarray(labels).shape != (n,):
                raise ValueError(
                    f"labels shape {np.asarray(labels).shape} != "
                    f"(n_train,) = ({n},)")
        self.device = resolve_device(device)
        self.metric = rows.metric
        self.n_train = n
        self.num_classes = num_classes
        self.dim_in = rows.dim_in
        self._host_rows = rows
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
        """The paths that read the whole database need it placed; the
        host-RAM tier only ever has one segment on the card."""
        if self._host_tier is not None:
            raise ValueError(
                f"{what} needs the full database resident on device, but "
                f"this placement runs the host-RAM shard tier (corpus "
                f"exceeds the {self._host_tier['budget_bytes']}-byte HBM "
                f"budget); use search(), or raise the budget")

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
        """The tier's ``depth`` slots and copy stream, made at the first
        search on the card and kept: each slot a pinned staging buffer, a
        device segment buffer and the events of its last copy (``copied``)
        and of the last work that read it (``done``).  The device buffers
        may reuse blocks that work still queued on the current stream
        reads, so the copy stream waits for that work once, here."""
        if self._slots is None:
            shape = (self._host_tier["segment_rows"],
                     self._host_rows.rows.shape[1])
            self._copy_stream = torch.cuda.Stream(self.device)
            self._slots = [
                {"host": torch.empty(shape, dtype=torch.float32,
                                     pin_memory=True),
                 "dev": torch.empty(shape, dtype=torch.float32,
                                    device=self.device),
                 "copied": None, "done": None}
                for _ in range(self._host_tier["depth"])]
            self._copy_stream.wait_stream(
                torch.cuda.current_stream(self.device))
        return self._slots, self._copy_stream

    def _hosttier_program(self, k: int):
        """The tier's segment program: its query blocks keep one sweep's
        search workspace within the budget (``_HOSTTIER_SCORE_BYTES`` a
        score)."""
        return segment_search_program(
            k, self.metric, train_tile=self.train_tile,
            compute_dtype=self._dtype_key, device=self.device,
            block_elems=max(1, self._host_tier["budget_bytes"]
                            // _HOSTTIER_SCORE_BYTES))

    def _stream_segments(self, marks: Optional[list] = None):
        """Yields ``(lo, hi, seg)`` for every host-tier segment, ``seg`` its
        rows padded to the segment width with ``PAD_VAL`` (on the card a
        device tensor, on the CPU a host array).  The caller holds
        ``_tier_lock`` and enqueues the work that reads ``seg`` on the
        current stream before it asks for the next segment.  On the card
        segment s goes through slot s % depth: its rows are written into
        the slot's staging buffer once the slot's last copy has finished,
        and copied up on the copy stream once the last work that read the
        slot's device buffer (in this call or an earlier one) has, behind
        an event the current stream waits for; so at most ``depth``
        segments are in flight.  ``marks`` gains each segment's CUDA
        events (``start``, ``copied``, ``done``) on the card, its host
        seconds on the CPU."""
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
        slots, copy_stream = self._hosttier_slots()
        compute = torch.cuda.current_stream(self.device)
        for s, (lo, hi) in enumerate(ht["segments"]):
            slot = slots[s % depth]
            if slot["copied"] is not None:
                slot["copied"].synchronize()
            host = slot["host"].numpy()
            host[: hi - lo] = rows[lo:hi]
            host[hi - lo:] = PAD_VAL
            ev = {name: torch.cuda.Event(enable_timing=True)
                  for name in ("start", "copied", "done")}
            with torch.cuda.stream(copy_stream):
                if slot["done"] is not None:
                    copy_stream.wait_event(slot["done"])
                ev["start"].record(copy_stream)
                slot["dev"].copy_(slot["host"], non_blocking=True)
                ev["copied"].record(copy_stream)
            slot["copied"] = ev["copied"]
            compute.wait_event(ev["copied"])
            try:
                yield lo, hi, slot["dev"]
            finally:  # also when the caller stops early
                ev["done"].record(compute)
                slot["done"] = ev["done"]
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
        with self._engines_lock:
            key = (k, q.shape[0])
            self._dispatch_shapes[key] = self._dispatch_shapes.get(key, 0) + 1
        best = None
        marks: list = []
        with self._tier_lock:
            t_wall0 = time.perf_counter()
            for lo, hi, seg in self._stream_segments(marks):
                d, i = prog(q, seg, hi - lo)
                # segment-local indices made global; the pad rows'
                # sentinel stays put
                gi = torch.where(i == I32MAX, i, i + lo)
                best = (d, gi) if best is None else \
                    merge_topk(*best, d, gi, k)
            last = {"sweeps": len(marks), "k": k,
                    "queries": int(q.shape[0])}
            if self.device.type == "cuda":
                marks[-1]["done"].synchronize()
                walls = [ev["start"].elapsed_time(ev["done"]) / 1e3
                         for ev in marks]
                h2d = [ev["start"].elapsed_time(ev["copied"]) / 1e3
                       for ev in marks]
                last["h2d_s"] = h2d
                last["h2d_gbps"] = (ht["bytes_per_sweep"] * len(h2d)
                                    / sum(h2d) / 1e9 if sum(h2d) > 0
                                    else None)
                last["device_buffer_bytes"] = sum(
                    slot["dev"].nbytes for slot in self._slots)
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
        if self.placement is None:
            return self._host_rows.rows
        return self.placement.db_host

    def _exact_topk(self, q: torch.Tensor, k: int, metric: str,
                    compute_dtype=None):
        return query_stream_program(
            k, metric, train_tile=self.train_tile,
            compute_dtype=compute_dtype)(q, self.placement.db)

    def search(self, queries, *, k: Optional[int] = None,
               return_sqrt: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """(distances, indices) [Q, k] of the k nearest rows, as tensors on
        the device.  L2 distances are SQUARED unless ``return_sqrt``."""
        k = self.k if k is None else k
        if k > self.n_train:
            raise ValueError(f"k={k} exceeds n_train={self.n_train}")
        if self._host_tier is not None:
            if k > self._host_tier["segment_rows"]:
                raise ValueError(
                    f"k={k} exceeds the "
                    f"{self._host_tier['segment_rows']}-row host-tier "
                    f"segment")
            return self._search_host_tier(queries, k, return_sqrt)
        q = self._to_device(queries)
        shape_key = (k, q.shape[0])
        with self._engines_lock:
            self._dispatch_shapes[shape_key] = (
                self._dispatch_shapes.get(shape_key, 0) + 1)
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
        :meth:`compile_cache_stats` and knn_tpu_torch.serving."""
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
        if self.placement.labels is None:
            raise RuntimeError("ShardedKNN built without labels; predict unavailable")
        _, gi = self.search(queries)
        safe = torch.clamp(gi, max=self.n_train - 1)
        return majority_vote(self.placement.labels[safe], self.num_classes)

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
        from knn_tpu_torch.ops.certified import count_below
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
            out = _single(self._to_device(queries), self.placement.db, radius,
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
        d, i = self.search(queries, k=m)
        d, i = d.cpu().numpy(), i.cpu().numpy()
        # strictly below the next f32 above the threshold: <= in f32
        qc = self._to_device(q_count)
        thr_vec = torch.full(
            (qc.shape[0],),
            float(np.nextafter(np.float32(count_thr), np.float32(np.inf))),
            dtype=torch.float32)
        counts = count_below(self.placement.db, qc, thr_vec,
                             tile=self.train_tile or 131072).cpu().numpy()
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
                    n = self.n_train
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
            byte_exact = precision == "int8" and pl.uint8_source
            offset = 128.0 if byte_exact else 0.0
            shifted = pl.db - offset
            if byte_exact:  # ops.quantize.from_uint8 on the device
                values = shifted.to(torch.int8)
                scales = torch.ones(self.n_train, device=self.device)
            elif precision == "int8":
                values, scales = quantize_rows(shifted, eager=True)
            else:
                values, scales = quantize_rows_int4(shifted, eager=True)
            del shifted
            stats, norms = db_bound_stats_t(values, scales, pl.db, offset)
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
        (ops.pq.train_pq, its assign steps on this placement's device) and
        the rows encoded as uint8 codes [N, m].  Defaults (4, 256); the
        JAX package reads them from environment switches (ROADMAP queue
        C).  Returns ``parts``, the kernel operands ``(codes, tnorm)``
        padded as the f32 placement's bf16 parts are (zero codes, PAD_VAL
        norm rows; coarse_knn.prepare_db_pq), ``codes`` (the unpadded
        rows of it), ``books`` (f32 [m, C, dsub]) and ``consts``
        (ops.pq.bound_consts_pq) on the device, ``stats``, ``dsub``,
        ``ncodes`` and ``train_s`` (the training's seconds)."""
        from knn_tpu_torch.ops.pq import train_pq

        dsub = int(dsub or PQ_DSUB_DEFAULT)
        ncodes = int(ncodes or PQ_NCODES_DEFAULT)
        key = (dsub, ncodes)
        if key not in self._pq:
            t0 = time.perf_counter()
            res = train_pq(self.placement.db_host, device=self.device,
                           dsub=dsub, ncodes=ncodes)
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
        ``PQResult`` across with it)."""
        codebooks = np.asarray(codebooks, np.float32)
        codes = np.ascontiguousarray(np.asarray(codes, np.uint8))
        if codes.shape != (self.n_train, codebooks.shape[0]):
            raise ValueError(
                f"codes {codes.shape} do not match {self.n_train} rows of "
                f"{codebooks.shape[0]} subspaces")
        ncodes = int(ncodes or codebooks.shape[1])
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
                      final_recall_target: Optional[float] = None):
        """((coarse, tail), m, analysis_window) for the one-pass certified
        path — the one home of the kernel-geometry margin cap.  The pair
        is the JAX package's program split at the candidate boundary
        (sharded.py:1840-1862): ``coarse(q)`` takes a [B, D] device batch
        and returns the coarse kernel's ``(cd, ci, bounds)``; ``tail(q,
        cd, ci, bounds)`` the select/rescore/certify, returning
        :func:`_certify_pack`'s tensors.  The sequential path and the
        pipeline run the same pair, so their outputs are bitwise equal."""
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

        def tail(q: torch.Tensor, cd, ci, bounds):
            d32, li, lb = local_select_rescore(
                q, db, cd, ci, bounds, m, final_select=final_select,
                final_recall_target=final_recall_target)
            return _certify_pack(q, d32, li, lb, db_norm_max=db_norm_max,
                                 m=m, k=self.k, w=w, n_train=rows,
                                 include_distances=include_distances,
                                 precision=precision, consts=consts,
                                 offset=offset, pq_dsub=dsub)

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
        (coarse, tail), m, w = self._pallas_setup(
            m - k, tile_n, precision, bin_w=bin_w, survivors=survivors,
            final_select=final_select,
            include_distances=want_distances, binning=binning,
            grid_order=grid_order, kernel=kernel, pq_dsub=pq_dsub,
            pq_ncodes=pq_ncodes, final_recall_target=final_recall_target)
        if precision in ("int8", "int4", "pq") and obs.enabled():
            # the certificate's per-query quantization bound, recomputed on
            # the host (O(Q D)) from the placement's host stats: the device
            # copy stays on the device
            if precision == "pq":
                from knn_tpu_torch.ops.pq import score_error_bound_pq

                eps = score_error_bound_pq(
                    q_np, self._pq_placement(pq_dsub, pq_ncodes)["stats"])
            else:
                from knn_tpu_torch.ops.quantize import score_error_bound

                pl = self._quant_placement(precision)
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
                fetched.append(_fetch_async(tail(q, *coarse(q))))
            for (lo, _, pad), f in zip(batches, fetched):
                repair(lo, pad, f)
            return np.flatnonzero(bad_mask), n_corrected, None

        depth = max(1, int(overlap_depth))
        cuda = self.device.type == "cuda"
        if cuda:
            main = torch.cuda.current_stream(self.device)
            if self._streams is None:
                self._streams = (torch.cuda.Stream(self.device),
                                 torch.cuda.Stream(self.device))
            coarse_stream, tail_stream = self._streams
            # the placement and anything queued before this call
            coarse_stream.wait_stream(main)
            tail_stream.wait_stream(main)
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
                fetched = _fetch_async(tail(q, *coarse(q)))
            else:
                with torch.cuda.stream(coarse_stream):
                    q = self._to_device(chunk)
                    cand = coarse(q)
                    coarse_done = torch.cuda.Event()
                    coarse_done.record()
                with torch.cuda.stream(tail_stream):
                    tail_stream.wait_event(coarse_done)
                    # made on the coarse stream, read on the tail stream:
                    # the allocator must not hand them out again before
                    # the tail is done with them
                    for t in (q, *cand):
                        t.record_stream(tail_stream)
                    fetched = _fetch_async(tail(q, *cand))
            pending.append((lo, pad, fetched, t0))
        while pending:
            finalize(pending.popleft())
        if cuda:
            # work queued after this call (the fallback repair's widened
            # select) starts after every batch of both streams
            main.wait_stream(coarse_stream)
            main.wait_stream(tail_stream)
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
        m = min(self.k + margin, self.n_train)
        db_np = self.placement.db_host
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
                self.n_train, self.placement.db.shape[1], self.k,
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
            max_widen=self.n_train, db_norm_max=self.placement.db_norm_max)
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
            d -= q_norm2[:, None] + self.placement.dot_shift
            d *= 0.5
        if return_distances and return_sqrt:
            from knn_tpu_torch.ops.distance import metric_values

            d = metric_values(d, self.metric)
        return (d if return_distances else None), i, stats

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
                                                 certification_tolerance,
                                                 count_below)
        from knn_tpu_torch.ops.refine import refine_exact

        k, db = self.k, self.placement.db
        if selector == "exact":
            def coarse(q):
                return self._exact_topk(q, m, "l2", self._dtype_key)[1]
        else:
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
                db_norm_max=self.placement.db_norm_max)
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
            counts = count_below(db, q, torch.from_numpy(thr),
                                 tile=self.train_tile or 131072)
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
        if self.placement.labels is None:
            raise RuntimeError("ShardedKNN built without labels; predict unavailable")
        _, idx, stats = self.search_certified(
            queries, margin=margin, selector=selector, batch_size=batch_size,
            tile_n=tile_n, precision=precision, kernel=kernel,
            tune_cache=tune_cache, return_distances=False)
        labels = self.placement.labels[torch.from_numpy(idx).to(self.device)]
        return majority_vote(labels, self.num_classes).cpu().numpy(), stats


def _certify_pack(q, d32, li, lb, *, db_norm_max: float, m: int, k: int,
                  w: int, n_train: int, include_distances: bool,
                  precision: str = "bf16x3",
                  consts: Optional[torch.Tensor] = None,
                  offset: float = 0.0, pq_dsub: Optional[int] = None):
    """The certify tail of the JAX package's ``_certify_pack_spmd`` for one
    shard, from ranked candidates ``(d32 [Q, m+1], li [Q, m+1], lb [Q])``:

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
      with ``s_k = d_k - ||q||^2`` the k-th distance in kernel space.

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
