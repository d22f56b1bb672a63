"""Several processes, one database — the port of
knn_tpu/parallel/multihost.py.

The reference scales with ``mpiexec -n N``: every rank is an OS process
(knn_mpi.cpp:123-125).  The JAX package joins one process a host through
``jax.distributed.initialize`` and trades candidate lists through the
coordinator's key-value store (multihost.py:181-243).  The port joins its
processes through a ``torch.distributed.TCPStore`` (:func:`initialize`:
process 0 holds the store at ``coordinator_address``) and trades through
it the same way: :func:`dcn_allgather_arrays` is ``set``, a blocking
``wait`` / ``get`` with a timeout, an ``add``-counted barrier and
``delete_key`` — the JAX package's ``key_value_set`` /
``blocking_key_value_get`` / ``wait_at_barrier`` / ``key_value_delete``.
Each process searches its own rows on its own devices
(:class:`MultiHostKNN`, a local :class:`~knn_tpu_torch.parallel.sharded.
ShardedKNN` on a local mesh, whose db shards merge on the devices), and
the per-process lists merge on the host (:func:`merge_topk_host`) in the
same lexicographic order.  The transport is the host and TCP: it is not
NCCL, NVLink or InfiniBand, and two processes on one machine measure no
interconnect.

Where the port differs (ROADMAP queue C): the in-mesh cross-process path
— a mesh over other processes' devices (:func:`global_mesh`) or rows
placed across processes (:func:`shard_across_hosts`) — needs device
collectives across processes (NCCL) and is refused by name with more
than one process; with one process both are the local forms.
"""

from __future__ import annotations

import io
import itertools
import threading
import time
from datetime import timedelta
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from knn_tpu_torch import obs
from knn_tpu_torch.device import DeviceLike
from knn_tpu_torch.obs import ident as _ident
from knn_tpu_torch.obs import names as _mn
from knn_tpu_torch.parallel import crossover
from knn_tpu_torch.parallel.collectives import shard
from knn_tpu_torch.parallel.mesh import DB_AXIS, Mesh, make_mesh

#: seconds a store wait takes before it raises
DEFAULT_TIMEOUT_S = 180.0

#: the joined runtime: the store, this process's index and the count
_STATE: dict = {}
_STATE_LOCK = threading.Lock()


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join this process to the others (the reference's ``MPI_Init``,
    knn_mpi.cpp:123): a ``TCPStore`` at ``coordinator_address``
    (``"host:port"``), held by process 0, which waits for all
    ``num_processes``.  A no-op for one process or once joined, so a
    program can call it unconditionally."""
    if num_processes is None or num_processes <= 1:
        return
    with _STATE_LOCK:
        if _STATE:
            return
        if coordinator_address is None or process_id is None:
            raise ValueError(
                "initialize needs coordinator_address and process_id for "
                f"{num_processes} processes")
        host, port = coordinator_address.rsplit(":", 1)
        store = torch.distributed.TCPStore(
            host, int(port), world_size=int(num_processes),
            is_master=int(process_id) == 0,
            timeout=timedelta(seconds=timeout_s), wait_for_workers=True)
        _STATE.update(store=store, process_index=int(process_id),
                      process_count=int(num_processes),
                      address=coordinator_address, timeout_s=timeout_s)
    _ident.set_identity(process_count=int(num_processes),
                        coordinator_address=coordinator_address,
                        process_index=int(process_id))


def process_index() -> int:
    return _STATE.get("process_index", 0)


def process_count() -> int:
    return _STATE.get("process_count", 1)


def _refuse_cross_process(what: str) -> None:
    if process_count() > 1:
        raise ValueError(
            f"{what}: a mesh over other processes' devices needs device "
            f"collectives across processes (NCCL); that path is queued "
            f"for a machine with several cards (ROADMAP queue A).  Use "
            f"MultiHostKNN, which merges through the store")


def global_mesh(query_shards: Optional[int] = None,
                db_shards: int = 1) -> Mesh:
    """The (query, db) mesh over every visible card — the reference's
    ``MPI_COMM_WORLD`` (knn_mpi.cpp:124-125) in one process; refused
    across processes (module docstring)."""
    _refuse_cross_process("global_mesh")
    return make_mesh(query_shards, db_shards)


def shard_across_hosts(local_rows, mesh: Mesh, axis_name=DB_AXIS):
    """This process's rows placed over ``mesh`` along ``axis_name`` (a
    :class:`~knn_tpu_torch.parallel.collectives.Placed`, which
    ``ShardedKNN(..., n_train=)`` takes) — the multi-host ``MPI_Scatter``
    (knn_mpi.cpp:226-227) in one process; refused across processes."""
    _refuse_cross_process("shard_across_hosts")
    return shard(np.asarray(local_rows), mesh, axis_name)


def process_row_slice(n_global_rows: int) -> slice:
    """The contiguous rows of a [N, D] global matrix this process loads —
    the per-rank read the reference assigns by rank id
    (knn_mpi.cpp:154-222).  Rows must be padded to a multiple of the
    process count."""
    pc = process_count()
    if n_global_rows % pc:
        raise ValueError(
            f"{n_global_rows} rows not divisible by {pc} processes; pad first")
    per = n_global_rows // pc
    pid = process_index()
    return slice(pid * per, (pid + 1) * per)


# -- the store exchange -------------------------------------------------------

#: the last cross-process merge's report (/statusz, doctor: obs.health)
_REPORT_LOCK = threading.Lock()
_LAST_REPORT: dict = {}

#: replica construction ordinals: store keys carry them, so two replicas
#: or two searches never share a key (every process must construct and
#: call in the same order, as with any collective)
_INSTANCE_SEQ = itertools.count()


def last_report() -> Optional[dict]:
    """The last cross-process merge's report (hosts, transport, strategy,
    straggler gap, merge bytes, and the seconds and payload bytes of the
    search's store exchanges: the lists, plus the float64 tie scores
    when near ties crossed processes); None until a merge ran in this
    process."""
    with _REPORT_LOCK:
        return dict(_LAST_REPORT) if _LAST_REPORT else None


def _update_report(**kw) -> None:
    with _REPORT_LOCK:
        _LAST_REPORT.clear()
        _LAST_REPORT.update(kw)


def _store():
    store = _STATE.get("store")
    if store is None:
        raise RuntimeError(
            "no store: call multihost.initialize(...) with the process "
            "count first")
    return store


def _encode_arrays(*arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, *[np.ascontiguousarray(np.asarray(a)) for a in arrays])
    return buf.getvalue()


def _decode_arrays(raw: bytes, n: int) -> List[np.ndarray]:
    with np.load(io.BytesIO(raw)) as z:
        return [z[f"arr_{i}"] for i in range(n)]


#: the last exchange's seconds and payload bytes (this process's view)
_LAST_EXCHANGE: dict = {}


def dcn_allgather_arrays(arrays: Sequence[np.ndarray], *, tag: str,
                         timeout_s: Optional[float] = None
                         ) -> List[List[np.ndarray]]:
    """Allgather a tuple of host arrays across every process through the
    store.  Returns one array list per process, in process order.
    ``tag`` must be unique per call and the same in every process (every
    process makes the same sequence of calls).  A wait that outlasts
    ``timeout_s`` (default: :func:`initialize`'s) raises: a missing
    process never leaves the others with their own rows alone."""
    pc = process_count()
    if pc == 1:
        return [[np.asarray(a) for a in arrays]]
    store = _store()
    timeout = timedelta(seconds=timeout_s or _STATE["timeout_s"])
    pid = process_index()
    t0 = time.perf_counter()
    payload = _encode_arrays(*arrays)
    own_key = f"knn_tpu/dcn/{tag}/{pid}"
    store.set(own_key, payload)
    out: List[List[np.ndarray]] = []
    moved = len(payload)
    for p in range(pc):
        if p == pid:
            out.append([np.asarray(a) for a in arrays])
            continue
        key = f"knn_tpu/dcn/{tag}/{p}"
        store.wait([key], timeout)
        raw = store.get(key)
        moved += len(raw)
        out.append(_decode_arrays(raw, len(arrays)))
    # every process has read every list: each deletes its own key, and
    # the last to leave the barrier deletes the barrier's keys, so a
    # long-lived replica leaves nothing in the store a search
    barrier = f"knn_tpu/dcn/{tag}/read"
    if store.add(barrier, 1) == pc:
        store.set(barrier + "/done", b"1")
    store.wait([barrier + "/done"], timeout)
    store.delete_key(own_key)
    if store.add(barrier + "/left", 1) == pc:
        for key in (barrier, barrier + "/done", barrier + "/left"):
            store.delete_key(key)
    _LAST_EXCHANGE.update(seconds=time.perf_counter() - t0, bytes=moved)
    return out


def _add_exchange_to_report() -> None:
    """Add the last exchange's seconds and bytes to the report's (a
    search's second exchange, the float64 tie scores)."""
    with _REPORT_LOCK:
        if _LAST_REPORT:
            _LAST_REPORT["exchange_s"] = round(
                _LAST_REPORT.get("exchange_s", 0.0)
                + _LAST_EXCHANGE.get("seconds", 0.0), 6)
            _LAST_REPORT["exchange_bytes"] = (
                _LAST_REPORT.get("exchange_bytes", 0)
                + int(_LAST_EXCHANGE.get("bytes", 0)))


def merge_topk_host(d_lists: Sequence[np.ndarray],
                    i_lists: Sequence[np.ndarray],
                    k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host lexicographic ``(distance, index)`` top-k of the per-process
    candidate lists — the order ops.topk merges in on the device, so the
    merged result is bitwise a single placement's over all rows."""
    cd = np.concatenate(list(d_lists), axis=1)
    ci = np.concatenate(list(i_lists), axis=1)
    order = np.lexsort((ci, cd), axis=-1)[:, :k]
    return (np.take_along_axis(cd, order, axis=-1),
            np.take_along_axis(ci, order, axis=-1))


class MultiHostKNN:
    """One replica over several processes, each holding only its own
    contiguous row block — the reference's ``mpiexec -n N`` scale-out
    (knn_mpi.cpp:123-175) without its replicated database.

    Each process runs a :class:`~knn_tpu_torch.parallel.sharded.ShardedKNN`
    of its rows on a local ``mesh`` (default: ``db_shards`` shards over the
    visible cards, or over ``device`` repeated, a logical mesh), whose
    shards merge on the devices; then the per-process ``[Q, k]`` lists
    cross through the store and merge on the host (the DCN level, always
    an allgather: ``dcn_merge`` other than "allgather" is refused).  Every
    process must hold the same row count and call each search in the
    same order with the same queries.  ``search_certified`` returns a
    single ``ShardedKNN``'s indices over the concatenated rows (near ties
    across processes re-ranked in float64), and its distances except for
    a query one side repaired and the other certified."""

    def __init__(self, local_rows, *, k: int, metric: str = "l2",
                 merge: Optional[str] = None,
                 dcn_merge: Optional[str] = None, db_shards: int = 1,
                 train_tile: Optional[int] = None, compute_dtype=None,
                 n_local: Optional[int] = None, mesh: Optional[Mesh] = None,
                 device: DeviceLike = None):
        from knn_tpu_torch.parallel.sharded import ShardedKNN

        local_rows = np.asarray(local_rows)
        self.process_index = process_index()
        self.process_count = process_count()
        if mesh is None:
            mesh = (make_mesh(None, db_shards) if device is None else
                    make_mesh(1, db_shards, devices=[device] * db_shards))
        elif device is not None:
            raise ValueError("pass mesh= or device=, not both")
        if n_local is not None and n_local != local_rows.shape[0]:
            raise ValueError(
                f"n_local={n_local} != local rows {local_rows.shape[0]}; "
                f"pad every process to the same row count first")
        if self.process_count > 1 and dcn_merge is not None \
                and dcn_merge != "allgather":
            # the store exchange ships every list to every process: a
            # ring cannot take effect here, so it is refused, not ignored
            raise ValueError(
                f"MultiHostKNN's store transport is an allgather; "
                f"dcn_merge={dcn_merge!r} cannot take effect (a ring "
                f"across processes needs the in-mesh path, queued)")
        self._local = ShardedKNN(local_rows, mesh=mesh, k=k, metric=metric,
                                 merge=merge, train_tile=train_tile,
                                 compute_dtype=compute_dtype)
        self.n_local = local_rows.shape[0]
        self.row_offset = self.process_index * self.n_local
        self.n_global = self.n_local * self.process_count
        self.k = k
        self.metric = self._local.metric
        if self.process_count > 1:
            self.dcn_merge, self.dcn_merge_source = "allgather", "transport"
            obs.counter(_mn.MERGE_SELECTED, level="dcn",
                        strategy=self.dcn_merge,
                        source=self.dcn_merge_source).inc()
        else:
            self.dcn_merge, self.dcn_merge_source = None, None
        self._instance = next(_INSTANCE_SEQ)
        self._seq = itertools.count()
        dev = self._local.device
        _ident.set_identity(
            process_index=self.process_index,
            process_count=self.process_count,
            device_kind=(torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else None))

    def _local_report(self, wall: float) -> None:
        """One process: no cross-process level, but /statusz still gets a
        fresh report."""
        _update_report(hosts=1, process_index=0, transport="local",
                       dcn_merge=None, dcn_merge_bytes=0,
                       straggler_gap_s=0.0, straggler_host=0,
                       host_walls_s=[round(wall, 6)])

    def _dcn_merge(self, d: np.ndarray, gi: np.ndarray, k: int,
                   local_wall_s: float, tag: str, extra=(),
                   trace_id: Optional[str] = None,
                   t_start: Optional[float] = None):
        """Exchange this process's global-index list (and ``extra``
        arrays), its local wall time and its trace id; merge; record the
        straggler gap (largest minus smallest wall, the slowest process
        named) and the merge bytes; and emit one ``multihost.merge`` span
        under the first non-empty trace id in process order, carrying
        every process's wall — what obs.waterfall.stitch_multihost stitches
        (multihost.py:320-401).  Returns ``(d, gi, info)``."""
        tid_arr = np.frombuffer((trace_id or "").encode("ascii"),
                                dtype=np.uint8)
        lists = dcn_allgather_arrays(
            (d, gi, *extra, tid_arr, np.float64(local_wall_s)), tag=tag)
        walls = [float(rec[-1]) for rec in lists]
        gap = max(walls) - min(walls)
        straggler = int(np.argmax(walls))
        ctid = next(
            (t for t in (bytes(rec[-2].tobytes()).decode("ascii")
                         for rec in lists) if t), None)
        md, mi = merge_topk_host([r[0] for r in lists],
                                 [r[1] for r in lists], k)
        bytes_moved = crossover.merge_bytes(
            d.shape[0], k, self.process_count, "allgather")
        obs.gauge(_mn.MERGE_STRAGGLER_GAP).set(gap)
        obs.counter(_mn.MERGE_BYTES, level="dcn",
                    strategy="allgather").inc(bytes_moved)
        _update_report(
            hosts=self.process_count,
            process_index=self.process_index,
            transport="kv",
            dcn_merge=self.dcn_merge,
            dcn_merge_source=self.dcn_merge_source,
            dcn_merge_bytes=bytes_moved,
            straggler_gap_s=round(gap, 6),
            straggler_host=straggler,
            host_walls_s=[round(w, 6) for w in walls],
            exchange_s=round(_LAST_EXCHANGE.get("seconds", 0.0), 6),
            exchange_bytes=int(_LAST_EXCHANGE.get("bytes", 0)),
        )
        if t_start is not None:
            obs.record_span(
                "multihost.merge", ctid,
                time.perf_counter() - t_start,
                host=self.process_index,
                hosts=self.process_count,
                local_wall_s=round(local_wall_s, 6),
                walls_s=[round(w, 6) for w in walls],
                straggler_host=straggler,
                straggler_gap_s=round(gap, 6),
                tag=tag,
            )
        info = {
            "walls_s": walls,
            "straggler_gap_s": gap,
            "straggler_host": straggler,
            "trace_id": ctid,
            "bytes": bytes_moved,
            "lists": [(rec[0], rec[1]) for rec in lists],
            "extra": [rec[2:-2] for rec in lists],
        }
        return md, mi, info

    def _cross_process_ties(self, lists, k: int, queries, tag: str,
                            return_sqrt: bool):
        """The exact top-k of the processes' certified lists.  Each list is
        exact, but its distances are the device's f32 direct differences
        except where it refined a near tie in float64, so two candidates
        of two processes closer than the rank slack may be merged out of
        order, or across the top-k boundary, by their f32 values (the JAX
        package's host merge keeps them so).  Here the merged list gets the
        rank analysis of the one-placement path (ops.refine.
        rank_correct_runs): adjacent pairs within RANK_SLACK, before the
        first wider gap at or after the boundary, form runs; each process
        scores its own members of every run in float64, a second exchange
        shares them, and each run re-sorts by ``(float64 distance,
        index)``, its members' distances float64.  Returns ``(d, gi,
        corrected query count)``."""
        from knn_tpu_torch.ops.coarse_knn import RANK_SLACK

        cd = np.concatenate([d for d, _ in lists], axis=1)
        ci = np.concatenate([i for _, i in lists], axis=1)
        src = np.concatenate([np.full(i.shape, p) for p, (_, i)
                              in enumerate(lists)], axis=1)
        order = np.lexsort((ci, cd), axis=-1)
        cd, ci, src = (np.take_along_axis(a, order, axis=-1)
                       for a in (cd, ci, src))
        cs = self._local.certify_space(queries, cd, return_sqrt)
        gaps = cs[:, 1:] - cs[:, :-1]
        tight = (gaps <= RANK_SLACK * cs[:, 1:]) & np.isfinite(cs[:, 1:])
        pair = np.arange(tight.shape[1])[None, :]
        big_after = ~tight & (pair >= k - 1)
        if not big_after.any(axis=-1).all():
            raise RuntimeError(
                "a near-tie run spans every exchanged candidate; no "
                "process holds enough of them to certify its top-k")
        stop = np.argmax(big_after, axis=-1)
        use = tight & (pair < stop[:, None])
        inv = np.zeros(cd.shape, dtype=bool)
        inv[:, :-1] |= use
        inv[:, 1:] |= use
        rows, cols = np.nonzero(inv)
        if rows.size == 0:
            return cd[:, :k], ci[:, :k], 0
        mine = src[rows, cols] == self.process_index
        d64 = np.full(rows.size, np.nan)
        d64[mine] = self._local.exact_pair_distances(
            queries, rows[mine], ci[rows, cols][mine] - self.row_offset,
            return_sqrt=return_sqrt)
        # every process scored its own members: share them
        for rec in dcn_allgather_arrays((np.flatnonzero(mine), d64[mine]),
                                        tag=tag + "/ties"):
            d64[rec[0]] = rec[1]
        _add_exchange_to_report()
        cand = ci[rows, cols]
        new_run = np.ones(rows.size, dtype=bool)
        new_run[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1] + 1)
        run = np.cumsum(new_run) - 1
        perm = np.lexsort((cand, d64, run))
        ci[rows, cols] = cand[perm]
        cd[rows, cols] = d64[perm]
        return cd[:, :k], ci[:, :k], int(np.unique(rows).size)

    def search(self, queries, *, k: Optional[int] = None,
               return_sqrt: bool = False, trace_id: Optional[str] = None):
        """Global ``(distances, indices)`` [Q, k] host arrays over every
        process's rows.  ``trace_id`` (minted when absent and telemetry is
        on) crosses the exchange, so the cross-process waterfall stitches
        under one id."""
        k = self.k if k is None else k
        if trace_id is None:
            trace_id = obs.new_trace_id()
        t0 = time.perf_counter()
        d, i = self._local.search(queries, k=k)
        d = d.cpu().numpy()
        gi = i.cpu().numpy().astype(np.int64) + self.row_offset
        wall = time.perf_counter() - t0
        if self.process_count > 1:
            d, gi, _ = self._dcn_merge(
                d, gi, k, wall,
                f"r{self._instance}/search/{next(self._seq)}",
                trace_id=trace_id, t_start=t0)
        else:
            self._local_report(wall)
        if return_sqrt:
            from knn_tpu_torch.ops.distance import metric_values

            d = metric_values(torch.from_numpy(d), self.metric).numpy()
        return d, gi

    def search_certified(self, queries, trace_id: Optional[str] = None,
                         **kwargs):
        """Certified-exact global top-k: each process certifies the exact
        top-k of its rows (every ``search_certified`` knob passes
        through), then the exact per-process lists merge: the merge of
        exact disjoint-block top-k lists is the exact global top-k once
        the near ties across processes are re-ranked in float64
        (:meth:`_cross_process_ties`).  ``stats`` gains ``per_host`` (each
        process's fallback and certified counts and wall), the straggler
        gap and ``cross_process_rank_corrected``."""
        k = self.k
        if kwargs.get("return_distances") is False:
            raise ValueError(
                "MultiHostKNN.search_certified merges on distances; "
                "return_distances=False is not supported")
        if trace_id is None:
            trace_id = obs.new_trace_id()
        t0 = time.perf_counter()
        d, i, stats = self._local.search_certified(queries, **kwargs)
        wall = time.perf_counter() - t0
        gi = np.asarray(i).astype(np.int64) + self.row_offset
        d = np.asarray(d)
        if self.process_count > 1:
            counts = np.asarray(
                [stats.get("fallback_queries", 0),
                 stats.get("certified", 0)], np.int64)
            tag = f"r{self._instance}/certified/{next(self._seq)}"
            _, _, info = self._dcn_merge(d, gi, k, wall, tag,
                                         extra=(counts,), trace_id=trace_id,
                                         t_start=t0)
            d, gi, corrected = self._cross_process_ties(
                info["lists"], k, queries, tag,
                bool(kwargs.get("return_sqrt")))
            stats = dict(stats)
            stats["cross_process_rank_corrected"] = corrected
            stats["per_host"] = {
                "fallback_queries": [int(e[0][0]) for e in info["extra"]],
                "certified": [int(e[0][1]) for e in info["extra"]],
                "walls_s": [round(w, 6) for w in info["walls_s"]],
            }
            stats["straggler_gap_s"] = round(info["straggler_gap_s"], 6)
            stats["straggler_host"] = info["straggler_host"]
        else:
            self._local_report(wall)
        return d, gi, stats

    # -- mutation refusals (knn_tpu_torch.index) -----------------------------
    def _refuse_mutation(self, what: str):
        from knn_tpu_torch.index.artifact import MutationUnsupportedError

        raise MutationUnsupportedError(
            f"{what}: MultiHostKNN spans {self.process_count} process(es) "
            f"with no write replication protocol — a one-process write "
            f"would serve stale results from the others; rebuild the "
            f"replica from the updated corpus, or serve a mutable corpus "
            f"from a one-process MutableIndex")

    def insert(self, vectors=None, ids=None):
        """Refused (see knn_tpu_torch.index for the one-process mutable
        path)."""
        self._refuse_mutation("insert")

    def delete(self, ids=None):
        """Refused (see knn_tpu_torch.index for the one-process mutable
        path)."""
        self._refuse_mutation("delete")


__all__ = [
    "initialize",
    "process_index",
    "process_count",
    "global_mesh",
    "shard_across_hosts",
    "process_row_slice",
    "MultiHostKNN",
    "dcn_allgather_arrays",
    "merge_topk_host",
    "last_report",
]
