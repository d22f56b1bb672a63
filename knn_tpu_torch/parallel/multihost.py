"""Several processes, one database — the port of
knn_tpu/parallel/multihost.py.

The reference scales with ``mpiexec -n N``: every rank is an OS process
(knn_mpi.cpp:123-125).  The JAX package joins one process a host through
``jax.distributed.initialize``; after that its mesh spans every host's
devices and the same SPMD programs run on it (the in-mesh path), and
:class:`MultiHostKNN` trades candidate lists through the coordinator's
key-value store (multihost.py:181-243).  The port has both:

- :func:`initialize` joins the processes through a
  ``torch.distributed.TCPStore`` (process 0 holds it at
  ``coordinator_address``) and, on top of it, a ``torch.distributed``
  process group of an explicit ``backend``: "nccl" (the default for
  processes on cards: one card a process) or "gloo" (the default on the
  CPU; on cards it stages every exchanged tensor through the host, which
  is how two processes share one card).
- **In-mesh**: :func:`global_mesh` / :func:`global_host_mesh` build a
  mesh over every process's devices, in process order, each position
  owned by the process that published the device;
  :func:`shard_across_hosts` places each process's own rows on its own
  positions.  ``ShardedKNN(mesh=)`` runs its programs at this process's
  positions only, and every merge level, exclusion-bound minimum and
  count that combines positions of several processes goes through the
  group (parallel.collectives): every process returns the whole result.
  :func:`last_report` names the transport ``"in_mesh:<backend>"``.
- **Host-mediated**: :class:`MultiHostKNN` searches each process's own
  rows on its own local mesh, and :func:`dcn_allgather_arrays` trades the
  ``[Q, k]`` lists through the store — the JAX package's
  ``key_value_set`` / ``blocking_key_value_get`` / ``wait_at_barrier`` /
  ``key_value_delete`` — merged on the host (:func:`merge_topk_host`) in
  the same lexicographic order; its transport is ``"kv"``.

Both transports are the host and TCP between processes of one machine
here: not NVLink or InfiniBand, and gloo is not NCCL.
"""

from __future__ import annotations

import contextlib
import io
import itertools
import json
import socket
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
from knn_tpu_torch.parallel.collectives import Placed, shard
from knn_tpu_torch.parallel.mesh import (DB_AXIS, HOST_AXIS, QUERY_AXIS,
                                         Mesh, _devices, make_host_mesh,
                                         make_mesh)

#: seconds a store wait, or a collective of the process group, takes
#: before it raises
DEFAULT_TIMEOUT_S = 180.0

#: the process group's transports: one card a process (nccl), or the
#: host (gloo)
BACKENDS = ("nccl", "gloo")

#: the joined runtime: the store, this process's index and the count, the
#: group's backend, the devices each process published
_STATE: dict = {}
_STATE_LOCK = threading.Lock()

#: stores whose group was refused, by address: a second initialize (with
#: another backend) joins through the same store
_STORES: dict = {}


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               timeout_s: float = DEFAULT_TIMEOUT_S,
               backend: Optional[str] = None,
               devices: Optional[Sequence[DeviceLike]] = None) -> None:
    """Join this process to the others (the reference's ``MPI_Init``,
    knn_mpi.cpp:123): a ``TCPStore`` at ``coordinator_address``
    (``"host:port"``), held by process 0, which waits for all
    ``num_processes``, and on top of it a ``torch.distributed`` process
    group of ``backend`` over a ``PrefixStore`` of it, whose collectives
    raise after ``timeout_s`` without a peer.

    ``devices`` are the devices this process drives (default: every
    visible card, or the CPU where none is visible); each process
    publishes them, and their UUIDs, through the store.  ``backend``
    None is "nccl" on cards and "gloo" on the CPU; it is never picked by
    catching an error.  "nccl" on the CPU, or with one card published by
    two processes, is refused by name before the group is made (NCCL
    needs a card a process): ``backend="gloo"`` runs there.  A no-op for
    one process or once joined, so a program can call it
    unconditionally."""
    if num_processes is None or num_processes <= 1:
        return
    with _STATE_LOCK:
        if _STATE:
            return
        if coordinator_address is None or process_id is None:
            raise ValueError(
                "initialize needs coordinator_address and process_id for "
                f"{num_processes} processes")
        pid, n = int(process_id), int(num_processes)
        local = _local_devices(devices)
        if backend is None:
            backend = "nccl" if local[0].type == "cuda" else "gloo"
        if backend not in BACKENDS:
            raise ValueError(
                f"backend {backend!r}: expected one of {BACKENDS}")
        timeout = timedelta(seconds=timeout_s)
        store = _STORES.get(coordinator_address)
        if store is None:
            host, port = coordinator_address.rsplit(":", 1)
            store = torch.distributed.TCPStore(
                host, int(port), world_size=n, is_master=pid == 0,
                timeout=timeout, wait_for_workers=True)
            _STORES[coordinator_address] = store
        # every attempt publishes under its own keys: a refused backend
        # and the next attempt never read each other's
        attempt = store.add(f"knn_tpu/join/attempts/{pid}", 1)
        mine = {"devices": [str(d) for d in local],
                "ids": [_device_id(d) for d in local]}
        store.set(f"knn_tpu/join/{attempt}/{pid}", json.dumps(mine))
        published = []
        for p in range(n):
            key = f"knn_tpu/join/{attempt}/{p}"
            store.wait([key], timeout)
            published.append(json.loads(store.get(key)))
        check_backend(backend, published)
        if backend == "nccl":
            torch.cuda.set_device(local[0])
        torch.distributed.init_process_group(
            backend, store=torch.distributed.PrefixStore(
                f"knn_tpu/group/{attempt}", store),
            rank=pid, world_size=n, timeout=timeout)
        _STORES.pop(coordinator_address, None)
        _STATE.update(store=store, process_index=pid, process_count=n,
                      address=coordinator_address, timeout_s=timeout_s,
                      backend=backend,
                      devices=[p["devices"] for p in published],
                      group_device=(local[0] if backend == "nccl"
                                    else torch.device("cpu")))
    _ident.set_identity(process_count=n,
                        coordinator_address=coordinator_address,
                        process_index=pid)


def _local_devices(devices) -> list:
    """This process's devices: ``devices`` checked, or every visible card,
    or the CPU where no card is visible."""
    if devices is None:
        if torch.cuda.is_available():
            return _devices(None)
        return [torch.device("cpu")]
    return _devices(devices)


def _device_id(dev: torch.device) -> str:
    """A device's identity across processes: a card's UUID, or the CPU of
    this machine."""
    if dev.type == "cuda":
        props = torch.cuda.get_device_properties(dev)
        return f"cuda/{getattr(props, 'uuid', None) or props.name}"
    return f"cpu/{socket.gethostname()}"


def check_backend(backend: str, published: Sequence[dict]) -> None:
    """Refuses, by name, a ``backend`` its processes' devices cannot run:
    ``published`` holds each process's ``{"devices": [...], "ids":
    [...]}`` in process order.  "nccl" needs cards, and a card of its own
    for each process; "gloo" runs anywhere."""
    if backend != "nccl":
        return
    for p, pub in enumerate(published):
        if any(not d.startswith("cuda") for d in pub["devices"]):
            raise ValueError(
                f"backend='nccl' runs on cards; process {p} drives "
                f"{pub['devices']}: pass backend='gloo' on the CPU")
    seen: dict = {}
    for p, pub in enumerate(published):
        for d, uid in zip(pub["devices"], pub["ids"]):
            other = seen.setdefault(uid, (p, d))
            if other[0] != p:
                raise ValueError(
                    f"backend='nccl' cannot run two processes on one card: "
                    f"process {other[0]}'s {other[1]} and process {p}'s {d} "
                    f"are the same card ({uid}), and NCCL needs a card a "
                    f"process; pass backend='gloo', which stages the "
                    f"exchanged tensors through the host")


def shutdown() -> None:
    """Leaves the process group (the reference's ``MPI_Finalize``); the
    store goes with the state.  A no-op when not joined."""
    with _STATE_LOCK:
        if not _STATE:
            return
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        _STATE.clear()


def process_index() -> int:
    return _STATE.get("process_index", 0)


def process_count() -> int:
    return _STATE.get("process_count", 1)


def backend() -> Optional[str]:
    """The process group's backend; None in one process."""
    return _STATE.get("backend")


def group_device() -> torch.device:
    """Where tensors cross processes: the CPU under gloo, this process's
    card under nccl."""
    if "backend" not in _STATE:
        raise RuntimeError(
            "no process group: call multihost.initialize(...) with the "
            "process count first")
    return _STATE["group_device"]


def all_gather_object(obj) -> list:
    """``obj`` (a small picklable host object) of every process, in
    process order, through the calling thread's group
    (:func:`group_scope`); every process of the group calls it."""
    out = [None] * process_count()
    torch.distributed.all_gather_object(out, obj, group=current_pg())
    count_collective()
    return out


def broadcast_object(obj, src: int = 0):
    """Process ``src``'s ``obj`` (a small picklable host object) in every
    process, through the calling thread's group; every process calls it
    (the others' ``obj`` is ignored)."""
    box = [obj]
    torch.distributed.broadcast_object_list(box, src=src, group=current_pg())
    count_collective()
    return box[0]


def max_over_processes(values: Sequence[float]) -> List[float]:
    """The elementwise maximum of every process's float64 ``values`` (one
    ``all_reduce``), the same floats in every process."""
    t = torch.tensor([float(v) for v in values], dtype=torch.float64,
                     device=group_device())
    torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX,
                                 group=current_pg())
    count_collective()
    return t.cpu().tolist()


def all_gather_ints(values: Sequence[int]) -> np.ndarray:
    """Every process's int ``values`` (one ``all_gather``): an int64 array
    ``[process_count, len(values)]`` in process order, the same in every
    process."""
    t = torch.tensor([int(v) for v in values], dtype=torch.int64,
                     device=group_device())
    out = [torch.empty_like(t) for _ in range(process_count())]
    torch.distributed.all_gather(out, t, group=current_pg())
    count_collective()
    return torch.stack(out).cpu().numpy()


# -- process groups of one thread's collectives -------------------------------

class Group:
    """A process group over every process of the joined group, made by
    :func:`new_group` at the same point of every process's call sequence.
    A thread that issues collectives beside another thread's (a tier's
    background compaction beside its readers) runs them on a group of its
    own inside :func:`group_scope`, so the two threads' collectives never
    pair with each other across processes.  ``tag`` names it in
    :func:`collective_counts`."""

    def __init__(self, pg, tag: str):
        self.pg = pg
        self.tag = tag

    def __repr__(self) -> str:
        return f"Group({self.tag!r})"


def new_group(tag: str) -> Optional[Group]:
    """A new :class:`Group` of every process (``torch.distributed.
    new_group`` with the joined group's backend and timeout); None in one
    process.  Every process calls it, in the same order as every other
    collective."""
    if process_count() == 1:
        return None
    pg = torch.distributed.new_group(
        list(range(process_count())), backend=_STATE["backend"],
        timeout=timedelta(seconds=_STATE["timeout_s"]))
    return Group(pg, tag)


#: the group each thread's collectives run on (None: the default group)
_THREAD_GROUP = threading.local()


@contextlib.contextmanager
def group_scope(group: Optional[Group]):
    """Runs the calling thread's collectives inside on ``group`` (None:
    the default group)."""
    prev = getattr(_THREAD_GROUP, "group", None)
    _THREAD_GROUP.group = group
    try:
        yield
    finally:
        _THREAD_GROUP.group = prev


def current_group() -> Optional[Group]:
    """The calling thread's group (None: the default group)."""
    return getattr(_THREAD_GROUP, "group", None)


def current_pg():
    """The ``torch.distributed`` process group of the calling thread's
    collectives (None: the default group)."""
    group = current_group()
    return None if group is None else group.pg


#: collectives issued, by (thread name, group tag): what a test reads to
#: show that a thread kept to its own group
_COLLECTIVES: dict = {}


def count_collective() -> None:
    """One collective issued by the calling thread on its group
    (parallel.collectives counts each)."""
    group = current_group()
    key = (threading.current_thread().name,
           "default" if group is None else group.tag)
    with _REPORT_LOCK:
        _COLLECTIVES[key] = _COLLECTIVES.get(key, 0) + 1


def collective_counts(reset: bool = False) -> dict:
    """``{"<thread name>|<group tag>": collectives}`` since the last
    reset (``reset=True`` clears the counts after reading them)."""
    with _REPORT_LOCK:
        out = {f"{t}|{g}": n for (t, g), n in sorted(_COLLECTIVES.items())}
        if reset:
            _COLLECTIVES.clear()
    return out


def _global_devices(devices) -> Tuple[list, list]:
    """``(devices, owners)``: every process's devices in process order,
    each with its process — ``devices`` this process's (None: the ones it
    published at :func:`initialize`), every other process's as it passed
    them to the same call."""
    if devices is None:
        lists = _STATE["devices"]
    else:
        lists = all_gather_object([str(d) for d in _devices(devices)])
    flat, owners = [], []
    for p, lst in enumerate(lists):
        flat += lst
        owners += [p] * len(lst)
    return flat, owners


def _require_every_process(mesh: Mesh, what: str) -> Mesh:
    missing = sorted(set(range(process_count()))
                     - {int(o) for o in mesh.owners.flat})
    if missing:
        raise ValueError(
            f"{what}: {mesh.size} positions leave process(es) {missing} "
            f"without a position; every process drives at least one")
    return mesh


def global_mesh(query_shards: Optional[int] = None, db_shards: int = 1, *,
                devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """The (query, db) mesh over every device of every process, in
    process order — the reference's ``MPI_COMM_WORLD``
    (knn_mpi.cpp:124-125), the JAX package's ``make_mesh(...,
    devices=jax.devices())`` (multihost.py:89-94).  ``query_shards=None``
    spreads every device left after ``db_shards`` over the query axis.
    ``devices`` are this process's (None: those it published at
    :func:`initialize`); a repeated device makes logical positions.
    Every process calls it with the same shape; each position is owned
    by the process whose device it is.  In one process: make_mesh."""
    if process_count() == 1:
        return make_mesh(query_shards, db_shards, devices=devices)
    devs, owners = _global_devices(devices)
    return _require_every_process(
        make_mesh(query_shards, db_shards, devices=devs, owners=owners,
                  rank=process_index()), "global_mesh")


def global_host_mesh(query_shards: Optional[int] = None,
                     db_hosts: Optional[int] = None, db_shards: int = 1, *,
                     devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """The hierarchical ``(query, host, db)`` mesh (parallel.mesh.
    make_host_mesh) over every process's devices, in process order, with
    the host axis the process axis (``db_hosts`` None: the process
    count), as the JAX package's ``db_hosts = jax.process_count()``
    (knn_tpu/parallel/mesh.py:75): each host's ``db_shards`` positions
    belong to one process, whose lists merge on its own devices before
    the host level crosses processes."""
    if process_count() == 1:
        return make_host_mesh(query_shards, db_hosts or 1, db_shards,
                              devices=devices)
    devs, owners = _global_devices(devices)
    mesh = make_host_mesh(query_shards, db_hosts or process_count(),
                          db_shards, devices=devs, owners=owners,
                          rank=process_index())
    own = mesh.owners
    for r in range(mesh.shape[QUERY_AXIS]):
        for h in range(mesh.shape[HOST_AXIS]):
            if len(set(own[r, h].tolist())) > 1:
                raise ValueError(
                    f"global_host_mesh: host {h} of query shard {r} spans "
                    f"processes {sorted(set(own[r, h].tolist()))}; the host "
                    f"axis is the process axis: give db_shards the "
                    f"positions of one process")
    return _require_every_process(mesh, "global_host_mesh")


def shard_across_hosts(local_rows, mesh: Mesh, axis_name=DB_AXIS):
    """This process's rows placed over ``mesh`` along ``axis_name`` (a
    name or a tuple of names, major first) — the multi-host
    ``MPI_Scatter`` (knn_mpi.cpp:226-227) with no root, the JAX package's
    ``make_array_from_process_local_data`` (multihost.py:97-137).  The
    global rows are every process's ``local_rows`` concatenated in
    process order (``local_rows.shape[0] * process_count`` of them; pad
    every process to the same count first, and give ``ShardedKNN(...,
    n_train=)`` the real count).  Returns a
    :class:`~knn_tpu_torch.parallel.collectives.Placed` whose positions of
    this process hold blocks of its own rows and whose other positions
    are remote (None).  The axis size must be a multiple of the process
    count, and each process's positions must hold its own rows.  In one
    process: parallel.collectives.shard."""
    local_rows = np.asarray(local_rows)
    pc = process_count()
    names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    axis_size = int(np.prod([mesh.shape[a] for a in names]))
    if axis_size % pc:
        raise ValueError(
            f"mesh axis {axis_name!r} (size {axis_size}) must be a multiple "
            f"of process_count={pc} to scatter rows across hosts; with fewer "
            "shards than processes the array would be replicated and every "
            "host would need the full matrix")
    if pc == 1 or not mesh.spans_processes:
        return shard(local_rows, mesh, axis_name)
    n_local = local_rows.shape[0]
    per_process = axis_size // pc
    if n_local % per_process:
        raise ValueError(
            f"{n_local} local rows do not divide into the {per_process} "
            f"blocks a process holds on axis {axis_name!r}; pad first")
    per = n_local // per_process
    pid = process_index()
    idx = [mesh.axis_names.index(a) for a in names]
    sizes = [mesh.shape[a] for a in names]
    parts = np.empty(mesh.devices.shape, dtype=object)
    copies: dict = {}
    for pos in mesh.local_positions:
        j = int(np.ravel_multi_index([pos[i] for i in idx], sizes))
        lo = j * per - pid * n_local
        if not 0 <= lo <= n_local - per:
            raise ValueError(
                f"shard_across_hosts: position {pos} of process {pid} holds "
                f"global rows {j * per}..{(j + 1) * per - 1}, which are "
                f"process {j * per // n_local}'s; each process's positions "
                f"must hold its own rows")
        dev = mesh.devices[pos]
        key = (j, str(dev))
        if key not in copies:
            copies[key] = torch.from_numpy(
                np.ascontiguousarray(local_rows[lo:lo + per])).to(dev)
        parts[pos] = copies[key]
    return Placed(mesh, parts, axis_name, 0,
                  (n_local * pc, *local_rows.shape[1:]))


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


#: the cross-process exchanges of the calling thread's in-mesh call in
#: progress (this process's view), and how deep its calls nest: a
#: thread's own, so a background compaction's calls never mix into a
#: reader's report
_IN_MESH = threading.local()


def _in_mesh() -> threading.local:
    if not hasattr(_IN_MESH, "depth"):
        _IN_MESH.depth, _IN_MESH.log = 0, []
    return _IN_MESH


def record_exchange(op: str, nbytes: int, seconds: float) -> None:
    """One cross-process exchange of an in-mesh call: the collective
    (``all_gather``, ``all_reduce``, ``send`` / ``recv``), the bytes every
    process put into it, and its seconds on this process's clock, host
    staging included (parallel.collectives records each).  Outside an
    in-mesh call it is only counted (:func:`count_collective`)."""
    count_collective()
    state = _in_mesh()
    if state.depth:
        state.log.append({"op": op, "bytes": int(nbytes),
                          "s": float(seconds)})


def begin_in_mesh_call() -> None:
    """An in-mesh call on a mesh that spans processes starts; a call made
    inside it (the fallback repair's select, a mesh program) adds to its
    exchanges."""
    state = _in_mesh()
    if state.depth == 0:
        state.log = []
    state.depth += 1


def finish_in_mesh_call(*, dcn_merge: Optional[str],
                        dcn_merge_source: Optional[str],
                        dcn_merge_bytes: int) -> None:
    """The outermost in-mesh call ends: its report — the transport
    ``"in_mesh:<backend>"``, the strategy and modeled bytes of the merge
    level that crosses processes, and the seconds and bytes of its
    exchanges (``exchange_log`` one entry each) — becomes
    :func:`last_report`."""
    state = _in_mesh()
    state.depth -= 1
    if state.depth:
        return
    log = list(state.log)
    _update_report(
        hosts=process_count(), process_index=process_index(),
        thread=threading.current_thread().name,
        transport=f"in_mesh:{backend()}", dcn_merge=dcn_merge,
        dcn_merge_source=dcn_merge_source,
        dcn_merge_bytes=int(dcn_merge_bytes), straggler_gap_s=None,
        straggler_host=None, host_walls_s=[], exchanges=len(log),
        exchange_s=round(sum(e["s"] for e in log), 6),
        exchange_bytes=int(sum(e["bytes"] for e in log)),
        exchange_log=log)


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
                f"dcn_merge={dcn_merge!r} cannot take effect: a ring "
                f"across processes runs in the mesh, ShardedKNN(rows, "
                f"mesh=global_host_mesh(...), dcn_merge={dcn_merge!r})")
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
    "BACKENDS",
    "initialize",
    "shutdown",
    "check_backend",
    "process_index",
    "process_count",
    "backend",
    "group_device",
    "global_mesh",
    "global_host_mesh",
    "shard_across_hosts",
    "process_row_slice",
    "MultiHostKNN",
    "dcn_allgather_arrays",
    "merge_topk_host",
    "last_report",
]
