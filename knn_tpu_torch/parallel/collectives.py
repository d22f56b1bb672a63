"""The reference's MPI collective surface (SURVEY.md §2.8) over a mesh of
torch devices — the port of knn_tpu/parallel/collectives.py.

Two levels, as in the JAX package:

- **Placement collectives** (:func:`replicate`, :func:`shard`): the
  Bcast / Scatter of knn_mpi.cpp:224-227 are placements.  Each returns a
  :class:`Placed`: one block per mesh position, copied to its device
  once (positions on one device share one copy of one block).
- **Compute collectives** over per-shard tensors, one tensor a
  participant on that participant's device: :func:`gather` (MPI_Gather,
  knn_mpi.cpp:340,383), :func:`allreduce_min` / :func:`allreduce_max`
  (the Allreduce MIN / MAX of knn_mpi.cpp:276-277), :func:`allreduce_sum`,
  and their rooted forms :func:`reduce_min` / :func:`reduce_max` /
  :func:`reduce_sum` (one result on one device: what a single controller
  that reads one position's result needs).  Each is a set of
  device-to-device copies (``tensor.to(device, non_blocking=True)``)
  followed by the reduction on the receiving device; nothing waits for
  the host.

On a mesh that spans processes (parallel.multihost.global_mesh) the
participants belong to processes: ``owners`` names each one's process, a
remote participant is None here, and ``like`` gives the ``(shape,
dtype)`` of one participant's tensor (a process may hold none of them).
A collective whose participants belong to several processes crosses
them through the ``torch.distributed`` process group, and every process
of the group calls it, in the same order: :func:`gather` as one
``all_gather`` (:func:`exchange`), the reductions as one ``all_reduce``
of each process's own partial result (the identity where it holds
none), :func:`send_recv` as a ``send`` / ``recv`` pair.  Exchanged
tensors sit on the group's device (multihost.group_device: the CPU under
gloo, the process's card under nccl) and land on ``device``; every
process ends with the same result.  Participants of one other process
are that process's alone: here the collective returns None.  Each
exchange's bytes and seconds go to multihost.record_exchange.  A thread
inside multihost.group_scope runs its collectives on that group (a
tier's background compaction beside its readers).

:func:`barrier` is the timing fence of knn_mpi.cpp:133-134: CUDA work is
asynchronous, so a wall clock without it measures the enqueue; over a
placement that spans processes it also waits for every process
(``torch.distributed.barrier``).

The JAX package's ``shard_map_compat`` has no counterpart: it wraps
``jax.shard_map`` across an API move, and the port's per-shard programs
are plain Python loops over the mesh (parallel.sharded).  The measured
merge crossover is re-exported from parallel.crossover, as the JAX
package re-exports it here.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from knn_tpu_torch.parallel.crossover import (  # noqa: F401  (re-export)
    MEASURED_CROSSOVER,
    choose_merge,
    merge_bytes,
    resolve_merge,
)
from knn_tpu_torch.parallel.mesh import Mesh


class Placed:
    """A global array placed over ``mesh``: ``parts`` is an object array
    of the mesh's shape, each position the block its device holds (None
    at a position another process drives); ``spec`` the sharded mesh
    axes (None: replicated) and ``axis`` the array axis they split;
    ``shape`` the global shape."""

    def __init__(self, mesh: Mesh, parts: np.ndarray, spec, axis: int,
                 shape: tuple):
        self.mesh = mesh
        self.parts = parts
        self.spec = spec
        self.axis = axis
        self.shape = tuple(shape)

    def _positions(self, index: int) -> list:
        """The mesh positions that hold block ``index``, in grid order."""
        names = self._names()
        if not names:
            return list(np.ndindex(*self.mesh.devices.shape))
        sizes = [self.mesh.shape[a] for a in names]
        coord = np.unravel_index(index, sizes)
        fixed = {self.mesh.axis_names.index(a): c
                 for a, c in zip(names, coord)}
        return [pos for pos in np.ndindex(*self.mesh.devices.shape)
                if all(pos[i] == c for i, c in fixed.items())]

    def block(self, index: int) -> torch.Tensor:
        """The ``index``-th block along the sharded axes (the whole array
        when replicated), from its first position this process drives.
        A block that lies only on other processes' positions raises."""
        positions = self._positions(index)
        for pos in positions:
            if self.mesh.is_local(pos):
                return self.parts[pos]
        raise ValueError(
            f"block {index} of this placement lies on process(es) "
            f"{sorted({int(self.mesh.owners[p]) for p in positions})}: a "
            f"remote block has no tensor in process {self.mesh.rank}")

    def _names(self) -> tuple:
        if self.spec is None:
            return ()
        return (self.spec,) if isinstance(self.spec, str) else tuple(self.spec)

    @property
    def n_blocks(self) -> int:
        return int(np.prod([self.mesh.shape[a] for a in self._names()]))

    def gather(self, device=None) -> torch.Tensor:
        """The global array on ``device`` (None: the CPU); over processes
        every block crosses from the first process holding it (one
        ``all_gather``), and every process gets the whole array."""
        device = torch.device("cpu") if device is None else device
        blocks = range(self.n_blocks)
        if not self.mesh.spans_processes:
            return gather([self.block(j) for j in blocks], device,
                          axis=self.axis)
        owners = [int(self.mesh.owners[self._positions(j)[0]])
                  for j in blocks]
        shape = list(self.shape)
        shape[self.axis] //= self.n_blocks
        dtype = next(p for p in self.parts.flat if p is not None).dtype
        parts = [self.block(j) if o == self.mesh.rank else None
                 for j, o in zip(blocks, owners)]
        return gather(parts, device, axis=self.axis, owners=owners,
                      like=(tuple(shape), dtype))


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _place(blocks: List[torch.Tensor], mesh: Mesh, block_of) -> np.ndarray:
    """Object array of the mesh's shape: position p holds block
    ``block_of(p)`` on p's device, one copy per (block, device); on a mesh
    that spans processes only this process's positions (the others None),
    so a process moves only its own blocks to its devices."""
    parts = np.empty(mesh.devices.shape, dtype=object)
    copies = {}
    for pos in np.ndindex(*mesh.devices.shape):
        if not mesh.is_local(pos):  # another process places its own
            continue
        dev = mesh.devices[pos]
        j = block_of(pos)
        key = (j, str(dev))
        if key not in copies:
            copies[key] = blocks[j].to(dev, non_blocking=True)
        parts[pos] = copies[key]
    return parts


def replicate(x, mesh: Mesh) -> Placed:
    """MPI_Bcast (knn_mpi.cpp:224-225): one copy of ``x`` on every device."""
    t = _as_tensor(x)
    return Placed(mesh, _place([t], mesh, lambda pos: 0), None, 0, t.shape)


def shard(x, mesh: Mesh, axis_name: Union[str, Sequence[str]],
          axis: int = 0) -> Placed:
    """MPI_Scatter (knn_mpi.cpp:226-227): ``x`` split along ``axis`` over
    the mesh axis ``axis_name`` (or axes, major first), each block
    replicated along the other mesh axes.  The size must divide the
    axis; callers pad first (mesh.pad_to_multiple)."""
    t = _as_tensor(x)
    names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    sizes = [mesh.shape[a] for a in names]
    n_blocks = int(np.prod(sizes))
    if t.shape[axis] % n_blocks:
        raise ValueError(
            f"axis {axis} of size {t.shape[axis]} does not divide into "
            f"{n_blocks} shards; pad first")
    blocks = list(torch.chunk(t, n_blocks, dim=axis))
    idx = [mesh.axis_names.index(a) for a in names]

    def block_of(pos):
        return int(np.ravel_multi_index([pos[i] for i in idx], sizes))

    return Placed(mesh, _place(blocks, mesh, block_of), axis_name, axis,
                  t.shape)


def _group():
    """The joined process group's module (parallel.multihost), its
    process index and count, the device tensors cross on and the calling
    thread's process group (multihost.group_scope; None: the default)."""
    from knn_tpu_torch.parallel import multihost

    return (multihost, multihost.process_index(), multihost.process_count(),
            multihost.group_device(), multihost.current_pg())


def _crosses(owners) -> bool:
    """Whether participants of ``owners`` belong to several processes."""
    return owners is not None and len(set(int(o) for o in owners)) > 1


def _elsewhere(owners) -> bool:
    """Whether every participant belongs to one other process."""
    if owners is None or _crosses(owners):
        return False
    from knn_tpu_torch.parallel import multihost

    return int(owners[0]) != multihost.process_index()


def _wire(dtype: torch.dtype) -> torch.dtype:
    # bool crosses as uint8 (not every backend reduces or gathers bool)
    return torch.uint8 if dtype == torch.bool else dtype


def exchange(items: Sequence[Optional[tuple]], owners: Sequence[int],
             like: Sequence[Optional[tuple]], device) -> List[tuple]:
    """Every participant's tensors in every process: ``items`` one tuple
    a participant (None where another process owns it), ``owners`` its
    process, ``like`` each tuple entry's ``(shape, dtype)`` (None: an
    entry every participant leaves None).  Each process stacks its own
    participants' entries, one ``all_gather`` an entry crosses them, and
    every participant's tuple comes back, another process's on
    ``device``.  Every process of the group calls it."""
    mh, me, world, wire, pg = _group()
    owners = [int(o) for o in owners]
    mine = [s for s, o in enumerate(owners) if o == me]
    n_max = max(owners.count(p) for p in range(world))
    out = [list(items[s]) if o == me else [None] * len(like)
           for s, o in enumerate(owners)]
    t0 = time.perf_counter()
    nbytes = 0
    for t, spec in enumerate(like):
        if spec is None:
            continue
        shape, dtype = tuple(spec[0]), spec[1]
        buf = torch.zeros((n_max, *shape), dtype=_wire(dtype), device=wire)
        for b, s in enumerate(mine):
            buf[b].copy_(items[s][t])
        bufs = [torch.empty_like(buf) for _ in range(world)]
        torch.distributed.all_gather(bufs, buf, group=pg)
        nbytes += buf.nbytes * world
        seen = [0] * world
        for s, o in enumerate(owners):
            b, seen[o] = seen[o], seen[o] + 1
            if o != me:
                out[s][t] = bufs[o][b].to(device=device, dtype=dtype)
    mh.record_exchange("all_gather", nbytes, time.perf_counter() - t0)
    return [tuple(x) for x in out]


def send_recv(tensors: Optional[tuple], src: int, dst: int, like, device
              ) -> Optional[tuple]:
    """One hop of a ring across processes: process ``src`` sends
    ``tensors`` (entries shaped as ``like``) to process ``dst``, which
    receives them on ``device``.  Returns the received tuple on ``dst``,
    None on every other process (which does nothing)."""
    mh, me, _, wire, pg = _group()
    if me not in (src, dst):
        return None
    t0 = time.perf_counter()
    nbytes = 0
    out = []
    for t, (shape, dtype) in enumerate(like):
        if me == src:
            buf = tensors[t].to(device=wire, dtype=_wire(dtype)).contiguous()
            torch.distributed.send(buf, dst, group=pg)
        else:
            buf = torch.empty(tuple(shape), dtype=_wire(dtype), device=wire)
            torch.distributed.recv(buf, src, group=pg)
            out.append(buf.to(device=device, dtype=dtype))
        nbytes += buf.nbytes
    mh.record_exchange("send" if me == src else "recv", nbytes,
                       time.perf_counter() - t0)
    return None if me == src else tuple(out)


def gather(parts: Sequence[Optional[torch.Tensor]], device, *, axis: int = 0,
           tiled: bool = True, owners: Optional[Sequence[int]] = None,
           like: Optional[tuple] = None) -> Optional[torch.Tensor]:
    """MPI_Gather (knn_mpi.cpp:340,383): every part copied to ``device``
    and joined along ``axis`` (``tiled``) or stacked on a new leading
    axis of one entry a part.  Over processes (``owners``, ``like``:
    module docstring) every process gets the whole result."""
    if _elsewhere(owners):
        return None
    if _crosses(owners):
        parts = [t[0] for t in exchange(
            [None if p is None else (p,) for p in parts], owners, [like],
            device)]
    moved = [p.to(device, non_blocking=True) for p in parts]
    return torch.cat(moved, dim=axis) if tiled else torch.stack(moved)


def _reduce(parts, device, op, owners=None, like=None, name=None):
    if _elsewhere(owners):
        return None
    if not _crosses(owners):
        acc = None
        for q in parts:
            q = q.to(device, non_blocking=True)
            acc = q if acc is None else op(acc, q)
        return acc
    mh, me, _, wire, pg = _group()
    shape, dtype = tuple(like[0]), like[1]
    acc = None
    for q, o in zip(parts, owners):
        if int(o) == me:
            # a copy: the all_reduce below writes into it
            q = q.to(wire, _wire(dtype), copy=True)
            acc = q if acc is None else op(acc, q)
    if acc is None:  # this process holds no participant: the identity
        acc = torch.full(shape, _IDENTITY[name](_wire(dtype)),
                         dtype=_wire(dtype), device=wire)
    acc = acc.contiguous()
    t0 = time.perf_counter()
    torch.distributed.all_reduce(acc, op=getattr(
        torch.distributed.ReduceOp, name), group=pg)
    mh.record_exchange("all_reduce", acc.nbytes * mh.process_count(),
                       time.perf_counter() - t0)
    return acc.to(device=device, dtype=dtype)


def _extreme(dtype: torch.dtype, high: bool):
    if dtype.is_floating_point:
        return float("inf") if high else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if high else info.min


#: the reductions' identities: what a process that holds no participant
#: contributes
_IDENTITY = {"MIN": lambda dt: _extreme(dt, True),
             "MAX": lambda dt: _extreme(dt, False),
             "SUM": lambda dt: 0}


def _allreduce(parts, op, owners=None, like=None, name=None):
    if not _crosses(owners):
        if _elsewhere(owners):
            return [None] * len(parts)
        return [_reduce(parts, p.device, op) for p in parts]
    from knn_tpu_torch.parallel import multihost

    me = multihost.process_index()
    here = [p for p, o in zip(parts, owners) if int(o) == me]
    dev = here[0].device if here else multihost.group_device()
    total = _reduce(parts, dev, op, owners, like, name)
    return [total.to(p.device) if int(o) == me else None
            for p, o in zip(parts, owners)]


def reduce_min(parts, device, *, owners=None, like=None):
    """MPI_Reduce(MPI_MIN) to ``device``: the elementwise minimum, once
    (over processes: an ``all_reduce``, the result in every process)."""
    return _reduce(parts, device, torch.minimum, owners, like, "MIN")


def reduce_max(parts, device, *, owners=None, like=None):
    """MPI_Reduce(MPI_MAX) to ``device``."""
    return _reduce(parts, device, torch.maximum, owners, like, "MAX")


def reduce_sum(parts, device, *, owners=None, like=None):
    """MPI_Reduce(MPI_SUM) to ``device``, in participant order (over
    processes each process's partial sum, then the group's: exact for
    the integer counts it serves)."""
    return _reduce(parts, device, torch.add, owners, like, "SUM")


def allreduce_min(parts, *, owners=None, like=None) -> List[torch.Tensor]:
    """MPI_Allreduce(MPI_MIN) (knn_mpi.cpp:277): the elementwise minimum
    on every participant's device (None at a remote participant)."""
    return _allreduce(parts, torch.minimum, owners, like, "MIN")


def allreduce_max(parts, *, owners=None, like=None) -> List[torch.Tensor]:
    """MPI_Allreduce(MPI_MAX) (knn_mpi.cpp:276)."""
    return _allreduce(parts, torch.maximum, owners, like, "MAX")


def allreduce_sum(parts, *, owners=None, like=None) -> List[torch.Tensor]:
    """MPI_Allreduce(MPI_SUM), in participant order on every device (the
    JAX package's ``lax.psum``; integer sums are exact in any order)."""
    return _allreduce(parts, torch.add, owners, like, "SUM")


def barrier(*arrays) -> None:
    """MPI_Barrier before MPI_Wtime (knn_mpi.cpp:133-134, 395-396): wait
    until the work that makes every listed tensor (or :class:`Placed`)
    has finished on its device."""
    devices: list = []
    spans = False
    for a in arrays:
        ts = a.parts.flat if isinstance(a, Placed) else [a]
        spans = spans or (isinstance(a, Placed) and a.mesh.spans_processes)
        for t in ts:
            if isinstance(t, torch.Tensor) and t.device.type == "cuda" \
                    and t.device not in devices:
                devices.append(t.device)
    for d in devices:
        torch.cuda.synchronize(d)
    if spans:
        from knn_tpu_torch.parallel import multihost

        torch.distributed.barrier(group=multihost.current_pg())
        multihost.count_collective()


__all__ = [
    "Placed",
    "replicate",
    "shard",
    "gather",
    "exchange",
    "send_recv",
    "allreduce_min",
    "allreduce_max",
    "allreduce_sum",
    "reduce_min",
    "reduce_max",
    "reduce_sum",
    "barrier",
    "MEASURED_CROSSOVER",
    "choose_merge",
    "merge_bytes",
    "resolve_merge",
]
