"""Device meshes — the port of knn_tpu/parallel/mesh.py.

The JAX package's mesh is a ``jax.sharding.Mesh``: a grid of devices with
named axes, over which its SPMD programs shard queries (``QUERY_AXIS``)
and database rows (``DB_AXIS``, and on a hierarchical mesh ``HOST_AXIS``
before it).  The port's :class:`Mesh` is the same grid as a numpy object
array of ``torch.device`` s with the same axis names; one process drives
every device of it (parallel.sharded enqueues each shard's work on its
own device's current stream) and processes join through a store
(parallel.multihost).

Where the port differs (ROADMAP queue C): a mesh may name one device
more than once (``devices=[torch.device("cuda:0")] * 4`` or ``["cpu"] *
8``).  Such a *logical* mesh runs every shard's program on the same
device one after another: the port's counterpart of the JAX harness's
virtual CPU devices.  It shows the merge tree and the per-shard programs;
it shows no overlap and no interconnect.  A mesh whose devices mix the CPU
and CUDA raises.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from knn_tpu_torch.device import resolve_device

QUERY_AXIS = "query"
DB_AXIS = "db"
#: the cross-host axis of a hierarchical mesh (make_host_mesh): db rows
#: shard over (HOST_AXIS, DB_AXIS), host-major, so each host's contiguous
#: row block subdivides across its own devices; merges go per device ->
#: per host (DB_AXIS), then per host -> global (HOST_AXIS)
HOST_AXIS = "host"


class Mesh:
    """A grid of devices with named axes — ``devices`` an object array of
    ``torch.device`` s, ``axis_names`` one name per array axis.
    ``shape`` maps each name to its size, as ``jax.sharding.Mesh.shape``
    does; ``size`` is the number of grid positions."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(
                f"{devices.ndim}-d device grid for axes {axis_names}")
        types = {d.type for d in devices.flat}
        if len(types) > 1:
            raise ValueError(
                f"a mesh holds devices of one type; this one mixes "
                f"{sorted(types)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))
        self.size = int(devices.size)

    @property
    def distinct_devices(self) -> list:
        """The mesh's devices, each once, in grid order."""
        seen = []
        for d in self.devices.flat:
            if d not in seen:
                seen.append(d)
        return seen

    @property
    def logical(self) -> bool:
        """Whether a device stands at more than one grid position."""
        return len(self.distinct_devices) < self.size

    def _key(self):
        return (self.axis_names, self.devices.shape,
                tuple(str(d) for d in self.devices.flat))

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        shape = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"Mesh({shape}; {', '.join(map(str, self.distinct_devices))})"


def _devices(devices: Optional[Sequence]) -> list:
    """``devices`` resolved to ``torch.device`` s (each checked as
    knn_tpu_torch.device checks one); None = every visible card, raising
    without a GPU."""
    if devices is None:
        resolve_device(None)  # raises without a GPU
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    out = []
    for d in devices:
        d = resolve_device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        out.append(d)
    if not out:
        raise ValueError("a mesh needs at least one device")
    return out


def make_mesh(query_shards: Optional[int] = None, db_shards: int = 1, *,
              devices: Optional[Sequence] = None) -> Mesh:
    """A 2-D :class:`Mesh` with axes ``(QUERY_AXIS, DB_AXIS)``.

    ``query_shards=None`` takes every device left after ``db_shards``.  A
    one-device mesh (1, 1) runs ShardedKNN's one-device programs; every
    other mesh runs its mesh programs, one one-device placement a shard.
    ``devices`` defaults to the visible cards; a list that repeats a
    device makes a logical mesh (module docstring)."""
    devices = _devices(devices)
    n = len(devices)
    if db_shards < 1:
        raise ValueError(f"db_shards={db_shards} must be >= 1")
    if query_shards is None:
        if n % db_shards:
            raise ValueError(
                f"{n} devices not divisible by db_shards={db_shards}")
        query_shards = n // db_shards
    need = query_shards * db_shards
    if need > n:
        raise ValueError(
            f"mesh {query_shards}x{db_shards} needs {need} devices, have {n}")
    grid = np.empty(need, dtype=object)
    grid[:] = devices[:need]
    return Mesh(grid.reshape(query_shards, db_shards), (QUERY_AXIS, DB_AXIS))


def make_host_mesh(query_shards: Optional[int] = None, db_hosts: int = 1,
                   db_shards: int = 1, *,
                   devices: Optional[Sequence] = None) -> Mesh:
    """A 3-D hierarchical :class:`Mesh` with axes ``(QUERY_AXIS,
    HOST_AXIS, DB_AXIS)``: database rows shard over hosts (major), then
    over each host's devices (minor).  In one process the host axis is a
    fold of the local devices: the same programs and merge tree, bitwise
    the flat mesh's result.  Processes on other hosts join through
    parallel.multihost instead."""
    devices = _devices(devices)
    n = len(devices)
    if db_hosts < 1 or db_shards < 1:
        raise ValueError(
            f"db_hosts={db_hosts} and db_shards={db_shards} must be >= 1")
    per_q = db_hosts * db_shards
    if query_shards is None:
        if n % per_q:
            raise ValueError(
                f"{n} devices not divisible by db_hosts*db_shards={per_q}")
        query_shards = n // per_q
    need = query_shards * per_q
    if need > n:
        raise ValueError(
            f"mesh {query_shards}x{db_hosts}x{db_shards} needs {need} "
            f"devices, have {n}")
    grid = np.empty(need, dtype=object)
    grid[:] = devices[:need]
    return Mesh(grid.reshape(query_shards, db_hosts, db_shards),
                (QUERY_AXIS, HOST_AXIS, DB_AXIS))


def is_hier(mesh: Mesh) -> bool:
    """Whether ``mesh`` carries the cross-host axis (make_host_mesh)."""
    return HOST_AXIS in mesh.shape


def db_axes(mesh: Mesh):
    """The db-sharding axes: ``DB_AXIS``, or ``(HOST_AXIS, DB_AXIS)``
    (host-major) on a hierarchical mesh."""
    return (HOST_AXIS, DB_AXIS) if is_hier(mesh) else DB_AXIS


def db_topology(mesh: Mesh) -> Tuple[int, int]:
    """``(hosts, devices_per_host)`` of the db sharding; hosts == 1 on a
    flat mesh.  Total db shards = hosts * devices_per_host."""
    return mesh.shape.get(HOST_AXIS, 1), mesh.shape[DB_AXIS]


def grid3(mesh: Mesh) -> np.ndarray:
    """The device grid as ``[query, host, db]`` (a flat mesh gains a host
    axis of 1): position ``[r, h, c]`` holds db shard ``h * chips + c``
    of query shard ``r``."""
    q = mesh.shape[QUERY_AXIS]
    hosts, chips = db_topology(mesh)
    return mesh.devices.reshape(q, hosts, chips)


def default_mesh(db_shards: int = 1) -> Mesh:
    """Mesh over every visible card; queries get every card the db axis
    does not use."""
    return make_mesh(None, db_shards)


def pad_to_multiple(x, multiple: int, axis: int = 0, *, fill: float = 0.0):
    """``(x padded along axis to the next multiple with fill, original
    size)`` — the JAX package's answer to the reference's divisibility
    abort (knn_mpi.cpp:127-129): any size runs on any mesh, and callers
    mask the padding by index.  A numpy array is padded on the host (each
    shard then goes straight to its device), a tensor on its device."""
    n = x.shape[axis]
    padded = -(-n // multiple) * multiple
    if padded == n:
        return x, n
    if isinstance(x, np.ndarray):
        widths = [(0, 0)] * x.ndim
        widths[axis] = (0, padded - n)
        return np.pad(x, widths, constant_values=fill), n
    shape = list(x.shape)
    shape[axis] = padded - n
    return torch.cat([x, torch.full(shape, fill, dtype=x.dtype,
                                    device=x.device)], dim=axis), n


__all__ = [
    "QUERY_AXIS",
    "DB_AXIS",
    "HOST_AXIS",
    "Mesh",
    "make_mesh",
    "make_host_mesh",
    "is_hier",
    "db_axes",
    "db_topology",
    "grid3",
    "default_mesh",
    "pad_to_multiple",
]
