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
  followed by the reduction on the receiving device; nothing here calls
  ``torch.distributed``, and nothing waits for the host.

:func:`barrier` is the timing fence of knn_mpi.cpp:133-134: CUDA work is
asynchronous, so a wall clock without it measures the enqueue.

The JAX package's ``shard_map_compat`` has no counterpart: it wraps
``jax.shard_map`` across an API move, and the port's per-shard programs
are plain Python loops over the mesh (parallel.sharded).  The measured
merge crossover is re-exported from parallel.crossover, as the JAX
package re-exports it here.
"""

from __future__ import annotations

from typing import List, Sequence, Union

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
    of the mesh's shape, each position the block its device holds;
    ``spec`` the sharded mesh axes (None: replicated) and ``axis`` the
    array axis they split; ``shape`` the global shape."""

    def __init__(self, mesh: Mesh, parts: np.ndarray, spec, axis: int,
                 shape: tuple):
        self.mesh = mesh
        self.parts = parts
        self.spec = spec
        self.axis = axis
        self.shape = tuple(shape)

    def block(self, index: int) -> torch.Tensor:
        """The ``index``-th block along the sharded axes (the whole array
        when replicated), from its first position."""
        names = self._names()
        if not names:
            return next(iter(self.parts.flat))
        sizes = [self.mesh.shape[a] for a in names]
        coord = np.unravel_index(index, sizes)
        pos = [0] * len(self.mesh.axis_names)
        for a, c in zip(names, coord):
            pos[self.mesh.axis_names.index(a)] = c
        return self.parts[tuple(pos)]

    def _names(self) -> tuple:
        if self.spec is None:
            return ()
        return (self.spec,) if isinstance(self.spec, str) else tuple(self.spec)

    @property
    def n_blocks(self) -> int:
        return int(np.prod([self.mesh.shape[a] for a in self._names()]))

    def gather(self, device=None) -> torch.Tensor:
        """The global array on ``device`` (None: the CPU)."""
        device = torch.device("cpu") if device is None else device
        return gather([self.block(j) for j in range(self.n_blocks)], device,
                      axis=self.axis)


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _place(blocks: List[torch.Tensor], mesh: Mesh, block_of) -> np.ndarray:
    """Object array of the mesh's shape: position p holds block
    ``block_of(p)`` on p's device, one copy per (block, device)."""
    parts = np.empty(mesh.devices.shape, dtype=object)
    copies = {}
    for pos in np.ndindex(*mesh.devices.shape):
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


def gather(parts: Sequence[torch.Tensor], device, *, axis: int = 0,
           tiled: bool = True) -> torch.Tensor:
    """MPI_Gather (knn_mpi.cpp:340,383): every part copied to ``device``
    and joined along ``axis`` (``tiled``) or stacked on a new leading
    axis of one entry a part."""
    moved = [p.to(device, non_blocking=True) for p in parts]
    return torch.cat(moved, dim=axis) if tiled else torch.stack(moved)


def _reduce(parts: Sequence[torch.Tensor], device, op) -> torch.Tensor:
    acc = None
    for q in parts:
        q = q.to(device, non_blocking=True)
        acc = q if acc is None else op(acc, q)
    return acc


def _allreduce(parts: Sequence[torch.Tensor], op) -> List[torch.Tensor]:
    return [_reduce(parts, p.device, op) for p in parts]


def reduce_min(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """MPI_Reduce(MPI_MIN) to ``device``: the elementwise minimum, once."""
    return _reduce(parts, device, torch.minimum)


def reduce_max(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """MPI_Reduce(MPI_MAX) to ``device``."""
    return _reduce(parts, device, torch.maximum)


def reduce_sum(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """MPI_Reduce(MPI_SUM) to ``device``, in participant order."""
    return _reduce(parts, device, torch.add)


def allreduce_min(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """MPI_Allreduce(MPI_MIN) (knn_mpi.cpp:277): the elementwise minimum
    on every participant's device."""
    return _allreduce(parts, torch.minimum)


def allreduce_max(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """MPI_Allreduce(MPI_MAX) (knn_mpi.cpp:276)."""
    return _allreduce(parts, torch.maximum)


def allreduce_sum(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """MPI_Allreduce(MPI_SUM), in participant order on every device (the
    JAX package's ``lax.psum``; integer sums are exact in any order)."""
    return _allreduce(parts, torch.add)


def barrier(*arrays) -> None:
    """MPI_Barrier before MPI_Wtime (knn_mpi.cpp:133-134, 395-396): wait
    until the work that makes every listed tensor (or :class:`Placed`)
    has finished on its device."""
    devices: list = []
    for a in arrays:
        ts = a.parts.flat if isinstance(a, Placed) else [a]
        for t in ts:
            if isinstance(t, torch.Tensor) and t.device.type == "cuda" \
                    and t.device not in devices:
                devices.append(t.device)
    for d in devices:
        torch.cuda.synchronize(d)


__all__ = [
    "Placed",
    "replicate",
    "shard",
    "gather",
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
