"""knn_tpu_torch.parallel — the port of knn_tpu/parallel: the reference's
MPI backend (knn_mpi.cpp:123-129, 133-134, 224-227, 276-277, 340, 383,
395-397) as a mesh of torch devices (parallel.mesh), collectives of
device-to-device copies (parallel.collectives), the measured merge
crossover (parallel.crossover), the db-sharded placement and its merge
tree (parallel.sharded) and processes joined through a store
(parallel.multihost).

Attribute access is lazy (PEP 562, as in the JAX package), so the
torch-free members — crossover's table and byte model, read by the
roofline and the artifact catalog — import nothing else.
"""

import importlib

#: symbol -> defining submodule; resolved on first attribute access
_EXPORTS = {
    "make_mesh": "knn_tpu_torch.parallel.mesh",
    "make_host_mesh": "knn_tpu_torch.parallel.mesh",
    "default_mesh": "knn_tpu_torch.parallel.mesh",
    "pad_to_multiple": "knn_tpu_torch.parallel.mesh",
    "QUERY_AXIS": "knn_tpu_torch.parallel.mesh",
    "DB_AXIS": "knn_tpu_torch.parallel.mesh",
    "HOST_AXIS": "knn_tpu_torch.parallel.mesh",
    "MEASURED_CROSSOVER": "knn_tpu_torch.parallel.crossover",
    "choose_merge": "knn_tpu_torch.parallel.crossover",
    "merge_bytes": "knn_tpu_torch.parallel.crossover",
    "resolve_merge": "knn_tpu_torch.parallel.crossover",
    "replicate": "knn_tpu_torch.parallel.collectives",
    "shard": "knn_tpu_torch.parallel.collectives",
    "gather": "knn_tpu_torch.parallel.collectives",
    "allreduce_min": "knn_tpu_torch.parallel.collectives",
    "allreduce_max": "knn_tpu_torch.parallel.collectives",
    "barrier": "knn_tpu_torch.parallel.collectives",
    "ShardedKNN": "knn_tpu_torch.parallel.sharded",
    "sharded_knn": "knn_tpu_torch.parallel.sharded",
    "sharded_knn_predict": "knn_tpu_torch.parallel.sharded",
    "sharded_minmax": "knn_tpu_torch.parallel.sharded",
    "sharded_normalize_transductive": "knn_tpu_torch.parallel.sharded",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    try:
        module = _EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module 'knn_tpu_torch.parallel' has no attribute {name!r}"
        ) from None
    value = getattr(importlib.import_module(module), name)
    globals()[name] = value  # cache: the next access skips __getattr__
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
