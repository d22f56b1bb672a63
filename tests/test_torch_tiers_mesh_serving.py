"""``ServingEngine`` on a db-sharded mesh across bucket boundaries against
the JAX package's and the eager mesh program of each padded batch.

Inputs, tolerances and helpers: ``tests/tiers_mesh_common.py``.
"""

import numpy as np
import pytest

from knn_tpu.parallel.sharded import ShardedKNN as JaxShardedKNN
from knn_tpu.serving.engine import ServingEngine as JaxServingEngine
from knn_tpu_torch.parallel.sharded import ShardedKNN
from knn_tpu_torch.serving.engine import ServingEngine

from tiers_mesh_common import (DIM, K, SHAPES, assert_exact, jax_mesh_of,
                               join_data, port_mesh)
from test_torch_cuda import empty_default_tune_cache  # noqa: F401 (autouse)


# -- serving --------------------------------------------------------------------
@pytest.mark.parametrize("shape", SHAPES)
def test_serving_engine_on_a_mesh_across_buckets(shape):
    db, qa = join_data(13)
    labels = np.random.default_rng(13).integers(0, 4, db.shape[0])
    knn = ShardedKNN(db, mesh=port_mesh(shape), k=K, labels=labels,
                     num_classes=4)
    eng = ServingEngine(knn, buckets=(1, 2, 8, 16))
    ref = JaxServingEngine(
        JaxShardedKNN(db, mesh=jax_mesh_of(shape), k=K, labels=labels,
                      num_classes=4), buckets=(1, 2, 8, 16))
    q_shards = shape[0]
    for n in (1, 2, 3, 9, 16, 21):
        d, i = eng.search(qa[:n])
        bucket = next((b for b in (1, 2, 8, 16) if b >= n), 16)
        placed = -(-bucket // q_shards) * q_shards
        padded = np.zeros((placed, DIM), np.float32)
        padded[:min(n, 16)] = qa[:min(n, 16)]
        if n <= 16:
            # bitwise the eager mesh program on the padded batch
            wd, wi = knn.search(padded)
            np.testing.assert_array_equal(d, wd.numpy()[:n])
            np.testing.assert_array_equal(i, wi.numpy()[:n])
        jd, ji = ref.search(qa[:n])
        assert_exact(d, i, jd, ji, qa[:n], db, K)
        np.testing.assert_array_equal(eng.predict(qa[:n]),
                                      np.asarray(ref.predict(qa[:n])))
    st, jst = eng.stats(), ref.stats()
    # buckets below the query-shard count share one placed shape
    assert st["executables"] == len({(op, -(-b // q_shards) * q_shards)
                                     for op in ("search", "predict")
                                     for b in (1, 2, 8, 16)})
    assert st["executables"] == jst["executables"]
    assert st["per_bucket_dispatches"] == jst["per_bucket_dispatches"]
