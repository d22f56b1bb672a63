"""``knn_join`` and the streaming entries on a db-sharded mesh against the
JAX package's, the looped mesh search and the direct
``search_certified``.

Inputs, tolerances and helpers: ``tests/tiers_mesh_common.py``.
"""

import numpy as np
import pytest

from knn_tpu import streaming as jax_streaming
from knn_tpu.join import knn_join as jax_join
from knn_tpu.parallel.mesh import make_mesh as jax_mesh
from knn_tpu.parallel.sharded import ShardedKNN as JaxShardedKNN
from knn_tpu_torch.join import knn_join
from knn_tpu_torch.parallel.sharded import ShardedKNN
from knn_tpu_torch.streaming import streaming_certified_knn, streaming_knn

from tiers_mesh_common import (DIM, K, SHAPES, assert_exact, assert_oracle_d,
                               jax_mesh_of, join_data, oracle_ids, port_mesh)
from test_torch_cuda import empty_default_tune_cache  # noqa: F401 (autouse)


@pytest.mark.parametrize("shape", SHAPES)
def test_join_stream_and_certified_on_a_mesh(shape):
    db, qa = join_data()
    knn = ShardedKNN(db, mesh=port_mesh(shape), k=K, merge="allgather")
    d, i, st = knn_join(knn, qa, mode="stream", superblock_rows=32)
    assert st["superblocks"] == 3 and st["dispatches"] == 3
    # bitwise the looped mesh search at the same padded block shape
    blocks = [np.pad(qa[lo:lo + 32], ((0, max(0, lo + 32 - 70)), (0, 0)))
              for lo in range(0, 70, 32)]
    loop = [knn.search(b) for b in blocks]
    np.testing.assert_array_equal(
        d, np.concatenate([x[0].numpy() for x in loop])[:70])
    np.testing.assert_array_equal(
        i, np.concatenate([x[1].numpy() for x in loop])[:70])
    # the streaming test's strategy, rows and block: one JAX program each
    ref = JaxShardedKNN(db, mesh=jax_mesh_of(shape), k=K, merge="allgather")
    jd, ji, jst = jax_join(ref, qa, mode="stream", superblock_rows=32)
    assert jst["superblocks"] == st["superblocks"]
    assert_exact(d, i, jd, ji, qa, db, K)
    # certified: the counted selector against the JAX package's (float64
    # distances), the pallas one bitwise its looped certified search
    cd, ci, cst = knn_join(knn, qa, mode="certified", superblock_rows=32,
                           selector="exact")
    jcd, jci, _ = jax_join(ref, qa, mode="certified", superblock_rows=32,
                           selector="exact")
    np.testing.assert_array_equal(ci, jci)
    np.testing.assert_array_equal(cd, jcd)
    od, oi = oracle_ids(db, np.arange(db.shape[0]), qa)
    np.testing.assert_array_equal(ci, oi)
    assert_oracle_d(cd, od)
    pd, pi, pst = knn_join(knn, qa, mode="certified", superblock_rows=32)
    looped = [knn.search_certified(qa[lo:lo + 32]) for lo in (0, 32, 64)]
    np.testing.assert_array_equal(pi, np.concatenate([x[1] for x in looped]))
    np.testing.assert_array_equal(pd, np.concatenate([x[0] for x in looped]))
    np.testing.assert_array_equal(pi, oi)
    assert pst["fallback_queries"] == sum(x[2]["fallback_queries"]
                                          for x in looped)


def test_join_superblock_budget_in_query_shard_multiples():
    db, qa = join_data(n_a=50)
    knn = ShardedKNN(db, mesh=port_mesh((4, 2)), k=K)
    ref = JaxShardedKNN(db, mesh=jax_mesh(4, 2), k=K)
    budget = 7 * DIM * 4  # 7 rows: rounded down to 4
    from knn_tpu.join import default_plan as jax_plan
    from knn_tpu_torch.join import default_plan

    plan = default_plan(knn, 50, query_budget_bytes=budget)
    assert plan["superblock_rows"] == 4
    assert plan == jax_plan(ref, 50, query_budget_bytes=budget)
    d, i, st = knn_join(knn, qa, query_budget_bytes=budget)
    assert st["superblocks"] == 13
    np.testing.assert_array_equal(i, knn.search(qa)[1].numpy())


# -- streaming ------------------------------------------------------------------
@pytest.mark.parametrize("shape", SHAPES)
def test_streaming_entries_on_a_mesh_match_jax(shape, tmp_path):
    db, qa = join_data()
    d, i = streaming_knn(db, qa, K, str(tmp_path / "p"), batch_size=32,
                         mesh=port_mesh(shape))
    jd, ji = jax_streaming.streaming_knn(db, qa, K, str(tmp_path / "j"),
                                         batch_size=32,
                                         mesh=jax_mesh_of(shape))
    assert_exact(d, i, jd, ji, qa, db, K)
    cd, ci, st = streaming_certified_knn(
        db, qa, K, str(tmp_path / "pc"), segment_size=32,
        mesh=port_mesh(shape), selector="exact")
    jcd, jci, jst = jax_streaming.streaming_certified_knn(
        db, qa, K, str(tmp_path / "jc"), segment_size=32,
        mesh=jax_mesh_of(shape), selector="exact")
    np.testing.assert_array_equal(ci, jci)
    np.testing.assert_array_equal(cd, jcd)
    assert st["certified"] == jst["certified"]
    # the pallas stream: bitwise the direct mesh search_certified
    knn = ShardedKNN(db, mesh=port_mesh(shape), k=K, merge="allgather")
    pd, pi, _ = streaming_certified_knn(db, qa, K, str(tmp_path / "pp"),
                                        segment_size=32,
                                        mesh=port_mesh(shape))
    rd, ri, _ = knn.search_certified(qa)
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_array_equal(pd, rd)
