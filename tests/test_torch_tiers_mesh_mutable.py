"""``MutableIndex`` on a db-sharded mesh — across inserts, deletes and a
compaction, on a host mesh, its delta ladder and its serving frontend
across a background compaction — against the JAX package's.

Inputs, tolerances and helpers: ``tests/tiers_mesh_common.py``.
"""

import time

import numpy as np
import pytest

from knn_tpu.index.mutable import MutableIndex as JaxMutableIndex
from knn_tpu.parallel.mesh import make_host_mesh as jax_host_mesh
from knn_tpu.parallel.mesh import make_mesh as jax_mesh
from knn_tpu_torch.index.artifact import MutationUnsupportedError
from knn_tpu_torch.index.mutable import MutableIndex

from tiers_mesh_common import (DIM, K, SHAPES, assert_exact, assert_oracle_d,
                               jax_mesh_of, mutable_data, mutate, one_device,
                               oracle_ids, port_mesh, survivors)
from test_torch_cuda import empty_default_tune_cache  # noqa: F401 (autouse)


@pytest.mark.parametrize("shape", SHAPES)
def test_mutable_index_matches_jax_across_writes_and_compaction(shape):
    db, q, new = mutable_data()
    rows, ids = survivors(db, new)
    port = mutate(MutableIndex(db, mesh=port_mesh(shape), k=K, reserve=4),
                  new)
    ref = mutate(JaxMutableIndex(db, mesh=jax_mesh_of(shape), k=K,
                                 reserve=4), new)
    assert port.stats()["tail_capacity"] == ref.stats()["tail_capacity"]
    assert port._main.k == ref._main.k
    od, oi = oracle_ids(rows, ids, q)
    # the port's default selector (pallas: the coarse kernel once a db
    # shard) against the JAX package's default (approx): the certified
    # answer is one
    d, i, st = port.search_certified(q)
    jd, ji, _ = ref.search_certified(q)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(i, oi)
    assert_oracle_d(d, od)
    assert st["index"]["tail_rows"] == 6 and st["index"]["tombstones"] == 3
    # the exact search, tombstones masked at merge time
    sd, si = port.search(q)
    jsd, jsi = ref.search(q)
    assert not np.isin(si, [3, 250, 599]).any()
    assert_exact(sd, si, jsd, jsi, q, rows, K)
    # the same writes on the (1, 1) placement: certified indices bitwise
    flat = mutate(MutableIndex(db, mesh=one_device(), k=K, reserve=4), new)
    np.testing.assert_array_equal(flat.search_certified(q)[1], i)
    # compaction builds the fresh placement on the same mesh
    rep = port.compact()
    assert rep["epoch"] == 1 and port._main.mesh is port.mesh
    assert port._main.db_shards == int(np.prod(shape[1:]))
    d2, i2, _ = port.search_certified(q)
    np.testing.assert_array_equal(i2, oi)
    assert_oracle_d(d2, od)


@pytest.mark.parametrize("merge", ["ring", "allgather"])
def test_mutable_host_mesh_searches_as_flat_and_refuses_writes(merge):
    db, q, new = mutable_data()
    flat = MutableIndex(db, mesh=port_mesh((2, 4)), k=K, reserve=4,
                        merge=merge)
    host = MutableIndex(db, mesh=port_mesh((2, 2, 2)), k=K, reserve=4,
                        merge=merge, dcn_merge="ring")
    assert host._main.dcn_merge == "ring"
    for a, b in zip(host.search_certified(q)[:2],
                    flat.search_certified(q)[:2]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(host.search(q), flat.search(q)):
        np.testing.assert_array_equal(a, b)
    jax_host = JaxMutableIndex(db[:512], mesh=jax_host_mesh(2, 2, 2), k=K)
    for idx in (host, jax_host):
        with pytest.raises(Exception, match="multi-host placements have "
                                            "no write"):
            idx.insert(new[:1], [90001])
    with pytest.raises(MutationUnsupportedError, match="multi-host"):
        host.delete([0])
    with pytest.raises(MutationUnsupportedError, match="multi-host"):
        host.compact()
    # the flat mesh mutates, and ring and allgather agree bitwise
    mutate(flat, new)
    other = mutate(MutableIndex(
        db, mesh=port_mesh((2, 4)), k=K, reserve=4,
        merge="allgather" if merge == "ring" else "ring"), new)
    for a, b in zip(flat.search_certified(q)[:2],
                    other.search_certified(q)[:2]):
        np.testing.assert_array_equal(a, b)


def test_mutable_delta_ladder_is_a_db_shard_multiple():
    db, _, _ = mutable_data()
    for shape in [(1, 8), (2, 4), (8, 1)]:
        idx = MutableIndex(db, mesh=port_mesh(shape), k=K, reserve=4,
                           delta_min_rows=10)
        ref = JaxMutableIndex(db[:64], mesh=jax_mesh_of(shape), k=K,
                              reserve=4, delta_min_rows=10)
        for rows in (0, 1, 71, 300, 1000):
            cap = idx._capacity_for(rows)
            assert cap == ref._capacity_for(rows)
            assert cap % idx._db_shards == 0 and cap >= rows
            assert cap // idx._db_shards >= K + 4


def test_mutable_frontend_on_a_mesh_reads_across_compaction():
    db, q, new = mutable_data()
    idx = MutableIndex(db, mesh=port_mesh((2, 4)), k=K, reserve=4)
    front = idx.serving_engine(buckets=(4, 16))
    front.warmup()
    mutate(idx, new)
    h = front.submit(q[:3])
    # bitwise the index's search of the snapshot's padded batch
    padded = np.zeros((4, DIM), np.float32)
    padded[:3] = q[:3]
    want = idx.search(padded)
    got = h.result()
    np.testing.assert_array_equal(got[0], want[0][:3])
    np.testing.assert_array_equal(got[1], want[1][:3])
    # a read pinned before a background compaction is its epoch's answer
    pinned = front.submit(q[:3])
    idx.start_compactor(interval_s=0.01)
    try:
        for _ in range(400):
            if idx.stats()["compactions"]:
                break
            time.sleep(0.01)
    finally:
        idx.close()
    assert idx.epoch == 1
    np.testing.assert_array_equal(pinned.result()[1], want[1][:3])
    after = front.submit(q[:3]).result()
    rows, ids = survivors(db, new)
    np.testing.assert_array_equal(after[1], oracle_ids(rows, ids, q[:3])[1])
    jref = mutate(JaxMutableIndex(db, mesh=jax_mesh(2, 4), k=K,
                                  reserve=4), new)
    jfront = jref.serving_engine(buckets=(4, 16))
    np.testing.assert_array_equal(jfront.submit(q[:3]).result()[1],
                                  after[1])
