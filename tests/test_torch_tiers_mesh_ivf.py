"""k-means and ``IVFIndex`` on a db-sharded mesh — ``train_kmeans``, a
centroid tie across shards, ``quantize_centroids`` / ``vote_counts``,
the counted and pallas selectors, the rungs and the serving frontend —
against the JAX package's.

Inputs, tolerances and helpers: ``tests/tiers_mesh_common.py``.
"""

import numpy as np
import pytest
import torch

from knn_tpu.ivf import IVFIndex as JaxIVFIndex
from knn_tpu.ivf import kmeans as jax_kmeans
from knn_tpu.ops import vote as jax_vote
from knn_tpu.parallel.mesh import make_mesh as jax_mesh
from knn_tpu_torch.ivf import IVFIndex, kmeans
from knn_tpu_torch.ops import vote

from tiers_mesh_common import (IVF_KW, SHAPES, assert_oracle_d, clustered,
                               jax_mesh_of, oracle_ids, port_mesh)
from test_torch_cuda import empty_default_tune_cache  # noqa: F401 (autouse)


@pytest.mark.parametrize("shape", SHAPES)
def test_train_kmeans_matches_jax(shape):
    rows, _ = clustered()
    got = kmeans.train_kmeans(rows, 12, mesh=port_mesh(shape), iters=2)
    ref = jax_kmeans.train_kmeans(rows, 12, mesh=jax_mesh_of(shape),
                                  iters=2)
    np.testing.assert_array_equal(got.assign, ref.assign)
    np.testing.assert_array_equal(got.centroids, ref.centroids)
    np.testing.assert_array_equal(got.counts, ref.counts)
    np.testing.assert_array_equal(got.residuals, ref.residuals)
    assert got.iters == ref.iters
    one = kmeans.train_kmeans(rows, 12, device="cpu", iters=2)
    np.testing.assert_array_equal(one.assign, got.assign)
    with pytest.raises(ValueError, match="not both"):
        kmeans.train_kmeans(rows, 12, mesh=port_mesh(shape), device="cpu")


@pytest.mark.parametrize("shape", SHAPES + [(2, 2, 2)])
def test_assign_tie_between_shards_goes_to_the_lower_centroid(shape):
    """Centroids 1 and 6 are one row, on different db shards of every
    shape here (8 centroids, a shard holding at most 2 of them... or the
    whole table on a query-only mesh): the tie goes to centroid 1, as the
    one-device stable select gives it.  Small integers: every f32
    distance is exact."""
    cent = np.arange(8 * 4, dtype=np.float32).reshape(8, 4) % 7
    cent[6] = cent[1]
    cent[3] = cent[1] + 2.0  # a farther neighbour
    rows = np.stack([cent[1] + 1.0, cent[1], cent[6] - 1.0])
    got = kmeans.assign_lists(rows, cent, mesh=port_mesh(shape))
    np.testing.assert_array_equal(got, [1, 1, 1])
    np.testing.assert_array_equal(
        got, jax_kmeans.assign_lists(rows, cent, mesh=jax_mesh_of(shape)))
    np.testing.assert_array_equal(
        got, kmeans.assign_lists(rows, cent, device="cpu"))


def test_quantize_centroids_and_vote_counts_bitwise_jax():
    rows, _ = clustered(2)
    cent = kmeans.train_kmeans(rows, 9, device="cpu", iters=1).centroids
    cent[2] = 0.0  # an all-zero row takes scale 1
    got, ref = kmeans.quantize_centroids(cent), \
        jax_kmeans.quantize_centroids(cent)
    np.testing.assert_array_equal(got.values, np.asarray(ref.values))
    np.testing.assert_array_equal(got.scales, np.asarray(ref.scales))
    assert got.values.dtype == np.int8 and got.offset == ref.offset
    labels = np.random.default_rng(3).integers(-1, 6, size=(7, 11))
    counts = vote.vote_counts(torch.from_numpy(labels), 5)
    assert counts.dtype == torch.int32
    np.testing.assert_array_equal(
        counts.numpy(), np.asarray(jax_vote.vote_counts(labels, 5)))


@pytest.mark.parametrize("shape", SHAPES)
def test_ivf_index_matches_jax_counted_and_pallas(shape):
    rows, q = clustered(4)
    port = IVFIndex(rows, mesh=port_mesh(shape), **IVF_KW)
    ref = JaxIVFIndex(rows, mesh=jax_mesh_of(shape), **IVF_KW)
    np.testing.assert_array_equal(port._centroids, ref._centroids)
    jd, ji, jst = ref.search_certified(q, selector="exact")
    od, oi = oracle_ids(rows, np.arange(rows.shape[0]), q)
    np.testing.assert_array_equal(ji, oi)
    for selector, kw in (("exact", {}),
                         ("pallas", {"precision": "bf16x3",
                                     "tile_n": 256})):
        d, i, st = port.search_certified(q, selector=selector, **kw)
        np.testing.assert_array_equal(i, ji)
        np.testing.assert_array_equal(d, jd)
        assert_oracle_d(d, od)
        if selector == "exact":
            assert st["fallback_queries"] == jst["fallback_queries"]
    # writes and a re-cluster keep the answer the oracle's
    port.insert(q[:2] + 0.5, [7000, 7001])
    port.delete([0, 1])
    port.compact()
    live = np.concatenate([rows[2:], q[:2] + 0.5])
    live_ids = np.concatenate([np.arange(2, rows.shape[0]), [7000, 7001]])
    d, i, _ = port.search_certified(q)
    od, oi = oracle_ids(live, live_ids, q)
    np.testing.assert_array_equal(i, oi)
    assert_oracle_d(d, od)


def test_ivf_rungs_on_a_mesh():
    rows, _ = clustered(5, n=200)
    idx = IVFIndex(rows, mesh=port_mesh((2, 4)), seg_min_rows=20, **IVF_KW)
    ref = JaxIVFIndex(rows, mesh=jax_mesh(2, 4), seg_min_rows=20, **IVF_KW)
    for n_rows, m in ((5, 13), (300, 13), (1000, 40)):
        assert idx._seg_rung(n_rows, m) == ref._seg_rung(n_rows, m)
        assert idx._seg_rung(n_rows, m) % 4 == 0
    for n_q in (1, 2, 3, 9):
        assert idx._q_rung(n_q) == ref._q_rung(n_q)


def test_ivf_frontend_on_a_mesh_is_the_direct_search():
    rows, q = clustered(6)
    idx = IVFIndex(rows, mesh=port_mesh((4, 2)), **IVF_KW)
    front = idx.serving_engine(buckets=(8, 16))
    front.apply_write("insert", vectors=q[:1] + 0.25, ids=[9999])
    got = front.submit(q[:5]).result()
    want = idx.search_certified(q[:5])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert 9999 in got[1][0]
