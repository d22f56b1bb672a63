"""The port's certified-exact search (knn_tpu_torch ShardedKNN.search_certified,
selector "pallas") against the JAX package's (ShardedKNN on a (1, 1) mesh,
Pallas kernel in interpret mode on CPU) and the float64 oracle.

Indices must be bitwise equal to both.  Distances: every returned value is
within RANK_SLACK of the f64 oracle, and values that both packages refined
in float64 (not representable in f32) are equal.  Both sides are built
from the same numpy arrays, the port's through convert.placement_from_numpy.
"""

import numpy as np
import pytest
import torch

from knn_tpu.parallel.mesh import make_mesh
from knn_tpu.parallel.sharded import ShardedKNN as JaxShardedKNN
from knn_tpu_torch.convert import placement_from_numpy
from knn_tpu_torch.ops import coarse_knn as ck
from knn_tpu_torch.parallel.sharded import ShardedKNN

import oracles


def _blobs(seed, n=1500, dim=24):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(12, dim)) * 10
    db = (centers[rng.integers(0, 12, size=n)]
          + rng.normal(size=(n, dim))).astype(np.float32)
    q = (centers[rng.integers(0, 12, size=40)]
         + rng.normal(size=(40, dim))).astype(np.float32)
    return db, q


def _ties(seed, n=1200, dim=16):
    # duplicate rows: exact ties at and around the top-k boundary
    rng = np.random.default_rng(seed)
    base = (rng.normal(size=(n // 4, dim)) * 5).astype(np.float32)
    db = np.concatenate([base, base, base[::-1], base])
    q = base[:30] + np.float32(0.01)
    q[::3] = base[:30:3]  # queries sitting exactly on duplicated rows
    return db, q


def _oracle(db, q, k):
    d = oracles.sq_l2(q, db)
    idx = np.lexsort((np.broadcast_to(np.arange(db.shape[0]), d.shape), d),
                     axis=-1)[:, :k]
    return np.take_along_axis(d, idx, axis=-1), idx


def _assert_distances(dp, dj, do):
    np.testing.assert_allclose(dp, do, rtol=ck.RANK_SLACK, atol=1e-12)
    both_f64 = (dp != dp.astype(np.float32)) & (dj != dj.astype(np.float32))
    np.testing.assert_array_equal(dp[both_f64], dj[both_f64])


@pytest.mark.parametrize("fixture,k,tile_n", [
    (_blobs, 10, None), (_blobs, 25, 256), (_ties, 10, None),
    (_ties, 7, 256)])
@pytest.mark.parametrize("seed", [0, 1])
def test_search_certified_matches_jax_and_oracle(fixture, k, tile_n, seed):
    db, q = fixture(seed)
    jax_knn = JaxShardedKNN(db, mesh=make_mesh(1, 1), k=k)
    jd, ji, jstats = jax_knn.search_certified(
        q, margin=28, selector="pallas", tile_n=tile_n)
    port = ShardedKNN(placement_from_numpy(db, metric="l2", device="cpu"), k=k)
    pd, pi, pstats = port.search_certified(q, margin=28, selector="pallas",
                                           tile_n=tile_n)
    od, oi = _oracle(db, q, k)
    np.testing.assert_array_equal(pi, oi)
    np.testing.assert_array_equal(pi, ji)
    _assert_distances(pd, jd, od)
    assert pstats["certified"] + pstats["fallback_queries"] == q.shape[0]
    assert pstats["pallas_knobs"]["precision"] == "bf16x3"


def test_search_certified_batches_and_indices_only():
    db, q = _blobs(4)
    port = ShardedKNN(db, k=10, device="cpu")
    d_all, i_all, _ = port.search_certified(q)
    d_b, i_b, _ = port.search_certified(q, batch_size=16)
    none, i_n, _ = port.search_certified(q, return_distances=False)
    assert none is None
    np.testing.assert_array_equal(i_all, i_b)
    np.testing.assert_array_equal(i_all, i_n)
    np.testing.assert_array_equal(d_all, d_b)


def test_search_certified_cosine_matches_jax():
    db, q = _blobs(2, dim=20)
    jd, ji, _ = JaxShardedKNN(db, mesh=make_mesh(1, 1), k=8,
                              metric="cosine").search_certified(
        q, selector="pallas")
    pd, pi, _ = ShardedKNN(db, k=8, metric="cosine",
                           device="cpu").search_certified(q)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(pd, jd, rtol=4 * ck.RANK_SLACK, atol=1e-7)


@pytest.mark.parametrize("fixture,k,tile_n", [(_blobs, 20, 2048),
                                              (_ties, 10, None)])
def test_repair_path_runs_and_stays_exact(fixture, k, tile_n):
    # a one-row margin forces uncertified queries (bin collisions on
    # blobs, unresolvable tie runs on the duplicates) through the widened
    # re-select and the float64 repair
    db, q = fixture(5)
    port = ShardedKNN(db, k=k, device="cpu")
    pd, pi, stats = port.search_certified(q, margin=1, tile_n=tile_n)
    od, oi = _oracle(db, q, k)
    np.testing.assert_array_equal(pi, oi)
    assert stats["fallback_queries"] > 0
    jd, ji, _ = JaxShardedKNN(db, mesh=make_mesh(1, 1), k=k).search_certified(
        q, margin=1, selector="pallas", tile_n=tile_n)
    np.testing.assert_array_equal(pi, ji)
    _assert_distances(pd, jd, od)


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_exact_search_and_predict_match_jax(metric):
    db, q = _blobs(3)
    labels = (np.arange(db.shape[0]) % 5).astype(np.int32)
    jknn = JaxShardedKNN(db, mesh=make_mesh(1, 1), k=9, metric=metric,
                         labels=labels, num_classes=5)
    port = ShardedKNN(db, k=9, metric=metric, labels=labels, num_classes=5,
                      device="cpu", train_tile=256)
    jd, ji = (np.asarray(a) for a in jknn.search(q))
    pd, pi = (a.numpy() for a in port.search(q))
    np.testing.assert_array_equal(pi, ji)
    # both are f32 expanded squares summed in different orders: their
    # error scales with the norms, not with the distance
    q64 = q.astype(np.float64)
    scale = (q64 ** 2).sum(-1) + (db.astype(np.float64) ** 2).sum(-1).max()
    eps = float(np.finfo(np.float32).eps)
    assert (np.abs(pd - jd) <= 16 * eps * scale[:, None]).all()
    np.testing.assert_array_equal(port.predict(q).numpy(),
                                  np.asarray(jknn.predict(q)))
    jl, _ = jknn.predict_certified(q, selector="pallas")
    pl, _ = port.predict_certified(q)
    np.testing.assert_array_equal(pl, np.asarray(jl))


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_return_sqrt_matches_jax(metric):
    # metric values (sqrt of squared L2; cosine unchanged) on both paths
    db, q = _blobs(7, n=600)
    jknn = JaxShardedKNN(db, mesh=make_mesh(1, 1), k=6, metric=metric)
    port = ShardedKNN(db, k=6, metric=metric, device="cpu")
    jd, ji = (np.asarray(a) for a in jknn.search(q, return_sqrt=True))
    pd, pi = (a.numpy() for a in port.search(q, return_sqrt=True))
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(pd, jd, rtol=1e-4, atol=1e-3)
    jd, ji, _ = jknn.search_certified(q, selector="pallas", return_sqrt=True)
    pd, pi, _ = port.search_certified(q, return_sqrt=True)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(pd, jd, rtol=4 * ck.RANK_SLACK, atol=1e-7)


def test_placement_matches_jax_placement():
    db, _ = _blobs(6)
    pl = placement_from_numpy(db, metric="cosine", device="cpu")
    jknn = JaxShardedKNN(db, mesh=make_mesh(1, 1), k=3, metric="cosine")
    np.testing.assert_array_equal(pl.db_host, jknn._host_train())
    assert pl.db_norm_max == jknn._db_norm_max()
    assert pl.th.shape == (ck.TILE_N, 128) and pl.tnorm.shape == (8, ck.TILE_N)
    with pytest.raises(ValueError, match="num_classes"):
        placement_from_numpy(db, np.zeros(len(db)), device="cpu")


@pytest.mark.parametrize("bad_value", [np.nan, np.inf])
@pytest.mark.parametrize("where", ["train", "query"])
def test_non_finite_input_is_refused(bad_value, where):
    # a NaN score has no place in the insertion network's order or the
    # certificate's, so the entry points refuse it instead of answering
    db, _ = _blobs(7)
    q = db[:3].copy()
    if where == "train":
        db[5, 1] = bad_value
        with pytest.raises(ValueError, match="finite"):
            ShardedKNN(db, k=4, device="cpu")
    else:
        q[1, 2] = bad_value
        with pytest.raises(ValueError, match="finite"):
            ShardedKNN(db, k=4, device="cpu").search_certified(q)


@pytest.mark.parametrize("knob,value", [("survivors", 4), ("bin_w", 256)])
def test_search_certified_refuses_unported_geometry(knob, value):
    db, _ = _blobs(8)
    with pytest.raises(ValueError, match=f"{knob}={value} is not ported"):
        ShardedKNN(db, k=4, device="cpu").search_certified(
            db[:2], **{knob: value})


def test_certify_pack_matches_jax_tail():
    # the device certificate on identical ranked candidates: same window,
    # same near-tie mask, same bad flags
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from knn_tpu.parallel.collectives import shard_map_compat
    from knn_tpu.parallel.mesh import QUERY_AXIS
    from knn_tpu.parallel.sharded import _certify_pack_spmd, unpack_certified
    from knn_tpu_torch.parallel.sharded import _certify_pack

    rng = np.random.default_rng(9)
    k, m, n_q = 5, 12, 6
    d32 = np.sort(rng.random((n_q, m + 1)).astype(np.float32) * 50, axis=1)
    d32[1, 4] = d32[1, 3]  # an exact tie inside the window
    d32[2, 5:] = np.inf    # sentinel tail
    li = np.tile(np.arange(m + 1), (n_q, 1)).astype(np.int32)
    li[2, 5:] = 2 ** 31 - 1
    q = rng.random((n_q, 8)).astype(np.float32)
    lb = (d32[:, k - 1] - (q.astype(np.float64) ** 2).sum(-1)
          + rng.normal(size=n_q)).astype(np.float32)
    w = min(k + 17, m + 1)

    def spmd(qs, ds, ls, bs):
        return _certify_pack_spmd(
            qs, jnp.zeros((50, 8)), ds, ls, bs, consts=None,
            db_norm_max=np.float32(3.0), precision="bf16x3",
            quant_offset=0.0, m=m, k=k, w=w, merge="allgather", n_train=50,
            hosts=1, chips=1, include_distances=True)

    prog = jax.jit(shard_map_compat(
        spmd, mesh=make_mesh(1, 1), in_specs=(P(QUERY_AXIS),) * 4,
        out_specs=P(QUERY_AXIS), check_vma=False))
    jpacked = prog(jnp.asarray(q), jnp.asarray(d32), jnp.asarray(li),
                   jnp.asarray(lb))
    jgi, jtight, jbad, jdk = unpack_certified(np.asarray(jpacked), k, w, True)
    pgi, ptight, pbad, pdk = _certify_pack(
        torch.from_numpy(q), torch.from_numpy(d32),
        torch.from_numpy(li.astype(np.int64)), torch.from_numpy(lb),
        db_norm_max=3.0, m=m, k=k, w=w, n_train=50, include_distances=True)
    np.testing.assert_array_equal(pgi.numpy(), jgi)
    np.testing.assert_array_equal(ptight.numpy(), jtight)
    np.testing.assert_array_equal(pbad.numpy(), jbad)
    np.testing.assert_array_equal(pdk.numpy(), jdk)
