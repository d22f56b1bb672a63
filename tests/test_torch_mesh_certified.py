"""The port's certified search on a db-sharded mesh (``ShardedKNN(mesh=)
.search_certified``: each db shard's coarse kernel — here its plain
version on the CPU — and select/rescore on its own rows, the merge tree,
the minimum of the exclusion bounds, the certificate of the merged lists)
against the port's one-device placement, the JAX package's ``ShardedKNN``
on the same mesh shape of its 8 virtual CPU devices and the float64
oracle.

Parity: the certified path's f32 distances are direct differences of
each pair and its refine is float64, so indices on every mesh shape and
merge pair are bitwise the port's one-device placement's and the
oracle's, and so are the distances wherever both placements certify
every query (``_assert_same``).  A mesh's exclusion bounds come from its
shards' bins, so a query may be repaired on one placement and certified
on the other (int4 and lane binning here); its distances are then float64
on one side and f32 on the other: within RANK_SLACK, equal where both are
float64, and every row whose distances differ must be such a row (one
that holds a value f32 cannot represent, on one side or the other).  Against the JAX package the indices are
equal and the distances within RANK_SLACK of the oracle, equal where both
refined in float64 (test_torch_certified.py's rule: the two packages'
f32 rescores sum in different orders).  The counted selectors' distances
are float64 refines of the same candidates: bitwise the JAX package's.
"""

import numpy as np
import pytest

from knn_tpu.parallel.sharded import ShardedKNN as JaxShardedKNN
from knn_tpu_torch.ops import coarse_knn as ck
from knn_tpu_torch.parallel.sharded import ShardedKNN

import oracles
from test_torch_cuda import empty_default_tune_cache  # noqa: F401 (autouse)
from test_torch_mesh import CASES, FLAT, HOST, jax_mesh_of, port_mesh

K = 5


def _data(seed=0, n=299, dim=12, n_q=21):
    rng = np.random.default_rng(seed)
    db = (rng.random((n, dim)) * 10).astype(np.float32)
    q = (rng.random((n_q, dim)) * 10).astype(np.float32)
    return db, q


def _oracle(db, q, k=K):
    d = oracles.sq_l2(q, db)
    idx = np.lexsort((np.broadcast_to(np.arange(db.shape[0]), d.shape), d),
                     axis=-1)[:, :k]
    return np.take_along_axis(d, idx, axis=-1), idx


def _assert_vs_jax(pd, pi, jd, ji, od, oi):
    np.testing.assert_array_equal(pi, oi)
    np.testing.assert_array_equal(pi, np.asarray(ji))
    np.testing.assert_allclose(pd, od, rtol=ck.RANK_SLACK, atol=1e-12)
    jd = np.asarray(jd)
    both_f64 = (pd != pd.astype(np.float32)) & (jd != jd.astype(np.float32))
    np.testing.assert_array_equal(pd[both_f64], jd[both_f64])


def repaired_rows(d):
    """Rows that hold a value f32 cannot represent: the float64 repairs (a
    certified row holds the f32 direct differences)."""
    return (d != d.astype(np.float32)).any(axis=1)


def assert_same_as_one_device(d, i, rd, ri, *, none_repaired=False):
    """A certified result against the one-device placement's: indices
    bitwise; every row whose distances differ lies among the rows either
    side repaired, and there they are within RANK_SLACK, equal where both
    are float64.  ``none_repaired``: neither side fell back, so every
    distance is bitwise."""
    np.testing.assert_array_equal(i, ri)
    if none_repaired:
        np.testing.assert_array_equal(d, rd)
        return
    stray = (d != rd).any(axis=1) & ~(repaired_rows(d) | repaired_rows(rd))
    assert not stray.any(), (
        f"rows {np.flatnonzero(stray)} differ and neither side repaired "
        f"them")
    np.testing.assert_allclose(d, rd, rtol=ck.RANK_SLACK, atol=1e-12)
    both_f64 = (d != d.astype(np.float32)) & (rd != rd.astype(np.float32))
    np.testing.assert_array_equal(d[both_f64], rd[both_f64])


def _assert_same(d, i, st, rd, ri, rst):
    """The mesh's certified result against the one-device placement's."""
    assert_same_as_one_device(
        d, i, rd, ri,
        none_repaired=st["fallback_queries"] == rst["fallback_queries"] == 0)


_ONE = {}


def _one_device(db, q, seed, **kw):
    key = (seed, tuple(sorted(kw.items())))
    if key not in _ONE:
        _ONE[key] = ShardedKNN(db, k=K, device="cpu").search_certified(
            q, margin=8, **kw)
    return _ONE[key]


@pytest.mark.parametrize("shape,merge,dcn", CASES)
def test_certified_bitwise_one_device_on_every_mesh(shape, merge, dcn):
    db, q = _data()
    port = ShardedKNN(db, mesh=port_mesh(shape), k=K, merge=merge,
                      dcn_merge=dcn)
    d, i, st = port.search_certified(q, margin=8)
    rd, ri, rst = _one_device(db, q, 0)
    assert st["fallback_queries"] == rst["fallback_queries"] == 0
    _assert_same(d, i, st, rd, ri, rst)
    np.testing.assert_array_equal(i, _oracle(db, q)[1])
    assert st["certified"] + st["fallback_queries"] == q.shape[0]
    assert st["pallas_knobs"]["precision"] == "bf16x3"


@pytest.mark.parametrize("shape", FLAT + HOST)
def test_certified_matches_jax_on_every_mesh(shape):
    db, q = _data(1)
    pd, pi, _ = ShardedKNN(db, mesh=port_mesh(shape), k=K).search_certified(
        q, margin=8)
    jd, ji, _ = JaxShardedKNN(db, mesh=jax_mesh_of(shape),
                              k=K).search_certified(q, selector="pallas",
                                                    margin=8)
    _assert_vs_jax(pd, pi, jd, ji, *_oracle(db, q))


#: every arm, kernel and grid the mesh runs per shard (pq is refused there)
ARM_CASES = [(p, "tiled", "query_major") for p in ("bf16x3", "int8",
                                                    "highest", "bf16x3f",
                                                    "int4")] + [
    (p, kern, "query_major") for p in ("bf16x3", "int8", "highest")
    for kern in ("streaming", "fused")] + [
    (p, "tiled", "db_major") for p in ("bf16x3", "int8", "highest")]


@pytest.mark.parametrize("precision,kernel,grid", ARM_CASES)
def test_certified_arms_and_kernels_per_shard(precision, kernel, grid):
    db, q = _data(2)
    kw = dict(precision=precision, kernel=kernel, grid_order=grid)
    rd, ri, rst = _one_device(db, q, 2, **kw)
    for shape in ((4, 2), (2, 2, 2)):
        d, i, st = ShardedKNN(db, mesh=port_mesh(shape),
                              k=K).search_certified(q, margin=8, **kw)
        _assert_same(d, i, st, rd, ri, rst)
        np.testing.assert_array_equal(i, _oracle(db, q)[1])
        assert st["pallas_knobs"]["kernel"] == kernel
    if precision in ("bf16x3", "int8", "highest") and grid == "query_major":
        jd, ji, _ = JaxShardedKNN(db, mesh=jax_mesh_of((4, 2)),
                                  k=K).search_certified(
            q, selector="pallas", margin=8, precision=precision,
            kernel=kernel)
        _assert_vs_jax(d, i, jd, ji, *_oracle(db, q))


@pytest.mark.parametrize("binning", ["lane", "grouped3"])
def test_certified_binning_per_shard(binning):
    db, q = _data(3)
    kw = (dict(binning="lane", bin_w=128, survivors=2)
          if binning == "lane" else dict(survivors=3))
    rd, ri, rst = _one_device(db, q, 3, **kw)
    d, i, st = ShardedKNN(db, mesh=port_mesh((2, 4)), k=K).search_certified(
        q, margin=8, **kw)
    _assert_same(d, i, st, rd, ri, rst)
    np.testing.assert_array_equal(i, _oracle(db, q)[1])


@pytest.mark.parametrize("selector", ["exact", "approx"])
@pytest.mark.parametrize("shape", [(4, 2), (2, 2, 2)])
def test_counted_selectors_match_jax_on_a_mesh(selector, shape):
    db, q = _data(4)
    pd, pi, pst = ShardedKNN(db, mesh=port_mesh(shape),
                             k=K).search_certified(q, selector=selector,
                                                   margin=8)
    jd, ji, jst = JaxShardedKNN(db, mesh=jax_mesh_of(shape),
                                k=K).search_certified(q, selector=selector,
                                                      margin=8)
    np.testing.assert_array_equal(pi, np.asarray(ji))
    np.testing.assert_array_equal(pd, np.asarray(jd))
    np.testing.assert_array_equal(pi, _oracle(db, q)[1])
    assert pst["fallback_queries"] == jst["fallback_queries"]


@pytest.mark.parametrize("metric", ["cosine", "dot"])
def test_certified_metrics_on_a_mesh(metric):
    db, q = _data(5)
    rd, ri, rst = ShardedKNN(db, k=K, metric=metric,
                             device="cpu").search_certified(q, margin=8)
    d, i, st = ShardedKNN(db, mesh=port_mesh((2, 4)), k=K,
                          metric=metric).search_certified(q, margin=8)
    _assert_same(d, i, st, rd, ri, rst)


def test_predict_certified_batches_and_fallbacks_on_a_mesh():
    db, q = _data(6, n_q=40)
    labels = (np.arange(db.shape[0]) % 4).astype(np.int32)
    # duplicated rows: exact ties around the top-k boundary
    db[100:140] = db[:40]
    mesh = ShardedKNN(db, mesh=port_mesh((2, 2, 2)), k=K, labels=labels,
                      num_classes=4)
    one = ShardedKNN(db, k=K, labels=labels, num_classes=4, device="cpu")
    got, st = mesh.predict_certified(q, batch_size=16, margin=8)
    ref, rst = one.predict_certified(q, batch_size=16, margin=8)
    np.testing.assert_array_equal(got, ref)
    d, i, _ = mesh.search_certified(q, batch_size=16, margin=8,
                                    return_distances=False)
    assert d is None
    np.testing.assert_array_equal(i, _oracle(db, q)[1])
