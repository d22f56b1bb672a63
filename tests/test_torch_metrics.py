"""The l1 and dot metrics of the port — pairwise_l1 / pairwise_dot /
pairwise_sq_l2_direct, the searches over them, and the dot placement's
norm augmentation with its certified search — against the JAX package
(make_mesh(1, 1); Pallas through its interpret mode) and float64 oracles.

Tolerances: pairwise scores within ``4 D eps_f32 scale`` of the JAX
package's (scale: the largest |score| summand, D * max|x| * max|t| for
l1 and dot); search indices equal wherever the float64 gap at rank k
exceeds twice that bound; the dot placement's rows and ``dot_shift``
BITWISE the JAX package's; certified dot indices equal the JAX package's
and the float64 MIPS oracle's, values within ``RANK_SLACK`` scaled f32
error (pallas) or 1e-12 relative (counted selectors).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knn_tpu.ops import distance as jdist
from knn_tpu.ops import topk as jtopk
from knn_tpu.parallel import sharded as jsh
from knn_tpu.parallel.mesh import make_mesh
from knn_tpu_torch import ShardedKNN
from knn_tpu_torch.convert import placement_from_numpy
from knn_tpu_torch.ops import distance as pdist
from knn_tpu_torch.ops.coarse_knn import RANK_SLACK
from knn_tpu_torch.ops.metrics import METRICS, canonical_metric
from knn_tpu_torch.ops.topk import knn_search_tiled

import oracles
from test_torch_cuda import empty_default_tune_cache  # noqa: F401 (autouse)

EPS = float(np.finfo(np.float32).eps)


def _data(seed, n=1500, dim=20, n_q=24, scale=3.0):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(n, dim)) * scale).astype(np.float32),
            (rng.normal(size=(n_q, dim)) * scale).astype(np.float32))


def _f64(metric, q, db):
    q64, t64 = q.astype(np.float64), db.astype(np.float64)
    if metric in ("l1", "manhattan"):
        return np.abs(q64[:, None, :] - t64[None, :, :]).sum(-1)
    if metric == "dot":
        return -(q64 @ t64.T)
    return oracles.sq_l2(q, db)


def _bound(metric, q, db):
    dim = q.shape[1]
    if metric in ("l1", "manhattan"):
        scale = dim * (np.abs(q).max() + np.abs(db).max())
    elif metric == "dot":
        scale = dim * np.abs(q).max() * np.abs(db).max()
    else:
        scale = dim * (np.abs(q).max() + np.abs(db).max()) ** 2
    return 4 * dim * EPS * scale


def test_every_reference_metric_is_accepted():
    assert METRICS == ("l2", "sql2", "euclidean", "l1", "manhattan",
                       "cosine", "dot")
    assert [canonical_metric(m) for m in METRICS] == [
        "l2", "l2", "l2", "l1", "l1", "cosine", "dot"]
    db, _ = _data(0, n=40)
    for m in METRICS:
        ShardedKNN(db, k=3, metric=m.upper(), device="cpu")
    with pytest.raises(ValueError, match="unknown metric"):
        ShardedKNN(db, k=3, metric="hamming", device="cpu")


@pytest.mark.parametrize("metric", ["l1", "manhattan", "dot", "l2"])
def test_pairwise_matches_jax_and_f64(metric):
    db, q = _data(1, n=300)
    got = pdist.pairwise_distance(torch.from_numpy(q), torch.from_numpy(db),
                                  metric).numpy()
    ref = np.asarray(jdist.pairwise_distance(jnp.asarray(q), jnp.asarray(db),
                                             metric))
    bound = _bound(metric, q, db)
    assert np.abs(got - ref).max() <= bound
    assert np.abs(got - _f64(metric, q, db)).max() <= bound


def test_pairwise_l1_blocks_change_no_value(monkeypatch):
    db, q = _data(2, n=130, n_q=9)
    tq, tdb = torch.from_numpy(q), torch.from_numpy(db)
    whole = pdist.pairwise_l1(tq, tdb)
    monkeypatch.setattr(pdist, "_BROADCAST_BLOCK_ELEMS", 7 * 20)
    assert torch.equal(pdist.pairwise_l1(tq, tdb), whole)


def test_sq_l2_direct_matches_jax():
    db, q = _data(3, n=200)
    got = pdist.pairwise_sq_l2_direct(torch.from_numpy(q),
                                      torch.from_numpy(db)).numpy()
    ref = np.asarray(jdist.pairwise_sq_l2_direct(jnp.asarray(q),
                                                 jnp.asarray(db)))
    assert np.abs(got - ref).max() <= _bound("l2", q, db)


@pytest.mark.parametrize("train_tile", [None, 256, 7])
@pytest.mark.parametrize("metric", ["l1", "dot"])
def test_knn_search_tiled_indices_equal_where_the_gap_is_clear(metric,
                                                               train_tile):
    db, q = _data(4)
    k = 8
    d, i = knn_search_tiled(torch.from_numpy(q), torch.from_numpy(db), k,
                            metric, train_tile=train_tile)
    jd, ji = jtopk.knn_search_tiled(jnp.asarray(q), jnp.asarray(db), k,
                                    metric, train_tile=train_tile)
    f64 = np.sort(_f64(metric, q, db), axis=-1)
    clear = (f64[:, k] - f64[:, k - 1]) > 2 * _bound(metric, q, db)
    assert clear.sum() >= q.shape[0] // 2
    np.testing.assert_array_equal(i.numpy()[clear], np.asarray(ji)[clear])
    assert np.abs(d.numpy() - np.asarray(jd)).max() <= _bound(metric, q, db)


@pytest.mark.parametrize("n_valid", [1499, 1000, 37])
@pytest.mark.parametrize("train_tile", [None, 256, 7])
@pytest.mark.parametrize("metric", ["l2", "l1"])
def test_n_valid_masks_trailing_rows_as_jax_does(metric, train_tile, n_valid):
    # rows at index >= n_valid are padding (the db-shard contract): never
    # selected, and the rest selected as from db[:n_valid] alone
    db, q = _data(9)
    k = 8
    d, i = knn_search_tiled(torch.from_numpy(q), torch.from_numpy(db), k,
                            metric, train_tile=train_tile, n_valid=n_valid)
    jd, ji = jtopk.knn_search_tiled(jnp.asarray(q), jnp.asarray(db), k,
                                    metric, train_tile=train_tile,
                                    n_valid=n_valid)
    assert int(i.max()) < n_valid and int(np.asarray(ji).max()) < n_valid
    f64 = _f64(metric, q, db[:n_valid])
    srt = np.sort(f64, axis=-1)
    clear = (srt[:, k] - srt[:, k - 1]) > 2 * _bound(metric, q, db)
    assert clear.sum() >= q.shape[0] // 2
    np.testing.assert_array_equal(i.numpy()[clear], np.asarray(ji)[clear])
    np.testing.assert_array_equal(
        i.numpy()[clear], np.argsort(f64, axis=-1, kind="stable")[clear, :k])
    assert np.abs(d.numpy() - np.asarray(jd)).max() <= _bound(metric, q, db)


@pytest.mark.parametrize("metric", ["l1", "dot"])
def test_sharded_search_matches_jax(metric):
    db, q = _data(5)
    k = 6
    jd, ji = jsh.ShardedKNN(db, mesh=make_mesh(1, 1), k=k,
                            metric=metric).search(q)
    knn = ShardedKNN(db, k=k, metric=metric, device="cpu")
    d, i = knn.search(q)
    f64 = np.sort(_f64(metric, q, db), axis=-1)
    clear = (f64[:, k] - f64[:, k - 1]) > 2 * _bound(metric, q, db)
    np.testing.assert_array_equal(i.numpy()[clear], np.asarray(ji)[clear])
    assert np.abs(d.numpy() - np.asarray(jd)).max() <= _bound(metric, q, db)
    labels = (np.arange(db.shape[0]) % 5).astype(np.int32)
    jp = jsh.ShardedKNN(db, mesh=make_mesh(1, 1), k=k, metric=metric,
                        labels=labels, num_classes=5).predict(q)
    pp = ShardedKNN(db, k=k, metric=metric, labels=labels, num_classes=5,
                    device="cpu").predict(q)
    np.testing.assert_array_equal(pp.numpy()[clear], np.asarray(jp)[clear])


# --- the dot placement ----------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_dot_placement_is_bitwise_the_jax_placement(dtype):
    rng = np.random.default_rng(6)
    db = (rng.random(size=(500, 20)) * 200).astype(dtype)
    ref = jsh.ShardedKNN(db, mesh=make_mesh(1, 1), k=4, metric="dot")
    pl = placement_from_numpy(db, metric="dot", device="cpu")
    assert pl.db_host.dtype == np.float32
    np.testing.assert_array_equal(pl.db_host, ref._train_host)
    assert pl.db_host.tobytes() == ref._train_host.tobytes()
    assert pl.dot_shift == ref._dot_shift
    assert pl.db_norm_max == ref._db_norm_max()
    assert pl.dim_in == ref.dim_in == 20
    assert torch.equal(pl.db, torch.from_numpy(ref._train_host))
    # a uint8 source under dot is cast before the augmentation: no
    # byte-exact int8 placement (the JAX package's _uint8_train is None)
    assert not pl.uint8_source and ref._uint8_train is None
    assert placement_from_numpy(db, metric="l1", device="cpu").uint8_source \
        == (dtype == np.uint8)


def test_dot_queries_gain_the_zero_column():
    db, q = _data(7, n=50)
    knn = ShardedKNN(db, k=3, metric="dot", device="cpu")
    qa = knn._to_device(q)
    assert qa.shape == (q.shape[0], 21)
    assert torch.equal(qa[:, :20], torch.from_numpy(q))
    assert not qa[:, 20].any()
    assert knn._to_device(qa).shape == qa.shape  # augmented pass as they are
    assert torch.equal(knn._to_device(torch.from_numpy(q)), qa)


def _mips_oracle(db, q, k):
    d = -(q.astype(np.float64) @ db.astype(np.float64).T)
    idx = np.lexsort((np.broadcast_to(np.arange(db.shape[0]), d.shape), d),
                     axis=-1)[:, :k]
    return np.take_along_axis(d, idx, -1), idx


@pytest.mark.parametrize("precision", ["bf16x3", "bf16x3f", "highest",
                                       "int8", "pq"])
def test_dot_certified_pallas_matches_jax_and_mips_oracle(precision):
    db, q = _data(8, n=1200, dim=24, n_q=16)
    k = 7
    od, oi = _mips_oracle(db, q, k)
    jd, ji, _ = jsh.ShardedKNN(db, mesh=make_mesh(1, 1), k=k, metric="dot"
                               ).search_certified(q, selector="pallas",
                                                  precision=precision)
    d, i, st = ShardedKNN(db, k=k, metric="dot", device="cpu"
                          ).search_certified(q, selector="pallas",
                                             precision=precision)
    np.testing.assert_array_equal(i, oi)
    np.testing.assert_array_equal(i, np.asarray(ji))
    # augmented squared L2 within RANK_SLACK relative, mapped back by /2
    q_norm2 = (q.astype(np.float64) ** 2).sum(-1)[:, None]
    aug = 2 * od + q_norm2 + float(
        (db.astype(np.float64) ** 2).sum(-1).max())
    assert (np.abs(d - od) <= RANK_SLACK * aug).all()
    assert st["pallas_knobs"]["precision"] == precision


@pytest.mark.parametrize("selector", ["exact", "approx"])
def test_dot_certified_counted_matches_jax_within_1e_12(selector):
    db, q = _data(9, n=1200, dim=24, n_q=16)
    k = 7
    od, oi = _mips_oracle(db, q, k)
    jd, ji, _ = jsh.ShardedKNN(db, mesh=make_mesh(1, 1), k=k, metric="dot"
                               ).search_certified(q, selector=selector)
    d, i, _ = ShardedKNN(db, k=k, metric="dot", device="cpu"
                         ).search_certified(q, selector=selector)
    np.testing.assert_array_equal(i, oi)
    np.testing.assert_array_equal(i, np.asarray(ji))
    np.testing.assert_allclose(d, np.asarray(jd), rtol=1e-12,
                               atol=1e-12 * np.abs(od).max())


def test_l1_certified_search_is_refused_as_jax_refuses_it():
    db, q = _data(10, n=100)
    msg = "search_certified supports the l2, cosine and dot metrics only"
    with pytest.raises(ValueError, match=msg):
        jsh.ShardedKNN(db, mesh=make_mesh(1, 1), k=3, metric="l1"
                       ).search_certified(q)
    for selector in ("pallas", "exact"):
        with pytest.raises(ValueError, match=msg):
            ShardedKNN(db, k=3, metric="l1", device="cpu").search_certified(
                q, selector=selector)
