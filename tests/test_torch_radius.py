"""Fixed-radius search of the port — ops.radius (``radius_threshold``,
``_dispatch_metric``, ``count_within``, ``radius_search``,
``check_truncation``) and ``ShardedKNN.radius_search`` — against the JAX
package (make_mesh(1, 1)).

Radii sit midway between two float64 distances of the data (the
reference tests' ``_safe_radius`` idea), so no row lies within f32
rounding of the boundary; there masks, indices and counts are EQUAL to
the JAX package's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knn_tpu.ops import radius as jrad
from knn_tpu.parallel import sharded as jsh
from knn_tpu.parallel.mesh import make_mesh
from knn_tpu_torch import ShardedKNN, radius_search
from knn_tpu_torch.convert import row_normalize_f64
from knn_tpu_torch.ops import radius as prad

import oracles
from test_torch_cuda import empty_default_tune_cache  # noqa: F401 (autouse)


def _data(seed, n=800, dim=12, n_q=20):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, dim)).astype(np.float32),
            rng.normal(size=(n_q, dim)).astype(np.float32))


def _safe_radius(q, db, metric, rank):
    """A radius midway between the rank-th and (rank+1)-th distinct
    float64 distance of the first query's row, in user units."""
    q64, t64 = q.astype(np.float64), db.astype(np.float64)
    if metric in ("l1", "manhattan", "cityblock"):
        d = np.abs(q64[:, None] - t64[None]).sum(-1)
    elif metric == "cosine":
        qn, tn = row_normalize_f64(q), row_normalize_f64(db)
        d = 1.0 - qn.astype(np.float64) @ tn.astype(np.float64).T
    else:
        d = np.sqrt(oracles.sq_l2(q, db))
    vals = np.unique(d.ravel())
    # the widest gap among the values around the wanted count: no row
    # lies within f32 rounding of the boundary
    j = int(np.searchsorted(vals, np.sort(d, axis=-1)[:, rank].mean()))
    lo, hi = max(1, j - 20), min(len(vals) - 1, j + 20)
    g = lo + int(np.argmax(vals[lo:hi] - vals[lo - 1 : hi - 1]))
    return 0.5 * (vals[g - 1] + vals[g])


@pytest.mark.parametrize("metric", ["l2", "sql2", "euclidean", "l1",
                                    "manhattan", "cityblock", "cosine",
                                    "dot"])
@pytest.mark.parametrize("radius", [0.0, 1.5, -1.0])
def test_radius_threshold_and_dispatch_equal_the_reference(metric, radius):
    assert prad._dispatch_metric(metric) == jrad._dispatch_metric(metric)
    try:
        want = jrad.radius_threshold(radius, metric)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split("(")[0][:30]):
            prad.radius_threshold(radius, metric)
    else:
        assert prad.radius_threshold(radius, metric) == want


@pytest.mark.parametrize("metric", ["l2", "l1", "cityblock", "cosine"])
@pytest.mark.parametrize("train_tile", [None, 96])
def test_radius_search_equals_jax(metric, train_tile):
    db, q = _data(1)
    r = _safe_radius(q, db, metric, 12)
    jd, ji, jc = jrad.radius_search(jnp.asarray(q), jnp.asarray(db), r,
                                    max_neighbors=16, metric=metric,
                                    train_tile=train_tile)
    d, i, c = radius_search(torch.from_numpy(q), torch.from_numpy(db), r,
                            max_neighbors=16, metric=metric,
                            train_tile=train_tile)
    ji, jc = np.asarray(ji), np.asarray(jc)
    np.testing.assert_array_equal(c.numpy(), jc)
    np.testing.assert_array_equal(i.numpy(), ji)
    np.testing.assert_array_equal(np.isinf(d.numpy()), np.isinf(np.asarray(jd)))
    assert (c.numpy() > 0).any()
    np.testing.assert_array_equal(
        c.numpy(),
        prad.count_within(torch.from_numpy(db), torch.from_numpy(q),
                          prad.radius_threshold(r, metric), metric,
                          tile=50).numpy())


@pytest.mark.parametrize("metric", ["l2", "cosine", "l1"])
def test_sharded_radius_search_equals_jax(metric):
    db, q = _data(2)
    r = _safe_radius(q, db, metric, 10)
    jd, ji, jc = jsh.ShardedKNN(db, mesh=make_mesh(1, 1), k=5, metric=metric
                                ).radius_search(q, r, max_neighbors=14)
    d, i, c = ShardedKNN(db, k=5, metric=metric, device="cpu"
                         ).radius_search(q, r, max_neighbors=14)
    np.testing.assert_array_equal(c, np.asarray(jc))
    np.testing.assert_array_equal(i, np.asarray(ji))
    np.testing.assert_array_equal(np.isinf(d), np.isinf(np.asarray(jd)))
    within = i != prad.SENTINEL_IDX
    np.testing.assert_allclose(d[within], np.asarray(jd)[within], rtol=1e-5)
    # truncation is visible: some queries count more rows than the width
    assert (c > 14).any()
    assert (within.sum(-1) == np.minimum(c, 14)).all()


def test_truncation_is_flagged_and_checked():
    db, q = _data(3)
    _, _, c = radius_search(torch.from_numpy(q), torch.from_numpy(db), 3.0,
                            max_neighbors=4)
    assert (c.numpy() > 4).any()
    with pytest.raises(ValueError, match="max_neighbors=4"):
        prad.check_truncation(c.numpy(), 4, "aggregate the nearest 4")
    prad.check_truncation(c.numpy(), int(c.max()), "aggregate")


def test_sharded_radius_refuses_dot_and_half_placements():
    db, q = _data(4, n=100)
    with pytest.raises(ValueError, match="radius semantics undefined"):
        jsh.ShardedKNN(db, mesh=make_mesh(1, 1), k=3, metric="dot"
                       ).radius_search(q, 1.0, max_neighbors=4)
    with pytest.raises(ValueError, match="radius semantics undefined"):
        ShardedKNN(db, k=3, metric="dot", device="cpu").radius_search(
            q, 1.0, max_neighbors=4)
    for dt in ("bfloat16", "float16"):
        with pytest.raises(ValueError, match="float32 placement"):
            ShardedKNN(db, k=3, compute_dtype=dt, device="cpu").radius_search(
                q, 1.0, max_neighbors=4)
    with pytest.raises(ValueError, match="max_neighbors"):
        ShardedKNN(db, k=3, device="cpu").radius_search(q, 1.0,
                                                        max_neighbors=0)


def test_l1_radius_takes_the_single_pass_path(monkeypatch):
    db, q = _data(5)
    calls = []
    real = prad.radius_search

    def spy(*a, **kw):
        calls.append(kw["metric"])
        return real(*a, **kw)

    monkeypatch.setattr(prad, "radius_search", spy)
    d, i, c = ShardedKNN(db, k=3, metric="manhattan", device="cpu"
                         ).radius_search(q, 9.0, max_neighbors=5000)
    assert calls == ["l1"]
    assert i.shape == (q.shape[0], db.shape[0])  # capped at n_train
    assert ((i != prad.SENTINEL_IDX).sum(-1) == c).all()
