"""The port's estimators — KNNRegressor (and knn_regress,
_weighted_targets), NearestNeighbors with its CSR graph exports, the
radius estimators and KNNClassifier's new metrics, compute_dtype and
kneighbors — against the JAX package's.

Tolerances: indices, labels, counts and CSR triples are EQUAL (radii off
the data's distances, as in test_torch_radius); weighted means within
1e-6 relative; distances within f32 rounding (1e-5 relative).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knn_tpu.models import neighbors as jnb
from knn_tpu.models import radius as jradm
from knn_tpu.models import regressor as jreg
from knn_tpu.models.classifier import KNNClassifier as JaxClassifier
from knn_tpu.parallel.mesh import make_mesh
from knn_tpu_torch import (KNNClassifier, KNNRegressor, NearestNeighbors,
                           RadiusNeighborsClassifier, RadiusNeighborsRegressor)
from knn_tpu_torch.models import regressor as preg

from test_torch_cuda import empty_default_tune_cache  # noqa: F401 (autouse)
from test_torch_radius import _safe_radius


def _data(seed, n=900, dim=10, n_q=30):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, dim)).astype(np.float32)
    Q = rng.normal(size=(n_q, dim)).astype(np.float32)
    y = (X[:, 0] * 2 + X[:, 1] ** 2).astype(np.float32)
    labels = (np.abs(X[:, 2] * 3).astype(np.int32) % 4).astype(np.int32)
    return X, Q, y, labels


@pytest.mark.parametrize("metric", ["l2", "l1", "cosine", "dot"])
@pytest.mark.parametrize("weights", ["uniform", "distance"])
def test_regressor_matches_jax(weights, metric):
    X, Q, y, _ = _data(1)
    # the JAX package's placed (meshed) regressor, whose cosine rows are
    # normalized in float64 as the port's are; for dot its single-device
    # path (the meshed one hands dot queries to the augmented placement
    # without their zero column)
    mesh = None if metric == "dot" else make_mesh(1, 1)
    ref = np.asarray(jreg.KNNRegressor(k=7, metric=metric, weights=weights,
                                       mesh=mesh).fit(X, y).predict(Q))
    got = KNNRegressor(k=7, metric=metric, weights=weights, device="cpu"
                       ).fit(X, y).predict(Q)
    assert got.dtype == np.float32 and got.shape == (Q.shape[0],)
    np.testing.assert_allclose(got, ref, rtol=1e-6,
                               atol=1e-6 * np.abs(y).max())


@pytest.mark.parametrize("weights", ["uniform", "distance"])
def test_knn_regress_and_multi_output_targets_match_jax(weights):
    X, Q, y, _ = _data(2)
    Y = np.stack([y, -y, y * 0.5], axis=1)
    ref = np.asarray(jreg.knn_regress(jnp.asarray(X), jnp.asarray(Y),
                                      jnp.asarray(Q), k=5, weights=weights,
                                      train_tile=128))
    got = preg.knn_regress(torch.from_numpy(X), torch.from_numpy(Y),
                           torch.from_numpy(Q), k=5, weights=weights,
                           train_tile=128).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6,
                               atol=1e-6 * np.abs(Y).max())


def test_weighted_targets_snap_exact_duplicates_to_zero():
    # a query on a db row: its squared distance lands in the cancellation
    # band and counts as 0, so the duplicate's target dominates
    X, _, y, _ = _data(3, n=200)
    Q = X[:5].copy()
    got = KNNRegressor(k=4, weights="distance", device="cpu").fit(X, y
                                                                  ).predict(Q)
    ref = np.asarray(jreg.KNNRegressor(k=4, weights="distance").fit(X, y)
                     .predict(Q))
    np.testing.assert_allclose(got, y[:5], rtol=1e-6)
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    d = torch.tensor([[0.0, 4.0]])
    t = torch.tensor([[1.0, 3.0]])
    w = preg._weighted_targets(d, t, "distance", "l2")
    assert torch.allclose(w, torch.tensor([1.0]))  # DIST_FLOOR: no inf/nan
    with pytest.raises(ValueError, match="unknown weights"):
        KNNRegressor(weights="cubic", device="cpu")


@pytest.mark.parametrize("metric", ["l2", "l1", "cosine"])
def test_nearest_neighbors_matches_jax(metric):
    X, Q, _, _ = _data(4)
    r = _safe_radius(Q, X, metric, 9)
    jnn = jnb.NearestNeighbors(k=6, radius=r, max_neighbors=12, metric=metric,
                               mesh=make_mesh(1, 1)).fit(X)
    nn = NearestNeighbors(k=6, radius=r, max_neighbors=12, metric=metric,
                          device="cpu").fit(X)
    assert nn.n_samples_fit == jnn.n_samples_fit
    jd, ji = jnn.kneighbors(Q, return_sqrt=True)
    d, i = nn.kneighbors(Q, return_sqrt=True)
    np.testing.assert_array_equal(i, np.asarray(ji))
    np.testing.assert_allclose(d, np.asarray(jd), rtol=1e-5, atol=1e-6)
    for got, want in zip(nn.radius_neighbors(Q), jnn.radius_neighbors(Q)):
        if got.dtype.kind == "f":
            np.testing.assert_array_equal(np.isinf(got), np.isinf(np.asarray(want)))
        else:
            np.testing.assert_array_equal(got, np.asarray(want))
    for mode in ("connectivity", "distance"):
        for got, want in zip(nn.kneighbors_graph(Q, mode=mode),
                             jnn.kneighbors_graph(Q, mode=mode)):
            if mode == "distance" and got.dtype.kind == "f":
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
            else:
                np.testing.assert_array_equal(got, want)
        got = nn.radius_neighbors_graph(Q, mode=mode, strict=False)
        want = jnn.radius_neighbors_graph(Q, mode=mode, strict=False)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
    # the self-graph: every fit row among its own neighbors
    _, ind, ptr = nn.kneighbors_graph(k=3)
    assert ptr[-1] == 3 * X.shape[0]
    assert (ind.reshape(-1, 3) == np.arange(X.shape[0])[:, None]).any(-1).all()


def test_radius_graph_strict_mode_raises_on_truncation():
    X, Q, _, _ = _data(5)
    nn = NearestNeighbors(radius=3.0, max_neighbors=2, device="cpu").fit(X)
    with pytest.raises(ValueError, match="max_neighbors=2"):
        nn.radius_neighbors_graph(Q)
    with pytest.raises(ValueError, match="no radius"):
        NearestNeighbors(device="cpu").fit(X).radius_neighbors(Q)


@pytest.mark.parametrize("metric", ["l2", "l1", "cosine"])
@pytest.mark.parametrize("normalize", [False, True])
def test_radius_classifier_matches_jax(metric, normalize):
    X, Q, _, labels = _data(6)
    r = _safe_radius(Q, X, metric, 15)
    kw = dict(max_neighbors=64, metric=metric, normalize=normalize,
              outlier_label=9, strict=False)
    if normalize:  # the train-only min-max rescales the data: its radius
        lo, hi = X.min(0), X.max(0)
        r = _safe_radius((Q - lo) / (hi - lo), (X - lo) / (hi - lo), metric, 15)
    ref = np.asarray(jradm.RadiusNeighborsClassifier(r, **kw).fit(X, labels)
                     .predict(Q))
    clf = RadiusNeighborsClassifier(r, device="cpu", **kw).fit(X, labels)
    np.testing.assert_array_equal(clf.predict(Q), ref)
    assert clf.score(Q, ref) == 1.0


@pytest.mark.parametrize("weights", ["uniform", "distance"])
def test_radius_regressor_matches_jax(weights):
    X, Q, y, _ = _data(7)
    r = _safe_radius(Q, X, "l2", 12)
    kw = dict(weights=weights, max_neighbors=128, outlier_value=-1.0)
    ref = np.asarray(jradm.RadiusNeighborsRegressor(r, **kw).fit(X, y)
                     .predict(Q))
    reg = RadiusNeighborsRegressor(r, device="cpu", **kw).fit(X, y)
    np.testing.assert_allclose(reg.predict(Q), ref, rtol=1e-6, atol=1e-6)
    assert abs(reg.score(Q, ref) - 1.0) < 1e-6


def test_radius_estimators_refuse_as_jax_does():
    X, Q, y, labels = _data(8, n=100)
    with pytest.raises(ValueError, match="radius semantics undefined"):
        RadiusNeighborsClassifier(1.0, metric="dot", device="cpu")
    clf = RadiusNeighborsClassifier(0.01, device="cpu").fit(X, labels)
    with pytest.raises(ValueError, match="no neighbors within"):
        clf.predict(Q)
    reg = RadiusNeighborsRegressor(5.0, max_neighbors=3, device="cpu").fit(X, y)
    with pytest.raises(ValueError, match="max_neighbors=3"):
        reg.predict(Q)
    with pytest.raises(RuntimeError, match="fit"):
        RadiusNeighborsRegressor(1.0, device="cpu").predict(Q)


@pytest.mark.parametrize("metric,dtype", [("l1", None), ("dot", None),
                                          ("l2", "bfloat16")])
def test_classifier_takes_every_metric_and_compute_dtype(metric, dtype):
    X, Q, _, labels = _data(9)
    jdt = None if dtype is None else jnp.bfloat16
    # dot: the JAX package's single-device path (its meshed classifier
    # hands device-array queries to the augmented placement without their
    # zero column)
    mesh = None if metric == "dot" else make_mesh(1, 1)
    jclf = JaxClassifier(k=5, metric=metric, compute_dtype=jdt,
                         mesh=mesh).fit(X, labels)
    clf = KNNClassifier(k=5, metric=metric, compute_dtype=dtype,
                        device="cpu").fit(X, labels)
    np.testing.assert_array_equal(clf.predict(Q), np.asarray(jclf.predict(Q)))
    jd, ji = jclf.kneighbors(Q, return_sqrt=True)
    d, i = clf.kneighbors(Q, return_sqrt=True)
    np.testing.assert_array_equal(i, np.asarray(ji))
    np.testing.assert_allclose(d, np.asarray(jd), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("selector", ["exact", "approx", "pallas"])
def test_classifier_certified_kneighbors_match_jax(selector):
    X, Q, _, labels = _data(10)
    jclf = JaxClassifier(k=5, mode="certified", selector=selector,
                         mesh=make_mesh(1, 1), batch_size=8).fit(X, labels)
    clf = KNNClassifier(k=5, mode="certified", selector=selector,
                        batch_size=8, device="cpu").fit(X, labels)
    np.testing.assert_array_equal(clf.predict(Q), np.asarray(jclf.predict(Q)))
    jd, ji = jclf.kneighbors(Q)
    d, i = clf.kneighbors(Q)
    np.testing.assert_array_equal(i, np.asarray(ji))
    np.testing.assert_allclose(d, np.asarray(jd), rtol=1e-5)
    with pytest.raises(ValueError, match="l2 and cosine"):
        KNNClassifier(mode="certified", metric="dot", device="cpu")
