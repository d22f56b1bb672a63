"""The port's counted ``exact`` / ``approx`` selectors and ``compute_dtype``
against the JAX package (make_mesh(1, 1)) and the float64 oracle.

Tolerances: certified indices are EQUAL to the JAX package's and the
oracle's; distances equal the JAX package's float64 values within 1e-12
relative (both refine in float64); the counts of the counted certificate
equal float64 counts (its thresholds are midpoints of gaps wider than
twice the f32 tolerance, or the k-th distance plus it).  bf16 scores stay
within the bf16 model, inputs rounded to bf16 and summed in f32:
``2^-8 (||q||^2 + ||t||^2)``.
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
from knn_tpu_torch.ops import certified as pcert
from knn_tpu_torch.ops import distance as pdist
from knn_tpu_torch.ops.topk import knn_search, knn_search_approx
from knn_tpu_torch.utils.config import SELECTORS

import oracles
from test_torch_cuda import empty_default_tune_cache  # noqa: F401 (autouse)

N, D, NQ, K = 2000, 24, 40, 10


def _data(seed=0, n=N, dim=D, n_q=NQ):
    rng = np.random.default_rng(seed)
    db = (rng.normal(size=(n, dim)) * 4).astype(np.float32)
    q = (rng.normal(size=(n_q, dim)) * 4).astype(np.float32)
    return db, q


def _lexsort_topk(d, k):
    idx = np.lexsort((np.broadcast_to(np.arange(d.shape[1]), d.shape), d),
                     axis=-1)[:, :k]
    return idx


def _oracle_idx(db, q, k, metric):
    """float64 lexicographic top-k: squared L2, unit-vector squared L2
    (cosine: rows normalized in f64, as both placements do) or negative
    inner product (dot, f64 MIPS)."""
    if metric == "dot":
        d = -(q.astype(np.float64) @ db.astype(np.float64).T)
    elif metric == "cosine":
        from knn_tpu_torch.convert import row_normalize_f64

        d = oracles.sq_l2(row_normalize_f64(q), row_normalize_f64(db))
    else:
        d = oracles.sq_l2(q, db)
    return _lexsort_topk(d, k)


def test_selectors_are_the_reference_three():
    assert SELECTORS == jsh.SELECTORS == ("exact", "approx", "pallas")


@pytest.mark.parametrize("batch_size", [None, 16])
@pytest.mark.parametrize("metric", ["l2", "cosine", "dot"])
@pytest.mark.parametrize("selector", ["exact", "approx"])
def test_counted_selectors_match_jax_and_oracle(selector, metric, batch_size):
    db, q = _data(1)
    jd, ji, jst = jsh.ShardedKNN(db, mesh=make_mesh(1, 1), k=K,
                                 metric=metric).search_certified(
        q, selector=selector, batch_size=batch_size)
    d, i, st = ShardedKNN(db, k=K, metric=metric, device="cpu"
                          ).search_certified(q, selector=selector,
                                             batch_size=batch_size)
    np.testing.assert_array_equal(i, np.asarray(ji))
    np.testing.assert_array_equal(i, _oracle_idx(db, q, K, metric))
    scale = float(np.abs(np.asarray(jd)).max())
    np.testing.assert_allclose(d, np.asarray(jd), rtol=1e-12,
                               atol=1e-12 * scale)
    assert st["certified"] + st["fallback_queries"] == NQ
    assert set(st) == set(jst)  # the same stats keys as the JAX package


def test_counted_certificate_counts_equal_float64_counts(monkeypatch):
    # the f32 count of each batch, against a float64 direct-difference
    # count of the rows strictly below the same thresholds
    db, q = _data(2)
    seen = []
    real = pcert.count_below

    def spy(db_t, q_t, thr, **kw):
        out = real(db_t, q_t, thr, **kw)
        seen.append((q_t.numpy().copy(), thr.numpy().copy(), out.numpy()))
        return out

    monkeypatch.setattr(pcert, "count_below", spy)
    ShardedKNN(db, k=K, device="cpu").search_certified(
        q, selector="exact", batch_size=16)
    assert len(seen) == 3
    for qb, thr, counts in seen:
        d64 = oracles.sq_l2(qb, db)
        np.testing.assert_array_equal(counts, (d64 < thr[:, None]).sum(-1))


def test_counted_selector_flags_a_tie_past_the_margin():
    # every row repeated: a gapless window makes the count exceed js for
    # some queries, and the repair keeps the indices exact
    rng = np.random.default_rng(3)
    base = rng.integers(-3, 4, size=(150, 4)).astype(np.float32)
    db = np.concatenate([base] * 4)
    q = base[:12]
    d, i, st = ShardedKNN(db, k=6, device="cpu").search_certified(
        q, selector="exact", margin=2)
    _, ji, jst = jsh.ShardedKNN(db, mesh=make_mesh(1, 1), k=6
                                ).search_certified(q, selector="exact",
                                                   margin=2)
    np.testing.assert_array_equal(i, np.asarray(ji))
    np.testing.assert_array_equal(i, _lexsort_topk(oracles.sq_l2(q, db), 6))
    assert st["fallback_queries"] == jst["fallback_queries"] > 0


@pytest.mark.parametrize("selector", ["exact", "approx"])
def test_predict_certified_takes_the_counted_selectors(selector):
    db, q = _data(4)
    labels = (np.arange(N) % 7).astype(np.int32)
    jl, _ = jsh.ShardedKNN(db, mesh=make_mesh(1, 1), k=K, labels=labels,
                           num_classes=7).predict_certified(q, selector=selector)
    pl, st = ShardedKNN(db, k=K, labels=labels, num_classes=7, device="cpu"
                        ).predict_certified(q, selector=selector)
    np.testing.assert_array_equal(pl, np.asarray(jl))
    assert "pallas_knobs" not in st


def test_approx_search_is_the_exact_topk_and_recall_target_is_inert():
    # ROADMAP divergence 21: no ApproxTopK on CUDA; off the TPU the JAX
    # package's own approx_max_k is an exact top-k as well
    db, q = _data(5)
    tq, tdb = torch.from_numpy(q), torch.from_numpy(db)
    d, i = knn_search_approx(tq, tdb, K, recall_target=0.5)
    d2, i2 = knn_search_approx(tq, tdb, K, recall_target=0.9999)
    _, ei = knn_search(tq, tdb, K)
    _, ji = jtopk.knn_search_approx(jnp.asarray(q), jnp.asarray(db), K)
    assert torch.equal(i, i2) and torch.equal(d, d2)
    np.testing.assert_array_equal(i.numpy(), ei.numpy())
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(i.numpy(), _oracle_idx(db, q, K, "l2"))


def test_approx_search_breaks_ties_low():
    db = np.zeros((9, 3), np.float32)
    db[::2] = 1.0  # even rows tie at one value, odd rows at another
    q = np.zeros((2, 3), np.float32)
    _, i = knn_search_approx(torch.from_numpy(q), torch.from_numpy(db), 5)
    assert i.tolist() == [[1, 3, 5, 7, 0]] * 2


# --- compute_dtype -------------------------------------------------------------


@pytest.mark.parametrize("dt", [None, "float32", "bfloat16", "float16",
                                torch.bfloat16, torch.float16, torch.float32])
def test_dtype_key_is_the_reference_name(dt):
    db, _ = _data(6, n=64)
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16,
           torch.float32: jnp.float32}.get(dt, dt)
    ref = jsh.ShardedKNN(db, mesh=make_mesh(1, 1), k=3, compute_dtype=jdt)
    assert ShardedKNN(db, k=3, compute_dtype=dt, device="cpu")._dtype_key \
        == ref._dtype_key


@pytest.mark.parametrize("dt", ["int8", torch.float64, "float8"])
def test_other_compute_dtypes_are_refused_by_name(dt):
    db, _ = _data(6, n=64)
    with pytest.raises(ValueError, match="compute_dtype"):
        ShardedKNN(db, k=3, compute_dtype=dt, device="cpu")


@pytest.mark.parametrize("metric", ["l2", "cosine", "dot"])
@pytest.mark.parametrize("dt", ["bfloat16", "float16"])
def test_half_scores_inside_the_half_model(metric, dt):
    db, q = _data(7, n=300)
    got = pdist.pairwise_distance(torch.from_numpy(q), torch.from_numpy(db),
                                  metric, compute_dtype=dt).numpy()
    assert got.dtype == np.float32
    ref = np.asarray(jdist.pairwise_distance(
        jnp.asarray(q), jnp.asarray(db), metric, compute_dtype=dt))
    if metric == "cosine":
        from knn_tpu_torch.convert import row_normalize_f64

        qn, tn = row_normalize_f64(q), row_normalize_f64(db)
        exact = 0.5 * oracles.sq_l2(qn, tn)  # 1 - cos
        norms = np.ones((q.shape[0], db.shape[0]))
    else:
        q64, t64 = q.astype(np.float64), db.astype(np.float64)
        exact = (oracles.sq_l2(q, db) if metric == "l2"
                 else -(q64 @ t64.T))
        norms = (q64 ** 2).sum(-1)[:, None] + (t64 ** 2).sum(-1)[None, :]
    unit = 2.0 ** -8 if dt == "bfloat16" else 2.0 ** -11
    bound = unit * norms
    assert (np.abs(got - exact) <= bound).all()
    # the JAX package's bf16 product on the CPU is the same model
    assert (np.abs(ref - exact) <= bound).all()
    # scores are not rounded to the half dtype: far finer than its ulp
    assert np.abs(got - ref).max() <= 64 * np.finfo(np.float32).eps * norms.max()


def test_half_matmul_form_on_the_cpu_is_the_f32_product_of_rounded_inputs():
    assert pdist.half_matmul_form("cpu") == "f32_of_rounded"
    db, q = _data(8, n=50)
    tq, tdb = torch.from_numpy(q), torch.from_numpy(db)
    want = tq.bfloat16().float() @ tdb.bfloat16().float().T
    assert torch.equal(pdist._dot(tq, tdb, "bfloat16"), want)


@pytest.mark.parametrize("selector", ["exact", "approx", "pallas"])
def test_bf16_placement_certified_indices_stay_exact(selector):
    db, q = _data(9)
    jd, ji, _ = jsh.ShardedKNN(db, mesh=make_mesh(1, 1), k=K,
                               compute_dtype=jnp.bfloat16).search_certified(
        q, selector=selector)
    d, i, st = ShardedKNN(db, k=K, compute_dtype="bfloat16", device="cpu"
                          ).search_certified(q, selector=selector)
    np.testing.assert_array_equal(i, _oracle_idx(db, q, K, "l2"))
    np.testing.assert_array_equal(i, np.asarray(ji))
    if selector == "pallas":
        assert "|bfloat16|" in st["tuning"]["cache_key"]
    else:
        np.testing.assert_allclose(d, np.asarray(jd), rtol=1e-12)


def test_bf16_search_matches_jax_within_the_model():
    db, q = _data(10)
    jd, ji = jsh.ShardedKNN(db, mesh=make_mesh(1, 1), k=K,
                            compute_dtype=jnp.bfloat16).search(q)
    d, i = ShardedKNN(db, k=K, compute_dtype="bfloat16", device="cpu").search(q)
    jd, ji = np.asarray(jd), np.asarray(ji)
    norms = (q.astype(np.float64) ** 2).sum(-1)[:, None] + float(
        (db.astype(np.float64) ** 2).sum(-1).max())
    assert (np.abs(d.numpy() - jd) <= 2.0 ** -8 * norms).all()
    # indices equal wherever the bf16 scores leave a gap wider than twice
    # the cross-framework difference at rank k
    full = np.asarray(jdist.pairwise_sq_l2(jnp.asarray(q), jnp.asarray(db),
                                           compute_dtype=jnp.bfloat16))
    srt = np.sort(full, axis=-1)
    clear = (srt[:, K] - srt[:, K - 1]) > 2 * 64 * np.finfo(np.float32).eps \
        * norms[:, 0]
    np.testing.assert_array_equal(i.numpy()[clear], ji[clear])


def test_tuner_key_carries_the_compute_dtype(tmp_path):
    from knn_tpu.tuning import cache as jcache
    from knn_tpu_torch import tuning

    key = tuning.cache_key("cpu", 700, 16, 5, "l2", "bfloat16")
    ref = jcache.cache_key("cpu", 700, 16, 5, "l2", "bfloat16")
    assert key.split("|rl")[0] == ref.split("|rl")[0]
    assert "|bfloat16|" in key
    assert tuning.cache_key("cpu", 700, 16, 5, "l2") == \
        tuning.cache_key("cpu", 700, 16, 5, "l2", None)
