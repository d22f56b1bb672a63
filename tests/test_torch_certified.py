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
from test_torch_cuda import empty_default_tune_cache  # noqa: F401 (autouse)


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


def test_certify_pack_matches_jax_tail():
    # the device certificate on identical ranked candidates: same window,
    # same near-tie mask, same bad flags -- the JAX tail given the bounds
    # lowered by the port's extra proved slack (bf16_tolerance_scale over
    # the reference's 2^-14, ROADMAP divergence 18); row 4's bound sits
    # inside that extra slack, so only the port's tolerance flags it
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
    q_norm = (q.astype(np.float64) ** 2).sum(-1)
    lb = (d32[:, k - 1] - q_norm + rng.normal(size=n_q)).astype(np.float32)
    w = min(k + 17, m + 1)
    new_scale = ck.bf16_tolerance_scale("bf16x3", 1)
    extra = (new_scale - 2.0 ** -14) * (q_norm + 3.0)
    lb[4] = (d32[4, k - 1] - q_norm[4]
             + ck.RANK_SLACK * float(d32[4, k - 1])
             + (2.0 ** -14 + new_scale) / 2 * (q_norm[4] + 3.0))

    def spmd(qs, ds, ls, bs):
        return _certify_pack_spmd(
            qs, jnp.zeros((50, 8)), ds, ls, bs, consts=None,
            db_norm_max=np.float32(3.0), precision="bf16x3",
            quant_offset=0.0, m=m, k=k, w=w, merge="allgather", n_train=50,
            hosts=1, chips=1, include_distances=True)

    prog = jax.jit(shard_map_compat(
        spmd, mesh=make_mesh(1, 1), in_specs=(P(QUERY_AXIS),) * 4,
        out_specs=P(QUERY_AXIS), check_vma=False))
    def jax_tail(bounds):
        packed = prog(jnp.asarray(q), jnp.asarray(d32), jnp.asarray(li),
                      jnp.asarray(bounds))
        return unpack_certified(np.asarray(packed), k, w, True)

    jgi, jtight, jbad, jdk = jax_tail((lb - extra).astype(np.float32))
    assert not jax_tail(lb)[2][4]  # the reference's 2^-14 passes row 4
    pgi, ptight, pbad, pdk = _certify_pack(
        torch.from_numpy(q), torch.from_numpy(d32),
        torch.from_numpy(li.astype(np.int64)), torch.from_numpy(lb),
        db_norm_max=3.0, m=m, k=k, w=w, n_train=50, include_distances=True)
    np.testing.assert_array_equal(pgi.numpy(), jgi)
    np.testing.assert_array_equal(ptight.numpy(), jtight)
    np.testing.assert_array_equal(pbad.numpy(), jbad)
    assert pbad[4]
    np.testing.assert_array_equal(pdk.numpy(), jdk)


# --- fault 18: the bf16x3 / bf16x3f slack, proved (coarse_knn.
# bf16_tolerance_scale; proofs in csrc/binned_select.cuh and
# csrc/binned_mma.cuh)

@pytest.mark.parametrize("precision", ["bf16x3", "bf16x3f"])
@pytest.mark.parametrize("dim", [24, 128, 300, 896])
def test_bf16_tolerance_is_never_below_the_jax_tolerance(precision, dim):
    from knn_tpu.ops import pallas_knn as jpk

    rng = np.random.default_rng(dim)
    q = (rng.normal(size=(16, dim)) * 10).astype(np.float32)
    db = (rng.normal(size=(200, dim)) * 10).astype(np.float32)
    port = ck.kernel_tolerance(q, db, precision=precision)
    ref = jpk.kernel_tolerance(q, db, precision=precision)
    assert (port >= ref).all()
    nd = -(-dim // ck.DIM_CHUNK)
    scale = ck.bf16_tolerance_scale(precision, nd)
    assert scale > 2.0 ** -14  # the proved terms pass the reference's
    q64, db64 = q.astype(np.float64), db.astype(np.float64)
    np.testing.assert_allclose(
        port, scale * ((q64 ** 2).sum(-1) + (db64 ** 2).sum(-1).max()),
        rtol=1e-12)


def _split_error(x):
    """x.x - (xh.xh + xh.xl + xl.xh) in float64 for f32 values x, the
    parts split as the kernels split them."""
    xh, xl = (a.double().numpy() for a in ck.split_bf16(torch.from_numpy(x)))
    x64 = x.astype(np.float64)
    return x64 * x64 - (xh * xh + xh * xl + xl * xh)


def _split_worst_values(count):
    """The f32 values in [1, 1 + 2^-8) whose split errs most (x.x
    against its three products), from a sweep of all 2^15 of them: the
    high part is 1 for each (so the errors of two such values add, where
    values rounding up would cancel them), the low part nears 2^-8 and its
    own rounding half its ulp, both errors positive."""
    one = np.float32(1.0).view(np.int32)
    x = (one + np.arange(2 ** 15, dtype=np.int32)).view(np.float32)
    rel = _split_error(x) / (x.astype(np.float64) ** 2)
    return x[np.argsort(-rel)[:count]]


@pytest.mark.parametrize("dim", [128, 896])
def test_fault18_split_worst_case_stays_inside_the_new_tolerance(dim):
    # every dim's split error at (nearly) its largest and of one sign:
    # queries and rows whose every value is one of the worst values
    vals = _split_worst_values(8)
    rng = np.random.default_rng(dim)
    q = vals[rng.integers(0, 8, size=(6, dim))]
    db = vals[rng.integers(0, 8, size=(256, dim))]
    q64, db64 = q.astype(np.float64), db.astype(np.float64)
    scale = (q64 ** 2).sum(-1) + (db64 ** 2).sum(-1).max()
    # the split alone: q.t - (three products), in s, over (||q||^2 + M)
    qh, ql = (a.double().numpy() for a in ck.split_bf16(torch.from_numpy(q)))
    th, tl = (a.double().numpy() for a in ck.split_bf16(torch.from_numpy(db)))
    split_s = 2.0 * (q64 @ db64.T - (qh @ th.T + qh @ tl.T + ql @ th.T))
    ratio = np.abs(split_s).max(-1) / scale
    assert (split_s > 0).all()
    # near two thirds of the proved 3 * 2^-16 (1 + 2^-7): e_q and e_t reach
    # 2^-17 |x|, the dropped ql.tl 2^-16 |q t|
    assert (ratio > 0.48 * 2.0 ** -14).all()
    assert (ratio <= ck.SPLIT_SCALE).all()
    # the plain version's scores against f64 scores of the f32 values,
    # every row a bin of its own (tile_n = 128: row r is survivor 0 of
    # bin r % 128 of its tile only when it is the bin's smallest, so
    # compare every emitted candidate)
    tol = ck.kernel_tolerance(q, db, precision="bf16x3")
    qp = ck.pad_queries(torch.from_numpy(q))
    th_t, tl_t, tnorm = ck.prepare_db(torch.from_numpy(db), ck.BIN_W)
    cd, ci, _ = ck.binned_select_plain(qp, th_t, tl_t, tnorm,
                                       tile_n=ck.BIN_W, arm="bf16x3")
    s64 = (db64 ** 2).sum(-1)[None, :] - 2.0 * q64 @ db64.T
    real = ci.numpy() < db.shape[0]
    assert real[:, :128].all()
    got = np.take_along_axis(s64, np.where(real, ci.numpy(), 0), 1)
    err = np.where(real, np.abs(cd.numpy().astype(np.float64) - got), 0.0)
    assert (err.max(-1) <= tol).all()
    over_old = err.max(-1) > 2.0 ** -14 * scale
    if over_old.any():  # the reference's slack would not have held
        assert (err.max(-1)[over_old] <= tol[over_old]).all()


def _model_chunk(a, b, block):
    """One 128-dim chunk's dot in the tensor-core step model, [Q, N]: 8
    k-steps of ck.MMA_K exact products, from a zero accumulator."""
    acc = np.zeros((a.shape[0], b.shape[0]))
    for k0 in range(0, a.shape[1], ck.MMA_K):
        p = (a[:, None, k0:k0 + ck.MMA_K].astype(np.float64)
             * b[None, :, k0:k0 + ck.MMA_K])
        acc = ck.mma_step_model(acc, p, block)
    return acc


@pytest.mark.parametrize("block", [8, 16])
def test_mma_step_model_stays_inside_the_stated_terms(block):
    u = ck.U32
    rng = np.random.default_rng(block)
    # one step: kappa u (|c| + sum |p|), on random signs and on products
    # just under the accumulator's truncation unit (each one dropped)
    c = rng.normal(size=(64, 32)) * 100
    p = rng.normal(size=(64, 32, ck.MMA_K))
    c[0] = 1.0
    p[0] = 0.99 * 2.0 ** -23
    got = ck.mma_step_model(c, p, block)
    exact = c + p.sum(-1)
    bound = ck.MMA_KAPPA * u * (np.abs(c) + np.abs(p).sum(-1))
    assert (np.abs(got - exact) <= bound).all()
    assert np.abs(got - exact)[0].max() > 0.6 * bound[0].max()  # truncated
    # one chunk (8 steps): (8 kappa + 1) u P -- all-positive bf16 values,
    # and a first product of 1 followed by 127 products each truncated away
    vals = ck.split_bf16(torch.from_numpy(
        rng.uniform(1.0, 2.0, size=(8, 128)).astype(np.float32)))[0]
    a = vals.double().numpy()
    b = a[::-1].copy()
    cases = [(a, b)]
    big = np.full((1, 128), 2.0 ** -12)
    big[0, 0] = 1.0
    cases.append((big, np.where(np.arange(128) == 0, 1.0,
                                0.99 * 2.0 ** -11)[None, :]))
    coef = ck.accumulation_coefficient("bf16x3", 1)
    for x, y in cases:
        got = _model_chunk(x, y, block)
        exact = x @ y.T
        p_sum = np.abs(x) @ np.abs(y).T
        assert (np.abs(got - exact) <= coef * u * p_sum).all()
    # the adversarial chunk loses ~7 x 16 truncated products: more than a
    # round-to-nearest chain would
    assert np.abs(got - exact).max() > 100 * u * p_sum.max()


# --- K4 (bf16x3f) on tensor cores: 24 k-steps a chunk into one accumulator
# (csrc/binned_mma.cuh), its proved coefficient and tolerances

def _k4_chunked_sums(q, t, block=8):
    """K4's qt in the tensor-core step model, in the kernel's k-order: per
    128-dim chunk, per 16-dim k-step, qh.th, qh.tl, ql.th into one
    accumulator from 0; the chunk sums added in f32.  Returns (qt as f32
    values in float64, the exact f64 sum of the three products, P = the sum
    of their magnitudes)."""
    qh, ql = (a.double().numpy() for a in ck.split_bf16(torch.from_numpy(q)))
    th, tl = (a.double().numpy() for a in ck.split_bf16(torch.from_numpy(t)))
    pairs = [(qh, th), (qh, tl), (ql, th)]
    total = None
    p_sum = np.zeros((q.shape[0], t.shape[0]))
    for c in range(0, q.shape[1], ck.DIM_CHUNK):
        acc = np.zeros((q.shape[0], t.shape[0]))
        for k0 in range(c, c + ck.DIM_CHUNK, ck.MMA_K):
            for a, b in pairs:
                p = a[:, None, k0:k0 + ck.MMA_K] * b[None, :, k0:k0 + ck.MMA_K]
                acc = ck.mma_step_model(acc, p, block)
                p_sum += np.abs(p).sum(-1)
        chunk = acc.astype(np.float32)
        total = chunk if total is None else total + chunk
    exact = sum(a @ b.T for a, b in pairs)
    return total.astype(np.float64), exact, p_sum


@pytest.mark.parametrize("dim", [128, 896])
@pytest.mark.parametrize("data", ["all_positive", "fault18"])
def test_k4_one_accumulator_replay_stays_inside_its_coefficient(dim, data):
    # the numpy replay of K4's chunk in the kernel's k-order errs by no more
    # than accumulation_coefficient("bf16x3f") u P, on all-positive values
    # (every partial sum grows) and on fault 18's construction (the split's
    # worst values), and the whole score by less than the new tolerance
    rng = np.random.default_rng(dim + len(data))
    if data == "all_positive":
        q = rng.uniform(1.0, 2.0, size=(4, dim)).astype(np.float32)
        t = rng.uniform(1.0, 2.0, size=(48, dim)).astype(np.float32)
    else:
        vals = _split_worst_values(8)
        q = vals[rng.integers(0, 8, size=(4, dim))]
        t = vals[rng.integers(0, 8, size=(48, dim))]
    nd = dim // ck.DIM_CHUNK
    got, exact, p_sum = _k4_chunked_sums(q, t)
    coef = ck.accumulation_coefficient("bf16x3f", nd)
    assert (np.abs(got - exact) <= coef * ck.U32 * p_sum).all()
    if data == "all_positive":
        assert np.abs(got - exact).max() > 0  # the model rounds
    q64, t64 = q.astype(np.float64), t.astype(np.float64)
    scale = (q64 ** 2).sum(-1)[:, None] + (t64 ** 2).sum(-1).max()
    s_err = 2.0 * np.abs(q64 @ t64.T - got)  # split + summation, in s
    assert (s_err <= ck.bf16_tolerance_scale("bf16x3f", nd) * scale).all()


@pytest.mark.parametrize("block", [8, 16])
def test_k4_one_accumulator_adversarial_chunk(block):
    # a first product of 1, then 383 products each below the accumulator's
    # truncation unit: the replay drops them, and stays inside the bound
    q = np.full((1, 128), np.float32(2.0 ** -6))
    t = np.full((1, 128), np.float32(0.99 * 2.0 ** -6))
    q[0, 0] = t[0, 0] = 1.0
    got, exact, p_sum = _k4_chunked_sums(q, t, block)
    coef = ck.accumulation_coefficient("bf16x3f", 1)
    err = np.abs(got - exact)
    assert (err <= coef * ck.U32 * p_sum).all()
    assert err.max() > 100 * ck.U32 * p_sum.max()


@pytest.mark.parametrize("nd", [1, 7])
def test_bf16x3f_tolerance_is_the_proved_sum(nd):
    u = ck.U32
    coef = (24 * ck.MMA_KAPPA + nd - 1) * (1 + 2.0 ** -7)
    assert ck.accumulation_coefficient("bf16x3f", nd) == coef
    scale = ck.bf16_tolerance_scale("bf16x3f", nd)
    assert scale == ck.SPLIT_SCALE + coef * u + ck.HEADROOM_SCALE
    assert scale >= 2.0 ** -14
    assert scale >= ck.bf16_tolerance_scale("bf16x3", nd)
    if nd == 1:  # Dp = 128
        assert scale / 2.0 ** -14 == pytest.approx(1.76318359375, abs=1e-12)


@pytest.mark.parametrize("arm,terms", [("bf16x3", 128), ("bf16x3f", 384),
                                       ("default", 128)])
@pytest.mark.parametrize("nd", [1, 7])
def test_kernel_plain_tolerance_is_the_proved_sum(arm, terms, nd):
    # the kernel's summation bound plus the plain version's (one f32 product
    # of ``terms`` products a chunk in any order, the chunk adds), plus both
    # roundings of s
    plain = (terms + nd) * (1 + 2.0 ** -7)
    want = (ck.accumulation_coefficient(arm, nd) + plain + 4) * ck.U32
    assert ck.kernel_plain_tolerance_scale(arm, nd) == want


# --- K3 (default) on the bf16 tensor cores: 8 k-steps of qh.th a chunk
# into one accumulator (csrc/binned_mma.cuh), its proved coefficient and
# the kernel-vs-plain tolerance that stands on it

def _k3_chunked_sums(q, t, block=8):
    """K3's qt in the tensor-core step model, in the walk's k-order: per
    128-dim chunk, per 16-dim k-step, qh.th into one accumulator from 0;
    the chunk sums added in f32.  Returns (qt as f32 values in float64, qh
    and th as float64: the bf16 operands, whose products are exact)."""
    qh = ck.split_bf16(torch.from_numpy(q))[0].double().numpy()
    th = ck.split_bf16(torch.from_numpy(t))[0].double().numpy()
    total = None
    for c in range(0, q.shape[1], ck.DIM_CHUNK):
        acc = np.zeros((q.shape[0], t.shape[0]))
        for k0 in range(c, c + ck.DIM_CHUNK, ck.MMA_K):
            p = qh[:, None, k0:k0 + ck.MMA_K] * th[None, :, k0:k0 + ck.MMA_K]
            acc = ck.mma_step_model(acc, p, block)
        chunk = acc.astype(np.float32)
        total = chunk if total is None else total + chunk
    return total.astype(np.float64), qh, th


def _k3_data(dim, data):
    rng = np.random.default_rng(dim + len(data))
    if data == "all_positive":  # values of many magnitudes, so steps round
        q, t = (rng.uniform(1.0, 2.0, size=(n, dim))
                * 2.0 ** rng.integers(-8, 8, size=(n, dim))
                for n in (3, 5))
        q, t = q.astype(np.float32), t.astype(np.float32)
    else:  # rows nearly orthogonal to every query: |q.t| << P
        q = rng.normal(size=(3, dim))
        t = rng.normal(size=(5, dim))
        basis, _ = np.linalg.qr(q.T)
        t = t - (t @ basis) @ basis.T
        q, t = q.astype(np.float32), t.astype(np.float32)
    return q, t


@pytest.mark.parametrize("dim", [128, 896])
@pytest.mark.parametrize("data", ["all_positive", "cancelling"])
@pytest.mark.parametrize("block", [8, 16])
def test_k3_replay_stays_inside_its_coefficient(dim, data, block):
    # the numpy replay of K3's chunk sums in the walk's k-order errs by no
    # more than accumulation_coefficient("default") u P of the exact sum of
    # its bf16 products (Fractions), on all-positive values (every partial
    # sum grows) and on cancelling ones (rows orthogonal to the queries)
    from fractions import Fraction

    q, t = _k3_data(dim, data)
    nd = dim // ck.DIM_CHUNK
    got, qh, th = _k3_chunked_sums(q, t, block)
    exact, p_sum = _exact_dot(qh, th)
    coef = Fraction(ck.accumulation_coefficient("default", nd))
    worst = 0.0
    for i in range(q.shape[0]):
        for j in range(t.shape[0]):
            err = abs(Fraction(float(got[i, j])) - exact[i][j])
            assert err <= coef * Fraction(ck.U32) * p_sum[i][j]
            worst = max(worst, float(err / p_sum[i][j]))
    if data == "all_positive":
        assert worst > 0  # the model truncates
    else:  # the sums cancel: |q.t| is far below P
        assert max(abs(float(exact[i][j] / p_sum[i][j]))
                   for i in range(3) for j in range(5)) < 0.1


@pytest.mark.parametrize("dim", [128, 896])
@pytest.mark.parametrize("data", ["all_positive", "cancelling"])
def test_k3_replay_against_the_plain_version_inside_the_tolerance(dim, data):
    # K3's scores in the step model against its plain version on the CPU
    # (binned_select_plain: an f32 matmul a chunk) stay within
    # kernel_plain_tolerance_scale("default", nd) (||q||^2 + M); tile_n =
    # 128 puts every row's score in survivor 0 of its bin
    q, t = _k3_data(dim, data)
    t = np.concatenate([t] * 26)[:128]   # one full 128-row tile
    nd = -(-dim // ck.DIM_CHUNK)
    ops = (ck.pad_queries(torch.from_numpy(q)),
           *ck.prepare_db_arm(torch.from_numpy(t), ck.BIN_W, "default"))
    cd, ci, _ = ck.binned_select_plain(*ops, tile_n=ck.BIN_W, arm="default")
    got, _, _ = _k3_chunked_sums(q, t)
    tn = ops[-1][0].double().numpy()
    s_model = (tn[None, :] - 2.0 * got).astype(np.float32)
    plain = cd.numpy()[:, :ck.BIN_W].astype(np.float64)
    model = np.take_along_axis(s_model, ci.numpy()[:, :ck.BIN_W], 1)
    q64, t64 = q.astype(np.float64), t.astype(np.float64)
    scale = (q64 ** 2).sum(-1) + (t64 ** 2).sum(-1).max()
    err = np.abs(plain - model).max(-1)
    assert (err <= ck.kernel_plain_tolerance_scale("default", nd) * scale).all()


@pytest.mark.parametrize("nd", [1, 7])
def test_default_tolerance_is_proved_and_above_two_f32_chains(nd):
    # K3's kernel-vs-plain tolerance is the proved sum (8 kappa + nd - 1 +
    # 128 + nd)(1 + 2^-7) + 4 -- 456.5 u at Dp = 128, where 128 u stood
    # unproved -- and never below what two f32 FMA chains of the same
    # products could differ by, (256 + 2 nd + 4) u; default keeps no
    # certificate tolerance, as the reference
    u = ck.U32
    coef = (8 * ck.MMA_KAPPA + nd - 1) * (1 + 2.0 ** -7)
    assert ck.accumulation_coefficient("default", nd) == coef
    scale = ck.kernel_plain_tolerance_scale("default", nd)
    assert scale == (coef + (128 + nd) * (1 + 2.0 ** -7) + 4) * u
    assert scale >= (256 + 2 * nd + 4) * u
    if nd == 1:
        assert scale / u == pytest.approx(456.5078125, abs=1e-9)
    with pytest.raises(ValueError, match="no certified tolerance"):
        ck.kernel_tolerance(np.zeros((2, 128 * nd), np.float32),
                            np.ones((4, 128 * nd), np.float32),
                            precision="default")


# --- K2 (highest) on the FP64 tensor cores: 16 m16n8k8 steps a chunk into
# one f64 accumulator (csrc/binned_mma.cuh), the step model the card's probe
# checks, and the tolerances that stand on it

def _k2_dmma_chunked_sums(q, t, reverse=False):
    """K2's qt as the FP64 tensor-core walk sums it: per 128-dim chunk, 16
    k-steps of ck.DMMA_K products in dim order (step s takes dims 8s ..
    8s+7), each step's products added to the f64 accumulator in the step
    model (in dim order, or reversed: the model allows any order), the
    chunk rounded once to f32, the chunks added in f32.  Returns qt as f32
    values in float64."""
    q64, t64 = q.astype(np.float64), t.astype(np.float64)
    total = None
    for c in range(0, q.shape[1], ck.DIM_CHUNK):
        acc = np.zeros((q.shape[0], t.shape[0]))
        for k0 in range(c, c + ck.DIM_CHUNK, ck.DMMA_K):
            p = q64[:, None, k0:k0 + ck.DMMA_K] * t64[None, :, k0:k0 + ck.DMMA_K]
            acc = ck.dmma_step_model(acc, p[..., ::-1] if reverse else p)
        chunk = acc.astype(np.float32)
        total = chunk if total is None else total + chunk
    return total.astype(np.float64)


def _exact_dot(q, t):
    """The exact q.t and P = sum |q_i t_i| of every (query, row) pair, as
    Fractions."""
    from fractions import Fraction

    qf = [[Fraction(float(x)) for x in row] for row in q]
    tf = [[Fraction(float(x)) for x in row] for row in t]
    exact = [[sum(a * b for a, b in zip(qr, tr)) for tr in tf] for qr in qf]
    p_sum = [[sum(abs(a * b) for a, b in zip(qr, tr)) for tr in tf]
             for qr in qf]
    return exact, p_sum


@pytest.mark.parametrize("dim", [128, 896])
@pytest.mark.parametrize("data", ["all_positive", "cancelling"])
@pytest.mark.parametrize("reverse", [False, True])
def test_k2_dmma_replay_stays_inside_its_coefficient(dim, data, reverse):
    # the numpy replay of K2's chunk sums in the walk's k-order errs by no
    # more than accumulation_coefficient("highest") u P of the exact dot
    # (Fractions), on all-positive values (every partial sum grows) and on
    # cancelling ones (rows near the negated query: |q.t| << P)
    from fractions import Fraction

    rng = np.random.default_rng(dim + len(data))
    if data == "all_positive":
        q = rng.uniform(1.0, 2.0, size=(3, dim)).astype(np.float32)
        t = rng.uniform(1.0, 2.0, size=(5, dim)).astype(np.float32)
    else:
        q = rng.normal(size=(3, dim)).astype(np.float32)
        t = np.concatenate([
            -q + rng.normal(size=(3, dim)).astype(np.float32) * 1e-3,
            rng.normal(size=(2, dim)).astype(np.float32)]).astype(np.float32)
    nd = dim // ck.DIM_CHUNK
    got = _k2_dmma_chunked_sums(q, t, reverse)
    exact, p_sum = _exact_dot(q, t)
    coef = Fraction(ck.accumulation_coefficient("highest", nd))
    worst = 0.0
    for i in range(q.shape[0]):
        for j in range(t.shape[0]):
            err = abs(Fraction(float(got[i, j])) - exact[i][j])
            assert err <= coef * Fraction(ck.U32) * p_sum[i][j]
            worst = max(worst, float(err / p_sum[i][j]))
    if data == "all_positive":
        assert worst > 0  # the f32 roundings are there


def test_k2_dmma_step_model_bound_and_the_probe_cases():
    # one step: DMMA_K 2^-53 (|c| + sum |p|) on random exact products, and
    # the probe's constructed cases replayed on the CPU inside the model
    rng = np.random.default_rng(53)
    c = rng.normal(size=(64, 32)) * 100
    a = rng.normal(size=(64, 32, ck.DMMA_K)).astype(np.float32)
    b = rng.normal(size=(64, 32, ck.DMMA_K)).astype(np.float32)
    p = a.astype(np.float64) * b
    got = ck.dmma_step_model(c, p)
    exact = c + p.sum(-1)
    assert (np.abs(got - exact)
            <= ck.DMMA_K * ck.U64 * (np.abs(c) + np.abs(p).sum(-1))).all()
    report = ck.dmma_rounding_probe("cpu")
    assert set(report) == {"half_ulp_tie", "eight_half_ulp_ties",
                           "far_below_the_accumulator",
                           "cancellation_after_a_tie",
                           "cancellation_of_the_accumulator", "random"}
    for name, r in report.items():
        assert r["max_error_over_bound"] <= 1.0, (name, r)
        assert r["chain_in_k_order"], name  # the CPU runs the model's chain
    # eight ties each rounded away by a chain reach the bound: the model is
    # tight for a round-to-nearest chain
    assert report["eight_half_ulp_ties"]["max_error_over_bound"] > 0.99


def test_dmma_probe_refuses_other_operands():
    a = torch.zeros((16, ck.DMMA_K), dtype=torch.float64)
    b = torch.zeros((8, ck.DMMA_K), dtype=torch.float64)
    c = torch.zeros((16, 8), dtype=torch.float64)
    before = ck.dmma_probe.launches
    assert torch.equal(ck.dmma_probe(a, b, c), c)
    assert ck.dmma_probe.launches == before  # the CPU runs the model
    with pytest.raises(ValueError, match="float64"):
        ck.dmma_probe(a.float(), b, c)
    with pytest.raises(ValueError, match="float64"):
        ck.dmma_probe(a, b[:4], c)


@pytest.mark.parametrize("nd", [1, 7])
def test_highest_tolerances_stand_on_the_dmma_model(nd):
    # the FP64 tensor cores keep highest's proof: its summation coefficient,
    # its kernel-vs-plain tolerance and its certificate (the reference's
    # 32 eps_f32 (||q||^2 + M)) are what they were on CUDA cores
    u = ck.U32
    assert ck.accumulation_coefficient("highest", nd) == nd * (1 + 2.0 ** -20)
    assert ck.kernel_plain_tolerance_scale("highest", nd) == (2 * nd + 4) * u
    # a chunk's 16 steps err by <= 128 2^-53 P_c: 2^-22 of its f32 rounding
    assert 16 * ck.DMMA_K * ck.U64 <= 2.0 ** -22 * u
    rng = np.random.default_rng(nd)
    q = rng.normal(size=(5, 128 * nd)).astype(np.float32)
    db = rng.normal(size=(40, 128 * nd)).astype(np.float32)
    scale = ((q.astype(np.float64) ** 2).sum(-1)
             + (db.astype(np.float64) ** 2).sum(-1).max())
    eps = float(np.finfo(np.float32).eps)
    np.testing.assert_allclose(
        ck.kernel_tolerance(q, db, precision="highest"), 32 * eps * scale,
        rtol=1e-12)
