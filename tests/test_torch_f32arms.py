"""The f32-family coarse arms bf16x3f (K4), highest (K2) and default (K3),
the db-major grid (K9) and the counted certificate of the port, against
the JAX package (Pallas in interpret mode on CPU) and the float64 oracle.

f32 scores are never compared bitwise across frameworks: cd and bounds
agree within the arm's ``kernel_tolerance``, ci is equal wherever a bin's
values are separated by more than that.  JAX's ``Precision.DEFAULT`` is a
full f32 dot on the CPU, so the port's K3 (the TPU's one bf16 pass) is
held against a numpy model of that product instead, and against the JAX
package only through the exact end result (ROADMAP queue C, divergence
14).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knn_tpu.ops import certified as jcert
from knn_tpu.ops import pallas_knn as jpk
from knn_tpu.parallel import sharded as jsh
from knn_tpu.parallel.mesh import make_mesh
from knn_tpu_torch import (count_below, knn_search_certified,
                           knn_search_pallas, pallas_candidate_fn)
from knn_tpu_torch.ops import certified as pcert
from knn_tpu_torch.ops import coarse_knn as ck
from knn_tpu_torch.parallel.sharded import ShardedKNN
from test_torch_cuda import (_assert_ci_separated, _assert_scores, _data,
                             _f32_operands, _tol)

import oracles
from test_torch_cuda import empty_default_tune_cache  # noqa: F401 (autouse)

CERT_ARMS = ["bf16x3f", "highest"]


def _oracle(db, q, k):
    d = oracles.sq_l2(q, db)
    idx = np.lexsort((np.broadcast_to(np.arange(db.shape[0]), d.shape), d),
                     axis=-1)[:, :k]
    return np.take_along_axis(d, idx, axis=-1), idx


def _bf16(x):
    """x rounded to bfloat16 by JAX's astype, as f64."""
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16)
                      .astype(jnp.float32)).astype(np.float64)


# --- the raw kernels ---------------------------------------------------------


@pytest.mark.parametrize("arm", CERT_ARMS)
@pytest.mark.parametrize("dim,kernel", [(24, "tiled"), (300, "tiled"),
                                        (24, "streaming")])
def test_plain_k4_k2_match_pallas_bin_candidates(arm, dim, kernel):
    rng = np.random.default_rng(dim + len(arm))
    q, db = _data(rng, 11, 5 * 128 + 60, dim)  # ragged rows
    ref = jpk._bin_candidates(
        jnp.asarray(q), jnp.asarray(db), block_q=8, tile_n=256, bin_w=128,
        survivors=2, precision=arm, interpret=True, binning="grouped",
        grid_order="query_major", kernel=kernel)
    ref = [np.asarray(a)[: q.shape[0]] for a in ref]
    port = [a.numpy() for a in ck._bin_candidates(
        torch.from_numpy(q), torch.from_numpy(db), tile_n=256,
        precision=arm, kernel=kernel)]
    assert [a.shape for a in port] == [a.shape for a in ref]
    tol = ck.kernel_tolerance(q, db, precision=arm)
    _assert_scores(port[0], ref[0], tol)
    _assert_scores(port[2], ref[2], tol)
    _assert_ci_separated(ref[0], port[1], ref[1], ref[2], tol)


@pytest.mark.parametrize("dim", [24, 300])
def test_plain_k3_matches_the_bf16_product_model(dim):
    # K3 is the TPU's one bf16 pass: bf16_rn(q) . bf16_rn(t), f32 sums;
    # the model takes the same rounded operands (JAX's astype) and exact
    # f64 products, then the same emitter
    rng = np.random.default_rng(dim + 7)
    q, db = _data(rng, 13, 5 * 128 + 60, dim)
    ops = _f32_operands("cpu", "default", q, db, 256)
    port = ck.binned_select_plain(*ops, tile_n=256, arm="default")
    qp, th, tnorm = ops
    assert torch.equal(th.float(), torch.from_numpy(
        _bf16(ck._pad_db(torch.from_numpy(db), 256).numpy())).float())
    s_model = (tnorm[0].double().numpy()[None, :]
               - 2.0 * _bf16(qp.numpy()) @ _bf16(th.float().numpy()).T)
    model = ck._select_tiles(
        lambda ti, rows: torch.from_numpy(s_model[:, rows]).float(),
        th.shape[0] // 256, 256)
    port, model = ([a.numpy() for a in out] for out in (port, model))
    tol = _tol(q, db)  # (128 + nd) u P of f32 sums, well inside it
    _assert_scores(port[0], model[0], tol)
    _assert_scores(port[2], model[2], tol)
    _assert_ci_separated(model[0], port[1], model[1], model[2], tol)
    # and it is not the f32 product: the bf16 rounding shows
    exact = (tnorm[0].double().numpy()[None, :]
             - 2.0 * qp.double().numpy() @ ck._pad_db(
                 torch.from_numpy(db), 256).double().numpy().T)
    real = port[1] < db.shape[0]
    got = np.take_along_axis(exact, np.where(real, port[1], 0), 1)
    assert np.abs(port[0] - got)[real].max() > tol.max()


@pytest.mark.parametrize("arm", ["bf16x3", "bf16x3f", "highest"])
def test_fault12_chunked_sums_stay_inside_the_bound_at_dp896(arm):
    # all-positive products at Dp = 896 (7 chunks): the kernels' order of
    # summation, replayed in numpy f32 / f64 (bf16x3, bf16x3f: the
    # tensor-core step model of csrc/binned_mma.cuh, coarse_knn.
    # accumulation_coefficient), errs by no more than the bound the
    # headers state, and s by less than the reference's tolerance; a
    # single chain of 3 Dp terms has a bound past it
    rng = np.random.default_rng(12)
    q = rng.uniform(1.0, 2.0, size=(4, 896)).astype(np.float32)
    t = rng.uniform(1.0, 2.0, size=(128, 896)).astype(np.float32)
    u, nd = 2.0 ** -24, 7
    scale = (q.astype(np.float64) ** 2).sum(-1)[:, None] + \
        (t.astype(np.float64) ** 2).sum(-1).max()
    if arm == "highest":
        terms = [[(q[:, d, None].astype(np.float64) * t[None, :, d])
                  for d in range(c, c + 128)] for c in range(0, 896, 128)]
        total = np.zeros((4, 128), np.float32)
        for chunk in terms:
            total = total + np.sum(chunk, axis=0).astype(np.float32)
        exact = q.astype(np.float64) @ t.astype(np.float64).T
        bound = nd * u * exact * (1 + 2.0 ** -20)
        tol = 32 * 2.0 ** -23 * scale
    else:
        qh, ql = (a.float().numpy() for a in ck.split_bf16(torch.from_numpy(q)))
        th, tl = (a.float().numpy() for a in ck.split_bf16(torch.from_numpy(t)))
        pairs = [(qh, th), (qh, tl), (ql, th)]

        def steps(a, b, c):  # [4, 128, 16] exact products of each k-step
            for k0 in range(c, c + 128, ck.MMA_K):
                yield (a[:, None, k0:k0 + ck.MMA_K].astype(np.float64)
                       * b[None, :, k0:k0 + ck.MMA_K])

        total = np.zeros((4, 128), np.float32)
        p_sum = np.zeros((4, 128))
        for c in range(0, 896, 128):
            # the tensor-core kernels, in the header's step model (blocks
            # of 8, truncating alignment): per k-step qh.th, qh.tl, ql.th
            # -- bf16x3 into hi, lo, lo, then hi + lo in f32; bf16x3f all
            # three into one accumulator
            hi = lo = np.zeros((4, 128))
            for ph, phl, plh in zip(*(steps(a, b, c) for a, b in pairs)):
                hi = ck.mma_step_model(hi, ph)
                if arm == "bf16x3":
                    lo = ck.mma_step_model(ck.mma_step_model(lo, phl), plh)
                else:
                    hi = ck.mma_step_model(ck.mma_step_model(hi, phl), plh)
                p_sum += sum(np.abs(x).sum(-1) for x in (ph, phl, plh))
            cacc = (hi.astype(np.float32) + lo.astype(np.float32)
                    if arm == "bf16x3" else hi.astype(np.float32))
            total = total + cacc
        exact = sum(a.astype(np.float64) @ b.astype(np.float64).T
                    for a, b in pairs)
        bound = ck.accumulation_coefficient(arm, nd) * u * p_sum
        tol = 2.0 ** -14 * scale
        # the old single chain's bound in s: 3 Dp u (||q||^2 + M) > tol
        assert (3 * 896 * u * scale > tol).all()
    err = np.abs(total.astype(np.float64) - exact)
    assert (err <= bound).all()
    assert (2 * bound < tol).all()
    # the port's plain version at the same shape, against f64 scores
    qp = ck.pad_queries(torch.from_numpy(q))
    ops = _f32_operands("cpu", arm, q, t, 128)
    cd, ci, _ = ck.binned_select_plain(*ops, tile_n=128, arm=arm)
    t64 = t.astype(np.float64)
    s64 = (t64 ** 2).sum(-1)[None, :] - 2.0 * qp.double().numpy() @ t64.T
    real = ci.numpy() < t.shape[0]  # one row per bin: survivor 1 is empty
    assert real[:, :128].all()
    got = np.take_along_axis(s64, np.where(real, ci.numpy(), 0), 1)
    err = np.where(real, np.abs(cd.numpy() - got), 0.0)
    assert (err <= tol.max(-1, keepdims=True)).all()


def test_grid_caps_and_operand_checks():
    ck.check_grid(4096, 65535, "db_major")
    ck.check_grid(10 ** 7, 62, "db_major")  # query blocks ride on x
    with pytest.raises(ValueError, match="db-major grid"):
        ck.check_grid(4096, 65536, "db_major")
    ck.check_grid(65535 * 32, 10 ** 6)
    with pytest.raises(ValueError, match="batch_size"):
        ck.check_grid(65535 * 32 + 1, 1)
    rng = np.random.default_rng(1)
    q, db = _data(rng, 4, 256, 128)
    ops = _f32_operands("cpu", "highest", q, db, 256)
    before = (dict(ck.binned_select.launches),
              dict(ck.binned_select.db_major_launches))
    got = ck.binned_select(*ops, tile_n=256, arm="highest",
                           grid_order="db_major")
    for a, b in zip(got, ck.binned_select_plain(*ops, tile_n=256,
                                                arm="highest")):
        assert torch.equal(a, b)  # CPU: the plain version, nothing counted
    assert (ck.binned_select.launches,
            ck.binned_select.db_major_launches) == before
    bf = _f32_operands("cpu", "bf16x3", q, db, 256)
    with pytest.raises(ValueError, match="takes 3 operands"):
        ck.binned_select(*bf, tile_n=256, arm="default")
    with pytest.raises(ValueError, match="must be float32"):
        ck.binned_select(bf[0], bf[1], bf[3], tile_n=256, arm="highest")
    # the arm is named, never inferred: the operands must be its own
    with pytest.raises(ValueError, match="int8 tensor"):
        ck.stream_select(*bf, tile_n=256, arm="int8")
    with pytest.raises(ValueError, match="not in"):
        ck.fused_select(*bf, tile_n=256, keep=15, arm="nope")
    with pytest.raises(ValueError, match="precision='pq'"):
        ck.fused_select(*bf, tile_n=256, keep=15, arm="pq")
    with pytest.raises(TypeError, match="arm"):
        ck.binned_select(*bf, tile_n=256)
    with pytest.raises(ValueError, match="grid_order"):
        ck.binned_select(*bf, tile_n=256, arm="bf16x3", grid_order="diagonal")


# --- the one-pass certificate ------------------------------------------------


def _search_data(seed=0):
    rng = np.random.default_rng(seed)
    db = (rng.normal(size=(1500, 24)) * 10).astype(np.float32)
    q = (rng.normal(size=(40, 24)) * 10).astype(np.float32)
    db[700:720] = db[:20]  # exact duplicates across tiles
    q[1] = db[3]
    return q, db


@pytest.mark.parametrize("arm", CERT_ARMS)
def test_search_certified_f32_arms_match_jax_and_oracle(arm):
    q, db = _search_data()
    _, oi = _oracle(db, q, 5)
    kw = dict(selector="pallas", margin=8, tile_n=256, precision=arm)
    _, ji, _ = jsh.ShardedKNN(db, mesh=make_mesh(1, 1), k=5).search_certified(
        q, **kw)
    port = ShardedKNN(db, k=5, device="cpu")
    out = {}
    for cfg in ({"kernel": "tiled"}, {"kernel": "tiled",
                                      "grid_order": "db_major"},
                {"kernel": "streaming"}, {"kernel": "fused"}):
        d, i, stats = port.search_certified(q, **kw, **cfg)
        np.testing.assert_array_equal(i, oi)
        np.testing.assert_array_equal(i, np.asarray(ji))
        assert stats["pallas_knobs"]["precision"] == arm
        assert stats["fallback_queries"] + stats["certified"] == 40
        out[tuple(cfg.values())] = (d, i)
    ref = out[("tiled",)]
    for d, i in out.values():
        np.testing.assert_array_equal(d, ref[0])
        np.testing.assert_array_equal(i, ref[1])
    if arm == "highest":  # the padded f32 rows are built once and kept
        t, tnorm = port._coarse_parts(256, "highest")
        assert t is port._coarse_parts(256, "highest")[0]
        n = db.shape[0]
        np.testing.assert_array_equal(t[:n, :24].numpy(), db)
        assert tnorm.shape == (8, t.shape[0]) and t.dtype == torch.float32


@pytest.mark.parametrize("arm", CERT_ARMS)
def test_f32_arm_overlap_pipeline_is_bitwise_the_sequential_path(arm):
    q, db = _search_data(1)
    port = ShardedKNN(db, k=5, device="cpu")
    kw = dict(selector="pallas", margin=8, tile_n=256, batch_size=8,
              kernel="fused", precision=arm)
    d0, i0, _ = port.search_certified(q, overlap=False, **kw)
    d1, i1, s1 = port.search_certified(q, overlap=True, **kw)
    np.testing.assert_array_equal(d0, d1)
    np.testing.assert_array_equal(i0, i1)
    assert s1["pipeline"]["batches"] == 5
    np.testing.assert_array_equal(i1, _oracle(db, q, 5)[1])


def test_predict_certified_and_knn_search_pallas_take_the_f32_arms():
    q, db = _search_data(2)
    labels = (np.arange(db.shape[0]) % 4).astype(np.int32)
    port = ShardedKNN(db, k=5, labels=labels, num_classes=4, device="cpu")
    ref = port.predict(q).numpy()
    jknn = jsh.ShardedKNN(db, mesh=make_mesh(1, 1), k=5, labels=labels,
                          num_classes=4)
    _, oi = _oracle(db, q, 5)
    for arm in CERT_ARMS:
        jl, _ = jknn.predict_certified(q, selector="pallas", tile_n=256,
                                       margin=8, precision=arm)
        for kern in ck.KERNELS:
            got, stats = port.predict_certified(q, margin=8, tile_n=256,
                                                precision=arm, kernel=kern)
            np.testing.assert_array_equal(got, ref)
            np.testing.assert_array_equal(got, np.asarray(jl))
            assert stats["pallas_knobs"]["precision"] == arm
        _, i, _ = knn_search_pallas(q, db, 5, tile_n=256, margin=8,
                                    precision=arm, grid_order="db_major",
                                    device="cpu")
        np.testing.assert_array_equal(i, oi)


def test_search_certified_refuses_default_as_jax_does():
    q, db = _search_data(3)
    with pytest.raises(ValueError, match="tolerance model"):
        jsh.ShardedKNN(db, mesh=make_mesh(1, 1), k=5).search_certified(
            q, selector="pallas", precision="default")
    with pytest.raises(ValueError, match="tolerance model"):
        ShardedKNN(db, k=5, device="cpu").search_certified(
            q, precision="default")


# --- the counted certificate -------------------------------------------------


def _blobs(seed, n=1500, dim=24):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(12, dim)) * 10
    db = (centers[rng.integers(0, 12, size=n)]
          + rng.normal(size=(n, dim))).astype(np.float32)
    q = (centers[rng.integers(0, 12, size=30)]
         + rng.normal(size=(30, dim))).astype(np.float32)
    db[900:910] = db[:10]
    return q, db


@pytest.mark.parametrize("precision", ["bf16x3", "highest", "default",
                                       "int8", None])
def test_knn_search_certified_matches_jax_and_oracle(precision):
    q, db = _blobs(4)
    k = 10
    od, oi = _oracle(db, q, k)
    if precision is None:
        jfn = pfn = None
    else:
        jfn = jcert.pallas_candidate_fn(precision=precision, tile_n=256)
        pfn = pallas_candidate_fn(precision=precision, tile_n=256)
    jd, ji, jstats = jcert.knn_search_certified(q, db, k, candidate_fn=jfn)
    pd, pi, pstats = knn_search_certified(q, db, k, candidate_fn=pfn,
                                          device="cpu")
    np.testing.assert_array_equal(pi, oi)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(pd, od, rtol=1e-12)
    np.testing.assert_allclose(pd, jd, rtol=1e-13)
    assert pstats["fallback_queries"] + pstats["certified"] == q.shape[0]


def test_pallas_knn_candidates_pad_a_whole_db_request():
    # m >= n: n - 1 real candidates, the rest the sentinel (pallas_knn.py
    # :1499-1513)
    rng = np.random.default_rng(5)
    q, db = _data(rng, 6, 40, 16)
    got = ck.pallas_knn_candidates(torch.from_numpy(q), torch.from_numpy(db),
                                   60, tile_n=128, precision="highest")
    ref = np.asarray(jpk.pallas_knn_candidates(
        jnp.asarray(q), jnp.asarray(db), 60, tile_n=128, precision="highest",
        block_q=8, interpret=True))
    assert got.shape == ref.shape == (6, 60)
    np.testing.assert_array_equal(got[:, 39:].numpy(), ref[:, 39:])
    assert bool((got[:, 39:] == ck.I32MAX).all())
    for row in got[:, :39].numpy():
        assert len(set(row)) == 39 and row.max() < 40


def test_count_below_matches_f64_counts():
    rng = np.random.default_rng(6)
    q, db = _data(rng, 9, 700, 20)
    d64 = oracles.sq_l2(q, db)
    thr = np.sort(d64, axis=1)[:, [3, 50, 200, 400, 600, 699, 1, 10, 90]
                               ].diagonal().copy()
    got = count_below(torch.from_numpy(db), torch.from_numpy(q),
                      torch.from_numpy(thr), tile=128)
    assert got.dtype == torch.int32 and got.shape == (9,)
    want = (d64 < thr[:, None]).sum(-1)
    # rows within the f32 expanded-square error of the threshold may count
    # either way
    slack = 8 * 2.0 ** -23 * ((q.astype(np.float64) ** 2).sum(-1)[:, None]
                              + (db.astype(np.float64) ** 2).sum(-1)[None])
    boundary = (np.abs(d64 - thr[:, None]) <= slack).sum(-1)
    assert (np.abs(got.numpy() - want) <= boundary).all()
    # the tiling, the query blocks and n_valid
    same = count_below(torch.from_numpy(db), torch.from_numpy(q),
                       torch.from_numpy(thr), tile=700)
    assert torch.equal(got, same)
    old = pcert._COUNT_BLOCK_ELEMS
    try:
        pcert._COUNT_BLOCK_ELEMS = 2 * 128
        assert torch.equal(got, count_below(
            torch.from_numpy(db), torch.from_numpy(q),
            torch.from_numpy(thr), tile=128))
    finally:
        pcert._COUNT_BLOCK_ELEMS = old
    head = count_below(torch.from_numpy(db), torch.from_numpy(q),
                       torch.from_numpy(thr), tile=128, n_valid=300)
    want_head = (d64[:, :300] < thr[:, None]).sum(-1)
    assert (np.abs(head.numpy() - want_head) <= boundary).all()
    assert (head <= got).all()
