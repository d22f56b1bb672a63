"""The port's coarse pass (knn_tpu_torch.ops.coarse_knn) against the JAX
package's Pallas kernel (knn_tpu.ops.pallas_knn, interpret mode on CPU).

Inputs are made with numpy from a seed and go through both.  f32 scores
are never compared bitwise across frameworks (the two sum the matmul in
different orders, tests/test_certified.py:31-34): cd and bounds agree
within 64 eps_f32 (||q||^2 + max||t||^2) per query, ci is equal wherever
a bin's values are separated by more than that, and pad-row scores
(~1e35, from PAD_VAL rows) are compared by class.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knn_tpu.ops import pallas_knn as jpk
from knn_tpu_torch.ops import coarse_knn as ck
from test_torch_cuda import _assert_ci_separated, _assert_scores, _data, _tol


@pytest.mark.parametrize("dim", [24, 300])
@pytest.mark.parametrize("tile_n", [256, 512])
def test_plain_k1_matches_pallas_bin_candidates(dim, tile_n):
    rng = np.random.default_rng(dim + tile_n)
    q, db = _data(rng, 11, 5 * 128 + 60, dim)  # ragged rows
    ref = jpk._bin_candidates(
        jnp.asarray(q), jnp.asarray(db), block_q=8, tile_n=tile_n,
        bin_w=128, survivors=2, precision="bf16x3", interpret=True,
        binning="grouped", grid_order="query_major")
    ref = [np.asarray(a)[: q.shape[0]] for a in ref]
    port = ck._bin_candidates(torch.from_numpy(q), torch.from_numpy(db),
                              tile_n=tile_n)
    port = [a.numpy() for a in port]
    assert [a.shape for a in port] == [a.shape for a in ref]
    assert port[1].dtype == np.int32
    tol = _tol(q, db)
    _assert_scores(port[0], ref[0], tol)
    _assert_scores(port[2], ref[2], tol)
    _assert_ci_separated(ref[0], port[1], ref[1], ref[2], tol)


def test_plain_k1_insertion_semantics_on_ties():
    # identical rows in one bin: strict `<` keeps the earlier group, the
    # bound is the third copy's score — the stable sort must agree
    rng = np.random.default_rng(3)
    db = rng.normal(size=(512, 8)).astype(np.float32)
    db[128 + 5] = db[5]
    db[256 + 5] = db[5]
    db[384 + 5] = db[5]
    q = db[5:6] + np.float32(0.0)
    cd, ci, bounds = ck._bin_candidates(torch.from_numpy(q),
                                        torch.from_numpy(db), tile_n=512)
    assert ci[0, 5].item() == 5 and ci[0, 128 + 5].item() == 128 + 5
    assert cd[0, 5].item() == cd[0, 128 + 5].item() == bounds[0, 5].item()


@pytest.mark.parametrize("tile_n", [256, 512])
def test_exclusion_bound_is_sound(tile_n):
    # mirrors tests/test_pallas_knn.py::test_exclusion_bound_is_sound:
    # every db row outside the candidates has kernel-space score >= lb
    # (within the bf16x3 tolerance), and d32 are the candidates' true
    # distances to f32 accuracy
    rng = np.random.default_rng(tile_n)
    q, db = _data(rng, 7, 5 * 128 + 60, 24)
    d32, idx, lb = ck.local_certified_candidates(
        torch.from_numpy(q), torch.from_numpy(db), 13, tile_n=tile_n)
    d32, idx, lb = d32.numpy(), idx.numpy(), lb.numpy()
    q64, db64 = q.astype(np.float64), db.astype(np.float64)
    s_true = (db64 ** 2).sum(-1)[None, :] - 2.0 * (q64 @ db64.T)
    d_true = ((db64[None] - q64[:, None]) ** 2).sum(-1)
    tol = ck.kernel_tolerance(q, db, precision="bf16x3")
    for qi in range(q.shape[0]):
        outside = np.setdiff1d(np.arange(db.shape[0]), idx[qi])
        assert s_true[qi, outside].min() >= lb[qi] - tol[qi]
        np.testing.assert_allclose(d32[qi], d_true[qi, idx[qi]],
                                   rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("dim,tile_n", [(24, 256), (300, 256), (24, 16384)])
def test_local_certified_candidates_match_pallas(dim, tile_n):
    rng = np.random.default_rng(dim)
    q, db = _data(rng, 9, 7 * 128 + 33, dim)
    db[100:120] = db[:20]  # duplicate rows: exact ties in the candidates
    m = 21
    jd, ji, jlb = jpk.local_certified_candidates(
        jnp.asarray(q), jnp.asarray(db), m, tile_n=tile_n, block_q=8,
        precision="bf16x3", interpret=True)
    jd, ji, jlb = np.asarray(jd), np.asarray(ji), np.asarray(jlb)
    pd, pi, plb = ck.local_certified_candidates(
        torch.from_numpy(q), torch.from_numpy(db), m, tile_n=tile_n)
    pd, pi, plb = pd.numpy(), pi.numpy(), plb.numpy()
    assert pd.shape == jd.shape == (9, m + 1)
    np.testing.assert_allclose(pd, jd, rtol=ck.RANK_SLACK)
    # indices agree wherever neighbouring distances are not near-tied
    gap_ok = np.ones_like(pd, dtype=bool)
    close = np.abs(np.diff(jd, axis=1)) <= 2 * ck.RANK_SLACK * jd[:, 1:]
    gap_ok[:, 1:] &= ~close
    gap_ok[:, :-1] &= ~close
    np.testing.assert_array_equal(pi[gap_ok], ji[gap_ok])
    tol = ck.kernel_tolerance(q, db, precision="bf16x3")
    assert (np.abs(plb - jlb) <= tol).all()


def test_geometry_and_effective_tile_match_pallas():
    # grouped binning at the JAX package's defaults: bin_w 128, 2 survivors
    # (tests/test_torch_lane.py covers the other geometries)
    for rows, tile, surv, width in ((1_000_000, 16384, None, 130),
                                    (10_000, 16384, None, 300),
                                    (700, 256, 2, 35), (5000, 384, 2, 900)):
        assert ck.effective_tile(rows, tile, 128, surv, "grouped", width) == \
            jpk.effective_tile(rows, tile, 128, surv, "grouped", width)
        assert ck._geometry(tile) == jpk._geometry(tile, 128, surv, "grouped")
    assert (ck.BIN_W, ck.TILE_N, ck.DIM_CHUNK, ck.SURVIVORS, ck.PAD_VAL,
            ck.RANK_SLACK) == (jpk.BIN_W, jpk.TILE_N, jpk.DIM_CHUNK,
                               jpk._geometry(jpk.TILE_N)[1], jpk.PAD_VAL,
                               jpk.RANK_SLACK)


def test_prepare_db_matches_pallas_prologue():
    # the db-side prologue: PAD_VAL rows, zero dims, the hi/lo split
    rng = np.random.default_rng(5)
    db = (rng.normal(size=(300, 24)) * 10).astype(np.float32)
    th, tl, tnorm = ck.prepare_db(torch.from_numpy(db), 256)
    ref = np.asarray(jpk._pad_axis(jpk._pad_axis(
        jnp.asarray(db), 256, 0, fill=jpk.PAD_VAL), 128, 1))
    rth = np.asarray(jnp.asarray(ref).astype(jnp.bfloat16).astype(jnp.float32))
    rtl = np.asarray((jnp.asarray(ref) - jnp.asarray(rth)).astype(
        jnp.bfloat16).astype(jnp.float32))
    assert th.shape == (512, 128) and tnorm.shape == (8, 512)
    np.testing.assert_array_equal(th.float().numpy(), rth)
    np.testing.assert_array_equal(tl.float().numpy(), rtl)
    np.testing.assert_allclose(tnorm[0].numpy(), (ref.astype(np.float64) ** 2).sum(-1),
                               rtol=1e-6)


def test_kernel_tolerance_matches_pallas():
    rng = np.random.default_rng(6)
    q, db = _data(rng, 5, 200, 16)
    for prec in ("highest", "int8", "int4"):
        np.testing.assert_allclose(
            ck.kernel_tolerance(q, db, precision=prec),
            jpk.kernel_tolerance(q, db, precision=prec), rtol=1e-12)
    # bf16x3 / bf16x3f: the reference's 2^-14 (||q||^2 + M) term with the
    # proved slack in place of 2^-14 (ROADMAP divergence 18)
    q64, db64 = q.astype(np.float64), db.astype(np.float64)
    x = (q64 ** 2).sum(-1) + (db64 ** 2).sum(-1).max()
    for prec in ("bf16x3", "bf16x3f"):
        ref = jpk.kernel_tolerance(q, db, precision=prec)
        np.testing.assert_allclose(ref, 2.0 ** -14 * x, rtol=1e-12)
        np.testing.assert_allclose(
            ck.kernel_tolerance(q, db, precision=prec),
            ck.bf16_tolerance_scale(prec, 1) * x, rtol=1e-12)
    # the proved scales at Dp = 128 (csrc/binned_mma.cuh): bf16x3f's one
    # tensor-core accumulator takes 24 k-steps a chunk
    assert ck.bf16_tolerance_scale("bf16x3", 1) / 2.0 ** -14 == \
        pytest.approx(1.13428497, abs=1e-8)
    assert ck.bf16_tolerance_scale("bf16x3f", 1) / 2.0 ** -14 == \
        pytest.approx(1.76318359, abs=1e-8)
    # default has no tolerance model in either package
    for fn in (ck.kernel_tolerance, jpk.kernel_tolerance):
        with pytest.raises(ValueError, match="tolerance model"):
            fn(q, db, precision="default")


@pytest.mark.parametrize("kw,match", [
    # the JAX package's own refusals (every value it takes is ported)
    ({"bin_w": 64}, "bin_w=64 must be a multiple of 128"),
    ({"kernel": "fused", "precision": "pq"}, "not certified for precision='pq'"),
    ({"kernel": "fused", "binning": "lane"}, "requires binning='grouped'")])
def test_unported_knobs_are_refused_by_name(kw, match):
    with pytest.raises(ValueError, match=match):
        ck.check_knobs(**kw)


@pytest.mark.parametrize("precision", ["int8", "int4"])
@pytest.mark.parametrize("kernel", ["tiled", "streaming", "fused"])
def test_int_arms_are_accepted_under_every_kernel(precision, kernel):
    ck.check_knobs(precision=precision, kernel=kernel)


@pytest.mark.parametrize("precision", ck.PRECISIONS)
@pytest.mark.parametrize("kernel,grid_order", [
    ("tiled", "query_major"), ("tiled", "db_major"),
    ("streaming", "query_major"), ("fused", "query_major")])
def test_ported_precisions_are_accepted_under_every_kernel(precision, kernel,
                                                           grid_order):
    if (kernel, precision) == ("fused", "pq"):  # the JAX package's refusal
        with pytest.raises(ValueError, match="precision='pq'"):
            ck.check_knobs(precision=precision, kernel=kernel)
        return
    ck.check_knobs(precision=precision, kernel=kernel, grid_order=grid_order)


@pytest.mark.parametrize("kw,match", [
    ({"precision": "nope"}, "not in"),
    ({"kernel": "fused", "binning": "lane"}, "requires binning='grouped'"),
    ({"kernel": "streaming", "grid_order": "db_major"}, "does not apply"),
    ({"kernel": "fused", "final_select": "approx"}, "final_select='exact'")])
def test_pallas_knob_refusals_kept(kw, match):
    with pytest.raises(ValueError, match=match):
        ck.check_knobs(**kw)


def test_wrapper_checks_operands_and_counts_only_kernel_launches():
    rng = np.random.default_rng(8)
    q, db = _data(rng, 4, 256, 128)
    th, tl, tnorm = ck.prepare_db(torch.from_numpy(db), 256)
    qt = torch.from_numpy(q)
    before = dict(ck.binned_select.launches)
    out = ck.binned_select(qt, th, tl, tnorm, tile_n=256, arm="bf16x3")
    assert ck.binned_select.launches == before  # CPU: the plain version
    ref = ck.binned_select_plain(qt, th, tl, tnorm, tile_n=256, arm="bf16x3")
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="float32"):
        ck.binned_select(qt.double(), th, tl, tnorm, tile_n=256, arm="bf16x3")
    with pytest.raises(ValueError, match="bfloat16"):
        ck.binned_select(qt, th.float(), tl, tnorm, tile_n=256, arm="bf16x3")
    with pytest.raises(ValueError, match="multiple of tile_n"):
        ck.binned_select(qt, th, tl, tnorm, tile_n=384, arm="bf16x3")
    with pytest.raises(ValueError, match="tnorm"):
        ck.binned_select(qt, th, tl, tnorm[:, :128], tile_n=256, arm="bf16x3")
