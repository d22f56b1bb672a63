"""The port's db-streaming coarse kernels (K10 ``streaming``, K11 ``fused``)
and the two-stage overlap pipeline of ``search_certified``, against the
JAX package (Pallas in interpret mode on CPU) and the float64 oracle.

On the CPU the wrappers run the plain versions: K10's is K1's
(``binned_select_plain``, the same function), K11's is
``fused_select_plain``.  f32 scores are compared within 64 eps_f32
(||q||^2 + max||t||^2) per query, never bitwise across frameworks; inside
the port, the kernels' certified stages and end results are compared
bitwise, as the JAX package compares its own (tests/test_fused_overlap.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knn_tpu.ops import pallas_knn as jpk
from knn_tpu.parallel import sharded as jsh
from knn_tpu.parallel.mesh import make_mesh
from knn_tpu_torch import knn_search_pallas
from knn_tpu_torch.ops import coarse_knn as ck
from knn_tpu_torch.parallel import sharded as psh
from knn_tpu_torch.parallel.sharded import ShardedKNN
from test_torch_cuda import _assert_ci_separated, _assert_scores, _data, _tol

import oracles
from test_torch_cuda import empty_default_tune_cache  # noqa: F401 (autouse)

BIN_W = ck.BIN_W


def _oracle(db, q, k):
    d = oracles.sq_l2(q, db)
    idx = np.lexsort((np.broadcast_to(np.arange(db.shape[0]), d.shape), d),
                     axis=-1)[:, :k]
    return np.take_along_axis(d, idx, axis=-1), idx


def _far_tile(seed=0):
    # tests/test_fused_overlap.py:87-89: tiles 1..2 uniformly far from
    # every query, so the early-out can skip them
    rng = np.random.default_rng(seed)
    db = rng.normal(size=(6 * BIN_W, 16)).astype(np.float32)
    db[2 * BIN_W:] += 500.0
    q = db[:9] + rng.normal(size=(9, 16)).astype(np.float32) * 1e-2
    return q, db


def _parts(q, db, tile_n):
    th, tl, tnorm = ck.prepare_db(torch.from_numpy(db), tile_n)
    return ck.pad_queries(torch.from_numpy(q)), th, tl, tnorm


def _jax_bin(q, db, kernel, block_q, tile_n=2 * BIN_W, keep=None):
    out = jpk._bin_candidates(
        jnp.asarray(q), jnp.asarray(db), block_q=block_q, tile_n=tile_n,
        bin_w=BIN_W, survivors=2, precision="bf16x3", interpret=True,
        kernel=kernel, keep=keep)
    return [np.array(a)[: q.shape[0]] for a in out]


# --- K10 ------------------------------------------------------------------


@pytest.mark.parametrize("dim", [24, 300])  # 300 spans 3 dim chunks
@pytest.mark.parametrize("tile_n", [256, 512])
def test_plain_k10_matches_pallas_streaming(dim, tile_n):
    rng = np.random.default_rng(dim + tile_n + 1)
    q, db = _data(rng, 11, 5 * BIN_W + 60, dim)  # ragged rows
    ref = _jax_bin(q, db, "streaming", 8, tile_n)
    qp, th, tl, tnorm = _parts(q, db, tile_n)
    before = dict(ck.stream_select.launches)
    port = [a.numpy() for a in ck.stream_select(qp, th, tl, tnorm,
                                                tile_n=tile_n, arm="bf16x3")]
    assert ck.stream_select.launches == before  # CPU: the plain version
    assert [a.shape for a in port] == [a.shape for a in ref]
    tol = _tol(q, db)
    _assert_scores(port[0], ref[0], tol)
    _assert_scores(port[2], ref[2], tol)
    _assert_ci_separated(ref[0], port[1], ref[1], ref[2], tol)


# --- K11 ------------------------------------------------------------------


def test_plain_k11_skips_the_tiles_pallas_skips():
    q, db = _far_tile()
    ref = _jax_bin(q, db, "fused", 16, keep=15)
    qp, th, tl, tnorm = _parts(q, db, 2 * BIN_W)
    port = [a.numpy() for a in ck.fused_select_plain(
        qp, th, tl, tnorm, tile_n=2 * BIN_W, keep=15, block_q=16,
        arm="bf16x3")]
    n_tiles = 3
    skip_ref = ck.skipped_cells(torch.from_numpy(ref[0]), n_tiles, 16)
    skip_port = ck.skipped_cells(torch.from_numpy(port[0]), n_tiles, 16)
    assert torch.equal(skip_port, skip_ref)
    assert bool(skip_port[0, 1:].all()) and not bool(skip_port[0, 0])
    # the emitted tile within tolerance, the skipped ones padded alike
    tol = _tol(q, db)
    _assert_scores(port[0], ref[0], tol)
    _assert_scores(port[2], ref[2], tol)
    _assert_ci_separated(ref[0][:, :2 * BIN_W], port[1][:, :2 * BIN_W],
                         ref[1][:, :2 * BIN_W], ref[2][:, :BIN_W], tol)
    np.testing.assert_array_equal(port[1][:, 2 * BIN_W:], ref[1][:, 2 * BIN_W:])


def test_plain_k11_disarmed_equals_k10():
    q, db = _far_tile(1)
    qp, th, tl, tnorm = _parts(q, db, 2 * BIN_W)
    k10 = ck.binned_select_plain(qp, th, tl, tnorm, tile_n=2 * BIN_W,
                                 arm="bf16x3")
    # keep None, or a carry deeper than MAX_CARRY_DEPTH, disarms the skip
    for keep in (None, BIN_W * ck.MAX_CARRY_DEPTH + 1):
        k11 = ck.fused_select_plain(qp, th, tl, tnorm, tile_n=2 * BIN_W,
                                    keep=keep, block_q=16, arm="bf16x3")
        for a, b in zip(k10, k11):
            assert torch.equal(a, b)
    assert ck.carry_depth(None) == 0
    assert ck.carry_depth(130) == 2 and ck.carry_depth(1024) == 8


@pytest.mark.parametrize("block_q,seg_tiles", [(8, None), (16, 1), (16, 2),
                                               (32, 3), (4, 2)])
def test_k11_geometry_never_changes_the_certified_stage(block_q, seg_tiles):
    # the skip depends on the query block and the tile segments; the
    # certified stage must not (the soundness argument in binned_stream.cu)
    rng = np.random.default_rng(block_q)
    db = rng.normal(size=(9 * BIN_W + 17, 16)).astype(np.float32)
    db[2 * BIN_W:] += 300.0
    q = db[:13] + rng.normal(size=(13, 16)).astype(np.float32) * 1e-2
    m, tile_n = 13, 2 * BIN_W
    qp, th, tl, tnorm = _parts(q, db, tile_n)
    dbt = torch.from_numpy(db)
    k1 = ck.binned_select_plain(qp, th, tl, tnorm, tile_n=tile_n, arm="bf16x3")
    k11 = ck.fused_select_plain(qp, th, tl, tnorm, tile_n=tile_n, keep=m + 2,
                                block_q=block_q, seg_tiles=seg_tiles,
                                arm="bf16x3")
    n_tiles = th.shape[0] // tile_n
    if seg_tiles != 1:  # one-tile segments never skip: their carry is empty
        assert bool(ck.skipped_cells(k11[0], n_tiles, block_q).any())
    qt = torch.from_numpy(q)
    for a, b in zip(ck.local_select_rescore(qt, dbt, *k1, m),
                    ck.local_select_rescore(qt, dbt, *k11, m)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n_rows", [2 * BIN_W, 2 * BIN_W + 1, 5 * BIN_W + 60])
def test_fused_certified_stage_is_bitwise_tiled(n_rows):
    # tests/test_fused_overlap.py:45-60 for bf16x3, in the port; and the
    # port's stage against the JAX package's as in test_torch_coarse_knn
    rng = np.random.default_rng(n_rows)
    q, db = _data(rng, 7, n_rows, 24)
    outs = {kern: ck.local_certified_candidates(
        torch.from_numpy(q), torch.from_numpy(db), 13, tile_n=2 * BIN_W,
        kernel=kern) for kern in ("tiled", "streaming", "fused")}
    for kern in ("streaming", "fused"):
        for a, b in zip(outs["tiled"], outs[kern]):
            assert torch.equal(a, b)
    jd, ji, jlb = (np.asarray(a) for a in jpk.local_certified_candidates(
        jnp.asarray(q), jnp.asarray(db), 13, tile_n=2 * BIN_W, block_q=8,
        precision="bf16x3", interpret=True, kernel="fused"))
    pd, pi, plb = (a.numpy() for a in outs["fused"])
    np.testing.assert_allclose(pd, jd, rtol=ck.RANK_SLACK)
    gap_ok = np.ones_like(pd, dtype=bool)
    close = np.abs(np.diff(jd, axis=1)) <= 2 * ck.RANK_SLACK * jd[:, 1:]
    gap_ok[:, 1:] &= ~close
    gap_ok[:, :-1] &= ~close
    np.testing.assert_array_equal(pi[gap_ok], ji[gap_ok])
    assert (np.abs(plb - jlb) <= ck.kernel_tolerance(q, db)).all()


def test_fused_refusals_kept():
    with pytest.raises(ValueError, match="grouped"):
        ck.check_knobs(kernel="fused", binning="lane")
    with pytest.raises(ValueError, match="db_major"):
        ck.check_knobs(kernel="fused", grid_order="db_major")
    with pytest.raises(ValueError, match="final_select='exact'"):
        ck.check_knobs(kernel="fused", final_select="approx")
    with pytest.raises(ValueError, match="precision='pq'"):
        ck.check_knobs(kernel="fused", precision="pq")
    for kern in ("tiled", "streaming"):
        # pq and lane binning run under the other two kernels
        ck.check_knobs(kernel=kern, precision="pq")
        ck.check_knobs(kernel=kern, precision="pq", binning="lane")
        # grouped binning at any survivors, capped at MAX_SURVIVORS
        ck.check_knobs(kernel=kern, survivors=3)
        ck.check_knobs(kernel=kern, survivors=12, bin_w=256)
    for kern in ck.KERNELS:
        for prec in ("bf16x3", "bf16x3f", "highest", "default", "int8",
                     "int4"):
            ck.check_knobs(kernel=kern, precision=prec)


def test_launch_accounting_and_overlap_ratio_match_jax():
    for kern in ck.KERNELS:
        for rows, tile in ((1_000_000, 16384), (700, 256), (256, 256)):
            ours = ck.kernel_launches_per_batch(kern, rows, tile)
            theirs = jpk.kernel_launches_per_batch(kern, rows, tile)
            # the port's K1 covers every tile in one launch; the TPU grid
            # re-dispatches once per tile
            assert ours == (1 if kern == "tiled" else theirs)
            assert theirs == (-(-rows // tile) if kern == "tiled" else 1)
    with pytest.raises(ValueError, match="warp"):
        ck.kernel_launches_per_batch("warp", 1000, 128)
    assert ck.MAX_CARRY_DEPTH == jpk.MAX_CARRY_DEPTH
    rng = np.random.default_rng(3)
    for n in (0, 1, 2, 5):
        starts = np.sort(rng.random(n))
        spans = [(s, s + rng.random()) for s in starts]
        assert psh._overlap_ratio(spans) == jsh._overlap_ratio(spans)


def test_stream_segments_fill_one_wave():
    # the SIFT1M batch on 132 SMs that hold 2 CTAs each: 2 segments of 31
    # tiles, 256 CTAs
    wave = 132 * 2
    assert ck.stream_segment_tiles(4096, 62, wave) == 31
    assert ck.stream_segment_tiles(1024, 62, wave) == 8
    assert ck.stream_segment_tiles(9, 3, wave) == 1
    assert ck.stream_segment_tiles(10 ** 6, 62, wave) == 62
    # one CTA per SM: half the segments
    assert ck.stream_segment_tiles(1024, 62, 132) == 16
    for kern in ("streaming", "fused"):
        assert ck.kernel_segment_tiles(4096, 62, "cpu", kern) == 62
    with pytest.raises(ValueError, match="tiled"):
        ck.kernel_segment_tiles(4096, 62, "cpu", "tiled")


# --- end to end ------------------------------------------------------------


def _dup_ties(seed=0):
    # tests/test_fused_overlap.py:115-138: exact cross-tile duplicates and
    # a near-tie pileup
    rng = np.random.default_rng(seed)
    db = rng.normal(size=(6 * BIN_W + 31, 12)).astype(np.float32) * 20
    db[3 * BIN_W: 3 * BIN_W + 40] = db[:40]
    db[5 * BIN_W: 5 * BIN_W + 10] = db[100] + 1e-3
    q = rng.normal(size=(9, 12)).astype(np.float32) * 20
    q[0] = db[0] + 5e-4
    q[1] = db[100] + 5e-4
    return q, db


def _strip(stats):
    return {k: v for k, v in stats.items()
            if k not in ("pallas_knobs", "tuning", "pipeline")}


def test_knn_search_pallas_cross_tile_ties_match_jax_and_oracle():
    q, db = _dup_ties()
    ref_d, ref_i = _oracle(db, q, 7)
    _, ji, _ = jpk.knn_search_pallas(q, db, 7, tile_n=2 * BIN_W, margin=8,
                                     kernel="fused")
    out = {}
    for kern in ck.KERNELS:
        d, i, stats = knn_search_pallas(q, db, 7, tile_n=2 * BIN_W, margin=8,
                                        kernel=kern, device="cpu")
        np.testing.assert_array_equal(i, ref_i)
        np.testing.assert_array_equal(i, np.asarray(ji))
        np.testing.assert_allclose(d, ref_d, rtol=5e-5)
        assert stats["pallas_knobs"]["kernel"] == kern
        out[kern] = (d, i, stats)
    for kern in ("streaming", "fused"):
        np.testing.assert_array_equal(out["tiled"][0], out[kern][0])
        np.testing.assert_array_equal(out["tiled"][1], out[kern][1])
        assert _strip(out["tiled"][2]) == _strip(out[kern][2])


def _wide_ties(seed=0):
    # tests/test_fused_overlap.py:200-206: an exact-tie run wider than the
    # rank-analysis window trips the fallback repair
    rng = np.random.default_rng(seed)
    db = rng.normal(size=(1500, 12)).astype(np.float32) * 10
    q = rng.normal(size=(40, 12)).astype(np.float32) * 10
    db[100:125] = db[99]
    q[1] = db[99] + 1e-4
    return q, db


@pytest.mark.parametrize("kernel,depth", [("tiled", None), ("fused", 3)])
def test_overlap_pipeline_is_bitwise_the_sequential_path(kernel, depth):
    q, db = _wide_ties()
    port = ShardedKNN(db, k=5, device="cpu")
    kw = dict(selector="pallas", margin=8, tile_n=256, batch_size=8,
              kernel=kernel)
    d0, i0, s0 = port.search_certified(q, overlap=False, **kw)
    d1, i1, s1 = port.search_certified(q, overlap=True, overlap_depth=depth,
                                       **kw)
    assert s0["fallback_queries"] > 0  # the repair path really ran
    np.testing.assert_array_equal(d0, d1)
    np.testing.assert_array_equal(i0, i1)
    assert _strip(s0) == _strip(s1) and "pipeline" not in s0
    pipe = s1["pipeline"]
    assert pipe["batches"] == 5
    assert pipe["depth"] == (2 if depth is None else depth)
    assert pipe["overlap_ratio"] > 0 and pipe["wall_s"] > 0
    _, oi = _oracle(db, q, 5)
    np.testing.assert_array_equal(i1, oi)
    jknn = jsh.ShardedKNN(db, mesh=make_mesh(1, 1), k=5)
    _, ji, js = jknn.search_certified(q, overlap=True, precision="bf16x3",
                                      **kw)
    np.testing.assert_array_equal(i1, ji)
    assert js["pipeline"]["batches"] == pipe["batches"]


def test_predict_certified_takes_the_kernel():
    q, db = _wide_ties(1)
    labels = (np.arange(db.shape[0]) % 4).astype(np.int32)
    port = ShardedKNN(db, k=5, labels=labels, num_classes=4, device="cpu")
    ref, _ = port.predict_certified(q, margin=8, tile_n=256)
    for kern in ("streaming", "fused"):
        got, stats = port.predict_certified(q, margin=8, tile_n=256,
                                            kernel=kern)
        np.testing.assert_array_equal(got, ref)
        assert stats["pallas_knobs"]["kernel"] == kern
