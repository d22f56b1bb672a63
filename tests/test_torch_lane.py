"""The port's lane binning (K8) against the JAX package (knn_tpu.ops.
pallas_knn in interpret mode on CPU, knn_tpu.parallel.sharded) and the
float64 oracle.

Lane binning emits, per bin of ``bin_w`` contiguous tile rows, the
``survivors`` smallest scores in (value, row) order and the next value as
the bin's bound (pallas_knn.py:506-549).  The int arms' scores are exact
up to one f32 rounding, so their lane outputs are held bitwise against the
Pallas kernel; the f32 family sums in another order than XLA, so theirs
within the K1 tolerance with ``ci`` equal on separated slots.  On the CPU
the wrappers run the plain versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knn_tpu.ops import pallas_knn as jpk
from knn_tpu.ops import quantize as jqz
from knn_tpu_torch import knn_search_pallas
from knn_tpu_torch.ops import coarse_knn as ck
from knn_tpu_torch.parallel.sharded import ShardedKNN
from test_torch_cuda import _assert_lane_ci_separated, _assert_scores, _tol

import oracles

BIN_W = ck.BIN_W


def _oracle(db, q, k):
    d = oracles.sq_l2(q, db)
    idx = np.lexsort((np.broadcast_to(np.arange(db.shape[0]), d.shape), d),
                     axis=-1)[:, :k]
    return np.take_along_axis(d, idx, axis=-1), idx


def _quantized_triple(db, arm):
    qr = (jqz.quantize_rows_np(db) if arm == "int8"
          else jqz.quantize_rows_int4_np(db))
    vals = qr.values
    if arm == "int4":
        vals = jqz.pack_nibbles(np.pad(vals, ((0, 0), (0, -db.shape[1] % 128))))
    norms = (db.astype(np.float64) ** 2).sum(-1).astype(np.float32)
    return vals, qr.scales, norms


# --- geometry ----------------------------------------------------------------


def test_geometry_and_effective_tile_match_jax():
    # tests/test_pallas_knn.py:281-287's cases, then a grid
    for args in ((4 * BIN_W, BIN_W, 64, "lane"), (16 * BIN_W, BIN_W, 2, "lane"),
                 (32 * BIN_W, BIN_W, 8, "lane"), (160 * BIN_W, BIN_W, 1, "lane"),
                 (4 * BIN_W, BIN_W, None, "grouped"),
                 (32 * BIN_W, BIN_W, 64, "grouped"),
                 (160 * BIN_W, 2 * BIN_W, 1, "grouped")):
        assert ck._geometry(*args) == jpk._geometry(*args)
    for tile in (256, 1024, 4096, 16384):
        for bin_w in (128, 256, 512):
            if tile % bin_w:
                continue
            for surv in (None, 1, 2, 3, 8, 12):
                for binning in ("grouped", "lane"):
                    assert ck._geometry(tile, bin_w, surv, binning) == \
                        jpk._geometry(tile, bin_w, surv, binning)
                    for rows, width in ((1_000_000, 130), (10_000, 300),
                                        (700, 35), (5000, 900), (300, 50)):
                        assert ck.effective_tile(
                            rows, tile, bin_w, surv, binning, width) == \
                            jpk.effective_tile(rows, tile, bin_w, surv,
                                               binning, width)
    for fn in (ck._geometry, jpk._geometry):
        with pytest.raises(ValueError, match="multiple of 128"):
            fn(384, 192, 2, "lane")
        with pytest.raises(ValueError, match="multiple of bin_w"):
            fn(384, 256, 2, "lane")


# --- the plain lane emitter against the Pallas kernel ------------------------


def _lane_case(rng, arm, dim):
    """Rows with exact ties inside one lane bin (rows 3 and 90 equal to row
    10 of the same 128-row bin) and across bins, ragged at the end."""
    if arm in ("int8", "int4"):
        db = rng.integers(-100, 101, size=(5 * BIN_W + 60, dim)).astype(
            np.float32)
        db[:, 0] = 127.0
        q = rng.integers(-100, 101, size=(11, dim)).astype(np.float32)
    else:
        db = (rng.normal(size=(5 * BIN_W + 60, dim)) * 10).astype(np.float32)
        q = (rng.normal(size=(11, dim)) * 10).astype(np.float32)
    db[3] = db[90] = db[10]
    db[3 * BIN_W : 3 * BIN_W + 40] = db[:40]
    q[0] = db[10]
    return q, db


def _port_operands(arm, q, db, tile_n):
    if arm in ("int8", "int4"):
        t, aux = ck.prepare_db_quant(
            *(torch.from_numpy(a) for a in _quantized_triple(db, arm)), tile_n)
        return (*ck.quantize_queries(torch.from_numpy(q)), t, aux)
    parts = ck.prepare_db_arm(torch.from_numpy(db), tile_n, arm)
    return (ck.pad_queries(torch.from_numpy(q)), *parts)


@pytest.mark.parametrize("arm", ["bf16x3", "bf16x3f", "highest", "int8",
                                 "int4"])
@pytest.mark.parametrize("kernel,bin_w,survivors", [
    ("tiled", 128, None), ("streaming", 256, 3), ("tiled", 128, 8)])
def test_plain_lane_matches_pallas(arm, kernel, bin_w, survivors):
    rng = np.random.default_rng(len(arm) + bin_w)
    dim = 24
    tile_n = 2 * 256
    q, db = _lane_case(rng, arm, dim)
    extra = {}
    if arm in ("int8", "int4"):
        key = "db_int8" if arm == "int8" else "db_int4"
        extra[key] = tuple(jnp.asarray(a) for a in _quantized_triple(db, arm))
    ref = jpk._bin_candidates(
        jnp.asarray(q), jnp.asarray(db), block_q=8, tile_n=tile_n,
        bin_w=bin_w, survivors=survivors, precision=arm, interpret=True,
        binning="lane", kernel=kernel, **extra)
    ref = [np.asarray(a)[: q.shape[0]] for a in ref]
    ops = _port_operands(arm, q, db, tile_n)
    fn = ck.stream_select if kernel == "streaming" else ck.binned_select
    before = dict(fn.launches)
    port = [a.numpy() for a in fn(*ops, tile_n=tile_n, arm=arm,
                                  binning="lane", bin_w=bin_w,
                                  survivors=survivors)]
    assert fn.launches == before  # CPU: the plain version
    geo = ck._geometry(tile_n, bin_w, survivors, "lane")
    assert port[0].shape == ref[0].shape and port[2].shape == ref[2].shape
    if arm in ("int8", "int4"):
        for a, b in zip(port, ref):
            np.testing.assert_array_equal(a, b)
        return
    tol = _tol(q, db, arm)
    _assert_scores(port[0], ref[0], tol)
    _assert_scores(port[2], ref[2], tol)
    _assert_lane_ci_separated(ref[0], port[1], ref[1], ref[2], geo, tol)


def test_lane_ties_go_to_the_lower_row_and_differ_from_grouped():
    # one 256-row tile: scores of rows 5, 40 and 130 tie exactly at the
    # minimum.  Lane binning (bin_w 128) keeps rows 5 and 40 of bin 0 in row
    # order; grouped binning puts rows 5 and 133 (lane 5) in one bin.
    s = torch.full((1, 256), 10.0)
    s[0, torch.arange(256)] += torch.arange(256, dtype=torch.float32) * 1e-3
    s[0, [5, 40, 130]] = 1.0
    s[0, 133] = 1.0
    geo = ck._geometry(256, 128, 2, "lane")
    cd, ci, bound = ck._select_tile_lane(s, 0, 256, geo)
    # survivor j of bin b at column j * n_bins + b
    assert ci[0, [0, 2]].tolist() == [5, 40]        # survivors 0, 1 of bin 0
    assert cd[0, [0, 2]].tolist() == [1.0, 1.0]
    assert bound[0, 0].item() == pytest.approx(10.0)  # row 0: 10.000
    assert ci[0, [1, 3]].tolist() == [130, 133]     # bin 1
    gcd, gci, _ = ck._select_tile(s, 0, 256)
    assert gci[0, [5, 133]].tolist() == [5, 133]    # lane 5's two rows
    # the same function as the Pallas lane emitter on these scores
    ref = jpk._emit_select(0, (-0.5 * jnp.asarray(s.numpy())), jnp.zeros(
        (8, 256), jnp.float32), tile_n=256, bin_w=128, n_bins=2,
        survivors=2, out_w=128, bound_w=128)
    for a, b in zip((cd, ci, bound), ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# --- knobs -------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    {"binning": "lane"}, {"binning": "lane", "survivors": 8},
    {"binning": "lane", "bin_w": 256, "survivors": 1},
    {"binning": "lane", "kernel": "streaming", "precision": "pq"},
    {"binning": "lane", "grid_order": "db_major", "precision": "int4"}])
def test_lane_knobs_are_accepted(kw):
    ck.check_knobs(**kw)


@pytest.mark.parametrize("kw,match", [
    ({"binning": "lane", "kernel": "fused"}, "requires binning='grouped'"),
    ({"binning": "lane", "survivors": 0}, "survivors=0 must be >= 1"),
    ({"binning": "lane", "bin_w": 192}, "multiple of 128"),
    ({"survivors": 3}, "survivors=3 is not ported")])
def test_lane_refusals(kw, match):
    with pytest.raises(ValueError, match=match):
        ck.check_knobs(**kw)


# --- certified search --------------------------------------------------------


@pytest.mark.parametrize("precision", ["bf16x3", "bf16x3f", "highest", "int8",
                                       "int4"])
@pytest.mark.parametrize("kernel", ["tiled", "streaming"])
def test_lane_search_certified_matches_oracle(precision, kernel):
    rng = np.random.default_rng(3)
    n, d, k = 900, 24, 7
    train = (rng.normal(size=(n, d)) * 10).astype(np.float32)
    queries = (rng.normal(size=(16, d)) * 10).astype(np.float32)
    ref_d, ref_i = _oracle(train, queries, k)
    knn = ShardedKNN(train, k=k, device="cpu")
    dd, ii, st = knn.search_certified(queries, precision=precision,
                                      kernel=kernel, binning="lane",
                                      tile_n=256)
    np.testing.assert_array_equal(ii, ref_i)
    np.testing.assert_allclose(dd, ref_d, rtol=5e-5)
    assert st["pallas_knobs"]["binning"] == "lane"
    gd, gi, _ = knn.search_certified(queries, precision=precision,
                                     kernel=kernel, tile_n=256)
    np.testing.assert_array_equal(gi, ii)


def test_lane_forced_miss_is_detected_and_repaired():
    # tests/test_pq.py:188's construction in bf16x3: the whole true top-k
    # in one lane bin of a 2-bin tile with k past its survivors
    rng = np.random.default_rng(2)
    dim, k = 12, 10
    db = (rng.normal(size=(4 * BIN_W, dim)) * 50).astype(np.float32)
    query = rng.normal(size=(1, dim)).astype(np.float32)
    for j, r in enumerate(2 * BIN_W + 3 * j for j in range(k)):
        db[r] = query[0] + (j + 1) * 1e-3
    ref_d, ref_i = _oracle(db, query, k)
    d, i, stats = knn_search_pallas(query, db, k, tile_n=2 * BIN_W, margin=4,
                                    binning="lane", device="cpu")
    np.testing.assert_array_equal(i, ref_i)
    np.testing.assert_allclose(d, ref_d, rtol=5e-5)
    assert stats["fallback_queries"] >= 1
    jd, ji, jst = jpk.knn_search_pallas(query, db, k, tile_n=2 * BIN_W,
                                        margin=4, binning="lane")
    np.testing.assert_array_equal(np.asarray(ji), i)
    assert jst["fallback_queries"] == stats["fallback_queries"]
