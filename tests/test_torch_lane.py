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


# --- K8's warp merge (csrc/binned_select.cuh, Emitter) replayed on the host

_TAKEN = np.uint32(0xFFFFFFFF)
_KEY_INF = np.uint32(0xFF800000)


def _order_key(x):
    """binned_select.cuh order_key: f32 -> uint32 in the floats' order, -0
    as +0, NaN as taken."""
    b = x.view(np.uint32)
    k = np.where(b & 0x80000000, ~b, b | 0x80000000).astype(np.uint32)
    k = np.where(b == 0x80000000, np.uint32(0x80000000), k)
    return np.where((b & 0x7FFFFFFF) > 0x7F800000, _TAKEN, k).astype(np.uint32)


def _key_value(key, packed):
    """binned_select.cuh key_value: a (key, packed row) pair's score."""
    bits = np.where(key & 0x80000000, key & 0x7FFFFFFF, ~key).astype(np.uint32)
    v = np.where(packed & 1, np.float32(-0.0), bits.view(np.float32))
    return np.where(key >= _KEY_INF, np.float32(np.inf), v).astype(np.float32)


def _lane_merge_replay(s, tile_n, geo):
    """The lane emitter's warp merge on scores ``s [Q, T*tile_n]`` f32, step
    for step: per query row and 128-row group, lane l holds rows g*128 + l +
    32 j; the bin's running list is one (key, packed row) pair a lane;
    surv + 1 rounds each take the warp's smallest key, then its smallest
    packed row among the lanes that hold that key (redux.sync); the owner
    drops it, lane r keeps round r's pair; lanes 0 .. surv-1 write the
    survivors, lane surv the bound.  Returns (cd, ci, bounds) in the
    geometry's layout."""
    n_bins, surv, out_w, bound_w = geo
    n_q = s.shape[0]
    n_tiles = s.shape[1] // tile_n
    groups = tile_n // 128
    bin_groups = groups // n_bins
    lane = np.arange(32)
    cd = np.full((n_q, n_tiles * out_w), np.inf, np.float32)
    ci = np.full((n_q, n_tiles * out_w), np.iinfo(np.int32).max, np.int32)
    bounds = np.full((n_q, n_tiles * bound_w), np.inf, np.float32)
    for ti in range(n_tiles):
        rk = np.full((n_q, 32), _TAKEN)
        rp = np.full((n_q, 32), _TAKEN)
        for g in range(groups):
            sc = s[:, ti * tile_n + g * 128:ti * tile_n + (g + 1) * 128]
            sc = sc.reshape(n_q, 4, 32).transpose(0, 2, 1)  # [Q, lane, j]
            key = _order_key(np.ascontiguousarray(sc))
            row = (g * 128 + lane[:, None] + 32 * np.arange(4)[None, :])
            pk = ((row.astype(np.uint32) << 1)[None]
                  | (sc.view(np.uint32) == 0x80000000)).astype(np.uint32)
            nk = np.full((n_q, 32), _TAKEN)
            np_ = np.full((n_q, 32), _TAKEN)
            for r in range(surv + 1):
                bk, bp = rk.copy(), rp.copy()
                for j in range(4):
                    less = key[:, :, j] < bk
                    bk = np.where(less, key[:, :, j], bk)
                    bp = np.where(less, pk[:, :, j], bp)
                mk = bk.min(1, keepdims=True)
                mp = np.where(bk == mk, bp, _TAKEN).min(1, keepdims=True)
                rk = np.where(rp == mp, _TAKEN, rk)
                key = np.where(pk == mp[:, :, None], _TAKEN, key)
                nk[:, r] = mk[:, 0]
                np_[:, r] = mp[:, 0]
            rk, rp = nk, np_
            if (g + 1) % bin_groups == 0:
                b = g // bin_groups
                v = _key_value(rk[:, :surv + 1], rp[:, :surv + 1])
                for r in range(surv):
                    col = ti * out_w + r * n_bins + b
                    cd[:, col] = v[:, r]
                    ci[:, col] = np.where(np.isfinite(v[:, r]),
                                          ti * tile_n + (rp[:, r] >> 1),
                                          np.iinfo(np.int32).max)
                bounds[:, ti * bound_w + b] = v[:, surv]
                rk = np.full((n_q, 32), _TAKEN)
                rp = np.full((n_q, 32), _TAKEN)
    return cd, ci, bounds


def _hard_scores(rng, n_q, n):
    """Scores with exact ties across lanes, groups and bins, both zeros,
    +-inf and runs of +inf that leave bins with fewer finite rows than
    survivors."""
    s = rng.integers(-6, 7, size=(n_q, n)).astype(np.float32)
    s[:, ::7] = 0.0
    s[:, 3::11] = -0.0
    s[:, 5::13] = np.inf
    s[:, 9::29] = -np.inf
    s[0, :300] = np.inf             # a query whose first bins are all +inf
    s[1, 128:256] = -0.0            # a bin of -0 ties
    s[2, :] = 0.0                   # every score a tie
    s[2, 40] = -0.0
    s[3, :512] = 5.0                # -0 ahead of +0 in one bin's minimum
    s[3, 0] = -0.0
    s[3, 1] = 0.0
    return s


@pytest.mark.parametrize("survivors", range(1, 9))
@pytest.mark.parametrize("bin_w", [128, 256, 512])
def test_warp_merge_replay_is_the_plain_lane_emitter(survivors, bin_w):
    # the redux.sync merge on (order key, packed row) pairs selects what the
    # plain lane emitter (repeated min / first-argmin) selects: the same
    # rows, values equal, the same bounds, +inf / INT32_MAX padding; and the
    # value it writes is bitwise the selected row's score (the sign of a
    # zero carried by the packed row)
    tile_n, n_tiles = 512, 2
    rng = np.random.default_rng(survivors * 1000 + bin_w)
    s = _hard_scores(rng, 6, n_tiles * tile_n)
    geo = ck._geometry(tile_n, bin_w, survivors, "lane")
    got = _lane_merge_replay(s, tile_n, geo)
    st = torch.from_numpy(s)
    ref = [a.numpy() for a in ck._select_tiles(
        lambda ti, rows: st[:, rows], n_tiles, tile_n, geo)]
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(got[0], ref[0])    # -0 == +0 here
    np.testing.assert_array_equal(got[2], ref[2])
    real = got[1] != np.iinfo(np.int32).max
    picked = np.take_along_axis(s, np.where(real, got[1], 0), 1)
    np.testing.assert_array_equal(got[0][real].view(np.uint32),
                                  picked[real].view(np.uint32))
    assert not np.isfinite(got[0][~real]).any()
    assert (got[0][3, 0].view(np.uint32) == 0x80000000
            and got[1][3, 0] == 0)             # -0, row 0, won the tie


def test_order_key_orders_like_the_floats():
    vals = np.array([-np.inf, -3.5, -1e-30, -0.0, 0.0, 1e-45, 2.0, 3e38,
                     np.inf], np.float32)
    keys = _order_key(vals)
    assert (np.diff(keys.astype(np.int64)) >= 0).all()
    assert keys[3] == keys[4]                        # -0 with +0
    assert (np.diff(keys.astype(np.int64))[[0, 1, 2, 4, 5, 6, 7]] > 0).all()
    assert keys[-1] == _KEY_INF
    assert _order_key(np.array([np.nan, -np.nan], np.float32)).tolist() == [
        0xFFFFFFFF, 0xFFFFFFFF]
    packed = np.zeros(len(vals), np.uint32)
    packed[3] = 1
    np.testing.assert_array_equal(_key_value(keys, packed).view(np.uint32),
                                  vals.view(np.uint32))


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
