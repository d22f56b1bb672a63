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
from test_torch_cuda import empty_default_tune_cache  # noqa: F401 (autouse)

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


# --- K8's lane lists and their warp merge (csrc/binned_select.cuh, Emitter)
# replayed on the host

_I32MAX = np.iinfo(np.int32).max


def _before(va, ra, vb, rb):
    """binned_select.cuh lane_before: (va, ra) ahead of (vb, rb) -- by
    value, then row."""
    return (va < vb) | ((va == vb) & (ra < rb))


def _insert(lv, lr, v, r):
    """Emitter::insert on every list at once: (v, r) into the sorted lists
    lv, lr [..., depth] with strict `<`."""
    for d in range(lv.shape[-1]):
        less = v < lv[..., d]
        tv, tr = lv[..., d].copy(), lr[..., d].copy()
        lv[..., d] = np.where(less, v, tv)
        lr[..., d] = np.where(less, r, tr)
        v, r = np.where(less, tv, v), np.where(less, tr, r)


def _butterfly_merge(lv, lr):
    """Emitter::merge on lists [Q, 8 lanes, depth]: three shuffle steps,
    each keeping the elementwise smaller of a lane's list and its partner's
    reversed, then an odd-even transposition sort."""
    depth = lv.shape[-1]
    slot = np.arange(8)
    for m in (1, 2, 4):
        bv, br = lv[:, slot ^ m, ::-1], lr[:, slot ^ m, ::-1]
        theirs = _before(bv, br, lv, lr)
        lv, lr = np.where(theirs, bv, lv), np.where(theirs, br, lr)
        for ph in range(depth):
            for d in range(ph % 2, depth - 1, 2):
                swap = _before(lv[..., d + 1], lr[..., d + 1], lv[..., d],
                               lr[..., d])
                a, ar = lv[..., d].copy(), lr[..., d].copy()
                lv[..., d] = np.where(swap, lv[..., d + 1], a)
                lr[..., d] = np.where(swap, lr[..., d + 1], ar)
                lv[..., d + 1] = np.where(swap, a, lv[..., d + 1])
                lr[..., d + 1] = np.where(swap, ar, lr[..., d + 1])
    return lv, lr


def _lane_merge_replay(s, tile_n, geo):
    """The lane emitter on scores ``s [Q, T*tile_n]`` f32, step for step:
    per query row, 8 lanes each own 16 rows of every 128-row group of a bin
    (binned_select.cuh lane_row, in increasing order) and keep the kDepth
    smallest (value, row) pairs in a sorted list (strict `<` against a list
    that starts at +inf, so +inf and NaN never enter); at the bin's end the
    8 lists merge in three butterfly steps,
    and survivor e / the bound come from the merged list (every lane holds
    the same one).  Returns (cd, ci, bounds) in the kernels' layout."""
    n_bins, surv, out_w, bound_w = geo
    depth = 3 if surv + 1 <= 3 else 9          # kLaneDepthSmall, kLaneDepth
    n_q = s.shape[0]
    n_tiles = s.shape[1] // tile_n
    bin_groups = tile_n // 128 // n_bins
    cd = np.full((n_q, n_tiles * out_w), np.inf, np.float32)
    ci = np.full((n_q, n_tiles * out_w), _I32MAX, np.int32)
    bounds = np.full((n_q, n_tiles * bound_w), np.inf, np.float32)
    slot = np.arange(8)
    for ti in range(n_tiles):
        for b in range(n_bins):
            lv = np.full((n_q, 8, depth), np.inf, np.float32)
            lr = np.full((n_q, 8, depth), _I32MAX, np.int64)
            for g in range(b * bin_groups, (b + 1) * bin_groups):
                for k in range(16):
                    row = (g * 128 + 32 * (k // 4) + 16 * (slot % 2)
                           + 4 * (k % 4) + slot // 2)
                    v = s[:, ti * tile_n + row]
                    _insert(lv, lr, v, np.broadcast_to(row, v.shape))
            lv, lr = _butterfly_merge(lv, lr)
            for e in range(8):   # every lane of a query row holds one list
                np.testing.assert_array_equal(lr[:, e], lr[:, 0])
            for e in range(surv):
                col = ti * out_w + e * n_bins + b
                cd[:, col] = lv[:, 0, e]
                ci[:, col] = np.where(np.isfinite(lv[:, 0, e]),
                                      ti * tile_n + lr[:, 0, e], _I32MAX)
            bounds[:, ti * bound_w + b] = lv[:, 0, surv]
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
    # the per-lane lists and their butterfly merge select what the plain
    # lane emitter (repeated min / first-argmin) selects: the same rows,
    # values equal, the same bounds, +inf / INT32_MAX padding; and the value
    # it writes is bitwise the selected row's score (a -0 stays -0)
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


@pytest.mark.parametrize("depth", [3, 9])
def test_butterfly_merge_keeps_the_smallest_pairs_in_order(depth):
    # 8 sorted lists of (value, row) with ties, +-0 and +inf: after the
    # merge every lane holds the depth smallest pairs of all 8 lists in
    # (value, row) order, -0 and +0 ordered by row
    rng = np.random.default_rng(depth)
    vals = rng.integers(-3, 4, size=(64, 8, depth)).astype(np.float32)
    vals[::3] = np.where(vals[::3] == 0, np.float32(-0.0), vals[::3])
    vals[5::7, :, -1] = np.inf
    rows = rng.permutation(64 * 8 * depth).reshape(64, 8, depth)
    order = np.lexsort((rows, vals), axis=-1)
    lv = np.take_along_axis(vals, order, -1)
    lr = np.take_along_axis(rows, order, -1).astype(np.int64)
    got_v, got_r = _butterfly_merge(lv.copy(), lr.copy())
    flat_v, flat_r = lv.reshape(64, -1), lr.reshape(64, -1)
    want = np.lexsort((flat_r, flat_v), axis=-1)[:, :depth]
    for lane in range(8):
        np.testing.assert_array_equal(got_r[:, lane],
                                      np.take_along_axis(flat_r, want, -1))
        np.testing.assert_array_equal(
            got_v[:, lane].view(np.uint32),
            np.take_along_axis(flat_v, want, -1).view(np.uint32))


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
    ({"bin_w": 192}, "multiple of 128")])
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
