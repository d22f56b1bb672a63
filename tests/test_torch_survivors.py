"""Grouped binning at 1 to 8 survivors in the port (the deep grouped build's
plain version, knn_tpu_torch.ops.coarse_knn) against the JAX package's
grouped emitter and Pallas kernel (knn_tpu.ops.pallas_knn, interpret mode
on CPU), and certified searches through it against the JAX package and the
float64 oracle.

Inputs are made with numpy from a seed and go through both.  The emitter
on the same f32 scores is held bitwise; f32-family scores within the
kernel tolerance (ck.kernel_tolerance, the K1 tolerance), with ci equal on
separated slots; int arms bitwise (the same pre-quantized operands); pq
within ROADMAP divergence 16's 2 m 2^-24 sum_s max|LUT| (the JAX kernel's
LUT fed to both).  The default arm (K3) is held against the bf16 product
model in tests/test_torch_f32arms.py (divergence 14); here through the
emitter test.  The streaming kernel at the same survivors is in
tests/test_torch_survivors_stream.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knn_tpu.ops import pallas_knn as jpk
from knn_tpu.ops import quantize as jqz
from knn_tpu.parallel.mesh import make_mesh
from knn_tpu.parallel.sharded import ShardedKNN as JaxShardedKNN
from knn_tpu_torch.ops import coarse_knn as ck
from knn_tpu_torch.parallel.sharded import ShardedKNN
from test_torch_cuda import _assert_ci_separated, _assert_scores

import oracles
from test_torch_cuda import empty_default_tune_cache  # noqa: F401 (autouse)

BIN_W = ck.BIN_W
U32 = 2.0 ** -24
SURVIVOR_COUNTS = (1, 3, 8)


def _hard_scores(rng, n_q, n, tile_n):
    """f32 scores with exact ties across groups, -0 and +0, +inf (a bin
    short of finite scores) and large magnitudes; in every tile the last
    group ties the first, and past 256 groups (the kernels' 8-bit group
    indices) groups 255 and 256 tie it too."""
    s = (rng.normal(size=(n_q, n)) * 100).astype(np.float32)
    s[:, 128:256] = s[:, :128]                   # group 1 ties group 0
    s[:, 5::128] = s[:, 5:6]                     # lane 5: one value in all
    s[:, 7] = -0.0
    s[:, 128 + 7] = 0.0
    s[:, 9::128] = np.inf                        # lane 9: no finite score
    s[:, 11::256] = np.inf                       # lane 11: half of them
    s[0] = np.round(s[0])                        # many ties in a row
    for t0 in range(0, n, tile_n):
        first = s[:, t0 : t0 + 128]
        s[:, t0 + tile_n - 128 : t0 + tile_n] = first
        if tile_n > 256 * 128:
            s[:, t0 + 255 * 128 : t0 + 257 * 128] = np.tile(first, 2)
    return s


@pytest.mark.parametrize("survivors", range(1, 9))
@pytest.mark.parametrize("tile_n", [512, 1024, 32768, 65536])
def test_plain_grouped_emitter_bitwise_the_reference_emitter(survivors,
                                                             tile_n):
    # the reference's _emit_select_grouped_scores (pallas_knn.py:575-610)
    # and the port's plain emitter (the deep builds' network, step for
    # step) on the same scores: the same indices, and the same values with
    # -0 equal to +0 (on a tie of signed zeros jnp.minimum and
    # torch.minimum may keep different ones; strict `<` keeps the earlier
    # group's index either way).  256 and 512 groups a tile: the packed
    # deep builds' widest tile and the four-pass build's geometry
    rng = np.random.default_rng(survivors * 100 + tile_n)
    n_tiles = 2
    s = _hard_scores(rng, 6, n_tiles * tile_n, tile_n)
    ref = []
    for ti in range(n_tiles):
        out = jpk._emit_select_grouped_scores(
            ti, jnp.asarray(s[:, ti * tile_n : (ti + 1) * tile_n]),
            tile_n=tile_n, survivors=survivors,
            out_w=survivors * BIN_W, bound_w=BIN_W)
        ref.append([np.asarray(a) for a in out])
    ref = [np.concatenate([r[j] for r in ref], 1) for j in range(3)]
    st = torch.from_numpy(s)
    port = [a.numpy() for a in ck._select_tiles(
        lambda ti, rows: st[:, rows], n_tiles, tile_n, survivors=survivors)]
    for a, b in zip(port, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _quantized_triple(db, arm):
    qr = (jqz.quantize_rows_np(db) if arm == "int8"
          else jqz.quantize_rows_int4_np(db))
    vals = qr.values
    if arm == "int4":
        vals = jqz.pack_nibbles(np.pad(vals,
                                       ((0, 0), (0, -db.shape[1] % 128))))
    norms = (db.astype(np.float64) ** 2).sum(-1).astype(np.float32)
    return vals, qr.scales, norms


def _jax_lut(q, books):
    m, c, dsub = books.shape
    qv = jnp.asarray(np.pad(q, ((0, 0), (0, m * dsub - q.shape[1]))))
    qv = qv.reshape(q.shape[0], m, dsub)
    b = jnp.asarray(books)
    lut = (jnp.einsum("qmd,mcd->qmc", qv, b)
           - 0.5 * jnp.sum(b * b, axis=-1)[None])
    return np.asarray(lut.reshape(q.shape[0], m * c))


def _case(arm, dim, tile_n, seed):
    """(q, db, jax kwargs, port operands) for one arm: integer rows with
    exact ties for the int arms (pre-quantized operands shared), random
    codes and codebooks for pq (the JAX LUT fed to the port), normal rows
    with exact ties for the f32 family."""
    rng = np.random.default_rng(seed)
    n = 2 * tile_n + 60                           # ragged last tile
    if arm in ck.INT_ARMS:
        db = rng.integers(-100, 101, size=(n, dim)).astype(np.float32)
        db[:, 0] = 127.0
        db[2 * BIN_W : 2 * BIN_W + 40] = db[:40]
        q = rng.integers(-100, 101, size=(9, dim)).astype(np.float32)
        q[0] = db[0]
        trip = _quantized_triple(db, arm)
        key = "db_int8" if arm == "int8" else "db_int4"
        t, aux = ck.prepare_db_quant(*(torch.from_numpy(a) for a in trip),
                                     tile_n)
        return q, db, {key: tuple(jnp.asarray(a) for a in trip)}, (
            *ck.quantize_queries(torch.from_numpy(q)), t, aux)
    db = (rng.normal(size=(n, dim)) * 10).astype(np.float32)
    db[3] = db[90] = db[BIN_W + 3] = db[10]
    q = (rng.normal(size=(9, dim)) * 10).astype(np.float32)
    q[0] = db[10]
    if arm == "pq":
        m, c = -(-dim // 4), 32
        codes = rng.integers(0, c, size=(n, m)).astype(np.uint8)
        codes[3] = codes[90] = codes[10]
        books = (rng.normal(size=(m, c, 4)) * 10).astype(np.float32)
        lut = _jax_lut(q, books).copy()
        return q, db, {"db_pq": (jnp.asarray(codes), jnp.asarray(books))}, (
            torch.from_numpy(lut),
            *ck.prepare_db_pq(torch.from_numpy(codes), tile_n))
    return q, db, {}, (ck.pad_queries(torch.from_numpy(q)),
                       *ck.prepare_db_arm(torch.from_numpy(db), tile_n, arm))


def check_against_pallas(arm, kernel, survivors, tile_n, dim):
    """The port's plain coarse pass of ``kernel`` at ``survivors`` against
    the JAX package's Pallas kernel in interpret mode."""
    seed = dim + tile_n + survivors + len(arm)
    q, db, jax_kw, ops = _case(arm, dim, tile_n, seed)
    ref = jpk._bin_candidates(
        jnp.asarray(q), jnp.asarray(db), block_q=8, tile_n=tile_n,
        bin_w=BIN_W, survivors=survivors, precision=arm, interpret=True,
        kernel=kernel, **jax_kw)
    ref = [np.asarray(a)[: q.shape[0]] for a in ref]
    fn = ck.stream_select if kernel == "streaming" else ck.binned_select
    before = dict(fn.deep_launches)
    port = [a.numpy() for a in fn(*ops, tile_n=tile_n, arm=arm,
                                  survivors=survivors)]
    assert fn.deep_launches == before      # CPU: the plain version
    assert [a.shape for a in port] == [a.shape for a in ref]
    assert port[0].shape[1] == 3 * survivors * BIN_W
    if arm in ck.INT_ARMS:
        for a, b in zip(port, ref):
            np.testing.assert_array_equal(a, b)
        return
    if arm == "pq":
        m = ops[1].shape[1]
        lut = ops[0].numpy()
        tol = 2 * m * U32 * np.abs(lut.reshape(lut.shape[0], m, -1)
                                   ).max(-1).sum(-1)
    else:
        tol = ck.kernel_tolerance(q, db, precision=arm)
    _assert_scores(port[0], ref[0], tol)
    _assert_scores(port[2], ref[2], tol)
    _assert_ci_separated(ref[0], port[1], ref[1], ref[2], tol)


ARMS = ("bf16x3", "bf16x3f", "highest", "int8", "int4", "pq")


@pytest.mark.parametrize("arm", ARMS)
@pytest.mark.parametrize("survivors", SURVIVOR_COUNTS)
@pytest.mark.parametrize("tile_n", [512, 1024])
@pytest.mark.parametrize("dim", [100, 200])       # Dp 128 and 256
def test_plain_tiled_matches_pallas_at_survivors(arm, survivors, tile_n, dim):
    check_against_pallas(arm, "tiled", survivors, tile_n, dim)


def _far_case(arm, seed=0):
    """Queries near tile 0 of three 256-row tiles, tiles 1 and 2 far: the
    fused kernel skips them (tests/test_torch_stream.py's far tiles)."""
    rng = np.random.default_rng(seed)
    db = rng.normal(size=(6 * BIN_W, 16)).astype(np.float32)
    db[2 * BIN_W:] += 500.0
    q = db[:9] + rng.normal(size=(9, 16)).astype(np.float32) * 1e-2
    if arm in ck.INT_ARMS:
        trip = _quantized_triple(db, arm)
        key = "db_int8" if arm == "int8" else "db_int4"
        t, aux = ck.prepare_db_quant(*(torch.from_numpy(a) for a in trip),
                                     2 * BIN_W)
        return q, db, {key: tuple(jnp.asarray(a) for a in trip)}, (
            *ck.quantize_queries(torch.from_numpy(q)), t, aux)
    return q, db, {}, (ck.pad_queries(torch.from_numpy(q)),
                       *ck.prepare_db_arm(torch.from_numpy(db), 2 * BIN_W,
                                          arm))


@pytest.mark.parametrize("arm", ["bf16x3", "bf16x3f", "highest", "int8",
                                 "int4"])
@pytest.mark.parametrize("survivors", SURVIVOR_COUNTS)
def test_plain_fused_skips_the_cells_pallas_skips(arm, survivors):
    # K11's carry depth is ceil(keep / 128), whatever the survivors: the
    # skip mask at 1, 3 and 8 survivors is the reference's
    q, db, jax_kw, ops = _far_case(arm)
    ref = jpk._bin_candidates(
        jnp.asarray(q), jnp.asarray(db), block_q=16, tile_n=2 * BIN_W,
        bin_w=BIN_W, survivors=survivors, precision=arm, interpret=True,
        kernel="fused", keep=15, **jax_kw)
    ref = [np.asarray(a)[: q.shape[0]] for a in ref]
    port = [a.numpy() for a in ck.fused_select_plain(
        *ops, tile_n=2 * BIN_W, keep=15, block_q=16, arm=arm,
        survivors=survivors)]
    n_tiles = 3
    skip_ref = ck.skipped_cells(torch.from_numpy(ref[0]), n_tiles, 16)
    skip_port = ck.skipped_cells(torch.from_numpy(port[0]), n_tiles, 16)
    assert torch.equal(skip_port, skip_ref)
    assert bool(skip_port[0, 1:].all()) and not bool(skip_port[0, 0])
    if arm in ck.INT_ARMS:
        for a, b in zip(port, ref):
            np.testing.assert_array_equal(a, b)
    else:
        tol = ck.kernel_tolerance(q, db, precision=arm)
        _assert_scores(port[0], ref[0], tol)
        _assert_scores(port[2], ref[2], tol)


def _blobs(seed, n=1500, dim=24):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(20, dim)) * 8
    db = (c[rng.integers(0, 20, n)] + rng.normal(size=(n, dim))).astype(
        np.float32)
    db[50:60] = db[:10]                          # duplicate rows: ties
    q = (c[rng.integers(0, 20, 13)] + rng.normal(size=(13, dim))).astype(
        np.float32)
    return db, q


def _oracle_idx(db, q, k):
    d = oracles.sq_l2(q, db)
    idx = np.lexsort((np.broadcast_to(np.arange(db.shape[0]), d.shape), d),
                     axis=-1)
    return idx[:, :k]


@pytest.mark.parametrize("knobs", [
    {"survivors": 1}, {"survivors": 4}, {"survivors": 8},
    {"survivors": 12},                 # capped at MAX_SURVIVORS, as there
    {"bin_w": 256}], ids=["s1", "s4", "s8", "s12", "bin_w256"])
def test_search_certified_at_survivors_matches_jax_and_oracle(knobs):
    db, q = _blobs(8)
    k = 7
    _, pi, st = ShardedKNN(db, k=k, device="cpu").search_certified(
        q, tile_n=512, **knobs)
    _, ji, _ = JaxShardedKNN(db, mesh=make_mesh(1, 1), k=k).search_certified(
        q, selector="pallas", tile_n=512, block_q=8, **knobs)
    np.testing.assert_array_equal(pi, np.asarray(ji))
    np.testing.assert_array_equal(pi, _oracle_idx(db, q, k))
    assert st["pallas_knobs"]["survivors"] == knobs.get("survivors")


@pytest.fixture(scope="module")
def placed():
    """One placement for every arm (its quantized and pq placements, the
    codebooks trained once, are built at first use and kept)."""
    db, q = _blobs(21)
    return db, q, ShardedKNN(db, k=6, device="cpu")


@pytest.mark.parametrize("arm,kernel", [
    (arm, kernel) for arm in ARMS for kernel in ("tiled", "streaming", "fused")
    if (arm, kernel) != ("pq", "fused")])    # refused, as the JAX package does
@pytest.mark.parametrize("survivors", SURVIVOR_COUNTS)
def test_search_certified_every_arm_at_survivors_matches_oracle(
        placed, arm, kernel, survivors):
    db, q, knn = placed
    k = knn.k
    d, i, st = knn.search_certified(
        q, tile_n=512, precision=arm, kernel=kernel, survivors=survivors)
    np.testing.assert_array_equal(i, _oracle_idx(db, q, k))
    ref_d = np.take_along_axis(oracles.sq_l2(q, db), i, axis=-1)
    np.testing.assert_allclose(d, ref_d, rtol=2 * ck.RANK_SLACK)
    assert st["certified"] + st["fallback_queries"] == q.shape[0]


def test_grouped_bin_w_moves_only_the_tile_floor():
    # grouped binning: bin_w does not shape the bins (the emit geometry is
    # the 128-lane one), it sets effective_tile's granularity -- both as
    # the JAX package computes them
    for rows, tile, bin_w, surv, width in ((700, 16384, 256, 3, 40),
                                           (5000, 1024, 512, None, 900),
                                           (100_000, 16384, 256, 8, 130)):
        assert ck.effective_tile(rows, tile, bin_w, surv, "grouped", width) \
            == jpk.effective_tile(rows, tile, bin_w, surv, "grouped", width)
        assert ck.emit_geometry(tile, "grouped", bin_w, surv) == \
            jpk._geometry(tile, bin_w, surv, "grouped")
    with pytest.raises(ValueError, match="multiple of bin_w"):
        ck.emit_geometry(384, "grouped", 256, 2)
