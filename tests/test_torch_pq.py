"""The port's pq arm (K7) against the JAX package (knn_tpu.ops.pq,
knn_tpu.ivf.kmeans, knn_tpu.ops.pallas_knn in interpret mode on CPU,
knn_tpu.parallel.sharded) and the float64 oracle.

The numpy functions of ops/pq.py and ivf/kmeans.py are the reference's
verbatim, so they are held bitwise; the k=1 assign of the k-means runs the
port's exact search, whose f32 distances can differ from the reference's
in the last bit, so training is compared on data without near ties
(well-separated rows).  K7 sums a row's LUT entries in f32: its plain
version in subspace order, the Pallas kernel as XLA orders its one-hot
dot, so their scores agree within 2 m 2^-24 sum_s |LUT| per query, with
ci equal on separated slots.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knn_tpu.ivf import kmeans as jkm
from knn_tpu.ops import pallas_knn as jpk
from knn_tpu.ops import pq as jpq
from knn_tpu.parallel.mesh import make_mesh
from knn_tpu.parallel.sharded import ShardedKNN as JaxShardedKNN
from knn_tpu_torch import knn_search_pallas
from knn_tpu_torch.convert import pq_from_numpy
from knn_tpu_torch.ivf import kmeans as pkm
from knn_tpu_torch.ops import coarse_knn as ck
from knn_tpu_torch.ops import pq as ppq
from knn_tpu_torch.parallel.sharded import ShardedKNN
from test_torch_cuda import (_assert_ci_separated, _assert_lane_ci_separated,
                             pq_bound_ratio)

import oracles
from test_torch_cuda import empty_default_tune_cache  # noqa: F401 (autouse)

BIN_W = ck.BIN_W
U32 = 2.0 ** -24


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(1, 1)


def _oracle(db, q, k):
    d = oracles.sq_l2(q, db)
    idx = np.lexsort((np.broadcast_to(np.arange(db.shape[0]), d.shape), d),
                     axis=-1)[:, :k]
    return np.take_along_axis(d, idx, axis=-1), idx


def _separated_rows(rng, n, d, centers=48):
    """Rows around well-separated centers: no f32 near ties in any k=1
    assign of the k-means, so both packages' assigns agree."""
    c = rng.normal(size=(centers, d)) * 40.0
    return (c[rng.integers(0, centers, size=n)]
            + rng.normal(size=(n, d))).astype(np.float32)


# --- numpy functions -----------------------------------------------------------


def test_constants_and_numpy_functions_match_jax(mesh):
    from knn_tpu.analysis import widths

    assert (ppq.PQ_DSUB_DEFAULT, ppq.PQ_NCODES_DEFAULT) == (
        widths.PQ_DSUB_DEFAULT, widths.PQ_NCODES_DEFAULT)
    rng = np.random.default_rng(1)
    rows = (rng.normal(size=(300, 10)) * 3).astype(np.float32)
    q = (rng.normal(size=(7, 10)) * 3).astype(np.float32)
    res = jpq.train_pq(rows, mesh=mesh, dsub=4, ncodes=16)
    np.testing.assert_array_equal(
        ppq.reconstruct(res.codebooks, res.codes, 10, 4),
        jpq.reconstruct(res.codebooks, res.codes, 10, 4))
    np.testing.assert_array_equal(ppq.build_luts(q, res.codebooks, 4),
                                  jpq.build_luts(q, res.codebooks, 4))
    ours = ppq.pq_bound_stats(res.codebooks, res.codes, rows, dsub=4,
                              chunk=128)
    theirs = jpq.pq_bound_stats(res.codebooks, res.codes, rows, dsub=4,
                                chunk=128)
    np.testing.assert_array_equal(ours.pop("r_sub"), theirs.pop("r_sub"))
    assert ours == theirs
    np.testing.assert_array_equal(ppq.bound_consts_pq(res.stats),
                                  jpq.bound_consts_pq(res.stats))
    np.testing.assert_array_equal(ppq.score_error_bound_pq(q, res.stats),
                                  jpq.score_error_bound_pq(q, res.stats))


@pytest.mark.parametrize("dim", [1, 3, 4])
def test_farthest_point_init_picks_match_jax(dim):
    rng = np.random.default_rng(dim)
    rows64 = (rng.normal(size=(500, dim)) * 7).astype(np.float32).astype(
        np.float64)
    ref = jkm._farthest_point_init(rows64, 40, seed=5)
    np.testing.assert_array_equal(pkm._farthest_point_init(rows64, 40, 5), ref)
    # lattice rows: exact ties in the distances go to the lowest index
    lat = np.repeat(np.arange(6.0)[:, None], dim, 1)[rng.integers(0, 6, 200)]
    np.testing.assert_array_equal(pkm._farthest_point_init(lat, 6, 0),
                                  jkm._farthest_point_init(lat, 6, 0))


@pytest.mark.parametrize("ncodes", [16, 64])
def test_train_kmeans_and_train_pq_match_jax(mesh, ncodes):
    rng = np.random.default_rng(ncodes)
    rows = _separated_rows(rng, 2000, 8)
    km = pkm.train_kmeans(rows[:, :4], ncodes, device="cpu", seed=3)
    jk = jkm.train_kmeans(rows[:, :4], ncodes, mesh=mesh, seed=3)
    for a, b in zip(km, jk):
        np.testing.assert_array_equal(a, b)
    ours = ppq.train_pq(rows, device="cpu", dsub=4, ncodes=ncodes, seed=2)
    theirs = jpq.train_pq(rows, mesh=mesh, dsub=4, ncodes=ncodes, seed=2)
    np.testing.assert_array_equal(ours.codebooks, theirs.codebooks)
    np.testing.assert_array_equal(ours.codes, theirs.codes)
    assert (ours.dsub, ours.dim, ours.nsub, ours.ncodes) == (
        theirs.dsub, theirs.dim, theirs.nsub, theirs.ncodes)
    np.testing.assert_array_equal(ours.stats["r_sub"], theirs.stats["r_sub"])
    np.testing.assert_array_equal(
        ppq.encode_pq(rows, ours.codebooks, device="cpu", dsub=4), ours.codes)
    for kw in ({"dsub": 0}, {"ncodes": 1}, {"ncodes": 300}):
        with pytest.raises(ValueError):
            ppq.train_pq(rows, device="cpu", **kw)


def test_torch_eps_never_below_host(mesh):
    # tests/test_pq.py:133 for the torch twin
    rng = np.random.default_rng(13)
    rows = (rng.normal(size=(80, 14)) * 20).astype(np.float32)
    q = (rng.normal(size=(6, 14)) * 20).astype(np.float32)
    res = jpq.train_pq(rows, mesh=mesh, dsub=4, ncodes=16)
    host = ppq.score_error_bound_pq(q, res.stats)
    consts = torch.from_numpy(ppq.bound_consts_pq(res.stats))
    q_norm, eps = ppq.score_error_bound_pq_t(torch.from_numpy(q), consts,
                                             dsub=4)
    assert (eps.double().numpy() >= host * (1 - 1e-5)).all()
    np.testing.assert_allclose(q_norm.numpy(),
                               (q.astype(np.float64) ** 2).sum(-1), rtol=1e-5)
    # the JAX device twin's ε plus K7's own f32 term (m = 4 subspaces)
    jq, jeps = jpq.score_error_bound_pq_device(
        jnp.asarray(q), jnp.asarray(jpq.bound_consts_pq(res.stats)), dsub=4)
    k7 = ppq.k7_rounding(4, 4) * (q_norm + 2.0 * (consts[5] + consts[4]))
    assert (k7 > 0).all()
    np.testing.assert_allclose(eps.numpy(), np.asarray(jeps) + k7.numpy(),
                               rtol=1e-6)


def test_k7_rounding_bound_covers_many_subspaces():
    # 784 dims at dsub 4: m = 196 f32 adds per score, where K7's chain
    # alone can pass the reference's f32 slack of 128 u (||q||^2 + M)
    assert ppq.k7_rounding(196, 4) * 2 ** 24 > 200
    ratio = pq_bound_ratio("cpu", "plain")
    assert 0.0 < ratio <= 1.0
    # the certified search at m = 196 on rows with zero residuals: ε is the
    # f32 terms alone, and the indices are the oracle's
    rng = np.random.default_rng(5)
    m, dsub, c, k = 196, 4, 64, 5
    books = (rng.normal(size=(m, c, dsub)) * 3).astype(np.float32)
    codes = rng.integers(0, c, size=(600, m)).astype(np.uint8)
    rows = ppq.reconstruct(books, codes, m * dsub, dsub)
    queries = (rng.normal(size=(12, m * dsub)) * 3).astype(np.float32)
    stats = ppq.pq_bound_stats(books, codes, rows, dsub=dsub)
    assert not stats["r_sub"].any()
    knn = ShardedKNN(rows, k=k, device="cpu")
    pq_from_numpy(knn, books, codes, stats, dsub, m * dsub)
    d, i, st = knn.search_certified(queries, precision="pq", pq_ncodes=c,
                                    tile_n=256)
    ref_d, ref_i = _oracle(rows, queries, k)
    np.testing.assert_array_equal(i, ref_i)
    np.testing.assert_allclose(d, ref_d, rtol=5e-5)
    assert st["certified"] == 12


# --- the pq prologue and K7's plain version ------------------------------------


def _trained(mesh, seed, n=5 * BIN_W + 60, dim=24, ncodes=32):
    rng = np.random.default_rng(seed)
    db = (rng.normal(size=(n, dim)) * 10).astype(np.float32)
    db[3] = db[90] = db[10]  # exact ties inside one lane bin
    q = (rng.normal(size=(11, dim)) * 10).astype(np.float32)
    q[0] = db[10]
    return q, db, jpq.train_pq(db, mesh=mesh, dsub=4, ncodes=ncodes)


def _jax_lut(q, books):
    m, c, dsub = books.shape
    qv = jnp.asarray(np.pad(q, ((0, 0), (0, m * dsub - q.shape[1]))))
    qv = qv.reshape(q.shape[0], m, dsub)
    b = jnp.asarray(books)
    lut = (jnp.einsum("qmd,mcd->qmc", qv, b)
           - 0.5 * jnp.sum(b * b, axis=-1)[None])
    return np.asarray(lut.reshape(q.shape[0], m * c))


def test_pq_prologue_matches_pallas(mesh):
    q, db, res = _trained(mesh, 2)
    lut = ck.pq_luts(torch.from_numpy(q), torch.from_numpy(res.codebooks))
    ref = _jax_lut(q, res.codebooks)
    # dsub products of f32 values summed in f32: within (dsub + 2) u of the
    # terms' magnitudes
    mag = (np.abs(q).max() * np.abs(res.codebooks).max() * 4
           + (res.codebooks.astype(np.float64) ** 2).sum(-1).max())
    np.testing.assert_allclose(lut.numpy(), ref, rtol=0, atol=8 * U32 * mag)
    np.testing.assert_allclose(lut.numpy(), ppq.build_luts(q, res.codebooks, 4),
                               rtol=0, atol=8 * U32 * mag)
    codes, tnorm = ck.prepare_db_pq(torch.from_numpy(res.codes), 256)
    assert codes.shape == (768, res.nsub) and tnorm.shape == (8, 768)
    np.testing.assert_array_equal(codes[: db.shape[0]].numpy(), res.codes)
    assert not codes[db.shape[0]:].any()
    assert (tnorm[:, : db.shape[0]] == 0).all()
    assert (tnorm[:, db.shape[0]:] == np.float32(ck.PAD_VAL)).all()


def _assert_pq_scores(port, ref, tol):
    # pad rows score PAD_VAL - 2 qt: compared at the f32 resolution there
    pad = ref >= 1e16
    np.testing.assert_array_equal(port >= 1e16, pad)
    np.testing.assert_array_equal(np.isinf(port), np.isinf(ref))
    real = ~pad & np.isfinite(ref)
    with np.errstate(invalid="ignore"):
        err = np.where(real, np.abs(port - ref), 0.0)
    assert (err <= tol[:, None]).all(), float(err.max())
    fin = pad & np.isfinite(ref)
    assert (np.abs(port[fin] - ref[fin]) <= 2.0 ** -20 * ref[fin]).all()


@pytest.mark.parametrize("binning,kernel,survivors", [
    ("grouped", "tiled", None), ("grouped", "streaming", None),
    ("lane", "tiled", None), ("lane", "streaming", 8)])
def test_plain_k7_matches_pallas(mesh, binning, kernel, survivors):
    q, db, res = _trained(mesh, 4)
    tile_n = 2 * 256
    ref = jpk._bin_candidates(
        jnp.asarray(q), jnp.asarray(db), block_q=8, tile_n=tile_n,
        bin_w=BIN_W, survivors=survivors, precision="pq", interpret=True,
        binning=binning, kernel=kernel,
        db_pq=(jnp.asarray(res.codes), jnp.asarray(res.codebooks)))
    ref = [np.asarray(a)[: q.shape[0]] for a in ref]
    lut = _jax_lut(q, res.codebooks).copy()
    # the same codes carried into the port's placement (convert.py), padded
    # for the tile
    knn = ShardedKNN(db, k=5, device="cpu")
    placed = pq_from_numpy(knn, res.codebooks, res.codes, res.stats, res.dsub,
                           res.dim)
    ops = (torch.from_numpy(lut),
           *knn._coarse_parts(tile_n, "pq", placed))
    fn = ck.stream_select if kernel == "streaming" else ck.binned_select
    port = [a.numpy() for a in fn(*ops, tile_n=tile_n, arm="pq",
                                  binning=binning, survivors=survivors)]
    m, c = res.nsub, res.ncodes
    tol = 2 * m * U32 * np.abs(lut.reshape(-1, m, c)).max(-1).sum(-1)
    _assert_pq_scores(port[0], ref[0], tol)
    _assert_pq_scores(port[2], ref[2], tol)
    if binning == "grouped":
        _assert_ci_separated(ref[0], port[1], ref[1], ref[2], tol)
    else:
        geo = ck._geometry(tile_n, BIN_W, survivors, "lane")
        _assert_lane_ci_separated(ref[0], port[1], ref[1], ref[2], geo, tol)
    # the port's own prologue through _bin_candidates: the same scores
    # within the LUT's rounding as well
    own = ck._bin_candidates(
        torch.from_numpy(q), torch.from_numpy(db), tile_n=tile_n,
        precision="pq", kernel=kernel, binning=binning, survivors=survivors,
        db_pq=(torch.from_numpy(res.codes), torch.from_numpy(res.codebooks)))
    _assert_pq_scores(own[0].numpy(), ref[0], 4 * tol)


def test_k7_sums_the_lut_in_subspace_order():
    # three subspaces whose entries sum differently by association in f32:
    # 1 + 2^-24 + 2^-24 is 1 left to right, 1 + 2^-23 otherwise
    lut = torch.tensor([[1.0, 0.0, U32, 0.0, U32, 0.0]])
    codes = torch.zeros((128, 3), dtype=torch.uint8)
    ops = (lut, *ck.prepare_db_pq(codes, 128))
    cd, _, _ = ck.binned_select_plain(*ops, tile_n=128, arm="pq")
    assert cd[0, 0].item() == -2.0


@pytest.mark.parametrize("n_q,n,m,ncodes,tile_n", [
    (45, 1280 + 60, 7, 200, 1280), (33, 300, 196, 64, 384)])
def test_k7_kernel_layout_replays_the_plain_scores(n_q, n, m, ncodes, tile_n):
    # the LUT and codes as the CUDA kernel reads them (query block x
    # subspace x [code][query], codes subspace-major), summed in the
    # kernel's order (per query block and row, subspaces in order, f32 adds
    # from 0), give the plain version's scores bitwise
    rng = np.random.default_rng(m)
    lut = torch.from_numpy((rng.normal(size=(n_q, m * ncodes)) * 10)
                           .astype(np.float32))
    codes, tnorm = ck.prepare_db_pq(torch.from_numpy(
        rng.integers(0, ncodes, size=(n, m)).astype(np.uint8)), tile_n)
    lut_t, codes_t = (a.numpy() for a in ck._pq_kernel_operands(lut, codes))
    n_blocks = -(-n_q // ck.QUERY_BLOCK)
    assert lut_t.shape == (n_blocks, m, ncodes, ck.QUERY_BLOCK)
    assert codes_t.shape == (m, codes.shape[0])
    # queries past n_q read zeros
    assert not lut_t[-1, :, :, n_q - (n_blocks - 1) * ck.QUERY_BLOCK:].any()
    rows = np.arange(codes.shape[0])
    acc = np.zeros((n_blocks, ck.QUERY_BLOCK, rows.size), np.float32)
    for s in range(m):
        acc = acc + lut_t[:, s][:, codes_t[s]].transpose(0, 2, 1)
    got = tnorm[0].numpy()[None, :] - np.float32(2.0) * acc.reshape(
        -1, rows.size)[:n_q]
    scores, _ = ck._pq_scores(lut, codes, tnorm)
    want = scores(0, slice(None)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


# --- knobs and the certified path ---------------------------------------------


def test_pq_knobs_and_refusals():
    for kern in ("tiled", "streaming"):
        ck.check_knobs(kernel=kern, precision="pq")
        ck.check_knobs(kernel=kern, precision="pq", binning="lane")
    ck.check_knobs(precision="pq", grid_order="db_major")
    with pytest.raises(ValueError, match="precision='pq'"):
        ck.check_knobs(kernel="fused", precision="pq")
    ops = (torch.zeros((2, 64)), *ck.prepare_db_pq(
        torch.zeros((10, 4), dtype=torch.uint8), 128))
    with pytest.raises(ValueError, match="precision='pq'"):
        ck.fused_select(*ops, tile_n=128, keep=15, arm="pq")
    with pytest.raises(ValueError, match="m\\*C"):
        ck.binned_select(torch.zeros((2, 63)), *ops[1:], tile_n=128, arm="pq")
    with pytest.raises(ValueError, match="requires db_pq"):
        ck._bin_candidates(torch.zeros((2, 4)), torch.zeros((10, 4)),
                           tile_n=128, precision="pq")


def test_kernel_tolerance_pq_matches_pallas(mesh):
    q, db, res = _trained(mesh, 6)
    np.testing.assert_allclose(
        ck.kernel_tolerance(q, db, precision="pq", quant=res),
        jpk.kernel_tolerance(q, db, precision="pq", quant=res), rtol=1e-12)
    with pytest.raises(ValueError, match="PQResult"):
        ck.kernel_tolerance(q, db, precision="pq")


@pytest.mark.parametrize("kernel,grid_order,binning", [
    ("tiled", "query_major", "grouped"), ("tiled", "db_major", "grouped"),
    ("streaming", "query_major", "grouped"), ("tiled", "query_major", "lane"),
    ("streaming", "query_major", "lane")])
def test_pq_certified_matches_oracle(kernel, grid_order, binning):
    # tests/test_pq.py:162 on the port, its own training
    rng = np.random.default_rng(0)
    n, d, k = 900, 24, 7
    train = (rng.normal(size=(n, d)) * 10).astype(np.float32)
    queries = (rng.normal(size=(16, d)) * 10).astype(np.float32)
    ref_d, ref_i = _oracle(train, queries, k)
    knn = ShardedKNN(train, k=k, device="cpu")
    dd, ii, st = knn.search_certified(
        queries, precision="pq", kernel=kernel, grid_order=grid_order,
        binning=binning, pq_ncodes=32)
    np.testing.assert_array_equal(ii, ref_i)
    np.testing.assert_allclose(dd, ref_d, rtol=5e-5)
    assert st["certified"] + st["fallback_queries"] == 16
    placed = knn._pq_placement(None, 32)
    assert placed["parts"][0].shape == (16384, 6)
    assert placed["train_s"] > 0


def test_pq_forced_miss_is_detected_and_repaired():
    # tests/test_pq.py:188 on the port
    rng = np.random.default_rng(2)
    dim, k = 12, 10
    tile_n = 2 * BIN_W
    db = (rng.normal(size=(4 * BIN_W, dim)) * 50).astype(np.float32)
    query = rng.normal(size=(1, dim)).astype(np.float32)
    for j, r in enumerate(2 * BIN_W + 3 * j for j in range(k)):
        db[r] = query[0] + (j + 1) * 1e-3
    ref_d, ref_i = _oracle(db, query, k)
    d, i, stats = knn_search_pallas(query, db, k, tile_n=tile_n, margin=4,
                                    precision="pq", binning="lane",
                                    pq_ncodes=32, device="cpu")
    np.testing.assert_array_equal(i, ref_i)
    np.testing.assert_allclose(d, ref_d, rtol=5e-5)
    assert stats["fallback_queries"] >= 1
    assert stats["fallback_genuine_misses"] >= 1


def test_pq_from_numpy_gives_the_jax_certified_indices(mesh, monkeypatch):
    monkeypatch.setenv("KNN_TPU_PQ_NCODES", "32")
    rng = np.random.default_rng(8)
    n, d, k = 900, 24, 7
    train = (rng.normal(size=(n, d)) * 10).astype(np.float32)
    queries = (rng.normal(size=(16, d)) * 10).astype(np.float32)
    res = jpq.train_pq(train, mesh=mesh, dsub=4, ncodes=32)
    jknn = JaxShardedKNN(train, k=k, mesh=mesh)
    jd, ji, jst = jknn.search_certified(queries, selector="pallas",
                                        precision="pq")
    # the JAX placement trained the same codes (seeded, deterministic)
    placed = jknn._pq_placement()
    np.testing.assert_array_equal(np.asarray(placed["codes"])[:n], res.codes)
    knn = ShardedKNN(train, k=k, device="cpu")
    entry = pq_from_numpy(knn, res.codebooks, res.codes, res.stats, res.dsub,
                          res.dim, ncodes=32)
    assert knn._pq_placement(None, 32) is entry
    dd, ii, st = knn.search_certified(queries, precision="pq", pq_ncodes=32)
    np.testing.assert_array_equal(ii, np.asarray(ji))
    np.testing.assert_array_equal(ii, _oracle(train, queries, k)[1])
    with pytest.raises(ValueError, match="dim"):
        pq_from_numpy(knn, res.codebooks, res.codes, res.stats, 4, d + 1)


def test_pq_predict_certified_and_job_match_exact(tmp_path):
    from knn_tpu_torch.cli import main
    from knn_tpu_torch.data.datasets import save_labeled_csv, save_unlabeled_csv

    rng = np.random.default_rng(11)
    train = _separated_rows(rng, 600, 20, centers=6)
    labels = (np.arange(600) % 4).astype(np.int32)
    test = _separated_rows(rng, 30, 20, centers=6)
    knn = ShardedKNN(train, k=9, labels=labels, num_classes=4, device="cpu")
    got, st = knn.predict_certified(test, precision="pq")
    np.testing.assert_array_equal(got, knn.predict(test).numpy())
    assert st["pallas_knobs"]["precision"] == "pq"
    save_labeled_csv(str(tmp_path / "tr.csv"), train, labels)
    save_unlabeled_csv(str(tmp_path / "te.csv"), test)
    outs = {}
    for mode in (("--mode", "exact"),
                 ("--mode", "certified", "--pallas-precision", "pq")):
        out = str(tmp_path / f"labels_{len(mode)}.csv")
        assert main(["--train", str(tmp_path / "tr.csv"), "--test",
                     str(tmp_path / "te.csv"), "--k", "9", "--out", out,
                     "--device", "cpu", *mode]) == 0
        outs[len(mode)] = open(out).read()
    assert outs[2] == outs[4]
