"""The port's CUDA kernels on the card, each against its plain PyTorch
version — tests marked ``cuda``, skipped without a GPU.

This file imports neither JAX nor the JAX package, so on a machine with a
card and no JAX it runs on its own::

    python -m pytest --noconftest tests/test_torch_cuda.py -q

The comparison helpers here are shared with tests/test_torch_coarse_knn.py:
f32 scores agree within 64 eps_f32 (||q||^2 + max||t||^2) per query (the
two sum in different orders; for highest, whose two differ only in the
order of each chunk's f64 sum, within (2 nd + 4) u (||q||^2 +
max||t||^2); a CUDA kernel against its plain version within
ck.kernel_plain_tolerance_scale, for the bf16 tensor-core arms bf16x3,
bf16x3f and default the proved sum of the two summations' bounds), ci is
equal wherever a bin's values are separated by more than that, and
pad-row scores (~1e35, from PAD_VAL rows) are compared by class.  So is
the fixture ``empty_default_tune_cache``, which every test module that
searches imports.
"""

import numpy as np
import pytest
import torch

from knn_tpu_torch.ops import coarse_knn as ck
from knn_tpu_torch.tuning import cache as tune_cache

EPS32 = float(np.finfo(np.float32).eps)
U32 = 2.0 ** -24
PAD_SCALE = 1e30


@pytest.fixture(scope="module", autouse=True)
def empty_default_tune_cache(tmp_path_factory):
    """The tuner's default cache, for the module that holds or imports this
    fixture, is an empty file of its own: a search's knobs left at None
    resolve to the library defaults whatever the user's
    ~/.cache/knn_tpu_torch/autotune.json holds (tests of the cache pass
    explicit paths, or write this one)."""
    path = str(tmp_path_factory.mktemp("tune_cache") / "autotune.json")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tune_cache, "default_cache_path", lambda: path)
        yield path


def _data(rng, n_q, n, dim, scale=10.0):
    q = (rng.normal(size=(n_q, dim)) * scale).astype(np.float32)
    db = (rng.normal(size=(n, dim)) * scale).astype(np.float32)
    return q, db


def _tol(q, db, arm="bf16x3", kernel=False):
    # highest: the kernel and its plain version round each chunk's f64 sum
    # to f32 (the two f64 sums differ far below an ulp, so the roundings by
    # at most one ulp), then add the nd chunks and form s in the same f32
    # order (at most one more ulp each): |Δs| <= (2 nd + 4) u (||q||^2 + M).
    # ``kernel``: a CUDA kernel against its plain version, at
    # ck.kernel_plain_tolerance_scale -- for bf16x3, bf16x3f and default
    # the proved sum of the tensor-core summation's bound and the plain
    # version's (past 64 eps_f32), for highest the value below
    q64, db64 = q.astype(np.float64), db.astype(np.float64)
    scale = (q64 ** 2).sum(-1) + (db64 ** 2).sum(-1).max()
    nd = -(-q.shape[1] // ck.DIM_CHUNK)
    if kernel:
        return ck.kernel_plain_tolerance_scale(arm, nd) * scale
    if arm == "highest":
        return (2 * nd + 4) * U32 * scale
    return 64 * EPS32 * scale


def _assert_scores(port, ref, tol):
    pad_p, pad_r = port >= PAD_SCALE, ref >= PAD_SCALE
    np.testing.assert_array_equal(pad_p, pad_r)
    np.testing.assert_array_equal(np.isinf(port), np.isinf(ref))
    real = ~pad_r & np.isfinite(ref)
    err = np.zeros(ref.shape)
    err[real] = np.abs(port[real] - ref[real])
    assert (err <= tol[:, None]).all(), float(err.max())


def _assert_ci_separated(cd, ci_p, ci_r, bounds, tol):
    # grouped binning: survivors = candidate columns over bound columns
    survivors = cd.shape[1] // bounds.shape[1]
    n_q = cd.shape[0]
    seq = np.concatenate([cd.reshape(n_q, -1, survivors, 128),
                          bounds.reshape(n_q, -1, 1, 128)], axis=2)
    with np.errstate(invalid="ignore"):
        gap = np.abs(np.diff(seq, axis=2))
    t = tol[:, None, None, None]
    sep = gap[:, :, :survivors] > t
    sep[:, :, 1:] &= gap[:, :, : survivors - 1] > t
    sep &= np.isfinite(seq[:, :, :survivors])
    a = ci_p.reshape(sep.shape)
    b = ci_r.reshape(sep.shape)
    assert sep.sum() > 0
    np.testing.assert_array_equal(a[sep], b[sep])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernel runs only on the GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dim,tile_n", [(24, 256), (300, 256), (128, 16384)])
def test_cuda_kernel_matches_plain(cuda_device, dim, tile_n):
    rng = np.random.default_rng(dim)
    q, db = _data(rng, 37, 3 * tile_n // 2 + 60, dim)
    th, tl, tnorm = ck.prepare_db(torch.from_numpy(db).to(cuda_device), tile_n)
    qp = ck.pad_queries(torch.from_numpy(q).to(cuda_device))
    before = ck.binned_select.launches["bf16x3"]
    kern = [a.cpu().numpy() for a in ck.binned_select(qp, th, tl, tnorm,
                                                      tile_n=tile_n,
                                                      arm="bf16x3")]
    assert ck.binned_select.launches["bf16x3"] == before + 1
    plain = [a.cpu().numpy() for a in ck.binned_select_plain(
        qp, th, tl, tnorm, tile_n=tile_n, arm="bf16x3")]
    tol = _tol(q, db, kernel=True)
    _assert_scores(kern[0], plain[0], tol)
    _assert_scores(kern[2], plain[2], tol)
    _assert_ci_separated(plain[0], kern[1], plain[1], plain[2], tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dim,tile_n", [(24, 256), (300, 256), (128, 16384)])
def test_cuda_streaming_kernel_is_bitwise_k1(cuda_device, dim, tile_n):
    # K10 shares K1's per-score arithmetic (csrc/binned_select.cuh)
    rng = np.random.default_rng(dim + 1)
    q, db = _data(rng, 37, 3 * tile_n // 2 + 60, dim)
    th, tl, tnorm = ck.prepare_db(torch.from_numpy(db).to(cuda_device), tile_n)
    qp = ck.pad_queries(torch.from_numpy(q).to(cuda_device))
    before = ck.stream_select.launches["bf16x3"]
    k10 = ck.stream_select(qp, th, tl, tnorm, tile_n=tile_n, arm="bf16x3")
    assert ck.stream_select.launches["bf16x3"] == before + 1
    k1 = ck.binned_select(qp, th, tl, tnorm, tile_n=tile_n, arm="bf16x3")
    for a, b in zip(k10, k1):
        assert torch.equal(a, b)


def _far_tile_cuda(device, n_q):
    # tests/test_fused_overlap.py:87-89 with more queries: every query sits
    # near a row of tile 0, the tiles after it are far from all of them
    rng = np.random.default_rng(11)
    db = rng.normal(size=(6 * 128, 16)).astype(np.float32)
    db[2 * 128:] += 500.0
    q = (db[rng.integers(0, 2 * 128, size=n_q)]
         + rng.normal(size=(n_q, 16)).astype(np.float32) * 1e-2)
    th, tl, tnorm = ck.prepare_db(torch.from_numpy(db).to(device), 256)
    return q, db, ck.pad_queries(torch.from_numpy(q).to(device)), th, tl, tnorm


@pytest.mark.cuda
@pytest.mark.parametrize("n_q", [9, 4096])
def test_cuda_fused_kernel_matches_plain_and_skips(cuda_device, n_q):
    q, db, qp, th, tl, tnorm = _far_tile_cuda(cuda_device, n_q)
    n_tiles = th.shape[0] // 256
    block_q = ck.QUERY_BLOCK
    seg = ck.kernel_segment_tiles(n_q, n_tiles, cuda_device, "fused")
    before = ck.fused_select.launches["bf16x3"]
    kern = ck.fused_select(qp, th, tl, tnorm, tile_n=256, keep=15,
                           arm="bf16x3")
    assert ck.fused_select.launches["bf16x3"] == before + 1
    plain = ck.fused_select_plain(qp, th, tl, tnorm, tile_n=256, keep=15,
                                  block_q=block_q, seg_tiles=seg, arm="bf16x3")
    skip_k = ck.skipped_cells(kern[0], n_tiles, block_q)
    assert torch.equal(skip_k, ck.skipped_cells(plain[0], n_tiles, block_q))
    if seg > 1:  # a segment with a near tile and a far one skips the far
        assert bool(skip_k.any())
    kern = [a.cpu().numpy() for a in kern]
    plain = [a.cpu().numpy() for a in plain]
    tol = _tol(q, db, kernel=True)
    _assert_scores(kern[0], plain[0], tol)
    _assert_scores(kern[2], plain[2], tol)
    done = np.isinf(plain[0])
    np.testing.assert_array_equal(kern[1][done], plain[1][done])


@pytest.mark.cuda
def test_cuda_fused_kernel_disarmed_is_bitwise_k10(cuda_device):
    _, _, qp, th, tl, tnorm = _far_tile_cuda(cuda_device, 4096)
    k10 = ck.stream_select(qp, th, tl, tnorm, tile_n=256, arm="bf16x3")
    for keep in (None, 128 * ck.MAX_CARRY_DEPTH + 1):
        k11 = ck.fused_select(qp, th, tl, tnorm, tile_n=256, keep=keep,
                              arm="bf16x3")
        for a, b in zip(k10, k11):
            assert torch.equal(a, b)


# --- K5 (int8) and K6 (int4): integer exact up to one rounding, so held
# bitwise against the plain version

def _int_case(device, arm, n_q, n, dim, tile_n, seed, ties=()):
    # integer-valued rows with exact ties: duplicated rows across groups of
    # one bin (and the rows ``ties`` names, (to, from) slices), and
    # uint8-range values at unit scale (int8 via the shift)
    rng = np.random.default_rng(seed)
    db = rng.integers(0, 256, size=(n, dim)).astype(np.float32)
    db[128:160] = db[:32]
    db[256:288] = db[:32]
    for dst, src in ties:
        db[dst] = db[src]
    q = rng.integers(0, 256, size=(n_q, dim)).astype(np.float32)
    q[:4] = db[:4]
    qi, qsc = ck.quantize_queries(torch.from_numpy(q).to(device), 128.0)
    t, aux = ck.prepare_db_int(torch.from_numpy(db).to(device), tile_n, arm,
                               128.0)
    return qi, qsc, t, aux


@pytest.mark.cuda
@pytest.mark.parametrize("arm", ["int8", "int4"])
@pytest.mark.parametrize("n_q,n,dim,tile_n", [(37, 5 * 128 + 60, 24, 256),
                                              (11, 3 * 128 + 40, 300, 256),
                                              (256, 16384, 128, 16384)])
def test_cuda_int_kernels_bitwise_plain(cuda_device, arm, n_q, n, dim, tile_n):
    args = _int_case(cuda_device, arm, n_q, n, dim, tile_n, dim + n_q)
    plain = ck.binned_select_plain(*args, tile_n=tile_n, arm=arm)
    before = dict(ck.binned_select.launches)
    tiled = ck.binned_select(*args, tile_n=tile_n, arm=arm)
    assert ck.binned_select.launches[arm] == before[arm] + 1
    before = dict(ck.stream_select.launches)
    stream = ck.stream_select(*args, tile_n=tile_n, arm=arm)
    assert ck.stream_select.launches[arm] == before[arm] + 1
    for a, b, c in zip(tiled, plain, stream):
        assert torch.equal(a, b) and torch.equal(c, b)


@pytest.mark.cuda
@pytest.mark.parametrize("arm", ["int8", "int4"])
@pytest.mark.parametrize("n_q", [9, 4096])
def test_cuda_fused_int_kernel_bitwise_plain_and_skips(cuda_device, arm, n_q):
    # the far-tile case of _far_tile_cuda, quantized on the fly
    rng = np.random.default_rng(12)
    db = rng.normal(size=(6 * 128, 16)).astype(np.float32)
    db[2 * 128:] += 500.0
    q = torch.from_numpy(db[rng.integers(0, 2 * 128, size=n_q)]
                         + rng.normal(size=(n_q, 16)).astype(np.float32)
                         * 1e-2).to(cuda_device)
    qi, qsc = ck.quantize_queries(q)
    t, aux = ck.prepare_db_int(torch.from_numpy(db).to(cuda_device), 256, arm)
    n_tiles = t.shape[0] // 256
    seg = ck.kernel_segment_tiles(n_q, n_tiles, cuda_device, "fused", arm)
    before = dict(ck.fused_select.launches)
    kern = ck.fused_select(qi, qsc, t, aux, tile_n=256, keep=15, arm=arm)
    assert ck.fused_select.launches[arm] == before[arm] + 1
    plain = ck.fused_select_plain(qi, qsc, t, aux, tile_n=256, keep=15,
                                      block_q=ck.QUERY_BLOCK, seg_tiles=seg,
                                      arm=arm)
    for a, b in zip(kern, plain):
        assert torch.equal(a, b)
    if seg > 1:
        assert bool(ck.skipped_cells(kern[0], n_tiles).any())
    # disarmed, it is the streaming kernel
    k10 = ck.stream_select(qi, qsc, t, aux, tile_n=256, arm=arm)
    for keep in (None, 128 * ck.MAX_CARRY_DEPTH + 1):
        k11 = ck.fused_select(qi, qsc, t, aux, tile_n=256, keep=keep, arm=arm)
        for a, b in zip(k10, k11):
            assert torch.equal(a, b)


# --- K4 (bf16x3f), K2 (highest), K3 (default): f32 sums in another order
# than the plain versions' matmuls, so held within the tolerance; and K9,
# the db-major grid of every tiled entry, bitwise the query-major one

F32_ARMS = ["bf16x3f", "highest", "default"]


def _f32_operands(device, arm, q, db, tile_n):
    return (ck.pad_queries(torch.from_numpy(q).to(device)),
            *ck.prepare_db_arm(torch.from_numpy(db).to(device), tile_n, arm))


@pytest.mark.cuda
@pytest.mark.parametrize("arm", F32_ARMS)
@pytest.mark.parametrize("dim,tile_n", [(24, 256), (300, 256), (128, 16384)])
def test_cuda_f32_arm_kernels_match_plain(cuda_device, arm, dim, tile_n):
    rng = np.random.default_rng(dim + 3)
    q, db = _data(rng, 37, 3 * tile_n // 2 + 60, dim)
    ops = _f32_operands(cuda_device, arm, q, db, tile_n)
    plain = [a.cpu().numpy() for a in ck.binned_select_plain(
        *ops, tile_n=tile_n, arm=arm)]
    before = (ck.binned_select.launches[arm], ck.stream_select.launches[arm])
    tiled = ck.binned_select(*ops, tile_n=tile_n, arm=arm)
    stream = ck.stream_select(*ops, tile_n=tile_n, arm=arm)
    assert (ck.binned_select.launches[arm],
            ck.stream_select.launches[arm]) == (before[0] + 1, before[1] + 1)
    for a, b in zip(stream, tiled):
        assert torch.equal(a, b)
    tiled = [a.cpu().numpy() for a in tiled]
    tol = _tol(q, db, arm, kernel=True)
    _assert_scores(tiled[0], plain[0], tol)
    _assert_scores(tiled[2], plain[2], tol)
    _assert_ci_separated(plain[0], tiled[1], plain[1], plain[2], tol)


@pytest.mark.cuda
@pytest.mark.parametrize("arm", F32_ARMS)
@pytest.mark.parametrize("n_q", [9, 4096])
def test_cuda_fused_f32_arm_kernels_match_plain_and_skip(cuda_device, arm,
                                                          n_q):
    q, db, *_ = _far_tile_cuda(cuda_device, n_q)
    ops = _f32_operands(cuda_device, arm, q, db, 256)
    n_tiles = ops[1].shape[0] // 256
    seg = ck.kernel_segment_tiles(n_q, n_tiles, cuda_device, "fused", arm)
    before = ck.fused_select.launches[arm]
    kern = ck.fused_select(*ops, tile_n=256, keep=15, arm=arm)
    assert ck.fused_select.launches[arm] == before + 1
    plain = ck.fused_select_plain(*ops, tile_n=256, keep=15, arm=arm,
                                  block_q=ck.QUERY_BLOCK, seg_tiles=seg)
    skip = ck.skipped_cells(kern[0], n_tiles)
    assert torch.equal(skip, ck.skipped_cells(plain[0], n_tiles))
    if seg > 1:
        assert bool(skip.any())
    kern = [a.cpu().numpy() for a in kern]
    plain = [a.cpu().numpy() for a in plain]
    tol = _tol(q, db, arm, kernel=True)
    _assert_scores(kern[0], plain[0], tol)
    _assert_scores(kern[2], plain[2], tol)
    done = np.isinf(plain[0])
    np.testing.assert_array_equal(kern[1][done], plain[1][done])
    # disarmed, it is the streaming kernel
    k10 = ck.stream_select(*ops, tile_n=256, arm=arm)
    k11 = ck.fused_select(*ops, tile_n=256, keep=None, arm=arm)
    for a, b in zip(k10, k11):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("arm", ["bf16x3", *F32_ARMS, "int8", "int4"])
@pytest.mark.parametrize("dim,tile_n", [(24, 256), (300, 256)])
def test_cuda_db_major_is_bitwise_query_major(cuda_device, arm, dim, tile_n):
    n_q, n = 37, 5 * 128 + 60
    if arm in ("int8", "int4"):
        ops = _int_case(cuda_device, arm, n_q, n, dim, tile_n, dim)
    else:
        q, db = _data(np.random.default_rng(dim), n_q, n, dim)
        ops = _f32_operands(cuda_device, arm, q, db, tile_n)
    qm = ck.binned_select(*ops, tile_n=tile_n, arm=arm)
    before = (ck.binned_select.launches[arm],
              ck.binned_select.db_major_launches[arm])
    dm = ck.binned_select(*ops, tile_n=tile_n, arm=arm, grid_order="db_major")
    assert (ck.binned_select.launches[arm],
            ck.binned_select.db_major_launches[arm]) == (before[0] + 1,
                                                         before[1] + 1)
    for a, b in zip(dm, qm):
        assert torch.equal(a, b)


def header_bound_ratio(device, arm, kernel, n_q=64, n=512, dim=896):
    """The largest |s_kernel - s_ref| / bound over every db row, for the
    ``kernel`` entry of f32-family arm ``arm`` on all-positive data at
    Dp = 896 (7 chunks, every product positive: the chains' worst shape).
    s_ref is the exact f64 score of the kernel's own operands (the bf16
    parts' three products, or the f32 values' one); the bound is
    the headers' worst case for the arm's qt
    (ck.accumulation_coefficient: csrc/binned_mma.cuh for bf16x3 and
    bf16x3f, csrc/binned_select.cuh for highest), doubled in s, plus the
    rounding of s.  With ``tile_n = 128`` every tile is one group, so
    every row's score is survivor 0 of its bin."""
    rng = np.random.default_rng(12)
    q = torch.from_numpy(rng.uniform(1.0, 2.0, size=(n_q, dim))
                         .astype(np.float32)).to(device)
    db = torch.from_numpy(rng.uniform(1.0, 2.0, size=(n, dim))
                          .astype(np.float32)).to(device)
    qp = ck.pad_queries(q)
    parts = ck.prepare_db_arm(db, ck.BIN_W, arm)
    nd = qp.shape[1] // ck.DIM_CHUNK
    b_qt = ck.accumulation_coefficient(arm, nd)
    if arm == "highest":
        pairs = [(qp, parts[0])]
    else:
        qh, ql = ck.split_bf16(qp)
        pairs = [(qh, parts[0]), (qh, parts[1]), (ql, parts[0])]
    qt = sum(a.double() @ b.double().T for a, b in pairs)
    p = sum(a.double().abs() @ b.double().abs().T for a, b in pairs)
    s_ref = parts[-1][0].double()[None, :] - 2.0 * qt
    bound = 2 * b_qt * U32 * p * (1 + U32) + U32 * s_ref.abs()
    fn = {"tiled": ck.binned_select, "streaming": ck.stream_select,
          "fused": ck.fused_select}[kernel]
    kw = {"keep": 15} if kernel == "fused" else {}
    cd, ci, _ = fn(qp, *parts, tile_n=ck.BIN_W, arm=arm, **kw)
    real = ci < n
    if kernel != "fused":  # the fused entry may skip a tile
        assert bool(real.view(n_q, -1, ck.SURVIVORS, ck.BIN_W)[:, :, 0].all())
    rows = torch.where(real, ci, 0).long()
    err = (cd.double() - torch.gather(s_ref, 1, rows)).abs()
    return float(torch.where(real, err / torch.gather(bound, 1, rows),
                             0.0).max())


@pytest.mark.cuda
@pytest.mark.parametrize("arm", ["bf16x3", "bf16x3f", "highest"])
@pytest.mark.parametrize("kernel", ["tiled", "streaming", "fused"])
def test_cuda_f32_arm_error_inside_the_header_bound_at_dp896(cuda_device,
                                                             arm, kernel):
    assert header_bound_ratio(cuda_device, arm, kernel) <= 1.0


def _split_worst_case(device, dim, n_q=32, n=512):
    """Fault 18's construction: queries and rows whose every value is one
    of the f32 values in [1, 1 + 2^-8) whose bf16 split errs most (the
    high part 1, the low part's rounding near half its ulp, one sign), so
    the split's error in s nears half of 2^-14 (||q||^2 + M)."""
    one = np.float32(1.0).view(np.int32)
    x = (one + np.arange(2 ** 15, dtype=np.int32)).view(np.float32)
    xh, xl = (a.double().numpy() for a in ck.split_bf16(torch.from_numpy(x)))
    x64 = x.astype(np.float64)
    rel = (x64 * x64 - (xh * xh + 2 * xh * xl)) / (x64 * x64)
    vals = x[np.argsort(-rel)[:8]]
    rng = np.random.default_rng(dim)
    q = vals[rng.integers(0, 8, size=(n_q, dim))]
    db = vals[rng.integers(0, 8, size=(n, dim))]
    return q, db


FAULT18_ENTRIES = ["tiled", "db_major", "streaming", "fused", "lane_tiled",
                   "lane_streaming"]


def _fault18_case(device, arm, entry, dim):
    # every ``arm`` entry's score of every emitted candidate against the f64
    # score of the f32 values, within the certificate's tolerance
    # (ck.kernel_tolerance: the split's proved error + the tensor-core
    # summation's + headroom)
    q, db = _split_worst_case(device, dim)
    qp = ck.pad_queries(torch.from_numpy(q).to(device))
    th, tl, tnorm = ck.prepare_db(torch.from_numpy(db).to(device), ck.BIN_W)
    fn, kw = {"tiled": (ck.binned_select, {}),
              "db_major": (ck.binned_select, {"grid_order": "db_major"}),
              "streaming": (ck.stream_select, {}),
              "fused": (ck.fused_select, {"keep": None}),
              "lane_tiled": (ck.binned_select, {"binning": "lane"}),
              "lane_streaming": (ck.stream_select, {"binning": "lane"})}[entry]
    cd, ci, _ = (a.cpu().numpy() for a in fn(qp, th, tl, tnorm,
                                             tile_n=ck.BIN_W, arm=arm, **kw))
    q64, db64 = q.astype(np.float64), db.astype(np.float64)
    s64 = (db64 ** 2).sum(-1)[None, :] - 2.0 * q64 @ db64.T
    real = ci < db.shape[0]
    assert real.sum() >= q.shape[0] * db.shape[0] // ck.BIN_W
    got = np.take_along_axis(s64, np.where(real, ci, 0), 1)
    err = np.where(real, np.abs(cd.astype(np.float64) - got), 0.0).max(-1)
    tol = ck.kernel_tolerance(q, db, precision=arm)
    assert (err <= tol).all(), float((err / tol).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [128, 896])
@pytest.mark.parametrize("entry", FAULT18_ENTRIES)
def test_cuda_bf16x3_fault18_case_inside_the_new_tolerance(cuda_device,
                                                           entry, dim):
    _fault18_case(cuda_device, "bf16x3", entry, dim)


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [128, 896])
@pytest.mark.parametrize("entry", FAULT18_ENTRIES)
def test_cuda_bf16x3f_fault18_case_inside_its_tolerance(cuda_device, entry,
                                                        dim):
    _fault18_case(cuda_device, "bf16x3f", entry, dim)


def _tensor_core_entries_alike(device, arm, dim, tile_n):
    """The tensor-core walk of ``arm`` serves every entry: tiled in both
    grids, streaming and fused (disarmed) give the same bits, every lane
    score is the grouped score of its row, and the kernel stays within the
    proved kernel-vs-plain tolerance."""
    rng = np.random.default_rng(dim + 17)
    q, db = _data(rng, 45, 3 * tile_n // 2 + 60, dim)
    ops = _f32_operands(device, arm, q, db, tile_n)
    ka = {"tile_n": tile_n, "arm": arm}
    tiled = ck.binned_select(*ops, **ka)
    for other in (ck.binned_select(*ops, **ka, grid_order="db_major"),
                  ck.stream_select(*ops, **ka),
                  ck.fused_select(*ops, **ka, keep=None)):
        for a, b in zip(other, tiled):
            assert torch.equal(a, b)
    n_rows = ops[-1].shape[1]
    for fn in (ck.binned_select, ck.stream_select):
        lane = fn(*ops, **ka, binning="lane", survivors=8)
        g = torch.full((tiled[0].shape[0], n_rows + 1), torch.nan,
                       device=device)
        g.scatter_(1, tiled[1].long().clamp(max=n_rows), tiled[0])
        li = lane[1].long().clamp(max=n_rows)
        got = torch.gather(g, 1, li)
        both = (li < n_rows) & ~torch.isnan(got)
        assert bool(both.any())
        assert torch.equal(lane[0][both], got[both])
    plain = [a.cpu().numpy() for a in ck.binned_select_plain(*ops, **ka)]
    tiled = [a.cpu().numpy() for a in tiled]
    tol = _tol(q, db, arm, kernel=True)
    _assert_scores(tiled[0], plain[0], tol)
    _assert_scores(tiled[2], plain[2], tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dim,tile_n", [(24, 256), (300, 256), (128, 16384)])
def test_cuda_bf16x3f_entries_are_bitwise_alike(cuda_device, dim, tile_n):
    # K4 runs one tensor-core walk for every entry
    _tensor_core_entries_alike(cuda_device, "bf16x3f", dim, tile_n)


@pytest.mark.cuda
@pytest.mark.parametrize("dim,tile_n", [(24, 256), (300, 256), (128, 16384),
                                        (896, 256)])
def test_cuda_highest_entries_are_bitwise_alike(cuda_device, dim, tile_n):
    # K2 runs one FP64 tensor-core walk for every entry, one k-order: tiled
    # in both grids, streaming, fused and the lane builds give the same
    # bits, within (2 nd + 4) u of the plain version
    _tensor_core_entries_alike(cuda_device, "highest", dim, tile_n)


@pytest.mark.cuda
@pytest.mark.parametrize("dim,tile_n", [(24, 256), (300, 256), (128, 16384),
                                        (896, 256)])
def test_cuda_default_entries_are_bitwise_alike(cuda_device, dim, tile_n):
    # K3 runs the bf16 tensor-core walk for every entry, one k-order: tiled
    # in both grids, streaming, fused and the lane builds give the same
    # bits, within the proved kernel-vs-plain tolerance
    _tensor_core_entries_alike(cuda_device, "default", dim, tile_n)


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [128, 896])
@pytest.mark.parametrize("kernel", ["tiled", "streaming", "fused"])
def test_cuda_default_kernel_within_the_proved_tolerance(cuda_device, dim,
                                                         kernel):
    # all-positive values, every partial sum growing: the chains' worst
    # shape; tile_n = 128 puts every row's score in survivor 0 of its bin
    rng = np.random.default_rng(dim + 5)
    q = rng.uniform(1.0, 2.0, size=(32, dim)).astype(np.float32)
    db = rng.uniform(1.0, 2.0, size=(512, dim)).astype(np.float32)
    ops = _f32_operands(cuda_device, "default", q, db, ck.BIN_W)
    fn = {"tiled": ck.binned_select, "streaming": ck.stream_select,
          "fused": ck.fused_select}[kernel]
    kw = {"keep": None} if kernel == "fused" else {}
    kern = [a.cpu().numpy() for a in fn(*ops, tile_n=ck.BIN_W, arm="default",
                                        **kw)]
    plain = [a.cpu().numpy() for a in ck.binned_select_plain(
        *ops, tile_n=ck.BIN_W, arm="default")]
    np.testing.assert_array_equal(kern[1], plain[1])
    tol = _tol(q, db, "default", kernel=True)
    _assert_scores(kern[0], plain[0], tol)


@pytest.mark.cuda
@pytest.mark.parametrize("arm", ["int8", "int4"])
@pytest.mark.parametrize("dim", [128, 256, 896])
def test_cuda_int_entries_bitwise_plain_at_every_build(cuda_device, arm, dim):
    # the s8 tensor-core walk at Dp = 128 (the query block staged once) and
    # above (its chunk staged per step): 45 queries (a ragged last block),
    # 767 rows (the last tile one row short of full, so the tile-edge rows
    # sit beside a PAD_VAL row), exact ties; every entry bitwise its plain
    # version, the lane builds too
    tile_n = 256
    args = _int_case(cuda_device, arm, 45, 3 * tile_n - 1, dim, tile_n,
                     dim + 45)
    ka = {"tile_n": tile_n, "arm": arm}
    plain = ck.binned_select_plain(*args, **ka)
    for out in (ck.binned_select(*args, **ka),
                ck.binned_select(*args, **ka, grid_order="db_major"),
                ck.stream_select(*args, **ka),
                ck.fused_select(*args, **ka, keep=None)):
        for a, b in zip(out, plain):
            assert torch.equal(a, b)
    lane = {"binning": "lane", "survivors": 3, "bin_w": 256}
    plain = ck.binned_select_plain(*args, **ka, **lane)
    for out in (ck.binned_select(*args, **ka, **lane),
                ck.binned_select(*args, **ka, **lane, grid_order="db_major"),
                ck.stream_select(*args, **ka, **lane)):
        for a, b in zip(out, plain):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("arm", ["default", "int8", "int4"])
def test_cuda_fused_multi_chunk_entries_skip_the_plain_cells(cuda_device,
                                                            arm):
    # the far-tile case at 200 dims (Dp = 256: the multi-chunk builds) with
    # 4,096 queries: the fused entry skips the cells the plain version skips
    # at the same segments, the rest bitwise (int) or within the tolerance
    rng = np.random.default_rng(13)
    db = rng.normal(size=(6 * 128, 200)).astype(np.float32)
    db[2 * 128:] += 500.0
    q = (db[rng.integers(0, 2 * 128, size=4096)]
         + rng.normal(size=(4096, 200)).astype(np.float32) * 1e-2)
    if arm == "default":
        ops = _f32_operands(cuda_device, arm, q, db, 256)
    else:
        ops = (*ck.quantize_queries(torch.from_numpy(q).to(cuda_device)),
               *ck.prepare_db_int(torch.from_numpy(db).to(cuda_device), 256,
                                  arm))
    n_tiles = ops[-1].shape[-1] // 256
    seg = ck.kernel_segment_tiles(4096, n_tiles, cuda_device, "fused", arm)
    kern = ck.fused_select(*ops, tile_n=256, keep=15, arm=arm)
    plain = ck.fused_select_plain(*ops, tile_n=256, keep=15, arm=arm,
                                  block_q=ck.QUERY_BLOCK, seg_tiles=seg)
    skip = ck.skipped_cells(kern[0], n_tiles)
    assert torch.equal(skip, ck.skipped_cells(plain[0], n_tiles))
    assert bool(skip.any())
    if arm == "default":
        tol = _tol(q, db, arm, kernel=True)
        _assert_scores(kern[0].cpu().numpy(), plain[0].cpu().numpy(), tol)
    else:
        for a, b in zip(kern, plain):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_dmma_step_rounding_inside_the_header_model(cuda_device):
    # one FP64 tensor-core k-step on constructed operands (half-ulp ties,
    # products far below the accumulator, cancellation, random): every
    # output within DMMA_K 2^-53 (|c| + sum |p|) of the exact sum, the
    # model highest's tolerance is proved from
    before = ck.dmma_probe.launches
    report = ck.dmma_rounding_probe(cuda_device)
    assert ck.dmma_probe.launches == before + len(report)
    for name, r in report.items():
        assert r["max_error_over_bound"] <= 1.0, (name, r)


@pytest.mark.cuda
def test_cuda_mma_step_rounding_inside_the_header_model(cuda_device):
    # one tensor-core k-step on constructed operands (products an
    # accumulator of 1 truncates away, random ones): every output within
    # MMA_KAPPA u (|c| + sum |p|) of the exact sum, the model the bf16x3
    # tolerance is proved from
    before = ck.mma_probe.launches
    report = ck.mma_rounding_probe(cuda_device)
    assert ck.mma_probe.launches == before + len(report)
    for name, r in report.items():
        assert r["max_error_over_bound"] <= 1.0, (name, r)


# --- K8 (lane binning) of every arm and K7 (pq): the int arms and pq are
# held bitwise against their plain versions, the f32 family within the
# tolerance with ci equal on separated slots; every score a lane entry
# emits is bitwise the grouped entry's score of the same row

def _assert_lane_ci_separated(cd, ci_p, ci_r, bounds, geo, tol):
    """ci equal wherever the survivor's value is apart from its
    neighbours in the bin's order (the previous survivor, the next one or
    the bound) by more than ``tol``."""
    n_bins, surv, out_w, bound_w = geo
    n_q = cd.shape[0]
    n_tiles = cd.shape[1] // out_w
    vals = cd.reshape(n_q, n_tiles, out_w)[:, :, : n_bins * surv]
    vals = vals.reshape(n_q, n_tiles, surv, n_bins)
    bnd = bounds.reshape(n_q, n_tiles, bound_w)[:, :, None, :n_bins]
    seq = np.concatenate([vals, bnd], axis=2)
    with np.errstate(invalid="ignore"):
        gap = np.abs(np.diff(seq, axis=2))
    t = tol[:, None, None, None]
    sep = gap[:, :, :surv] > t
    sep[:, :, 1:] &= gap[:, :, : surv - 1] > t
    sep &= np.isfinite(vals)

    def view(ci):
        c = ci.reshape(n_q, n_tiles, out_w)[:, :, : n_bins * surv]
        return c.reshape(sep.shape)

    assert sep.sum() > 0
    np.testing.assert_array_equal(view(ci_p)[sep], view(ci_r)[sep])


def _pq_case(device, n_q, n, m, ncodes, tile_n, seed, ties=()):
    # a random LUT and codes with exact ties: rows 3 and 90 equal to row 10
    # (one 128-row bin), rows 128-159 equal to rows 0-31 (another bin), and
    # the rows ``ties`` names ((to, from) slices)
    rng = np.random.default_rng(seed)
    lut = (rng.normal(size=(n_q, m * ncodes)) * 10).astype(np.float32)
    codes = rng.integers(0, ncodes, size=(n, m)).astype(np.uint8)
    codes[3] = codes[90] = codes[10]
    codes[128:160] = codes[:32]
    for dst, src in ties:
        codes[dst] = codes[src]
    parts = ck.prepare_db_pq(torch.from_numpy(codes).to(device), tile_n)
    return (torch.from_numpy(lut).to(device), *parts)


def _lane_operands(device, arm, tile_n, seed, dim=24):
    n_q, n = 37, 5 * 128 + 60
    if arm == "pq":
        return _pq_case(device, n_q, n, 7, 200, tile_n, seed), None
    if arm in ("int8", "int4"):
        return _int_case(device, arm, n_q, n, dim, tile_n, seed), None
    q, db = _data(np.random.default_rng(seed), n_q, n, dim)
    db[3] = db[90] = db[10]
    return (_f32_operands(device, arm, q, db, tile_n),
            _tol(q, db, arm, kernel=True))


LANE_ARMS = ["bf16x3", *F32_ARMS, "int8", "int4", "pq"]
#: every survivor count, every bin width of a 512-row tile
LANE_GEOMETRIES = [(1, 128), (2, 128), (2, 256), (3, 512), (4, 128),
                   (5, 256), (6, 512), (7, 128), (8, 256), (8, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("arm", LANE_ARMS)
@pytest.mark.parametrize("survivors,bin_w", LANE_GEOMETRIES)
def test_cuda_lane_kernels_match_plain(cuda_device, arm, survivors, bin_w):
    tile_n = 512
    args, tol = _lane_operands(cuda_device, arm, tile_n, survivors + bin_w)
    kw = {"tile_n": tile_n, "arm": arm, "binning": "lane", "bin_w": bin_w,
          "survivors": survivors}
    plain = [a.cpu().numpy() for a in ck.binned_select_plain(*args, **kw)]
    geo = ck._geometry(tile_n, bin_w, survivors, "lane")
    before = (dict(ck.binned_select.lane_launches),
              dict(ck.stream_select.lane_launches))
    outs = {"tiled": ck.binned_select(*args, **kw),
            "db_major": ck.binned_select(*args, **kw, grid_order="db_major"),
            "streaming": ck.stream_select(*args, **kw)}
    assert ck.binned_select.lane_launches[arm] == before[0][arm] + 2
    assert ck.stream_select.lane_launches[arm] == before[1][arm] + 1
    for out in outs.values():
        assert torch.equal(out[0], outs["tiled"][0])  # one arithmetic
        got = [a.cpu().numpy() for a in out]
        assert got[0].shape == plain[0].shape
        assert got[2].shape == plain[2].shape
        if tol is None:
            for a, b in zip(got, plain):
                np.testing.assert_array_equal(a, b)
        else:
            _assert_scores(got[0], plain[0], tol)
            _assert_scores(got[2], plain[2], tol)
            _assert_lane_ci_separated(plain[0], got[1], plain[1], plain[2],
                                      geo, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("arm", ["bf16x3", *F32_ARMS, "int8", "int4"])
def test_cuda_lane_kernels_match_plain_at_three_dim_chunks(cuda_device, arm):
    # Dp = 384: the f32 arms' multi-chunk builds, the int arms' chunk loop
    tile_n = 256
    args, tol = _lane_operands(cuda_device, arm, tile_n, 3, dim=300)
    kw = {"tile_n": tile_n, "arm": arm, "binning": "lane", "survivors": 3}
    plain = [a.cpu().numpy() for a in ck.binned_select_plain(*args, **kw)]
    geo = ck._geometry(tile_n, 128, 3, "lane")
    for out in (ck.binned_select(*args, **kw),
                ck.binned_select(*args, **kw, grid_order="db_major"),
                ck.stream_select(*args, **kw)):
        got = [a.cpu().numpy() for a in out]
        if tol is None:
            for a, b in zip(got, plain):
                np.testing.assert_array_equal(a, b)
        else:
            _assert_scores(got[0], plain[0], tol)
            _assert_scores(got[2], plain[2], tol)
            _assert_lane_ci_separated(plain[0], got[1], plain[1], plain[2],
                                      geo, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("arm", LANE_ARMS)
@pytest.mark.parametrize("survivors,bin_w", LANE_GEOMETRIES)
def test_cuda_lane_scores_are_the_grouped_scores_at_every_geometry(
        cuda_device, arm, survivors, bin_w):
    # every score a lane entry emits is bitwise the grouped entry's score of
    # the same row, for the tiled (both grids) and streaming entries
    tile_n = 512
    args, _ = _lane_operands(cuda_device, arm, tile_n, survivors + bin_w)
    n_rows = args[-1].shape[1]
    kw = {"tile_n": tile_n, "arm": arm}
    for fn, extra in ((ck.binned_select, {}),
                      (ck.binned_select, {"grid_order": "db_major"}),
                      (ck.stream_select, {})):
        lane = fn(*args, **kw, **extra, binning="lane", bin_w=bin_w,
                  survivors=survivors)
        grouped = fn(*args, **kw, **extra)
        g = torch.full((grouped[0].shape[0], n_rows + 1), torch.nan,
                       device=cuda_device)
        g.scatter_(1, grouped[1].long().clamp(max=n_rows), grouped[0])
        li = lane[1].long().clamp(max=n_rows)
        got = torch.gather(g, 1, li)
        both = (li < n_rows) & ~torch.isnan(got)
        assert bool(both.any())
        assert torch.equal(lane[0][both].view(torch.int32),
                           got[both].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("arm", LANE_ARMS)
def test_cuda_lane_scores_are_the_grouped_scores(cuda_device, arm):
    tile_n = 256
    args, _ = _lane_operands(cuda_device, arm, tile_n, 5)
    for fn in (ck.binned_select, ck.stream_select):
        lane = fn(*args, tile_n=tile_n, arm=arm, binning="lane",
                  survivors=8)
        grouped = fn(*args, tile_n=tile_n, arm=arm)
        n_rows = args[-1].shape[1]
        common = 0
        for q in range(lane[0].shape[0]):
            g = torch.full((n_rows + 1,), torch.nan, device=cuda_device)
            gi = grouped[1][q].long().clamp(max=n_rows)
            g[gi] = grouped[0][q]
            li = lane[1][q].long().clamp(max=n_rows)
            both = (li < n_rows) & ~torch.isnan(g[li])
            assert torch.equal(lane[0][q][both], g[li][both])
            common += int(both.sum())
        assert common > 0


@pytest.mark.cuda
@pytest.mark.parametrize("n_q,n,m,ncodes,tile_n", [
    (37, 5 * 128 + 60, 7, 200, 256), (11, 3 * 128 + 40, 32, 256, 256),
    (256, 16384, 32, 256, 16384),
    (9, 7 * 128 + 5, 5, 130, 384)])  # C % 4 != 0: the LUT copied by floats
def test_cuda_pq_kernels_bitwise_plain(cuda_device, n_q, n, m, ncodes,
                                       tile_n):
    args = _pq_case(cuda_device, n_q, n, m, ncodes, tile_n, n_q + m)
    plain = ck.binned_select_plain(*args, tile_n=tile_n, arm="pq")
    before = (dict(ck.binned_select.launches),
              dict(ck.stream_select.launches))
    outs = (ck.binned_select(*args, tile_n=tile_n, arm="pq"),
            ck.binned_select(*args, tile_n=tile_n, arm="pq",
                             grid_order="db_major"),
            ck.stream_select(*args, tile_n=tile_n, arm="pq"))
    assert ck.binned_select.launches["pq"] == before[0]["pq"] + 2
    assert ck.stream_select.launches["pq"] == before[1]["pq"] + 1
    for out in outs:
        for a, b in zip(out, plain):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="precision='pq'"):
        ck.fused_select(*args, tile_n=tile_n, keep=15, arm="pq")


@pytest.mark.cuda
@pytest.mark.parametrize("n_q,n,m,ncodes,tile_n", [
    (45, 1280 + 60, 196, 200, 1280),    # a full 1,024-row block + 2 groups
    (70, 2 * 1152 + 5, 7, 256, 1152),   # a block + 1 group, C % 32 == 0
    (33, 300, 32, 130, 128)])           # a tile shorter than a block
def test_cuda_pq_kernels_bitwise_plain_at_the_row_block_edges(
        cuda_device, n_q, n, m, ncodes, tile_n):
    # K7's walk stages 1,024-row blocks and 32-query LUT slices: query
    # counts off a multiple of 32, tiles shorter than a block or ending in
    # a partial one, m = 196 and C = 200, in grouped and lane binning, every
    # entry bitwise its plain version
    args = _pq_case(cuda_device, n_q, n, m, ncodes, tile_n, n_q + m)
    for emit in ({}, {"binning": "lane"},
                 {"binning": "lane", "survivors": 8}):
        kw = dict(emit, tile_n=tile_n, arm="pq")
        plain = ck.binned_select_plain(*args, **kw)
        for out in (ck.binned_select(*args, **kw),
                    ck.binned_select(*args, **kw, grid_order="db_major"),
                    ck.stream_select(*args, **kw)):
            for a, b in zip(out, plain):
                assert torch.equal(a, b)


def pq_bound_ratio(device, kernel, n_q=16, n=256, m=196, dsub=4,
                   ncodes=64):
    """The largest |s_kernel - s_ref| / bound over every real row for K7's
    ``kernel`` entry ("plain": its plain version) at ``m`` subspaces (196:
    784 dims), on rows that are their own reconstruction (residuals 0) and
    all-nonnegative LUT entries (q in [1, 2], codebook values in [0, 1]:
    the chain's worst shape, every partial sum grows).  s_ref is the exact
    f64 score ||t||^2 - 2 q.t; the bound is csrc/binned_pq.cuh's worst
    case, ops.pq.k7_rounding (||q||^2 + 2 M) (norm_err_max is 0 here).
    With ``tile_n = 128`` every row's score is survivor 0 of its bin."""
    from knn_tpu_torch.ops import pq as ppq

    rng = np.random.default_rng(m)
    books = rng.uniform(0.0, 1.0, size=(m, ncodes, dsub)).astype(np.float32)
    codes = rng.integers(0, ncodes, size=(n, m)).astype(np.uint8)
    q = rng.uniform(1.0, 2.0, size=(n_q, m * dsub)).astype(np.float32)
    t64 = ppq.reconstruct(books, codes, m * dsub, dsub).astype(np.float64)
    q64 = q.astype(np.float64)
    tn = (t64 ** 2).sum(-1)
    s_ref = torch.from_numpy(tn[None, :] - 2.0 * (q64 @ t64.T)).to(device)
    bound = torch.from_numpy(ppq.k7_rounding(m, dsub) * (
        (q64 ** 2).sum(-1) + 2.0 * tn.max())).to(device)
    lut = ck.pq_luts(torch.from_numpy(q).to(device),
                     torch.from_numpy(books).to(device))
    assert bool((lut >= 0).all())
    parts = ck.prepare_db_pq(torch.from_numpy(codes).to(device), ck.BIN_W)
    fn = {"plain": ck.binned_select_plain, "tiled": ck.binned_select,
          "streaming": ck.stream_select}[kernel]
    cd, ci, _ = fn(lut, *parts, tile_n=ck.BIN_W, arm="pq")
    real = ci < n
    assert bool(real.view(n_q, -1, ck.SURVIVORS, ck.BIN_W)[:, :, 0].all())
    rows = torch.where(real, ci, 0).long()
    err = (cd.double() - torch.gather(s_ref, 1, rows)).abs()
    return float(torch.where(real, err / bound[:, None], 0.0).max())


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["tiled", "streaming"])
def test_cuda_k7_error_inside_the_header_bound_at_196_subspaces(cuda_device,
                                                                kernel):
    assert pq_bound_ratio(cuda_device, kernel) <= 1.0


@pytest.mark.cuda
def test_cuda_pq_and_lane_search_certified_match_the_exact_search(
        cuda_device):
    from knn_tpu_torch import ShardedKNN

    rng = np.random.default_rng(21)
    db = (rng.normal(size=(3000, 16)) * 5).astype(np.float32)
    q = (rng.normal(size=(40, 16)) * 5).astype(np.float32)
    knn = ShardedKNN(db, k=10, device=cuda_device)
    _, ref = knn.search(q)
    ref = ref.cpu().numpy()
    for knobs in ({"precision": "pq"}, {"precision": "pq", "kernel": "streaming"},
                  {"precision": "pq", "binning": "lane"},
                  {"binning": "lane", "kernel": "streaming"},
                  {"precision": "int8", "binning": "lane", "survivors": 4}):
        _, i, _ = knn.search_certified(q, tile_n=1024, pq_ncodes=64, **knobs)
        np.testing.assert_array_equal(i, ref)


# --- grouped binning at 1-8 survivors (the deep grouped build) -------------

#: survivor counts the deep builds are checked at (2 is the default build):
#: each build of csrc/binned_select.cuh's table and its edges
DEEP_SURVIVORS = [1, 3, 4, 5, 8]


def _wide_ties(tile_n, n):
    """(to, from) row slices tying rows 0-31 of each tile's first group to
    the same lanes of its last group and, past 256 groups (the packed
    builds' 8-bit group indices), of groups 255 and 256."""
    ties = []
    for t0 in range(0, n - tile_n + 1, tile_n):
        src = slice(t0, t0 + 32)
        groups = [tile_n // 128 - 1] + ([255, 256] if tile_n > 256 * 128
                                        else [])
        ties += [(slice(t0 + g * 128, t0 + g * 128 + 32), src)
                 for g in groups]
    return ties


def _deep_operands(device, arm, tile_n, seed, dim):
    n_q, n = 37, 2 * tile_n + 60
    ties = _wide_ties(tile_n, n)
    if arm == "pq":
        return _pq_case(device, n_q, n, 7, 200, tile_n, seed, ties), None
    if arm in ("int8", "int4"):
        return _int_case(device, arm, n_q, n, dim, tile_n, seed, ties), None
    q, db = _data(np.random.default_rng(seed), n_q, n, dim)
    db[3] = db[90] = db[128 + 3] = db[10]
    for dst, src in ties:
        db[dst] = db[src]
    return (_f32_operands(device, arm, q, db, tile_n),
            _tol(q, db, arm, kernel=True))


@pytest.mark.cuda
@pytest.mark.parametrize("arm", LANE_ARMS)
@pytest.mark.parametrize("survivors", DEEP_SURVIVORS)
@pytest.mark.parametrize("dim,tile_n", [(24, 512), (24, 1024), (300, 512),
                                        (24, 32768), (24, 65536)])
def test_cuda_deep_grouped_entries_match_plain(cuda_device, arm, survivors,
                                               dim, tile_n):
    # every grouped entry (tiled, db-major, streaming, fused but pq's) at
    # 1, 3, 4, 5 and 8 survivors against its plain version: int and pq
    # bitwise, the f32 family within the kernel's tolerance; one arithmetic
    # across the entries; 256 and 512 groups a tile (the widest the packed
    # builds take, and the four-pass build's geometry) with exact ties
    # between the first and last groups; the deep launches counted apart
    # from the default build's
    args, tol = _deep_operands(cuda_device, arm, tile_n, survivors + dim, dim)
    kw = {"tile_n": tile_n, "arm": arm, "survivors": survivors}
    plain = [a.cpu().numpy() for a in ck.binned_select_plain(*args, **kw)]
    before = {fn: (dict(fn.deep_launches), dict(fn.launches))
              for fn in (ck.binned_select, ck.stream_select, ck.fused_select)}
    outs = {"tiled": ck.binned_select(*args, **kw),
            "db_major": ck.binned_select(*args, **kw, grid_order="db_major"),
            "streaming": ck.stream_select(*args, **kw)}
    if arm != "pq":
        outs["fused"] = ck.fused_select(*args, **kw, keep=None)
    for fn, n in ((ck.binned_select, 2), (ck.stream_select, 1),
                  (ck.fused_select, int(arm != "pq"))):
        assert fn.deep_launches[arm] == before[fn][0][arm] + n
        assert fn.launches == before[fn][1]
    for out in outs.values():
        assert torch.equal(out[0], outs["tiled"][0])
        assert torch.equal(out[1], outs["tiled"][1])
        got = [a.cpu().numpy() for a in out]
        assert got[0].shape == plain[0].shape == (37, 3 * survivors * 128)
        if tol is None:
            for a, b in zip(got, plain):
                np.testing.assert_array_equal(a, b)
        else:
            _assert_scores(got[0], plain[0], tol)
            _assert_scores(got[2], plain[2], tol)
            _assert_ci_separated(plain[0], got[1], plain[1], plain[2], tol)


@pytest.mark.cuda
@pytest.mark.parametrize("arm", ["bf16x3", *F32_ARMS, "int8", "int4"])
@pytest.mark.parametrize("survivors", [1, 3, 5, 8])
def test_cuda_deep_fused_entries_skip_the_plain_cells(cuda_device, arm,
                                                      survivors):
    # K11's carry is the same at every survivor count (depth ceil(keep /
    # 128)): the deep fused entries skip the cells their plain version
    # skips on the far-tile case
    q, db, *_ = _far_tile_cuda(cuda_device, 4096)
    if arm in ("int8", "int4"):
        args = (*ck.quantize_queries(torch.from_numpy(q).to(cuda_device)),
                *ck.prepare_db_int(torch.from_numpy(db).to(cuda_device), 256,
                                   arm))
        tol = None
    else:
        args = _f32_operands(cuda_device, arm, q, db, 256)
        tol = _tol(q, db, arm, kernel=True)
    kw = {"tile_n": 256, "arm": arm, "survivors": survivors}
    n_tiles = args[-1].shape[1] // 256
    seg = ck.kernel_segment_tiles(q.shape[0], n_tiles, cuda_device, "fused",
                                  arm, (0, survivors))
    kern = ck.fused_select(*args, **kw, keep=15)
    plain = ck.fused_select_plain(*args, **kw, keep=15, seg_tiles=seg)
    skip = ck.skipped_cells(kern[0], n_tiles)
    assert torch.equal(skip, ck.skipped_cells(plain[0], n_tiles))
    assert int(skip.sum()) > 0
    got, want = ([a.cpu().numpy() for a in out] for out in (kern, plain))
    if tol is None:
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    else:
        _assert_scores(got[0], want[0], tol)
        _assert_scores(got[2], want[2], tol)


@pytest.mark.cuda
@pytest.mark.parametrize("arm", LANE_ARMS)
def test_cuda_deep_calls_move_only_the_deep_counters(cuda_device, arm):
    # a deep call counts in .deep_launches alone (and a db-major one in
    # .db_major_launches): the two-survivor (.launches) and lane
    # (.lane_launches) counters, which chip_smoke.py reads to show which
    # build a path ran, stay where they were
    args, _ = _deep_operands(cuda_device, arm, 512, 7, 24)
    wrappers = (ck.binned_select, ck.stream_select, ck.fused_select)

    def counters():
        return {fn: {name: dict(getattr(fn, name)) for name in
                     ("launches", "lane_launches", "deep_launches",
                      "db_major_launches") if hasattr(fn, name)}
                for fn in wrappers}
    before = counters()
    for surv in DEEP_SURVIVORS:
        kw = {"tile_n": 512, "arm": arm, "survivors": surv}
        ck.binned_select(*args, **kw)
        ck.binned_select(*args, **kw, grid_order="db_major")
        ck.stream_select(*args, **kw)
        if arm != "pq":
            ck.fused_select(*args, **kw, keep=130)
    after = counters()
    n = len(DEEP_SURVIVORS)
    added = {ck.binned_select: {"deep_launches": 2 * n,
                                "db_major_launches": n},
             ck.stream_select: {"deep_launches": n},
             ck.fused_select: {"deep_launches": n * (arm != "pq")}}
    for fn in wrappers:
        for name, counts in after[fn].items():
            want = dict(before[fn][name])
            want[arm] += added[fn].get(name, 0)
            assert counts == want, (fn.__name__, name)


#: local memory a build may take by design: the fused builds keep K11's
#: carry in thread-local memory (16 cells x MAX_CARRY_DEPTH floats, 512 B);
#: at 255 registers the two-survivor highest builds (their f64
#: accumulators) and pq's streaming one (128 accumulators a thread) spill a
#: few words -- 16-56 B and 8 B (H100 builds, sm_90a); the deep builds
#: spill nothing
CARRY_BYTES = 4 * 4 * ck.MAX_CARRY_DEPTH * 4
SPILL_BYTES = {"highest": 64, "pq": 8}


def _deep_plan(arm, survivors, tile_n):
    """(slots, rows a pass, packed) of the deep build csrc/binned_select.cuh's
    table gives a grouped launch at ``survivors`` on ``tile_n``-row tiles."""
    if survivors == 1:
        return 1, 4, False                  # A, any tile width
    if tile_n > 256 * 128:
        return 8, 1, False                  # W: past 8-bit group indices
    if survivors == 3:
        return 3, 4, True                   # B
    if survivors == 4 and arm not in ("highest", "pq"):
        return 4, 4, True                   # B4
    return 8, 2, True                       # C


def _deep_code(slots, rows, packed):
    """csrc/binned_select.cuh's deep_code: the emitter code
    kernel_resources reports for a deep build."""
    return -(100 * slots + 10 * rows + int(packed))


@pytest.mark.cuda
@pytest.mark.parametrize("arm,kernel", [
    (arm, kernel) for arm in LANE_ARMS
    for kernel in ("tiled", "streaming", "fused")
    if (kernel, arm) != ("fused", "pq")])    # refused, as in the reference
def test_cuda_grouped_builds_take_no_local_memory_beyond_the_stated(
        cuda_device, arm, kernel):
    # the two-survivor build and every deep one, at Dp 128 and above: no
    # spill but the stated (the deep builds none), every build one CTA per
    # SM, and each deep launch on the build and passes of the header's
    # table (4 / rows passes a db tile)
    carry = CARRY_BYTES if kernel == "fused" else 0
    for survivors, tile_n in ((2, 16384), (1, 16384), (3, 16384),
                              (4, 16384), (5, 16384), (8, 16384),
                              (1, 65536), (3, 65536), (8, 65536)):
        for dp in ((32,) if arm == "pq" else (128, 256)):
            res = ck.kernel_resources(kernel, arm, survivors=survivors, dp=dp,
                                      tile_n=tile_n, device=cuda_device)
            key = (survivors, tile_n, dp, res)
            if survivors == 2:
                assert res["emitter"] == 0 and res["passes"] == 1, key
                assert res["local_bytes"] <= carry + SPILL_BYTES.get(arm, 0), \
                    key
            else:
                slots, rows, packed = _deep_plan(arm, survivors, tile_n)
                assert res["emitter"] == _deep_code(slots, rows, packed), key
                assert res["passes"] == 4 // rows, key
                assert res["local_bytes"] <= carry, key
            assert res["ctas_per_sm"] >= 1, key
            assert res["registers"] <= 255, key


# --- the counted selectors, compute_dtype, l1 / dot, radius, estimators -------


def _lex_topk(d, k):
    return np.lexsort((np.broadcast_to(np.arange(d.shape[1]), d.shape), d),
                      axis=-1)[:, :k]


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "cosine", "dot"])
@pytest.mark.parametrize("selector", ["exact", "approx"])
def test_cuda_counted_selectors_equal_the_cpu_path(cuda_device, selector,
                                                   metric):
    from knn_tpu_torch import ShardedKNN

    rng = np.random.default_rng(40)
    q, db = _data(rng, 37, 3000, 24)
    out = {dev: ShardedKNN(db, k=9, metric=metric, device=dev
                           ).search_certified(q, selector=selector,
                                              batch_size=16)
           for dev in ("cpu", cuda_device)}
    (dc, ic, _), (dg, ig, st) = out["cpu"], out[cuda_device]
    np.testing.assert_array_equal(ig, ic)
    np.testing.assert_allclose(dg, dc, rtol=1e-12,
                               atol=1e-12 * np.abs(dc).max())
    if metric == "l2":
        np.testing.assert_array_equal(ig, _lex_topk(
            ((q[:, None].astype(np.float64) - db[None]) ** 2).sum(-1), 9))
    assert st["certified"] + st["fallback_queries"] == 37


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["bfloat16", "float16"])
def test_cuda_half_scores_are_f32_inside_the_half_model(cuda_device, dt):
    from knn_tpu_torch.ops import distance as pdist

    rng = np.random.default_rng(41)
    q, db = _data(rng, 33, 500, 40)
    form = pdist.half_matmul_form(cuda_device)
    assert form == "mm_out_dtype"
    got = pdist.pairwise_sq_l2(torch.from_numpy(q).to(cuda_device),
                               torch.from_numpy(db).to(cuda_device),
                               compute_dtype=dt)
    assert got.dtype == torch.float32
    q64, t64 = q.astype(np.float64), db.astype(np.float64)
    exact = ((q64[:, None] - t64[None]) ** 2).sum(-1)
    norms = (q64 ** 2).sum(-1)[:, None] + (t64 ** 2).sum(-1)[None]
    unit = 2.0 ** -8 if dt == "bfloat16" else 2.0 ** -11
    assert (np.abs(got.cpu().numpy() - exact) <= unit * norms).all()
    cpu = pdist.pairwise_sq_l2(torch.from_numpy(q), torch.from_numpy(db),
                               compute_dtype=dt).numpy()
    # f32 accumulation either way: the forms differ by f32 rounding only
    assert np.abs(got.cpu().numpy() - cpu).max() <= 64 * EPS32 * norms.max()


@pytest.mark.cuda
def test_cuda_dot_certified_search_runs_k1_at_dp256(cuda_device):
    from knn_tpu_torch import ShardedKNN

    rng = np.random.default_rng(42)
    q, db = _data(rng, 64, 20000, 128)
    knn = ShardedKNN(db, k=10, metric="dot", device=cuda_device)
    assert knn.placement.th.shape[1] == 256
    before = ck.binned_select.launches["bf16x3"]
    d, i, st = knn.search_certified(q)
    assert ck.binned_select.launches["bf16x3"] - before == \
        ck.kernel_launches_per_batch("tiled", 20000, ck.TILE_N)
    ip = -(q.astype(np.float64) @ db.astype(np.float64).T)
    oi = _lex_topk(ip, 10)
    np.testing.assert_array_equal(i, oi)
    od = np.take_along_axis(ip, oi, -1)
    aug = 2 * od + (q.astype(np.float64) ** 2).sum(-1)[:, None] + \
        knn.placement.db_norm_max
    assert (np.abs(d - od) <= ck.RANK_SLACK * aug).all()


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "l1", "cosine"])
def test_cuda_search_and_radius_equal_the_cpu_path(cuda_device, metric):
    from knn_tpu_torch import ShardedKNN

    rng = np.random.default_rng(43)
    q, db = _data(rng, 20, 900, 12, scale=1.0)
    radius = {"l2": 3.1, "l1": 9.0, "cosine": 0.9}[metric]
    out = {}
    for dev in ("cpu", cuda_device):
        knn = ShardedKNN(db, k=7, metric=metric, device=dev)
        d, i = knn.search(q)
        out[dev] = (d.cpu().numpy(), i.cpu().numpy(),
                    *knn.radius_search(q, radius, max_neighbors=40))
    (dc, ic, rdc, ric, cc), (dg, ig, rdg, rig, cg) = out["cpu"], out[cuda_device]
    np.testing.assert_allclose(dg, dc, rtol=1e-5, atol=1e-5)
    # radii off the data's values: the in-radius sets agree
    np.testing.assert_array_equal(cg, cc)
    np.testing.assert_array_equal(np.sort(rig, -1), np.sort(ric, -1))
    assert (cg > 0).any()


@pytest.mark.cuda
def test_cuda_estimators_equal_the_cpu_path(cuda_device):
    from knn_tpu_torch import (KNNRegressor, NearestNeighbors,
                               RadiusNeighborsClassifier)

    rng = np.random.default_rng(44)
    q, X = _data(rng, 25, 800, 10, scale=1.0)
    y = X[:, 0] * 3
    labels = (np.arange(800) % 3).astype(np.int32)
    res = {}
    for dev in ("cpu", cuda_device):
        res[dev] = (
            KNNRegressor(k=5, weights="distance", device=dev).fit(X, y)
            .predict(q),
            NearestNeighbors(k=5, device=dev).fit(X).kneighbors_graph(q)[1],
            RadiusNeighborsClassifier(2.5, max_neighbors=400, outlier_label=0,
                                      device=dev).fit(X, labels).predict(q))
    c, g = res["cpu"], res[cuda_device]
    np.testing.assert_allclose(g[0], c[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(g[1], c[1])
    np.testing.assert_array_equal(g[2], c[2])


# -- the index tiers and the join ---------------------------------------------
@pytest.fixture
def no_card(monkeypatch):
    """A machine without a GPU, whatever this one has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_tiers_need_a_gpu_unless_cpu_is_asked(no_card):
    from knn_tpu_torch import tuning
    from knn_tpu_torch.cli import main
    from knn_tpu_torch.index import MutableIndex
    from knn_tpu_torch.ivf import IVFIndex
    from knn_tpu_torch.parallel.sharded import segment_search_program

    X = np.random.default_rng(50).normal(size=(40, 4)).astype(np.float32)
    for make in (lambda: MutableIndex(X, k=2),
                 lambda: IVFIndex(X, k=2),
                 lambda: segment_search_program(2),
                 lambda: tuning.autotune_ivf(X, X[:3], 2, runs=1),
                 lambda: main(["join", "--n", "40", "--rows", "4",
                               "--dim", "4", "--k", "2"]),
                 lambda: main(["index", "--selftest"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    MutableIndex(X, k=2, device="cpu")
    IVFIndex(X, k=2, device="cpu")


@pytest.mark.cuda
def test_cuda_segment_program_masks_rows_at_and_above_n_valid(cuda_device):
    """Rows at and above n_valid never come back, however near: with fewer
    valid rows than k the rest are +inf with the int32-max sentinel; the
    valid rows equal the CPU program's (values to f32 tolerance)."""
    from knn_tpu_torch.ops.topk import I32MAX
    from knn_tpu_torch.parallel.sharded import segment_search_program

    rng = np.random.default_rng(51)
    q, seg = _data(rng, 16, 512, 24)
    seg[300:] = q[0]  # invalid rows right on top of query 0
    out = {}
    for dev in ("cpu", cuda_device):
        prog = segment_search_program(10, device=dev)
        out[dev] = [tuple(t.cpu().numpy() for t in prog(q, seg, nv))
                    for nv in (300, 6)]
    for (dg, ig), (dc, ic) in zip(out[cuda_device], out["cpu"]):
        assert ((ig < 300) | (ig == I32MAX)).all()
        np.testing.assert_array_equal(np.isinf(dg), ig == I32MAX)
        np.testing.assert_allclose(dg[np.isfinite(dg)], dc[np.isfinite(dc)],
                                   rtol=1e-5)
    dg, ig = out[cuda_device][1]
    assert (ig[:, 6:] == I32MAX).all() and np.isinf(dg[:, 6:]).all()
    assert set(np.sort(ig[:, :6], -1).ravel()) == set(range(6))


@pytest.mark.cuda
def test_cuda_mutation_oracle(cuda_device):
    """A small mutation oracle on the card: after inserts, deletes and a
    compaction, search_certified (the default pallas selector, K1) is
    bitwise a fresh index of the survivors and the same index on the CPU;
    the IVF tier and the certified join likewise."""
    from knn_tpu_torch import ShardedKNN
    from knn_tpu_torch.index import MutableIndex
    from knn_tpu_torch.ivf import IVFIndex
    from knn_tpu_torch.join import knn_join

    rng = np.random.default_rng(52)
    db = (rng.normal(size=(3000, 24)) * 10).astype(np.float32)
    q = (rng.normal(size=(40, 24)) * 10).astype(np.float32)
    new = (rng.normal(size=(70, 24)) * 10).astype(np.float32)
    dead = [3, 250, 2999, 3001]
    res = {}
    for dev in ("cpu", cuda_device):
        idx = MutableIndex(db, k=10, reserve=8, delta_min_rows=64,
                           device=dev)
        idx.insert(new[:50], np.arange(3000, 3050))
        idx.insert(new[50:], np.arange(3050, 3070))  # crosses a rung
        idx.delete(dead)
        before = idx.search_certified(q)
        _, ids = idx.search(q)
        idx.compact()
        after = idx.search_certified(q, precision="int8", kernel="fused")
        res[dev] = (before, after, ids)
    surv = np.ones(3070, bool)
    surv[dead] = False
    rows = np.concatenate([db, new])[surv]
    fresh = MutableIndex(rows, np.arange(3070)[surv], k=10, reserve=8,
                         device=cuda_device).search_certified(q)
    for got in (res[cuda_device][0], res[cuda_device][1], res["cpu"][0]):
        np.testing.assert_array_equal(got[0], fresh[0])
        np.testing.assert_array_equal(got[1], fresh[1])
    # search ranks in f32: near ties may swap against the f64 ranking
    assert (res[cuda_device][2] == fresh[1]).mean() > 0.99
    ivf = {dev: IVFIndex(db, k=10, device=dev).search_certified(
        q, selector="pallas", precision="bf16x3") for dev in ("cpu",
                                                              cuda_device)}
    np.testing.assert_array_equal(ivf[cuda_device][0], ivf["cpu"][0])
    np.testing.assert_array_equal(ivf[cuda_device][1], ivf["cpu"][1])
    knn = ShardedKNN(db, k=10, device=cuda_device)
    jd, ji, st = knn_join(knn, q, mode="certified", superblock_rows=16)
    ld = [knn.search_certified(q[lo:lo + 16]) for lo in range(0, 40, 16)]
    np.testing.assert_array_equal(jd, np.concatenate([x[0] for x in ld]))
    np.testing.assert_array_equal(ji, np.concatenate([x[1] for x in ld]))
    sd, si, sst = knn_join(knn, q, superblock_rows=16)
    np.testing.assert_array_equal(si, ji)
    assert sst["dispatches"] == 3


# -- serving: CUDA graphs per rung ---------------------------------------------
def test_serving_entry_points_need_a_gpu_unless_cpu_is_asked(no_card):
    from knn_tpu_torch.cli import main
    from knn_tpu_torch.streaming import streaming_certified_knn, streaming_knn

    X = np.random.default_rng(60).normal(size=(40, 4)).astype(np.float32)
    for make in (lambda: streaming_knn(X, X[:3], 2, "unused"),
                 lambda: streaming_certified_knn(X, X[:3], 2, "unused"),
                 lambda: main(["loadgen", "--n", "40", "--dim", "4",
                               "--k", "2", "--rates", "5",
                               "--duration", "0.1"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def _padded(q, rows):
    out = np.zeros((rows, q.shape[1]), np.float32)
    out[: q.shape[0]] = q
    return out


def _eager_bucketed(fn, q, ladder):
    """``fn`` (an eager ShardedKNN method) over ``q`` as the engine splits
    and pads it: max-bucket chunks, each padded to its rung, pad rows
    sliced away, host arrays."""
    from knn_tpu_torch.serving import bucket_for

    parts = []
    for lo in range(0, q.shape[0], ladder[-1]):
        chunk = q[lo:lo + ladder[-1]]
        out = fn(_padded(chunk, bucket_for(ladder, chunk.shape[0])))
        out = out if isinstance(out, tuple) else (out,)
        parts.append([t.cpu().numpy()[: chunk.shape[0]] for t in out])
    return [np.concatenate(x) for x in zip(*parts)]


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_cuda_graph_replay_is_bitwise_the_eager_program(cuda_device, metric):
    """Each of three rungs is one captured graph; a replay is bitwise an
    eager ShardedKNN.search of the same padded batch (distances and
    indices), a second pass over the rungs captures nothing, and predict's
    replay equals ShardedKNN.predict of the padded batch."""
    from knn_tpu_torch import ShardedKNN
    from knn_tpu_torch.serving import ServingEngine

    rng = np.random.default_rng(61)
    q, db = _data(rng, 40, 3000, 24)
    labels = rng.integers(0, 4, 3000).astype(np.int32)
    prog = ShardedKNN(db, k=10, metric=metric, labels=labels, num_classes=4,
                      device=cuda_device)
    ladder = (8, 16, 32)
    eng = ServingEngine(prog, buckets=ladder)
    assert eng.graphs
    assert eng.warmup(ops=("search", "predict")) == {"search": 3,
                                                     "predict": 3}
    for n in (3, 8, 11, 32, 40):
        d, i = eng.search(q[:n])
        de, ie = _eager_bucketed(prog.search, q[:n], ladder)
        np.testing.assert_array_equal(d, de)
        np.testing.assert_array_equal(i, ie)
        (want,) = _eager_bucketed(prog.predict, q[:n], ladder)
        np.testing.assert_array_equal(eng.predict(q[:n]), want)
    assert eng.stats()["compile_count"] == 6
    pool = eng.graph_pool_bytes()
    assert pool is None or pool > 0


@pytest.mark.cuda
def test_cuda_two_in_flight_requests_on_one_rung_keep_their_rows(cuda_device):
    """Two requests submitted back to back ride the same graph; each
    handle gets its own rows (the static outputs are copied out per
    request before the next replay)."""
    from knn_tpu_torch import ShardedKNN
    from knn_tpu_torch.serving import ServingEngine

    rng = np.random.default_rng(62)
    q, db = _data(rng, 64, 20000, 32)
    prog = ShardedKNN(db, k=16, device=cuda_device)
    eng = ServingEngine(prog, buckets=(32,))
    eng.warmup()
    handles = [eng.submit(q[j * 16:(j + 1) * 16]) for j in range(4)]
    outs = [h.result() for h in handles]
    for j, (d, i) in enumerate(outs):
        de, ie = prog.search(_padded(q[j * 16:(j + 1) * 16], 32))
        np.testing.assert_array_equal(d, de.cpu().numpy()[:16])
        np.testing.assert_array_equal(i, ie.cpu().numpy()[:16])
    assert not np.array_equal(outs[0][1], outs[1][1])
    assert eng.stats()["per_bucket_dispatches"] == {32: 4}


@pytest.mark.cuda
def test_cuda_eager_engine_is_bitwise_the_graph_replay(cuda_device):
    """``aot=False`` on the card runs the eager program at every rung and
    answers bitwise what the captured graphs answer, capturing nothing."""
    from knn_tpu_torch import ShardedKNN
    from knn_tpu_torch.serving import ServingEngine

    rng = np.random.default_rng(64)
    q, db = _data(rng, 70, 20000, 32)
    prog = ShardedKNN(db, k=12, device=cuda_device)
    ladder = (8, 16, 32)
    graphed = ServingEngine(prog, buckets=ladder)
    eager = ServingEngine(prog, buckets=ladder, aot=False)
    assert graphed.graphs and not eager.graphs
    graphed.warmup()
    eager.warmup()
    for n in (5, 16, 27, 70):
        for a, b in zip(graphed.search(q[:n]), eager.search(q[:n])):
            np.testing.assert_array_equal(a, b)
    assert eager.graph_pool_bytes() is None
    assert eager.stats()["per_bucket_dispatches"] == \
        graphed.stats()["per_bucket_dispatches"]


@pytest.mark.cuda
def test_cuda_warmup_holds_no_blocks_beyond_its_graph_pool(cuda_device):
    """The eager runs before each capture leave no cached blocks behind:
    after warmup() the allocator reserves the graph pool and at most
    128 MiB more (the capture stream's cuBLAS workspace, the static
    inputs); one stranded block of the warm-up (the [1M, 64] f32 squares
    of the rows) would be 244 MiB."""
    from knn_tpu_torch import ShardedKNN
    from knn_tpu_torch.serving import ServingEngine

    rng = np.random.default_rng(65)
    _, db = _data(rng, 1, 1000000, 64)
    prog = ShardedKNN(db, k=16, device=cuda_device)
    eng = ServingEngine(prog, buckets=(16, 32, 64))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()
    eng.warmup()
    delta = torch.cuda.memory_reserved() - reserved0
    pool = eng.graph_pool_bytes()
    assert pool is not None and pool > 0
    assert delta <= pool + (128 << 20), (delta, pool)


@pytest.mark.cuda
def test_cuda_capture_on_a_second_thread_while_the_first_searches(
        cuda_device):
    """A second engine captures its graphs on another thread while this
    thread replays the first engine's graphs: both answer bitwise their
    eager programs, and the capture raises nothing."""
    import threading

    from knn_tpu_torch import ShardedKNN
    from knn_tpu_torch.serving import ServingEngine

    rng = np.random.default_rng(63)
    q, db = _data(rng, 64, 20000, 32)
    prog_a = ShardedKNN(db, k=8, device=cuda_device)
    prog_b = ShardedKNN(db[::-1].copy(), k=8, device=cuda_device)
    eng_a = ServingEngine(prog_a, buckets=(8, 16, 32, 64))
    eng_a.warmup()
    eng_b = ServingEngine(prog_b, buckets=(8, 16, 32, 64))
    errors = []

    def capture():
        try:
            eng_b.warmup()
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    t = threading.Thread(target=capture)
    t.start()
    served = []
    while t.is_alive() or len(served) < 8:
        n = 1 + len(served) % 64
        served.append((n, eng_a.search(q[:n])))
    t.join()
    assert not errors, errors
    assert eng_b.stats()["compile_count"] == 4
    for n, (d, i) in served[:8] + served[-4:]:
        r = 8 if n <= 8 else 16 if n <= 16 else 32 if n <= 32 else 64
        de, ie = prog_a.search(_padded(q[:n], r))
        np.testing.assert_array_equal(d, de.cpu().numpy()[:n])
        np.testing.assert_array_equal(i, ie.cpu().numpy()[:n])
    d, i = eng_b.search(q[:20])
    de, ie = prog_b.search(_padded(q[:20], 32))
    np.testing.assert_array_equal(d, de.cpu().numpy()[:20])
    np.testing.assert_array_equal(i, ie.cpu().numpy()[:20])


@pytest.mark.cuda
def test_cuda_mutable_frontend_across_a_compaction(cuda_device):
    """The MutableIndex frontend on the card through a QueryQueue: a
    write, a compaction that captures the replacement engine's graphs
    (two rungs), and reads whose ids equal the index's direct search
    before and after; the inserted rows are their queries' nearest."""
    from knn_tpu_torch.index import MutableIndex
    from knn_tpu_torch.serving import QueryQueue

    rng = np.random.default_rng(64)
    q, db = _data(rng, 8, 4000, 24)
    idx = MutableIndex(db, k=10, reserve=8, device=cuda_device)
    eng = idx.serving_engine(buckets=(8, 16))
    eng.warmup()
    with QueryQueue(eng, max_wait_ms=1.0) as qq:
        assert qq.submit_write("insert", vectors=q[:2] + 0.01,
                               ids=[9000, 9001]).result()["tail_rows"] == 2
        before = qq.submit(q).result()
        np.testing.assert_array_equal(before[1], idx.search(q)[1])
        idx.compact()
        assert eng.stats()["compile_count"] == 2  # the new engine's
        after = qq.submit(q).result()
    assert after[1][:2, 0].tolist() == [9000, 9001]
    np.testing.assert_array_equal(after[1], idx.search(q)[1])


@pytest.mark.cuda
def test_cuda_device_trace_names_k1_and_obs_moves_no_sync(cuda_device,
                                                          tmp_path):
    """obs.profiler.device_trace of a certified search on the card holds
    K1, and the host's synchronizations and device-to-host copies are the
    same with obs on and off (obs reads no device tensor); the results are
    bitwise the same."""
    from knn_tpu_torch import ShardedKNN, obs
    from knn_tpu_torch.obs import profiler

    rng = np.random.default_rng(11)
    q, db = _data(rng, 64, 40_000, 64)
    knn = ShardedKNN(db, k=10, device=cuda_device)
    knn.search_certified(q)  # warm: builds, allocations
    runs = {}
    try:
        for on in (True, False):
            obs.reset(enabled=on)
            # one trace each: the warm-up kernels take the loss of a
            # trace's first kernels, and one of them must be kept
            torch.cuda.synchronize()
            with profiler.device_trace("search",
                                       out_dir=str(tmp_path)) as cap:
                out = knn.search_certified(q)
                torch.cuda.synchronize()
            runs[on] = (out, cap.summary())
    finally:
        obs.reset()
    (d1, i1, _), s_on = runs[True]
    (d0, i0, _), s_off = runs[False]
    assert np.array_equal(d1, d0) and np.array_equal(i1, i0)
    for s in (s_on, s_off):
        assert any("binned_select_" in n for n in s["kernel_names"])
        # the warm-up kernels and the fill of their buffer
        assert 1 <= s["device_events_before"] <= profiler.WARMUP_KERNELS + 1
    assert s_on["syncs"] == s_off["syncs"]
    assert s_on["d2h_copies"] == s_off["d2h_copies"] > 0
    assert 0.0 <= s_on["device_idle_share"] < 1.0


@pytest.mark.cuda
def test_cuda_health_inventory_names_the_card(cuda_device):
    from knn_tpu_torch import obs

    inv = obs.health.report()["devices"]
    assert inv["available"] and inv["backend"] == "cuda"
    assert inv["count"] == torch.cuda.device_count()
    assert inv["kinds"] == sorted({torch.cuda.get_device_name(i)
                                   for i in range(inv["count"])})
    assert inv["devices"][0]["total_memory_bytes"] > 0


#: device bytes a tier search may keep per neighbour of its [Q, k] carry
#: beside the budget (the carry, a sweep's top-k and their merge's sorts)
_CARRY_BYTES_PER_NEIGHBOUR = 128


def _int_rows(rng, n, dim):
    """Integer-valued rows: every f32 product and sum of the l2 gram form
    is exact in any order, on the card as on the host."""
    return rng.integers(0, 10, size=(n, dim)).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_cuda_host_tier_is_bitwise_the_resident_search(cuda_device, depth):
    """The host-RAM tier on the card: 50,000 x 32 integer rows behind a
    6,000-row budget (9 sweeps through the pinned staging buffers and the
    copy stream), bitwise the resident search and the float64 oracle's
    indices, at every depth; the tier holds ``depth`` segment buffers and
    a call adds at most one budget besides the queries and the carry."""
    from knn_tpu_torch import ShardedKNN
    from knn_tpu_torch.analysis import hbm

    rng = np.random.default_rng(70)
    db, q = _int_rows(rng, 50_000, 32), _int_rows(rng, 300, 32)
    budget = hbm.placement_bytes(6_000, 32)
    tier = ShardedKNN(db, k=10, device=cuda_device, hbm_budget_bytes=budget,
                      hosttier_depth=depth)
    assert tier.hosttier_stats()["sweeps"] == 9
    seg_bytes = tier.hosttier_stats()["segment_rows"] * 32 * 4
    torch.mm(torch.ones(8, 8, device=cuda_device),
             torch.ones(8, 8, device=cuda_device))  # the cuBLAS workspace
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    tier.search(q[:8])  # makes the slots
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    assert held == depth * seg_bytes == \
        tier.hosttier_stats()["last_search"]["device_buffer_bytes"]
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    d, i = tier.search(q)
    torch.cuda.synchronize()
    added = torch.cuda.max_memory_allocated() - base
    assert added <= budget + q.nbytes + _CARRY_BYTES_PER_NEIGHBOUR * 300 * 10
    last = tier.hosttier_stats()["last_search"]
    assert last["sweeps"] == 9 and len(last["h2d_s"]) == 9
    assert last["h2d_gbps"] > 0
    rd, ri = ShardedKNN(db, k=10, device=cuda_device).search(q)
    assert torch.equal(d, rd) and torch.equal(i, ri)
    d64 = ((db.astype(np.float64)[None] - q.astype(np.float64)[:, None])
           ** 2).sum(-1)
    order = np.lexsort((np.broadcast_to(np.arange(50_000), d64.shape), d64),
                       axis=-1)[:, :10]
    np.testing.assert_array_equal(i.cpu().numpy(), order)


def _lagging(prog):
    """``prog`` behind a 10M-cycle spin (~5 ms) of the current stream
    before each call.  The dispatches are a few blocks of few kernels, so
    the launch queue holds many of them and the host runs far ahead of the
    card: a copy that does not wait for the work reading its buffer
    overwrites a segment before it is read."""
    def run(*args):
        torch.cuda._sleep(10_000_000)
        return prog(*args)

    return run


@pytest.mark.cuda
@pytest.mark.parametrize("n_b,seg,dim,n_q,sb,order,lag", [
    (40_000, 9_000, 16, 300, 64, "db_major", False),
    (40_000, 9_000, 16, 300, 300, "query_major", False),
    (1_000, 20, 64, 80, 20, "query_major", True)])
def test_cuda_tiered_join_is_bitwise_the_looped_tier_search(
        cuda_device, n_b, seg, dim, n_q, sb, order, lag):
    """The tiered join in both orders, query-major also over four
    superblocks and 50 segments with the card behind the host, bitwise the
    looped tier search and (integer rows) the resident search."""
    from knn_tpu_torch import ShardedKNN, knn_join
    from knn_tpu_torch.analysis import hbm

    rng = np.random.default_rng(71)
    db, q = _int_rows(rng, n_b, dim), _int_rows(rng, n_q, dim)
    tier = ShardedKNN(db, k=5, device=cuda_device,
                      hbm_budget_bytes=hbm.placement_bytes(seg, dim))
    made = tier._hosttier_program
    if lag:
        tier._hosttier_program = lambda k: _lagging(made(k))
    d, i, st = knn_join(tier, q, mode="stream", superblock_rows=sb)
    assert st["order"] == order
    assert st["db_segments"] == -(-n_b // seg)
    assert st["superblocks"] == -(-n_q // sb)
    tier._hosttier_program = made
    looped = [tier.search(np.pad(q[lo:lo + sb],
                                 ((0, max(0, lo + sb - q.shape[0])), (0, 0))))
              for lo in range(0, q.shape[0], sb)]
    ld = np.concatenate([x[0].cpu().numpy() for x in looped])[:q.shape[0]]
    li = np.concatenate([x[1].cpu().numpy() for x in looped])[:q.shape[0]]
    np.testing.assert_array_equal(d, ld)
    np.testing.assert_array_equal(i, li)
    rd, ri = ShardedKNN(db, k=5, device=cuda_device).search(q)
    np.testing.assert_array_equal(i, ri.cpu().numpy())
    np.testing.assert_array_equal(d, rd.cpu().numpy())


@pytest.mark.cuda
def test_cuda_concurrent_tier_searches_equal_sequential(cuda_device):
    """Four threads search one tier at once, the card lagging the host:
    each result is bitwise its sequential search (the tier's slots are
    taken one search at a time)."""
    import threading

    from knn_tpu_torch import ShardedKNN
    from knn_tpu_torch.analysis import hbm

    rng = np.random.default_rng(72)
    db = _int_rows(rng, 2_000, 64)
    qs = [_int_rows(rng, 8, 64) for _ in range(4)]
    tier = ShardedKNN(db, k=5, device=cuda_device,
                      hbm_budget_bytes=hbm.placement_bytes(100, 64))
    want = [tuple(t.cpu().numpy() for t in tier.search(q)) for q in qs]
    made = tier._hosttier_program
    tier._hosttier_program = lambda k: _lagging(made(k))
    got = [None] * len(qs)

    def run(j):
        got[j] = tuple(t.cpu().numpy() for t in tier.search(qs[j]))

    threads = [threading.Thread(target=run, args=(j,))
               for j in range(len(qs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for (wd, wi), (gd, gi) in zip(want, got):
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gi, wi)


@pytest.mark.cuda
def test_cuda_audited_graph_engine_scores_what_the_caller_received(
        cuda_device):
    """The audit sampler on a graphed engine: two back-to-back requests
    ride one rung, the worker is held until the second replay is done, and
    the first record still holds the first caller's arrays (never the
    graph's static output buffer); both audit recall 1.0."""
    import threading

    from knn_tpu_torch import ShardedKNN, obs
    from knn_tpu_torch.obs import audit
    from knn_tpu_torch.serving import ServingEngine

    rng = np.random.default_rng(71)
    q, db = _data(rng, 32, 20000, 32)
    prog = ShardedKNN(db, k=16, device=cuda_device)
    eng = ServingEngine(prog, buckets=(16,))
    eng.warmup()
    assert eng.graphs
    obs.reset(enabled=True)
    audit.reset_auditor(rate=1.0, budget_rows_s=1e12)
    release, seen = threading.Event(), {}

    def hold(rec):
        assert release.wait(120)
        seen[rec.trace_id] = (rec.served_d.copy(), rec.served_ids.copy())
        return rec

    audit.set_fault(hold)
    try:
        res_a = eng.submit(q[:16], trace_id="audit-a").result()
        res_b = eng.submit(q[16:], trace_id="audit-b").result()
        release.set()
        assert audit.get_auditor().drain(timeout=120)
    finally:
        audit.clear_fault()
        release.set()
    s = audit.get_auditor().summary()
    audit.reset_auditor()
    assert not np.array_equal(res_a[1], res_b[1])
    for tid, (d, i) in (("audit-a", res_a), ("audit-b", res_b)):
        np.testing.assert_array_equal(seen[tid][0], d)
        np.testing.assert_array_equal(seen[tid][1], i)
    de, ie = prog.search(q[:16])
    np.testing.assert_array_equal(res_a[1], ie.cpu().numpy())
    assert s["replayed_queries"] == 32 and s["deficient_queries"] == 0
    assert s["last_recall_at_k"] == 1.0 and s["dropped"] == {}


@pytest.mark.cuda
def test_cuda_audited_ivf_frontend_launches_k1(cuda_device):
    """The IVF frontend with pallas / bf16x3 on the card: K1 launched for
    the probe groups, every served answer audited at recall 1.0, and the
    drift sketch observed the queries."""
    from knn_tpu_torch import obs
    from knn_tpu_torch.ivf import IVFIndex
    from knn_tpu_torch.obs import audit

    rng = np.random.default_rng(72)
    cents = rng.normal(size=(16, 32)).astype(np.float32) * 20
    rows = (cents[rng.integers(0, 16, 8000)]
            + rng.normal(size=(8000, 32)).astype(np.float32))
    q = (cents[rng.integers(0, 16, 48)]
         + rng.normal(size=(48, 32)).astype(np.float32))
    obs.reset(enabled=True)
    idx = IVFIndex(rows, k=10, ncentroids=16, nprobe=4, device=cuda_device)
    eng = idx.serving_engine(buckets=(16,), selector="pallas",
                             precision="bf16x3")
    audit.reset_auditor(rate=1.0, budget_rows_s=1e12)
    before = ck.binned_select.launches["bf16x3"]
    try:
        served = [eng.submit(q[j:j + 16], trace_id=f"ivf-{j}").result()
                  for j in range(0, 48, 16)]
        assert audit.get_auditor().drain(timeout=120)
        s = audit.get_auditor().summary()
    finally:
        audit.reset_auditor()
    assert ck.binned_select.launches["bf16x3"] > before
    assert s["replayed_queries"] == 48 and s["deficient_queries"] == 0
    assert s["last_recall_at_k"] == 1.0 and s["dropped"] == {}
    assert idx.stats()["drift"]["queries_observed"] == 48
    direct = idx.search_certified(q[:16], selector="pallas",
                                  precision="bf16x3")
    np.testing.assert_array_equal(served[0][1], direct[1])


@pytest.mark.cuda
def test_cuda_device_time_lands_in_the_join_segment(cuda_device):
    """ROADMAP divergence: a dispatch only enqueues the graph replay, so
    a request whose replay waits behind ~50 ms of device work shows that
    time in ``join``; ``device`` holds only the host's gap between the
    dispatch's return and the ``result()`` call, and the segments tile."""
    from knn_tpu_torch import ShardedKNN, obs
    from knn_tpu_torch.obs import waterfall

    rng = np.random.default_rng(73)
    q, db = _data(rng, 8, 20000, 32)
    eng_prog = ShardedKNN(db, k=8, device=cuda_device)
    from knn_tpu_torch.serving import ServingEngine

    eng = ServingEngine(eng_prog, buckets=(8,))
    eng.warmup()
    obs.reset(enabled=True)
    obs.reset_event_log(None)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)  # ~50 ms of device time at 2 GHz
    h = eng.submit(q, trace_id="join-holds-device")
    h.result()
    w = waterfall.reconstruct(obs.get_event_log().recent())[h.trace_id]
    seg = {s["name"]: s["dur_s"] for s in w["segments"]}
    assert seg["join"] >= 0.02, seg
    assert seg["device"] < seg["join"], seg
    assert w["complete"], w


@pytest.mark.cuda
def test_cuda_traceread_busy_equals_profiler_summary(cuda_device, tmp_path):
    """A device trace of a certified search on the card, read back from
    disk: device tracks matched, the warm-up kernels before the body, K1
    in the body, and the busy time profiler.summarize gives the same
    trace."""
    from knn_tpu_torch import ShardedKNN
    from knn_tpu_torch.obs import profiler, traceread

    rng = np.random.default_rng(17)
    q, db = _data(rng, 256, 40_000, 64)
    knn = ShardedKNN(db, k=10, device=cuda_device)
    knn.search_certified(q)  # warm: builds, allocations
    torch.cuda.synchronize()
    with profiler.device_trace("search", out_dir=str(tmp_path)) as cap:
        knn.search_certified(q)
        torch.cuda.synchronize()
    summ = cap.summary()
    s = traceread.read_section(str(tmp_path), "search")
    assert s["device_tracks_matched"] and s["events_before_body"] >= 1
    assert s["kernel_events"] == summ["kernel_events"]
    assert abs(s["device_busy_s"] - summ["device_busy_ms"] / 1e3) <= \
        1e-6 + 1e-9 * s["kernel_events"]
    events = traceread.read_trace_events(s["trace_files"][0])
    assert any("binned_select_" in n
               for n in traceread.body_event_names(events))
    sample = traceread.sample_from_trace(str(tmp_path), "search", nq=256)
    assert sample["source"] == "device_trace" and sample["qps"] > 0


@pytest.mark.cuda
def test_cuda_campaign_arms_calibrate_at_a_small_shape(cuda_device,
                                                       tmp_path):
    """The campaign's two bf16x3 arms on the card: every stage ok, the
    trace read back holds each arm's kernel with the busy time
    profiler.summarize gives, both samples fit, the device-trace fit
    stored under two keys, and each calibrated ceiling within the
    tolerance of its measured q/s and at least the arm's own wall
    rate."""
    from knn_tpu_torch import campaign
    from knn_tpu_torch.obs import calibrate

    # large enough that the host-phase sample stays inside the factor
    # clamp of the modeled microseconds
    s = campaign.run_campaign(
        rehearse=True, arms=("bf16x3_tiled", "bf16x3_streaming"),
        out_dir=str(tmp_path), device="cuda",
        shape=dict(n=200_000, d=128, k=10, nq=1024))
    assert s["ok"], s["arms"]
    keys = [a["entry_key"] for a in s["arms"]]
    assert len(set(keys)) == 2
    assert keys[0].startswith(torch.cuda.get_device_name(0) + "|")
    for r in s["results"]:
        line = r["line"]
        stages = {st["stage"]: st for st in line["campaign"]["stages"]}
        assert all(st["status"] == "ok" for st in stages.values())
        cap = stages["capture"]["live_capture"]
        assert cap["device_tracks_matched"] and cap["kernel_held"]
        assert abs(cap["device_busy_s"] - cap["summarize_busy_s"]) <= \
            1e-6 + 1e-9 * cap["kernel_events"]
        assert stages["reconcile"]["source"] == "device_trace"
        fits = stages["reconcile"]["fits"]
        assert set(fits) == {"device_trace", "host_phase"}
        assert all("error" not in f for f in fits.values()), fits
        assert stages["calibrate"]["reconstruction_residual_pct"] <= \
            calibrate.RESIDUAL_TOLERANCE_PCT
        # the stored (trace) ceiling is at least the arm's own wall rate
        assert stages["calibrate"]["ceiling_below"] == []
        assert line["roofline"]["ceiling_qps"] >= fits["host_phase"]["qps"]
        bench = stages["bench"]
        assert bench["tile_n"] in stages["tune"]["tiles"]
        assert bench["certified"] + bench["fallback_queries"] >= 1024
        assert line["roofline"]["calibration"]["applied"]
        assert line["device_kind"] == torch.cuda.get_device_name(0)


@pytest.mark.cuda
def test_cuda_graphed_engine_lock_order_acyclic_under_hammer(cuda_device):
    """The lock-order hammer (chip_smoke.lock_order_hammer) over a warm
    CUDA-graph engine: its _lock and _launch_lock, a QueryQueue's _cond
    and admission controller, the SLO engine, the registry, one histogram
    and the audit sampler at rate 1.0; 8 threads x 4 requests of 1-8
    rows, every request bitwise the eager search of its coalesced batch,
    one graph replay per queue batch and no new capture."""
    import chip_smoke
    from knn_tpu_torch import ShardedKNN, obs
    from knn_tpu_torch.obs import audit
    from knn_tpu_torch.obs import names as mn
    from knn_tpu_torch.serving import (AdmissionConfig, QueryQueue,
                                       ServingEngine, bucket_for)

    rng = np.random.default_rng(71)
    q, db = _data(rng, 256, 20000, 32)
    knn = ShardedKNN(db, k=16, device=cuda_device)
    eng = ServingEngine(knn, min_bucket=16, max_bucket=512)
    eng.warmup()
    assert eng.graphs
    st0 = eng.stats()

    def eager(cat):
        padded = np.zeros((bucket_for(eng.buckets, cat.shape[0]), 32),
                          np.float32)
        padded[:cat.shape[0]] = cat
        return tuple(t.cpu().numpy()[:cat.shape[0]]
                     for t in knn.search(padded))

    obs.reset(enabled=True)
    slo_eng = obs.reset_slo_engine()
    aud = audit.reset_auditor(rate=1.0)
    try:
        with QueryQueue(eng, max_wait_ms=1.0, admission=AdmissionConfig(
                max_depth=4096)) as qq:
            out = chip_smoke.lock_order_hammer(
                qq, eng, q,
                {"engine": eng, "engine_launch": (eng, "_launch_lock"),
                 "queue": qq, "admission": qq._ctrl, "slo": slo_eng,
                 "registry": obs.get_registry(),
                 "latency_hist": obs.histogram(
                     mn.SERVING_REQUEST_LATENCY, op="search"),
                 "audit": aud},
                [eager], calls=(qq.stats, slo_eng.evaluate))
            dispatches = qq.stats()["dispatches"]
    finally:
        audit.reset_auditor()
        obs.reset_slo_engine()
    st1 = eng.stats()
    replays = (sum(st1["per_bucket_dispatches"].values())
               - sum(st0["per_bucket_dispatches"].values()))
    assert out["requests"] == 32 and out["edges"] >= 1
    assert "engine_launch" in out["locks_seen"]
    assert replays == dispatches == out["batches"]
    assert st1["compile_count"] == st0["compile_count"] == 6


@pytest.mark.cuda
def test_cuda_catalog_validates_a_real_searchs_roofline_block(cuda_device):
    """The artifact catalog on a roofline block attributed to a real
    certified search on the card (and its calibration-off overlay):
    valid in both styles, as the shim says."""
    import time

    from knn_tpu_torch import ShardedKNN
    from knn_tpu_torch.analysis import artifacts
    from knn_tpu_torch.obs import roofline

    rng = np.random.default_rng(72)
    q, db = _data(rng, 512, 50000, 64)
    knn = ShardedKNN(db, k=10, device=cuda_device)
    knn.search_certified(q)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, st = knn.search_certified(q)
    wall = time.perf_counter() - t0
    assert st["certified"] + st["fallback_queries"] == 512
    block = roofline.attribute(roofline.pallas_cost_model(
        n=50000, d=64, k=10, nq=512,
        device_kind=torch.cuda.get_device_name(0)), 512 / wall)
    assert block["bound_class"] in roofline.BOUND_CLASSES
    for style in ("legacy", "normalized"):
        assert artifacts.validate("roofline", block, style=style) == []
        assert artifacts.validate("calibration", block["calibration"],
                                  style=style) == []
    assert roofline.validate_block(block) == []
    assert roofline.validate_block({**block, "roofline_pct": -1.0}) == [
        "roofline_pct must be a non-negative number, got -1.0"]


@pytest.mark.cuda
def test_cuda_logical_mesh_launches_k1_per_shard_bitwise_one_device(
        cuda_device):
    """A (1, 4) logical mesh on one card: every batch launches K1 once a
    db shard, nothing else, and the certified result is bitwise the
    (1, 1) placement's wherever neither placement repaired a query (a
    repaired row holds a value f32 cannot represent); ring
    and allgather are bitwise each other."""
    from knn_tpu_torch import ShardedKNN
    from knn_tpu_torch.parallel.mesh import make_mesh

    rng = np.random.default_rng(73)
    q, db = _data(rng, 256, 40000, 64)
    one = ShardedKNN(db, k=10, device=cuda_device)
    rd, ri, rst = one.search_certified(q, batch_size=128)
    dev = torch.device(cuda_device)
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if dev.index is None else dev
    outs = {}
    for merge in ("ring", "allgather"):
        knn = ShardedKNN(db, k=10, merge=merge,
                         mesh=make_mesh(1, 4, devices=[dev] * 4))
        before = dict(ck.binned_select.launches)
        others = (dict(ck.stream_select.launches),
                  dict(ck.fused_select.launches))
        d, i, st = knn.search_certified(q, batch_size=128)
        assert ck.binned_select.launches["bf16x3"] == \
            before["bf16x3"] + 4 * 2
        assert {a: n for a, n in ck.binned_select.launches.items()
                if a != "bf16x3"} == {a: n for a, n in before.items()
                                      if a != "bf16x3"}
        assert (dict(ck.stream_select.launches),
                dict(ck.fused_select.launches)) == others
        np.testing.assert_array_equal(i, ri)
        if st["fallback_queries"] == rst["fallback_queries"] == 0:
            np.testing.assert_array_equal(d, rd)
        # a row's distances differ only where one side repaired it (it
        # then holds a value f32 cannot represent)
        repaired = ((d != d.astype(np.float32)).any(1)
                    | (rd != rd.astype(np.float32)).any(1))
        assert not ((d != rd).any(1) & ~repaired).any()
        np.testing.assert_allclose(d, rd, rtol=ck.RANK_SLACK, atol=1e-12)
        both = (d != d.astype(np.float32)) & (rd != rd.astype(np.float32))
        np.testing.assert_array_equal(d[both], rd[both])
        outs[merge] = (d, i)
    np.testing.assert_array_equal(outs["ring"][0], outs["allgather"][0])
    np.testing.assert_array_equal(outs["ring"][1], outs["allgather"][1])


@pytest.mark.cuda
def test_cuda_mixed_device_mesh_raises(cuda_device):
    from knn_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(ValueError, match="mixes"):
        make_mesh(1, 2, devices=["cpu", cuda_device])


def _logical_mesh(cuda_device, shape):
    from knn_tpu_torch.parallel.mesh import make_host_mesh, make_mesh

    dev = torch.device(cuda_device)
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if dev.index is None else dev
    devs = [dev] * int(np.prod(shape))
    return (make_mesh(*shape, devices=devs) if len(shape) == 2
            else make_host_mesh(*shape, devices=devs))


@pytest.mark.cuda
def test_cuda_logical_mesh_tiers_launch_k1_per_shard(cuda_device):
    """MutableIndex and the certified join on a (1, 4) logical mesh: every
    certified batch launches K1 once a db shard and no other kernel;
    certified indices are bitwise the (1, 1) placement's; the stream join
    is bitwise the looped mesh search; a (1, 2, 2) host mesh is bitwise the
    flat mesh."""
    from knn_tpu_torch import ShardedKNN
    from knn_tpu_torch.index import MutableIndex
    from knn_tpu_torch.join import knn_join

    rng = np.random.default_rng(83)
    q, db = _data(rng, 96, 20000, 32)
    new = (rng.normal(size=(300, 32)) * 10).astype(np.float32)
    mesh = _logical_mesh(cuda_device, (1, 4))
    idx = MutableIndex(db, k=10, mesh=mesh)
    one = MutableIndex(db, k=10, device=cuda_device)
    for x in (idx, one):
        x.insert(new, np.arange(10 ** 6, 10 ** 6 + 300))
        x.delete([5, 77, 10 ** 6 + 3])
    counts = {fn: dict(fn.launches) for fn in (
        ck.binned_select, ck.stream_select, ck.fused_select)}
    d, i, st = idx.search_certified(q, batch_size=48)
    assert ck.binned_select.launches["bf16x3"] == \
        counts[ck.binned_select]["bf16x3"] + 4 * 2
    assert {fn: {a: n for a, n in fn.launches.items()
                 if (fn, a) != (ck.binned_select, "bf16x3")}
            for fn in counts} == {fn: {a: n for a, n in c.items()
                                       if (fn, a) != (ck.binned_select,
                                                      "bf16x3")}
                                  for fn, c in counts.items()}
    rd, ri, _ = one.search_certified(q, batch_size=48)
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_array_equal(d, rd)  # both refined in float64
    host = MutableIndex(db, k=10, mesh=_logical_mesh(cuda_device,
                                                     (1, 2, 2)))
    flat = MutableIndex(db, k=10, mesh=mesh)
    for a, b in zip(host.search_certified(q)[:2],
                    flat.search_certified(q)[:2]):
        np.testing.assert_array_equal(a, b)
    knn = ShardedKNN(db, k=10, mesh=mesh)
    before = ck.binned_select.launches["bf16x3"]
    cd, ci, _ = knn_join(knn, q, mode="certified", superblock_rows=32)
    assert ck.binned_select.launches["bf16x3"] == before + 4 * 3
    looped = [knn.search_certified(q[lo:lo + 32]) for lo in (0, 32, 64)]
    np.testing.assert_array_equal(ci, np.concatenate([x[1] for x in looped]))
    sd, si, _ = knn_join(knn, q, mode="stream", superblock_rows=32)
    loop = [knn.search(q[lo:lo + 32]) for lo in (0, 32, 64)]
    np.testing.assert_array_equal(
        sd, np.concatenate([x[0].cpu().numpy() for x in loop]))
    np.testing.assert_array_equal(
        si, np.concatenate([x[1].cpu().numpy() for x in loop]))


@pytest.mark.cuda
def test_cuda_logical_mesh_serving_graph_is_bitwise_eager(cuda_device):
    """ServingEngine on a (2, 2) logical mesh: each placed shape is one
    captured graph of the whole mesh program (buckets below the two query
    shards share one), a replay is bitwise the eager mesh search of the
    padded batch, a second pass captures nothing; MutableServingEngine
    over a mesh index reads bitwise the index's search."""
    from knn_tpu_torch import ShardedKNN
    from knn_tpu_torch.index import MutableIndex
    from knn_tpu_torch.serving import ServingEngine

    rng = np.random.default_rng(89)
    q, db = _data(rng, 40, 6000, 24)
    labels = rng.integers(0, 4, 6000).astype(np.int32)
    mesh = _logical_mesh(cuda_device, (2, 2))
    prog = ShardedKNN(db, k=10, labels=labels, num_classes=4, mesh=mesh)
    eng = ServingEngine(prog, buckets=(1, 2, 8, 16))
    assert eng.graphs
    assert eng.warmup(ops=("search", "predict")) == {"search": 3,
                                                     "predict": 3}
    for n in (1, 2, 5, 16, 21):
        d, i = eng.search(q[:n])
        e = eng.search(q[:n])
        np.testing.assert_array_equal(d, e[0])
        if n <= 16:
            b = next(b for b in (2, 8, 16) if b >= n)
            padded = np.zeros((b, 24), np.float32)
            padded[:n] = q[:n]
            wd, wi = prog.search(padded)
            np.testing.assert_array_equal(d, wd.cpu().numpy()[:n])
            np.testing.assert_array_equal(i, wi.cpu().numpy()[:n])
            np.testing.assert_array_equal(
                eng.predict(q[:n]), prog.predict(padded).cpu().numpy()[:n])
    # buckets 1 and 2 share one placed shape: one capture each op
    assert eng.stats()["compile_count"] == 6
    assert eng.stats()["executables"] == 6
    idx = MutableIndex(db, k=10, mesh=mesh)
    front = idx.serving_engine(buckets=(8, 16))
    front.warmup()
    idx.insert(q[:2] + 0.5, [9000, 9001])
    got = front.submit(q[:5]).result()
    padded = np.zeros((8, 24), np.float32)
    padded[:5] = q[:5]
    want = idx.search(padded)
    np.testing.assert_array_equal(got[0], want[0][:5])
    np.testing.assert_array_equal(got[1], want[1][:5])


@pytest.mark.cuda
def test_cuda_k7_on_a_mesh_shard_is_bitwise_its_plain_version(cuda_device):
    """pq on a (1, 4) logical mesh: each certified batch launches the
    tiled pq entry once a db shard and nothing else; on a shard of 5,000
    rows (not a multiple of the tile) K7 is bitwise its plain version; the
    indices are the (1, 1) pq placement's."""
    from knn_tpu_torch import ShardedKNN

    rng = np.random.default_rng(91)
    q, db = _data(rng, 64, 20000, 32)
    knn = ShardedKNN(db, k=10, mesh=_logical_mesh(cuda_device, (1, 4)))
    counts = {fn: dict(fn.launches) for fn in (
        ck.binned_select, ck.stream_select, ck.fused_select)}
    _, i, _ = knn.search_certified(q, precision="pq", pq_ncodes=64,
                                   batch_size=32)
    for fn, before in counts.items():
        for arm, n in fn.launches.items():
            want = 4 * 2 if (fn, arm) == (ck.binned_select, "pq") else 0
            assert n == before[arm] + want
    one = ShardedKNN(db, k=10, device=cuda_device)
    _, ri, _ = one.search_certified(q, precision="pq", pq_ncodes=64,
                                    batch_size=32)
    np.testing.assert_array_equal(i, ri)
    sub = knn._distinct_shards()[1]
    entry = sub._pq_placement(None, 64)
    assert sub._n_valid == 5000 and entry["parts"][0].shape[0] == 16384
    args = (ck.pq_luts(torch.from_numpy(q).to(cuda_device), entry["books"]),
            *entry["parts"])
    for grid in ("query_major", "db_major"):
        kern = ck.binned_select(*args, tile_n=ck.TILE_N, arm="pq",
                                grid_order=grid)
        plain = ck.binned_select_plain(*args, tile_n=ck.TILE_N, arm="pq")
        for a, b in zip(kern, plain):
            assert torch.equal(a, b)
    for a, b in zip(ck.stream_select(*args, tile_n=ck.TILE_N, arm="pq"),
                    ck.binned_select_plain(*args, tile_n=ck.TILE_N,
                                           arm="pq")):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_k11_on_a_mesh_shard_at_the_pipeline_geometry(cuda_device):
    """K11 on one db shard of a (1, 4) logical mesh at the pipeline's batch
    and keep: the plain version's skipped cells, the rest within the
    kernel tolerance."""
    from knn_tpu_torch import ShardedKNN

    rng = np.random.default_rng(92)
    q, db = _data(rng, 128, 40000, 64)
    knn = ShardedKNN(db, k=10, mesh=_logical_mesh(cuda_device, (1, 4)))
    pl = knn._distinct_shards()[2].placement
    qp = ck.pad_queries(torch.from_numpy(q).to(cuda_device))
    n_tiles = pl.th.shape[0] // ck.TILE_N
    seg = ck.kernel_segment_tiles(q.shape[0], n_tiles, cuda_device, "fused")
    kern = ck.fused_select(qp, pl.th, pl.tl, pl.tnorm, tile_n=ck.TILE_N,
                           keep=40, arm="bf16x3")
    plain = ck.fused_select_plain(qp, pl.th, pl.tl, pl.tnorm,
                                  tile_n=ck.TILE_N, keep=40,
                                  block_q=ck.QUERY_BLOCK, seg_tiles=seg,
                                  arm="bf16x3")
    assert torch.equal(ck.skipped_cells(kern[0], n_tiles, ck.QUERY_BLOCK),
                       ck.skipped_cells(plain[0], n_tiles, ck.QUERY_BLOCK))
    kern = [a.cpu().numpy() for a in kern]
    plain = [a.cpu().numpy() for a in plain]
    tol = _tol(q, pl.db_host, kernel=True)
    _assert_scores(kern[0], plain[0], tol)
    _assert_scores(kern[2], plain[2], tol)


@pytest.mark.cuda
def test_cuda_mesh_tier_slots_hold_each_block_once_a_device(cuda_device):
    """The host-RAM tier on a (2, 2) logical mesh of one card, the card
    behind the host: one copy stream and one buffer a slot on the card,
    holding each db shard's block once (its two query shards share it);
    bitwise the resident mesh search on integer rows."""
    from knn_tpu_torch import ShardedKNN
    from knn_tpu_torch.analysis import hbm

    rng = np.random.default_rng(93)
    db, q = _int_rows(rng, 3_000, 32), _int_rows(rng, 40, 32)
    mesh = _logical_mesh(cuda_device, (2, 2))
    tier = ShardedKNN(db, k=5, mesh=mesh,
                      hbm_budget_bytes=hbm.placement_bytes(400, 32))
    made = tier._hosttier_program
    tier._hosttier_program = lambda k: _lagging(made(k))
    d, i = tier.search(q)
    tier._hosttier_program = made
    st = tier.hosttier_stats()
    assert st["segment_rows"] == 400 and st["sweeps"] == 8
    assert len(tier._copy_streams) == 1
    slot_rows = [sum(b.shape[0] for b in s["dev"].values())
                 for s in tier._slots]
    assert slot_rows == [400] * st["depth"]
    assert st["last_search"]["device_buffer_bytes"] == \
        st["depth"] * 400 * 32 * 4
    rd, ri = ShardedKNN(db, k=5, mesh=mesh).search(q)
    assert torch.equal(d, rd) and torch.equal(i, ri)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,precision", [
    ("fused", "bf16x3"), ("tiled", "bf16x3"), ("streaming", "bf16x3"),
    ("tiled", "int8"), ("tiled", "pq")])
def test_cuda_mesh_pipeline_is_bitwise_the_sequential_mesh_call(
        cuda_device, kernel, precision):
    """overlap=True on a (1, 4) logical mesh: the entry once a db shard a
    batch, and (d, i) and the stats bitwise the sequential mesh call's."""
    from knn_tpu_torch import ShardedKNN

    rng = np.random.default_rng(94)
    q, db = _data(rng, 256, 30000, 32)
    if precision == "int8":
        q, db = np.abs(q).astype(np.uint8), np.abs(db).astype(np.uint8)
    knn = ShardedKNN(db, k=10, mesh=_logical_mesh(cuda_device, (1, 4)))
    wrapper = {"tiled": ck.binned_select, "streaming": ck.stream_select,
               "fused": ck.fused_select}[kernel]
    kw = dict(kernel=kernel, precision=precision, batch_size=64,
              pq_ncodes=64)
    outs = []
    for overlap in (False, True):
        before = wrapper.launches[precision]
        outs.append(knn.search_certified(q, overlap=overlap, **kw))
        assert wrapper.launches[precision] == before + 4 * 4
    (d, i, st), (od, oi, ost) = outs
    np.testing.assert_array_equal(od, d)
    np.testing.assert_array_equal(oi, i)
    assert ost.pop("pipeline")["batches"] == 4
    assert ost == st


@pytest.mark.cuda
def test_cuda_autotune_ivf_on_a_logical_mesh_launches_per_probe_group(
        cuda_device):
    """``autotune_ivf(mesh=, selector="pallas")`` on a (1, 4) logical mesh
    of one card: both candidates pass the bitwise gate; every gated and
    timed search launches the IVF pallas selector's coarse kernel once for
    each probe group — ``knn_search_pallas`` over the group's gathered
    block at ``IVFIndex.search_certified``'s default precision, highest
    (K2's tiled entry), on the mesh's first device, as the JAX package
    calls it with no mesh — and no other kernel; the winner's certified
    search on the mesh is bitwise the (1, 1) index's."""
    from knn_tpu_torch.ivf import IVFIndex
    from knn_tpu_torch.tuning import autotune_ivf

    rng = np.random.default_rng(91)
    q, db = _data(rng, 24, 8192, 32)
    mesh = _logical_mesh(cuda_device, (1, 4))
    kw = dict(k=10, ncentroids=16, train_iters=2, seed=0)
    ref = IVFIndex(db, mesh=mesh, **kw)
    groups = {p: ref.search_certified(q, nprobe=p,
                                      selector="pallas")[2]["groups"]
              for p in (16, 4)}
    assert groups[16] == 1 and groups[4] > 1
    counts = {fn: dict(fn.launches) for fn in (
        ck.binned_select, ck.stream_select, ck.fused_select)}
    entry = autotune_ivf(db, q, 10, mesh=mesh, runs=1, selector="pallas",
                         grid=[{"ncentroids": 16, "nprobe": p}
                               for p in (16, 4)],
                         train_iters=2, seed=0)
    assert entry["errors"] == {}
    assert set(entry["timings_ms"]) == {"c16p16", "c16p4"}
    assert all(v is not None for v in entry["timings_ms"].values())
    # the gate's search and one timed run of each candidate
    launched = {(fn.__name__, a): n - counts[fn][a]
                for fn in counts for a, n in fn.launches.items()
                if n != counts[fn][a]}
    assert launched == {("binned_select", "highest"):
                        2 * (groups[16] + groups[4])}
    one = IVFIndex(db, device=cuda_device, **kw)
    p = entry["knobs"]["nprobe"]
    for a, b in zip(ref.search_certified(q, nprobe=p, selector="pallas")[:2],
                    one.search_certified(q, nprobe=p, selector="pallas")[:2]):
        np.testing.assert_array_equal(a, b)


#: one of two processes on cuda:0 (gloo) running a tier on
#: ``global_mesh(1, 4)``, two positions a process: what the spanning
#: tests below hold against the one-process logical mesh
_SPAN_TIER_CHILD = r'''
import json, sys
import numpy as np
import torch

pid, port, what = int(sys.argv[1]), sys.argv[2], sys.argv[3]
from knn_tpu_torch.index import MutableIndex
from knn_tpu_torch.ivf import IVFIndex
from knn_tpu_torch.ops import coarse_knn as ck
from knn_tpu_torch.parallel import multihost

dev = torch.device("cuda", 0)
multihost.initialize(f"localhost:{port}", 2, pid, timeout_s=120,
                     backend="gloo", devices=[dev])
mesh = multihost.global_mesh(1, 4, devices=[dev, dev])
rng = np.random.default_rng(83)
q = (rng.normal(size=(96, 32)) * 10).astype(np.float32)
db = (rng.normal(size=(20000, 32)) * 10).astype(np.float32)
new = (rng.normal(size=(300, 32)) * 10).astype(np.float32)
out = {}


def counts():
    return {f"{fn.__name__}.{a}": n
            for fn in (ck.binned_select, ck.stream_select, ck.fused_select)
            for a, n in fn.launches.items()}


def launched(fn):
    before = counts()
    res = fn()
    after = counts()
    return res, {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}


if what == "mutable":
    idx = MutableIndex(db, k=10, mesh=mesh)
    idx.insert(new, np.arange(10 ** 6, 10 ** 6 + 300))
    idx.delete([5, 77, 10 ** 6 + 3])
    (d, i, _), out["launched"] = launched(
        lambda: idx.search_certified(q, batch_size=48))
    out["d"], out["i"] = d.tolist(), i.tolist()
else:
    ivf = IVFIndex(db[:8192], mesh=mesh, k=10, ncentroids=16, train_iters=2,
                   seed=0)
    for p in (16, 4):
        (d, i, st), got = launched(lambda: ivf.search_certified(
            q[:24], nprobe=p, selector="pallas"))
        out[str(p)] = {"launched": got, "groups": st["groups"],
                       "d": d.tolist(), "i": i.tolist()}
out["foreign"] = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "knn_tpu"))
multihost.shutdown()
print("RESULT " + json.dumps(out), flush=True)
'''


def _spanning_children(tmp_path, what):
    """Two processes of ``_SPAN_TIER_CHILD`` on cuda:0, joined over a free
    local port; their RESULT dicts."""
    import json
    import os
    import socket
    import subprocess
    import sys

    child = tmp_path / "span_tier_child.py"
    child.write_text(_SPAN_TIER_CHILD)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    procs = [subprocess.Popen(
        [sys.executable, str(child), str(p), str(port), what], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for p in range(2)]
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-3000:]
            line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
            results.append(json.loads(line[-1][len("RESULT "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return results


@pytest.mark.cuda
def test_cuda_spanning_mutable_index_launches_k1_per_owned_shard(
        cuda_device, tmp_path):
    """A certified ``MutableIndex`` call on ``global_mesh(1, 4)`` over two
    processes on cuda:0: each process launches K1 once an owned shard a
    batch (2 shards x 2 batches) and no other kernel, and both return the
    one-process (1, 4) logical mesh's ``(d, i)`` bitwise."""
    from knn_tpu_torch.index import MutableIndex

    results = _spanning_children(tmp_path, "mutable")
    rng = np.random.default_rng(83)
    q, db = (rng.normal(size=(96, 32)) * 10).astype(np.float32), \
        (rng.normal(size=(20000, 32)) * 10).astype(np.float32)
    new = (rng.normal(size=(300, 32)) * 10).astype(np.float32)
    ref = MutableIndex(db, k=10, mesh=_logical_mesh(cuda_device, (1, 4)))
    ref.insert(new, np.arange(10 ** 6, 10 ** 6 + 300))
    ref.delete([5, 77, 10 ** 6 + 3])
    d, i, _ = ref.search_certified(q, batch_size=48)
    for r in results:
        assert r["launched"] == {"binned_select.bf16x3": 2 * 2}
        assert r["foreign"] == []
        np.testing.assert_array_equal(np.asarray(r["i"]), i)
        np.testing.assert_array_equal(np.asarray(r["d"]), d)


@pytest.mark.cuda
def test_cuda_spanning_ivf_pallas_launches_k2_per_probe_group(
        cuda_device, tmp_path):
    """IVF's pallas selector on ``global_mesh(1, 4)`` over two processes
    on cuda:0: each process runs ``knn_search_pallas`` over every probe
    group's gathered block on its first device, at the default precision
    highest — K2's tiled entry once a probe group a process, no other
    kernel — and both return the logical mesh's answer bitwise."""
    from knn_tpu_torch.ivf import IVFIndex

    results = _spanning_children(tmp_path, "ivf")
    rng = np.random.default_rng(83)
    q, db = (rng.normal(size=(96, 32)) * 10).astype(np.float32), \
        (rng.normal(size=(20000, 32)) * 10).astype(np.float32)
    ref = IVFIndex(db[:8192], mesh=_logical_mesh(cuda_device, (1, 4)), k=10,
                   ncentroids=16, train_iters=2, seed=0)
    for p in (16, 4):
        d, i, st = ref.search_certified(q[:24], nprobe=p, selector="pallas")
        for r in results:
            got = r[str(p)]
            assert got["groups"] == st["groups"]
            assert got["launched"] == {"binned_select.highest": st["groups"]}
            np.testing.assert_array_equal(np.asarray(got["i"]), i)
            np.testing.assert_array_equal(np.asarray(got["d"]), d)
    assert all(r["foreign"] == [] for r in results)
