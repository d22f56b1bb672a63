"""The port's CUDA kernels on the card, each against its plain PyTorch
version — tests marked ``cuda``, skipped without a GPU.

This file imports neither JAX nor the JAX package, so on a machine with a
card and no JAX it runs on its own::

    python -m pytest --noconftest tests/test_torch_cuda.py -q

The comparison helpers here are shared with tests/test_torch_coarse_knn.py:
f32 scores agree within 64 eps_f32 (||q||^2 + max||t||^2) per query (the
two sum in different orders; for highest, whose two differ only in the
order of each chunk's f64 sum, within (2 nd + 4) u (||q||^2 +
max||t||^2)), ci is equal wherever a bin's values are separated by more
than that, and pad-row scores (~1e35, from PAD_VAL rows) are compared by
class.
"""

import numpy as np
import pytest
import torch

from knn_tpu_torch.ops import coarse_knn as ck

EPS32 = float(np.finfo(np.float32).eps)
U32 = 2.0 ** -24
PAD_SCALE = 1e30


def _data(rng, n_q, n, dim, scale=10.0):
    q = (rng.normal(size=(n_q, dim)) * scale).astype(np.float32)
    db = (rng.normal(size=(n, dim)) * scale).astype(np.float32)
    return q, db


def _tol(q, db, arm="bf16x3"):
    # highest: the kernel and its plain version round each chunk's f64 sum
    # to f32 (the two f64 sums differ far below an ulp, so the roundings by
    # at most one ulp), then add the nd chunks and form s in the same f32
    # order (at most one more ulp each): |Δs| <= (2 nd + 4) u (||q||^2 + M)
    q64, db64 = q.astype(np.float64), db.astype(np.float64)
    scale = (q64 ** 2).sum(-1) + (db64 ** 2).sum(-1).max()
    if arm == "highest":
        return (2 * -(-q.shape[1] // ck.DIM_CHUNK) + 4) * U32 * scale
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
    survivors = ck.SURVIVORS
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
    tol = _tol(q, db)
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
    tol = _tol(q, db)
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

def _int_case(device, arm, n_q, n, dim, tile_n, seed):
    # integer-valued rows with exact ties: duplicated rows across groups of
    # one bin, and uint8-range values at unit scale (int8 via the shift)
    rng = np.random.default_rng(seed)
    db = rng.integers(0, 256, size=(n, dim)).astype(np.float32)
    db[128:160] = db[:32]
    db[256:288] = db[:32]
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
    tol = _tol(q, db, arm)
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
    tol = _tol(q, db, arm)
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
    csrc/binned_select.cuh's worst case for the arm's qt, doubled in s,
    plus the rounding of s.  With ``tile_n = 128`` every tile is one group,
    so every row's score is survivor 0 of its bin."""
    rng = np.random.default_rng(12)
    q = torch.from_numpy(rng.uniform(1.0, 2.0, size=(n_q, dim))
                         .astype(np.float32)).to(device)
    db = torch.from_numpy(rng.uniform(1.0, 2.0, size=(n, dim))
                          .astype(np.float32)).to(device)
    qp = ck.pad_queries(q)
    parts = ck.prepare_db_arm(db, ck.BIN_W, arm)
    nd = qp.shape[1] // ck.DIM_CHUNK
    if arm == "highest":
        pairs = [(qp, parts[0])]
        b_qt = nd * (1 + 2.0 ** -20)
    else:
        qh, ql = ck.split_bf16(qp)
        pairs = [(qh, parts[0]), (qh, parts[1]), (ql, parts[0])]
        b_qt = (3 * ck.DIM_CHUNK + nd) * (1 + 2.0 ** -7)
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
