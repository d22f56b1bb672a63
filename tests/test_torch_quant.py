"""The port's int8 (K5) and int4 (K6) arms against the JAX package
(knn_tpu.ops.quantize, knn_tpu.ops.pallas_knn in interpret mode on CPU,
knn_tpu.parallel.sharded) and the float64 oracle.

The int arms are integer exact up to one f32 rounding (the rescale), so
their raw outputs are held bitwise against the Pallas kernel given the
same operand arrays (ROADMAP, parity levels).  On the CPU the wrappers
run the plain versions (binned_select_plain, fused_select_plain).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knn_tpu.ops import pallas_knn as jpk
from knn_tpu.ops import quantize as jqz
from knn_tpu.parallel import sharded as jsh
from knn_tpu.parallel.mesh import make_mesh
from knn_tpu_torch import knn_search_pallas
from knn_tpu_torch.ops import coarse_knn as ck
from knn_tpu_torch.ops import quantize as pqz
from knn_tpu_torch.parallel.sharded import ShardedKNN
from test_torch_cuda import _assert_ci_separated, _assert_scores, _tol

import oracles
from test_torch_cuda import empty_default_tune_cache  # noqa: F401 (autouse)

BIN_W = ck.BIN_W
ARMS = ("int8", "int4")


def _oracle(db, q, k):
    d = oracles.sq_l2(q, db)
    idx = np.lexsort((np.broadcast_to(np.arange(db.shape[0]), d.shape), d),
                     axis=-1)[:, :k]
    return np.take_along_axis(d, idx, axis=-1), idx


def _rows(rng, kind, n, dim):
    if kind == "normal":
        return (rng.normal(size=(n, dim)) * 10).astype(np.float32)
    if kind == "integer":  # exact ties, scales 1 where a row reaches 127
        x = rng.integers(-127, 128, size=(n, dim)).astype(np.float32)
        x[n // 2:] = x[: n - n // 2]
        return x
    x = (rng.normal(size=(n, dim)) * 1e-3).astype(np.float32)
    x[::5] = 0.0  # zero rows: unit scale
    return x


# --- ops/quantize.py ---------------------------------------------------------


@pytest.mark.parametrize("kind", ["normal", "integer", "tiny_and_zero"])
def test_quantize_functions_bitwise_jax(kind):
    rng = np.random.default_rng(len(kind))
    x = _rows(rng, kind, 40, 256)
    xt = torch.from_numpy(x)
    # against the compiled functions: the reference quantizes queries
    # inside jit (kernel prologue, certificate)
    for ours, theirs in ((pqz.quantize_rows, jqz.quantize_rows),
                         (pqz.quantize_rows_int4, jqz.quantize_rows_int4)):
        v, s = ours(xt)
        jv, js = jax.jit(theirs)(jnp.asarray(x))
        assert v.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    # against the numpy functions (the db placement): eager divides
    for ours, ours_t, theirs in (
            (pqz.quantize_rows_np, pqz.quantize_rows, jqz.quantize_rows_np),
            (pqz.quantize_rows_int4_np, pqz.quantize_rows_int4,
             jqz.quantize_rows_int4_np)):
        a, b = ours(x, offset=3.0), theirs(x, offset=3.0)
        np.testing.assert_array_equal(a.values, b.values)
        np.testing.assert_array_equal(a.scales, b.scales)
        assert a.offset == b.offset
        np.testing.assert_array_equal(pqz.dequantize(a), jqz.dequantize(b))
        v, s = ours_t(torch.from_numpy(x) - 3.0, eager=True)
        np.testing.assert_array_equal(v.numpy(), b.values)
        np.testing.assert_array_equal(s.numpy(), b.scales)
    q4 = pqz.quantize_rows_int4_np(x).values
    packed = pqz.pack_nibbles(q4)
    np.testing.assert_array_equal(packed, jqz.pack_nibbles(q4))
    np.testing.assert_array_equal(
        pqz.pack_nibbles_t(torch.from_numpy(q4)).numpy(),
        np.asarray(jqz.pack_nibbles_t(jnp.asarray(q4))))
    np.testing.assert_array_equal(pqz.unpack_nibbles(packed, 256), q4)
    np.testing.assert_array_equal(
        pqz.unpack_nibbles_t(torch.from_numpy(packed)).numpy(), q4)
    # the kernel prologue's unpack, chunk by chunk
    ref = np.concatenate([np.asarray(jpk._unpack_nibble_chunk(
        jnp.asarray(packed[:, c : c + 64]))) for c in (0, 64)], axis=1)
    np.testing.assert_array_equal(
        pqz.unpack_nibbles_t(torch.from_numpy(packed)).numpy(), ref)


def test_bound_stats_and_error_bounds_match_jax():
    rng = np.random.default_rng(1)
    for arm in ARMS:
        for src in ("float", "uint8"):
            if src == "uint8":
                db = rng.integers(0, 256, size=(300, 20), dtype=np.uint8)
                q = rng.integers(0, 256, size=(9, 20)).astype(np.float32)
                if arm == "int4":
                    continue  # bytes do not fit 4 bits: no uint8 shortcut
                ours, theirs = pqz.from_uint8(db), jqz.from_uint8(db)
            else:
                db = (rng.normal(size=(300, 20)) * 10).astype(np.float32)
                q = (rng.normal(size=(9, 20)) * 10).astype(np.float32)
                fn = "quantize_rows_np" if arm == "int8" else \
                    "quantize_rows_int4_np"
                ours, theirs = getattr(pqz, fn)(db), getattr(jqz, fn)(db)
            np.testing.assert_array_equal(ours.values, theirs.values)
            stats = pqz.db_bound_stats(ours, db, chunk=64)
            assert stats == jqz.db_bound_stats(theirs, db, chunk=64)
            # the device twin (the placement's): float64 sums in another
            # order, exact on integer rows
            stats_t, norms = pqz.db_bound_stats_t(
                torch.from_numpy(ours.values), torch.from_numpy(ours.scales),
                torch.from_numpy(db.astype(np.float32)), ours.offset, chunk=64)
            assert stats_t.keys() == stats.keys()
            for key, value in stats.items():
                if src == "uint8":
                    assert stats_t[key] == value
                else:
                    assert stats_t[key] == pytest.approx(value, rel=1e-12)
            np.testing.assert_allclose(
                norms.numpy(),
                ((db.astype(np.float64) - ours.offset) ** 2).sum(-1),
                rtol=2.0 ** -23)
            consts = pqz.bound_consts(stats)
            np.testing.assert_array_equal(consts, jqz.bound_consts(stats))
            np.testing.assert_array_equal(
                pqz.score_error_bound(q, stats, offset=ours.offset),
                jqz.score_error_bound(q, stats, offset=ours.offset))
            q_sh = q - np.float32(ours.offset)
            pn, pe = pqz.score_error_bound_device(torch.from_numpy(q_sh),
                                                  torch.from_numpy(consts))
            jn, je = jax.jit(jqz.score_error_bound_device)(
                jnp.asarray(q_sh), jnp.asarray(consts))
            np.testing.assert_allclose(pn.numpy(), np.asarray(jn), rtol=1e-6)
            np.testing.assert_allclose(pe.numpy(), np.asarray(je), rtol=1e-6)
    assert pqz.from_uint8(np.zeros((2, 3), np.uint8)).offset == 128.0
    with pytest.raises(ValueError, match="uint8"):
        pqz.from_uint8(np.zeros((2, 3), np.float32))


@pytest.mark.parametrize("arm", ARMS)
def test_bound_dominates_observed_kernel_error(arm):
    # tests/test_quantize.py:63 and :170 through the port: ε from the
    # placement statistics dominates |exact shifted score - the plain
    # kernel's f32 score| for every (query, db row)
    rng = np.random.default_rng(7 if arm == "int8" else 8)
    kinds = ("normal", "big", "integer", "uint8", "skewed")
    for trial in range(15):
        kind = kinds[trial % len(kinds)]
        if kind == "uint8" and arm == "int4":
            kind = "normal"
        dim = int(rng.choice([3, 17, 64, 130]))
        n = int(rng.choice([97, 256]))
        if kind == "uint8":
            db = rng.integers(0, 256, size=(n, dim), dtype=np.uint8)
            q = rng.integers(0, 256, size=(5, dim)).astype(np.float32)
            qr = pqz.from_uint8(db)
        else:
            scale = 1000.0 if kind == "big" else 10.0
            db = (rng.normal(size=(n, dim)) * scale).astype(np.float32)
            q = (rng.normal(size=(5, dim)) * scale).astype(np.float32)
            if kind == "integer":
                db, q = np.round(db), np.round(q)
            if kind == "skewed":
                db[:, 0] *= 500
                q[:, -1] *= 500
            qr = (pqz.quantize_rows_np(db) if arm == "int8"
                  else pqz.quantize_rows_int4_np(db))
        stats = pqz.db_bound_stats(qr, db, chunk=50)
        eps = pqz.score_error_bound(q, stats, offset=qr.offset)
        t_sh = db.astype(np.float64) - qr.offset
        norms = torch.from_numpy((t_sh ** 2).sum(-1).astype(np.float32))
        vals = qr.values
        if arm == "int4":
            vals = pqz.pack_nibbles(np.pad(vals, ((0, 0), (0, -dim % 128))))
        t, aux = ck.prepare_db_quant(torch.from_numpy(vals),
                                     torch.from_numpy(qr.scales), norms, 256)
        qi, qsc = ck.quantize_queries(torch.from_numpy(q), qr.offset)
        n_p = t.shape[0]
        cd, ci, _ = ck.binned_select_plain(qi, qsc, t, aux, tile_n=n_p,
                                           arm=arm)
        # every emitted candidate's f32 score against its exact score
        q_sh = q.astype(np.float64) - qr.offset
        s_true = (t_sh ** 2).sum(-1)[None, :] - 2.0 * (q_sh @ t_sh.T)
        real = ci.numpy() < n
        rows = np.where(real, ci.numpy(), 0)
        err = np.where(real, np.abs(cd.numpy() - np.take_along_axis(
            s_true, rows, axis=1)), 0.0)
        assert (err.max(-1) <= eps).all(), (trial, kind, dim)


# --- the plain K5 / K6 against the Pallas kernel -----------------------------


def _quantized_triple(db, arm):
    qr = (jqz.quantize_rows_np(db) if arm == "int8"
          else jqz.quantize_rows_int4_np(db))
    vals = qr.values
    if arm == "int4":
        vals = jqz.pack_nibbles(np.pad(vals, ((0, 0), (0, -db.shape[1] % 128))))
    norms = (db.astype(np.float64) ** 2).sum(-1).astype(np.float32)
    return vals, qr.scales, norms


@pytest.mark.parametrize("arm", ARMS)
@pytest.mark.parametrize("kernel", ["tiled", "streaming", "fused"])
@pytest.mark.parametrize("dim", [24, 300])  # 300 spans 3 dim chunks
def test_plain_int_arms_bitwise_pallas(arm, kernel, dim):
    # integer data with exact ties (tests/test_pallas_streaming.py:170-187)
    # and ragged rows; the same pre-quantized operand arrays for both
    rng = np.random.default_rng(dim + len(kernel))
    db = rng.integers(-100, 101, size=(5 * BIN_W + 60, dim)).astype(np.float32)
    db[:, 0] = 127.0
    db[3 * BIN_W : 3 * BIN_W + 40] = db[:40]
    q = rng.integers(-100, 101, size=(11, dim)).astype(np.float32)
    q[0] = db[0]
    trip = _quantized_triple(db, arm)
    keep = 15 if kernel == "fused" else None
    key = "db_int8" if arm == "int8" else "db_int4"
    ref = jpk._bin_candidates(
        jnp.asarray(q), jnp.asarray(db), block_q=8, tile_n=2 * BIN_W,
        bin_w=BIN_W, survivors=2, precision=arm, interpret=True,
        kernel=kernel, keep=keep, **{key: tuple(jnp.asarray(a) for a in trip)})
    ref = [np.asarray(a)[: q.shape[0]] for a in ref]
    t, aux = ck.prepare_db_quant(*(torch.from_numpy(a) for a in trip),
                                 2 * BIN_W)
    qi, qsc = ck.quantize_queries(torch.from_numpy(q))
    if kernel == "fused":  # at the Pallas kernel's query block
        port = ck.fused_select_plain(qi, qsc, t, aux, tile_n=2 * BIN_W,
                                         keep=keep, block_q=8, arm=arm)
    else:
        fn = ck.stream_select if kernel == "streaming" else ck.binned_select
        before = dict(fn.launches)
        port = fn(qi, qsc, t, aux, tile_n=2 * BIN_W, arm=arm)
        assert fn.launches == before  # CPU: the plain version
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("arm", ARMS)
def test_plain_fused_int_skips_the_cells_pallas_skips(arm):
    rng = np.random.default_rng(0)
    db = rng.normal(size=(6 * BIN_W, 16)).astype(np.float32)
    db[2 * BIN_W:] += 500.0
    q = db[:9] + rng.normal(size=(9, 16)).astype(np.float32) * 1e-2
    trip = _quantized_triple(db, arm)
    key = "db_int8" if arm == "int8" else "db_int4"
    ref = jpk._bin_candidates(
        jnp.asarray(q), jnp.asarray(db), block_q=16, tile_n=2 * BIN_W,
        bin_w=BIN_W, survivors=2, precision=arm, interpret=True,
        kernel="fused", keep=15, **{key: tuple(jnp.asarray(a) for a in trip)})
    ref = [np.asarray(a)[: q.shape[0]] for a in ref]
    t, aux = ck.prepare_db_quant(*(torch.from_numpy(a) for a in trip),
                                 2 * BIN_W)
    qi, qsc = ck.quantize_queries(torch.from_numpy(q))
    port = ck.fused_select_plain(qi, qsc, t, aux, tile_n=2 * BIN_W,
                                     keep=15, block_q=16, arm=arm)
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a.numpy(), b)
    skip = ck.skipped_cells(port[0], 3, 16)
    assert bool(skip[0, 1:].all()) and not bool(skip[0, 0])


@pytest.mark.parametrize("arm", ARMS)
def test_quantize_on_the_fly_matches_pallas(arm):
    # no pre-quantized triple: both sides quantize the padded db; the f32
    # norm sums differ in order across frameworks, so scores within the
    # K1 tolerance and ci equal on separated slots
    rng = np.random.default_rng(5)
    q = (rng.normal(size=(11, 24)) * 10).astype(np.float32)
    db = (rng.normal(size=(5 * BIN_W + 60, 24)) * 10).astype(np.float32)
    ref = jpk._bin_candidates(
        jnp.asarray(q), jnp.asarray(db), block_q=8, tile_n=2 * BIN_W,
        bin_w=BIN_W, survivors=2, precision=arm, interpret=True)
    ref = [np.asarray(a)[: q.shape[0]] for a in ref]
    port = [a.numpy() for a in ck._bin_candidates(
        torch.from_numpy(q), torch.from_numpy(db), tile_n=2 * BIN_W,
        precision=arm)]
    tol = _tol(q, db)
    _assert_scores(port[0], ref[0], tol)
    _assert_scores(port[2], ref[2], tol)
    _assert_ci_separated(ref[0], port[1], ref[1], ref[2], tol)


def test_kernel_tolerance_takes_the_placement_quantization():
    rng = np.random.default_rng(9)
    db = rng.integers(0, 256, size=(200, 16), dtype=np.uint8)
    q = rng.integers(0, 256, size=(5, 16)).astype(np.float32)
    np.testing.assert_allclose(
        ck.kernel_tolerance(q, db, precision="int8",
                            quant=pqz.from_uint8(db)),
        jpk.kernel_tolerance(q, db, precision="int8",
                             quant=jqz.from_uint8(db)), rtol=1e-12)


def test_int_operands_are_checked():
    rng = np.random.default_rng(2)
    db = torch.from_numpy((rng.normal(size=(256, 128)) * 5).astype(np.float32))
    qi, qsc = ck.quantize_queries(db[:4])
    t8, aux = ck.prepare_db_int(db, 256, "int8")
    t4, _ = ck.prepare_db_int(db, 256, "int4")
    assert t8.shape == (256, 128) and t4.shape == (256, 64)
    assert aux.shape == (2, 256) and t4.dtype == torch.uint8
    with pytest.raises(ValueError, match="qsc"):
        ck.binned_select(qi, qsc.double(), t8, aux, tile_n=256, arm="int8")
    with pytest.raises(ValueError, match="packed two per byte"):
        ck.binned_select(qi, qsc, t4[:, :32].contiguous(), aux, tile_n=256,
                         arm="int4")
    with pytest.raises(ValueError, match="aux"):
        ck.stream_select(qi, qsc, t8, aux[:1], tile_n=256, arm="int8")
    with pytest.raises(ValueError, match="multiple of tile_n"):
        ck.fused_select(qi, qsc, t8, aux, tile_n=384, keep=15, arm="int8")
    with pytest.raises(ValueError, match="4 operands"):
        ck.binned_select(qi, qsc, t8, tile_n=256, arm="int8")
    with pytest.raises(ValueError, match="takes a torch.uint8"):
        ck._bin_candidates(db[:4], None, tile_n=256, precision="int4",
                           db_parts=(t8, aux))


def test_padded_query_dims_share_the_certificate_quantization():
    # ROADMAP queue C fault 8: with a uint8 source (offset 128) and dims
    # not a multiple of 128, the reference's kernel prologue quantizes the
    # query with its zero-padded dims shifted to -128 (pallas_knn.py:912,
    # 983), its certificate the unpadded query (sharded.py:2354): two
    # different scales.  The port quantizes one way for both.
    rng = np.random.default_rng(4)
    q = rng.integers(1, 256, size=(6, 24)).astype(np.float32)
    q[:, 0] = 255.0  # max |q - 128| = 127: an exact unit scale
    padded = jpk._pad_axis(jnp.asarray(q), 128, 1) - 128.0
    _, ref_kernel_scale = jax.jit(jqz.quantize_rows)(padded)
    _, ref_cert_scale = jax.jit(jqz.quantize_rows)(jnp.asarray(q) - 128.0)
    assert not np.array_equal(np.asarray(ref_kernel_scale),
                              np.asarray(ref_cert_scale))
    _, port_kernel_scale = ck.quantize_queries(torch.from_numpy(q), 128.0)
    np.testing.assert_array_equal(port_kernel_scale.numpy(),
                                  np.asarray(ref_cert_scale))


# --- end to end --------------------------------------------------------------


def _search_data(src, seed=0):
    rng = np.random.default_rng(seed)
    if src == "uint8":
        db = rng.integers(0, 256, size=(1500, 24), dtype=np.uint8)
        q = rng.integers(0, 256, size=(40, 24)).astype(np.float32)
        db[100:125] = db[99]  # an exact-tie run wider than the window
        q[1] = db[99]
    else:
        db = (rng.normal(size=(1500, 24)) * 10).astype(np.float32)
        q = (rng.normal(size=(40, 24)) * 10).astype(np.float32)
        db[700:720] = db[:20]
    return q, db


@pytest.mark.parametrize("arm", ARMS)
@pytest.mark.parametrize("src", ["float", "uint8"])
def test_search_certified_matches_jax_and_oracle(arm, src):
    q, db = _search_data(src)
    _, oi = _oracle(db.astype(np.float32), q, 5)
    port = ShardedKNN(db, k=5, device="cpu")
    jknn = jsh.ShardedKNN(db, mesh=make_mesh(1, 1), k=5)
    kw = dict(selector="pallas", margin=8, tile_n=256, precision=arm)
    _, ji, jstats = jknn.search_certified(q, **kw)
    out = {}
    for kern in ck.KERNELS:
        d, i, stats = port.search_certified(q, kernel=kern, **kw)
        np.testing.assert_array_equal(i, oi)
        np.testing.assert_array_equal(i, np.asarray(ji))
        assert stats["pallas_knobs"]["precision"] == arm
        assert stats["fallback_queries"] + stats["certified"] == 40
        out[kern] = (d, i, stats)
    for kern in ("streaming", "fused"):
        np.testing.assert_array_equal(out["tiled"][0], out[kern][0])
        np.testing.assert_array_equal(out["tiled"][1], out[kern][1])
    placed = port._quant_placement(arm)
    ref = jknn._int8_cache if arm == "int8" else jknn._int4_cache
    if src == "uint8" and arm == "int8":
        assert placed["offset"] == 128.0 and placed["stats"]["et2_max"] == 0.0
        assert placed["stats"] == ref["stats"]
    else:
        assert placed["offset"] == 0.0
    # the placement, built on the device, holds the reference's operands
    t, aux = placed["parts"]
    n = db.shape[0]
    ref_t = np.asarray(ref["values"])[:n]  # int8: dims not padded there
    np.testing.assert_array_equal(t[:n, : ref_t.shape[1]].numpy(), ref_t)
    assert not bool(t[:, ref_t.shape[1]:].any())
    np.testing.assert_array_equal(aux[1, :n].numpy(),
                                  np.asarray(ref["scales"])[:n])
    np.testing.assert_array_equal(aux[0, :n].numpy(),
                                  np.asarray(ref["norms"])[:n])
    assert bool((aux[0, n:] == ck.PAD_VAL).all())
    np.testing.assert_array_equal(placed["consts"].numpy(),
                                  np.asarray(ref["consts"]))


def test_uint8_placement_keeps_no_view_of_the_callers_rows():
    # the int8 placement is built lazily; bytes the caller changes after
    # construction must not reach it
    q, db = _search_data("uint8", 3)
    _, oi = _oracle(db.astype(np.float32), q, 5)
    port = ShardedKNN(db, k=5, device="cpu")
    assert port.placement.uint8_source
    db[:] = 0
    _, i, _ = port.search_certified(q, selector="pallas", margin=8,
                                    tile_n=256, precision="int8")
    np.testing.assert_array_equal(i, oi)
    assert port._quant_placement("int8")["stats"]["et2_max"] == 0.0


@pytest.mark.parametrize("arm", ARMS)
def test_int_overlap_pipeline_is_bitwise_the_sequential_path(arm):
    q, db = _search_data("uint8", 1)
    port = ShardedKNN(db, k=5, device="cpu")
    kw = dict(selector="pallas", margin=8, tile_n=256, batch_size=8,
              kernel="fused", precision=arm)
    d0, i0, s0 = port.search_certified(q, overlap=False, **kw)
    d1, i1, s1 = port.search_certified(q, overlap=True, **kw)
    np.testing.assert_array_equal(d0, d1)
    np.testing.assert_array_equal(i0, i1)
    assert s1["pipeline"]["batches"] == 5
    _, oi = _oracle(db.astype(np.float32), q, 5)
    np.testing.assert_array_equal(i1, oi)


def test_knn_search_pallas_and_predict_certified_take_the_precision():
    q, db = _search_data("float", 2)
    _, oi = _oracle(db, q, 5)
    labels = (np.arange(db.shape[0]) % 4).astype(np.int32)
    port = ShardedKNN(db, k=5, labels=labels, num_classes=4, device="cpu")
    ref, _ = port.predict_certified(q, margin=8, tile_n=256)
    for arm in ARMS:
        _, i, stats = knn_search_pallas(q, db, 5, tile_n=256, margin=8,
                                        precision=arm, device="cpu")
        np.testing.assert_array_equal(i, oi)
        got, stats = port.predict_certified(q, margin=8, tile_n=256,
                                            precision=arm, kernel="fused")
        np.testing.assert_array_equal(got, ref)
        assert stats["pallas_knobs"]["precision"] == arm


def test_run_job_int8_labels_equal_exact(tmp_path):
    from knn_tpu_torch.cli import args_to_config, build_parser
    from knn_tpu_torch.data.datasets import (make_mnist_like, save_labeled_csv,
                                             save_unlabeled_csv)
    from knn_tpu_torch.pipeline import run_job

    tr, trl, te, _, va, val = make_mnist_like(n_train=600, n_test=40,
                                              n_val=40, dim=32)
    files = {name: str(tmp_path / f"{name}.csv")
             for name in ("train", "test", "val")}
    save_labeled_csv(files["train"], tr, trl)
    save_unlabeled_csv(files["test"], te)
    save_labeled_csv(files["val"], va, val)
    results = {}
    for label, extra in (("exact", ["--mode", "exact"]),
                         ("int8", ["--mode", "certified",
                                   "--pallas-precision", "int8"])):
        argv = ["--train", files["train"], "--test", files["test"],
                "--val", files["val"], "--k", "5", "--device", "cpu",
                *extra, "--out", str(tmp_path / f"out_{label}.csv")]
        results[label] = run_job(args_to_config(
            build_parser().parse_args(argv)))
    np.testing.assert_array_equal(results["int8"].test_labels,
                                  results["exact"].test_labels)
    np.testing.assert_array_equal(results["int8"].val_labels,
                                  results["exact"].val_labels)
    stats = results["int8"].certified_stats
    assert stats["pallas_knobs"]["precision"] == "int8"
    assert stats["fallback_queries"] + stats["certified"] == 80
