"""The port's tiers on a mesh that spans processes (parallel.multihost.
global_mesh): ``segment_search_program``, ``sharded_minmax``,
``train_kmeans``, ``MutableIndex`` with its compaction, ``IVFIndex`` with
its retrain, ``knn_join``, the streams and ``autotune_ivf``.  Real child
processes join a gloo process group on a free local port, make the same
calls with the same arguments, and each drives only its own grid
positions; the children import neither ``jax`` nor ``knn_tpu``.

The parent holds every process's results against each other (equal),
against the port's one-process logical mesh of the same shape
(``make_mesh(..., devices=["cpu"] * n)``: bitwise), against the JAX
package's tier on its one-process mesh of virtual CPU devices (indices)
and against the float64 oracle (indices; certified distances within
1e-12).  A background compaction over processes answers each read from
one epoch in every process (index.tier.AgreedCompaction); its build
issues no collective on the readers' group.  One module fixture a
process count spawns the processes once; the group's timeout is 60 s and
each child's 120 s, so a lost peer fails a test, not the suite.
Shared inputs: ``tests/tiers_mesh_common.py``.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from knn_tpu.index.mutable import MutableIndex as JaxMutableIndex
from knn_tpu.ivf import IVFIndex as JaxIVFIndex
from knn_tpu.parallel.mesh import make_mesh as jax_mesh
from knn_tpu.parallel.sharded import ShardedKNN as JaxShardedKNN
from knn_tpu_torch.index.mutable import MutableIndex
from knn_tpu_torch.ivf import IVFIndex, kmeans
from knn_tpu_torch.join import knn_join
from knn_tpu_torch.parallel.mesh import make_mesh
from knn_tpu_torch.parallel.sharded import (ShardedKNN, segment_search_program,
                                            sharded_minmax,
                                            sharded_normalize_transductive)
from knn_tpu_torch.streaming import streaming_certified_knn, streaming_knn

from tiers_mesh_common import (IVF_KW, K, assert_exact, assert_oracle_d,
                               clustered, join_data, mutable_data, mutate,
                               oracle_ids, survivors)
from test_torch_cuda import empty_default_tune_cache  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the tail threshold of the background compactions: the second insert
#: of ``mutate`` (six rows) trips it
TAIL_ROWS = 6


def seg_data():
    rng = np.random.default_rng(17)
    seg = (rng.random((64, 16)) * 10).astype(np.float32)
    q = (rng.random((13, 16)) * 10).astype(np.float32)
    return seg, q


CHILD = r'''
import json, os, sys, time
import numpy as np
import torch

torch.set_num_threads(1)
pid, n_proc, port, mode, work = (int(sys.argv[1]), int(sys.argv[2]),
                                 sys.argv[3], sys.argv[4], sys.argv[5])
# tests/tiers_mesh_common.py's inputs, copied: that module imports the
# JAX package, which no child imports
K = 5
IVF_KW = dict(k=K, ncentroids=12, nprobe=3, train_iters=2, seed=0)


def mutable_data():
    rng = np.random.default_rng(7)
    db = rng.normal(size=(600, 16)).astype(np.float32) * 20
    q = rng.normal(size=(9, 16)).astype(np.float32) * 20
    new = rng.normal(size=(6, 16)).astype(np.float32) * 20
    return db, q, new


def mutate(idx, new):
    idx.insert(new[:4], np.arange(9000, 9004))
    idx.insert(new[4:], np.arange(9004, 9006))
    idx.delete([3, 250, 599])
    return idx


def clustered(seed=1, n=480, dim=16, centres=12):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(centres, dim)) * 40
    rows = c[rng.integers(0, centres, n)] + rng.normal(size=(n, dim))
    q = c[rng.integers(0, centres, 24)] + rng.normal(size=(24, dim))
    return rows.astype(np.float32), q.astype(np.float32)


def join_data(seed=9, n=400, n_a=70):
    rng = np.random.default_rng(seed)
    db = (rng.random((n, 16)) * 10).astype(np.float32)
    qa = (rng.random((n_a, 16)) * 10).astype(np.float32)
    return db, qa

from knn_tpu_torch.index import MutableIndex
from knn_tpu_torch.ivf import IVFIndex
from knn_tpu_torch.ivf.kmeans import train_kmeans
from knn_tpu_torch.join import knn_join
from knn_tpu_torch.parallel import multihost
from knn_tpu_torch.parallel.collectives import shard
from knn_tpu_torch.parallel.mesh import db_axes
from knn_tpu_torch.parallel.sharded import (ShardedKNN, segment_search_program,
                                            sharded_minmax,
                                            sharded_normalize_transductive)

TAIL_ROWS = 6
out = {}


def tl(x):
    return x.tolist() if hasattr(x, "tolist") else x


def refused(key, fn):
    try:
        fn()
        out[key] = None
    except Exception as e:  # the parent checks the type and the text
        out[key] = [type(e).__name__, str(e)]


def seg_data():
    rng = np.random.default_rng(17)
    seg = (rng.random((64, 16)) * 10).astype(np.float32)
    q = (rng.random((13, 16)) * 10).astype(np.float32)
    return seg, q


def segments(mesh, label):
    seg, q = seg_data()
    prog = segment_search_program(K, mesh=mesh, merge="ring")
    placed = shard(seg, mesh, db_axes(mesh))
    # only this process's positions hold a block
    out[f"{label}/placed_parts"] = [list(p) for p in np.ndindex(
        *mesh.devices.shape) if placed.parts[p] is not None]
    for n_valid in (64, 37, 3):
        d, i = prog(q, seg, n_valid)
        pd, pi = prog(q, placed, n_valid)
        out[f"{label}/segment/{n_valid}"] = [tl(d), tl(i), tl(pd), tl(pi)]
    out[f"{label}/segment_report"] = multihost.last_report()


def mutable_run(mesh, label):
    db, q, new = mutable_data()
    idx = mutate(MutableIndex(db, k=K, reserve=4, mesh=mesh), new)
    d, i, st = idx.search_certified(q)
    sd, si = idx.search(q)
    out[f"{label}/mutable"] = [tl(d), tl(i), st["index"], tl(sd), tl(si)]
    rep = idx.compact()
    d, i, st = idx.search_certified(q)
    sd, si = idx.search(q)
    out[f"{label}/compacted"] = [tl(d), tl(i), st["index"], tl(sd), tl(si),
                                 {k: rep[k] for k in ("epoch", "rows",
                                                      "rows_dropped")}]
    # writes after the compaction, then a second one
    idx.insert(q[:2] + 0.25, [7000, 7001])
    idx.delete([10, 7000])
    d, i, st = idx.search_certified(q)
    idx.compact()
    d2, i2, st2 = idx.search_certified(q)
    out[f"{label}/rewritten"] = [tl(d), tl(i), tl(d2), tl(i2), st2["index"]]


if mode == "lost":
    multihost.initialize(f"localhost:{port}", n_proc, pid, timeout_s=3,
                         backend="gloo", devices=["cpu"])
    db, q, new = mutable_data()
    idx = MutableIndex(db, k=K, reserve=4,
                       mesh=multihost.global_mesh(1, n_proc))
    out["before"] = tl(idx.search_certified(q)[1])
    if pid == 1:  # never arrives at the next read
        time.sleep(12)
    else:
        t0 = time.perf_counter()
        refused("lost", lambda: idx.search_certified(q))
        out["waited_s"] = time.perf_counter() - t0
    print("RESULT " + json.dumps(out), flush=True)
    sys.exit(0)

multihost.initialize(f"localhost:{port}", n_proc, pid, timeout_s=60,
                     backend="gloo", devices=["cpu"])
if n_proc == 4:
    mesh = multihost.global_mesh(2, 2)
    out["mesh"] = [list(p) for p in mesh.local_positions]
    segments(mesh, "2x2")
    mutable_run(mesh, "2x2")
else:
    mesh = multihost.global_mesh(1, 2)
    flat4 = multihost.global_mesh(1, 4, devices=["cpu", "cpu"])
    segments(mesh, "1x2")
    segments(flat4, "1x4")
    # the host axis the process axis: two positions of one process a host
    hmesh = multihost.global_host_mesh(1, 2, 2, devices=["cpu", "cpu"])
    segments(hmesh, "host")
    db, q, new = mutable_data()
    for label, m in (("host", hmesh), ("flat4", flat4)):
        h = MutableIndex(db, k=K, reserve=4, mesh=m, merge="ring",
                         dcn_merge="allgather" if label == "host" else None)
        d, i, _ = h.search_certified(q)
        sd, si = h.search(q)
        out[f"{label}/unwritten"] = [tl(d), tl(i), tl(sd), tl(si)]
    refused("host/insert", lambda: MutableIndex(db, k=K, mesh=hmesh).insert(
        new[:1], [90001]))
    # -- sharded_minmax / the transductive normalize
    rng = np.random.default_rng(3)
    a = (rng.normal(size=(37, 16)) * 5).astype(np.float32)
    b = (rng.normal(size=(5, 16)) * 5).astype(np.float32)
    lo, hi = sharded_minmax([a, b, a[:0]], mesh=flat4)
    na, nb, _ = sharded_normalize_transductive(a, b, None, mesh=mesh)
    out["minmax"] = [tl(lo), tl(hi), tl(na), tl(nb)]
    # -- train_kmeans: every process's centroids
    rows, cq = clustered()
    km = train_kmeans(rows, 12, mesh=mesh, iters=2)
    out["kmeans"] = [tl(km.centroids), tl(km.assign), tl(km.counts),
                     tl(km.residuals), km.iters]
    # -- MutableIndex across writes and compactions, on 1 x 2 and 1 x 4
    mutable_run(mesh, "1x2")
    mutable_run(flat4, "1x4")
    # -- a read across a background compaction: process 1's build lasts
    # 1.5 s longer, so the first read finds it unfinished there
    db, q, new = mutable_data()
    multihost.collective_counts(reset=True)
    bg = MutableIndex(db, k=K, reserve=4, mesh=mesh,
                      compact_tail_rows=TAIL_ROWS)
    build = bg._agreed._build_fn

    def slow_build(cut):
        if pid == 1:
            time.sleep(1.5)
        return build(cut)

    bg._agreed._build_fn = slow_build
    bg.start_compactor()
    mutate(bg, new)
    reads = []
    for pause in (0.0, 3.0, 0.0):
        time.sleep(pause)
        d, i, st = bg.search_certified(q)
        sd, si = bg.search(q)
        reads.append([tl(d), tl(i), st["index"]["epoch"], bg.epoch,
                      tl(sd), tl(si)])
    bg.close()
    out["bg_mutable"] = reads
    out["bg_mutable_collectives"] = multihost.collective_counts(reset=True)
    # -- IVFIndex: both selectors, writes, the retrain on compaction
    rows, cq = clustered(4)
    ivf = IVFIndex(rows, mesh=mesh, **IVF_KW)
    res = {"centroids": tl(ivf._centroids)}
    for sel, kw in (("exact", {}), ("pallas", {"precision": "bf16x3",
                                               "tile_n": 256}),
                    ("pallas_highest", {})):
        d, i, st = ivf.search_certified(
            cq, selector="pallas" if sel.startswith("pallas") else sel, **kw)
        res[sel] = [tl(d), tl(i), st["fallback_queries"], st["groups"]]
    ivf.insert(cq[:2] + 0.5, [7000, 7001])
    ivf.delete([0, 1])
    res["compact"] = {k: v for k, v in ivf.compact().items()
                      if k != "wall_s"}
    res["retrained"] = tl(ivf._centroids)
    d, i, _ = ivf.search_certified(cq)
    res["after"] = [tl(d), tl(i)]
    out["ivf"] = res
    # IVF's background compaction: the retrain runs k-means searches,
    # which must cross on the compaction group
    multihost.collective_counts(reset=True)
    bgi = IVFIndex(rows, mesh=mesh, compact_tail_rows=2, **IVF_KW)
    ibuild = bgi._agreed._build_fn

    def slow_ibuild(cut):
        if pid == 1:
            time.sleep(1.5)
        return ibuild(cut)

    bgi._agreed._build_fn = slow_ibuild
    bgi.start_compactor(interval_s=0.01)
    bgi.insert(cq[:2] + 0.5, [7000, 7001])
    ireads = []
    for pause in (0.0, 3.0):
        time.sleep(pause)
        d, i, st = bgi.search_certified(cq)
        ireads.append([tl(d), tl(i), st["epoch"], tl(bgi._centroids)])
    bgi.close()
    out["bg_ivf"] = ireads
    out["bg_ivf_collectives"] = multihost.collective_counts(reset=True)
    # -- the joins: resident stream and certified, and an IVF join
    jdb, qa = join_data()
    knn = ShardedKNN(jdb, k=K, mesh=mesh)
    for jmode in ("stream", "certified"):
        d, i, st = knn_join(knn, qa, mode=jmode, superblock_rows=16)
        out[f"join/{jmode}"] = [tl(d), tl(i), st["superblocks"]]
    d, i, _ = knn_join(ivf, cq, mode="certified", superblock_rows=8)
    out["join/ivf"] = [tl(d), tl(i)]
    # -- the streams, each process with a checkpoint directory of its
    # own; the certified stream interrupted at its third segment, then
    # process 1 loses its last finished batch: the resume recomputes it
    from knn_tpu_torch import streaming

    sdir = os.path.join(work, f"stream_p{pid}")
    d, i = streaming.streaming_knn(jdb, qa, K, sdir + "_plain",
                                   batch_size=16, mesh=mesh)
    out["stream"] = [tl(d), tl(i)]
    calls = {"n": 0}
    real = ShardedKNN.search_certified

    def interrupted(self, *a, **kw):
        calls["n"] += 1
        if calls["n"] == 3:
            raise ValueError("interrupted")
        return real(self, *a, **kw)

    ShardedKNN.search_certified = interrupted
    refused("stream_interrupted", lambda: streaming.streaming_certified_knn(
        jdb, qa, K, sdir, segment_size=24, mesh=mesh))
    ShardedKNN.search_certified = real
    before = sorted(f for f in os.listdir(sdir) if f.startswith("batch_"))
    if pid == 1:
        os.remove(os.path.join(sdir, before[-1]))
    seen = []
    real_state = streaming.StreamingSearch.state

    def state(self, n):
        st = real_state(self, n)
        seen.append(list(st.done))
        return st

    streaming.StreamingSearch.state = state
    d, i, st = streaming.streaming_certified_knn(jdb, qa, K, sdir,
                                                 segment_size=24, mesh=mesh)
    streaming.StreamingSearch.state = real_state
    out["cstream"] = [tl(d), tl(i), {k: st[k] for k in ("certified",)},
                      before, seen[0], calls["n"]]
    out["stream_files"] = {
        f: open(os.path.join(sdir + "_plain", f), "rb").read().hex()
        for f in sorted(os.listdir(sdir + "_plain"))}
    out["cstream_files"] = sorted(os.listdir(sdir))
    # -- the IVF tuner under a delay only process 1 pays
    from knn_tpu_torch.tuning import autotune_ivf

    real_search = IVFIndex.search_certified

    def delayed(self, *a, **kw):
        if pid == 1:
            time.sleep(0.05 * (1 + kw.get("nprobe", 1) % 3))
        return real_search(self, *a, **kw)

    IVFIndex.search_certified = delayed
    entry = autotune_ivf(
        rows, cq[:6], K, mesh=mesh, runs=1, train_iters=2,
        grid=[{"ncentroids": 12, "nprobe": p} for p in (3, 12)])
    IVFIndex.search_certified = real_search
    out["tuner"] = entry
    # -- a JAX package's index state (written by the parent) loads into
    # the spanning tiers
    state = np.load(os.path.join(work, "jax_state.npz"))
    sq = state["q"]
    loaded = MutableIndex(state["rows"], state["ids"], k=K, reserve=4,
                          mesh=mesh)
    d, i, _ = loaded.search_certified(sq)
    iv = IVFIndex(state["ivf_rows"], state["ivf_ids"], mesh=mesh, **IVF_KW)
    di, ii, _ = iv.search_certified(sq)
    out["loaded"] = [tl(d), tl(i), tl(di), tl(ii)]
    # -- what stays queued over processes, each by name
    from knn_tpu_torch.serving import ServingEngine

    refused("queued/mutable_serving",
            lambda: MutableIndex(db, k=K, mesh=mesh).serving_engine())
    refused("queued/ivf_serving", lambda: ivf.serving_engine())
    refused("queued/interval_compactor", lambda: MutableIndex(
        db, k=K, mesh=mesh).start_compactor(interval_s=0.1))
    refused("queued/join_serving", lambda: ServingEngine(knn))
out["foreign"] = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "knn_tpu"))
multihost.shutdown()
print("RESULT " + json.dumps(out), flush=True)
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_state(path):
    """The JAX package's tiers after writes and a compaction: their host
    rows and ids, what a spanning tier loads."""
    db, q, new = mutable_data()
    ref = mutate(JaxMutableIndex(db, mesh=jax_mesh(1, 2), k=K, reserve=4),
                 new)
    ref.compact()
    snap = ref._snapshot()
    rows = np.asarray(snap.main._host_train())
    rows_ivf, _ = clustered(4)
    jivf = JaxIVFIndex(rows_ivf, mesh=jax_mesh(1, 2), **IVF_KW)
    jivf.insert(rows_ivf[:2] + 0.5, [7000, 7001])
    jivf.delete([3])
    jivf.compact()
    np.savez(path, rows=rows, ids=np.asarray(snap.base_ids), q=q,
             ivf_rows=np.asarray(jivf._base),
             ivf_ids=np.asarray(jivf._base_ids))


def _spawn(tmp_path, n_proc, mode="main", timeout=120):
    child = tmp_path / "child.py"
    child.write_text(textwrap.dedent(CHILD))
    if mode == "main" and n_proc == 2:
        _jax_state(tmp_path / "jax_state.npz")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, str(child), str(p), str(n_proc), str(port), mode,
         str(tmp_path), REPO],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for p in range(n_proc)]
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-3000:]
            line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
            assert line, err[-3000:]
            results.append(json.loads(line[-1][len("RESULT "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return results


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("gt2"), 2)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("gt4"), 4)


def _logical(*shape):
    return make_mesh(*shape, devices=["cpu"] * int(np.prod(shape)))


def _j(x):
    return json.loads(json.dumps(x))


def _tl(*xs):
    return _j([x.tolist() if hasattr(x, "tolist") else x for x in xs])


# -- every process, one result --------------------------------------------------
def test_every_process_returns_the_same_whole_result(two, four):
    for results in (two, four):
        for key in results[0]:
            if key.endswith(("_report", "placed_parts", "_collectives")) \
                    or key in ("mesh", "stream_interrupted"):
                continue
            if key == "cstream":  # what each process saw on resuming
                for r in results[1:]:
                    assert r[key][:3] == results[0][key][:3]
                continue
            for r in results[1:]:
                assert r[key] == results[0][key], key
        for r in results:
            assert r["foreign"] == []
    # each process placed only its own positions' blocks
    assert two[0]["1x4/placed_parts"] == [[0, 0], [0, 1]]
    assert two[1]["1x4/placed_parts"] == [[0, 2], [0, 3]]
    assert four[3]["2x2/placed_parts"] == [[1, 1]] == [four[3]["mesh"][0]]


# -- segment_search_program -----------------------------------------------------
@pytest.mark.parametrize("label,shape,results", [
    ("1x2", (1, 2), "two"), ("1x4", (1, 4), "two"), ("2x2", (2, 2), "four")])
def test_segment_program_bitwise_the_logical_mesh(label, shape, results,
                                                  request):
    res = request.getfixturevalue(results)[0]
    seg, q = seg_data()
    prog = segment_search_program(K, mesh=_logical(*shape), merge="ring")
    one = segment_search_program(K, device="cpu")
    for n_valid in (64, 37, 3):
        d, i, pd, pi = res[f"{label}/segment/{n_valid}"]
        rd, ri = prog(q, seg, n_valid)
        assert [d, i] == _tl(rd, ri)
        assert [pd, pi] == [d, i]  # a placed segment: the same
        od, oi = one(q, seg, n_valid)
        np.testing.assert_array_equal(np.asarray(i), oi.numpy())
        if n_valid >= K:  # the JAX package's program on its mesh
            jd, ji = _jax_segment(shape, seg, q, n_valid)
            assert_exact(d, i, jd, ji, q, seg[:n_valid], K)
    rep = res[f"{label}/segment_report"]
    assert rep["transport"] == "in_mesh:gloo" and rep["exchanges"] > 0


def test_host_mesh_tiers_bitwise_the_flat_spanning_mesh_and_oracle(two):
    """``global_host_mesh(1, 2, 2)`` (the host axis the process axis; the
    JAX package's host mesh is a reference fault, ROADMAP queue C): the
    segment program and a ``MutableIndex`` bitwise the flat spanning
    ``global_mesh(1, 4)`` and the oracle's indices; writes refused by
    name, as on any host mesh."""
    res = two[0]
    for n_valid in (64, 37, 3):
        assert res[f"host/segment/{n_valid}"] == \
            res[f"1x4/segment/{n_valid}"]
    assert res["host/unwritten"] == res["flat4/unwritten"]
    db, q, _ = mutable_data()
    np.testing.assert_array_equal(np.asarray(res["host/unwritten"][1]),
                                  oracle_ids(db, np.arange(600), q)[1])
    kind, msg = res["host/insert"]
    assert kind == "MutationUnsupportedError" and "multi-host" in msg


def _jax_segment(shape, seg, q, n_valid):
    """The JAX package's segment program on its mesh of ``shape`` (its
    queries padded to the query shards), as its IVF tier calls it."""
    from knn_tpu.parallel.collectives import replicate, shard
    from knn_tpu.parallel.mesh import QUERY_AXIS, db_axes
    from knn_tpu.parallel.sharded import segment_search_program as jseg

    mesh = jax_mesh(*shape)
    qp = np.zeros((-(-q.shape[0] // shape[0]) * shape[0], q.shape[1]),
                  np.float32)
    qp[:q.shape[0]] = q
    d, i = jseg(mesh, K, "l2", merge="ring")(
        shard(qp, mesh, QUERY_AXIS), shard(seg, mesh, db_axes(mesh)),
        replicate(np.asarray([n_valid], np.int32), mesh))
    return np.asarray(d)[:q.shape[0]], np.asarray(i)[:q.shape[0]]


# -- sharded_minmax -------------------------------------------------------------
def test_sharded_minmax_bitwise_one_process(two):
    rng = np.random.default_rng(3)
    a = (rng.normal(size=(37, 16)) * 5).astype(np.float32)
    b = (rng.normal(size=(5, 16)) * 5).astype(np.float32)
    lo, hi = sharded_minmax([a, b, a[:0]], mesh=_logical(1, 4))
    na, nb, _ = sharded_normalize_transductive(a, b, None,
                                               mesh=_logical(1, 2))
    assert two[0]["minmax"] == _tl(lo, hi, na, nb)
    both = np.concatenate([a, b])
    np.testing.assert_array_equal(np.asarray(two[0]["minmax"][0]),
                                  both.min(0))
    np.testing.assert_array_equal(np.asarray(two[0]["minmax"][1]),
                                  both.max(0))


# -- train_kmeans ---------------------------------------------------------------
def test_train_kmeans_same_centroids_in_every_process(two):
    from knn_tpu.ivf import kmeans as jax_kmeans

    rows, _ = clustered()
    got = two[0]["kmeans"]
    assert two[1]["kmeans"][0] == got[0]  # the centroids, bitwise
    ref = kmeans.train_kmeans(rows, 12, mesh=_logical(1, 2), iters=2)
    assert got == _tl(ref.centroids, ref.assign, ref.counts, ref.residuals,
                      ref.iters)
    jref = jax_kmeans.train_kmeans(rows, 12, mesh=jax_mesh(1, 2), iters=2)
    np.testing.assert_array_equal(np.asarray(got[1]), jref.assign)
    np.testing.assert_array_equal(np.asarray(got[0], np.float32),
                                  jref.centroids)


# -- MutableIndex ---------------------------------------------------------------
def _mutable_ref(shape):
    """The same calls on the one-process logical mesh of ``shape``."""
    db, q, new = mutable_data()
    idx = mutate(MutableIndex(db, k=K, reserve=4, mesh=_logical(*shape)),
                 new)
    out = {}
    d, i, st = idx.search_certified(q)
    sd, si = idx.search(q)
    out["mutable"] = _j([d.tolist(), i.tolist(), st["index"],
                         sd.tolist(), si.tolist()])
    rep = idx.compact()
    d, i, st = idx.search_certified(q)
    sd, si = idx.search(q)
    out["compacted"] = _j([d.tolist(), i.tolist(), st["index"], sd.tolist(),
                           si.tolist(), {k: rep[k] for k in
                                         ("epoch", "rows", "rows_dropped")}])
    idx.insert(q[:2] + 0.25, [7000, 7001])
    idx.delete([10, 7000])
    d, i, _ = idx.search_certified(q)
    idx.compact()
    d2, i2, st2 = idx.search_certified(q)
    out["rewritten"] = _j([d.tolist(), i.tolist(), d2.tolist(), i2.tolist(),
                           st2["index"]])
    return out


@pytest.mark.parametrize("label,shape,results", [
    ("1x2", (1, 2), "two"), ("1x4", (1, 4), "two"), ("2x2", (2, 2), "four")])
def test_mutable_index_bitwise_the_logical_mesh_jax_and_oracle(
        label, shape, results, request):
    res = request.getfixturevalue(results)[0]
    ref = _mutable_ref(shape)
    for step in ("mutable", "compacted", "rewritten"):
        assert res[f"{label}/{step}"] == ref[step], step
    db, q, new = mutable_data()
    rows, ids = survivors(db, new)
    od, oi = oracle_ids(rows, ids, q)
    d, i = res[f"{label}/mutable"][:2]
    np.testing.assert_array_equal(np.asarray(i), oi)
    assert_oracle_d(np.asarray(d), od)
    np.testing.assert_array_equal(np.asarray(res[f"{label}/compacted"][1]),
                                  oi)
    jref = mutate(JaxMutableIndex(db, mesh=jax_mesh(*shape), k=K,
                                  reserve=4), new)
    np.testing.assert_array_equal(np.asarray(i), jref.search_certified(q)[1])
    assert res[f"{label}/compacted"][2]["epoch"] == 1
    assert res[f"{label}/rewritten"][4]["epoch"] == 2


def test_background_compaction_reads_one_epoch_everywhere(two):
    """Process 1's build is 1.5 s slower: the first read finds it
    unfinished there, so both processes answer from epoch 0 (process 0's
    finished build waits, staged); after it the build swaps in at the
    same read in both.  Each read is bitwise the direct search of its
    epoch on the logical mesh, and the compactor's thread issued no
    collective at all (a MutableIndex build places rows: none needed)."""
    reads = [r["bg_mutable"] for r in two]
    assert reads[0] == reads[1]
    assert [(x[2], x[3]) for x in reads[0]] == [(0, 0), (1, 1), (1, 1)]
    db, q, new = mutable_data()
    pre = mutate(MutableIndex(db, k=K, reserve=4, mesh=_logical(1, 2)), new)
    want0 = _tl(*pre.search_certified(q)[:2]) + _tl(*pre.search(q))
    pre.compact()
    want1 = _tl(*pre.search_certified(q)[:2]) + _tl(*pre.search(q))
    got = reads[0]
    assert got[0][:2] + got[0][4:] == want0
    assert got[1][:2] + got[1][4:] == want1 == got[2][:2] + got[2][4:]
    for r in two:
        counts = r["bg_mutable_collectives"]
        assert not any(key.startswith("knn-index-compactor|")
                       for key in counts), counts
        assert counts["MainThread|default"] > 0


def test_background_retrain_on_its_own_group(two):
    """IVF's background compaction retrains k-means over processes: its
    collectives all cross on the tier's compaction group, from the
    compactor's thread; the readers' all stay on the default group.  The
    read during the slower build answers from epoch 0 in both, the next
    from epoch 1 with the same centroids in both, bitwise the logical
    mesh's retrain."""
    reads = [r["bg_ivf"] for r in two]
    assert reads[0] == reads[1]
    assert [x[2] for x in reads[0]] == [0, 1]
    rows, cq = clustered(4)
    ref = IVFIndex(rows, mesh=_logical(1, 2), **IVF_KW)
    ref.insert(cq[:2] + 0.5, [7000, 7001])
    want0 = _tl(*ref.search_certified(cq)[:2])
    ref.compact()
    want1 = _tl(*ref.search_certified(cq)[:2])
    assert reads[0][0][:2] == want0 and reads[0][1][:2] == want1
    assert reads[0][1][3] == _j(ref._centroids.tolist())
    for r in two:
        counts = r["bg_ivf_collectives"]
        assert counts.get("ivf-compactor|ivf-compaction", 0) > 0, counts
        assert all(key.split("|")[1] == "ivf-compaction"
                   for key in counts if key.startswith("ivf-compactor|"))
        assert all(key.split("|")[1] == "default"
                   for key in counts if key.startswith("MainThread|"))


# -- IVFIndex -------------------------------------------------------------------
def test_ivf_index_bitwise_the_logical_mesh_jax_and_oracle(two):
    got = two[0]["ivf"]
    rows, cq = clustered(4)
    ref = IVFIndex(rows, mesh=_logical(1, 2), **IVF_KW)
    assert got["centroids"] == _j(ref._centroids.tolist())
    jref = JaxIVFIndex(rows, mesh=jax_mesh(1, 2), **IVF_KW)
    np.testing.assert_array_equal(np.asarray(got["centroids"], np.float32),
                                  jref._centroids)
    od, oi = oracle_ids(rows, np.arange(rows.shape[0]), cq)
    _, ji, _ = jref.search_certified(cq, selector="exact")
    for sel, kw in (("exact", {}), ("pallas", {"precision": "bf16x3",
                                               "tile_n": 256}),
                    ("pallas_highest", {})):
        d, i, st = ref.search_certified(
            cq, selector="pallas" if sel.startswith("pallas") else sel, **kw)
        assert got[sel] == _j([d.tolist(), i.tolist(),
                               st["fallback_queries"], st["groups"]])
        np.testing.assert_array_equal(np.asarray(got[sel][1]), ji)
        np.testing.assert_array_equal(np.asarray(got[sel][1]), oi)
        assert_oracle_d(np.asarray(got[sel][0]), od)
    ref.insert(cq[:2] + 0.5, [7000, 7001])
    ref.delete([0, 1])
    rep = ref.compact()
    assert got["compact"] == _j({k: v for k, v in rep.items()
                                 if k != "wall_s"})
    assert got["retrained"] == _j(ref._centroids.tolist())
    assert two[1]["ivf"]["retrained"] == got["retrained"]
    assert got["after"] == _tl(*ref.search_certified(cq)[:2])
    live = np.concatenate([rows[2:], cq[:2] + 0.5])
    live_ids = np.concatenate([np.arange(2, rows.shape[0]), [7000, 7001]])
    np.testing.assert_array_equal(np.asarray(got["after"][1]),
                                  oracle_ids(live, live_ids, cq)[1])


# -- knn_join -------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["stream", "certified"])
def test_join_bitwise_the_logical_mesh_and_jax(two, mode):
    from knn_tpu.join import knn_join as jax_join

    db, qa = join_data()
    d, i, st = knn_join(ShardedKNN(db, k=K, mesh=_logical(1, 2)), qa,
                        mode=mode, superblock_rows=16)
    assert two[0][f"join/{mode}"] == _j([d.tolist(), i.tolist(),
                                          st["superblocks"]])
    _, ji, _ = jax_join(JaxShardedKNN(db, mesh=jax_mesh(1, 2), k=K), qa,
                        mode=mode, superblock_rows=16)
    sep = np.ones(qa.shape[0], bool)
    if mode == "stream":  # f32 ranks: where the oracle separates k, k+1
        from tiers_mesh_common import _tol
        import oracles

        od = np.sort(oracles.sq_l2(qa, db), axis=-1)[:, :K + 1]
        sep = (np.diff(od, axis=-1) > 2 * _tol(qa, db)).all(-1)
    np.testing.assert_array_equal(np.asarray(two[0][f"join/{mode}"][1])[sep],
                                  np.asarray(ji)[sep])


def test_ivf_join_bitwise_the_logical_mesh(two):
    rows, cq = clustered(4)
    ref = IVFIndex(rows, mesh=_logical(1, 2), **IVF_KW)
    ref.insert(cq[:2] + 0.5, [7000, 7001])
    ref.delete([0, 1])
    ref.compact()
    d, i, _ = knn_join(ref, cq, mode="certified", superblock_rows=8)
    assert two[0]["join/ivf"] == _tl(d, i)
    live = np.concatenate([rows[2:], cq[:2] + 0.5])
    live_ids = np.concatenate([np.arange(2, rows.shape[0]), [7000, 7001]])
    np.testing.assert_array_equal(np.asarray(two[0]["join/ivf"][1]),
                                  oracle_ids(live, live_ids, cq)[1])


# -- the streams ----------------------------------------------------------------
def test_streams_bitwise_the_logical_mesh(two, tmp_path):
    db, qa = join_data()
    d, i = streaming_knn(db, qa, K, str(tmp_path / "s"), batch_size=16,
                         mesh=_logical(1, 2))
    assert two[0]["stream"] == _tl(d, i)
    d, i, st = streaming_certified_knn(db, qa, K, str(tmp_path / "c"),
                                       segment_size=24, mesh=_logical(1, 2))
    assert two[0]["cstream"][:3] == _j([d.tolist(), i.tolist(),
                                        {"certified": st["certified"]}])
    np.testing.assert_array_equal(np.asarray(two[0]["cstream"][1]),
                                  oracle_ids(db, np.arange(db.shape[0]),
                                             qa)[1])
    # the plain stream's files byte-identical to the one-process run's
    # (a certified batch's stats hold its seconds), no temporary left
    files = {f: (tmp_path / "s" / f).read_bytes().hex()
             for f in sorted(os.listdir(tmp_path / "s"))}
    for r in two:
        assert r["stream_files"] == files
        assert r["cstream_files"] == sorted(os.listdir(tmp_path / "c"))


def test_stream_resumes_from_the_batches_every_process_has(two):
    """Interrupted at its third segment (two finished in both), process 1
    then lost its last finished batch: both resume from the one batch
    both hold, so both recompute the same two and run the same
    collectives."""
    for pid, r in enumerate(two):
        kind, msg = r["stream_interrupted"]
        assert kind == "RuntimeError" or "interrupted" in msg
        before, seen, calls = r["cstream"][3:]
        assert before == ["batch_000000.npz", "batch_000001.npz"]
        assert seen == ([0, 1] if pid == 0 else [0])
        # two segments, then the third raised
        assert calls == 3


# -- autotune_ivf ---------------------------------------------------------------
def test_tuner_agrees_under_a_rank_dependent_delay(two):
    from knn_tpu_torch.tuning import autotune_ivf

    a, b = two[0]["tuner"], two[1]["tuner"]
    assert a == b
    assert a["errors"] == {} and a["gate"] == "bitwise-vs-reference"
    assert set(a["timings_ms"]) == {"c12p3", "c12p12"}
    # process 1 slept in every timed run: the group's max is its time
    assert all(v >= 50.0 for v in a["timings_ms"].values())
    # every candidate's gate and stats: the logical mesh's
    rows, cq = clustered(4)
    ref = autotune_ivf(rows, cq[:6], K, mesh=_logical(1, 2), runs=1,
                       train_iters=2,
                       grid=[{"ncentroids": 12, "nprobe": p} for p in (3, 12)])
    assert a["stats_per_candidate"] == _j(ref["stats_per_candidate"])
    for key in ("runs", "n_queries", "selector", "backend"):
        assert a[key] == ref[key], key


# -- state from the JAX package -------------------------------------------------
def test_jax_index_state_loads_into_the_spanning_tiers(two, tmp_path):
    _jax_state(tmp_path / "s.npz")
    st = np.load(tmp_path / "s.npz")
    one = MutableIndex(st["rows"], st["ids"], k=K, reserve=4,
                       mesh=_logical(1, 2))
    iv = IVFIndex(st["ivf_rows"], st["ivf_ids"], mesh=_logical(1, 2),
                  **IVF_KW)
    want = _tl(*one.search_certified(st["q"])[:2]) + \
        _tl(*iv.search_certified(st["q"])[:2])
    assert two[0]["loaded"] == want
    db, q, new = mutable_data()
    rows, ids = survivors(db, new)
    np.testing.assert_array_equal(np.asarray(want[1]),
                                  oracle_ids(rows, ids, q)[1])


# -- refusals and a lost peer ---------------------------------------------------
@pytest.mark.parametrize("name", ["mutable_serving", "ivf_serving",
                                  "join_serving"])
def test_serving_stays_queued_by_name(two, name):
    kind, msg = two[0][f"queued/{name}"]
    assert kind == "ValueError" and "spans processes is queued" in msg
    assert "serving" in msg and "the host-RAM tier" in msg


def test_wall_clock_compactor_refused_by_name(two):
    kind, msg = two[0]["queued/interval_compactor"]
    assert kind == "ValueError" and "interval_s" in msg
    assert "compact_tail_rows" in msg


def test_lost_peer_raises_within_the_group_timeout(tmp_path):
    results = _spawn(tmp_path, 2, mode="lost", timeout=60)
    assert results[0]["before"] == results[1]["before"]
    kind, _ = results[0]["lost"]
    assert kind in ("RuntimeError", "DistBackendError")
    assert 2.5 < results[0]["waited_s"] < 11
