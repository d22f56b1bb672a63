"""The port's multi-process lane (knn_tpu_torch.parallel.multihost): two
child processes, each holding half the rows, join through a
``torch.distributed.TCPStore`` on a free local port and merge their
per-process top-k lists through it (``MultiHostKNN``), as the JAX
package's two-process lane (tests/test_multihost.py:386) merges through
its coordinator's key-value store.  The children import neither ``jax``
nor ``knn_tpu``.

The parent holds their results against the JAX package's single-process
``ShardedKNN`` of the concatenated rows, the port's one-device placement
and the float64 oracle: exact-search indices equal and distances within
1e-5 relative (the JAX lane's rule: the per-process matmul shapes
differ); certified indices equal, and distances bitwise the port's
one-device placement's where neither placement repaired a query, within
RANK_SLACK of the oracle and equal to the JAX package's where both refined
in float64.
"""

import inspect
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from knn_tpu.parallel.mesh import make_mesh as jax_mesh
from knn_tpu.parallel.sharded import ShardedKNN as JaxShardedKNN
from knn_tpu_torch.ops import coarse_knn as ck
from knn_tpu_torch.ops.topk import merge_topk
from knn_tpu_torch.parallel import multihost
from knn_tpu_torch.parallel.crossover import merge_bytes
from knn_tpu_torch.parallel.mesh import make_mesh
from knn_tpu_torch.parallel.sharded import ShardedKNN

import oracles
from test_torch_cuda import empty_default_tune_cache  # noqa: F401 (autouse)
from test_torch_mesh_certified import assert_same_as_one_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, D, NQ = 96, 8, 6


def ties_data():
    """Rows 64-127 are rows 0-63 moved by a few ulps: each query's near
    ties pair a row of process 0 with one of process 1."""
    rng = np.random.default_rng(5)
    base = (rng.random((64, 8)) * 10).astype(np.float32)
    near = base.copy()
    for _ in range(3):
        near = (np.nextafter(near, np.float32(np.inf)) if rng.random() < 0.5
                else np.nextafter(near, np.float32(0)))
    q = base[:20] + rng.normal(size=(20, 8)).astype(np.float32) * 0.5
    return np.concatenate([base, near]), q.astype(np.float32)


CHILD = """
import json, sys, time
import numpy as np
""" + inspect.getsource(ties_data) + """

pid, n_proc, port, log = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])
from knn_tpu_torch import obs
from knn_tpu_torch.parallel import multihost

obs.reset(enabled=True)
obs.reset_event_log(path=log)
multihost.initialize(f"localhost:{port}", n_proc, pid, timeout_s=60)


# the bytes of each exchange, to hold the report's sum against, and every
# exchange's tag, to look for keys left in the store
exchanged, tags = [], []
_exchange = multihost.dcn_allgather_arrays


def counted_exchange(*args, **kwargs):
    lists = _exchange(*args, **kwargs)
    exchanged.append(multihost._LAST_EXCHANGE["bytes"])
    tags.append(kwargs["tag"])
    return lists


multihost.dcn_allgather_arrays = counted_exchange
rng = np.random.default_rng(0)
db = (rng.random((96, 8)) * 10).astype(np.float32)
q = (rng.random((6, 8)) * 10).astype(np.float32)
rows = 96 // n_proc
local = db[pid * rows:(pid + 1) * rows]
out = {}
for k in (3, 7):
    for metric in ("l2", "cosine"):
        prog = multihost.MultiHostKNN(local, k=k, metric=metric,
                                      device="cpu", db_shards=2)
        d, i = prog.search(q)
        out[f"search/{k}/{metric}"] = {"d": d.tolist(), "i": i.tolist()}
for precision in ("highest", "bf16x3", "int8"):
    prog = multihost.MultiHostKNN(local, k=5, device="cpu")
    d, i, st = prog.search_certified(q, selector="pallas", margin=8,
                                     precision=precision)
    out[f"certified/pallas/{precision}"] = {
        "d": d.tolist(), "i": i.tolist(), "per_host": st["per_host"],
        "gap": st["straggler_gap_s"], "host": st["straggler_host"]}
# near ties across the processes: process 1's rows are process 0's moved
# by a few ulps, so a pair's f32 distances may order against float64
tdb, tq = ties_data()
tlocal = tdb[pid * 64:(pid + 1) * 64]
for metric in ("l2", "cosine"):
    prog = multihost.MultiHostKNN(tlocal, k=6, metric=metric, device="cpu")
    exchanged.clear()
    d, i, st = prog.search_certified(tq, margin=8)
    out[f"ties/{metric}"] = {"d": d.tolist(), "i": i.tolist(),
                             "corrected": st["cross_process_rank_corrected"],
                             "exchanged": list(exchanged),
                             "reported": multihost.last_report()[
                                 "exchange_bytes"]}
prog = multihost.MultiHostKNN(local, k=5, device="cpu")
d, i, st = prog.search_certified(q, selector="approx", margin=8)
out["certified/approx"] = {"d": d.tolist(), "i": i.tolist(),
                           "per_host": st["per_host"]}
rep = obs.health.report()
out["health"] = rep["multihost"]
out["health_text"] = [ln for ln in obs.health.render_text(rep).splitlines()
                      if ln.startswith("multihost:")]
snap = obs.snapshot()
out["merge_bytes"] = [s["value"] for s in
                      snap[obs.names.MERGE_BYTES]["series"]
                      if s["labels"]["level"] == "dcn"]
# once every process is here, every exchange has deleted its payloads and
# its barrier's keys
store = multihost._store()
store.add("test/end", 1)
while store.add("test/end", 0) < n_proc:
    time.sleep(0.01)
out["store_keys_left"] = sum(
    store.check([f"knn_tpu/dcn/{tag}/{key}"])
    for tag in tags for key in [*map(str, range(n_proc)), "read",
                                "read/done", "read/left"])
out["exchanges"] = len(tags)
if pid == 0:
    # process 1 is gone: a wait for its list raises within the timeout
    t0 = time.perf_counter()
    try:
        multihost.dcn_allgather_arrays((np.zeros(2),), tag="alone",
                                       timeout_s=2)
        out["timeout"] = None
    except Exception as e:
        out["timeout"] = [type(e).__name__, time.perf_counter() - t0]
out["foreign"] = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "knn_tpu"))
print("RESULT " + json.dumps(out), flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(tmp_path, n_proc=2, timeout=120):
    child = tmp_path / "child.py"
    child.write_text(textwrap.dedent(CHILD))
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, str(child), str(p), str(n_proc), str(port),
         str(tmp_path / f"events{p}.jsonl")],
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


def _data():
    rng = np.random.default_rng(0)
    db = (rng.random((N, D)) * 10).astype(np.float32)
    q = (rng.random((NQ, D)) * 10).astype(np.float32)
    return db, q


@pytest.fixture(scope="module")
def lane(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mh")
    return _spawn(tmp), tmp


def test_two_process_search_matches_jax_and_oracle(lane):
    results, _ = lane
    db, q = _data()
    for key in results[0]:
        if key not in ("health", "health_text", "timeout", "merge_bytes"):
            assert results[0][key] == results[1][key], key
    for k in (3, 7):
        for metric in ("l2", "cosine"):
            got = results[0][f"search/{k}/{metric}"]
            ref_d, ref_i = JaxShardedKNN(db, mesh=jax_mesh(8, 1), k=k,
                                         metric=metric).search(q)
            np.testing.assert_array_equal(np.asarray(got["i"]),
                                          np.asarray(ref_i))
            np.testing.assert_allclose(np.asarray(got["d"], np.float32),
                                       np.asarray(ref_d), rtol=1e-5)
            one_d, one_i = ShardedKNN(db, k=k, metric=metric,
                                      device="cpu").search(q)
            np.testing.assert_array_equal(np.asarray(got["i"]), one_i.numpy())


@pytest.mark.parametrize("precision", ["highest", "bf16x3", "int8"])
def test_two_process_certified_matches_jax_and_one_device(lane, precision):
    results, _ = lane
    db, q = _data()
    got = results[0][f"certified/pallas/{precision}"]
    d, i = np.asarray(got["d"]), np.asarray(got["i"])
    od = oracles.sq_l2(q, db)
    oi = np.lexsort((np.broadcast_to(np.arange(N), od.shape), od),
                    axis=-1)[:, :5]
    np.testing.assert_array_equal(i, oi)
    np.testing.assert_allclose(d, np.take_along_axis(od, oi, -1),
                               rtol=ck.RANK_SLACK, atol=1e-12)
    jd, ji, _ = JaxShardedKNN(db, mesh=jax_mesh(8, 1), k=5).search_certified(
        q, selector="pallas", margin=8, precision=precision)
    np.testing.assert_array_equal(i, ji)
    jd = np.asarray(jd)
    both = (d != d.astype(np.float32)) & (jd != jd.astype(np.float32))
    np.testing.assert_array_equal(d[both], jd[both])
    rd, ri, rst = ShardedKNN(db, k=5, device="cpu").search_certified(
        q, margin=8, precision=precision)
    assert_same_as_one_device(
        d, i, rd, ri, none_repaired=sum(
            got["per_host"]["fallback_queries"]) == rst["fallback_queries"]
        == 0)
    assert len(got["per_host"]["walls_s"]) == 2 and got["gap"] >= 0
    assert got["per_host"]["certified"][0] + \
        got["per_host"]["fallback_queries"][0] == NQ


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_two_process_near_ties_across_processes_are_exact(lane, metric):
    """Rows of process 1 a few ulps off process 0's: the merged list's
    cross-process near ties are re-ranked in float64, so the result is the
    exact lexicographic top-k, bitwise the one-device placement's."""
    from knn_tpu_torch.convert import row_normalize_f64

    results, _ = lane
    db, q = ties_data()
    got = results[0][f"ties/{metric}"]
    d, i = np.asarray(got["d"]), np.asarray(got["i"])
    a, b = ((row_normalize_f64(q), row_normalize_f64(db)) if metric ==
            "cosine" else (q, db))
    od = oracles.sq_l2(a, b)
    oi = np.lexsort((np.broadcast_to(np.arange(db.shape[0]), od.shape), od),
                    axis=-1)[:, :6]
    np.testing.assert_array_equal(i, oi)
    rd, ri, rst = ShardedKNN(db, k=6, metric=metric,
                             device="cpu").search_certified(q, margin=8)
    np.testing.assert_array_equal(i, ri)
    assert rst["fallback_queries"] == 0
    np.testing.assert_array_equal(d, rd)
    assert got["corrected"] > 0
    # the report covers both exchanges: the lists and the tie scores
    assert len(got["exchanged"]) == 2
    assert got["reported"] == sum(got["exchanged"])


def test_two_process_counted_selector_bitwise_jax(lane):
    results, _ = lane
    db, q = _data()
    got = results[0]["certified/approx"]
    jd, ji, _ = JaxShardedKNN(db, mesh=jax_mesh(8, 1), k=5).search_certified(
        q, selector="approx", margin=8)
    np.testing.assert_array_equal(np.asarray(got["i"]), ji)
    np.testing.assert_array_equal(np.asarray(got["d"]), jd)


def test_two_process_report_health_waterfalls_and_imports(lane):
    from knn_tpu_torch.obs.waterfall import stitch_multihost

    results, tmp = lane
    for r in results:
        h = r["health"]
        assert h["hosts"] == 2 and h["transport"] == "kv"
        assert h["dcn_merge"] == "allgather"
        assert h["dcn_merge_bytes"] == merge_bytes(NQ, 5, 2, "allgather")
        assert h["exchange_bytes"] > 0 and h["exchange_s"] >= 0
        assert r["health_text"][0].startswith("multihost: 2 host(s) [kv]")
        # every merge of the run: 4 searches (k 3 and 7), 4 certified,
        # 2 near-tie certified (20 queries, k 6)
        assert r["merge_bytes"] == [
            merge_bytes(NQ, 3, 2, "allgather") * 2
            + merge_bytes(NQ, 7, 2, "allgather") * 2
            + merge_bytes(NQ, 5, 2, "allgather") * 4
            + merge_bytes(20, 6, 2, "allgather") * 2]
        assert r["foreign"] == []
        # 4 searches, 3 certified, 1 approx, and 2 near-tie certified
        # searches of two exchanges each
        assert r["store_keys_left"] == 0 and r["exchanges"] == 12
    kind, waited = results[0]["timeout"]
    assert "Error" in kind and waited < 30
    events = []
    for p in (0, 1):
        with open(tmp / f"events{p}.jsonl") as f:
            events += [json.loads(ln) for ln in f if ln.strip()]
    stitched = stitch_multihost(events)
    assert len(stitched) == 10  # one cross-host waterfall per request
    for wf in stitched.values():
        assert wf["kind"] == "multihost"
        names = [s["name"] for s in wf["segments"]]
        assert "host0.local" in names and "dcn_merge" in names


def test_single_process_degenerates_and_refusals(tmp_path):
    db, q = _data()
    prog = multihost.MultiHostKNN(db, k=6, db_shards=2, device="cpu")
    d, i = prog.search(q)
    rd, ri = ShardedKNN(db, mesh=make_mesh(1, 2, devices=["cpu"] * 2),
                        k=6).search(q)
    np.testing.assert_array_equal(i, ri.numpy())
    np.testing.assert_array_equal(d, rd.numpy())
    rep = multihost.last_report()
    assert rep["hosts"] == 1 and rep["transport"] == "local"
    cd, ci, st = prog.search_certified(q, margin=8)
    np.testing.assert_array_equal(
        ci, ShardedKNN(db, k=6, device="cpu").search_certified(q, margin=8)[1])
    assert "per_host" not in st
    assert multihost.process_count() == 1
    assert multihost.process_row_slice(96) == slice(0, 96)
    multihost.initialize()  # one process: a no-op
    assert multihost.dcn_allgather_arrays((q,), tag="t")[0][0] is not None
    placed = multihost.shard_across_hosts(
        db, make_mesh(1, 2, devices=["cpu"] * 2))
    assert placed.n_blocks == 2
    from knn_tpu_torch.index.artifact import MutationUnsupportedError

    with pytest.raises(MutationUnsupportedError):
        prog.insert(db[:1])
    with pytest.raises(MutationUnsupportedError):
        prog.delete([0])
    with pytest.raises(ValueError, match="return_distances=False"):
        prog.search_certified(q, return_distances=False)
    with pytest.raises(ValueError, match="pad every process"):
        multihost.MultiHostKNN(db, k=6, n_local=5, device="cpu")


def test_cross_process_mesh_is_refused_by_name(monkeypatch):
    """The in-mesh path across processes now runs (test_torch_global_mesh
    drives it with real processes): with two processes' published devices
    ``global_mesh`` spans them and ``shard_across_hosts`` places this
    process's rows on its own position, the other remote; the store
    replica still refuses a ring by name, and points at the mesh."""
    monkeypatch.setitem(multihost._STATE, "process_count", 2)
    monkeypatch.setitem(multihost._STATE, "process_index", 0)
    monkeypatch.setitem(multihost._STATE, "devices", [["cpu"], ["cpu"]])
    mesh = multihost.global_mesh(1, 2)
    assert mesh.spans_processes and mesh.local_positions == [(0, 0)]
    placed = multihost.shard_across_hosts(np.ones((4, 2)), mesh)
    assert placed.shape == (8, 2) and placed.parts[0, 1] is None
    assert placed.block(0).shape == (4, 2)
    with pytest.raises(ValueError, match="lies on process"):
        placed.block(1)
    with pytest.raises(ValueError, match="multiple of process_count"):
        multihost.shard_across_hosts(np.ones((4, 2)), multihost.global_mesh(
            2, 1))
    with pytest.raises(ValueError, match="runs in the mesh"):
        multihost.MultiHostKNN(np.ones((4, 2), np.float32), k=1,
                               device="cpu", dcn_merge="ring")
    with pytest.raises(RuntimeError, match="no store"):
        multihost.dcn_allgather_arrays((np.ones(2),), tag="x")
    assert multihost.process_row_slice(8) == slice(0, 4)


def test_merge_topk_host_is_the_device_merge():
    rng = np.random.default_rng(1)
    d1 = np.sort(rng.random((5, 4)).astype(np.float32), axis=1)
    d2 = np.sort(rng.random((5, 4)).astype(np.float32), axis=1)
    d2[:, 0] = d1[:, 1]  # a tie across the lists: the lower index wins
    i1 = rng.integers(0, 50, (5, 4)).astype(np.int64)
    i2 = rng.integers(50, 100, (5, 4)).astype(np.int64)
    hd, hi = multihost.merge_topk_host([d1, d2], [i1, i2], 4)
    dd, di = merge_topk(torch.from_numpy(d1), torch.from_numpy(i1),
                        torch.from_numpy(d2), torch.from_numpy(i2), 4)
    np.testing.assert_array_equal(hd, dd.numpy())
    np.testing.assert_array_equal(hi, di.numpy())
