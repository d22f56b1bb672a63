"""The port's micro-batching queue and admission control
(knn_tpu_torch.serving.queue / .admission) against the JAX package's
(knn_tpu.serving) — the rules of tests/test_admission.py that need no obs.

No test here asserts a wall time.  The queue's threads are driven by a
gated fake engine (its ``submit`` blocks on an event the test opens), the
controller by the clock it takes as an argument (``now``), and waits are
event waits with generous timeouts.  Results through a real engine are
BITWISE the engine's own dispatch of the same coalesced batch (and the
port's ``ShardedKNN.search`` of its padded rows); decisions and
``stats()`` of the controller equal the JAX controller's on the same
inputs.
"""

import threading
import time

import numpy as np
import pytest

from knn_tpu import obs
from knn_tpu.serving import AdmissionConfig as JaxConfig
from knn_tpu.serving import AdmissionController as JaxController
from knn_tpu.serving import QueryQueue as JaxQueue
from knn_tpu.serving import admission as jax_admission
from knn_tpu_torch import ShardedKNN
from knn_tpu_torch.serving import (AdmissionConfig, AdmissionController,
                                   AdmissionError, DeadlineError, QueryQueue,
                                   QueueFullError, QuotaExceededError,
                                   ServingEngine, bucket_for)
from knn_tpu_torch.serving import admission

from test_torch_cuda import empty_default_tune_cache  # noqa: F401 (autouse)

K = 7
DIM = 12
BUCKETS = (8, 16, 32)
ROW = np.zeros((1, DIM), np.float32)
WAIT = 60.0  # seconds an event wait may take before the test fails


@pytest.fixture(scope="module", autouse=True)
def _obs_off():
    obs.reset(enabled=False)
    yield
    obs.reset()


class _Handle:
    trace_id = None

    def __init__(self, n, fail=None):
        self._n, self._fail = n, fail

    def result(self):
        if self._fail is not None:
            raise self._fail
        return (np.full((self._n, K), float(self._n), np.float32),
                np.zeros((self._n, K), np.int64))


class _GatedEngine:
    """QueryQueue-facing engine stub: ``submit`` records the batch size,
    sets ``entered`` and blocks until ``gate`` is open."""

    buckets = BUCKETS
    _dim = DIM

    def __init__(self, open_gate=True, fail=None):
        self.gate = threading.Event()
        if open_gate:
            self.gate.set()
        self.entered = threading.Event()
        self.sizes = []
        self.fail = fail

    def submit(self, cat, op="search"):
        self.sizes.append(int(cat.shape[0]))
        self.entered.set()
        assert self.gate.wait(WAIT)
        return _Handle(cat.shape[0], self.fail)

    def stats(self):
        return {"fake": True}


def _wait_until(pred):
    t0 = time.monotonic()
    while not pred():
        assert time.monotonic() - t0 < WAIT
        time.sleep(0.005)


@pytest.fixture(scope="module")
def served():
    rng = np.random.default_rng(5)
    db = (rng.random((400, DIM)) * 10).astype(np.float32)
    q = (rng.random((64, DIM)) * 10).astype(np.float32)
    labels = rng.integers(0, 3, 400).astype(np.int32)
    prog = ShardedKNN(db, k=K, labels=labels, num_classes=3, device="cpu")
    engine = ServingEngine(prog, buckets=BUCKETS)
    engine.warmup()
    return prog, engine, q


# -- exact scatter through a real engine -----------------------------------
def test_queue_coalesces_and_scatters_exactly(served):
    prog, engine, q = served
    qq = QueryQueue(engine, max_wait_ms=600_000.0)  # only close() flushes
    futs = [qq.submit(q[3 * j: 3 * j + 3]) for j in range(6)]
    qq.close()
    results = [f.result(timeout=WAIT) for f in futs]
    st = qq.stats()
    assert (st["requests"], st["dispatches"], st["coalesced_rows"]) == (
        6, 1, 18)
    assert st["latency_ms"]["count"] == 6
    d_b, i_b = engine.submit(q[:18]).result()
    d_p, i_p = (t.numpy()[:18] for t in prog.search(
        np.concatenate([q[:18], np.zeros((14, DIM), np.float32)])))
    for j, (d, i) in enumerate(results):
        np.testing.assert_array_equal(d, d_b[3 * j: 3 * j + 3])
        np.testing.assert_array_equal(i, i_b[3 * j: 3 * j + 3])
        np.testing.assert_array_equal(d, d_p[3 * j: 3 * j + 3])
        np.testing.assert_array_equal(i, i_p[3 * j: 3 * j + 3])


def test_batches_are_the_fifo_cut_at_max_rows_as_in_jax():
    """With everything queued before the first batch is due, both queues
    cut the same batches: whole requests, FIFO, stopping at the first
    request that would overflow max_rows."""
    rng = np.random.default_rng(6)
    sizes = rng.integers(1, 12, 40)
    cuts = {}
    for name, cls in (("port", QueryQueue), ("jax", JaxQueue)):
        eng = _GatedEngine()
        qq = cls(eng, max_wait_ms=600_000.0)
        futs = [qq.submit(np.zeros((int(s), DIM), np.float32))
                for s in sizes]
        qq.close()
        for f, s in zip(futs, sizes):
            assert f.result(timeout=WAIT)[0].shape == (s, K)
        cuts[name] = eng.sizes
    assert cuts["port"] == cuts["jax"]
    assert sum(cuts["port"]) == sizes.sum() and max(cuts["port"]) <= 32


def test_queue_zero_wait_still_exact(served):
    prog, engine, q = served
    with QueryQueue(engine, max_wait_ms=0.0) as qq:
        futs = [qq.submit(q[n: n + 2]) for n in range(0, 12, 2)]
        for n, f in zip(range(0, 12, 2), futs):
            _, i = f.result(timeout=WAIT)
            np.testing.assert_array_equal(i, prog.search(q[n: n + 2])[1])
        assert qq.stats()["dispatches"] >= 1


def test_queue_close_flushes_pending(served):
    _, engine, q = served
    qq = QueryQueue(engine, max_wait_ms=600_000.0)
    fut = qq.submit(q[:4])
    qq.close()
    d, i = fut.result(timeout=5)
    assert i.shape == (4, K)
    with pytest.raises(RuntimeError, match="closed"):
        qq.submit(q[:2])
    qq.close()  # idempotent


def test_queue_predict_op(served):
    prog, engine, q = served
    qq = QueryQueue(engine, max_wait_ms=600_000.0, op="predict")
    futs = [qq.submit(q[5 * j: 5 * j + 5]) for j in range(3)]
    qq.close()
    want = prog.predict(np.concatenate(
        [q[:15], np.zeros((1, DIM), np.float32)])).numpy()
    for j, f in enumerate(futs):
        np.testing.assert_array_equal(f.result(timeout=WAIT),
                                      want[5 * j: 5 * j + 5])


def test_queue_validates_and_survives_bad_requests(served):
    prog, engine, q = served
    with pytest.raises(ValueError, match="max_wait_ms"):
        QueryQueue(engine, max_wait_ms=-1.0)
    with pytest.raises(ValueError, match="unknown op"):
        QueryQueue(engine, op="nope")
    with QueryQueue(engine, max_wait_ms=1.0) as qq:
        with pytest.raises(ValueError, match="queries must be"):
            qq.submit(q[:3, :4])
        with pytest.raises(ValueError, match="deadline_ms"):
            qq.submit(q[:3], deadline_ms=0)
        _, i = qq.submit(q[:3]).result(timeout=WAIT)
    np.testing.assert_array_equal(i, prog.search(q[:3])[1])


def test_engine_failure_resolves_the_batch_and_the_queue_goes_on():
    eng = _GatedEngine(fail=RuntimeError("device gone"))
    with QueryQueue(eng, max_wait_ms=0.0) as qq:
        with pytest.raises(RuntimeError, match="device gone"):
            qq.submit(ROW).result(timeout=WAIT)
        eng.fail = None
        assert qq.submit(ROW).result(timeout=WAIT)[0].shape == (1, K)
        st = qq.stats()
    assert st["errors"] == 1 and st["requests"] == 2


def test_submit_write_needs_a_mutable_engine(served):
    _, engine, q = served
    with QueryQueue(engine, max_wait_ms=1.0) as qq:
        with pytest.raises(ValueError, match="immutable"):
            qq.submit_write("insert", vectors=q[:1], ids=[1])
        assert "writes" not in qq.stats()


# -- bounded depth ----------------------------------------------------------
@pytest.mark.parametrize("queue_cls", [QueryQueue, JaxQueue])
def test_max_depth_bounds_outstanding_work_with_explicit_rejection(
        queue_cls):
    eng = _GatedEngine(open_gate=False)
    with queue_cls(eng, max_wait_ms=0.0, max_depth=2) as q:
        f0 = q.submit(ROW)
        assert eng.entered.wait(WAIT)  # f0 in flight, the batcher held
        f1 = q.submit(ROW)
        with pytest.raises(Exception) as exc:
            q.submit(ROW)
        assert exc.value.reason == "queue_full"
        st = q.stats()["admission"]
        assert st["rejected"] == {"queue_full": 1}
        assert st["admitted"] == 2
        eng.gate.set()
        for f in (f0, f1):
            f.result(timeout=WAIT)
        _wait_until(lambda: q._out_req == 0)
        q.submit(ROW).result(timeout=WAIT)
    if queue_cls is QueryQueue:
        assert isinstance(exc.value, QueueFullError)


def test_default_queue_is_unbounded_and_keeps_its_stats_shape():
    eng = _GatedEngine(open_gate=False)
    qq = QueryQueue(eng, max_wait_ms=0.0)
    futs = [qq.submit(ROW) for _ in range(100)]
    st = qq.stats()
    assert "admission" not in st
    assert set(st) == {"requests", "dispatches", "coalesced_rows",
                       "errors", "latency_ms", "engine"}
    eng.gate.set()
    for f in futs:
        f.result(timeout=WAIT)
    qq.close()
    assert qq.stats()["requests"] == 100


@pytest.mark.parametrize("mode", ["on", "off"])
def test_admission_off_stats_shape_equals_jax(served, mode):
    """The queue's stats keys over a stub engine, and over each package's
    real engine with the engine's own keys (its ``slo`` and
    ``slowest_requests`` sections with telemetry on), telemetry on and
    off in both packages."""
    from knn_tpu.parallel import ShardedKNN as JaxShardedKNN
    from knn_tpu.parallel import make_mesh
    from knn_tpu.serving import ServingEngine as JaxServingEngine
    from knn_tpu_torch import obs as pobs

    prog, _, q = served
    jprog = JaxShardedKNN(prog._host_train(), mesh=make_mesh(1, 1), k=K)
    shapes = []
    try:
        for pkg in (obs, pobs):
            pkg.reset(enabled=mode == "on")
            pkg.reset_slo_engine()
        for cls, engine in ((QueryQueue, ServingEngine(prog,
                                                       buckets=BUCKETS)),
                            (JaxQueue, JaxServingEngine(jprog,
                                                        buckets=BUCKETS))):
            for eng in (_GatedEngine(), engine):
                qq = cls(eng, max_wait_ms=600_000.0)
                qq.submit(q[:5])
                qq.close()
                st = qq.stats()
                shapes.append((set(st), set(st["engine"])))
    finally:
        obs.reset(enabled=False)
        pobs.reset()
    assert shapes[:2] == shapes[2:]
    assert ({"slo", "slowest_requests"} <= shapes[1][1]) == (mode == "on")


def test_conflicting_depth_bounds_raise_and_one_sided_merge():
    eng = _GatedEngine()
    with pytest.raises(ValueError, match="conflicting"):
        QueryQueue(eng, max_depth=4, admission=AdmissionConfig(max_depth=8))
    q = QueryQueue(eng, max_depth=4, admission=AdmissionConfig(shed=True))
    assert q._ctrl.config.max_depth == 4 and q._ctrl.config.shed is True
    q.close()
    q = QueryQueue(eng, max_depth=4, admission=AdmissionConfig(max_depth=4))
    assert q._ctrl.config.max_depth == 4
    q.close()


# -- quotas, deadlines, priorities: the controller on an injected clock ----
def _both(cfg_kw, **ctrl_kw):
    return (AdmissionController(AdmissionConfig(**cfg_kw), **ctrl_kw),
            JaxController(JaxConfig(**cfg_kw), **ctrl_kw))


def _decide(ctrl, **kw):
    try:
        return ("ok", ctrl.admit(**kw))
    except Exception as e:  # noqa: BLE001 - compared by reason and text
        return (e.reason, str(e))


def _same(port, jax, **kw):
    out = _decide(port, **kw)
    assert out == _decide(jax, **kw)
    return out[0]


def test_token_bucket_quota_and_refill_equal_jax():
    port, jax = _both({"quotas": {"a": (10.0, 2.0)}})
    seq = [("a", 0.0), ("a", 0.0), ("a", 0.01), ("b", 0.01), ("a", 0.05),
           ("a", 0.1), ("a", 0.2), ("a", 0.2), ("a", 0.2), ("a", 5.0)]
    got = [_same(port, jax, tenant=t, depth=0, rows=0, deadline_s=None,
                 now=now) for t, now in seq]
    # 10 tokens/s from a full burst of 2: empty at 0.0, one token back
    # at 0.1, then at 0.2, full long after
    assert got == ["ok", "ok", "quota", "ok", "quota", "ok", "ok", "quota",
                   "quota", "ok"]
    assert port.stats() == jax.stats()
    assert port.stats()["per_tenant"]["a"] == {"admitted": 5,
                                               "rejected": 4, "shed": 0}


def test_quota_rejects_over_rate_tenant_through_the_queue():
    cfg = AdmissionConfig(quotas={"a": (0.001, 2.0)})
    with QueryQueue(_GatedEngine(), max_wait_ms=0.0, admission=cfg) as q:
        oks, rejs = 0, 0
        for _ in range(5):
            try:
                q.submit(ROW, tenant="a")
                oks += 1
            except QuotaExceededError as e:
                assert e.reason == "quota" and e.tenant == "a"
                rejs += 1
        assert (oks, rejs) == (2, 3)
        for _ in range(5):
            q.submit(ROW, tenant="b")
        st = q.stats()["admission"]
    assert st["per_tenant"]["a"] == {"admitted": 2, "rejected": 3, "shed": 0}
    assert st["per_tenant"]["b"]["admitted"] == 5


def test_submit_time_shed_uses_the_wait_estimate_as_jax():
    port, jax = _both({"shed": True}, base_wait_s=0.002)
    # no estimator history: never shed on a made-up estimate
    assert _same(port, jax, tenant=None, depth=0, rows=500,
                 deadline_s=0.01, now=0.0) == "ok"
    for c in (port, jax):
        c.observe_service(rows=100, seconds=1.0)  # 10 ms a row
        c.observe_service(rows=50, seconds=1.0)  # EWMA toward 20 ms
        c.observe_service(rows=0, seconds=1.0)  # ignored
    assert port.wait_estimate_s(10) == jax.wait_estimate_s(10)
    assert _same(port, jax, tenant="t", depth=1, rows=500,
                 deadline_s=0.1, now=0.0) == "deadline"
    assert _same(port, jax, tenant="t", depth=1, rows=500,
                 deadline_s=10.0, now=0.0) == "ok"
    assert port.stats() == jax.stats()


def test_deadline_rejection_never_spends_a_quota_token():
    port, jax = _both({"shed": True, "quotas": {"a": (1.0, 1.0)}})
    for c in (port, jax):
        c.observe_service(rows=10, seconds=1.0)  # 100 ms a row
    for _ in range(3):
        assert _same(port, jax, tenant="a", depth=1, rows=100,
                     deadline_s=0.1, now=0.0) == "deadline"
    assert _same(port, jax, tenant="a", depth=0, rows=0, deadline_s=100.0,
                 now=0.0) == "ok"


def test_default_deadline_applies_to_untagged_requests():
    port, jax = _both({"shed": True, "default_deadline_ms": 100.0})
    assert _same(port, jax, tenant=None, depth=0, rows=0, deadline_s=None,
                 now=3.0) == "ok"
    assert port.admit(tenant=None, depth=0, rows=0, deadline_s=None,
                      now=3.0) == pytest.approx(3.1)
    for c in (port, jax):
        c.observe_service(rows=10, seconds=1.0)
    assert _same(port, jax, tenant=None, depth=1, rows=100,
                 deadline_s=None, now=0.0) == "deadline"
    assert port.stats()["rejected"] == {"deadline": 1}


def test_depth_check_comes_first_and_shed_accounting_equals_jax():
    port, jax = _both({"max_depth": 3, "quotas": {"a": (1.0, 1.0)}})
    assert _same(port, jax, tenant="a", depth=3, rows=0, deadline_s=None,
                 now=0.0) == "queue_full"
    assert _same(port, jax, tenant="a", depth=2, rows=0, deadline_s=None,
                 now=0.0) == "ok"  # the token was not spent above
    for c in (port, jax):
        c.record_shed("a")
        c.record_shed(None, "expired")
    assert port.stats() == jax.stats()
    assert port.stats()["shed"] == {"expired": 2}


def test_queued_requests_shed_on_expiry_before_dispatch():
    eng = _GatedEngine(open_gate=False)
    cfg = AdmissionConfig(shed=True)
    with QueryQueue(eng, max_wait_ms=0.0, admission=cfg) as q:
        f0 = q.submit(ROW)
        assert eng.entered.wait(WAIT)  # the batcher holds f0
        f1 = q.submit(ROW, deadline_ms=1.0)
        f2 = q.submit(ROW)  # no deadline: survives the sweep
        deadline = q._pending[0].deadline
        _wait_until(lambda: time.monotonic() > deadline)
        eng.gate.set()
        with pytest.raises(DeadlineError) as exc:
            f1.result(timeout=WAIT)
        assert exc.value.reason == "expired"
        assert f2.result(timeout=WAIT) is not None
        f0.result(timeout=WAIT)
        st = q.stats()
    assert st["admission"]["shed"] == {"expired": 1}
    assert st["errors"] == 0  # a shed is an outcome, not an error


def test_expired_shed_is_delivered_before_the_max_wait():
    """The batcher's sleep is capped by the earliest deadline: a ten-minute
    max-wait does not hold a 50 ms deadline's DeadlineError."""
    cfg = AdmissionConfig(shed=True)
    with QueryQueue(_GatedEngine(), max_wait_ms=600_000.0,
                    admission=cfg) as q:
        fut = q.submit(ROW, deadline_ms=50.0)
        with pytest.raises(DeadlineError):
            fut.result(timeout=WAIT)


def test_aged_priority_ordering_is_starvation_safe_as_in_jax():
    cfg_kw = {"priorities": {"gold": 0, "free": 5}, "aging_s": 0.1}
    orders = {}
    for name, cls, cfg in (("port", QueryQueue, AdmissionConfig(**cfg_kw)),
                           ("jax", JaxQueue, JaxConfig(**cfg_kw))):
        q = cls(_GatedEngine(), max_wait_ms=600_000.0, admission=cfg)
        try:
            q.submit(ROW, tenant="free")
            q.submit(ROW, tenant="gold")
            now = q._pending[1].t_arr
            fresh = [q._pending[i].tenant for i in q._select_indices(now)]
            q._pending[0].t_arr -= 1.0  # free waited a second longer
            aged = [q._pending[i].tenant for i in q._select_indices(now)]
        finally:
            q.close()
        orders[name] = (fresh, aged)
    assert orders["port"] == orders["jax"] == (["gold", "free"],
                                               ["free", "gold"])
    ctrl = AdmissionController(AdmissionConfig(**cfg_kw))
    effs = [ctrl.effective_priority(5, w) for w in (0.0, 0.5, 1.0, 5.0)]
    assert effs == sorted(effs, reverse=True)
    assert ctrl.effective_priority(5, 1.0) < ctrl.effective_priority(0, 0.0)


def test_fifo_without_priorities_and_the_explicit_override():
    q = QueryQueue(_GatedEngine(), max_wait_ms=600_000.0,
                   admission=AdmissionConfig(max_depth=100))
    try:
        for tenant in ("a", "b", "c"):
            q.submit(ROW, tenant=tenant)
        now = time.monotonic()
        assert [q._pending[i].tenant
                for i in q._select_indices(now)] == ["a", "b", "c"]
        q.submit(ROW, tenant="d", priority=-1)
        assert q._pending[q._select_indices(now)[0]].tenant == "d"
    finally:
        q.close()


def test_admission_config_validation_and_parse_quotas_equal_jax():
    for kw in ({"quotas": {"a": (0.0, 1.0)}}, {"quotas": {"a": (1.0, 0.5)}},
               {"aging_s": 0}, {"default_deadline_ms": -1},
               {"max_depth": 0}, {}):
        outs = []
        for cfg in (AdmissionConfig(**kw), JaxConfig(**kw)):
            try:
                cfg.validate()
                outs.append("ok")
            except ValueError as e:
                outs.append(str(e))
        assert outs[0] == outs[1], kw
    for text in ("gold:100:20, free:10", "a:0.5", "", "x", "a:1:2:3"):
        try:
            want = jax_admission.parse_quotas(text)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)[:20]):
                admission.parse_quotas(text)
        else:
            assert admission.parse_quotas(text) == want


def test_no_admission_environment_switch():
    """Divergence: the policy is arguments only (no from_env); the error
    classes and reasons are the reference's."""
    assert not hasattr(AdmissionConfig, "from_env")
    assert not hasattr(admission, "ENV_PREFIX")
    for port, jax in ((QueueFullError, jax_admission.QueueFullError),
                      (QuotaExceededError,
                       jax_admission.QuotaExceededError),
                      (DeadlineError, jax_admission.DeadlineError),
                      (AdmissionError, jax_admission.AdmissionError)):
        assert port.reason == jax.reason
        assert issubclass(port, AdmissionError)
    e = DeadlineError("x", tenant="t", reason="expired")
    assert (e.reason, e.tenant) == ("expired", "t")


def test_bucket_for_is_the_engine_rung(served):
    _, engine, q = served
    assert [bucket_for(engine.buckets, n) for n in (1, 9, 32)] == [8, 16, 32]


def test_stress_many_threads_on_one_engine_and_queue(served):
    """More threads than cores, a short switch interval: concurrent first
    requests build each rung once, every dispatch is counted, every
    future gets exactly its rows, and the queue's outstanding counts
    return to zero."""
    import sys

    prog, _, q = served
    eng = ServingEngine(prog, buckets=BUCKETS)
    n_threads, per = 24, 6
    want = {n: prog.search(np.concatenate(
        [q[:n], np.zeros((bucket_for(BUCKETS, n) - n, DIM), np.float32)]))
        for n in range(1, 33)}
    errors, seen = [], []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with QueryQueue(eng, max_wait_ms=0.5) as qq:
            def work(t):
                try:
                    for j in range(per):
                        n = 1 + (7 * t + j) % 32
                        d, i = eng.search(q[:n])
                        if not np.array_equal(i, want[n][1][:n].numpy()):
                            errors.append(("engine", n))
                        _, qi = qq.submit(q[:n]).result(timeout=WAIT)
                        seen.append((n, qi))
                except BaseException as e:  # noqa: BLE001 - reported below
                    errors.append(e)
                    raise

            threads = [threading.Thread(target=work, args=(t,))
                       for t in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=WAIT)
            assert not any(t.is_alive() for t in threads)
            _wait_until(lambda: qq._out_req == 0 and qq._out_rows == 0)
            qst = qq.stats()
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors[:3]
    assert len(seen) == n_threads * per == qst["requests"]
    for n, qi in seen:
        assert qi.shape == (n, K)
        np.testing.assert_array_equal(qi, prog.search(q[:n])[1].numpy())
    st = eng.stats()
    assert st["compile_count"] == st["executables"] == 3
    assert st["per_bucket_compiles"] == {8: 1, 16: 1, 32: 1}
    assert sum(st["per_bucket_dispatches"].values()) == \
        n_threads * per + qst["dispatches"]
    assert st["requests_total"] == n_threads * per + qst["dispatches"]
