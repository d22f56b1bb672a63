"""The port's static-analysis suite (knn_tpu_torch.analysis) against the JAX
package's (knn_tpu.analysis) on the same inputs, and its own checkers.

- Framework and ``locked-mutation``: the same fixture sources written
  under a ``knn_tpu/`` root and a ``knn_tpu_torch/`` root (the cases of
  tests/test_analysis.py's framework, suppression and locked-mutation
  tests); both ``run``s give equal findings (checker, path and message
  with the package name swapped, line), equal suppression and stale
  verdicts and equal report shapes.  Exact: these modules do no
  arithmetic.
- ``lockorder``: the scripted sequences of tests/test_analysis.py's
  harness tests through both harnesses (equal edge sets, equal cycles),
  and the hammer over the port's serving stack on the CPU.
- ``switch-lockstep``, ``metric-lockstep`` and ``torch-hygiene``: one
  seeded fixture per rule and its clean twin.
- The gate: the whole suite green on this tree, in process and through
  ``cli lint --json`` (no JAX, no knn_tpu, no CUDA context), and a
  seeded finding of each checker exiting 1.
"""

import json
import os
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest

import knn_tpu.analysis as janalysis
from knn_tpu.analysis import lockorder as jlockorder
from knn_tpu.analysis import switches as jsw
from knn_tpu.analysis.core import CHECKERS as JCHECKERS
from knn_tpu.analysis.core import load_suppressions as jload

import knn_tpu_torch.analysis as analysis
from knn_tpu_torch.analysis import lockorder
from knn_tpu_torch.analysis import switches as sw
from knn_tpu_torch.analysis.core import CHECKERS, load_suppressions

from test_torch_cuda import empty_default_tune_cache  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the JAX checker each port checker stands in for
PORT_OF = {"jax-hygiene": "torch-hygiene"}
FIVE = {"switch-lockstep", "metric-lockstep", "locked-mutation",
        "torch-hygiene", "artifact-lockstep"}


def write_tree(root, files, pkg):
    for rel, text in files.items():
        path = root / rel.format(pkg=pkg)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(text).replace("{pkg}", pkg))


def _norm(findings, port):
    """Findings as comparable tuples: checker (the JAX name of a port
    checker), path and message with the port's package name written as
    the JAX package's, line.  Sorted: the two registries order their
    checkers differently."""
    back = {v: k for k, v in PORT_OF.items()}
    out = []
    for f in findings:
        checker = back.get(f.checker, f.checker) if port else f.checker
        path, msg = f.path, f.message
        if port:
            path = path.replace("knn_tpu_torch", "knn_tpu")
            msg = msg.replace("knn_tpu_torch", "knn_tpu")
            for j, p in PORT_OF.items():
                msg = msg.replace(p, j)
        out.append((checker, path, f.line, msg, f.symbol))
    return sorted(out)


def both(tmp_path, files, checkers, sups=None):
    """Run the JAX and the port suite over the same fixture tree (each
    under its own package root); returns (jax report, port report)."""
    reps = []
    for pkg, run, names in (
            ("knn_tpu", janalysis.run, checkers),
            ("knn_tpu_torch", analysis.run,
             [PORT_OF.get(c, c) for c in checkers])):
        root = tmp_path / pkg
        root.mkdir()
        write_tree(root, files, pkg)
        sup_path = None
        if sups is not None:
            payload = {"suppressions": [
                {**e, **({"checker": PORT_OF.get(e["checker"],
                                                 e["checker"])}
                         if pkg == "knn_tpu_torch" and "checker" in e
                         else {}),
                 **({"path": e["path"].format(pkg=pkg)}
                    if "path" in e else {})}
                for e in sups]}
            sup_path = str(root / "sup.json")
            with open(sup_path, "w") as f:
                json.dump(payload, f)
        reps.append(run(str(root), names=names, suppressions_path=sup_path))
    return reps


def assert_same(jrep, prep):
    assert _norm(prep.findings, True) == _norm(jrep.findings, False)
    assert prep.suppressed == jrep.suppressed
    assert prep.ok == jrep.ok
    jd, pd = jrep.as_dict(), prep.as_dict()
    assert set(pd) == set(jd)
    assert [PORT_OF.get(c, c) for c in jd["checkers"]] == pd["checkers"]
    assert {PORT_OF.get(c, c): n
            for c, n in jd["counts_by_checker"].items()} \
        == pd["counts_by_checker"]
    assert pd["suppressed"] == jd["suppressed"]
    assert [sorted(f) for f in pd["findings"]] == \
        [sorted(f) for f in jd["findings"]]


# --- framework ----------------------------------------------------------
BAD_CLASS = '''
    import threading


    class Box:
        """A shared box.

        Thread-safety: guarded by ``self._lock``.
        """

        def __init__(self):
            self._lock = threading.Lock()
            self._count = 0
            self._items = {}

        def bad(self):
            self._count = 1
            self._count += 1
            self._items["k"] = 2

        def good(self):
            with self._lock:
                self._count = 3
                self._items["k"] = 4

        def helper(self):
            """Bump the count.  Caller holds ``self._lock``."""
            self._count += 1
    '''

GOOD_CLASS = BAD_CLASS.replace('''
        def bad(self):
            self._count = 1
            self._count += 1
            self._items["k"] = 2
''', "")

NESTED_CALLBACK = '''
    import threading


    class Box:
        """Thread-safety: guarded by ``self._lock``."""

        def __init__(self):
            self._lock = threading.Lock()
            self._done = 0

        def submit(self, fut):
            with self._lock:
                def _cb(_fut):
                    self._done += 1
                fut.add_done_callback(_cb)

        def locked_nested(self, fut):
            def _cb(_fut):
                with self._lock:
                    self._done += 1  # takes the lock itself: clean
            fut.add_done_callback(_cb)
    '''

OTHER_STORES = '''
    import threading


    class Box:
        """Thread-safety: guarded by ``self._lock``."""

        def __init__(self):
            self._lock = threading.Lock()
            self._cursor = 0
            self._fh = None

        def bad_loop(self, chunks):
            for self._cursor in chunks:
                pass

        def bad_with(self, path):
            with open(path) as self._fh:
                pass

        def good_loop(self, chunks):
            with self._lock:
                for self._cursor in chunks:
                    pass

        def comp(self, xs):
            return [0 for self._cursor in xs]

        def gone(self):
            del self._fh
    '''

GUARDS_NOTHING = '''
    import threading


    class Empty:
        """Thread-safety: guarded by ``self._lock``."""

        def method(self):
            return 1
    '''

NO_LOCK_NAME = '''
    class Vague:
        """Thread-safety: trust me."""

        def __init__(self):
            self._x = 1
    '''

WRAPPED_MARKER = '''
    import threading


    class Wrapped:
        """A class whose marker wraps.

        Thread-safety: guarded
        by ``self._cond``.
        """

        def __init__(self):
            self._cond = threading.Condition()
            self._n = 0

        def bump(self):
            self._n += 1
    '''

WALL_CLOCK = '''
    import time

    def f():
        return time.time()
    '''

FRAMEWORK_CASES = {
    "syntax_error": ({"{pkg}/broken.py": "def f(:\n"}, ["locked-mutation"],
                     None),
    "text_only_pass_skips_the_parse": (
        {"{pkg}/broken.py": "def f(:\n"}, ["metric-lockstep"], None),
    "report_shape": ({"{pkg}/ok.py": "x = 1\n"}, ["locked-mutation"], None),
    "stale_suppression": (
        {"{pkg}/ok.py": "x = 1\n"}, ["locked-mutation"],
        [{"checker": "locked-mutation", "path": "{pkg}/gone.py",
          "contains": "self._x",
          "justification": "outlived the code it excused"}]),
    "subset_run_keeps_other_checkers_suppressions": (
        {"{pkg}/ok.py": "x = 1\n"}, ["locked-mutation"],
        [{"checker": "jax-hygiene", "path": "{pkg}/obs/trace.py",
          "contains": "time.time",
          "justification": "wall timestamp by contract, never "
                           "differenced"}]),
    "suppression_naming_no_checker_is_stale": (
        {"{pkg}/ok.py": "x = 1\n"}, ["locked-mutation"],
        [{"checker": "no-such-checker", "path": "", "contains": "x",
          "justification": "points at nothing that could ever match"}]),
    "wall_clock_finding": ({"{pkg}/mod.py": WALL_CLOCK}, ["jax-hygiene"],
                           None),
    "matching_suppression_silences_and_counts": (
        {"{pkg}/mod.py": WALL_CLOCK}, ["jax-hygiene"],
        [{"checker": "jax-hygiene", "path": "{pkg}/mod.py",
          "contains": "time.time",
          "justification": "fixture wall timestamp, never differenced"}]),
    "short_justification_is_refused": (
        {"{pkg}/mod.py": WALL_CLOCK}, ["jax-hygiene"],
        [{"checker": "jax-hygiene", "path": "{pkg}/mod.py",
          "contains": "time.time", "justification": "because"}]),
    # locked-mutation
    "unlocked_writes": ({"{pkg}/box.py": BAD_CLASS}, ["locked-mutation"],
                        None),
    "locked_class": ({"{pkg}/box.py": GOOD_CLASS}, ["locked-mutation"],
                     None),
    "nested_callback_write": ({"{pkg}/cb.py": NESTED_CALLBACK},
                              ["locked-mutation"], None),
    "other_store_contexts": ({"{pkg}/stores.py": OTHER_STORES},
                             ["locked-mutation"], None),
    "marker_guarding_nothing": ({"{pkg}/empty.py": GUARDS_NOTHING},
                                ["locked-mutation"], None),
    "marker_without_a_lock_name": ({"{pkg}/vague.py": NO_LOCK_NAME},
                                   ["locked-mutation"], None),
    "wrapped_marker": ({"{pkg}/wrapped.py": WRAPPED_MARKER},
                       ["locked-mutation"], None),
    "single_writer_suppressed": (
        {"{pkg}/box.py": BAD_CLASS}, ["locked-mutation"],
        [{"checker": "locked-mutation", "path": "{pkg}/box.py",
          "contains": "self._count",
          "justification": "fixture: one writer thread by construction"}]),
}


@pytest.mark.parametrize("case", sorted(FRAMEWORK_CASES))
def test_framework_and_locked_mutation_equal_jax(tmp_path, case):
    files, checkers, sups = FRAMEWORK_CASES[case]
    jrep, prep = both(tmp_path, files, checkers, sups)
    assert_same(jrep, prep)
    assert jrep.render_text().replace("jax-hygiene", "torch-hygiene") \
        .split("\n")[0] == prep.render_text().split("\n")[0]


def test_framework_cases_cover_the_verdicts(tmp_path):
    """The parity cases are not vacuous: each rule the lint pins down
    shows in them (a parse failure reported once, a stale entry, a
    refused justification, the three unlocked writes)."""
    def port(case):
        files, checkers, sups = FRAMEWORK_CASES[case]
        sub = tmp_path / case
        sub.mkdir()
        return both(sub, files, checkers, sups)[1]

    rep = port("syntax_error")
    assert [f.checker for f in rep.findings] == ["framework"]
    assert port("text_only_pass_skips_the_parse").ok
    assert any("stale suppression" in f.message
               for f in port("stale_suppression").findings)
    assert port("subset_run_keeps_other_checkers_suppressions").ok
    assert not port("suppression_naming_no_checker_is_stale").ok
    rep = port("matching_suppression_silences_and_counts")
    assert rep.ok and rep.suppressed == 1
    assert any("written justification" in f.message
               for f in port("short_justification_is_refused").findings)
    syms = [f.symbol for f in port("unlocked_writes").findings]
    assert syms == ["Box.bad"] * 3
    assert port("locked_class").ok
    assert [f.symbol for f in port("nested_callback_write").findings] \
        == ["Box.submit"]
    assert sorted(f.symbol for f in port("other_store_contexts").findings) \
        == ["Box.bad_loop", "Box.bad_with", "Box.comp", "Box.gone"]
    assert any("guards nothing" in f.message for f in
               port("marker_guarding_nothing").findings)
    assert any("names no lock" in f.message for f in
               port("marker_without_a_lock_name").findings)
    assert [f.symbol for f in port("wrapped_marker").findings] \
        == ["Wrapped.bump"]
    rep = port("single_writer_suppressed")
    assert rep.suppressed == 2
    assert ["self._items" in f.message for f in rep.findings] == [True]


def test_checker_crash_becomes_a_finding_in_both(tmp_path):
    def boom(ctx):
        raise RuntimeError("kaboom")

    reps = []
    for pkg, registry, run in (("knn_tpu", JCHECKERS, janalysis.run),
                               ("knn_tpu_torch", CHECKERS, analysis.run)):
        root = tmp_path / pkg
        write_tree(root, {"{pkg}/ok.py": "x = 1\n"}, pkg)
        registry["test-boom"] = (boom, "always crashes")
        try:
            reps.append(run(str(root), names=["test-boom"]))
        finally:
            del registry["test-boom"]
    assert_same(*reps)
    assert any("checker crashed: RuntimeError: kaboom" in f.message
               for f in reps[1].findings)


def test_unknown_checker_raises_in_both():
    for run in (janalysis.run, analysis.run):
        with pytest.raises(ValueError, match="unknown checker"):
            run(REPO, names=["no-such-checker"])


@pytest.mark.parametrize("payload", [
    {"suppressions": [{"checker": "x", "path": "a.py", "contains": "y",
                       "justification": "because"}]},
    {"suppressions": [{"checker": "x", "line": 3,
                       "justification": "long enough justification"}]},
    {"suppressions": [{"path": "a.py",
                       "justification": "long enough justification"}]},
    {"suppressions": ["not an object"]},
    {"not-suppressions": []},
    [],
])
def test_load_suppressions_equals_jax(tmp_path, payload):
    path = tmp_path / "sup.json"
    path.write_text(json.dumps(payload))
    (js, je), (ps, pe) = jload(str(path)), load_suppressions(str(path))
    assert [vars(s) for s in ps] == [vars(s) for s in js]
    assert [(e.checker, e.path, e.message) for e in pe] == \
        [(e.checker, e.path, e.message) for e in je]
    assert pe
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert [e.message.split(":")[0] for e in load_suppressions(str(bad))[1]] \
        == [e.message.split(":")[0] for e in jload(str(bad))[1]]


def test_registry_holds_the_five_checkers():
    assert set(CHECKERS) == FIVE
    assert set(JCHECKERS) - set(CHECKERS) == {"jax-hygiene", "vmem-budget"}


# --- lockorder: the scripted sequences through both harnesses ------------
def _inversion(mod):
    rec = mod.LockOrderRecorder()
    a = mod.InstrumentedLock("A", rec)
    b = mod.InstrumentedLock("B", rec)
    t1_done = threading.Event()

    def t1():
        with a:
            with b:
                pass
        t1_done.set()

    def t2():
        t1_done.wait(5)
        with b:
            with a:
                pass

    ts = [threading.Thread(target=t1), threading.Thread(target=t2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return rec


def _consistent(mod):
    rec = mod.LockOrderRecorder()
    a = mod.InstrumentedLock("A", rec)
    b = mod.InstrumentedLock("B", rec)
    c = mod.InstrumentedLock("C", rec, threading.RLock())

    def worker():
        for _ in range(50):
            with a:
                with b:
                    with c:
                        with c:  # re-entrant: no self edge
                            pass
            with a:
                b.acquire()
                c.acquire()
                b.release()  # out of order: B goes before C
                c.release()

    ts = [threading.Thread(target=worker) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return rec


def _three_cycle(mod):
    rec = mod.LockOrderRecorder()
    locks = {n: mod.InstrumentedLock(n, rec) for n in "XYZ"}
    for first, second in (("X", "Y"), ("Y", "Z"), ("Z", "X")):
        with locks[first]:
            with locks[second]:
                pass
    return rec


@pytest.mark.parametrize("scenario", [_inversion, _consistent, _three_cycle])
def test_lockorder_records_the_jax_edges_and_cycles(scenario):
    jrec, prec = scenario(jlockorder), scenario(lockorder)
    assert set(prec.edges()) == set(jrec.edges())
    assert prec.order_graph() == jrec.order_graph()
    assert prec.find_cycle() == jrec.find_cycle()
    errs = []
    for rec in (jrec, prec):
        try:
            rec.assert_acyclic()
            errs.append(None)
        except AssertionError as e:
            errs.append(str(e).split(" (witness")[0])
    assert errs[0] == errs[1]
    if scenario is _consistent:
        assert prec.find_cycle() is None
        assert prec.order_graph()["A"] == {"B", "C"}
        assert prec.seen() == {"A", "B", "C"}
    else:
        cyc = prec.find_cycle()
        assert cyc is not None and cyc[0] == cyc[-1]


def test_instrument_swaps_lock_attrs_as_jax_does():
    class HasLock:
        def __init__(self):
            self._lock = threading.Lock()

    class HasCond:
        def __init__(self):
            self._cond = threading.Condition()

    class HasNeither:
        pass

    for mod in (jlockorder, lockorder):
        rec = mod.LockOrderRecorder()
        a, c = HasLock(), HasCond()
        mod.instrument(rec, a=a, c=c)
        assert isinstance(a._lock, mod.InstrumentedLock)
        assert isinstance(c._cond, mod.InstrumentedLock)
        with pytest.raises(ValueError, match="neither _lock nor _cond"):
            mod.instrument(rec, bad=HasNeither())


def test_instrument_named_attributes_and_conditions():
    """The port's harness also swaps a named attribute (``_launch_lock``,
    ``_tier_lock``), and a Condition works through it: wait releases it
    for the notifier and notify wakes the waiter."""
    rec = lockorder.LockOrderRecorder()

    class Engine:
        def __init__(self):
            self._lock = threading.Lock()
            self._launch_lock = threading.Lock()
            self._cond = threading.Condition()

    e = Engine()
    lockorder.instrument(rec, engine=e, launch=(e, "_launch_lock"),
                         cond=(e, "_cond"))
    assert isinstance(e._launch_lock, lockorder.InstrumentedLock)
    with pytest.raises(ValueError, match="has no _gone"):
        lockorder.instrument(rec, gone=(e, "_gone"))
    woke, flag = [], []
    waiting = threading.Event()

    def waiter():
        with e._cond:
            waiting.set()
            woke.append(e._cond.wait_for(lambda: bool(flag), 5))

    with e._launch_lock:
        with e._lock:
            pass
    t = threading.Thread(target=waiter)
    t.start()
    assert waiting.wait(5)
    with e._cond:  # wait released the condition for the notifier
        flag.append(1)
        e._cond.notify_all()
    t.join(5)
    assert woke == [True]
    assert not e._lock.locked()
    assert set(rec.edges()) == {("launch", "engine")}
    rec.assert_acyclic()


def _cpu_serving_stack(rng, n=512, dim=8, k=4):
    from knn_tpu_torch import ShardedKNN
    from knn_tpu_torch.serving import ServingEngine

    db = (rng.random((n, dim)) * 32).astype(np.float32)
    knn = ShardedKNN(db, k=k, device="cpu")
    eng = ServingEngine(knn, buckets=(8, 16, 32, 64, 128, 256))
    eng.warmup()
    return db, knn, eng


def test_serving_stack_lock_order_acyclic_under_hammer_cpu():
    """The hammer over the port's serving stack on the CPU (chip_smoke's
    ``lock_order_hammer``, the run the card repeats on its CUDA graphs,
    where the engine's _launch_lock is instrumented too; the CPU replays
    no graph and never takes it): the engine's _lock, the queue's _cond
    and its admission controller, the SLO engine, the registry, one
    histogram and the audit sampler at rate 1.0; no thread raises, every
    instrumented lock is taken, edges are recorded, the graph is acyclic
    and every request is bitwise the eager search of its coalesced
    batch; the locks are restored after."""
    import chip_smoke
    from knn_tpu_torch import obs
    from knn_tpu_torch.obs import audit
    from knn_tpu_torch.obs import names as mn
    from knn_tpu_torch.serving import (AdmissionConfig, QueryQueue,
                                       bucket_for)

    rng = np.random.default_rng(5)
    db, knn, eng = _cpu_serving_stack(rng)
    pool = (rng.random((256, 8)) * 32).astype(np.float32)
    obs.reset(enabled=True)
    slo_eng = obs.reset_slo_engine()
    aud = audit.reset_auditor(rate=1.0)

    def eager(cat):
        padded = np.zeros((bucket_for(eng.buckets, cat.shape[0]), 8),
                          np.float32)
        padded[:cat.shape[0]] = cat
        return tuple(t.numpy()[:cat.shape[0]] for t in knn.search(padded))

    raw = eng._lock
    try:
        with QueryQueue(eng, max_wait_ms=1.0, admission=AdmissionConfig(
                max_depth=4096)) as q:
            out = chip_smoke.lock_order_hammer(
                q, eng, pool,
                {"engine": eng, "queue": q, "admission": q._ctrl,
                 "slo": slo_eng,
                 "registry": obs.get_registry(),
                 "latency_hist": obs.histogram(
                     mn.SERVING_REQUEST_LATENCY, op="search"),
                 "audit": aud},
                [eager], calls=(q.stats, slo_eng.evaluate))
        assert aud.drain(timeout=60)
    finally:
        audit.reset_auditor()
        obs.reset_slo_engine()
    assert out["requests"] == 32 and out["edges"] >= 1
    assert {"engine", "queue", "registry"} <= set(out["locks_seen"])
    assert sum(out["batch_rows"]) == sum(1 + (i + j) % 8 for i in range(8)
                                         for j in range(4))
    assert eng._lock is raw and "submit" not in vars(eng)


def test_mutable_frontend_lock_order_acyclic_across_a_compaction_cpu():
    """The same over a MutableServingEngine during one background
    compaction of its writes: the index's _lock and _compact_lock, the
    placement's _engines_lock (a direct search beside the queue takes it)
    and the epoch's engine; each request bitwise the direct search of its
    batch before the swap or after it; then, with the locks still
    instrumented, the compactor starts and reads go through the queue
    until the swap, some of them on the old epoch."""
    import chip_smoke
    from knn_tpu_torch import obs
    from knn_tpu_torch.index import MutableIndex
    from knn_tpu_torch.serving import QueryQueue, bucket_for

    rng = np.random.default_rng(8)
    db = (rng.random((600, 8)) * 32).astype(np.float32)
    idx = MutableIndex(db, k=4, reserve=4, device="cpu")
    eng = idx.serving_engine(buckets=(8, 16, 32, 64, 128))
    eng.warmup()
    pool = (rng.random((256, 8)) * 32).astype(np.float32)
    slo_eng = obs.reset_slo_engine()
    with QueryQueue(eng, max_wait_ms=1.0) as q:
        q.submit_write("insert", vectors=(rng.random((20, 8)) * 32).astype(
            np.float32), ids=np.arange(1000, 1020)).result()
        q.submit_write("delete", ids=[3, 1005]).result()
        snap0 = idx._snapshot()
        epoch0 = idx.epoch

        def direct(cat):
            padded = np.zeros((bucket_for((8, 16, 32, 64, 128),
                                          cat.shape[0]), 8), np.float32)
            padded[:cat.shape[0]] = cat
            d, i = idx.search(padded)
            return d[:cat.shape[0]], i[:cat.shape[0]]

        def at_snapshot(cat):
            idx._snapshot = lambda: snap0
            try:
                return direct(cat)
            finally:
                del idx._snapshot

        def across_swap():
            idx.start_compactor(interval_s=0.05)
            epochs = []
            for _ in range(6000):
                if idx.epoch != epoch0:
                    return epochs
                q.submit(pool[:3]).result()
                epochs.append(idx.epoch)
            raise AssertionError("compaction did not swap")

        out = chip_smoke.lock_order_hammer(
            q, eng, pool,
            {"index": idx, "index_compact": (idx, "_compact_lock"),
             "engines": (snap0.main, "_engines_lock"),
             "engine": snap0.engine,
             "queue": q, "slo": slo_eng, "registry": obs.get_registry()},
            [at_snapshot, direct],
            calls=(q.stats, slo_eng.evaluate, lambda: idx.search(pool[:2])),
            during=across_swap)
        idx.close()
    obs.reset_slo_engine()
    assert out["requests"] == 32 and out["edges"] >= 1
    assert out["batches"] >= 4
    assert set(out["locks_seen"]) == set(out["locks_instrumented"])
    assert "index_compact->index" in out["edge_list"]
    assert epoch0 in out["during"]
    assert idx.epoch == epoch0 + 1



def test_host_tier_lock_order_acyclic_under_hammer_cpu():
    """chip_smoke's ``tier_lock_order`` on the CPU: 8 threads x 4 rounds
    of direct host-RAM-tier searches beside its stats and the SLO
    engine's evaluate(); the tier's _tier_lock and _engines_lock are
    taken, the order graph is acyclic and every search is bitwise the
    same rows' search run alone."""
    import chip_smoke
    from knn_tpu_torch import ShardedKNN, obs
    from knn_tpu_torch.analysis import hbm

    rng = np.random.default_rng(12)
    db = rng.integers(0, 10, size=(300, 8)).astype(np.float32)
    tier = ShardedKNN(db, k=4, device="cpu",
                      hbm_budget_bytes=hbm.placement_bytes(128, 8))
    assert tier.hosttier_stats()["sweeps"] == 3
    pool = rng.integers(0, 10, size=(256, 8)).astype(np.float32)
    obs.reset(enabled=True)
    raw = tier._tier_lock
    out = chip_smoke.tier_lock_order(tier, pool)
    assert out["requests"] == 32 and out["batches"] == 32
    assert {"tier", "engines"} <= set(out["locks_seen"])
    assert tier._tier_lock is raw and "submit" not in vars(tier)

# --- switch-lockstep ----------------------------------------------------
def test_switch_catalog_is_the_jax_catalog_with_port_fields():
    assert [(s.name, s.kind, s.description, s.family, s.reserved)
            for s in sw.SWITCHES] == \
        [(s.name, s.kind, s.description, s.family, s.reserved)
         for s in jsw.SWITCHES]
    assert sw.SWITCH_RE.pattern == jsw.SWITCH_RE.pattern
    assert sw.FAMILY_PREFIXES == jsw.FAMILY_PREFIXES
    for tok in ("KNN_TPU_OBS", "KNN_TPU_ADMISSION_", "KNN_TPU_ADMISSION_NOPE",
                "KNN_TPU_TOTALLY_BOGUS", "KNN_BENCH_N", "KNN_BENCH_"):
        assert (sw.lookup(tok) is None) == (jsw.lookup(tok) is None), tok
    text = "a KNN_TPU_OBS_LOG and KNN_BENCH_PALLAS_ token, KNN_TPUX no"
    assert list(sw.tokens_in_source(text)) == \
        list(jsw.tokens_in_source(text))
    assert not hasattr(sw, "isolation_names")
    for s in sw.SWITCHES:
        assert len(s.port) >= 10
        assert s.port.startswith("not ported:") or "divergence" in s.port
    assert sw.BY_NAME["KNN_TPU_CALIBRATION"].port == \
        "calibrate.configure(store=) (divergence 43)"
    assert sw.BY_NAME["KNN_TPU_MERGE"].port == \
        "ShardedKNN(merge=) (divergence 56)"
    assert sw.BY_NAME["KNN_TPU_DCN_MERGE"].port == \
        "ShardedKNN(dcn_merge=) (divergence 56)"


SWITCH_CASES = {
    # (files, seeded finding symbol or None for the clean twin)
    "code_literal": ({"knn_tpu_torch/mod.py": '''
        import os

        FLAG = os.environ.get("KNN_TPU_OBS")
        '''}, "KNN_TPU_OBS"),
    "docstring_names_the_replaced_switch": ({"knn_tpu_torch/mod.py": '''
        """The JAX package reads KNN_TPU_OBS; the port takes an argument."""
        '''}, None),
    "uncataloged_docstring_token": ({"knn_tpu_torch/mod.py": '''
        """Reads KNN_TPU_TOTALLY_BOGUS."""
        '''}, "KNN_TPU_TOTALLY_BOGUS"),
    "readme_port_section_token": ({"README.md": (
        "# x\n## PyTorch/CUDA port (`knn_tpu_torch/`)\n\nset KNN_TPU_OBS=0\n"
        "\n## Serving\n\nKNN_TPU_OBS_LOG is the JAX package's\n")},
        "KNN_TPU_OBS"),
    "readme_token_outside_the_port_section": ({"README.md": (
        "# x\n## PyTorch/CUDA port (`knn_tpu_torch/`)\n\nobs.reset()\n"
        "\n## Serving\n\nKNN_TPU_OBS_LOG is the JAX package's\n")}, None),
    "verify_notes_token": ({".claude/skills/verify/SKILL.md": (
        "## Drive\n\nKNN_TPU_OBS=0\n\n## The PyTorch/CUDA port\n\n"
        "KNN_TPU_AUDIT_RATE=1\n")}, "KNN_TPU_AUDIT_RATE"),
    "perf_token": ({"PERF.md": "# PERF\nKNN_BENCH_N=10\n"}, "KNN_BENCH_N"),
}


@pytest.mark.parametrize("case", sorted(SWITCH_CASES))
def test_switch_lockstep_seeded_and_clean(tmp_path, case):
    files, symbol = SWITCH_CASES[case]
    write_tree(tmp_path, files, "knn_tpu_torch")
    rep = analysis.run(str(tmp_path), names=["switch-lockstep"])
    assert [f.symbol for f in rep.findings] == \
        ([symbol] if symbol else []), [f.message for f in rep.findings]


def test_switch_row_without_a_port_counterpart_is_a_finding(tmp_path):
    src = open(os.path.join(REPO, "knn_tpu_torch", "analysis",
                            "switches.py")).read()
    src = src.replace('"obs.reset(enabled=) (divergence 34)"', '""')
    write_tree(tmp_path, {"knn_tpu_torch/analysis/switches.py": src},
               "knn_tpu_torch")
    rep = analysis.run(str(tmp_path), names=["switch-lockstep"])
    assert [f.symbol for f in rep.findings] == ["KNN_TPU_OBS"]
    assert "names no port counterpart" in rep.findings[0].message


# --- metric-lockstep ----------------------------------------------------
NAMES_FIXTURE = '''
    CATALOG_VERSION = "fixture"
    SERVING_ERRORS = "knn_tpu_serving_errors_total"
    JAX_COMPILES = "knn_tpu_jax_compiles_total"
    CATALOG = {
        SERVING_ERRORS: ("counter", ("op",), "errors"),
        JAX_COMPILES: ("counter", (), "compiles"),
    }
    UNWRITTEN = frozenset({JAX_COMPILES})
    '''

METRIC_CASES = {
    "writes_only_the_written_name": ({
        "knn_tpu_torch/obs/names.py": NAMES_FIXTURE,
        "knn_tpu_torch/mod.py": '''
            """Counts knn_tpu_jax_compiles_total nowhere (a docstring)."""
            from knn_tpu_torch.obs import names as mn

            def f(reg):
                reg.counter(mn.SERVING_ERRORS, op="search").inc()
            '''}, []),
    "writes_an_unwritten_name": ({
        "knn_tpu_torch/obs/names.py": NAMES_FIXTURE,
        "knn_tpu_torch/mod.py": '''
            from knn_tpu_torch.obs import names as mn

            def f(reg):
                reg.counter(mn.SERVING_ERRORS, op="search").inc()
                reg.counter(mn.JAX_COMPILES).inc()
            '''}, ["knn_tpu_jax_compiles_total"]),
    "writes_an_unwritten_literal": ({
        "knn_tpu_torch/obs/names.py": NAMES_FIXTURE,
        "knn_tpu_torch/mod.py": '''
            from knn_tpu_torch.obs.names import SERVING_ERRORS

            NAME = "knn_tpu_jax_compiles_total"
            '''}, ["knn_tpu_jax_compiles_total"]),
    "writes_nothing": ({
        "knn_tpu_torch/obs/names.py": NAMES_FIXTURE,
        "knn_tpu_torch/mod.py": "x = 1\n"}, ["knn_tpu_serving_errors_total"]),
    "uncataloged_literal": ({"knn_tpu_torch/mod.py": '''
        NAME = "knn_tpu_bogus_metric_total"
        PATH = "~/.cache/knn_tpu_torch/autotune.json"
        '''}, ["knn_tpu_bogus_metric_total"]),
    "cataloged_literal_and_summary_suffix": ({"knn_tpu_torch/mod.py": '''
        NAME = "knn_tpu_serving_requests_total"
        SUFFIXED = "knn_tpu_serving_requests_total_count"
        '''}, []),
}


@pytest.mark.parametrize("case", sorted(METRIC_CASES))
def test_metric_lockstep_seeded_and_clean(tmp_path, case):
    files, symbols = METRIC_CASES[case]
    write_tree(tmp_path, files, "knn_tpu_torch")
    rep = analysis.run(str(tmp_path), names=["metric-lockstep"])
    assert [f.symbol for f in rep.findings] == symbols, \
        [f.message for f in rep.findings]


def test_unwritten_is_exactly_what_the_port_never_writes():
    from knn_tpu_torch.analysis.check_metrics import written_names
    from knn_tpu_torch.analysis.core import Context
    from knn_tpu_torch.obs import names as mn

    written = written_names(Context(REPO), mn)
    assert set(mn.CATALOG) - written == mn.UNWRITTEN
    assert mn.UNWRITTEN == {mn.JAX_COMPILES, mn.JAX_COMPILE_SECONDS}
    assert not {mn.MERGE_SELECTED, mn.MERGE_BYTES,
                mn.MERGE_STRAGGLER_GAP} & mn.UNWRITTEN


# --- torch-hygiene ------------------------------------------------------
HYGIENE_CASES = {
    "wall_clock": ({"knn_tpu_torch/mod.py": WALL_CLOCK}, ["time.time"]),
    "wall_clock_in_probes_and_the_smoke": ({
        "knn_tpu_torch/csrc/probes/p.py": WALL_CLOCK,
        "chip_smoke.py": WALL_CLOCK}, []),
    "hot_path_item": ({"knn_tpu_torch/hot.py": '''
        from knn_tpu_torch.analysis.annotations import hot_path


        @hot_path
        def dispatch(x, torch):
            n = x.sum().item()
            y = x.cpu()
            torch.cuda.synchronize()
            x.numpy()
            return int(x.max()), n, y
        '''}, ["dispatch"] * 5),
    "hot_path_allow": ({"knn_tpu_torch/hot.py": '''
        import numpy as np

        from knn_tpu_torch.analysis.annotations import hot_path


        @hot_path(allow=(".item", "np.asarray", "int"))
        def dispatch(x, stream):
            stream.synchronize()
            return x.sum().item(), np.asarray(x), int(x.max())


        def cold(x):
            return x.item()
        '''}, ["dispatch"]),
    "import_jax": ({"knn_tpu_torch/mod.py": '''
        import jax
        import jaxlib.xla_client
        from knn_tpu.obs import names
        from knn_tpu import analysis
        import importlib
        mod = importlib.import_module("knn_tpu.ops")
        '''}, ["jax", "jaxlib.xla_client", "knn_tpu.obs", "knn_tpu",
               "knn_tpu.ops"]),
    "import_the_port": ({"knn_tpu_torch/mod.py": '''
        import knn_tpu_torch.obs
        from knn_tpu_torch import analysis
        from . import sibling
        '''}, []),
    "import_jax_in_the_smoke": ({"chip_smoke.py": "import jax\n"}, ["jax"]),
    "plain_fallback": ({"knn_tpu_torch/ops/k.py": '''
        def select(q):
            try:
                return _launch(q)
            except RuntimeError:
                return binned_select_plain(q)


        def other(q, ck):
            try:
                return _launch(q)
            except RuntimeError:
                raise
            finally:
                ck.stream_select_plain(q)
        '''}, ["binned_select_plain"]),
    "plain_version_for_cpu_tensors": ({"knn_tpu_torch/ops/k.py": '''
        def select(q):
            if q.device.type == "cpu":
                return binned_select_plain(q)
            return _launch(q)
        '''}, []),
}


@pytest.mark.parametrize("case", sorted(HYGIENE_CASES))
def test_torch_hygiene_seeded_and_clean(tmp_path, case):
    files, symbols = HYGIENE_CASES[case]
    write_tree(tmp_path, files, "knn_tpu_torch")
    rep = analysis.run(str(tmp_path), names=["torch-hygiene"])
    assert sorted(f.symbol for f in rep.findings) == sorted(symbols), \
        [f.message for f in rep.findings]


def test_hot_path_sites_carry_the_jax_allow_tuples():
    """The four serving hot paths carry ``@hot_path`` with the JAX
    package's ``allow`` tuples."""
    import ast

    def sites(root):
        out = {}
        for rel in ("serving/engine.py", "serving/queue.py"):
            tree = ast.parse(open(os.path.join(REPO, root, rel)).read())
            for node in ast.walk(tree):
                if isinstance(node, ast.FunctionDef):
                    for dec in node.decorator_list:
                        if "hot_path" in ast.dump(dec):
                            out[(rel, node.name)] = ast.dump(dec)
        return out

    assert sites("knn_tpu_torch") == sites("knn_tpu")
    assert len(sites("knn_tpu_torch")) == 4


# --- the gate -----------------------------------------------------------
def test_full_suite_green_in_process():
    rep = analysis.run(REPO)
    assert rep.ok, rep.render_text()
    assert rep.suppressed >= 1
    assert rep.checkers_run == list(CHECKERS)


def test_annotated_runtime_classes_lint_clean():
    rep = analysis.run(REPO, names=["locked-mutation"])
    assert rep.ok, [f.message for f in rep.findings]
    assert rep.suppressed == 1
    text = open(os.path.join(REPO, "knn_tpu_torch", "utils", "timing.py"),
                encoding="utf-8").read()
    assert "Thread-safety: guarded by\n    ``self._lock``" in text


def test_cli_lint_green_json_without_jax_or_a_cuda_context():
    code = (
        "import sys\n"
        "from knn_tpu_torch.cli import main\n"
        "rc = main(['lint', '--json'])\n"
        "import torch\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'knn_tpu'))\n"
        "print('CHECK', bad, torch.cuda.is_initialized())\n"
        "sys.exit(rc)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    body, check = proc.stdout.rsplit("CHECK", 1)
    assert check.split() == ["[]", "False"]
    payload = json.loads(body)
    assert payload["ok"] is True and payload["findings"] == []
    assert set(payload["checkers"]) == FIVE
    assert payload["suppressed"] >= 1


def test_cli_lint_seeded_regression_exits_one(tmp_path):
    write_tree(tmp_path, {"knn_tpu_torch/rogue.py": '''
        import os

        FLAG = os.environ.get("KNN_TPU_TOTALLY_BOGUS")
        '''}, "knn_tpu_torch")
    proc = subprocess.run(
        [sys.executable, "-m", "knn_tpu_torch.cli", "lint", "--json",
         "--root", str(tmp_path), "--checker", "switch-lockstep"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    payload = json.loads(proc.stdout)
    assert [f["symbol"] for f in payload["findings"]] == \
        ["KNN_TPU_TOTALLY_BOGUS"]


SEEDED = {
    "switch-lockstep": {"knn_tpu_torch/a.py": 'X = "KNN_TPU_OBS"\n'},
    "metric-lockstep": {"knn_tpu_torch/a.py": 'X = "knn_tpu_no_such"\n'},
    "locked-mutation": {"knn_tpu_torch/a.py": BAD_CLASS},
    "torch-hygiene": {"knn_tpu_torch/a.py": "import jax\n"},
    "artifact-lockstep": {"knn_tpu_torch/loadgen/knee.py": '''
        def block():
            return {"version": 1, "rate_steps": [], "slo_p99_ms": 1.0,
                    "knee_qps": None, "undeclared_key": 1}
        '''},
}


@pytest.mark.parametrize("name", sorted(SEEDED))
def test_cli_lint_exits_one_on_each_checkers_seeded_finding(
        tmp_path, capsys, name):
    from knn_tpu_torch.cli import main

    write_tree(tmp_path, SEEDED[name], "knn_tpu_torch")
    assert main(["lint", "--root", str(tmp_path), "--checker", name,
                 "--json"]) == 1
    payload = json.loads(capsys.readouterr().out)
    assert payload["findings"] and \
        {f["checker"] for f in payload["findings"]} == {name}
    assert main(["lint", "--root", str(tmp_path / "empty"), "--checker",
                 name]) == 0
    capsys.readouterr()


def test_cli_lint_list_and_unknown_checker(capsys):
    from knn_tpu_torch.cli import main

    assert main(["lint", "--list"]) == 0
    listed = [line.split()[0] for line in
              capsys.readouterr().out.splitlines()]
    assert listed == list(CHECKERS)
    assert main(["lint", "--checker", "vmem-budget"]) == 2
    assert "unknown checker" in capsys.readouterr().err
