"""Runtime instrumented-lock harness: record lock-acquisition order
across threads and prove the order graph acyclic (deadlock detection) —
the port's copy of knn_tpu/analysis/lockorder.py, with the same edges,
witnesses and cycle search.

The ``locked-mutation`` checker proves writes happen under A lock; it
cannot prove two locks are always taken in the same ORDER — the
classic deadlock (thread 1 holds A wants B, thread 2 holds B wants A)
is a cross-thread property no single method shows.  This harness is
the runtime complement: tests (and ``chip_smoke.py`` on the card) wrap
the real locks of the thread-safe classes (engine, queue, registry, SLO
engine, audit sampler, the tiers and the host-RAM tier's locks) in
:class:`InstrumentedLock`, run 8-thread hammer scenarios,
and assert :func:`find_cycle` returns None — every edge ``A -> B``
("a thread acquired B while holding A") recorded during the run, with
a witness stack of names, and a cycle in that graph is a lock-order
inversion that WILL deadlock under the right interleaving even if this
run got lucky.

Stdlib-only; zero coupling to the classes it instruments (tests swap
``obj._lock``/``obj._cond`` attributes, or any attribute they name, such
as ``ServingEngine._launch_lock`` or ``ShardedKNN._tier_lock`` — the
``with``-statement protocol is all that's required).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Set, Tuple


class LockOrderRecorder:
    """The shared order graph a group of instrumented locks feeds.

    Thread-safety: guarded by ``self._lock`` (its own plain lock —
    never instrumented, held only for dict updates, so it cannot
    participate in the graphs it records).
    """

    def __init__(self):
        self._lock = threading.Lock()
        #: (held_name, acquired_name) -> first witness thread name
        self._edges: Dict[Tuple[str, str], str] = {}
        #: every name acquired at least once
        self._seen: Set[str] = set()
        self._held = threading.local()

    def _stack(self) -> List[str]:
        st = getattr(self._held, "stack", None)
        if st is None:
            st = []
            self._held.stack = st
        return st

    def note_acquire(self, name: str) -> None:
        st = self._stack()
        tname = threading.current_thread().name
        with self._lock:
            self._seen.add(name)
            for held in st:
                if held != name:
                    self._edges.setdefault((held, name), tname)
        st.append(name)

    def note_release(self, name: str) -> None:
        st = self._stack()
        # release order may differ from acquire order (with-blocks can
        # interleave via explicit acquire/release); remove the newest
        # matching entry
        for i in range(len(st) - 1, -1, -1):
            if st[i] == name:
                del st[i]
                return

    def edges(self) -> Dict[Tuple[str, str], str]:
        with self._lock:
            return dict(self._edges)

    def seen(self) -> Set[str]:
        """Every lock name acquired while recording, nested or not."""
        with self._lock:
            return set(self._seen)

    def order_graph(self) -> Dict[str, Set[str]]:
        graph: Dict[str, Set[str]] = {}
        for (a, b), _tname in self.edges().items():
            graph.setdefault(a, set()).add(b)
            graph.setdefault(b, set())
        return graph

    def find_cycle(self) -> Optional[List[str]]:
        """A lock-name cycle in the acquisition-order graph, or None.
        Any cycle is reportable: ``A -> B -> A`` means some thread
        acquired B holding A and some (possibly other) thread acquired
        A holding B — a deadlock waiting for its interleaving."""
        graph = self.order_graph()
        WHITE, GREY, BLACK = 0, 1, 2
        color = {n: WHITE for n in graph}
        path: List[str] = []

        def visit(n: str) -> Optional[List[str]]:
            color[n] = GREY
            path.append(n)
            for m in sorted(graph[n]):
                if color[m] == GREY:
                    return path[path.index(m):] + [m]
                if color[m] == WHITE:
                    cyc = visit(m)
                    if cyc is not None:
                        return cyc
            path.pop()
            color[n] = BLACK
            return None

        for n in sorted(graph):
            if color[n] == WHITE:
                cyc = visit(n)
                if cyc is not None:
                    return cyc
        return None

    def assert_acyclic(self) -> None:
        cyc = self.find_cycle()
        if cyc is not None:
            edges = self.edges()
            witness = {f"{a}->{b}": edges.get((a, b), "?")
                       for a, b in zip(cyc, cyc[1:])}
            raise AssertionError(
                f"lock-order cycle {' -> '.join(cyc)} "
                f"(witness threads: {witness}) — a deadlock under the "
                f"right interleaving")


class InstrumentedLock:
    """A drop-in ``with``-protocol wrapper over any lock-like object
    (Lock, RLock, Condition) that reports acquisition order to a
    :class:`LockOrderRecorder`.  Condition extras (wait/notify) proxy
    through, so ``QueryQueue._cond`` and the tiers' ``_lock`` Conditions
    instrument like the plain locks; any other attribute (``locked``)
    reads through to the inner object.
    """

    def __init__(self, name: str, recorder: LockOrderRecorder,
                 inner=None):
        self.name = name
        self.recorder = recorder
        self.inner = inner if inner is not None else threading.Lock()

    def acquire(self, *a, **kw):
        got = self.inner.acquire(*a, **kw)
        if got:
            self.recorder.note_acquire(self.name)
        return got

    def release(self):
        self.recorder.note_release(self.name)
        return self.inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    # Condition pass-throughs (wait releases and re-acquires the inner
    # lock without changing which NAME this thread holds — correct for
    # ordering: the protected region is still "under" this lock)
    def wait(self, timeout=None):
        return self.inner.wait(timeout)

    def wait_for(self, predicate, timeout=None):
        return self.inner.wait_for(predicate, timeout)

    def notify(self, n=1):
        return self.inner.notify(n)

    def notify_all(self):
        return self.inner.notify_all()

    def __getattr__(self, attr):
        return getattr(self.inner, attr)


def instrument(recorder: LockOrderRecorder, **named_objects) -> None:
    """Swap each object's lock attribute for an instrumented wrapper:
    ``instrument(rec, engine=engine, queue=queue)`` wraps
    ``engine._lock`` as ``"engine"`` and ``queue._cond`` as
    ``"queue"`` (whichever of ``_lock``/``_cond`` the object has).  A
    value ``(obj, "attr")`` names the attribute to swap:
    ``instrument(rec, launch=(engine, "_launch_lock"))`` wraps
    ``engine._launch_lock`` as ``"launch"``."""
    for name, obj in named_objects.items():
        attrs: Tuple[str, ...] = ("_lock", "_cond")
        if isinstance(obj, tuple):
            obj, attr = obj
            attrs = (attr,)
        for attr in attrs:
            inner = getattr(obj, attr, None)
            if inner is not None:
                setattr(obj, attr,
                        InstrumentedLock(name, recorder, inner))
                break
        else:
            raise ValueError(
                f"{name}: object has neither _lock nor _cond"
                if len(attrs) == 2 else f"{name}: object has no {attrs[0]}")

