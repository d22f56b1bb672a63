"""Request-scoped trace spans and the structured JSONL event log — the
port of knn_tpu/obs/trace.py.

A **trace id** is minted where a request enters the system
(``ServingEngine.submit`` for direct callers, ``QueryQueue.submit`` for
queued ones) and rides the request through micro-batching, dispatch and
result join, so one request's queue wait, capture, device and join times
stay attributable even when it was coalesced into a batch with others
(each member keeps its own id; the batch's dispatch event lists them).

A **span** is a timed scope: ``with span("serving.dispatch",
trace_id=tid, op="search"):`` records its wall duration into the
``knn_tpu_span_seconds{span=...}`` histogram and emits one event.  Events
land in a bounded in-memory ring (:data:`RING_SIZE`) and, when the event
log was given a path, as JSON lines on disk, rotated to two generations.

Disabled mode: :func:`span` yields a shared inert span,
:func:`new_trace_id` returns None and :func:`emit_event` drops.

Where the port differs: the sink's path and size cap are arguments of
:func:`reset_event_log` (``path``, ``max_bytes``), not environment
variables; with none given the log is the in-memory ring alone.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
import uuid
from collections import deque
from typing import Optional

from knn_tpu_torch.obs import ident, names, registry

#: default rotation cap of the JSONL sink: a long-running process holds at
#: most two generations of this size on disk
DEFAULT_LOG_MAX_BYTES = 64 * 1024 * 1024

#: in-memory event ring size
RING_SIZE = 8192


def new_trace_id() -> Optional[str]:
    """A 16-hex-character request id, or None when the subsystem is off
    (so propagation sites can thread it unconditionally)."""
    if not registry.enabled():
        return None
    return uuid.uuid4().hex[:16]


class EventLog:
    """Bounded ring plus an optional size-capped JSONL file sink.
    ``emit`` is thread-safe and never raises into the instrumented path: a
    failing sink counts ``knn_tpu_events_dropped_total`` instead.

    The sink rotates: when the next line would push the file past
    ``max_bytes``, the file is renamed to ``<path>.1`` (replacing the
    previous generation) and a fresh one begins, always between lines, so
    both files hold whole JSON lines only."""

    def __init__(self, path: Optional[str] = None, ring: int = RING_SIZE,
                 max_bytes: Optional[int] = None):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=int(ring))
        self._path = path
        self._fh = None
        self._size = 0  # bytes in the current generation (set on open)
        self._max_bytes = max(1, int(
            DEFAULT_LOG_MAX_BYTES if max_bytes is None else max_bytes))

    @property
    def path(self) -> Optional[str]:
        return self._path

    def emit(self, event: dict) -> None:
        evt = {"ts": round(time.time(), 6), **event}
        # serialized outside the lock; file lines carry the process
        # identity (merged multi-process logs stay attributable), the ring
        # does not (it never leaves the process)
        line = (json.dumps({**evt, "identity": ident.identity()}) + "\n"
                if self._path is not None else None)
        with self._lock:
            self._ring.append(evt)
            if line is None:
                return
            try:
                if self._fh is None:
                    self._fh = open(self._path, "a")
                    self._fh.seek(0, 2)
                    self._size = self._fh.tell()
                # json.dumps escapes to ASCII: characters == bytes
                if self._size > 0 and self._size + len(line) > self._max_bytes:
                    self._fh.close()
                    self._fh = None
                    os.replace(self._path, self._path + ".1")
                    self._fh = open(self._path, "a")
                    self._size = 0
                self._fh.write(line)
                self._fh.flush()
                self._size += len(line)
            except OSError:
                registry.counter(names.EVENTS_DROPPED).inc()

    def recent(self, n: Optional[int] = None) -> list:
        """Newest-last copy of the ring (``n`` trailing events)."""
        with self._lock:
            evts = list(self._ring)
        return evts if n is None else evts[-n:]

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None


_state_lock = threading.Lock()
_log: Optional[EventLog] = None


def get_event_log() -> EventLog:
    global _log
    log = _log
    if log is None:
        with _state_lock:
            if _log is None:
                _log = EventLog()
            log = _log
    return log


def reset_event_log(path: Optional[str] = None,
                    max_bytes: Optional[int] = None) -> EventLog:
    """Swap in a fresh event log: the ring alone, or also the JSONL sink at
    ``path`` rotated at ``max_bytes`` (default
    :data:`DEFAULT_LOG_MAX_BYTES`)."""
    global _log
    with _state_lock:
        if _log is not None:
            _log.close()
        _log = EventLog(path, max_bytes=max_bytes)
        return _log


def emit_event(name: str, **fields) -> None:
    """One structured event (not a span); dropped when disabled."""
    if not registry.enabled():
        return
    get_event_log().emit({"type": "event", "name": name, **fields})


class Span:
    """A live span: :meth:`set` attributes before the scope closes and
    they ride the emitted event."""

    __slots__ = ("name", "trace_id", "attrs")

    def __init__(self, name: str, trace_id: Optional[str], attrs: dict):
        self.name = name
        self.trace_id = trace_id
        self.attrs = attrs

    def set(self, key: str, value) -> None:
        self.attrs[key] = value


class _NoopSpan:
    __slots__ = ()
    name = None
    trace_id = None

    def set(self, key: str, value) -> None:
        pass


NOOP_SPAN = _NoopSpan()


def record_span(name: str, trace_id: Optional[str], dur_s: float,
                **attrs) -> None:
    """Record an already-measured span: one histogram observation and one
    event."""
    if not registry.enabled():
        return
    registry.histogram(names.SPAN_SECONDS, span=name).observe(dur_s)
    evt = {"type": "span", "span": name, "dur_s": round(dur_s, 6), **attrs}
    if trace_id is not None:
        evt["trace_id"] = trace_id
    get_event_log().emit(evt)


@contextlib.contextmanager
def span(name: str, trace_id: Optional[str] = None, **attrs):
    """Timed scope -> ``knn_tpu_span_seconds{span=name}`` + one event;
    yields the :class:`Span`.  ``trace_id`` is propagated, never minted
    here: a span with no request behind it (a warm-up capture, a
    background compaction) emits without one."""
    if not registry.enabled():
        yield NOOP_SPAN
        return
    sp = Span(name, trace_id, dict(attrs))
    t0 = time.perf_counter()
    try:
        yield sp
    finally:
        record_span(name, sp.trace_id, time.perf_counter() - t0,
                    **sp.attrs)
