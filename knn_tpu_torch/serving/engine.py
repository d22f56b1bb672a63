"""The serving engine on one GPU or a mesh: shape-bucketed executables
over a placed :class:`~knn_tpu_torch.parallel.sharded.ShardedKNN`, with
dispatch-ahead — the port of knn_tpu/serving/engine.py.

- **Shape bucketing** (serving.buckets): each request pads up to the
  smallest ladder bucket with whole zero queries whose outputs are sliced
  away on the host.  Every query row's distances and top-k are its own
  (the distance matrix is row-separable, the select runs per row), so
  bucketed results are bitwise a direct ``ShardedKNN.search`` of the same
  padded batch.  Against the unpadded call neighbour identity and the
  tie-break order are kept; the distances are bitwise too wherever the
  matmul's reduction order does not depend on the batch shape.
- **An executable per placed shape**: the JAX package AOT-compiles one
  XLA program per ``(op, placed rows)`` (``lower().compile()``).  On the
  card the port captures one **CUDA graph** of the exact ``search`` /
  ``predict`` program per key instead, in :meth:`ServingEngine.warmup` or
  at the key's first request; a replay launches the whole program — the
  matmuls, the stable sort, the vote — as one graph.  On the CPU, or with
  ``aot=False``, the executable is the eager program.  Compiles (captures)
  and dispatches are counted per bucket, as the JAX package counts them.
  On a mesh the program is the mesh's (``ShardedKNN._exact_topk``: the
  queries split over the query shards, the db shards' lists merged), a
  bucket's placed rows round up to a multiple of the query shards, and
  buckets below that count share one executable.  A logical mesh of one
  card (parallel.mesh) runs every shard on the capturing stream, so its
  graph holds the whole mesh program; a mesh over several cards runs the
  eager program (``aot=False``) — ``aot=True`` there is refused by name,
  since one graph per card is not built yet (ROADMAP queue C).
- **Dispatch-ahead**: :meth:`ServingEngine.submit` enqueues and returns a
  :class:`PendingSearch` at once; :meth:`PendingSearch.result` waits on
  the request's own CUDA event.  :meth:`ServingEngine.replay` keeps at
  most ``depth`` requests in flight.

A graph replay writes its outputs into the same static tensors every
time, and two in-flight requests may ride the same rung.  So a dispatch
enqueues, in one critical section on the device's default stream: the
copy of the padded queries (pinned host memory, kept alive by the
request's handle) into the graph's static input, the replay, and
non-blocking copies of the static outputs into pinned host buffers of
that request alone; then it records the request's event.  The next
replay of that rung is ordered after those copies.

A graph is captured on a side stream that first waits for the default
stream (so the placement's copies and kernels are done), after one eager
run of the program on that stream (library handles, workspaces and
allocator blocks exist before capture), with ``capture_error_mode=
"thread_local"``: another thread may launch work while this one captures
— a compaction pre-warms its replacement engine beside live traffic.  One
process-wide lock serializes captures.  The eager run's blocks stay cached
for the side stream, where nothing else would reuse them (at 1M rows as
many bytes as the graph pool), so each capture ends by handing the
allocator's unused cached blocks back to the driver
(``torch.cuda.empty_cache()``, a device synchronization once per
capture); the stream's cuBLAS workspace is made before any warm-up, in a
segment of its own, so no warm-up block shares a segment with it.  An
engine's graphs share one
memory pool: their replays are stream-ordered and each replay's outputs
are copied out before the next replay, so no two replays overlap.  The
graphs, and the pool with them, are freed with the engine.  A failed
capture raises; the engine never falls back to the eager program on the
card.

Telemetry (knn_tpu_torch.obs; engine.py:155, 245-247, 313-333, 399,
424-461, 527-586, 592-594, 615-672 of the JAX package):
:meth:`ServingEngine.submit` mints a trace id when the caller gives none
and records the ``serving.dispatch`` span (``serving.compile`` around a
capture, outside ``torch.cuda.graph``), :meth:`PendingSearch.result` the
``serving.join`` and ``serving.request`` spans; the ``SERVING_*`` counters
(a capture counts under ``SERVING_COMPILES``), the tenant series and the
latency histogram (trace-id exemplars) follow each request, and the engine
registers with obs.health.  No obs call reads a device tensor.  The shadow
audit sampler (obs.audit) picks ``search`` requests by trace id: ``submit``
copies a sampled request's queries, and ``result`` hands the host arrays
the caller receives (never a graph's static output buffer, which the next
replay overwrites) to the audit worker, whose oracle is the float64
``ops.refine.refine_shared_exact`` over ``ShardedKNN._host_train()``.
``stats()`` carries the ``slo`` section (one evaluation; ``include_slo=
False`` skips it), ``slowest_requests`` while telemetry is on, and
``quality`` while the sampler is armed.

Where the port differs (ROADMAP queue C): CUDA graphs stand in for the AOT
compiles; ``donate_queries`` is accepted and reported in ``stats()`` but
changes nothing (the graph's static input is reused already); and no
transient retry: a CUDA error raises at its first occurrence.
"""

from __future__ import annotations

import threading
import time
from collections import Counter, deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from knn_tpu_torch import obs
from knn_tpu_torch.analysis.annotations import hot_path
from knn_tpu_torch.obs import names as mn
from knn_tpu_torch.parallel.mesh import require_one_process
from knn_tpu_torch.parallel.sharded import _host_copies
from knn_tpu_torch.serving.buckets import (
    DEFAULT_MAX_BUCKET,
    DEFAULT_MIN_BUCKET,
    bucket_for,
    bucket_ladder,
    normalize_ladder,
    split_sizes,
)

#: operations the engine can serve; each maps to one program family
OPS = ("search", "predict")

#: serializes graph captures across the process (engines and threads)
_CAPTURE_LOCK = threading.Lock()
#: one capture stream per device (made under _CAPTURE_LOCK): the
#: allocator caches a freed block for the stream it was made on, so a new
#: stream per capture would keep a warm-up's blocks apart each time
_CAPTURE_STREAMS: Dict[int, object] = {}


def latency_summary(samples_s: Sequence) -> Optional[Dict[str, float]]:
    """p50/p95/p99/mean (milliseconds) of per-request wall latencies over
    a bounded window (``count`` is the window's fill, not the lifetime
    total).  Samples may be plain durations or ``(monotonic_ts,
    duration)`` pairs; with timestamps the summary also carries
    ``window_span_s``, the wall span of the window."""
    if not samples_s:
        return None
    first = samples_s[0]
    ts = None
    if isinstance(first, tuple):
        ts = [t for t, _ in samples_s]
        vals = [v for _, v in samples_s]
    else:
        vals = samples_s
    arr = np.asarray(vals, dtype=np.float64) * 1e3
    out = {
        "p50": round(float(np.percentile(arr, 50)), 3),
        "p95": round(float(np.percentile(arr, 95)), 3),
        "p99": round(float(np.percentile(arr, 99)), 3),
        "mean": round(float(arr.mean()), 3),
        "max": round(float(arr.max()), 3),
        "count": int(arr.size),
        "window_samples": int(arr.size),
    }
    if ts is not None:
        out["window_span_s"] = round(max(ts) - min(ts), 3)
    return out


class _Executable:
    """One ``(op, placed rows)`` program: a captured CUDA graph with its
    static input and outputs, or (``graph`` None) the eager program."""

    __slots__ = ("fn", "graph", "q", "outs")

    def __init__(self, fn, graph=None, q=None, outs=None):
        self.fn = fn
        self.graph = graph
        self.q = q
        self.outs = outs


def capture_graph(fn, q: torch.Tensor, pool) -> Tuple[object, tuple]:
    """``(graph, static outputs)`` of ``fn(q)`` captured into ``pool`` on a
    side stream of ``q``'s device: the side stream waits for the default
    stream, runs ``fn`` once eagerly, then captures it in
    ``thread_local`` mode, and the default stream waits for the side
    stream; the eager run's cached blocks are then released.  Raises if
    the capture fails (nothing falls back to eager)."""
    dev = q.device
    main = torch.cuda.default_stream(dev)
    with _CAPTURE_LOCK:
        side = _CAPTURE_STREAMS.get(main.device_index)
        if side is None:
            side = _CAPTURE_STREAMS[main.device_index] = torch.cuda.Stream(dev)
            # a first matmul on the new stream sets up cuBLAS's workspace
            # for it in a segment of its own; made inside the warm-up, the
            # workspace would split one of its blocks and pin that segment
            one = torch.ones((1, 1), device=dev)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                torch.mm(one, one)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            fn(q)  # the warm-up: handles, workspaces, allocator blocks
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                outs = fn(q)
            except BaseException:
                try:
                    graph.capture_end()
                except Exception:  # noqa: BLE001 - the body's error wins
                    pass
                raise
            graph.capture_end()
        main.wait_stream(side)
        # the warm-up's blocks are free but cached for the side stream;
        # under the lock no capture is under way while they go
        torch.cuda.empty_cache()
    return graph, tuple(outs)


class PendingSearch:
    """An in-flight bucketed request: its chunks were enqueued on the
    device; :meth:`result` waits on each chunk's event, slices the pad
    rows away, and records the request's wall latency."""

    def __init__(self, engine: "ServingEngine", op: str, chunks, n: int,
                 t0: float, trace_id: Optional[str] = None,
                 tenant: Optional[str] = None,
                 audit_queries: Optional[np.ndarray] = None):
        self._engine = engine
        self._op = op
        #: [(host outputs, event or None, real rows, kept-alive inputs)]
        self._chunks = chunks
        self._n = n
        self._t0 = t0
        self._error_counted = False
        self._res = None
        #: request-scoped trace id (minted in submit; None with obs off)
        self.trace_id = trace_id
        #: tenant tag (None = untagged)
        self.tenant = tenant
        #: the queries copied at submit when the audit sampler picked this
        #: request (obs.audit); None = not sampled
        self._audit_queries = audit_queries

    def result(self):
        if self._res is not None:
            return self._res
        t_join = time.perf_counter()
        try:
            parts = []
            for host, event, rows, _keep in self._chunks:
                if event is not None:
                    event.synchronize()
                parts.append([t.numpy()[:rows] for t in host])
            if self._op == "search":
                d = np.concatenate([p[0] for p in parts])[: self._n]
                i = np.concatenate([p[1] for p in parts])[: self._n]
                res = (d, i)
            else:
                res = np.concatenate([p[0] for p in parts])[: self._n]
        except Exception:
            if not self._error_counted:
                self._error_counted = True
                self._engine._record_error(self._op, tenant=self.tenant)
            raise
        # the host buffers are read: the inputs kept alive for their copies
        # can go; latency, like errors, counts once per request
        self._chunks = None
        self._res = res
        done = time.perf_counter()
        # join: the wait for the device and the copies inside result();
        # the request span is the whole submit-to-result wall
        obs.record_span("serving.join", self.trace_id, done - t_join,
                        op=self._op,
                        **({} if self.tenant is None
                           else {"tenant": self.tenant}))
        self._engine._record_latency(done - self._t0, self._op,
                                     trace_id=self.trace_id, rows=self._n,
                                     tenant=self.tenant)
        if self._audit_queries is not None:
            self._engine._submit_audit(self, res)
        return res


class ServingEngine:
    """Shape-bucketed query-serving frontend over a placed ``ShardedKNN``
    (see the module docstring).

    Construction is cheap (nothing is captured); call :meth:`warmup` at
    start-up to capture every bucket, or let the first request of each
    bucket pay its capture once.  ``stats()`` carries the capture
    (compile) and dispatch accounting.  ``aot=False`` runs the eager
    program on every device.  ``donate_queries`` (None: True off the CPU,
    as the JAX package defaults it) is reported and has no effect.

    Thread-safety: ``self._lock`` guards the accounting and the executable
    cache and is never held across a capture or a launch; concurrent first
    requests to one key wait on a per-key event; ``self._launch_lock``
    makes each dispatch's copy / replay / copy-out one unit on the default
    stream."""

    def __init__(
        self,
        program,
        *,
        buckets: Optional[Sequence[int]] = None,
        min_bucket: int = DEFAULT_MIN_BUCKET,
        max_bucket: int = DEFAULT_MAX_BUCKET,
        k: Optional[int] = None,
        donate_queries: Optional[bool] = None,
        aot: bool = True,
        latency_window: int = 4096,
    ):
        self.program = program
        # a host-RAM-tier placement has no placed database to capture
        # against: refused with the tier's own message
        program._require_resident("ServingEngine")
        require_one_process(program.mesh, "ServingEngine")
        self.k = program.k if k is None else int(k)
        if self.k > program.n_train:
            raise ValueError(f"k={self.k} > n_train={program.n_train}")
        self.buckets = (
            bucket_ladder(min_bucket, max_bucket) if buckets is None
            else normalize_ladder(buckets)
        )
        self.device = program.device
        if donate_queries is None:
            donate_queries = self.device.type != "cpu"
        self.donate_queries = bool(donate_queries)
        self._aot = bool(aot)
        #: CUDA graphs on the card with aot; the eager program otherwise
        self.graphs = self._aot and self.device.type == "cuda"
        if self.graphs and len(program.mesh.distinct_devices) > 1:
            raise ValueError(
                "aot=True on a mesh over several cards: a CUDA graph of the "
                "mesh program needs one graph a card, which is queued "
                "(ROADMAP queue C); pass aot=False to serve the eager "
                "program")
        #: the request dim submit validates and pads against; a dot
        #: placement is one column wider (the zero augmentation column)
        self._dim = int(program.dim_in)
        self._placed_dim = int(
            program.placement.db.shape[1] if program.placement is not None
            else program._host_rows_of().rows.shape[1])
        self._lock = threading.Lock()
        self._launch_lock = threading.Lock()
        self._execs: Dict[Tuple[str, int], _Executable] = {}
        #: per-key in-flight capture events (see _executable)
        self._compiling: Dict[Tuple[str, int], threading.Event] = {}
        self._compiles: Counter = Counter()  # bucket -> capture count
        #: lookups that found their executable built
        self.cache_hits = 0
        self._dispatches: Counter = Counter()  # bucket -> dispatch count
        #: the graphs' shared memory pool, made at the first capture
        self._pool = None
        #: lifetime totals beside the bounded latency window
        self._requests = 0
        self._queries = 0
        self._errors = 0
        self._latencies_s: deque = deque(maxlen=int(latency_window))
        #: ops whose buckets have all been built (warmup()); the readiness
        #: probe (/healthz) gates on this being non-empty
        self.warmed_ops: set = set()
        obs.health.register_engine(self)

    # -- executables -------------------------------------------------------
    def _program_fn(self, op: str):
        """``fn(q placed [rows, placed dim]) -> tuple of device tensors``:
        the exact search program (ShardedKNN.search's, without its
        dispatch accounting) or search plus the majority vote."""
        from knn_tpu_torch.ops.vote import majority_vote

        p = self.program
        k = self.k

        def search(q):
            return p._exact_topk(q, k, p.metric, p._dtype_key)

        if op == "search":
            return search
        labels = p._labels()
        if labels is None:
            raise RuntimeError(
                "ServingEngine op='predict' needs a ShardedKNN built with "
                "labels")

        def predict(q):
            _, gi = search(q)
            safe = torch.clamp(gi, max=p.n_train - 1)
            return (majority_vote(labels[safe], p.num_classes),)

        return predict

    def _placed_rows(self, bucket: int) -> int:
        """A bucket's rows rounded up to a multiple of the mesh's query
        shards (one device: every bucket is its own placed shape)."""
        from knn_tpu_torch.parallel.mesh import QUERY_AXIS

        qs = self.program.mesh.shape[QUERY_AXIS]
        return -(-int(bucket) // qs) * qs

    def _build(self, op: str, rows: int) -> _Executable:
        fn = self._program_fn(op)
        if not self.graphs:
            return _Executable(fn)
        # two cold keys may build at once: one pool for every capture
        with self._lock:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            pool = self._pool
        # the static input is made on the default stream, which the
        # capture stream waits for
        with torch.cuda.stream(torch.cuda.default_stream(self.device)):
            q = torch.zeros((rows, self._placed_dim), dtype=torch.float32,
                            device=self.device)
        graph, outs = capture_graph(fn, q, pool)
        return _Executable(fn, graph, q, outs)

    def _executable(self, op: str, bucket: int,
                    trace_id: Optional[str] = None) -> _Executable:
        """The executable of ``(op, bucket)``, built (captured) on first
        use.  The engine lock is never held across a capture: a cold
        bucket must not stall dispatches to warm ones; concurrent first
        requests to one key wait on a per-key event.  The build runs in a
        ``serving.compile`` span under the trace id of the request that
        triggered it (None for warmup)."""
        key = (op, self._placed_rows(bucket))
        while True:
            with self._lock:
                ex = self._execs.get(key)
                if ex is not None:
                    self.cache_hits += 1
                    return ex
                ev = self._compiling.get(key)
                if ev is None:
                    ev = threading.Event()
                    self._compiling[key] = ev
                    break  # this thread owns the build
            ev.wait()  # another thread builds this key; re-check
        try:
            with obs.span("serving.compile", trace_id=trace_id, op=op,
                          bucket=int(bucket), placed_rows=int(key[1])):
                ex = self._build(op, key[1])
            with self._lock:
                self._execs[key] = ex
                self._compiles[bucket] += 1
            obs.counter(mn.SERVING_COMPILES, op=op, bucket=bucket).inc()
            return ex
        finally:
            # waiters re-check _execs; after a raised build they find the
            # key absent and try (and raise) for themselves
            with self._lock:
                del self._compiling[key]
            ev.set()

    def warmup(self, ops: Sequence[str] = ("search",)) -> Dict[str, int]:
        """Build every bucket's executable for each op, so no live request
        pays a capture.  Returns per-op executable counts.  When the
        autotuner's cached winner for this placement's shape resolves
        ``precision="int8"``, warmup also builds the int8 placement
        (``ShardedKNN._quant_placement``) that the first certified int8
        query would otherwise build; a failure there raises."""
        counts = {}
        for op in ops:
            if op not in OPS:
                raise ValueError(f"unknown op {op!r}; expected one of {OPS}")
            for b in self.buckets:
                self._executable(op, b)
            with self._lock:
                keys = list(self._execs)
            counts[op] = len({k for k in keys if k[0] == op})
            self.warmed_ops.add(op)
        info = self._tuning_info()
        if (info and info.get("resolved_knobs", {}).get("precision")
                == "int8"):
            self.program._quant_placement("int8")
            counts["int8_placement"] = 1
        return counts

    def graph_pool_bytes(self) -> Optional[int]:
        """Bytes the allocator holds in this engine's graph pool (the
        segments of ``torch.cuda.memory_snapshot()`` tagged with its pool
        id); None without graphs or when the snapshot carries no pool
        ids."""
        if self._pool is None:
            return None
        segs = torch.cuda.memory_snapshot()
        if not segs or "segment_pool_id" not in segs[0]:
            return None
        pool = tuple(self._pool)
        return int(sum(s["total_size"] for s in segs
                       if tuple(s["segment_pool_id"]) == pool))

    # -- dispatch ----------------------------------------------------------
    @hot_path
    def _dispatch_chunk(self, op: str, chunk: np.ndarray,
                        trace_id: Optional[str] = None):
        """Pad one <= max_bucket chunk to its bucket and enqueue it.
        Returns (host outputs, event or None, real rows, kept inputs)."""
        n = chunk.shape[0]
        bucket = bucket_for(self.buckets, n)
        assert bucket is not None  # callers split oversize requests first
        padded = np.zeros((self._placed_rows(bucket), self._placed_dim),
                          dtype=np.float32)
        padded[:n, : self._dim] = chunk
        ex = self._executable(op, bucket, trace_id)
        if self.device.type != "cuda":
            host, event = _host_copies(ex.fn(torch.from_numpy(padded)))
            keep = ()
        else:
            src = torch.from_numpy(padded).pin_memory()
            with self._launch_lock, torch.cuda.stream(
                    torch.cuda.default_stream(self.device)):
                if ex.graph is None:
                    q = src.to(self.device, non_blocking=True)
                    host, event = _host_copies(ex.fn(q))
                else:
                    ex.q.copy_(src, non_blocking=True)
                    ex.graph.replay()
                    host, event = _host_copies(ex.outs)
            keep = (src,)
        with self._lock:
            self._dispatches[bucket] += 1
        obs.counter(mn.SERVING_DISPATCHES, op=op, bucket=bucket).inc()
        return host, event, n, keep

    @hot_path(allow=("np.asarray", "np.ascontiguousarray", "int"))
    def submit(self, queries, *, op: str = "search",
               trace_id: Optional[str] = None,
               tenant: Optional[str] = None) -> PendingSearch:
        """Enqueue ``queries`` and return a handle; oversize requests split
        into max-bucket chunks, enqueued back to back.  ``trace_id`` scopes
        the request's spans (None mints one when obs is on); ``tenant``
        tags it for the per-tenant series (None: no tenant series)."""
        if op not in OPS:
            raise ValueError(f"unknown op {op!r}; expected one of {OPS}")
        q = np.ascontiguousarray(np.asarray(queries, dtype=np.float32))
        if q.ndim != 2 or q.shape[1] != self._dim:
            raise ValueError(
                f"queries shape {q.shape} incompatible with database dim "
                f"{self._dim}")
        if trace_id is None:
            trace_id = obs.new_trace_id()
        # the audit sampler's only hot-path costs: one trace-id hash and,
        # for a sampled request, one copy of its queries (a later in-place
        # change by the caller cannot reach the replay)
        audit_q = (q.copy()
                   if op == "search" and obs.audit.sampled(trace_id)
                   else None)
        t0 = time.perf_counter()
        try:
            with obs.span("serving.dispatch", trace_id=trace_id, op=op,
                          rows=int(q.shape[0]),
                          **({"tenant": tenant}
                             if tenant is not None else {})) as sp:
                chunks = []
                lo = 0
                rungs = []
                for size in split_sizes(q.shape[0], self.buckets[-1]):
                    rungs.append(int(bucket_for(self.buckets, size)))
                    chunks.append(self._dispatch_chunk(
                        op, q[lo : lo + size], trace_id))
                    lo += size
                sp.set("buckets", rungs)
        except Exception:
            self._record_error(op, tenant=tenant)
            raise
        with self._lock:
            self._requests += 1
            self._queries += int(q.shape[0])
        obs.counter(mn.SERVING_REQUESTS, op=op).inc()
        obs.counter(mn.SERVING_QUERIES, op=op).inc(int(q.shape[0]))
        if tenant is not None:
            obs.counter(mn.TENANT_REQUESTS, tenant=tenant).inc()
        return PendingSearch(self, op, chunks, q.shape[0], t0, trace_id,
                             tenant, audit_queries=audit_q)

    def search(self, queries, *, return_sqrt: bool = False):
        """Bucketed exact search: (distances [Q, k], indices [Q, k]) as
        numpy arrays, bitwise ``ShardedKNN.search`` of the padded batch."""
        d, i = self.submit(queries, op="search").result()
        if return_sqrt:
            from knn_tpu_torch.ops.distance import metric_values

            d = np.asarray(metric_values(d, self.program.metric))
        return d, i

    def predict(self, queries) -> np.ndarray:
        """Bucketed classification: labels [Q] int32 (the majority vote
        of ``ShardedKNN.predict``)."""
        return self.submit(queries, op="predict").result()

    # -- trace replay ------------------------------------------------------
    def replay(self, requests: Sequence[np.ndarray], *, depth: int = 2):
        """Replay a request trace with at most ``depth`` requests in
        flight: request N+1 is padded and enqueued while request N runs.
        Returns ``(results, report)``; the report carries sustained q/s
        and the stats."""
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        results: List[object] = [None] * len(requests)
        pending: List[Tuple[int, PendingSearch]] = []
        total_rows = 0
        t0 = time.perf_counter()
        for idx, q in enumerate(requests):
            # drain before submitting: at most ``depth`` in flight, the
            # new one included
            while len(pending) >= depth:
                j, h = pending.pop(0)
                results[j] = h.result()
            total_rows += int(np.shape(q)[0])
            pending.append((idx, self.submit(q)))
        for j, h in pending:
            results[j] = h.result()
        wall = time.perf_counter() - t0
        report = {
            "requests": len(requests),
            "total_queries": total_rows,
            "wall_s": round(wall, 4),
            "sustained_qps": round(total_rows / wall, 2) if wall > 0 else None,
            "depth": depth,
            **self.stats(),
        }
        return results, report

    # -- accounting --------------------------------------------------------
    def _record_latency(self, seconds: float, op: str = "search", *,
                        trace_id: Optional[str] = None,
                        rows: Optional[int] = None,
                        tenant: Optional[str] = None) -> None:
        with self._lock:
            self._latencies_s.append((time.monotonic(), seconds))
        # the registry's counterpart of stats()["latency_ms"], each with its
        # own bounded window; the exemplar keeps the worst samples' trace
        # ids joinable to their spans
        obs.histogram(mn.SERVING_REQUEST_LATENCY, op=op).observe(
            seconds, exemplar=trace_id)
        if tenant is not None:
            obs.histogram(mn.TENANT_REQUEST_LATENCY, tenant=tenant).observe(
                seconds, exemplar=trace_id)
        obs.record_span("serving.request", trace_id, seconds, op=op,
                        **({} if rows is None else {"rows": int(rows)}),
                        **({} if tenant is None else {"tenant": tenant}))

    def _submit_audit(self, handle: PendingSearch, res) -> None:
        """Enqueue one sampled, already-served request for the audit
        worker's exact replay (obs.audit): one bounded queue put under the
        sampler's row budget.  The oracle below — a float64 scan of every
        placed row (``refine_shared_exact``) and the float64 recompute of
        the served rows (``_pairwise_f64``) — runs only on the audit
        worker.  The request was served already, so a failure here drops
        the record with an ``audit.submit_error`` event and never reaches
        the caller."""
        try:
            d, i = res
            program = self.program
            k = self.k
            metric = program.metric

            def oracle(queries, served_ids):
                from knn_tpu_torch.ops.refine import (_pairwise_f64,
                                                      refine_shared_exact)

                db = program._host_train()
                # a dot placement is one column wider than the request
                # (the norm augmentation): its rows are the first D columns
                if db.shape[1] != queries.shape[1]:
                    db = db[:, : queries.shape[1]]
                n = db.shape[0]
                od, oi = refine_shared_exact(
                    db, queries, np.arange(n), k, metric=metric)
                ids = np.asarray(served_ids, np.int64)[:, :k]
                valid = (ids >= 0) & (ids < n)
                safe = np.where(valid, ids, 0)
                se = _pairwise_f64(queries, db[safe], metric)
                return od, oi, np.where(valid, se, np.inf)

            q_audit = handle._audit_queries
            obs.audit.submit(obs.audit.AuditRecord(
                trace_id=handle.trace_id,
                tenant=handle.tenant,
                k=k,
                queries=q_audit,
                served_d=np.asarray(d),
                served_ids=np.asarray(i),
                epoch=None,
                cost_rows=int(q_audit.shape[0]) * int(program.n_train),
                oracle=oracle,
            ))
        except Exception:  # noqa: BLE001 - audit must not fail serving
            obs.emit_event("audit.submit_error", op=handle._op,
                           trace_id=handle.trace_id)

    def _record_error(self, op: str = "search", *,
                      tenant: Optional[str] = None) -> None:
        with self._lock:
            self._errors += 1
        obs.counter(mn.SERVING_ERRORS, op=op).inc()
        if tenant is not None:
            obs.counter(mn.TENANT_ERRORS, tenant=tenant).inc()

    def _tuning_info(self) -> Optional[dict]:
        """Resolved coarse-kernel knobs and their provenance for this
        placement's shape (``tuning.resolve_full``, keyed as
        ``ShardedKNN.search_certified`` keys it: the placed width, l2, the
        compute dtype, this card).  Memoized; a failed cache read gives
        None (tuning is reporting here, not a dispatch dependency)."""
        cached = getattr(self, "_tuning_memo", False)
        if cached is not False:
            return cached
        try:
            from knn_tpu_torch import tuning

            p = self.program
            knobs, info = tuning.resolve_full(
                p.n_train, self._placed_dim, self.k, metric="l2",
                dtype=p._dtype_key,
                device_kind=tuning.device_kind_of(p.device))
            memo = {"resolved_knobs": knobs, **info}
        except (OSError, ValueError):
            memo = None
        self._tuning_memo = memo
        return memo

    def stats(self, *, include_slo: bool = True) -> dict:
        """Capture (compile) / dispatch accounting and request latency
        percentiles.  With telemetry on it also carries ``slo`` (one
        burn-rate evaluation over the process's objectives; skipped with
        ``include_slo=False``, as the health report does, which evaluates
        once for every engine) and ``slowest_requests`` (the exemplar
        table, no inline waterfalls), and ``quality`` while the audit
        sampler is armed; with telemetry off the shape is the JAX
        package's telemetry-off one."""
        tuning_info = self._tuning_info()
        slo_section = (obs.slo_report()
                       if include_slo and obs.enabled() else None)
        slowest = None
        quality = None
        if obs.enabled():
            slowest = obs.waterfall.slowest_table(with_waterfalls=False)
            if obs.audit.audit_rate() > 0:
                quality = obs.audit.status()
        with self._lock:
            return {
                **({"tuning": tuning_info} if tuning_info else {}),
                **({"slo": slo_section} if slo_section else {}),
                **({"quality": quality} if quality else {}),
                **({"slowest_requests": slowest}
                   if slowest is not None else {}),
                "buckets": list(self.buckets),
                "compile_count": int(sum(self._compiles.values())),
                "executables": len(self._execs),
                "per_bucket_compiles": {
                    int(b): int(c) for b, c in sorted(self._compiles.items())
                },
                "per_bucket_dispatches": {
                    int(b): int(c) for b, c in sorted(self._dispatches.items())
                },
                "requests": self._requests,
                "requests_total": self._requests,
                "queries_total": self._queries,
                "errors_total": self._errors,
                "donate_queries": self.donate_queries,
                "latency_ms": latency_summary(self._latencies_s),
            }
