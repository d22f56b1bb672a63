"""Resumable query-batch streaming — the port of knn_tpu/streaming.py.

Large query sets run as a sequence of fixed-size batches; each batch's
top-k lands in its own atomically written ``.npz`` under a checkpoint
directory, with a manifest that refuses to resume onto another database,
query set or configuration.  A re-run skips finished batches, so a
preempted run loses at most one batch.

:class:`StreamingSearch` streams any ``search_fn(batch) -> (d, i)``;
:class:`StreamingCertifiedSearch` any ``search_fn(batch) -> (d | None, i,
stats)`` and persists each segment's certificate stats beside its
results.  :func:`streaming_knn` and :func:`streaming_certified_knn` place
the database once (a :class:`~knn_tpu_torch.parallel.sharded.ShardedKNN`
on ``device``, default ``cuda``, or on ``mesh``) and stream through
``search`` / ``search_certified``.

Per-batch retry (``max_retries``) keeps the JAX package's classifier
vocabulary for a caller's ``search_fn``: known-transient failures get the
full retry window, deterministic ones (out of memory, invalid argument,
...) propagate at once, and an unknown one stops retrying when it
repeats verbatim.  Where the port differs (ROADMAP queue C): a CUDA error
— a device fault, a cuBLAS status, CUDA's out of memory — raises on its
first occurrence whatever its text (after an illegal access the context
is unusable, so a retry could only repeat it).  The entry points place
on ``device`` or on ``mesh`` (not both; ``merge`` its strategy, the JAX
package's default ``"allgather"``); their manifests echo the placement's
device type and the strategy.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Callable, Optional, Tuple

import numpy as np

#: retry wait before attempt n + 1: _RETRY_WAIT_S * 2 ** n seconds
_RETRY_WAIT_S = 0.5

#: error-text signatures of a deterministic failure, which a retry can
#: only repeat (the JAX package's list, sharded.py:394-398)
_DETERMINISTIC_SIGNATURES = (
    "resource_exhausted", "resource exhausted", "out of memory",
    "invalid_argument", "invalid argument", "failed_precondition",
    "failed precondition", "unimplemented", "mosaic",
)
#: signatures of known-transient failures, checked first: they keep the
#: full retry window even when attempts fail identically
_TRANSIENT_SIGNATURES = (
    "unavailable", "deadline_exceeded", "deadline exceeded", "aborted",
    "cancelled", "connection", "socket", "data_loss", "data loss",
)
#: signatures of an error raised by the CUDA runtime or its libraries
_DEVICE_SIGNATURES = ("cuda", "cublas", "cudnn", "cusparse", "cufft")


def _is_device_error(e: BaseException) -> bool:
    """True for an error of the CUDA runtime or its libraries."""
    import torch

    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(e, accel):
        return True
    if isinstance(e, torch.cuda.OutOfMemoryError):
        return True
    s = f"{type(e).__name__}: {e}".lower()
    return any(sig in s for sig in _DEVICE_SIGNATURES)


def _classify_failure(e: Exception) -> str:
    """'device' (never retried) | 'transient' (full retry window) |
    'deterministic' (never retried) | 'unknown' (retried until the
    identical error repeats)."""
    if _is_device_error(e):
        return "device"
    s = f"{type(e).__name__}: {e}".lower()
    if any(sig in s for sig in _TRANSIENT_SIGNATURES):
        return "transient"
    if any(sig in s for sig in _DETERMINISTIC_SIGNATURES):
        return "deterministic"
    return "unknown"


def _retry(fn, what: str, attempts: int):
    """``fn()`` with bounded retries under :func:`_classify_failure`;
    ``ValueError`` / ``TypeError`` (a caller's bug) propagate at once."""
    err = None
    for attempt in range(attempts):
        try:
            return fn()
        except (ValueError, TypeError):
            raise
        except Exception as e:
            cls = _classify_failure(e)
            if cls in ("device", "deterministic"):
                raise
            if cls == "unknown" and err is not None and repr(e) == repr(err):
                raise RuntimeError(
                    f"{what} failed after {attempt + 1} attempts "
                    f"(identical error repeated)") from e
            err = e
            if attempt + 1 < attempts:
                time.sleep(_RETRY_WAIT_S * (2 ** attempt))
    raise RuntimeError(f"{what} failed after {attempts} attempts") from err


def _host(x) -> np.ndarray:
    """A search output (numpy array or tensor on any device) on the host."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _fingerprint(db: np.ndarray) -> str:
    """Cheap database identity: shape + dtype + strided sample digest."""
    h = hashlib.sha256()
    h.update(repr((db.shape, str(db.dtype))).encode())
    flat = np.ascontiguousarray(db).reshape(-1)
    step = max(1, flat.size // 4096)
    h.update(np.ascontiguousarray(flat[::step]).tobytes())
    return h.hexdigest()[:32]


@dataclasses.dataclass
class StreamState:
    """Progress snapshot: which batches are done."""

    n_queries: int
    batch_size: int
    n_batches: int
    done: list

    @property
    def complete(self) -> bool:
        return len(self.done) == self.n_batches


class StreamingSearch:
    """Checkpointed batch-streaming KNN search over a placed program.

    ``search_fn(query_batch) -> (dists [B, k], idx [B, k])`` (numpy arrays
    or tensors) is typically ``ShardedKNN.search``, but any callable with
    that contract works."""

    MANIFEST = "manifest.json"

    def __init__(
        self,
        search_fn: Callable[[np.ndarray], Tuple],
        k: int,
        checkpoint_dir: str,
        *,
        batch_size: int = 512,
        db_fingerprint: Optional[str] = None,
        search_config: Optional[dict] = None,
        max_retries: int = 2,
    ):
        self._fn = search_fn
        self.k = k
        self.dir = checkpoint_dir
        self.batch_size = batch_size
        self.fingerprint = db_fingerprint
        #: JSON-serializable echo of the search configuration — part of the
        #: resume guard: batches computed under another configuration are
        #: another run
        self.search_config = search_config or {}
        self.max_retries = max_retries
        os.makedirs(self.dir, exist_ok=True)

    # -- manifest ----------------------------------------------------------
    def _manifest_path(self) -> str:
        return os.path.join(self.dir, self.MANIFEST)

    def _expected_manifest(self, queries: np.ndarray) -> dict:
        return {
            "n_queries": int(queries.shape[0]),
            "query_fingerprint": _fingerprint(queries),
            "batch_size": self.batch_size,
            "k": self.k,
            "db_fingerprint": self.fingerprint,
            "search_config": self.search_config,
        }

    def _check_manifest(self, queries: np.ndarray) -> None:
        path = self._manifest_path()
        expected = self._expected_manifest(queries)
        if os.path.exists(path):
            with open(path) as f:
                found = json.load(f)
            if found != expected:
                raise ValueError(
                    f"checkpoint dir {self.dir} belongs to a different run:\n"
                    f"  found    {found}\n  expected {expected}\n"
                    "use a fresh directory or delete the stale checkpoint"
                )
        else:
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(expected, f)
            os.replace(tmp, path)

    def _batch_path(self, b: int) -> str:
        return os.path.join(self.dir, f"batch_{b:06d}.npz")

    def state(self, n_queries: int) -> StreamState:
        n_batches = -(-n_queries // self.batch_size)
        done = sorted(
            int(name[len("batch_") : -len(".npz")])
            for name in os.listdir(self.dir)
            if name.startswith("batch_") and name.endswith(".npz")
        )
        return StreamState(n_queries, self.batch_size, n_batches, done)

    # -- execution ---------------------------------------------------------
    #: pad each batch to ``batch_size`` and strip after (one shape);
    #: subclasses whose search fn pads internally set False and receive
    #: the raw tail chunk
    _pad_batches = True

    def _run_batch(self, chunk: np.ndarray):
        d, i = _retry(lambda: self._fn(chunk), "stream batch",
                      self.max_retries + 1)
        return _host(d), _host(i)

    def _strip(self, result, pad: int):
        """Drop the ``pad`` trailing padded rows from a batch result."""
        d, i = result
        return d[:-pad], i[:-pad]

    def _payload(self, result) -> dict:
        """Batch result -> the arrays persisted in its ``.npz``."""
        d, i = result
        return {"d": d, "i": i}

    def run(self, queries: np.ndarray):
        """Stream all batches, skipping finished ones; returns
        :meth:`assemble` of the complete run."""
        queries = np.asarray(queries)
        n = queries.shape[0]
        self._check_manifest(queries)
        st = self.state(n)
        done = set(st.done)
        for b in range(st.n_batches):
            if b in done:
                continue
            lo = b * self.batch_size
            chunk = queries[lo : lo + self.batch_size]
            pad = self.batch_size - chunk.shape[0]
            if pad and self._pad_batches:
                chunk = np.pad(chunk, ((0, pad), (0, 0)))
            result = self._run_batch(chunk)
            if pad and self._pad_batches:
                result = self._strip(result, pad)
            tmp = self._batch_path(b) + ".tmp"
            with open(tmp, "wb") as f:
                np.savez(f, **self._payload(result))
            os.replace(tmp, self._batch_path(b))
        return self.assemble(n)

    def _iter_complete(self, n_queries: int):
        """Each finished batch's persisted arrays (dict), after checking
        the run is complete."""
        st = self.state(n_queries)
        if not st.complete:
            missing = sorted(set(range(st.n_batches)) - set(st.done))
            raise RuntimeError(
                f"stream incomplete; missing batches {missing[:8]}...")
        for b in range(st.n_batches):
            with np.load(self._batch_path(b)) as z:
                yield {key: z[key] for key in z.files}

    def assemble(self, n_queries: int) -> Tuple[np.ndarray, np.ndarray]:
        """Concatenate all finished batches (requires a complete run)."""
        ds, is_ = [], []
        for z in self._iter_complete(n_queries):
            ds.append(z["d"])
            is_.append(z["i"])
        return np.concatenate(ds)[:n_queries], np.concatenate(is_)[:n_queries]


class StreamingCertifiedSearch(StreamingSearch):
    """Checkpointed streaming for certified-exact sweeps.

    ``search_fn(query_batch) -> (dists | None, idx, stats)`` is typically
    a closure over :meth:`ShardedKNN.search_certified`.  Each segment
    persists its results and its certificate ``stats`` dict, so a resumed
    run reassembles the whole sweep's accounting.  Segments are not padded
    (the certified search batches internally).  ``assemble`` returns
    ``(dists | None, idx, stats)`` with numeric stats summed across
    segments."""

    _pad_batches = False

    def _run_batch(self, chunk: np.ndarray):
        d, i, stats = _retry(lambda: self._fn(chunk),
                             "certified stream batch", self.max_retries + 1)
        return (None if d is None else _host(d), _host(i), dict(stats))

    def _payload(self, result) -> dict:
        d, i, stats = result
        payload = {"i": i, "stats": json.dumps(stats, default=_json_value)}
        if d is not None:
            payload["d"] = d
        return payload

    def assemble(self, n_queries: int):
        ds, is_, agg = [], [], {}
        n_batches = 0
        for z in self._iter_complete(n_queries):
            n_batches += 1
            if "d" in z:
                ds.append(z["d"])
            is_.append(z["i"])
            for key, v in json.loads(str(z["stats"])).items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    agg[key] = agg.get(key, 0) + v
                else:
                    agg[key] = v
        d = np.concatenate(ds)[:n_queries] if len(ds) == n_batches else None
        return d, np.concatenate(is_)[:n_queries], agg


def _json_value(v):
    """numpy scalars and arrays in a stats dict, as JSON values."""
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    return str(v)


def streaming_certified_knn(
    db: np.ndarray,
    queries: np.ndarray,
    k: int,
    checkpoint_dir: str,
    *,
    segment_size: int = 4096,
    metric: str = "l2",
    train_tile: Optional[int] = None,
    compute_dtype=None,
    max_retries: int = 2,
    selector: str = "pallas",
    margin: int = 28,
    batch_size: Optional[int] = None,
    return_distances: bool = True,
    device=None,
    mesh=None,
    merge: str = "allgather",
    **certified_kwargs,
):
    """Place ``db`` once on ``device`` (None: cuda) or ``mesh`` (not both;
    ``merge`` its db-axis strategy, the JAX package's default), stream
    ``queries``
    through ``search_certified`` in resumable ``segment_size`` chunks.
    ``batch_size`` is the certified search's inner device batch;
    ``segment_size`` the durable checkpoint unit.  Every certified knob
    (``tile_n``, ``precision``, ``kernel``, ``final_select``, ...) passes
    through and is echoed into the manifest.  ``selector`` defaults to
    ``"pallas"``, the port's ``search_certified`` default (the JAX
    package's streaming entry defaults to it too)."""
    from knn_tpu_torch.parallel.sharded import ShardedKNN

    program = ShardedKNN(db, k=k, metric=metric, train_tile=train_tile,
                         compute_dtype=compute_dtype, device=device,
                         mesh=mesh, merge=merge)
    stream = StreamingCertifiedSearch(
        lambda chunk: program.search_certified(
            chunk, selector=selector, margin=margin, batch_size=batch_size,
            return_distances=return_distances, **certified_kwargs,
        ),
        k, checkpoint_dir,
        batch_size=segment_size, db_fingerprint=_fingerprint(db),
        search_config={
            "certified": True,
            "selector": selector,
            "margin": margin,
            "inner_batch_size": batch_size,
            "return_distances": return_distances,
            "metric": metric,
            "merge": merge,
            "train_tile": train_tile,
            "compute_dtype": (None if compute_dtype is None
                              else str(compute_dtype)),
            "device": program.device.type,
            **{key: str(v) for key, v in sorted(certified_kwargs.items())},
        },
        max_retries=max_retries,
    )
    return stream.run(queries)


def streaming_knn(
    db: np.ndarray,
    queries: np.ndarray,
    k: int,
    checkpoint_dir: str,
    *,
    batch_size: int = 512,
    metric: str = "l2",
    train_tile: Optional[int] = None,
    compute_dtype=None,
    max_retries: int = 2,
    device=None,
    mesh=None,
    merge: str = "allgather",
) -> Tuple[np.ndarray, np.ndarray]:
    """Place ``db`` once on ``device`` (None: cuda) or ``mesh`` (not both;
    ``merge`` its db-axis strategy), stream ``queries`` through
    ``ShardedKNN.search`` with checkpointing, and resume from
    ``checkpoint_dir`` if an earlier run was interrupted."""
    from knn_tpu_torch.parallel.sharded import ShardedKNN

    program = ShardedKNN(db, k=k, metric=metric, train_tile=train_tile,
                         compute_dtype=compute_dtype, device=device,
                         mesh=mesh, merge=merge)
    stream = StreamingSearch(
        program.search, k, checkpoint_dir,
        batch_size=batch_size, db_fingerprint=_fingerprint(db),
        search_config={
            "metric": metric,
            "merge": merge,
            "train_tile": train_tile,
            "compute_dtype": (None if compute_dtype is None
                              else str(compute_dtype)),
            "device": program.device.type,
        },
        max_retries=max_retries,
    )
    return stream.run(queries)
