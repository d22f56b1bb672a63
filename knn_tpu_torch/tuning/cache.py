"""On-disk winner cache of the port's kernel autotuner — a copy of
knn_tpu/tuning/cache.py for the CUDA kernels.

One JSON file maps ``cache_key(device_kind, n, d, k, metric, dtype)`` to
the measured winning knob set plus its provenance (timings, gate verdict,
torch version, timestamp), so a later ``ShardedKNN.search_certified`` on
the same card and shape resolves its knobs from disk with zero re-timing.

File format (``version`` guards future migrations)::

    {
      "version": 1,
      "entries": {
        "NVIDIA H100 80GB HBM3|n1000000|d128|k100|l2|float32|rltorch1|kvtorch1-...": {
          "knobs": {"kernel": "tiled", "precision": "bf16x3", ...},
          "winner_ms": 61.8,
          "timings_ms": {"<candidate label>": ms | null (ineligible)},
          "gate": "bitwise-vs-reference",
          "measured_at": "...Z", "torch_version": "...",
          "n_queries": 256, "runs": 2
        }
      }
    }

Reads are memoized on (mtime, size), so a resolve costs a ``stat``, not a
parse; writes are atomic (tmp + rename).  Differences from the JAX
package's cache: the key's kernel token hashes the port's CUDA sources
(:func:`kernel_version_token`), so a rebuilt kernel re-keys every winner
and no entry of the JAX package can match; the key's roofline token is
the port's H100 model version (:func:`roofline_token`, ``rltorch<n>``),
so an entry attributed under another model misses, as the JAX package's
``rl<n>`` does; the path is an argument (default :func:`default_cache_path`), never an
environment switch.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
import tempfile
import threading
from pathlib import Path
from typing import Optional

CACHE_VERSION = 1
#: the port's own version of what a winner measures, in every key: bump it
#: when the search or the measured program changes without a kernel change
PORT_VERSION = 1
#: the sources of every CUDA kernel a winner is a measurement of
_CSRC = Path(__file__).resolve().parent.parent / "csrc"

_lock = threading.Lock()
#: path -> ((mtime_ns, size), entries) read memo
_read_memo: dict = {}


def default_cache_path() -> str:
    """``~/.cache/knn_tpu_torch/autotune.json``: per-user winners stay out
    of the repository tree."""
    return os.path.join(os.path.expanduser("~"), ".cache", "knn_tpu_torch",
                        "autotune.json")


@functools.lru_cache(maxsize=1)
def kernel_version_token() -> str:
    """The kernel code a winner was measured on, baked into every cache
    key: the port version and a hash of every CUDA source and header of
    ``knn_tpu_torch/csrc`` (the files the kernels build from).  An edited
    kernel re-keys every winner, so a stale entry falls back to the
    defaults instead of steering a kernel it never timed; the ``torch``
    prefix keeps every JAX package key (``kv<int>``) from matching."""
    h = hashlib.sha256()
    for src in sorted(_CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return f"torch{PORT_VERSION}-{h.hexdigest()[:12]}"


def roofline_token() -> str:
    """The roofline model version baked into every key: entries carry the
    winner's attribution, so one rendered under another model
    (knn_tpu_torch.obs.roofline.MODEL_VERSION) must miss."""
    from knn_tpu_torch.obs.roofline import MODEL_VERSION

    return f"torch{MODEL_VERSION}"


def cache_key(device_kind: str, n: int, d: int, k: int,
              metric: str, dtype: Optional[str] = None) -> str:
    """The shape key a winner is valid for; any field mismatch misses.
    ``dtype`` is the placement's compute dtype name (None = float32), in
    the JAX package's key layout; the trailing ``rl<token>|kv<token>`` tie
    the entry to the roofline model its attribution was rendered under
    (:func:`roofline_token`) and the kernel sources that were measured
    (:func:`kernel_version_token`)."""
    return (f"{device_kind}|n{int(n)}|d{int(d)}|k{int(k)}|"
            f"{metric.lower()}|{dtype or 'float32'}|rl{roofline_token()}"
            f"|kv{kernel_version_token()}")


class TuneCache:
    """Handle on one cache file; ``get`` / ``put`` are the whole API."""

    def __init__(self, path: Optional[str] = None):
        self.path = path or default_cache_path()

    def load(self) -> dict:
        """All entries (empty when the file is absent or corrupt: a broken
        cache degrades to the defaults, never to an error)."""
        try:
            st = os.stat(self.path)
        except OSError:
            return {}
        sig = (st.st_mtime_ns, st.st_size)
        with _lock:
            memo = _read_memo.get(self.path)
            if memo and memo[0] == sig:
                return memo[1]
        try:
            with open(self.path) as f:
                data = json.load(f)
            if (not isinstance(data, dict)
                    or data.get("version") != CACHE_VERSION):
                return {}
            entries = data.get("entries", {})
            if not isinstance(entries, dict):
                return {}
        except (OSError, json.JSONDecodeError, UnicodeDecodeError):
            return {}
        with _lock:
            _read_memo[self.path] = (sig, entries)
        return entries

    def get(self, key: str) -> Optional[dict]:
        entry = self.load().get(key)
        return entry if isinstance(entry, dict) else None

    def put(self, key: str, entry: dict) -> None:
        """Inserts or replaces one entry; atomic write (tmp + rename)."""
        with _lock:
            entries = {}
            try:
                with open(self.path) as f:
                    data = json.load(f)
                if (isinstance(data, dict)
                        and data.get("version") == CACHE_VERSION
                        and isinstance(data.get("entries"), dict)):
                    entries = data["entries"]
            except (OSError, json.JSONDecodeError, UnicodeDecodeError):
                pass
            entries[key] = entry
            payload = {"version": CACHE_VERSION, "entries": entries}
            d = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(d, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
            try:
                with os.fdopen(fd, "w") as f:
                    json.dump(payload, f, indent=1, sort_keys=True)
                os.replace(tmp, self.path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
            _read_memo.pop(self.path, None)
