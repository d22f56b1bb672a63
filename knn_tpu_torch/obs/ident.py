"""Process identity — the stamp every telemetry payload carries (the port
of knn_tpu/obs/ident.py): ``write_json_snapshot`` / ``/metrics.json``
(obs.export) and every line of the JSONL event sink (obs.trace) stamp
it, so two processes' merged logs stay attributable.

One process, one card: its host and pid, process 0 of 1, no coordinator,
and the repository commit read from ``.git`` at the root of the checkout
the package sits in (None elsewhere).  The JAX package's
``set_identity`` (its multi-host init stamps the real process index)
waits for multi-GPU (ROADMAP queue A item 8).
"""

from __future__ import annotations

import functools
import os
import socket
from typing import Optional

from knn_tpu_torch.obs import names


@functools.lru_cache(maxsize=1)
def _commit() -> Optional[str]:
    """The checkout's HEAD commit (12 hex), read from ``.git`` at the root
    of the checkout this package sits in — never above it; None outside a
    git checkout or on any read problem."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    head = os.path.join(root, ".git", "HEAD")
    try:
        with open(head) as f:
            ref = f.read().strip()
        if ref.startswith("ref:"):
            with open(os.path.join(root, ".git",
                                   *ref.split(None, 1)[1].split("/"))) as f:
                return f.read().strip()[:12]
        return ref[:12]
    except OSError:
        return None


def identity() -> dict:
    """host, pid, process_index, process_count, device_kind,
    coordinator_address, commit and the catalog-version token."""
    return {
        "host": socket.gethostname(),
        "pid": os.getpid(),
        "process_index": 0,
        "process_count": 1,
        "device_kind": None,
        "coordinator_address": None,
        "commit": _commit(),
        "catalog_version": names.catalog_version(),
    }
