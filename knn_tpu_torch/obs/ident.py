"""Process identity — the stamp every telemetry payload carries (the port
of knn_tpu/obs/ident.py): ``write_json_snapshot`` / ``/metrics.json``
(obs.export) and every line of the JSONL event sink (obs.trace) stamp
it, so two processes' merged logs stay attributable.

Defaults are one process on one card: its host and pid, process 0 of 1,
no coordinator, and the repository commit read from ``.git`` at the root
of the checkout the package sits in (None elsewhere).
:func:`set_identity` stamps other values (a fleet member's process index
and count, its device kind), which every later payload carries and the
fleet plane (knn_tpu_torch.obs.fleet) keys its members by;
:func:`reset_identity` drops them.
"""

from __future__ import annotations

import functools
import os
import socket
import threading
from typing import Dict, Optional

from knn_tpu_torch.obs import names

#: the fields set_identity may stamp
FIELDS = ("host", "process_index", "process_count", "device_kind",
          "coordinator_address", "commit")

_lock = threading.Lock()
_overrides: Dict[str, object] = {}


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


def set_identity(**fields) -> None:
    """Override identity fields (:data:`FIELDS`); an unknown field name is
    refused, so a mistyped stamp cannot vanish from every payload."""
    bad = set(fields) - set(FIELDS)
    if bad:
        raise ValueError(f"unknown identity field(s) {sorted(bad)}; "
                         f"allowed: {sorted(FIELDS)}")
    with _lock:
        _overrides.update(fields)


def reset_identity() -> None:
    """Drop every override."""
    with _lock:
        _overrides.clear()


def identity() -> dict:
    """host, pid, process_index, process_count, device_kind,
    coordinator_address, commit and the catalog-version token, with the
    :func:`set_identity` overrides applied."""
    with _lock:
        ov = dict(_overrides)
    return {
        "host": socket.gethostname(),
        "pid": os.getpid(),
        "process_index": 0,
        "process_count": 1,
        "device_kind": None,
        "coordinator_address": None,
        "commit": _commit(),
        "catalog_version": names.catalog_version(),
        **ov,
    }
