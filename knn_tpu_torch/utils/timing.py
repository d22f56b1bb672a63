"""Per-phase timing — the port of knn_tpu/utils/timing.py (``PhaseTimer``).

PyTorch launches GPU work asynchronously, so a phase boundary on the host
clock says nothing until the queued work has finished: the timer
synchronizes CUDA when a phase opens and when it closes, so each phase is
billed its own device work.  A PhaseTimer may be shared across threads
(mutation is locked); phases must not nest within one thread (nesting
double-counts the phase sum and raises instead).  Each closed phase is
also observed into ``knn_tpu_phase_seconds{phase=...}`` and emitted as a
``phase`` event (knn_tpu_torch.obs), as the JAX package's timer does.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Optional

import torch

from knn_tpu_torch import obs
from knn_tpu_torch.device import synchronize
from knn_tpu_torch.obs import names as _mn


class PhaseTimer:
    """Accumulates named phase durations; ``total`` covers first start to
    last stop (the reference's single Wtime pair, knn_mpi.cpp:134,396).
    ``device``: the CUDA device to synchronize at phase boundaries (None
    or a CPU device: no synchronization)."""

    def __init__(self, device: Optional[torch.device] = None):
        self.device = device
        self.phases: Dict[str, float] = {}
        self._t0: Optional[float] = None
        self._t_end: Optional[float] = None
        self._lock = threading.Lock()
        self._open = threading.local()

    @contextlib.contextmanager
    def phase(self, name: str):
        already = getattr(self._open, "name", None)
        if already is not None:
            raise RuntimeError(
                f"PhaseTimer.phase({name!r}) opened inside still-open "
                f"phase {already!r}: nested phases double-count the totals")
        self._open.name = name
        synchronize(self.device)
        start = time.perf_counter()
        with self._lock:
            if self._t0 is None:
                self._t0 = start
        try:
            yield
        finally:
            synchronize(self.device)
            end = time.perf_counter()
            self._open.name = None
            with self._lock:
                self.phases[name] = self.phases.get(name, 0.0) + (end - start)
                if self._t_end is None or end > self._t_end:
                    self._t_end = end
            obs.histogram(_mn.PHASE_SECONDS, phase=name).observe(end - start)
            obs.emit_event("phase", phase=name, dur_s=round(end - start, 6))

    @property
    def total(self) -> float:
        with self._lock:
            if self._t0 is None or self._t_end is None:
                return 0.0
            return self._t_end - self._t0

    def summary(self) -> Dict[str, float]:
        """Every phase's seconds and their ``total``."""
        with self._lock:
            out = dict(self.phases)
        out["total"] = self.total
        return out
