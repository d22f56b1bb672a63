"""Deadline-aware admission control for the serving queue — shed, don't
collapse; the port of knn_tpu/serving/admission.py.

An unbounded :class:`~knn_tpu_torch.serving.queue.QueryQueue` under
overload grows its backlog without limit: every request is eventually
served, long after its caller stopped caring.  The controls:

- **bounded depth** — past ``max_depth`` OUTSTANDING requests (queued
  plus in flight: dispatch-ahead drains the pending list into the device
  pipeline almost at once, so a pending-only bound would never bind),
  ``submit()`` raises :class:`QueueFullError`;
- **deadline-aware shedding** — a request whose deadline cannot be met
  given the current queue-wait estimate is refused at submit
  (:class:`DeadlineError`, reason ``deadline``), and one whose deadline
  expires while queued is shed before dispatch (reason ``expired``);
- **per-tenant token-bucket quotas** — each tenant spends one token per
  request (refilled at ``rate_qps``, capped at ``burst``); an empty
  bucket rejects with :class:`QuotaExceededError`;
- **starvation-safe priority ordering** — lower ``priority`` dispatches
  first, but a queued request's effective priority decays by one level
  per ``aging_s`` seconds of wait, so it can be delayed, never starved.

Everything is off by default: a ``QueryQueue`` built without an
:class:`AdmissionConfig` behaves as the queue without admission — same
results, same ``stats()`` shape.  Decisions surface in the queue's
``stats()["admission"]`` section.

Tenant ids grow per-tenant state for the process lifetime (token buckets,
stats slots): use a bounded set of tenant classes, never per-request ids.

Where the port differs (ROADMAP queue C): every field of
:class:`AdmissionConfig` is an argument with the reference's default —
there is no ``from_env`` and no environment switch.

Telemetry (knn_tpu_torch.obs, admission.py:265, 291, 304, 350, 361 of the
JAX package): ``ADMISSION_ADMITTED`` / ``ADMISSION_REJECTED`` /
``ADMISSION_SHED`` by tenant (and reason), beside the same counts in
``stats()``, and the ``ADMISSION_WAIT_ESTIMATE`` gauge each time the
estimate is taken.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from knn_tpu_torch import obs
from knn_tpu_torch.obs import names as mn

#: tenant label used for untagged traffic in the admission accounting
UNTAGGED = "-"


class AdmissionError(RuntimeError):
    """A request the admission controller refused or shed; ``reason`` is
    the machine-readable outcome tag the loadgen records (overridable per
    instance so one class carries both the submit-time ``deadline`` and
    the dispatch-time ``expired`` tags)."""

    reason = "rejected"

    def __init__(self, message: str, *, tenant: Optional[str] = None,
                 reason: Optional[str] = None):
        super().__init__(message)
        self.tenant = tenant
        if reason is not None:
            self.reason = reason


class QueueFullError(AdmissionError):
    """Outstanding depth reached ``max_depth`` — explicit rejection
    instead of unbounded backlog growth."""

    reason = "queue_full"


class QuotaExceededError(AdmissionError):
    """The tenant's token bucket is empty."""

    reason = "quota"


class DeadlineError(AdmissionError):
    """The deadline cannot be met (at submit) or already expired (at
    dispatch) — shed before wasting device time."""

    reason = "deadline"


def parse_quotas(text: str) -> Dict[str, Tuple[float, float]]:
    """``tenant:rate[:burst],...`` -> quota dict (burst defaults to
    max(1, rate)) — the CLI flag's grammar."""
    quotas: Dict[str, Tuple[float, float]] = {}
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        bits = part.split(":")
        if len(bits) not in (2, 3):
            raise ValueError(
                f"quota entry {part!r}: expected tenant:rate[:burst]")
        rate = float(bits[1])
        burst = float(bits[2]) if len(bits) == 3 else max(1.0, rate)
        quotas[bits[0]] = (rate, burst)
    return quotas


class _TokenBucket:
    """Classic token bucket: ``rate`` tokens/s refill, ``burst`` cap.
    ``take`` is called under the controller lock (no internal one)."""

    __slots__ = ("rate", "burst", "_tokens", "_t")

    def __init__(self, rate: float, burst: float, now: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self._tokens = float(burst)  # start full: cold tenants may burst
        self._t = now

    def take(self, now: float, n: float = 1.0) -> bool:
        self._tokens = min(self.burst,
                           self._tokens + (now - self._t) * self.rate)
        self._t = now
        if self._tokens >= n:
            self._tokens -= n
            return True
        return False


@dataclass(frozen=True)
class AdmissionConfig:
    """Declarative admission policy; every field optional and off by
    default — an all-defaults config admits everything FIFO, as no config
    at all does (but carries the accounting)."""

    #: outstanding-request bound (queued + in flight); None = unbounded
    max_depth: Optional[int] = None
    #: deadline-aware shedding (submit-time estimate + queued expiry);
    #: requests without a deadline are never shed
    shed: bool = False
    #: deadline applied to requests submitted without one (ms)
    default_deadline_ms: Optional[float] = None
    #: tenant -> (rate_qps, burst) token-bucket quota
    quotas: Dict[str, Tuple[float, float]] = field(default_factory=dict)
    #: tenant -> priority level (lower dispatches first; default 0)
    priorities: Dict[str, int] = field(default_factory=dict)
    #: seconds of queue wait per priority level of aging decay (a level-5
    #: tenant waiting 5 * aging_s competes evenly with a fresh level 0)
    aging_s: float = 0.25

    def validate(self) -> None:
        if self.max_depth is not None and self.max_depth < 1:
            raise ValueError(
                f"max_depth must be >= 1, got {self.max_depth}")
        if (self.default_deadline_ms is not None
                and self.default_deadline_ms <= 0):
            raise ValueError(
                f"default_deadline_ms must be > 0, got "
                f"{self.default_deadline_ms}")
        for tenant, (rate, burst) in self.quotas.items():
            if rate <= 0 or burst < 1:
                raise ValueError(
                    f"quota for tenant {tenant!r} must have rate > 0 and "
                    f"burst >= 1, got ({rate}, {burst})")
        if self.aging_s <= 0:
            raise ValueError(f"aging_s must be > 0, got {self.aging_s}")


class AdmissionController:
    """The queue-side policy engine: one per admission-enabled
    :class:`QueryQueue`.  All mutation happens under one lock; the
    wait-time estimator is fed by the queue's completer thread.  Every
    decision takes the clock as an argument (``now``), so a test drives
    it without sleeping."""

    #: EWMA smoothing for the per-row service-time estimate
    _ALPHA = 0.2

    def __init__(self, config: AdmissionConfig, *,
                 base_wait_s: float = 0.0):
        config.validate()
        self.config = config
        self._lock = threading.Lock()
        self._buckets: Dict[str, _TokenBucket] = {}
        #: EWMA seconds of service per query row (None until the first
        #: completion feeds it: shedding never runs on a made-up estimate)
        self._row_s: Optional[float] = None
        #: the micro-batching deadline: a floor every wait estimate
        #: carries even when the queue is empty
        self._base_wait_s = float(base_wait_s)
        self._stats = {
            "admitted": 0,
            "rejected": {},  # reason -> count
            "shed": {},  # reason -> count
            "per_tenant": {},  # tenant -> {admitted, rejected, shed}
        }
        self._g_wait = obs.gauge(mn.ADMISSION_WAIT_ESTIMATE)

    # -- estimator ---------------------------------------------------------
    def observe_service(self, rows: int, seconds: float) -> None:
        """Feed one completed batch's (rows, wall seconds) into the
        per-row EWMA the wait estimate extrapolates from."""
        if rows <= 0 or seconds <= 0:
            return
        per_row = seconds / rows
        with self._lock:
            self._row_s = (per_row if self._row_s is None else
                           (1 - self._ALPHA) * self._row_s
                           + self._ALPHA * per_row)

    def wait_estimate_s(self, rows: int) -> Optional[float]:
        """Estimated wait for a request arriving now behind ``rows``
        outstanding rows (queued + in flight); None until a completion has
        fed the estimator."""
        with self._lock:
            row_s = self._row_s
        if row_s is None:
            return None
        est = self._base_wait_s + rows * row_s
        self._g_wait.set(est)
        return est

    # -- admission decision ------------------------------------------------
    def _tenant_slot(self, tenant: str) -> dict:
        return self._stats["per_tenant"].setdefault(
            tenant, {"admitted": 0, "rejected": 0, "shed": 0})

    def _reject(self, exc: AdmissionError, tenant: str):
        with self._lock:
            r = self._stats["rejected"]
            r[exc.reason] = r.get(exc.reason, 0) + 1
            self._tenant_slot(tenant)["rejected"] += 1
        obs.counter(mn.ADMISSION_REJECTED, tenant=tenant,
                    reason=exc.reason).inc()
        raise exc

    def admit(self, *, tenant: Optional[str], depth: int,
              rows: int, deadline_s: Optional[float],
              now: float) -> Optional[float]:
        """Admit or raise.  ``depth``/``rows`` are the OUTSTANDING request
        / row counts (queued + in flight).  Returns the absolute deadline
        (monotonic seconds, None = none) the queue should track.  Check
        order: depth, deadline feasibility, then quota last — a request
        the deadline check would shed must not spend a token."""
        cfg = self.config
        label = tenant if tenant is not None else UNTAGGED
        if cfg.max_depth is not None and depth >= cfg.max_depth:
            self._reject(QueueFullError(
                f"{depth} requests outstanding at max_depth "
                f"{cfg.max_depth}", tenant=tenant), label)
        if deadline_s is None and cfg.default_deadline_ms is not None:
            deadline_s = now + cfg.default_deadline_ms / 1e3
        if cfg.shed and deadline_s is not None:
            est = self.wait_estimate_s(rows)
            if est is not None and now + est > deadline_s:
                self._reject(DeadlineError(
                    f"deadline {1e3 * (deadline_s - now):.1f} ms out, "
                    f"queue wait estimate {1e3 * est:.1f} ms",
                    tenant=tenant), label)
        quota = cfg.quotas.get(label)
        if quota is not None:
            with self._lock:
                b = self._buckets.get(label)
                if b is None:
                    b = self._buckets[label] = _TokenBucket(
                        quota[0], quota[1], now)
                ok = b.take(now)
            if not ok:
                self._reject(QuotaExceededError(
                    f"tenant {label!r} over quota "
                    f"({quota[0]:g} q/s, burst {quota[1]:g})",
                    tenant=tenant), label)
        with self._lock:
            self._stats["admitted"] += 1
            self._tenant_slot(label)["admitted"] += 1
        obs.counter(mn.ADMISSION_ADMITTED, tenant=label).inc()
        return deadline_s

    def record_shed(self, tenant: Optional[str],
                    reason: str = "expired") -> None:
        """An admitted-then-expired request dropped at dispatch time."""
        label = tenant if tenant is not None else UNTAGGED
        with self._lock:
            s = self._stats["shed"]
            s[reason] = s.get(reason, 0) + 1
            self._tenant_slot(label)["shed"] += 1
        obs.counter(mn.ADMISSION_SHED, tenant=label, reason=reason).inc()

    # -- ordering ----------------------------------------------------------
    def priority_of(self, tenant: Optional[str]) -> int:
        return self.config.priorities.get(
            tenant if tenant is not None else UNTAGGED, 0)

    def effective_priority(self, priority: int, waited_s: float) -> float:
        """Aged priority: one level of decay per ``aging_s`` of wait — the
        monotone decrease that makes starvation impossible."""
        return priority - waited_s / self.config.aging_s

    def stats(self) -> dict:
        with self._lock:
            row_s = self._row_s
            out = {
                "admitted": self._stats["admitted"],
                "rejected": dict(self._stats["rejected"]),
                "shed": dict(self._stats["shed"]),
                "per_tenant": {t: dict(v) for t, v in
                               self._stats["per_tenant"].items()},
            }
        out["config"] = {
            "max_depth": self.config.max_depth,
            "shed": self.config.shed,
            "default_deadline_ms": self.config.default_deadline_ms,
            "quotas": {t: list(q) for t, q in self.config.quotas.items()},
            "priorities": dict(self.config.priorities),
            "aging_s": self.config.aging_s,
        }
        out["row_service_estimate_us"] = (
            None if row_s is None else round(row_s * 1e6, 3))
        return out
