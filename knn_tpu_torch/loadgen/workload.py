"""Workload specification and deterministic arrival generation — the
port of knn_tpu/loadgen/workload.py, numpy only.

A closed-loop microbench waits for each completion before offering the
next request, so the offered rate collapses to whatever the server
sustains and the knee is unobservable.  This module generates
**open-loop** request schedules — arrival times fixed in advance by the
arrival process, independent of how the server is doing — as plain data,
so the same trace can be generated, saved, replayed and rate-scaled.

A :class:`WorkloadSpec` describes the mix: an aggregate request rate, an
arrival process (``poisson``; ``onoff`` — a bursty square wave with a
``burst``-multiplied on-phase; ``replay`` — a recorded JSONL trace), and
a multi-tenant mix of :class:`TenantSpec` entries.  :func:`generate`
turns it into a list of :class:`Request` values under a fixed seed: the
same spec gives the same list, element for element, and the JAX
package's ``generate`` gives it too (the same numpy draws in the same
order).
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

#: arrival processes generate() understands
ARRIVALS = ("poisson", "onoff", "replay")


@dataclass(frozen=True)
class TenantSpec:
    """One tenant's slice of the mix: its share of the aggregate rate
    (``weight``), the request shapes it sends (``batch_sizes``, drawn
    uniformly per request), and the admission-relevant tags that ride
    each request (deadline, priority, precision)."""

    name: str
    weight: float = 1.0
    #: request row counts, drawn uniformly per request
    batch_sizes: Tuple[int, ...] = (1, 2, 4, 8)
    #: neighbor count the tenant asks for (None = server default)
    k: Optional[int] = None
    #: distance metric tag (None = server default)
    metric: Optional[str] = None
    #: coarse-pass precision tag ("f32" / "int8"; None = server default)
    precision: Optional[str] = None
    #: per-request deadline (ms from arrival; None = no deadline)
    deadline_ms: Optional[float] = None
    #: dispatch priority (lower first; admission aging keeps it
    #: starvation-safe)
    priority: int = 0
    #: deterministic write-stream mix: each scheduled request is an
    #: ``insert`` with probability ``insert_fraction`` and a ``delete``
    #: with probability ``delete_fraction`` (seeded draw — same spec,
    #: same kinds), a query otherwise.  Inserts carry ``write_rows``
    #: vectors; deletes target one previously inserted id (the driver
    #: allocates/retires ids).  Both zero = the pre-write schedule,
    #: draw for draw.
    insert_fraction: float = 0.0
    delete_fraction: float = 0.0
    write_rows: int = 1
    #: offline bulk-join lane: with probability ``bulk_fraction`` a
    #: scheduled request is a ``bulk`` read of ``bulk_rows`` rows — a
    #: join superblock riding the serving schedule, the mixed
    #: join/serving interference shape.  Bulk outcomes land in their
    #: own report section; the admitted-read percentiles never see
    #: them.  Zero = the pre-bulk schedule, draw for draw.
    bulk_fraction: float = 0.0
    bulk_rows: int = 1024

    def validate(self) -> None:
        if self.weight <= 0:
            raise ValueError(
                f"tenant {self.name!r}: weight must be > 0, got "
                f"{self.weight}")
        if not self.batch_sizes or any(b < 1 for b in self.batch_sizes):
            raise ValueError(
                f"tenant {self.name!r}: batch_sizes must be >= 1, got "
                f"{self.batch_sizes}")
        if self.deadline_ms is not None and self.deadline_ms <= 0:
            raise ValueError(
                f"tenant {self.name!r}: deadline_ms must be > 0, got "
                f"{self.deadline_ms}")
        if self.insert_fraction < 0 or self.delete_fraction < 0 \
                or self.bulk_fraction < 0 \
                or (self.insert_fraction + self.delete_fraction
                        + self.bulk_fraction) > 1:
            raise ValueError(
                f"tenant {self.name!r}: kind fractions must be >= 0 "
                f"and sum to <= 1, got insert={self.insert_fraction} "
                f"delete={self.delete_fraction} "
                f"bulk={self.bulk_fraction}")
        if self.write_rows < 1:
            raise ValueError(
                f"tenant {self.name!r}: write_rows must be >= 1, got "
                f"{self.write_rows}")
        if self.bulk_rows < 1:
            raise ValueError(
                f"tenant {self.name!r}: bulk_rows must be >= 1, got "
                f"{self.bulk_rows}")


@dataclass(frozen=True)
class Request:
    """One scheduled request: WHEN it arrives (``t``, seconds from
    trace start — fixed in advance, the open-loop property), WHO sends
    it, and its shape/deadline/priority tags."""

    tenant: str
    t: float
    rows: int
    k: Optional[int] = None
    metric: Optional[str] = None
    precision: Optional[str] = None
    deadline_ms: Optional[float] = None
    priority: int = 0
    #: "query" | "insert" | "delete" | "bulk" — writes and bulk-join
    #: superblocks ride the same seeded open-loop schedule as reads
    #: (TenantSpec kind fractions); old traces without the field load
    #: as pure-query schedules
    kind: str = "query"


@dataclass(frozen=True)
class WorkloadSpec:
    """The full mix: aggregate ``rate_qps`` (requests/s, not rows/s)
    over ``duration_s``, split across ``tenants`` by weight, arriving
    by ``arrival``.  ``onoff`` alternates ``on_s`` seconds at
    ``rate_qps * burst`` with ``off_s`` seconds of silence (the bursty
    pattern admission control exists for); ``replay`` reads the JSONL
    trace at ``trace_path`` verbatim (rate/duration/tenants ignored)."""

    rate_qps: float = 100.0
    duration_s: float = 1.0
    seed: int = 0
    arrival: str = "poisson"
    tenants: Tuple[TenantSpec, ...] = field(
        default_factory=lambda: (TenantSpec("default"),))
    on_s: float = 0.25
    off_s: float = 0.25
    burst: float = 4.0
    trace_path: Optional[str] = None

    def validate(self) -> None:
        if self.arrival not in ARRIVALS:
            raise ValueError(
                f"arrival must be one of {ARRIVALS}, got {self.arrival!r}")
        if self.arrival == "replay":
            if not self.trace_path:
                raise ValueError("arrival='replay' needs trace_path")
            return
        if self.rate_qps <= 0:
            raise ValueError(f"rate_qps must be > 0, got {self.rate_qps}")
        if self.duration_s <= 0:
            raise ValueError(
                f"duration_s must be > 0, got {self.duration_s}")
        if not self.tenants:
            raise ValueError("at least one tenant required")
        seen = set()
        for t in self.tenants:
            if t.name in seen:
                raise ValueError(f"duplicate tenant name {t.name!r}")
            seen.add(t.name)
            t.validate()
        if self.arrival == "onoff":
            if self.on_s <= 0 or self.off_s < 0:
                raise ValueError(
                    f"onoff needs on_s > 0 and off_s >= 0, got "
                    f"on_s={self.on_s} off_s={self.off_s}")
            if self.burst <= 0:
                raise ValueError(f"burst must be > 0, got {self.burst}")

    def at_rate(self, rate_qps: float) -> "WorkloadSpec":
        """The same mix at a different aggregate rate — the knee
        sweep's step generator (same seed: the step traces differ only
        by arrival spacing, never by mix)."""
        return WorkloadSpec(
            rate_qps=float(rate_qps), duration_s=self.duration_s,
            seed=self.seed, arrival=self.arrival, tenants=self.tenants,
            on_s=self.on_s, off_s=self.off_s, burst=self.burst,
            trace_path=self.trace_path)


def _arrival_times(spec: WorkloadSpec, rng: np.random.Generator
                   ) -> List[float]:
    """Arrival offsets (seconds, ascending) for the configured process.
    Poisson: exponential gaps at ``rate_qps``.  On/off: exponential
    gaps at ``rate_qps * burst`` inside on-windows, silence in
    off-windows (arrivals landing in an off-window are pushed to the
    next on-edge — the synchronized-burst shape that stresses
    admission hardest)."""
    out: List[float] = []
    if spec.arrival == "poisson":
        t = 0.0
        while True:
            t += float(rng.exponential(1.0 / spec.rate_qps))
            if t >= spec.duration_s:
                break
            out.append(t)
        return out
    # onoff
    period = spec.on_s + spec.off_s
    rate_on = spec.rate_qps * spec.burst
    t = 0.0
    while True:
        t += float(rng.exponential(1.0 / rate_on))
        # skip the off part of whichever period t landed in — LOOPED:
        # a re-drawn gap can itself overshoot the next on-window (at
        # low rates e^{-rate_on*on_s} is not small), and an arrival in
        # a silence window would break the square-wave invariant the
        # admission tests lean on
        k, phase = divmod(t, period)
        while phase > spec.on_s:
            t = (k + 1) * period + float(rng.exponential(1.0 / rate_on))
            k, phase = divmod(t, period)
        if t >= spec.duration_s:
            break
        out.append(t)
    return out


def generate(spec: WorkloadSpec) -> List[Request]:
    """The deterministic request schedule for ``spec``: same spec ->
    identical list, element for element.  ``replay`` loads the trace
    verbatim (already a schedule)."""
    spec.validate()
    if spec.arrival == "replay":
        return load_trace(spec.trace_path)
    rng = np.random.default_rng(spec.seed)
    times = _arrival_times(spec, rng)
    weights = np.asarray([t.weight for t in spec.tenants], np.float64)
    weights = weights / weights.sum()
    picks = rng.choice(len(spec.tenants), size=len(times), p=weights)
    out: List[Request] = []
    for t, pick in zip(times, picks):
        ten = spec.tenants[int(pick)]
        rows = int(ten.batch_sizes[int(
            rng.integers(0, len(ten.batch_sizes)))])
        kind = "query"
        if ten.insert_fraction > 0 or ten.delete_fraction > 0 \
                or ten.bulk_fraction > 0:
            # the kind draw happens ONLY for mixed tenants, so a
            # pure-query spec's rng sequence — and therefore its whole
            # schedule — is unchanged draw for draw (pinned)
            u = float(rng.random())
            if u < ten.insert_fraction:
                kind = "insert"
            elif u < ten.insert_fraction + ten.delete_fraction:
                kind = "delete"
            elif u < (ten.insert_fraction + ten.delete_fraction
                      + ten.bulk_fraction):
                kind = "bulk"
        if kind == "insert":
            rows = ten.write_rows
        elif kind == "delete":
            rows = 1
        elif kind == "bulk":
            rows = ten.bulk_rows
        out.append(Request(
            tenant=ten.name, t=round(float(t), 6), rows=rows, k=ten.k,
            metric=ten.metric, precision=ten.precision,
            deadline_ms=ten.deadline_ms, priority=ten.priority,
            kind=kind))
    return out


# -- trace persistence (JSONL: one request per line) ----------------------
def save_trace(requests: Sequence[Request], path: str) -> None:
    """One JSON object per line; :func:`load_trace` round-trips it
    exactly (tests/test_torch_loadgen.py)."""
    with open(path, "w") as f:
        for r in requests:
            f.write(json.dumps(asdict(r), sort_keys=True) + "\n")


def load_trace(path: str) -> List[Request]:
    out: List[Request] = []
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{ln}: not JSON: {e}") from e
            try:
                out.append(Request(**rec))
            except TypeError as e:
                raise ValueError(
                    f"{path}:{ln}: not a request record: {e}") from e
    out.sort(key=lambda r: r.t)
    return out


def parse_tenants(text: str) -> Tuple[TenantSpec, ...]:
    """CLI shorthand ``name[:weight[:priority]],...`` -> tenant specs
    (e.g. ``gold:3:0,free:1:2``)."""
    out = []
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        bits = part.split(":")
        if len(bits) > 3:
            raise ValueError(
                f"tenant spec {part!r}: expected name[:weight[:priority]]")
        out.append(TenantSpec(
            name=bits[0],
            weight=float(bits[1]) if len(bits) > 1 else 1.0,
            priority=int(bits[2]) if len(bits) > 2 else 0))
    if not out:
        raise ValueError(f"no tenants in {text!r}")
    return tuple(out)
