"""Device trace capture and its summary — the port of
knn_tpu/obs/profiler.py on ``torch.profiler``.

:func:`device_trace` wraps a block in ``torch.profiler.profile`` (CPU and,
where there is a card, CUDA activity), writes a Chrome trace under
``<out_dir>/<section>/trace.json`` and records a ``profiler.trace`` event.
``out_dir=None`` captures nothing and yields None, so a caller can skip
its extra traced run.  The block runs inside a ``record_function`` range
(:data:`BODY_MARKER`), after :data:`WARMUP_KERNELS` tiny kernels inside
the trace: after a trace of tens of thousands of events, a later trace in
the same process can miss its first kernels altogether (CUPTI records
none of them; ``csrc/probes/trace_clock.py --flood``), and the warm-up
kernels take that loss.  A summary counts the warm-up kernels it holds
(``device_events_before``): while one is there, the loss stopped short of
the block.

:func:`summarize` reads a trace's events — those of the block alone:
device events inside the marker's own device-side range (the
``record_function`` range lands on the device timeline too, spanning the
block's kernels on the device clock), host runtime calls inside the
host-side range — into the numbers a breakdown needs: device time by
kernel name, the device's busy time (the union of its kernel intervals)
and idle share of the wall time, the host↔device synchronizations
(``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaEventSynchronize`` runtime calls) and the device-to-host copies
(``Memcpy DtoH`` device events, beside the ``cudaMemcpyAsync`` runtime
calls of any direction).  Device events are never placed by the host
clock: a device timeline offset from the host's would drop the block's
first kernels in such a filter.  Without a device-side range (a CPU
trace) every device event counts.

``torch`` is imported inside :func:`device_trace` only.  Where the port
differs: the capture directory is the ``out_dir`` argument, not an
environment variable, and a capture is a torch.profiler Chrome trace, not
an XLA one.
"""

from __future__ import annotations

import contextlib
import os
import re
import time
from typing import Dict, Iterator, Optional

from knn_tpu_torch.obs import trace

#: the record_function range around the traced block
BODY_MARKER = "obs.device_trace"

#: tiny kernels a trace runs before the block, to take the loss of a
#: trace's first kernels
WARMUP_KERNELS = 64

#: host runtime calls that wait for the device
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")

_SECTION_RE = re.compile(r"[^A-Za-z0-9._-]+")


def sanitize_section(section: str) -> str:
    """A filesystem-safe capture name."""
    return _SECTION_RE.sub("_", section).strip("_") or "trace"


def _is_device(e) -> bool:
    return getattr(getattr(e, "device_type", None), "name", "") == "CUDA"


def summarize(events, wall_s: Optional[float] = None, top: int = 10) -> dict:
    """The breakdown of one traced block from profiler ``events`` (each
    with ``name``, ``device_type`` and ``time_range.start/.end`` in µs):
    ``kernels_ms`` (device ms by name, the ``top`` largest), ``device_busy_ms``
    (union of device intervals), ``wall_ms`` (``wall_s``, else the
    marker's host span), ``device_idle_share`` (1 - busy / wall), ``syncs``
    by runtime call and their ``sync_count``, ``d2h_copies`` and
    ``memcpy_async_calls``; ``device_filter`` names the range the device
    events were read in (``"device_marker"``, or ``"none"``) and
    ``device_events_before`` counts those before it (a device trace's
    warm-up kernels).  Host events outside
    the :data:`BODY_MARKER` host range are left out (all count when there
    is no marker)."""
    events = list(events)
    host_marks = [e for e in events
                  if e.name == BODY_MARKER and not _is_device(e)]
    dev_marks = [e for e in events if e.name == BODY_MARKER and _is_device(e)]
    t_lo = min((e.time_range.start for e in host_marks), default=None)
    t_hi = max((e.time_range.end for e in host_marks), default=None)
    d_lo = min((e.time_range.start for e in dev_marks), default=None)
    d_hi = max((e.time_range.end for e in dev_marks), default=None)

    def host_in_body(e) -> bool:
        return t_lo is None or t_lo <= e.time_range.start <= t_hi

    def dev_in_body(e) -> bool:
        return d_lo is None or d_lo <= e.time_range.start <= d_hi

    # the marker's own device range is no kernel
    dev_all = [e for e in events if _is_device(e) and e.name != BODY_MARKER]
    dev = [e for e in dev_all if dev_in_body(e)]
    host = [e for e in events if not _is_device(e) and host_in_body(e)]
    by_name: Dict[str, float] = {}
    spans = []
    for e in dev:
        s, t = e.time_range.start, e.time_range.end
        by_name[e.name] = by_name.get(e.name, 0.0) + (t - s)
        spans.append((s, t))
    busy = 0.0
    cur_s = cur_e = None
    for s, t in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    if cur_e is not None:
        busy += cur_e - cur_s
    if wall_s is not None:
        wall_ms = wall_s * 1e3
    elif t_lo is not None:
        wall_ms = (t_hi - t_lo) / 1e3
    else:
        wall_ms = None
    syncs = {name: sum(1 for e in host if e.name == name)
             for name in SYNC_CALLS}
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy / 1e3,
        "device_idle_share": (1.0 - busy / 1e3 / wall_ms
                              if wall_ms else None),
        "kernels_ms": {name[:80]: us / 1e3 for name, us in ranked},
        "kernel_events": len(dev),
        "kernel_names": sorted(by_name),
        "device_filter": "none" if d_lo is None else "device_marker",
        "device_events_before": (0 if d_lo is None else sum(
            1 for e in dev_all if e.time_range.start < d_lo)),
        "syncs": syncs,
        "sync_count": sum(syncs.values()),
        "d2h_copies": sum(1 for e in dev
                          if e.name.startswith("Memcpy DtoH")),
        "memcpy_async_calls": sum(1 for e in host
                                  if e.name == "cudaMemcpyAsync"),
    }


class DeviceTrace:
    """One capture: ``path`` (its directory), ``profiler`` (the finished
    ``torch.profiler.profile``, set when the block exits) and
    :meth:`summary`."""

    def __init__(self, path: str):
        self.path = path
        self.profiler = None

    def summary(self, wall_s: Optional[float] = None, top: int = 10) -> dict:
        if self.profiler is None:
            raise RuntimeError("the traced block has not finished")
        return summarize(self.profiler.events(), wall_s=wall_s, top=top)


@contextlib.contextmanager
def device_trace(section: str,
                 out_dir: Optional[str] = None) -> Iterator[Optional[DeviceTrace]]:
    """Trace the wrapped block under ``<out_dir>/<section>``; yields its
    :class:`DeviceTrace`, or None when ``out_dir`` is None (nothing is
    captured)."""
    if out_dir is None:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    name = sanitize_section(section)
    path = os.path.join(out_dir, name)
    os.makedirs(path, exist_ok=True)
    cap = DeviceTrace(path)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    t0 = time.perf_counter()
    with profile(activities=activities) as prof:
        if cuda:
            warm = torch.zeros(8, device="cuda")
            for _ in range(WARMUP_KERNELS):
                warm.add_(1)
            torch.cuda.synchronize()  # done before the block's range opens
        with record_function(BODY_MARKER):
            yield cap
    cap.profiler = prof
    prof.export_chrome_trace(os.path.join(path, "trace.json"))
    trace.emit_event("profiler.trace", section=name, trace_dir=path,
                     dur_s=round(time.perf_counter() - t0, 4))
