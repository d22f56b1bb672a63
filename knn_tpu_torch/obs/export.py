"""Exporters: Prometheus text, atomic JSON snapshots and a stdlib-HTTP
endpoint — the port of knn_tpu/obs/export.py.

One source renders everything (:func:`prometheus_text` over
``registry.snapshot()``): counters and gauges as ``name{labels} value``;
histograms as Prometheus summaries (window quantiles plus lifetime
``_sum`` / ``_count``), with their cumulative ``_bucket`` lines and the
worst exemplar on a comment line.  The JSON snapshot writer is atomic
(temporary file and rename).  :func:`start_metrics_server` serves
``/metrics``, ``/metrics.json``, ``/healthz``, ``/statusz`` and
``/waterfallz`` (the request waterfalls, read by ``cli waterfall
--port``) and ``/fleetz`` (the merged fleet report over the configured
members, obs.fleet.live_fleet_report) from a daemon thread.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from typing import Optional

from knn_tpu_torch.obs import ident, registry

#: summary quantiles exported from the histogram window
_QUANTILES = (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99"))


def _esc(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _labels_str(labels: dict, extra: Optional[tuple] = None) -> str:
    items = sorted(labels.items())
    if extra is not None:
        items = items + [extra]
    if not items:
        return ""
    return "{" + ",".join(f'{k}="{_esc(str(v))}"' for k, v in items) + "}"


def prometheus_text(snapshot: Optional[dict] = None) -> str:
    """The whole registry in Prometheus text exposition format."""
    snap = registry.snapshot() if snapshot is None else snapshot
    lines = []
    for name in sorted(snap):
        m = snap[name]
        kind = m["type"]
        prom_kind = "summary" if kind == "histogram" else kind
        lines.append(f"# HELP {name} {m['help']}")
        lines.append(f"# TYPE {name} {prom_kind}")
        for s in m["series"]:
            ls, v = s["labels"], s["value"]
            if kind == "histogram":
                for q, key in _QUANTILES:
                    if key in v:
                        lines.append(
                            f"{name}{_labels_str(ls, ('quantile', q))} "
                            f"{v[key]}")
                if v.get("exemplars"):
                    # the worst retained sample's trace id, value, and
                    # wall timestamp in OpenMetrics exemplar syntax —
                    # but on a COMMENT line: neither exposition format
                    # allows inline exemplars on summary quantiles, and
                    # a text-0.0.4 scraper must keep parsing (comments
                    # other than HELP/TYPE are ignored)
                    ex = v["exemplars"][0]
                    lines.append(
                        f"# EXEMPLAR "
                        f"{name}{_labels_str(ls, ('quantile', '0.99'))} "
                        f'{{trace_id="{_esc(str(ex["trace_id"]))}"}} '
                        f'{ex["value"]} {ex["ts"]}')
                if v.get("buckets"):
                    # the mergeable form: cumulative counts over the
                    # fixed registry.BUCKET_BOUNDS grid, classic
                    # ``_bucket{le=...}`` lines — identical bounds in
                    # every process is what lets the fleet aggregator
                    # add them and take quantiles of the SUM
                    cum = v["buckets"]
                    for b, c in zip(registry.BUCKET_BOUNDS, cum):
                        lines.append(
                            f"{name}_bucket"
                            f"{_labels_str(ls, ('le', format(b, '.6g')))} "
                            f"{c}")
                    lines.append(
                        f"{name}_bucket{_labels_str(ls, ('le', '+Inf'))} "
                        f"{cum[-1]}")
                lines.append(f"{name}_sum{_labels_str(ls)} {v['sum']}")
                lines.append(f"{name}_count{_labels_str(ls)} {v['count']}")
            else:
                lines.append(f"{name}{_labels_str(ls)} {v}")
    return "\n".join(lines) + "\n"


def compact_snapshot(snapshot: Optional[dict] = None) -> dict:
    """The snapshot flattened for embedding (JobResult.metrics()["obs"],
    bench lines): ``{name: value}`` for unlabeled series, ``{name:
    {"k=v,...": value}}`` for labeled ones; histograms keep their
    summary dict."""
    snap = registry.snapshot() if snapshot is None else snapshot
    out: dict = {}
    for name, m in snap.items():
        series = m["series"]
        if len(series) == 1 and not series[0]["labels"]:
            out[name] = series[0]["value"]
        else:
            out[name] = {
                ",".join(f"{k}={v}" for k, v in sorted(s["labels"].items())):
                    s["value"]
                for s in series
            }
    return out


def write_json_snapshot(path: str, snapshot: Optional[dict] = None) -> dict:
    """Atomic JSON snapshot (tmp + rename): a scraper of the file can
    never observe a torn write.  Returns the written payload.  Embeds
    the health/self-diagnosis report, so ``knn_tpu_torch.cli doctor
    --snapshot`` renders offline exactly what ``/statusz`` served
    live."""
    from knn_tpu_torch.obs import health

    payload = {
        "written_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "written_at_unix": round(time.time(), 3),
        "pid": os.getpid(),
        "identity": ident.identity(),
        "enabled": registry.enabled(),
        "metrics": registry.snapshot() if snapshot is None else snapshot,
        "health": health.report(),
    }
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return payload


def start_metrics_server(port: int, host: str = "127.0.0.1"):
    """Serve ``/metrics`` (Prometheus text), ``/metrics.json`` (the
    snapshot), ``/healthz`` (200 once an engine is warmed and the queue
    workers live, else 503: obs.health.probe), ``/statusz`` (the full
    health report), ``/waterfallz`` (every request waterfall the event
    ring rebuilds, their attribution and the slowest requests:
    obs.waterfall.live_report) and ``/fleetz`` (the merged fleet report:
    obs.fleet.live_fleet_report) from a daemon thread; returns the server
    (``.shutdown()`` and ``.server_close()`` stop it,
    ``.server_address[1]`` is the bound port: pass 0 for any free one)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 - stdlib handler contract
            from knn_tpu_torch.obs import health

            path = self.path.split("?", 1)[0]
            status = 200
            if path in ("/metrics", "/"):
                body = prometheus_text().encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif path == "/metrics.json":
                body = json.dumps(
                    {"enabled": registry.enabled(),
                     "identity": ident.identity(),
                     "written_at_unix": round(time.time(), 3),
                     "metrics": registry.snapshot()},
                    indent=1, sort_keys=True).encode()
                ctype = "application/json"
            elif path == "/healthz":
                probe = health.probe()
                status = 200 if probe["ready"] else 503
                body = json.dumps(probe, sort_keys=True).encode()
                ctype = "application/json"
            elif path == "/statusz":
                body = json.dumps(health.report(), indent=1,
                                  sort_keys=True, default=str).encode()
                ctype = "application/json"
            elif path == "/waterfallz":
                from knn_tpu_torch.obs import waterfall

                body = json.dumps(waterfall.live_report(), indent=1,
                                  sort_keys=True, default=str).encode()
                ctype = "application/json"
            elif path == "/fleetz":
                from knn_tpu_torch.obs import fleet

                body = json.dumps(fleet.live_fleet_report(), indent=1,
                                  sort_keys=True, default=str).encode()
                ctype = "application/json"
            else:
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # silence per-scrape stderr
            pass

    server = ThreadingHTTPServer((host, int(port)), Handler)
    server.daemon_threads = True
    t = threading.Thread(
        target=server.serve_forever, name="knn-obs-metrics", daemon=True)
    t.start()
    return server
