"""Exporters: JSON metrics snapshot, Chrome trace-event file, terminal
summary table; the port of the reference's obs/export.py.

- :func:`metrics_snapshot` / :func:`write_metrics_json` — one JSON doc
  merging every registry plus lock occupancy, with the same
  a ``schema_version``.
- :func:`chrome_trace` / :func:`write_chrome_trace` — Chrome trace-event
  format (``{"traceEvents": [...]}`` with "X" complete events, µs
  timestamps), loadable at https://ui.perfetto.dev.
- :func:`to_prometheus_text` — Prometheus text exposition format
  (version 0.0.4): HELP/TYPE headers, one sample line per label cell,
  histograms as cumulative ``_bucket{le=...}`` series plus ``_sum`` /
  ``_count``. Serve it from any HTTP handler to scrape the plane.
- :func:`serve_prometheus` — a daemon-thread HTTP pull endpoint serving
  that text at ``/metrics``, so a real Prometheus server can scrape a
  live plane without any in-process glue.
- :func:`summary` — a plain-text table for terminal use.
"""

from __future__ import annotations

import json
import re
import threading
from typing import Any, Dict, List, Optional

from .occupancy import occupancy_snapshot
from .registry import all_registries
from .trace import get_tracer

__all__ = [
    "chrome_trace",
    "metrics_snapshot",
    "serve_prometheus",
    "summary",
    "to_prometheus_text",
    "validate_chrome_trace",
    "write_chrome_trace",
    "write_metrics_json",
]

SNAPSHOT_SCHEMA_VERSION = 1


def metrics_snapshot() -> Dict[str, Any]:
    registries = {}
    for reg in all_registries():
        snap = reg.snapshot()
        if not snap:
            continue
        if reg.name in registries:
            # Two registries with the same name (e.g. two planes named
            # identically): suffix to keep both visible.
            i = 2
            while f"{reg.name}#{i}" in registries:
                i += 1
            registries[f"{reg.name}#{i}"] = snap
        else:
            registries[reg.name] = snap
    return {
        "schema_version": SNAPSHOT_SCHEMA_VERSION,
        "kind": "obs_metrics_snapshot",
        "registries": registries,
        "lock_occupancy": occupancy_snapshot(),
    }


def write_metrics_json(path: str) -> Dict[str, Any]:
    snap = metrics_snapshot()
    with open(path, "w") as f:
        json.dump(snap, f, indent=2, sort_keys=True)
        f.write("\n")
    return snap


def chrome_trace() -> Dict[str, Any]:
    tr = get_tracer()
    events: List[Dict[str, Any]] = []
    for tid, name in sorted(tr.thread_names().items()):
        events.append(
            {
                "ph": "M",
                "name": "thread_name",
                "pid": 1,
                "tid": tid,
                "args": {"name": name},
            }
        )
    for rec in list(tr.records):
        args = dict(rec["args"])
        args["sid"] = rec["sid"]
        if rec["parent"]:
            args["parent"] = rec["parent"]
        if "fence_s" in rec:
            args["device_fence_us"] = round(rec["fence_s"] * 1e6, 3)
        events.append(
            {
                "ph": "X",
                "name": rec["name"],
                "cat": rec["cat"] or "span",
                "pid": 1,
                "tid": rec["tid"],
                "ts": round(rec["t0"] * 1e6, 3),
                "dur": round(rec["dur"] * 1e6, 3),
                "args": args,
            }
        )
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str) -> Dict[str, Any]:
    doc = chrome_trace()
    with open(path, "w") as f:
        json.dump(doc, f)
        f.write("\n")
    return doc


def validate_chrome_trace(doc: Dict[str, Any]) -> List[str]:
    """Return a list of schema problems (empty == valid): every event an
    "X" or "M" with name, pid and tid, numeric ts and non-negative dur,
    and every parent sid present among the events."""
    problems: List[str] = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return ["missing traceEvents key"]
    events = doc["traceEvents"]
    if not isinstance(events, list):
        return ["traceEvents is not a list"]
    sids = set()
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "M"):
            problems.append(f"event {i}: unsupported ph {ph!r}")
            continue
        if "name" not in ev or "pid" not in ev or "tid" not in ev:
            problems.append(f"event {i}: missing name/pid/tid")
        if ph == "X":
            ts, dur = ev.get("ts"), ev.get("dur")
            if not isinstance(ts, (int, float)) or not isinstance(dur, (int, float)):
                problems.append(f"event {i}: ts/dur not numeric")
            elif dur < 0:
                problems.append(f"event {i}: negative dur")
            sid = ev.get("args", {}).get("sid")
            if sid is not None:
                sids.add(sid)
    for i, ev in enumerate(events):
        if ev.get("ph") != "X":
            continue
        parent = ev.get("args", {}).get("parent")
        if parent is not None and parent not in sids:
            problems.append(f"event {i}: parent sid {parent} not present")
    return problems


_PROM_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    name = _PROM_NAME_BAD.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def _prom_escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _prom_labels(key, extra: Optional[str] = None) -> str:
    """Render a registry LabelKey (sorted (k, v) tuple) as {k="v",...};
    `extra` is a pre-rendered pair appended last (the histogram `le`)."""
    parts = [f'{_prom_name(k)}="{_prom_escape(v)}"' for k, v in key]
    if extra is not None:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _prom_val(v: float) -> str:
    f = float(v)
    if f != f:  # NaN
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def to_prometheus_text(registry=None) -> str:
    """Render metrics in the Prometheus text exposition format (0.0.4).

    With `registry` given, exports that one registry; with None, exports
    every live registry (metric names deduped first-wins, matching the
    Prometheus rule that a name appears in one HELP/TYPE group only —
    duplicate names across planes keep only the first registry's cells,
    same precedence as :func:`metrics_snapshot`'s name suffixing).

    Counters export as-is (names are already `_total`-style by repo
    convention), gauges as gauges, histograms as cumulative
    `_bucket{le="..."}` series plus `_sum` and `_count` — the registry's
    per-bucket counts are partial sums, so the cumulative series here is
    exact, including the `+Inf` overflow bucket.
    """
    from .registry import Histogram

    regs = [registry] if registry is not None else all_registries()
    lines: List[str] = []
    seen: set = set()
    for reg in regs:
        for m in reg.metrics():
            name = _prom_name(m.name)
            if name in seen:
                continue
            seen.add(name)
            cells = m.cells()
            if not cells:
                continue
            if m.help:
                lines.append(f"# HELP {name} {_prom_escape(m.help)}")
            lines.append(f"# TYPE {name} {'histogram' if m.kind == 'histogram' else m.kind}")
            if isinstance(m, Histogram):
                for key in sorted(cells):
                    cell = cells[key]
                    cum = 0
                    for edge, n in zip(m.edges, cell["buckets"]):
                        cum += n
                        le = f'le="{_prom_val(edge)}"'
                        lines.append(f"{name}_bucket{_prom_labels(key, le)} {cum}")
                    inf_le = 'le="+Inf"'
                    lines.append(f"{name}_bucket{_prom_labels(key, inf_le)} {cell['count']}")
                    lines.append(f"{name}_sum{_prom_labels(key)} {_prom_val(cell['sum'])}")
                    lines.append(f"{name}_count{_prom_labels(key)} {cell['count']}")
            else:
                for key in sorted(cells):
                    lines.append(f"{name}{_prom_labels(key)} {_prom_val(cells[key])}")
    return "\n".join(lines) + "\n" if lines else ""


class _PrometheusEndpoint:
    """Handle returned by :func:`serve_prometheus`. Context-manager and
    explicit ``stop()`` both shut the server down; the serving thread is
    a daemon so a forgotten handle never blocks interpreter exit."""

    def __init__(self, server, thread: threading.Thread, host: str) -> None:
        self._server = server
        self._thread = thread
        self.host = host
        self.port = server.server_address[1]
        self.url = f"http://{host}:{self.port}/metrics"

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "_PrometheusEndpoint":
        return self

    def __exit__(self, *exc: object) -> None:
        self.stop()


def serve_prometheus(registry=None, port: int = 0, host: str = "127.0.0.1") -> _PrometheusEndpoint:
    """Start a daemon-thread HTTP server exposing :func:`to_prometheus_text`
    at ``/metrics`` (any other path 404s). ``port=0`` binds an ephemeral
    port; read it back from the returned handle's ``.port`` / ``.url``.
    Scoped to one registry when given, every live registry otherwise —
    the text is rendered fresh per scrape, so no state is cached.

    Concurrency contract (tests hammer this from many threads during
    live ingest): the text is rendered from per-cell locked snapshots,
    so every histogram cell a scrape sees is internally consistent
    (cumulative buckets monotone, +Inf bucket == count) even while
    writers observe concurrently; a scraper that disconnects mid-write
    is swallowed (no traceback, no dead handler thread); and stop()
    closes the listening socket before returning, so the port is
    immediately rebindable."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class _Handler(BaseHTTPRequestHandler):
        def do_GET(self) -> None:  # noqa: N802 - http.server API
            try:
                if self.path.split("?", 1)[0] != "/metrics":
                    self.send_error(404, "only /metrics is served")
                    return
                # Render BEFORE the status line: a mid-render failure
                # must produce a clean 500, not a half-sent 200.
                body = to_prometheus_text(registry).encode("utf-8")
            except (BrokenPipeError, ConnectionResetError):
                return  # scraper gone; nothing to answer
            except Exception as e:  # defensive: never kill the endpoint
                try:
                    self.send_error(500, f"metrics render failed: {e}")
                except OSError:
                    pass
                return
            try:
                self.send_response(200)
                self.send_header(
                    "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            except (BrokenPipeError, ConnectionResetError, OSError):
                pass  # scraper disconnected mid-write; drop silently

        def log_message(self, format: str, *args: object) -> None:
            pass  # scrapes are high-frequency; keep stderr quiet

    class _Server(ThreadingHTTPServer):
        def handle_error(self, request, client_address) -> None:
            pass  # per-connection errors are handled in do_GET; no stderr spew

    server = _Server((host, port), _Handler)
    server.daemon_threads = True
    thread = threading.Thread(
        target=server.serve_forever, name="prometheus-scrape", daemon=True
    )
    thread.start()
    return _PrometheusEndpoint(server, thread, host)


def _fmt_labels(key: str) -> str:
    return "" if key == "__all__" else f"{{{key}}}"


def summary(width: int = 78) -> str:
    """Terminal summary: lock occupancy first (the headline), then every
    non-empty metric."""
    lines: List[str] = []
    occ = occupancy_snapshot()
    if occ:
        lines.append("== lock occupancy ==")
        for name, snap in sorted(occ.items()):
            total = float(snap["total_held_s"])
            lines.append(
                f"{name}: held {total * 1e3:.1f} ms over {snap['acquisitions']} acquisitions"
            )
            by = snap["by_owner_s"]
            for owner, secs in sorted(by.items(), key=lambda kv: -kv[1]):
                frac = (secs / total * 100.0) if total > 0 else 0.0
                n = snap["acq_by_owner"].get(owner, 0)
                lines.append(f"  {owner:<16} {secs * 1e3:>10.1f} ms  {frac:>5.1f}%  (n={n})")
    for reg in all_registries():
        snap = reg.snapshot()
        if not snap:
            continue
        lines.append(f"== registry: {reg.name} ==")
        for mname in sorted(snap):
            m = snap[mname]
            if m["kind"] == "histogram":
                for key, cell in sorted(m["cells"].items()):
                    mean = cell["sum"] / cell["count"] if cell["count"] else 0.0
                    lines.append(
                        f"{mname}{_fmt_labels(key)}: n={cell['count']} "
                        f"mean={mean * 1e3:.2f}ms min={cell['min'] * 1e3:.2f}ms "
                        f"max={cell['max'] * 1e3:.2f}ms"
                    )
            else:
                for key, val in sorted(m["cells"].items()):
                    if isinstance(val, float) and val == int(val):
                        val = int(val)
                    lines.append(f"{mname}{_fmt_labels(key)}: {val}")
    return "\n".join(lines)
