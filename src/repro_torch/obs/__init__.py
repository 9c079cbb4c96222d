"""repro_torch.obs — the observability plane; the port of the
reference's obs package, name for name.

- registry: typed counters/gauges/histograms with label sets
- trace: spans with parent linkage and CUDA-event device fencing
- occupancy: per-owner held-time attribution on the device locks
- flight: a bounded per-thread ring of recent spans
- watchdog: sliding-window SLO rules that write incident bundles

plus exporters (JSON snapshot, Chrome/Perfetto trace, Prometheus text and
its pull endpoint, terminal table).
"""

from .flight import (
    FlightRecorder,
    flight_clear,
    flight_disable,
    flight_dump,
    flight_enable,
    flight_enabled,
    get_flight,
)
from .occupancy import OwnedLock, all_locks, occupancy_snapshot
from .registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    all_registries,
    get_registry,
)
from .trace import (
    Tracer,
    clear,
    disable,
    enable,
    enabled,
    get_tracer,
    span,
)
from .export import (
    chrome_trace,
    metrics_snapshot,
    serve_prometheus,
    summary,
    to_prometheus_text,
    validate_chrome_trace,
    write_chrome_trace,
    write_metrics_json,
)
from .watchdog import (
    WatchRule,
    Watchdog,
    counter_delta_rule,
    gauge_rule,
    lock_wait_rule,
)

__all__ = [
    "Counter",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "OwnedLock",
    "Tracer",
    "WatchRule",
    "Watchdog",
    "all_locks",
    "all_registries",
    "chrome_trace",
    "clear",
    "counter_delta_rule",
    "disable",
    "enable",
    "enabled",
    "flight_clear",
    "flight_disable",
    "flight_dump",
    "flight_enable",
    "flight_enabled",
    "gauge_rule",
    "get_flight",
    "get_registry",
    "get_tracer",
    "lock_wait_rule",
    "metrics_snapshot",
    "occupancy_snapshot",
    "serve_prometheus",
    "span",
    "summary",
    "to_prometheus_text",
    "validate_chrome_trace",
    "write_chrome_trace",
    "write_metrics_json",
]
