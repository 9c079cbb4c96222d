"""Observability for the port: metrics registry (counters and gauges),
span tracing with device fencing, and lock occupancy books. Cut to what
the ingest plane, the scan path and chip_smoke.py read."""
from .occupancy import OwnedLock  # noqa: F401
from .registry import Counter, Gauge, MetricsRegistry  # noqa: F401
from .trace import clear, disable, enable, get_tracer, span  # noqa: F401
