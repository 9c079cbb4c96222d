"""SLO watchdog: declarative sliding-window rules over the obs plane;
the port of the reference's obs/watchdog.py.

The paper's serving claim is a latency *objective* (initial result sets
arrive fast, even under ingest); this module is the piece that holds a
long-running deployment to it. A :class:`Watchdog` thread evaluates
declarative :class:`WatchRule`s on a fixed tick; each rule aggregates a
probe over a sliding time window (p99 of TTFR events, max per-group lock
acquire-wait delta, the compactor's worst increment, per-writer blocked
seconds) and compares against a threshold. On breach it

- bumps ``watchdog_incidents_total{rule=...}`` on the default registry,
- writes an **incident bundle** to the incident directory:
  ``incident.json`` (rule, value, threshold, window), ``trace.json``
  (the flight recorder's last-N-seconds dump — the evidence that is
  normally gone by the time anyone looks), and ``metrics.json``
  (a full ``export.metrics_snapshot``),

then holds its fire for ``cooldown_s`` so a sustained breach produces a
bundle per cooldown period, not per tick.

Probe shapes, by ``agg``:

- ``"p99"`` / ``"max"`` — *event* probes: callable returning an iterable
  of ``(t, value)`` samples produced since the last call (t =
  ``time.perf_counter()``); the watchdog windows and aggregates them.
- ``"delta"`` — *cumulative* probes: callable returning a monotonic
  total (lock wait seconds, blocked seconds); the value is the increase
  over the window.
- ``"gauge"`` — instantaneous probes: callable returning the current
  value (the compactor's max-increment gauge).

Rule construction helpers for the common lock/counter probes live here;
the TTFR event source lives with the serve plane
(`repro_torch.serve_db.profile.ttfr_event_probe`) — obs stays import-free of
serve_db.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from .flight import get_flight
from .occupancy import occupancy_snapshot
from .registry import get_registry

__all__ = [
    "WatchRule",
    "Watchdog",
    "counter_delta_rule",
    "gauge_rule",
    "lock_wait_rule",
]

_AGGS = ("p99", "max", "delta", "gauge")


class WatchRule:
    """One declarative SLO: ``agg(probe, window_s) > threshold`` is a
    breach. See module docstring for the probe shape per ``agg``."""

    def __init__(
        self,
        name: str,
        probe: Callable[[], Any],
        threshold: float,
        window_s: float = 30.0,
        agg: str = "p99",
        cooldown_s: float = 30.0,
        help: str = "",
    ) -> None:
        if agg not in _AGGS:
            raise ValueError(f"agg must be one of {_AGGS}: {agg!r}")
        self.name = name
        self.probe = probe
        self.threshold = float(threshold)
        self.window_s = float(window_s)
        self.agg = agg
        self.cooldown_s = float(cooldown_s)
        self.help = help

    def describe(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "agg": self.agg,
            "threshold": self.threshold,
            "window_s": self.window_s,
            "cooldown_s": self.cooldown_s,
            "help": self.help,
        }


def _p99(values: List[float]) -> float:
    if not values:
        return 0.0
    vs = sorted(values)
    # Nearest-rank p99.
    rank = max(0, min(len(vs) - 1, int(round(0.99 * (len(vs) - 1)))))
    return vs[rank]


class Watchdog:
    """Evaluate rules every ``interval_s`` on a daemon thread; write
    incident bundles on breach. Use as a context manager or call
    start()/stop()."""

    def __init__(
        self,
        rules: Iterable[WatchRule],
        incident_dir: str = "incidents",
        interval_s: float = 0.25,
        flight_window_s: float = 30.0,
        registry=None,
    ) -> None:
        self.rules = list(rules)
        self.incident_dir = incident_dir
        self.interval_s = float(interval_s)
        self.flight_window_s = float(flight_window_s)
        self._flight = get_flight()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        # Per-rule sliding sample window and breach bookkeeping. Written
        # by the watchdog thread, read by incidents()/values() callers.
        self._windows: Dict[str, deque] = {  # guarded-by: _lock
            r.name: deque() for r in self.rules
        }
        self._last_fire: Dict[str, float] = {}  # guarded-by: _lock
        self._incidents: List[Dict[str, Any]] = []  # guarded-by: _lock
        self._values: Dict[str, float] = {}  # guarded-by: _lock
        reg = registry if registry is not None else get_registry()
        self._m_incidents = reg.counter(
            "watchdog_incidents_total", "SLO breaches, by rule"
        )
        self._m_value = reg.gauge(
            "watchdog_rule_value", "last windowed value per rule"
        )
        self._m_breached = reg.gauge(
            "watchdog_rule_breached", "1 while the rule's window is in breach"
        )
        self._m_ticks = reg.counter(
            "watchdog_ticks_total", "watchdog evaluation passes"
        )

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "Watchdog":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="slo-watchdog", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def __enter__(self) -> "Watchdog":
        return self.start()

    def __exit__(self, *exc: object) -> None:
        self.stop()

    # ---------------------------------------------------------- evaluation
    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.tick()

    def tick(self) -> None:
        """One evaluation pass (public so tests can drive the watchdog
        synchronously, without the thread)."""
        now = time.perf_counter()
        self._m_ticks.inc()
        for rule in self.rules:
            try:
                value = self._evaluate(rule, now)
            except Exception as e:  # a broken probe must not kill the loop
                self._m_value.set(float("nan"), rule=rule.name)
                self._note_probe_error(rule, e)
                continue
            breached = value > rule.threshold
            self._m_value.set(value, rule=rule.name)
            self._m_breached.set(1.0 if breached else 0.0, rule=rule.name)
            if breached and self._cooldown_ok(rule, now):
                self._incident(rule, value, now)

    def _evaluate(self, rule: WatchRule, now: float) -> float:
        with self._lock:
            win = self._windows[rule.name]
        if rule.agg in ("p99", "max"):
            events = list(rule.probe() or ())
            with self._lock:
                win.extend(events)
                cut = now - rule.window_s
                while win and win[0][0] < cut:
                    win.popleft()
                values = [v for _, v in win]
            value = _p99(values) if rule.agg == "p99" else (max(values) if values else 0.0)
        elif rule.agg == "delta":
            total = float(rule.probe())
            with self._lock:
                win.append((now, total))
                cut = now - rule.window_s
                while len(win) > 1 and win[0][0] < cut:
                    win.popleft()
                value = total - win[0][1]
        else:  # gauge
            value = float(rule.probe())
            with self._lock:
                win.append((now, value))
                cut = now - rule.window_s
                while win and win[0][0] < cut:
                    win.popleft()
        with self._lock:
            self._values[rule.name] = value
        return value

    def _cooldown_ok(self, rule: WatchRule, now: float) -> bool:
        with self._lock:
            last = self._last_fire.get(rule.name)
            if last is not None and (now - last) < rule.cooldown_s:
                return False
            self._last_fire[rule.name] = now
            return True

    def _note_probe_error(self, rule: WatchRule, e: Exception) -> None:
        with self._lock:
            self._incidents.append(
                {"rule": rule.name, "error": repr(e), "kind": "probe_error"}
            )

    # ------------------------------------------------------------ incident
    def _incident(self, rule: WatchRule, value: float, now: float) -> None:
        from .export import metrics_snapshot  # late: export imports trace

        self._m_incidents.inc(rule=rule.name)
        with self._lock:
            seq = sum(1 for i in self._incidents if i.get("kind") != "probe_error")
        bundle_dir = os.path.join(
            self.incident_dir, f"{seq:04d}_{rule.name}"
        )
        record: Dict[str, Any] = {
            "kind": "incident",
            "rule": rule.name,
            "value": value,
            "threshold": rule.threshold,
            "window_s": rule.window_s,
            "agg": rule.agg,
            "wallclock": time.time(),
            "bundle": bundle_dir,
            **{"describe": rule.describe()},
        }
        try:
            os.makedirs(bundle_dir, exist_ok=True)
            with open(os.path.join(bundle_dir, "incident.json"), "w") as f:
                json.dump(record, f, indent=2, sort_keys=True)
                f.write("\n")
            with open(os.path.join(bundle_dir, "trace.json"), "w") as f:
                json.dump(self._flight.dump(self.flight_window_s), f)
                f.write("\n")
            with open(os.path.join(bundle_dir, "metrics.json"), "w") as f:
                json.dump(metrics_snapshot(), f, indent=2, sort_keys=True)
                f.write("\n")
        except OSError as e:
            record["write_error"] = repr(e)
        with self._lock:
            self._incidents.append(record)

    # ------------------------------------------------------------- queries
    def incidents(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._incidents)

    def values(self) -> Dict[str, float]:
        """Last windowed value per rule (the watchdog's own view of the
        system, mirrored on watchdog_rule_value)."""
        with self._lock:
            return dict(self._values)


# ------------------------------------------------------- rule constructors
def lock_wait_rule(
    name: str,
    lock_prefix: str,
    threshold_s: float,
    window_s: float = 30.0,
    cooldown_s: float = 30.0,
) -> WatchRule:
    """Acquire-wait seconds accrued over the window, summed across every
    OwnedLock whose name starts with ``lock_prefix`` (e.g. "plane_lock"
    covers plane_lock + plane_lock_g<i> on a sharded plane)."""

    def probe() -> float:
        snap = occupancy_snapshot()
        return sum(
            float(s["total_wait_s"])
            for lname, s in snap.items()
            if lname.startswith(lock_prefix)
        )

    return WatchRule(
        name, probe, threshold_s, window_s=window_s, agg="delta",
        cooldown_s=cooldown_s,
        help=f"acquire-wait delta over {window_s:.0f}s on {lock_prefix}*",
    )


def counter_delta_rule(
    name: str,
    counter,
    threshold: float,
    window_s: float = 30.0,
    cooldown_s: float = 30.0,
) -> WatchRule:
    """Increase of a registry Counter's total over the window (per-writer
    blocked-seconds, fold events, ...)."""

    def probe() -> float:
        return float(counter.total())

    return WatchRule(
        name, probe, threshold, window_s=window_s, agg="delta",
        cooldown_s=cooldown_s, help=f"delta of {counter.name} over window",
    )


def gauge_rule(
    name: str,
    gauge,
    threshold: float,
    cooldown_s: float = 30.0,
    **labels: object,
) -> WatchRule:
    """Instantaneous gauge vs threshold (compaction increment stall:
    compactor_max_increment_seconds)."""

    def probe() -> float:
        return float(gauge.value(**labels))

    return WatchRule(
        name, probe, threshold, window_s=1.0, agg="gauge",
        cooldown_s=cooldown_s, help=f"gauge {gauge.name} vs threshold",
    )
