"""The traced run's instruments: the benchmark's own host spans around
its calls into each layer of the port, and a ``torch.profiler`` window
over the card, read back as busy time, kernel time by name and idle gaps
labelled by the spans open while the card waited.

Spans cost a clock read and a list append; with ``--trace 0`` they are
not recorded at all.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

MARKER_CYCLES = 20_000  # the spin kernel that ties the card's clock to the host's


class Spans:
    """Host spans (name, thread, start, end) on the perf_counter clock."""

    def __init__(self, on: bool):
        self.on = on
        self.records: List[Tuple[str, int, float, float]] = []
        self._lock = threading.Lock()

    @contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            rec = (name, threading.get_ident(), t0, time.perf_counter())
            with self._lock:
                self.records.append(rec)


@dataclass
class DeviceTrace:
    """What the profiler saw of the card over the traced window."""

    window_s: float
    busy_s: float
    kernel_s: Dict[str, float] = field(default_factory=dict)  # by kernel name
    idle_by_host: Dict[str, float] = field(default_factory=dict)  # idle seconds by open spans


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def label_gaps(spans: List[Tuple[str, int, float, float]],
               gaps: List[Tuple[float, float]]) -> Dict[str, float]:
    """Idle seconds by what the host was doing: each gap (sorted, apart)
    goes to the distinct names of the spans open at its middle."""
    edges = sorted([(s, 1, n) for n, _, s, _ in spans] + [(e, -1, n) for n, _, _, e in spans],
                   key=lambda x: (x[0], x[1]))
    open_: Dict[str, int] = {}
    out: Dict[str, float] = {}
    i = 0
    for a, b in gaps:
        mid = 0.5 * (a + b)
        while i < len(edges) and edges[i][0] <= mid:
            _, d, n = edges[i]
            open_[n] = open_.get(n, 0) + d
            i += 1
        names = sorted(n for n, k in open_.items() if k > 0)
        lab = "+".join(names) if names else "no bench span open"
        out[lab] = out.get(lab, 0.0) + (b - a)
    return out


class DeviceWindow:
    """A torch.profiler window (CUDA activity only) on the card. The
    card's clock is tied to the host's by a spin kernel launched on an
    idle stream right after a host clock read."""

    def __init__(self, device, on: bool):
        self.device = device
        self.on = on and getattr(device, "type", "cpu") == "cuda"
        self._prof = None
        self._mark_host = 0.0

    def start(self) -> None:
        if not self.on:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize(self.device)
        self._mark_host = time.perf_counter()
        torch.cuda._sleep(MARKER_CYCLES)

    def stop(self, t0: float, t1: float, spans: Spans) -> Optional[DeviceTrace]:
        """Close the window and read it over host times [t0, t1]."""
        if self._prof is None:
            return None
        import torch

        torch.cuda.synchronize(self.device)
        self._prof.__exit__(None, None, None)
        evs = _device_events(self._prof)
        self._prof = None
        marks = [e for e in evs if "spin_kernel" in e[0]] or evs
        if not marks:
            return DeviceTrace(window_s=t1 - t0, busy_s=0.0)
        # Host seconds of device microsecond 0 (should the marker be lost,
        # the first event stands for it, a few microseconds late).
        shift = self._mark_host - min(e[1] for e in marks) / 1e6

        intervals, kernel_s = [], {}
        for name, start, end in evs:
            if "spin_kernel" in name:
                continue
            a = max(start / 1e6 + shift, t0)
            b = min(end / 1e6 + shift, t1)
            if b <= a:
                continue
            intervals.append((a, b))
            kernel_s[name] = kernel_s.get(name, 0.0) + (b - a)
        busy = _union(intervals)
        edges = [t0] + [x for iv in busy for x in iv] + [t1]
        gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
        return DeviceTrace(window_s=t1 - t0, busy_s=sum(b - a for a, b in busy),
                           kernel_s=kernel_s, idle_by_host=label_gaps(spans.records, gaps))


def short_name(name: str, width: int = 96) -> str:
    """A kernel's name without its return type, cut to ``width``."""
    return name[5:width + 5] if name.startswith("void ") else name[:width]


def _device_events(prof) -> List[Tuple[str, float, float]]:
    """(name, start us, end us) of every device event of a closed window,
    from the profiler's raw results when it has them: a window holds
    millions of events, and building the profiler's event tree for them
    takes minutes."""
    from torch.autograd import DeviceType

    raw = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if raw is not None:
        out = []
        for e in raw.events():
            if e.device_type() == DeviceType.CUDA:
                s = e.start_ns()
                out.append((e.name(), s / 1e3, (s + e.duration_ns()) / 1e3))
        return out
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def top(d: Dict[str, float], n: int = 10) -> List[List[object]]:
    """The n largest entries, names shortened (entries whose short names
    agree summed)."""
    merged: Dict[str, float] = {}
    for k, v in d.items():
        merged[short_name(k)] = merged.get(short_name(k), 0.0) + v
    return [[k, v] for k, v in sorted(merged.items(), key=lambda kv: -kv[1])[:n]]
