"""Device traces and host spans.

``Spans`` records named host intervals (the benchmark's own around each
call into the program, and the program's ``trace_stage`` stages, read by
wrapping the name the pipeline calls). ``profile`` runs a function under
``torch.profiler`` with device activity only (the host's events cost tens
of seconds a clip) and reduces the trace: the union of device-activity
intervals (busy), the span's length on the host clock (window), device
time by kernel name, and the longest idle gaps, each named by the
innermost host span it fell in. The device and host clocks are tied by a
marker: the device is idle when the profile starts, so the first device
event is the marker launched at a known host time.
"""

from __future__ import annotations

import contextlib
import re
import time
from typing import Callable, Dict, List, Tuple

TOP = 10


class Spans:
    """Named (start, end) intervals on the host's perf_counter clock."""

    def __init__(self) -> None:
        self.items: List[Tuple[str, float, float]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.items.append((name, t0, time.perf_counter()))

    def wrap_stage(self, trace_stage: Callable) -> Callable:
        """A stand-in for the program's ``trace_stage`` that keeps its
        timing and records each stage as a span."""
        spans = self

        @contextlib.contextmanager
        def recording(name, *args, **kw):
            with trace_stage(name, *args, **kw), spans.span(name):
                yield
        return recording

    def name_at(self, t: float, default: str) -> str:
        """The innermost span around host time ``t``."""
        inside = [(t1 - t0, name) for name, t0, t1 in self.items
                  if t0 <= t <= t1]
        return min(inside)[1] if inside else default


def kernel_matches(event_name: str, kernel: str) -> bool:
    """Whether a profiler event names ``kernel`` (a template instance or a
    namespaced one too)."""
    return re.search(rf"(^|::|\s){re.escape(kernel)}[(<]",
                     event_name) is not None


def union_length(intervals: List[Tuple[float, float]]) -> Tuple[float, list]:
    """Total length of the union of intervals, and the merged intervals."""
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), merged


def reduce_events(events: List[Tuple[str, float, float]], t_marker: float,
                  t_end: float, spans: Spans, default: str = "harness"
                  ) -> Dict:
    """Reduce device events (name, start_us, end_us), the first being the
    marker launched at host time ``t_marker``, over the host span
    [t_marker, t_end]."""
    if not events:
        raise RuntimeError("the profiler recorded no device activity")
    events = sorted(events, key=lambda e: e[1])
    origin = events[0][1]

    def host(us: float) -> float:
        return t_marker + (us - origin) / 1e6

    busy_us, merged = union_length([(a, b) for _, a, b in events])
    by_name: Dict[str, List[float]] = {}
    for name, a, b in events:
        entry = by_name.setdefault(name, [0, 0.0])
        entry[0] += 1
        entry[1] += (b - a) / 1e6
    gaps = [(host((a[1] + b[0]) / 2), (b[0] - a[1]) / 1e6)
            for a, b in zip(merged, merged[1:])]
    tail = t_end - host(merged[-1][1])
    if tail > 0:
        gaps.append(((host(merged[-1][1]) + t_end) / 2, tail))
    gaps.sort(key=lambda g: -g[1])
    window_s = t_end - t_marker
    return {
        "busy_s": busy_us / 1e6,
        "window_s": window_s,
        "kernels": {n: (int(c), s) for n, (c, s) in by_name.items()},
        "breakdown": {
            "device_ops": [[n[:160], s] for n, (c, s) in sorted(
                by_name.items(), key=lambda kv: -kv[1][1])[:TOP]],
            "idle_gaps": [[spans.name_at(t, default), s]
                          for t, s in gaps[:TOP]],
        },
    }


def profile(fn: Callable[[], None], spans: Spans) -> Dict:
    """Run ``fn`` under torch.profiler (device activity only) and reduce
    the trace over the span from the marker to the last synchronise."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    marker = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        t_marker = time.perf_counter()
        marker.add_(1)
        fn()
        torch.cuda.synchronize()
        t_end = time.perf_counter()
    events = [(e.name, e.time_range.start, e.time_range.end)
              for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return reduce_events(events, t_marker, t_end, spans)


def device_seconds(kernels: Dict[str, Tuple[int, float]],
                   names: List[str]) -> float:
    """Device seconds of the kernels named (any instance of each)."""
    return sum(s for event, (_, s) in kernels.items()
               if any(kernel_matches(event, k) for k in names))
