"""Spans and counters of the clip path (the JAX package's utils/tracing.py,
whose per-stage wall-clock timer this extends).

A span (``trace_stage(name)`` or ``StageTimer(name)``) records its name,
its parent (the innermost span open on the same thread), the clip id that
``clip`` set (``process_video`` opens one clip per call), optional
attributes (such as ``level``) and its host start and end on
``time.perf_counter``.

While the thread's clip runs on a card, a span also records a CUDA timing
event on the clip device's current stream at entry and at exit, and is
timed to completion: it runs from the moment both the host and the
device reached its start to the moment both reached its end. On one
stream, spans then tile both timelines, and a span that only enqueues
work is charged the device time of that work, not the time of the
enqueue. Events are put on the ``perf_counter`` clock through an anchor:
``anchor(device)``, called right after a point where the program already
waited for the card, records an event there and reads the host clock
(one anchor kept per device, with the one before it). A span resolves once
its end event has completed, at the next anchor; nothing in a clip waits
on the card for tracing. ``get_stage_report``, which runs outside any
clip, synchronises the cards that still have spans to resolve. Spans
outside a clip, and every span of a clip on the CPU, record host times
only.

``get_stage_report`` sums the resolved spans by name: total, calls, mean
and self time (a span's time less the part its child spans cover);
``get_spans`` returns the most recent ``SPAN_LOG_CAP`` spans; ``count``
adds to a named counter and ``get_counters`` returns the totals over the
process's life (never reset: callers take differences). ``count_sync``
counts a point where the host waits on a card (``host_syncs``).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Dict, List, Optional

import torch

SPAN_LOG_CAP = 4096


class CudaClock:
    """The host clock and the CUDA timing events spans record: the seam
    a test replaces with injected times. An event has ``query()``,
    ``synchronize()`` and ``elapsed_time(later)`` in milliseconds."""

    now = staticmethod(time.perf_counter)

    @staticmethod
    def record(device: int):
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(device))
        return event

    @staticmethod
    def synchronize(device: int) -> None:
        torch.cuda.synchronize(device)


class _Span:
    __slots__ = ("id", "name", "parent", "clip", "attrs", "device",
                 "host_start", "host_end", "ev_start", "ev_end",
                 "children", "open_children")

    def __init__(self, span_id, name, parent, clip, attrs, device):
        self.id = span_id
        self.name = name
        self.parent = parent
        self.clip = clip
        self.attrs = attrs
        self.device = device
        self.host_start = self.host_end = 0.0
        self.ev_start = self.ev_end = None  # (event, record order)
        self.children: List[tuple] = []  # resolved (start, end)
        self.open_children = 0


def _covered(intervals, start: float, end: float) -> float:
    """Length of the union of ``intervals`` within [start, end]."""
    total, reach = 0.0, start
    for a, b in sorted(intervals):
        a, b = max(a, reach), min(b, end)
        if b > a:
            total += b - a
            reach = b
    return total


class Tracer:
    """The spans, anchors and counters of one process (module docstring).
    The module's functions use one shared instance; a test may build its
    own around another clock."""

    def __init__(self, clock=None, log_cap: int = SPAN_LOG_CAP):
        self.clock = clock or CudaClock()
        self._local = threading.local()
        self._lock = threading.RLock()
        self._ids = itertools.count(1)
        self._clip_ids = itertools.count(1)
        self._order = itertools.count()  # record order of every event
        self._pending: List[_Span] = []  # closed card spans, in exit order
        self._anchors: Dict[int, list] = {}  # device -> [(event, order, t)]
        self._totals: Dict[str, list] = {}  # name -> [total, calls, self]
        self._counters: Dict[str, int] = {}
        self._log = collections.deque(maxlen=log_cap)

    # --- the clip and its device -----------------------------------------

    @staticmethod
    def card_index(device) -> Optional[int]:
        """The CUDA device index of ``device``, or None off a card."""
        dev = torch.device(device)
        if dev.type != "cuda":
            return None
        return dev.index if dev.index is not None \
            else torch.cuda.current_device()

    @contextlib.contextmanager
    def clip(self, device):
        """One clip on ``device`` for this thread's spans; counts
        ``clips`` and yields the clip id."""
        loc = self._local
        saved = (getattr(loc, "clip", None), getattr(loc, "device", None))
        loc.clip = next(self._clip_ids)
        loc.device = self.card_index(device)
        self.count("clips")
        try:
            yield loc.clip
        finally:
            loc.clip, loc.device = saved

    def anchor(self, device) -> None:
        """Tie ``device``'s events to the host clock. Call right after a
        point where the host already waited for the card (the clip's last
        copy to the host); resolves the spans that have completed."""
        idx = self.card_index(device)
        if idx is None:
            return
        t = self.clock.now()
        event = self.clock.record(idx)
        with self._lock:
            self._keep_anchor(idx, event, t)
            self._resolve()

    def _keep_anchor(self, idx: int, event, t: float) -> None:
        anchors = self._anchors.setdefault(idx, [])
        anchors.append((event, next(self._order), t))
        del anchors[:-2]

    # --- spans ------------------------------------------------------------

    def _stack(self) -> List[_Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def enter(self, name: str, attrs: Optional[dict] = None) -> _Span:
        stack = self._stack()
        parent = stack[-1] if stack else None
        span = _Span(next(self._ids), name, parent,
                     getattr(self._local, "clip", None), attrs or {},
                     getattr(self._local, "device", None))
        with self._lock:
            self._totals.setdefault(name, [0.0, 0, 0.0])
            if parent is not None:
                parent.open_children += 1
        stack.append(span)
        span.host_start = self.clock.now()
        if span.device is not None:
            span.ev_start = (self.clock.record(span.device),
                             next(self._order))
        return span

    def exit(self, span: _Span) -> None:
        if span.device is not None:
            span.ev_end = (self.clock.record(span.device), next(self._order))
        span.host_end = self.clock.now()
        stack = self._stack()
        if stack and stack[-1] is span:
            stack.pop()
        else:
            stack.remove(span)
        with self._lock:
            if span.ev_end is None and not span.open_children:
                self._finish(span, span.host_start, span.host_end)
            else:
                self._pending.append(span)

    def _finish(self, span: _Span, start: float, end: float) -> None:
        duration = end - start
        self_s = duration - _covered(span.children, start, end)
        totals = self._totals.setdefault(span.name, [0.0, 0, 0.0])
        totals[0] += duration
        totals[1] += 1
        totals[2] += self_s
        parent = span.parent
        self._log.append({
            "id": span.id, "name": span.name,
            "parent": None if parent is None else parent.id,
            "clip": span.clip, "attrs": span.attrs, "start": start,
            "end": end, "self_s": self_s, "host_start": span.host_start,
            "host_end": span.host_end})
        if parent is not None:
            parent.children.append((start, end))
            parent.open_children -= 1

    @staticmethod
    def _on_host(recorded, anchor) -> float:
        """Host time of a recorded event through a completed anchor."""
        event, order = recorded
        a_event, a_order, t = anchor
        if order < a_order:
            return t - event.elapsed_time(a_event) / 1e3
        return t + a_event.elapsed_time(event) / 1e3

    def _resolve(self) -> None:
        """Finish every closed span whose end event has completed, whose
        children are finished and whose device has a completed anchor
        (the newest one). Holds the lock."""
        anchors: Dict[int, Optional[tuple]] = {}
        keep = []
        for span in self._pending:  # children close before their parents
            if span.open_children:
                keep.append(span)
                continue
            if span.ev_end is None:  # a host span around a clip's spans
                self._finish(span, span.host_start, span.host_end)
                continue
            if span.device not in anchors:
                anchors[span.device] = next(
                    (a for a in reversed(self._anchors.get(span.device, []))
                     if a[0].query()), None)
            anchor = anchors[span.device]
            if anchor is None or not span.ev_end[0].query():
                keep.append(span)
                continue
            self._finish(
                span, max(span.host_start, self._on_host(span.ev_start,
                                                         anchor)),
                max(span.host_end, self._on_host(span.ev_end, anchor)))
        self._pending = keep

    def drain(self) -> None:
        """Resolve every closed span, synchronising each card that has
        one pending. Not for use inside a clip."""
        with self._lock:
            for idx in sorted({s.device for s in self._pending
                               if s.device is not None}):
                self.clock.synchronize(idx)
                t = self.clock.now()
                event = self.clock.record(idx)
                event.synchronize()
                self._keep_anchor(idx, event, t)
            self._resolve()

    # --- reports and counters ---------------------------------------------

    def stage_report(self, reset: bool = False) -> Dict[str, dict]:
        self.drain()
        with self._lock:
            report = {name: {"total_s": total, "calls": calls,
                             "mean_s": total / calls, "self_s": self_s}
                      for name, (total, calls, self_s) in self._totals.items()
                      if calls}
            if reset:
                self._totals.clear()
        return report

    def spans(self) -> List[dict]:
        with self._lock:
            self._resolve()
            return list(self._log)

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)


_TRACER = Tracer()


class StageTimer:
    """A named span (see the module docstring) with optional attributes;
    ``elapsed`` sums the host seconds of its uses."""

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs
        self.elapsed = 0.0
        self._span: Optional[_Span] = None

    def __enter__(self):
        self._span = _TRACER.enter(self.name, self.attrs)
        return self

    def __exit__(self, *exc):
        span = self._span
        _TRACER.exit(span)
        self.elapsed += span.host_end - span.host_start
        return False


@contextlib.contextmanager
def trace_stage(name: str, **attrs):
    """A pipeline stage as a span, with optional attributes."""
    with StageTimer(name, **attrs):
        yield


def clip(device):
    """Context of one clip on ``device`` (``process_video``); yields its
    id."""
    return _TRACER.clip(device)


def anchor(device) -> None:
    """Tie ``device``'s span events to the host clock (Tracer.anchor)."""
    _TRACER.anchor(device)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _TRACER.count(name, n)


def count_sync(device, n: int = 1) -> None:
    """Count ``n`` host waits on ``device`` in ``host_syncs``, if it is a
    card."""
    if torch.device(device).type == "cuda":
        _TRACER.count("host_syncs", n)


def get_counters() -> Dict[str, int]:
    """A snapshot of every counter's total over the process's life."""
    return _TRACER.counters()


def get_spans() -> List[dict]:
    """The most recent resolved spans (at most SPAN_LOG_CAP), oldest
    first, each {id, name, parent (its id), clip, attrs, start, end,
    self_s, host_start, host_end}, on the perf_counter clock."""
    return _TRACER.spans()


def get_stage_report(reset: bool = False) -> Dict[str, dict]:
    """Return {stage: {total_s, calls, mean_s, self_s}} accumulated so
    far, each span timed to completion; synchronises the cards whose
    spans are still pending."""
    return _TRACER.stage_report(reset)
