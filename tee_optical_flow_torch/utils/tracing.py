"""Per-stage wall-clock timing, with an optional profiler annotation (the
JAX package's utils/tracing.py; ``jax.profiler.TraceAnnotation`` becomes
``torch.profiler.record_function``).

Stage times are host-clock times: a stage that launches CUDA work and does
not synchronise is timed to its enqueue, not to its completion.
"""

from __future__ import annotations

import contextlib
import time
from collections import OrderedDict
from typing import Dict, Optional

_STAGE_TOTALS: "OrderedDict[str, float]" = OrderedDict()
_STAGE_COUNTS: Dict[str, int] = {}


class StageTimer:
    """Accumulating named wall-clock timer; each exit adds to the stage's
    totals in the stage report."""

    def __init__(self, name: str):
        self.name = name
        self.elapsed = 0.0
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self.elapsed += dt
        _STAGE_TOTALS[self.name] = _STAGE_TOTALS.get(self.name, 0.0) + dt
        _STAGE_COUNTS[self.name] = _STAGE_COUNTS.get(self.name, 0) + 1
        return False


@contextlib.contextmanager
def trace_stage(name: str, profile: bool = False):
    """Time a pipeline stage; with ``profile`` also mark it as a range in a
    running ``torch.profiler`` trace."""
    if profile:
        from torch.profiler import record_function

        with record_function(name), StageTimer(name):
            yield
    else:
        with StageTimer(name):
            yield


def get_stage_report(reset: bool = False) -> Dict[str, dict]:
    """Return {stage: {total_s, calls, mean_s}} accumulated so far."""
    report = {
        name: {
            "total_s": total,
            "calls": _STAGE_COUNTS[name],
            "mean_s": total / _STAGE_COUNTS[name],
        }
        for name, total in _STAGE_TOTALS.items()
    }
    if reset:
        _STAGE_TOTALS.clear()
        _STAGE_COUNTS.clear()
    return report
