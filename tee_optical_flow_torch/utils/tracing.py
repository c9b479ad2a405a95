"""Per-stage wall-clock timing (the JAX package's utils/tracing.py, without
the jax profiler hook).

Stage times are host-clock times: a stage that launches CUDA work and does
not synchronise is timed to its enqueue, not to its completion.
"""

from __future__ import annotations

import contextlib
import time
from collections import OrderedDict
from typing import Dict

_STAGE_TOTALS: "OrderedDict[str, float]" = OrderedDict()
_STAGE_COUNTS: Dict[str, int] = {}


@contextlib.contextmanager
def trace_stage(name: str):
    """Time a pipeline stage, adding to its totals in the stage report."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        _STAGE_TOTALS[name] = _STAGE_TOTALS.get(name, 0.0) + dt
        _STAGE_COUNTS[name] = _STAGE_COUNTS.get(name, 0) + 1


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
