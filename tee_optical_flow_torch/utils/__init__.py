from .helpers import (
    find_start_stop, fix_ecg, frame2time, index_smallest_positive,
    pad_to_multiple, safe_makedir, timeinterval2index,
)
from .tracing import StageTimer, get_stage_report, trace_stage

__all__ = ["find_start_stop", "fix_ecg", "frame2time",
           "index_smallest_positive", "pad_to_multiple", "safe_makedir",
           "timeinterval2index", "StageTimer", "get_stage_report",
           "trace_stage"]
