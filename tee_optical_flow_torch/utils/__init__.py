from .helpers import (
    bucket_shape, find_start_stop, fix_ecg, frame2time, img2uint8,
    index_smallest_positive, pad_to_multiple, safe_makedir,
    timeinterval2index,
)
from .tracing import StageTimer, get_stage_report, trace_stage

__all__ = ["safe_makedir", "img2uint8", "find_start_stop", "fix_ecg",
           "frame2time", "index_smallest_positive", "pad_to_multiple",
           "bucket_shape", "timeinterval2index", "StageTimer",
           "get_stage_report", "trace_stage"]
