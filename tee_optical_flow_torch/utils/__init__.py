from .helpers import pad_to_multiple, safe_makedir
from .tracing import get_stage_report, trace_stage

__all__ = ["pad_to_multiple", "safe_makedir", "get_stage_report",
           "trace_stage"]
