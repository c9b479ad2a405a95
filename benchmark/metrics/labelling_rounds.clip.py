"""labelling_rounds.clip: the program's labelling_rounds counter over its clips counter (every clip the process ran, the warm-up clip too), read from tee_optical_flow_torch.utils.tracing.get_counters when the run is read; rounds per clip."""

UNIT = "rounds"
COUNTER = "labelling_rounds"


def read(run):
    if run.get("driver") != "clip":
        return None
    try:
        from tee_optical_flow_torch.utils import tracing
    except ImportError:
        return None
    get_counters = getattr(tracing, "get_counters", None)
    if get_counters is None:  # a program without counters
        return None
    counters = get_counters()
    clips = counters.get("clips", 0)
    if not clips:
        return None
    return counters.get(COUNTER, 0) / clips
