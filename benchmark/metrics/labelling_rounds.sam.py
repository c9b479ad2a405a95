"""labelling_rounds.sam: the program's labelling_rounds counter (the rounds of neighbour-min propagation its masks' labellings ran, four a clip in RVIO_2class: each label's fill and size filter) over its clips counter (every clip the process ran, the warm-up clip too), read from tee_optical_flow_torch.utils.tracing.get_counters when the run is read; rounds per clip."""

UNIT = "rounds/clip"
COUNTER = "labelling_rounds"


def read(run):
    if run.get("driver") != "sam_clip":
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
    if not clips or COUNTER not in counters:
        return None
    return counters[COUNTER] / clips
