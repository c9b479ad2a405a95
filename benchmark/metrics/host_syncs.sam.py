"""host_syncs.sam: the program's host_syncs counter (each point where the clip path waits on the card: pageable uploads, copies to the host, scalar reads, the labellings' flag reads; none off a card) over its clips counter (every clip the process ran, the warm-up clip too), read from tee_optical_flow_torch.utils.tracing.get_counters when the run is read; waits per clip."""

UNIT = "count"
COUNTER = "host_syncs"


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
    if not clips:
        return None
    return counters.get(COUNTER, 0) / clips
