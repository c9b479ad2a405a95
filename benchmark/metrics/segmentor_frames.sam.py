"""segmentor_frames.sam: the program's segmentor_frames counter (the frames its segmentor ran through the encoder, frame-bucket padding and the shifted tail's overlap included) over its clips counter (every clip the process ran, the warm-up clip too), read from tee_optical_flow_torch.utils.tracing.get_counters when the run is read; frames per clip."""

UNIT = "frames/clip"
COUNTER = "segmentor_frames"


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
