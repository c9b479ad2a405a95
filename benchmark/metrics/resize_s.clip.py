"""resize_s.clip: the program's resize spans per clip (the pyramid's downsampling and the flow's upsampling between levels, each with its weights' upload), timed to completion; seconds, from a clip cell's traced window."""

UNIT = "s"


def read(run):
    if run.get("driver") != "clip":
        return None
    return run["stages"].get("resize")
