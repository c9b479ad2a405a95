"""labelling_s.sam: the program's labelling spans per clip (each connected_components call, run to its first quiet pass: four a clip in RVIO_2class, each label's fill and size filter), timed to completion; seconds, from a SAM clip cell's traced window."""

UNIT = "s"


def read(run):
    if run.get("driver") != "sam_clip":
        return None
    return run["stages"].get("labelling")
