"""global_attn_s.sam: the program's global_attn spans per clip (each global block's attention, from q, k and v to the weighted sum, on each micro-batch), timed to completion; seconds, from a SAM clip cell's traced window."""

UNIT = "s"


def read(run):
    if run.get("driver") != "sam_clip":
        return None
    return run["stages"].get("global_attn")
