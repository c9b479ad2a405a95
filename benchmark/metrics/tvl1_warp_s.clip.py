"""tvl1_warp_s.clip: the program's tvl1_warp spans per clip (each warp's image warp and residual terms, at every pyramid level), timed to completion; seconds, from a clip cell's traced window."""

UNIT = "s"


def read(run):
    if run.get("driver") != "clip":
        return None
    return run["stages"].get("tvl1_warp")
