"""tvl1_loop_s.clip: the program's tvl1_loop spans per clip (each warp's call of K1 or the block loop, at every pyramid level), timed to completion; seconds, from a clip cell's traced window."""

UNIT = "s"


def read(run):
    if run.get("driver") != "clip":
        return None
    return run["stages"].get("tvl1_loop")
