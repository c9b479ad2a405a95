"""idle_share.sam: the share of the profiled span of a SAM clip cell's
traced window in which no operation ran on the device; percent."""

from benchmark.counts import idle_share

UNIT = "%"


def read(run):
    if run.get("driver") != "sam_clip" or not run.get("trace"):
        return None
    return idle_share(run["trace"]["busy_s"], run["trace"]["window_s"])
