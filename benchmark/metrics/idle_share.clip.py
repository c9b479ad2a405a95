"""idle_share.clip: the share of the profiled span of a clip cell's traced
window in which no operation ran on the device; percent."""

from benchmark.counts import idle_share

UNIT = "%"


def read(run):
    if run.get("driver") != "clip" or not run.get("trace"):
        return None
    return idle_share(run["trace"]["busy_s"], run["trace"]["window_s"])
