"""optical_flow_s.sam: the program's optical_flow span per clip (it ends in the flow's copy to the host, so it holds flow_input_prep's device work too); seconds, from a SAM clip cell's traced window."""

UNIT = "s"


def read(run):
    if run.get("driver") != "sam_clip":
        return None
    return run["stages"].get("optical_flow")
