"""segmentation_s.clip: the program's segmentation span per clip (it ends in the masks' copy to the host); seconds, from a clip cell's traced window."""

UNIT = "s"


def read(run):
    if run.get("driver") != "clip":
        return None
    return run["stages"].get("segmentation")
