"""segmentation_s.sam: the program's segmentation span per clip (the segmentor on every frame, the cleaned masks with their labellings, and the masks' copy to the host, where it ends); seconds, from a SAM clip cell's traced window."""

UNIT = "s"


def read(run):
    if run.get("driver") != "sam_clip":
        return None
    return run["stages"].get("segmentation")
