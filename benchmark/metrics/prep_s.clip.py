"""prep_s.clip: the program's clip_prep span per clip (from the end of the DICOM read to the masks: frame bucketing, the grayscale test, the contiguous copy, the upload and the luma), timed to completion; seconds, from a clip cell's traced window."""

UNIT = "s"


def read(run):
    if run.get("driver") != "clip":
        return None
    return run["stages"].get("clip_prep")
