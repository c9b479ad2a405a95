"""prep_s.sam: the program's clip_prep span per clip (from the end of the DICOM read to the masks: frame bucketing, the grayscale test, the contiguous copy, the upload and the luma), timed to completion; seconds, from a SAM clip cell's traced window."""

UNIT = "s"


def read(run):
    if run.get("driver") != "sam_clip":
        return None
    return run["stages"].get("clip_prep")
