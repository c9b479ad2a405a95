"""decode_s.sam: the program's dicom_read span per clip (the DICOM parse and its pixel data, on the host); seconds, from a SAM clip cell's traced window."""

UNIT = "s"


def read(run):
    if run.get("driver") != "sam_clip":
        return None
    return run["stages"].get("dicom_read")
