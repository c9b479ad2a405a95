"""decode_s.clip: the program's dicom_read span per clip (the DICOM parse and its pixel data, on the host); seconds, from a clip cell's traced window."""

UNIT = "s"


def read(run):
    if run.get("driver") != "clip":
        return None
    return run["stages"].get("dicom_read")
