"""sam_encoder_s.sam: the program's sam_encoder spans per clip (the ViT-Det image encoder on each micro-batch of frames, frame-bucket padding included), timed to completion; seconds, from a SAM clip cell's traced window."""

UNIT = "s"


def read(run):
    if run.get("driver") != "sam_clip":
        return None
    return run["stages"].get("sam_encoder")
