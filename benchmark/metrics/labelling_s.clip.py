"""labelling_s.clip: the program's labelling spans per clip (each connected_components call's rounds: two a clip on the Otsu path), timed to completion; seconds, from a clip cell's traced window."""

UNIT = "s"


def read(run):
    if run.get("driver") != "clip":
        return None
    return run["stages"].get("labelling")
