"""mfu.sam: a SAM clip's model work over the whole clip at the card's dense
bfloat16 peak: the clip's real frames times one frame's share of the
segmentor's forward (benchmark/counts_sam.py, counted from the shapes as
FlopCounterMode counts them), over the mean time of the window's clips
run outside the profiler (clip_s of a run without a trace; a traced run's
clip_s also counts the seconds the profiler takes to read its trace), or
over the profiled clip's time where no other clip ran, at 989.4 TFLOP/s;
percent."""

from benchmark.counts_sam import BF16_DENSE_FLOPS

UNIT = "%"


def read(run):
    if run.get("driver") != "sam_clip":
        return None
    clip_s = run.get("timed_clip_s") or run.get("profiled_clip_s")
    if not clip_s:
        return None
    flops = run["real_frames"] * run["flop_per_frame"]
    return 100.0 * flops / clip_s / BF16_DENSE_FLOPS
