"""global_attn_roofline.sam: the least time of a clip's global attention
work (per global_attn span, the larger of its operations at the dense
bfloat16 peak and its q, k, v, weighted sum and tables at the HBM rate;
benchmark/counts_sam.py) over the time of the program's global_attn spans
per clip; percent."""

UNIT = "%"


def read(run):
    if run.get("driver") != "sam_clip" or not run.get("global_attn_least_s"):
        return None
    spent = run["stages"].get("global_attn")
    if not spent:
        return None
    return 100.0 * run["global_attn_least_s"] / spent
