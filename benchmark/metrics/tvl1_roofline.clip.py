"""tvl1_roofline.clip: the least time the chip needs for the profiled
clips' TV-L1 work (per call of the per-iteration loop, the larger of its
bytes at the HBM rate and the float32 operations that the epsilon stop
let run on these inputs at the float32 peak, counted by the reference's
own solve; benchmark/counts.py) over the device time of csrc/tvl1.cu's
kernels in the trace of those clips; percent."""

from benchmark.trace import device_seconds

UNIT = "%"
KERNELS = ["outer_loop_kernel", "median5x5_kernel", "block_sweep_kernel",
           "block_end_kernel"]


def read(run):
    if run.get("driver") != "clip" or not run.get("tvl1_bound_s"):
        return None
    busy = device_seconds(run["trace"]["kernels"], KERNELS)
    if busy <= 0:
        return None
    return 100.0 * run["tvl1_bound_s"] / busy
