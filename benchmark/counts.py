"""The yardstick's arithmetic: the card's published peaks, the least time
the TV-L1 work of a clip needs, and the idle formula.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit):
3.35 TB/s of HBM, 67 TFLOP/s in float32 outside the tensor cores.
"""

from __future__ import annotations

from typing import Iterable, Tuple

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

# float32 operations per pixel, counted from the algorithm: a primal-dual
# step is 28 in the primal and 28 in the dual, and 5 more for the epsilon
# error; a 5x5 median is 9 + 66 compare-exchanges of 2 operations per plane
OPS_STEP, OPS_ERR, OPS_MEDIAN_PLANE = 56, 5, 150
# planes one warp's loop reads once (the residual, the warped gradients,
# their squared norm, u, v and the four dual fields) and writes once (u, v
# and the dual fields)
LOOP_PLANES_IN, LOOP_PLANES_OUT = 10, 6


def loop_bound_s(b: int, h: int, w: int, steps: int, medians: int,
                 checks: int) -> Tuple[float, str]:
    """Least seconds of one warp's loop on these inputs (its pair-steps,
    pair-medians and stop checks): the larger of its bytes at the HBM
    rate and its float32 operations at the float32 peak, and which of the
    two bounds it."""
    ops = (steps * OPS_STEP + checks * OPS_ERR
           + medians * 2 * OPS_MEDIAN_PLANE) * h * w
    nbytes = (LOOP_PLANES_IN + LOOP_PLANES_OUT) * 4 * b * h * w
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def tvl1_bound_s(calls: Iterable[Tuple[int, int, int, int, int, int]]
                 ) -> float:
    """Summed least time of a clip's loops, each given as (pairs, h, w,
    pair-steps, pair-medians, stop checks)."""
    return sum(loop_bound_s(*c)[0] for c in calls)


def idle_share(busy_s: float, window_s: float) -> float:
    return 100.0 * (1.0 - busy_s / window_s)
