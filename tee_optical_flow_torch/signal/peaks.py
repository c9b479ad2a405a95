"""1-D peak indexing and polynomial baseline estimation (the port's copy
of the JAX package's signal/peaks.py, the same NumPy code line for line).

``peak_indexes`` reproduces the semantics of peakutils.indexes as used by
the reference detectors (cardiac_cycle_detection.py:180-222, 376-391,
440-465; peak_detection.py:41-48 etc.):

  * the threshold is *normalized*: a peak must exceed
    ``thres * (max - min) + min`` of the whole input;
  * peaks are strict local maxima of the first difference, with plateaus
    resolved by propagating the nearest non-zero slopes inward;
  * when ``min_dist > 1``, peaks are greedily kept tallest-first and any
    remaining peak within ``min_dist`` samples of a kept one is dropped.

``poly_baseline`` reproduces peakutils.baseline (iteratively reweighted
polynomial fit clipped from above), used by the area detector
(cardiac_cycle_detection.py:180-181).

These run host-side on tiny 1-D signals where device dispatch latency
would dominate any compute win.
"""

from __future__ import annotations

import numpy as np


def peak_indexes(y: np.ndarray, thres: float = 0.3, min_dist: int = 1,
                 thres_abs: bool = False) -> np.ndarray:
    y = np.asarray(y, dtype=np.float64)
    if y.size < 3:
        return np.array([], dtype=np.int64)
    if not thres_abs:
        thres = thres * (np.max(y) - np.min(y)) + np.min(y)
    min_dist = int(min_dist)

    dy = np.diff(y)

    # resolve plateaus: fill zero-slope runs with the bordering slopes so a
    # flat-topped peak registers once at its midpoint
    zeros = np.where(dy == 0)[0]
    if zeros.size == dy.size:
        return np.array([], dtype=np.int64)  # completely flat signal
    if zeros.size:
        run_breaks = np.where(np.diff(zeros) != 1)[0] + 1
        runs = np.split(zeros, run_breaks)
        if runs and runs[0].size and runs[0][0] == 0:
            dy[runs[0]] = dy[runs[0][-1] + 1]
            runs = runs[1:]
        if runs and runs[-1].size and runs[-1][-1] == dy.size - 1:
            dy[runs[-1]] = dy[runs[-1][0] - 1]
            runs = runs[:-1]
        for run in runs:
            mid = np.median(run)
            dy[run[run < mid]] = dy[run[0] - 1]
            dy[run[run >= mid]] = dy[run[-1] + 1]

    rising = np.hstack([0.0, dy]) > 0.0
    falling = np.hstack([dy, 0.0]) < 0.0
    peaks = np.where(rising & falling & (y > thres))[0]

    if peaks.size > 1 and min_dist > 1:
        tallest_first = peaks[np.argsort(y[peaks])][::-1]
        suppressed = np.ones(y.size, dtype=bool)
        suppressed[peaks] = False
        for p in tallest_first:
            if not suppressed[p]:
                lo = max(0, p - min_dist)
                suppressed[lo:p + min_dist + 1] = True
                suppressed[p] = False
        peaks = np.arange(y.size)[~suppressed]

    return peaks.astype(np.int64)


def poly_baseline(y: np.ndarray, deg: int = 3, max_it: int = 100,
                  tol: float = 1e-3) -> np.ndarray:
    """Iterative polynomial baseline: repeatedly fit a degree-``deg``
    polynomial and clip the data from above until the coefficients
    stabilize, yielding the slowly-varying floor beneath the peaks."""
    y = np.asarray(y, dtype=np.float64).copy()
    order = deg + 1
    # condition the Vandermonde basis like peakutils does
    span = np.abs(y).max()
    cond = span ** (1.0 / order) if span > 0 else 1.0
    x = np.linspace(0.0, cond, y.size)
    vander = np.vander(x, order)
    vander_pinv = np.linalg.pinv(vander)

    coeffs = np.ones(order)
    base = y.copy()
    for _ in range(max_it):
        coeffs_new = vander_pinv @ y
        denom = np.linalg.norm(coeffs)
        if denom > 0 and np.linalg.norm(coeffs_new - coeffs) / denom < tol:
            coeffs = coeffs_new
            break
        coeffs = coeffs_new
        base = vander @ coeffs
        y = np.minimum(y, base)
    return vander @ coeffs
