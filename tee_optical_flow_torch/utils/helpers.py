"""Shared small helpers (copies of the JAX package's utils/helpers.py)."""

from __future__ import annotations

import math
import os
from typing import List, Optional, Sequence

import numpy as np


def safe_makedir(path: str) -> None:
    """mkdir -p (reference optical_flow_utils.py:26-28)."""
    os.makedirs(path, exist_ok=True)


def pad_to_multiple(n: int, m: int) -> int:
    """Next multiple of ``m`` at or above ``n`` (``n`` itself for m <= 1)."""
    return int(math.ceil(n / m) * m) if m > 1 else int(n)


def index_smallest_positive(values: Sequence[float]) -> Optional[int]:
    """Index of the smallest strictly-positive element, or None
    (reference optical_flow_utils.py:33-38)."""
    values = list(values)
    positive = [v for v in values if v > 0]
    if not positive:
        return None
    return values.index(min(positive))


def find_start_stop(arr: np.ndarray) -> List[List[int]]:
    """Collapse a sorted index array into [start, stop] runs of consecutive
    integers (reference optical_flow_utils.py:40-49)."""
    arr = np.asarray(arr)
    if arr.size == 0:
        return []
    if arr.size == 1:
        return [[int(arr[0]), int(arr[0])]]
    breaks = np.where(np.diff(arr) != 1)[0] + 1
    clusters = []
    start_idx = 0
    for end_idx in breaks:
        clusters.append([int(arr[start_idx]), int(arr[end_idx - 1])])
        start_idx = int(end_idx)
    clusters.append([int(arr[start_idx]), int(arr[-1])])
    return clusters


def timeinterval2index(intervals, frame_times) -> List[List[int]]:
    """Map [start, stop] time intervals onto frame indices
    (reference optical_flow_utils.py:60-66)."""
    frame_times = np.asarray(frame_times)
    frame_i = []
    for start, stop in intervals:
        hits = np.nonzero((frame_times >= start) & (frame_times <= stop))[0]
        if hits.size == 0:
            continue
        frame_i.append([int(hits[0]), int(hits[-1])])
    return frame_i


def frame2time(intervals, sampling_rate: float) -> List[List[float]]:
    """Convert index intervals to seconds (reference
    optical_flow_utils.py:68-71)."""
    return [[float(i) / float(sampling_rate) for i in interval]
            for interval in intervals]


def fix_ecg(ecg_arr: np.ndarray, sampling_rate: float,
            smooth_fraction: float = 0.2, pad_len: int = 20) -> np.ndarray:
    """Clean + spectrally smooth an ECG trace (reference
    optical_flow_utils.py:51-58: neurokit2's 'vg' cleaning and tsmoothie's
    SpectralSmoother, both reimplemented in signal/)."""
    from ..signal.ecg import ecg_clean
    from ..signal.smoother import spectral_smooth

    cleaned = ecg_clean(np.asarray(ecg_arr, dtype=np.float64), sampling_rate)
    return spectral_smooth(cleaned, smooth_fraction=smooth_fraction,
                           pad_len=pad_len)
