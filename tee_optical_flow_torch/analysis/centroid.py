"""AV-valve centroid tracking (the JAX package's analysis/centroid.py).

Parity with reference analysis.py:18-86: per frame, the centroid of the
largest connected region of the mask; empty frames carry the previous
centroid forward (image center for a leading empty run); the (N, 2) track
is optionally Savitzky-Golay smoothed (window 10, poly 4 defaults).

The per-frame labelling and centroid run batched on the device
(ops.morphology.largest_centroid_series); the carry-forward and the tiny
(N, 2) savgol run on the host in float64.
"""

from __future__ import annotations

import logging
from typing import Sequence, Tuple

import numpy as np
import torch

from ..core import as_device_tensor
from ..ops.morphology import largest_centroid_series
from ..ops.smoothing import savgol_filter_np

logger = logging.getLogger(__name__)


def find_correct_centroid(areas: Sequence[float],
                          centroids: Sequence[Tuple[float, float]]):
    """Centroid of the largest region (reference analysis.py:18-36,
    expressed over parallel area/centroid lists)."""
    return centroids[int(np.argmax(np.asarray(areas)))]


def calc_AV_centroid(mask_arr, nframes: int, filter: bool = True,
                     savgol_window: int = 10, savgol_poly: int = 4,
                     verbose: bool = False, device=None) -> np.ndarray:
    """(N, H, W, C) host mask stack -> (N, 2) centroid track (row, col),
    labelled on ``device`` (``cuda`` by default); only channel 0 of the
    first ``nframes`` frames is sent."""
    frames = as_device_tensor(
        np.ascontiguousarray(np.asarray(mask_arr)[:nframes, :, :, 0]), device)
    cents_d, _areas, valid_d = largest_centroid_series(frames.to(torch.bool))
    # one copy to the host for both
    packed = torch.cat([cents_d.to(torch.float32),
                        valid_d.to(torch.float32)[:, None]], dim=1).cpu()
    packed = packed.numpy()
    cents = packed[:, :2].astype(np.float64)
    valid = packed[:, 2] > 0

    default = (mask_arr.shape[1] / 2, mask_arr.shape[2] / 2)
    out = np.empty_like(cents)
    last = None
    for i in range(nframes):
        if valid[i]:
            last = cents[i]
            out[i] = cents[i]
        else:
            logger.warning("EMPTY MASK at Frame %d", i)
            out[i] = last if last is not None else default

    if filter:
        if nframes < savgol_window:
            logger.error("Cannot apply savgol filter! List smaller than window")
        else:
            out = savgol_filter_np(out, savgol_window, savgol_poly)
    return out
