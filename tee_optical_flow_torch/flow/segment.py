"""Otsu masks for the no-SAM path (the JAX package's flow/segment.py,
``predict_movie_thres`` only; the segmentor path comes with the SAM
slice)."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..config import OpticalFlowCalculationConfig, default_optical_flow_config
from ..core import resolve_device
from ..ops.imaging import rgb2gray
from ..ops.morphology import (
    clean_binary_stack, moving_avg_mask, pack_mask_bits, unpack_mask_bits,
)
from ..ops.otsu import otsu_mask_stack


def predict_movie_thres(nparr: np.ndarray, verbose: bool = False,
                        config: Optional[OpticalFlowCalculationConfig] = None,
                        _gray_dev: Optional[torch.Tensor] = None,
                        device=None) -> Dict[str, np.ndarray]:
    """Otsu-threshold masks for the no-SAM path (reference
    calculate_optical_flow.py:184-213): per-frame Otsu, then fill-holes +
    remove-small-objects, then the temporal moving average. Returns
    {"otsu": (N, H, W, 2) bool}.

    ``_gray_dev`` lets the pipeline pass its device-resident grayscale
    clip, so this path moves no second copy of the clip; otherwise the
    clip goes to ``device`` (``cuda`` by default)."""
    if config is None:
        config = default_optical_flow_config()
    if _gray_dev is not None:
        gray = _gray_dev
    else:
        clip = torch.from_numpy(np.ascontiguousarray(nparr))
        gray = rgb2gray(clip.to(resolve_device(device)))
    raw = otsu_mask_stack(gray)
    clean = clean_binary_stack(raw, min_size=config.min_mask_size)
    avg_dev = moving_avg_mask(clean, n=config.moving_avg_window,
                              threshold=config.moving_avg_threshold)
    avg = unpack_mask_bits(pack_mask_bits(avg_dev), tuple(avg_dev.shape))
    return {"otsu": np.repeat(avg[:, :, :, None], 2, axis=3)}
