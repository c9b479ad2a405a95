"""Clip masks (the JAX package's flow/segment.py): the segmentor path
(``clean_mask``, ``predict_movie``) and the Otsu path
(``predict_movie_thres``), batched over the clip on its device.

  * ``clean_mask``: per label of the mode's map (A4C 8 classes,
    RVIO_2class, MouseRV_A4C), the temporal moving average (window 4,
    threshold 0.49), then fill-holes + remove-small-objects per frame;
    background = NOT(union); each mask broadcast to (N, H, W, 2) so that
    it multiplies the flow directly;
  * ``predict_movie_thres``: per-frame Otsu, then fill/remove, then the
    moving average (the reverse order of clean_mask, as in the reference,
    whose two paths differ so);
  * ``predict_movie``: runs a segmentor over the clip and cleans the
    labels. The pipeline runs its two halves (``segment_labels``, then
    ``clean_mask_device``) itself, to keep the device masks for WASE.
"""

from __future__ import annotations

import functools
import logging
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..config import OpticalFlowCalculationConfig, default_optical_flow_config
from ..core import as_device_tensor, resolve_device
from ..ops.imaging import rgb2gray
from ..ops.morphology import (
    clean_binary_stack, moving_avg_mask, pack_mask_bits, unpack_mask_bits,
)
from ..ops.otsu import otsu_mask_stack

logger = logging.getLogger(__name__)

# label values per mode (reference calculate_optical_flow.py:132-152)
LABEL_MAPS = {
    "A4C": {
        "lv_inner": 1, "lv": 2, "la_inner": 3, "la": 4,
        "rv_inner": 5, "ra_inner": 6, "rv": 7, "ra": 8,
    },
    "RVIO_2class": {"rv": 1, "av": 2},
    "MouseRV_A4C": {"rv": 1, "rv_inner": 2},
}


def clean_mask_device(arr, mode: str = "A4C",
                      config: Optional[OpticalFlowCalculationConfig] = None,
                      device=None) -> Optional[Dict[str, torch.Tensor]]:
    """(N, H, W) integer label movie -> {label: (N, H, W) bool tensor} +
    'bkgd', on the device, or None for an unknown mode.

    ``arr`` is a tensor (cleaned on its device) or a host array (sent to
    ``device``, ``cuda`` by default). Per label: the temporal moving
    average, then fill-holes + remove-small-objects per frame; 'bkgd' is
    NOT(union)."""
    if config is None:
        config = default_optical_flow_config()
    label_map = LABEL_MAPS.get(mode)
    if label_map is None:
        logger.error("mode=%s not supported, must be %s!", mode,
                     list(LABEL_MAPS.keys()))
        return None
    labels = as_device_tensor(arr, device)
    masks: Dict[str, torch.Tensor] = {}
    for name, value in label_map.items():
        avg = moving_avg_mask(labels == value, n=config.moving_avg_window,
                              threshold=config.moving_avg_threshold)
        masks[name] = clean_binary_stack(avg, min_size=config.min_mask_size)
    masks["bkgd"] = ~functools.reduce(torch.logical_or, masks.values())
    return masks


def masks_to_host(masks: Dict[str, torch.Tensor], verbose: bool = False
                  ) -> Dict[str, np.ndarray]:
    """clean_mask_device's masks -> {label: (N, H, W, 2) bool} on the host:
    each mask crosses bit-packed and is broadcast to two channels, so that
    it multiplies the flow directly."""
    mask_dict: Dict[str, np.ndarray] = {}
    for name, mask in masks.items():
        host = unpack_mask_bits(pack_mask_bits(mask), tuple(mask.shape))
        mask_dict[name] = np.repeat(host[:, :, :, None], 2, axis=3)
        if verbose and name != "bkgd":
            logger.debug("For mask %s, produced cleaned mask arr of shape %s",
                         name, mask_dict[name].shape)
    return mask_dict


def clean_mask(arr, mode: str = "A4C", verbose: bool = False,
               config: Optional[OpticalFlowCalculationConfig] = None,
               device=None) -> Optional[Dict[str, np.ndarray]]:
    """(N, H, W) integer label movie -> {label: (N, H, W, 2) bool} +
    'bkgd', or None for an unknown mode: clean_mask_device, then
    masks_to_host. Every label is cleaned before any mask leaves the
    device."""
    masks = clean_mask_device(arr, mode, config=config, device=device)
    return None if masks is None else masks_to_host(masks, verbose)


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


def segment_labels(nparr: np.ndarray, segmentor: Callable[[np.ndarray],
                                                          np.ndarray],
                   _clip_dev: Optional[torch.Tensor] = None, device=None):
    """The segmentor's (N, H, W) labels of a clip, and the device to clean
    them on.

    When the segmentor has ``labels_device`` (make_clip_segmentor's does)
    and the pipeline hands over its device clip as ``_clip_dev``, the
    labels are made on the device and never cross to the host. Otherwise
    the segmentor is called on the host frames, so any such callable
    works, and its labels are cleaned on ``_clip_dev``'s device, or
    ``device``."""
    device_fn = getattr(segmentor, "labels_device", None)
    if device_fn is not None and _clip_dev is not None:
        h, w = np.asarray(nparr).shape[1:3]
        return device_fn(_clip_dev, (h, w)), device
    labels = np.asarray(segmentor(np.asarray(nparr)))
    if _clip_dev is not None:
        device = _clip_dev.device
    return labels, device


def predict_movie(nparr: np.ndarray, segmentor: Callable[[np.ndarray],
                                                          np.ndarray],
                  mode: str = "A4C", verbose: bool = False,
                  config: Optional[OpticalFlowCalculationConfig] = None,
                  _clip_dev: Optional[torch.Tensor] = None, device=None
                  ) -> Optional[Dict[str, np.ndarray]]:
    """Run a clip segmentor ((N, H, W, 3) uint8 -> (N, H, W) labels) and
    clean its labels (reference calculate_optical_flow.py:215-241); the
    routes of segment_labels."""
    labels, device = segment_labels(nparr, segmentor, _clip_dev, device)
    return clean_mask(labels, mode, verbose, config=config, device=device)
