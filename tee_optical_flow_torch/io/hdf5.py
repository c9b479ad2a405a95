"""HDF5 persistence with the reference schema (the JAX package's
``save_optical_flow_hdf5``, io/hdf5.py:88-166).

Schema (reference optical_flow/calculate_optical_flow.py:370-475):
  datasets  echo (float16, gzip-9), flow (float16, gzip-9),
            art/ecg/cvp/pap (float16, gzip-9, attr sampling_rate),
            RWaveTime (gzip-9), one uint8/bool dataset per mask label
  attrs on 'flow':  frame_rate, nframes (raw clip length, pre the -2
            convention applied at read time), pixel_spacing, ID, HR,
            no_saliency, mode, units_converted, waveforms_present,
            CVP_exists, PAP_exists, R_wave_data_present, labels

``h5py`` is imported inside the writer: a machine without it can still
import and run everything up to the write.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..utils import safe_makedir

logger = logging.getLogger(__name__)


def save_optical_flow_hdf5(
    save_path: str,
    flow_arr: np.ndarray,
    echo_gray: np.ndarray,
    mask_dict: Dict[str, np.ndarray],
    metadata: Dict[str, Any],
    waveforms: Dict[str, Tuple[bool, Optional[np.ndarray]]],
    *,
    mode: str,
    no_saliency: bool,
    include_waveforms: bool,
    patient_id: str = "",
    heart_rate: float = 0,
    sampling_rates: Optional[Dict[str, int]] = None,
    save_mask_subset: Optional[List[str]] = None,
    verbose: bool = False,
) -> None:
    """Write the full clip artifact with the reference's exact schema.

    ``flow_arr``  (N, H, W, 2) float; stored float16 gzip-9.
    ``echo_gray`` (N, H, W) grayscale float in [0, 1]; stored float16 gzip-9.
    ``metadata``  needs keys frame_rate, pixel_spacing, R_wave_data_present,
                  and R_times when R-wave data is present; nframes defaults
                  to the echo clip length.
    """
    import h5py

    sampling_rates = sampling_rates or {"ecg": 500, "art": 125, "cvp": 125,
                                        "pap": 125}
    if os.path.exists(save_path):
        os.remove(save_path)
    parent = os.path.dirname(save_path)
    if parent:
        safe_makedir(parent)

    with h5py.File(save_path, "w") as f:
        f.create_dataset("echo", data=np.asarray(echo_gray, np.float16),
                         compression="gzip", compression_opts=9)
        flow_dset = f.create_dataset("flow",
                                     data=np.asarray(flow_arr, np.float16),
                                     compression="gzip", compression_opts=9)

        frame_rate = metadata.get("frame_rate")
        pixel_spacing = metadata.get("pixel_spacing")
        units_converted = pixel_spacing is not None and frame_rate is not None
        flow_dset.attrs["frame_rate"] = (frame_rate if frame_rate is not None
                                         else 0.0)
        flow_dset.attrs["nframes"] = int(metadata.get("nframes",
                                                      echo_gray.shape[0]))
        flow_dset.attrs["pixel_spacing"] = (pixel_spacing
                                            if pixel_spacing is not None
                                            else 0.0)
        flow_dset.attrs["ID"] = patient_id
        flow_dset.attrs["HR"] = heart_rate
        flow_dset.attrs["no_saliency"] = bool(no_saliency)
        flow_dset.attrs["mode"] = mode
        flow_dset.attrs["units_converted"] = bool(units_converted)
        flow_dset.attrs["waveforms_present"] = bool(include_waveforms)

        if include_waveforms:
            flow_dset.attrs["CVP_exists"] = bool(
                waveforms.get("cvp", (False, None))[0])
            flow_dset.attrs["PAP_exists"] = bool(
                waveforms.get("pap", (False, None))[0])
            flow_dset.attrs["R_wave_data_present"] = bool(
                metadata.get("R_wave_data_present", False))
            for name in ("art", "ecg", "cvp", "pap"):
                exists, data = waveforms.get(name, (False, None))
                if exists and data is not None:
                    wf = f.create_dataset(name,
                                          data=np.asarray(data, np.float16),
                                          compression="gzip",
                                          compression_opts=9)
                    wf.attrs["sampling_rate"] = sampling_rates.get(name, 125)

        if metadata.get("R_wave_data_present", False):
            f.create_dataset("RWaveTime", data=np.asarray(metadata["R_times"]),
                             compression="gzip", compression_opts=9)

        saved_keys: List[str] = []
        for k, v in mask_dict.items():
            if save_mask_subset is not None and k not in save_mask_subset:
                continue
            f.create_dataset(k, data=v, compression="gzip",
                             compression_opts=9)
            saved_keys.append(k)
        flow_dset.attrs["labels"] = saved_keys

    if verbose:
        logger.info("Saved optical flow array of shape %s to %s",
                    tuple(flow_arr.shape), save_path)
