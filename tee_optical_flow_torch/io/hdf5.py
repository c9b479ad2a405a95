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

``optical_flow_layout`` builds, in memory, the datasets and attributes
the writer stores, with their stored dtypes; ``save_optical_flow_hdf5``
writes that layout. ``dataset.OpticalFlowDataset(_file_override=...)``
reads the same layout from memory. ``HDF5Reader`` and ``HDF5Writer`` are
the generic context managers of reference file_io.py:18-116. ``h5py`` is
imported inside the writer and the context managers: a machine without it
can still import and run everything up to the write.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..utils import safe_makedir

# dataset name -> (stored array, its attributes), in the writer's order
Layout = Dict[str, Tuple[np.ndarray, Dict[str, Any]]]

logger = logging.getLogger(__name__)


class HDF5Reader:
    """Context-managed HDF5 reader (reference file_io.py:18-74)."""

    def __init__(self, filepath: str, mode: str = "r"):
        self.filepath = filepath
        self.mode = mode
        self._file = None

    def __enter__(self):
        import h5py

        self._file = h5py.File(self.filepath, self.mode)
        return self._file

    def __exit__(self, exc_type, exc_val, exc_tb):
        if self._file is not None:
            self._file.close()
            self._file = None
        return False

    def read_dataset(self, key: str) -> Any:
        with self as f:
            if key not in f:
                raise KeyError(f"Dataset '{key}' not found in HDF5 file")
            return f[key][()]

    def read_attributes(self, key: str) -> dict:
        with self as f:
            if key not in f:
                raise KeyError(f"Dataset '{key}' not found in HDF5 file")
            return dict(f[key].attrs)


class HDF5Writer:
    """Context-managed HDF5 writer (reference file_io.py:77-116)."""

    def __init__(self, filepath: str, mode: str = "w"):
        self.filepath = filepath
        self.mode = mode
        self._file = None

    def __enter__(self):
        import h5py

        parent = os.path.dirname(self.filepath)
        if parent:
            safe_makedir(parent)
        self._file = h5py.File(self.filepath, self.mode)
        return self._file

    def __exit__(self, exc_type, exc_val, exc_tb):
        if self._file is not None:
            self._file.close()
            self._file = None
        return False

    def write_dataset(self, key: str, data: Any, **attrs):
        with self as f:
            dset = f.create_dataset(key, data=data)
            for k, v in attrs.items():
                dset.attrs[k] = v


def optical_flow_layout(
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
) -> Layout:
    """The clip artifact with the reference's exact schema, in memory.

    ``flow_arr``  (N, H, W, 2) float; stored float16.
    ``echo_gray`` (N, H, W) grayscale float in [0, 1]; stored float16.
    ``metadata``  needs keys frame_rate, pixel_spacing, R_wave_data_present,
                  and R_times when R-wave data is present; nframes defaults
                  to the echo clip length.
    """
    sampling_rates = sampling_rates or {"ecg": 500, "art": 125, "cvp": 125,
                                        "pap": 125}
    layout: Layout = {"echo": (np.asarray(echo_gray, np.float16), {})}

    frame_rate = metadata.get("frame_rate")
    pixel_spacing = metadata.get("pixel_spacing")
    units_converted = pixel_spacing is not None and frame_rate is not None
    flow_attrs: Dict[str, Any] = {
        "frame_rate": frame_rate if frame_rate is not None else 0.0,
        "nframes": int(metadata.get("nframes", echo_gray.shape[0])),
        "pixel_spacing": (pixel_spacing if pixel_spacing is not None
                          else 0.0),
        "ID": patient_id,
        "HR": heart_rate,
        "no_saliency": bool(no_saliency),
        "mode": mode,
        "units_converted": bool(units_converted),
        "waveforms_present": bool(include_waveforms),
    }
    layout["flow"] = (np.asarray(flow_arr, np.float16), flow_attrs)

    if include_waveforms:
        flow_attrs["CVP_exists"] = bool(waveforms.get("cvp", (False, None))[0])
        flow_attrs["PAP_exists"] = bool(waveforms.get("pap", (False, None))[0])
        flow_attrs["R_wave_data_present"] = bool(
            metadata.get("R_wave_data_present", False))
        for name in ("art", "ecg", "cvp", "pap"):
            exists, data = waveforms.get(name, (False, None))
            if exists and data is not None:
                layout[name] = (np.asarray(data, np.float16),
                                {"sampling_rate": sampling_rates.get(name,
                                                                     125)})

    if metadata.get("R_wave_data_present", False):
        layout["RWaveTime"] = (np.asarray(metadata["R_times"]), {})

    saved_keys: List[str] = []
    for k, v in mask_dict.items():
        if save_mask_subset is not None and k not in save_mask_subset:
            continue
        layout[k] = (v, {})
        saved_keys.append(k)
    flow_attrs["labels"] = saved_keys
    return layout


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
    """Write the full clip artifact (``optical_flow_layout``'s datasets and
    attributes), every dataset gzip-9."""
    import h5py

    layout = optical_flow_layout(
        flow_arr, echo_gray, mask_dict, metadata, waveforms, mode=mode,
        no_saliency=no_saliency, include_waveforms=include_waveforms,
        patient_id=patient_id, heart_rate=heart_rate,
        sampling_rates=sampling_rates, save_mask_subset=save_mask_subset)
    if os.path.exists(save_path):
        os.remove(save_path)
    parent = os.path.dirname(save_path)
    if parent:
        safe_makedir(parent)

    with h5py.File(save_path, "w") as f:
        for name, (data, attrs) in layout.items():
            dset = f.create_dataset(name, data=data, compression="gzip",
                                    compression_opts=9)
            for key, value in attrs.items():
                dset.attrs[key] = value

    if verbose:
        logger.info("Saved optical flow array of shape %s to %s",
                    tuple(flow_arr.shape), save_path)
