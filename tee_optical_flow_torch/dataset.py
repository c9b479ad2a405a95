"""OpticalFlowDataset: the clip object the analysis reads (the JAX
package's dataset.py).

Semantic parity with reference optical_flow/optical_flow_dataset.py:29-228,
including its load-bearing quirks:
  * ``nframes = attrs['nframes'] - 2`` (reference :58) — the stored attr is
    the raw clip length; analysis code sees two fewer frames.
  * the flow as float32; acceleration = np.gradient(vel, 1/frame_rate,
    axis=0) and PWR = vel * accel, derived eagerly at load on the host
    (reference :100-101).
  * eager mode deep-copies everything and closes the file; lazy mode
    (``keep_file_open=True``) keeps h5py dataset references alive.

The clip comes from an HDF5 file (h5py is imported in the constructor
only) or, with ``_file_override``, from memory: the layout
``io.hdf5.optical_flow_layout`` builds, which holds what the writer would
store, so both give the same dataset. ``device_masked_arr`` returns the
masked parameter as a tensor on a device (``cuda`` unless the caller asks
for ``cpu``), for the analysis's device passes.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from .core import resolve_device
from .io.hdf5 import Layout

logger = logging.getLogger(__name__)

_PARAMS = ["velocity", "acceleration", "PWR"]


class _MemoryDataset:
    """One entry of an in-memory layout, read like an h5py dataset."""

    def __init__(self, data: np.ndarray, attrs: Dict[str, Any]):
        self._data = data
        self.attrs = attrs

    def __getitem__(self, key):
        return self._data[key]


class _MemoryFile(dict):
    """An in-memory layout (io/hdf5.optical_flow_layout), read like an open
    h5py file."""

    def __init__(self, layout: Layout):
        super().__init__({name: _MemoryDataset(data, attrs)
                          for name, (data, attrs) in layout.items()})

    def close(self) -> None:
        pass


class OpticalFlowDataset:
    def __init__(self, hdf5_filepath: str, keep_file_open: bool = False,
                 _file_override: Optional[Layout] = None):
        self.GRAPH_CALCULATED = False
        self.CARDIACCYCLE_CALCULATED = False
        self._hdf5_filepath = hdf5_filepath
        self._keep_file_open = keep_file_open
        self._hdf5_file = None
        self._closed = False

        if _file_override is not None:
            f = _MemoryFile(_file_override)
        else:
            import h5py

            f = h5py.File(hdf5_filepath, "r")
        if keep_file_open:
            self._hdf5_file = f
        try:
            self.filename = os.path.basename(hdf5_filepath)[:-4]
            ds_of = f["flow"]
            if keep_file_open:
                self.ds_echo = f["echo"]
                self.echo_array = None
            else:
                self.echo_array = f["echo"][()]
                self.ds_echo = None

            # deep copy of (N, H, W, 2) flow as float32 (reference :57)
            self.vel_array = np.asarray(ds_of[()]).astype(np.float32)
            # the -2 convention (reference :58)
            self.nframes = int(ds_of.attrs["nframes"]) - 2
            self.mode = ds_of.attrs["mode"]

            if "RWaveTime" in f:
                self.RTimePresent = True
                self.RWaveTimes = f["RWaveTime"][()]
            else:
                self.RTimePresent = False

            self.waveforms_present = bool(ds_of.attrs["waveforms_present"])
            self.units_converted_flag = bool(ds_of.attrs["units_converted"])
            if self.units_converted_flag:
                self.frame_rate = float(ds_of.attrs["frame_rate"])
                self.pixel_spacing = float(ds_of.attrs["pixel_spacing"])
                self.ID = ds_of.attrs["ID"]
            else:
                self.frame_rate = 1
                self.pixel_spacing = 1

            self.cvp_exists = False
            self.pap_exists = False
            if self.waveforms_present:
                for name in ("art", "ecg"):
                    if name in f:
                        setattr(self, name, f[name][()])
                        setattr(self, f"{name}_sampling_rate",
                                f[name].attrs["sampling_rate"])
                    else:
                        logger.warning("ERROR no %s waveform!", name.upper())
                if "cvp" in f:
                    self.cvp_exists = True
                    self.cvp = f["cvp"][()]
                    self.cvp_sampling_rate = f["cvp"].attrs["sampling_rate"]
                if "pap" in f:
                    self.pap_exists = True
                    self.pap = f["pap"][()]
                    self.pap_sampling_rate = f["pap"].attrs["sampling_rate"]

            # derived kinematics (reference :100-101)
            self.accel_array = np.gradient(self.vel_array,
                                           1 / self.frame_rate, axis=0)
            self.pwr_array = self.vel_array * self.accel_array

            self.accepted_labels = list(ds_of.attrs["labels"])
            self.accepted_params = list(_PARAMS)
            self.mask_ds_dict: Dict[str, Any] = {}
            for label in self.accepted_labels:
                ds_label = f[label]
                self.mask_ds_dict[label] = (ds_label if keep_file_open
                                            else ds_label[()])
        finally:
            if not keep_file_open:
                f.close()

    # -- lifecycle ----------------------------------------------------------

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.close()
        return False

    def close(self) -> None:
        if self._hdf5_file is not None and not self._closed:
            self._hdf5_file.close()
            self._hdf5_file = None
            self._closed = True

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # -- validation / units (reference :136-168) ----------------------------

    def _validate_label(self, label: str) -> bool:
        return label in self.accepted_labels

    def _validate_param(self, param: str) -> bool:
        return param in self.accepted_params

    def _param_unit(self, param: str) -> Optional[str]:
        converted = {"velocity": "cm/s", "acceleration": "cm/s2",
                     "PWR": "cm2/s3"}
        raw = {"velocity": "pixel/frame", "acceleration": "pixel/frame2",
               "PWR": "pixel2/frame3"}
        table = converted if self.units_converted_flag else raw
        unit = table.get(param)
        if unit is None:
            logger.error("%s is not a valid optical flow parameter, choose "
                         "from %s", param, self.accepted_params)
        return unit

    # -- accessors (reference :170-228) --------------------------------------

    def get_echo(self) -> Optional[np.ndarray]:
        if self.echo_array is not None:
            return self.echo_array
        if self.ds_echo is not None:
            return self.ds_echo[()]
        return None

    def get_mask(self, label: str) -> Optional[np.ndarray]:
        if not self._validate_label(label):
            logger.error("%s not a valid key. Choose from %s", label,
                         self.accepted_labels)
            return None
        mask_data = self.mask_ds_dict[label]
        if isinstance(mask_data, np.ndarray):
            return mask_data
        return mask_data[()]

    def _masked(self, arr: np.ndarray, label: str) -> Optional[np.ndarray]:
        mask = self.get_mask(label)
        return None if mask is None else arr * mask

    def get_velocity(self, label: str) -> Optional[np.ndarray]:
        return self._masked(self.vel_array, label)

    def get_accel(self, label: str) -> Optional[np.ndarray]:
        return self._masked(self.accel_array, label)

    def get_pwr(self, label: str) -> Optional[np.ndarray]:
        return self._masked(self.pwr_array, label)

    def _param_array(self, param: str) -> Optional[np.ndarray]:
        arr = {"velocity": self.vel_array, "acceleration": self.accel_array,
               "PWR": self.pwr_array}.get(param)
        if arr is None:
            logger.error("%s is not a valid optical flow parameter, choose "
                         "from %s", param, self.accepted_params)
        return arr

    def get_masked_arr(self, param: str, label: str) -> Optional[np.ndarray]:
        arr = self._param_array(param)
        return None if arr is None else self._masked(arr, label)

    # -- device staging ----------------------------------------------------

    def device_masked_arr(self, param: str, label: str, device=None
                          ) -> Optional[torch.Tensor]:
        """The masked parameter as a float32 tensor on ``device`` (``cuda``
        unless the caller asks for ``cpu``): the parameter and the mask
        are sent and multiplied there, which gives get_masked_arr's values
        (the mask is 0 or 1)."""
        arr = self._param_array(param)
        mask = None if arr is None else self.get_mask(label)
        if mask is None:
            return None
        dev = resolve_device(device)
        return (torch.from_numpy(np.ascontiguousarray(arr)).to(dev)
                * torch.from_numpy(np.ascontiguousarray(mask)).to(dev))
