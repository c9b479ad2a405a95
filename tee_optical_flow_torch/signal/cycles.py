"""Cardiac-cycle (systole/diastole) detection — six strategies + factory
(the JAX package's signal/cycles.py).

Behavioral parity with reference optical_flow/cardiac_cycle_detection.py:
same class names, ``detect`` signatures, (sys_frames, dia_frames) interval
contract, dataset mutation guarded by ``CARDIACCYCLE_CALCULATED``, and the
``create_detector`` registry {angle, area, ecg, ecg_lazy, metadata,
arterial}.

The per-frame image reductions (the angle-mode series over the masked
flow, reference :104-114; the label-1 area series, :161-172) run batched
on the device (``device``: ``cuda`` unless the caller asks for ``cpu``);
the interval assembly (ragged lists, a dozen scalars per beat) runs on the
host.
"""

from __future__ import annotations

import logging
import os
from abc import ABC, abstractmethod
from typing import List, Optional, Tuple

import math

import numpy as np
import torch

from ..config import CardiacCycleConfig, ProcessingConfig, VisualizationConfig
from ..core import as_device_tensor
from ..ops.histogram import INV_100
from ..ops.morphology import first_area_series
from ..utils import (
    find_start_stop, frame2time, index_smallest_positive, safe_makedir,
    timeinterval2index,
)
from .ecg import detect_r_peaks, ecg_clean
from .peaks import peak_indexes, poly_baseline
from .smoother import spectral_smooth

logger = logging.getLogger(__name__)

Intervals = List[List[int]]


# ---------------------------------------------------------------------------
# device kernels
# ---------------------------------------------------------------------------

def angle_mode_series(masked_flow: torch.Tensor) -> torch.Tensor:
    """Per-frame mode of the flow angles rounded to 2 decimals, nonzero
    entries only (reference :104-114) — as a 630-bucket histogram argmax
    batched over the clip, on the flow's device. Returns (N,) float32 mode
    angles. torch's atan2 may differ from XLA's by an ulp, which can move
    an angle across a bucket edge."""
    x = masked_flow[..., 0].to(torch.float32)
    y = masked_flow[..., 1].to(torch.float32)
    ang = torch.atan2(y, x)
    ang = torch.where(ang < 0, ang + 2 * math.pi, ang)
    rounded = torch.round(ang * 100.0)            # centi-radian buckets
    n = masked_flow.shape[0]
    flat = rounded.reshape(n, -1)
    nbuckets = 630                               # ceil(2*pi*100) + 1
    bucket = torch.clamp(flat.to(torch.int32), 0, nbuckets - 1)
    weights = (flat != 0).to(torch.float32)
    hist = torch.zeros((n, nbuckets), dtype=torch.float32,
                       device=flat.device)
    hist.scatter_add_(1, bucket.to(torch.int64), weights)
    # scipy.stats.mode tie-break: smallest value wins == argmax's first-hit
    mode_bucket = torch.argmax(hist, dim=1)
    # XLA's bucket / 100.0 is a product with the float32 reciprocal
    return mode_bucket.to(torch.float32) * torch.tensor(
        INV_100, device=hist.device)


# ---------------------------------------------------------------------------
# base class
# ---------------------------------------------------------------------------

class CardiacCycleDetector(ABC):
    """Strategy base (reference :24-84)."""

    def __init__(self, cc_config: Optional[CardiacCycleConfig] = None,
                 vis_config: Optional[VisualizationConfig] = None,
                 proc_config: Optional[ProcessingConfig] = None,
                 device=None):
        self.cc_config = cc_config or CardiacCycleConfig()
        self.vis_config = vis_config or VisualizationConfig()
        self.proc_config = proc_config or ProcessingConfig()
        self.device = device

    @abstractmethod
    def detect(self, ds, **kwargs) -> Tuple[Intervals, Intervals]:
        ...

    def _should_recalculate(self, ds) -> bool:
        return self.proc_config.recalculate or not ds.CARDIACCYCLE_CALCULATED

    def _update_dataset(self, ds, sys_frames: Intervals, dia_frames: Intervals):
        ds.sys_frames = sys_frames
        ds.dia_frames = dia_frames
        ds.CARDIACCYCLE_CALCULATED = True

    def _plot_cardiac_cycle(self, ds, signal_data, signal_times, sys_intervals,
                            dia_intervals, xlabel: str, ylabel: str,
                            title: str, filename_suffix: str):
        if not (self.vis_config.save_cc_plot or self.vis_config.show_plot):
            return
        import matplotlib
        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(nrows=1, ncols=1)
        ax.plot(signal_times, signal_data)
        ax.set_xlabel(xlabel)
        ax.set_ylabel(ylabel)
        ax.set_title(title)
        times = np.asarray(signal_times)
        for start, stop in sys_intervals:
            ax.axvspan(times[int(start)] if isinstance(start, (int, np.integer)) else start,
                       times[int(stop)] if isinstance(stop, (int, np.integer)) else stop,
                       facecolor="0.8", alpha=0.5)
        for start, stop in dia_intervals:
            ax.axvspan(times[int(start)] if isinstance(start, (int, np.integer)) else start,
                       times[int(stop)] if isinstance(stop, (int, np.integer)) else stop,
                       facecolor="0.9", alpha=0.25)
        if self.vis_config.save_dir is not None and self.vis_config.save_cc_plot:
            safe_makedir(self.vis_config.save_dir)
            fig.savefig(os.path.join(self.vis_config.save_dir,
                                     ds.filename + filename_suffix))
        elif self.vis_config.save_cc_plot:
            logger.error("save_dir cannot be None if save_cc_plot flag is True!")
        if not self.vis_config.show_plot:
            plt.close(fig)


# ---------------------------------------------------------------------------
# detectors
# ---------------------------------------------------------------------------

class AngleDetector(CardiacCycleDetector):
    """Split on the smoothed per-frame dominant flow direction crossing pi
    (reference :87-143)."""

    def detect(self, ds, param: str, label: str) -> Tuple[Intervals, Intervals]:
        if not self._should_recalculate(ds):
            return ds.sys_frames, ds.dia_frames

        arr = ds.get_masked_arr(param, label)
        modes = angle_mode_series(as_device_tensor(
            np.ascontiguousarray(arr[:ds.nframes]), self.device)).cpu().numpy()
        filt = spectral_smooth(modes, self.cc_config.smooth_fraction,
                               self.cc_config.pad_len)
        up = np.nonzero(filt < np.pi)[0]
        down = np.nonzero(filt >= np.pi)[0]
        sys_frames = find_start_stop(up)
        dia_frames = find_start_stop(down)

        self._plot_cardiac_cycle(
            ds, modes, list(range(ds.nframes)), sys_frames, dia_frames,
            "Frame", "Angle Mode", "Angle-based Cardiac Cycle Detection",
            f"_{label}_{param}_sysdia_angle_diagnostic_plot.png")
        self._update_dataset(ds, sys_frames, dia_frames)
        return sys_frames, dia_frames


class AreaDetector(CardiacCycleDetector):
    """Peaks/valleys of the (baseline-subtracted, smoothed) mask-area series
    (reference :146-240), including the double-systole pruning pass."""

    def detect(self, ds, label: str) -> Tuple[Intervals, Intervals]:
        if not self._should_recalculate(ds):
            return ds.sys_frames, ds.dia_frames

        mask_arr = np.asarray(ds.get_mask(label))
        frames = mask_arr[:ds.nframes, :, :, 0]
        areas_dev, valid = first_area_series(as_device_tensor(
            np.ascontiguousarray(frames.astype(bool)), self.device))
        areas = areas_dev.cpu().numpy().astype(np.float64)
        valid = valid.cpu().numpy()
        # reference empty-mask policy (:165-172): carry previous, else 0
        last = 0.0
        for i in range(len(areas)):
            if valid[i]:
                last = areas[i]
            else:
                logger.warning("Error no mask detected!")
                areas[i] = last

        filt = spectral_smooth(areas, self.cc_config.smooth_fraction,
                               self.cc_config.pad_len)
        filt = np.asarray(filt) - poly_baseline(filt)

        peak_i = sorted(peak_indexes(filt, thres=self.cc_config.dia_thres,
                                     min_dist=5).tolist())
        val_i = sorted(peak_indexes(-filt, thres=self.cc_config.sys_thres,
                                    min_dist=5).tolist())

        # prune double systolic valleys with no diastolic peak between
        del_list = []
        for i in range(len(val_i) - 1):
            v1, v2 = val_i[i], val_i[i + 1]
            if not any(v1 < p < v2 for p in peak_i):
                hit = np.argwhere(filt == max(filt[v1], filt[v2]))
                if len(hit) > 0 and hit[0][0] in val_i:
                    del_list.append(val_i.index(hit[0][0]))
        for i in sorted(set(del_list), reverse=True):
            if i < len(val_i):
                del val_i[i]

        # pair each end-systole valley with the nearest preceding peak
        val_desc = sorted(val_i, reverse=True)
        peak_desc = sorted(peak_i, reverse=True)
        sys_frames: Intervals = []
        dia_frames: Intervals = []
        for i, end_sys in enumerate(val_desc):
            dist = [(end_sys - p) for p in peak_desc]
            j = index_smallest_positive(dist)
            if j is None:
                break
            end_dia = peak_desc[j]
            sys_frames.append((end_dia, end_sys))
            if (i + 1) < len(val_desc):
                dia_frames.append((val_desc[i + 1], end_dia))

        self._plot_cardiac_cycle(
            ds, areas, list(range(ds.nframes)), sys_frames, dia_frames,
            "Frame", "Area", "Area-based Cardiac Cycle Detection",
            f"_{label}_area_plot.png")
        self._update_dataset(ds, sys_frames, dia_frames)
        return sys_frames, dia_frames


class RTimeDetector(CardiacCycleDetector):
    """DICOM R-wave times -> fixed-ratio systole windows (reference :243-281)."""

    def detect(self, ds) -> Tuple[Intervals, Intervals]:
        if not self._should_recalculate(ds):
            return ds.sys_frames, ds.dia_frames
        if not ds.RTimePresent:
            logger.error("no R Wave Time Vector metadata present for "
                         "automatic cardiac cycle calculation!")
            return [], []
        if ds.RWaveTimes.size < 2:
            logger.error("not enough R waves recorded to determine at least "
                         "1 cardiac cycle!")
            return [], []

        frame_times = np.arange(ds.nframes) * (1000 / ds.frame_rate)
        sys_times, dia_times = [], []
        for i in range(ds.RWaveTimes.size - 1):
            r1 = ds.RWaveTimes[i]
            r2 = ds.RWaveTimes[i + 1]
            sys_end = r1 + (r2 - r1) * self.cc_config.rr_sys_ratio
            sys_times.append([r1, sys_end])
            dia_times.append([sys_end, r2])
        sys_frames = timeinterval2index(sys_times, frame_times)
        dia_frames = timeinterval2index(dia_times, frame_times)
        self._update_dataset(ds, sys_frames, dia_frames)
        return sys_frames, dia_frames


class ECGLazyDetector(CardiacCycleDetector):
    """R-peaks + fixed RR ratio, with a small systole extension clamp
    (reference :284-343)."""

    def detect(self, ds, ecg_arr: np.ndarray,
               sampling_rate: int = 500) -> Tuple[Intervals, Intervals]:
        if not self._should_recalculate(ds):
            return ds.sys_frames, ds.dia_frames

        ecg = ecg_clean(np.asarray(ecg_arr, np.float64), sampling_rate)
        filt_ecg = spectral_smooth(ecg, self.cc_config.smooth_fraction,
                                   self.cc_config.pad_len)
        r_i = detect_r_peaks(filt_ecg, sampling_rate, correct_artifacts=True)

        sys_i, dia_i = [], []
        for i in range(len(r_i) - 1):
            r1, r2 = int(r_i[i]), int(r_i[i + 1])
            sys_end = r1 + (r2 - r1) * self.cc_config.rr_sys_ratio
            sys_i.append([r1, sys_end])
            dia_i.append([sys_end, r2])

        frame_times = np.arange(ds.nframes) * (1 / ds.frame_rate)
        sys_frames = timeinterval2index(frame2time(sys_i, sampling_rate), frame_times)
        dia_frames = timeinterval2index(frame2time(dia_i, sampling_rate), frame_times)
        sys_frames = [
            [s[0], int(np.min([s[1] + self.cc_config.sys_extension, ds.nframes - 1]))]
            for s in sys_frames
        ]

        self._plot_cardiac_cycle(
            ds, filt_ecg, np.arange(filt_ecg.shape[0]) * (1000 / sampling_rate),
            sys_i, dia_i, "Time (msec)", "Voltage (mV)",
            "ECG Lazy Cardiac Cycle Detection", "_sysdia_ecg_diagnostic_plot.png")
        self._update_dataset(ds, sys_frames, dia_frames)
        return sys_frames, dia_frames


class ECGDetector(CardiacCycleDetector):
    """R-peak to T-wave-peak systole via a windowed T search
    (reference :346-420)."""

    def detect(self, ds, ecg_arr: np.ndarray,
               sampling_rate: int = 500) -> Tuple[Intervals, Intervals]:
        if not self._should_recalculate(ds):
            return ds.sys_frames, ds.dia_frames

        ecg = ecg_clean(np.asarray(ecg_arr, np.float64), sampling_rate)
        filt_ecg = spectral_smooth(ecg, self.cc_config.smooth_fraction,
                                   self.cc_config.pad_len)
        r_i = detect_r_peaks(filt_ecg, sampling_rate, correct_artifacts=True)

        sys_i = []
        lo_f, hi_f = self.cc_config.rr_search_range
        for idx in range(len(r_i) - 1):
            r_start, r_stop = int(r_i[idx]), int(r_i[idx + 1])
            delta = r_stop - r_start
            s0 = int(np.round(delta * lo_f + r_start))
            s1 = int(np.round(delta * hi_f + r_start))
            segment = filt_ecg[s0:s1]
            cand = peak_indexes(segment, thres=self.cc_config.t_peak_thres,
                                min_dist=self.cc_config.t_min_dist) + s0
            if len(cand) > 0:
                best = cand[int(np.argmax(filt_ecg[cand]))]
                sys_i.append([r_start, int(best)])

        dia_i = []
        # reference appends the trailing interval first (:400-403)
        if len(sys_i) > 0 and sys_i[-1][1] < r_i[-1]:
            dia_i.append([sys_i[-1][1], int(r_i[-1]) - 1])
        for i in range(len(sys_i) - 1):
            dia_i.append([sys_i[i][1], sys_i[i + 1][0]])

        frame_times = np.arange(ds.nframes) * (1 / ds.frame_rate)
        sys_frames = timeinterval2index(frame2time(sys_i, sampling_rate), frame_times)
        dia_frames = timeinterval2index(frame2time(dia_i, sampling_rate), frame_times)

        self._plot_cardiac_cycle(
            ds, filt_ecg, np.arange(filt_ecg.shape[0]) * (1000 / sampling_rate),
            sys_i, dia_i, "Time (msec)", "Voltage (mV)",
            "ECG Cardiac Cycle Detection", "_sysdia_ecg_diagnostic_plot.png")
        self._update_dataset(ds, sys_frames, dia_frames)
        return sys_frames, dia_frames


class ArterialDetector(CardiacCycleDetector):
    """Diastolic troughs + systolic upstroke on the arterial pressure trace
    (reference :423-494)."""

    def detect(self, ds, art_arr: np.ndarray,
               sampling_rate: int = 125) -> Tuple[Intervals, Intervals]:
        if not self._should_recalculate(ds):
            return ds.sys_frames, ds.dia_frames

        filt_art = spectral_smooth(np.asarray(art_arr, np.float64),
                                   self.cc_config.smooth_fraction,
                                   self.cc_config.pad_len)
        lows_i = peak_indexes(-filt_art, thres=self.cc_config.low_peak_thres,
                              min_dist=self.cc_config.low_min_dist) \
            - self.cc_config.sys_upstroke_offset
        lows_i = np.maximum(lows_i, 0)

        sys_i = []
        for idx in range(len(lows_i) - 1):
            low_start, low_stop = int(lows_i[idx]), int(lows_i[idx + 1])
            segment = filt_art[low_start:low_stop]
            cand = peak_indexes(segment, thres=self.cc_config.high_peak_thres,
                                min_dist=self.cc_config.high_min_dist) + low_start
            if len(cand) > 0:
                high = int(cand[int(np.argmax(filt_art[cand]))])
                delta = high - low_start
                sys_stop = low_start + int(np.round(
                    self.cc_config.sys_upstroke_multiplier * delta))
                sys_i.append([low_start, sys_stop])

        dia_i = []
        if len(sys_i) > 0 and sys_i[-1][1] < lows_i[-1]:
            dia_i.append([sys_i[-1][1], int(lows_i[-1]) - 1])
        for i in range(len(sys_i) - 1):
            dia_i.append([sys_i[i][1], sys_i[i + 1][0]])

        frame_times = np.arange(ds.nframes) * (1 / ds.frame_rate)
        sys_frames = timeinterval2index(frame2time(sys_i, sampling_rate), frame_times)
        dia_frames = timeinterval2index(frame2time(dia_i, sampling_rate), frame_times)

        self._plot_cardiac_cycle(
            ds, filt_art, np.arange(np.asarray(art_arr).size) * (1000 / sampling_rate),
            sys_i, dia_i, "Time (msec)", "Pressure (mmHg)",
            "Arterial Pressure Cardiac Cycle Detection",
            "_sysdia_art_diagnostic_plot.png")
        self._update_dataset(ds, sys_frames, dia_frames)
        return sys_frames, dia_frames


def create_detector(method: str, cc_config: Optional[CardiacCycleConfig] = None,
                    vis_config: Optional[VisualizationConfig] = None,
                    proc_config: Optional[ProcessingConfig] = None,
                    device=None) -> CardiacCycleDetector:
    """Factory (reference :497-526). ``device`` is where the angle and
    area detectors reduce their frames."""
    method_map = {
        "angle": AngleDetector,
        "area": AreaDetector,
        "ecg": ECGDetector,
        "ecg_lazy": ECGLazyDetector,
        "metadata": RTimeDetector,
        "arterial": ArterialDetector,
    }
    cls = method_map.get(method)
    if cls is None:
        raise ValueError(f"Unknown detection method: {method}. "
                         f"Must be one of {list(method_map.keys())}")
    return cls(cc_config, vis_config, proc_config, device)
