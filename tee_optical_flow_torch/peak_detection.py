"""S / e' / l' / a' peak extraction from radial-longitudinal traces (the
port's copy of the JAX package's peak_detection.py, host NumPy line for
line).

Behavioral parity with reference optical_flow/peak_detection.py:
  * systolic peak = deepest minimum of the low-percentile trace inside each
    systole window (subset re-search vs global-peak filtering via
    ``pick_peak_by_subset``; argmin fallback, :41-57);
  * diastole split into thirds -> e'/l'/a' windows, argmax per window with
    fallback warnings (:80-134);
  * for the 'angle' method, true diastole is derived as the complement of
    the systole windows (:176-187);
  * same return dicts: filt_hi/filt_lo/true_sys/true_dia and the
    {sys,e,l,a}_{px,py} coordinates (:213-226, :331-373).
"""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple

import numpy as np

from .config import CardiacCycleConfig, PeakDetectionConfig
from .signal.peaks import peak_indexes
from .signal.smoother import spectral_smooth

logger = logging.getLogger(__name__)

Intervals = List[Tuple[int, int]]


def _complement_diastole(true_sys: Intervals, nframes: int) -> Intervals:
    """Diastole as the complement of systole windows ('angle' method,
    reference :176-187)."""
    true_dia: Intervals = []
    if len(true_sys) > 0:
        if true_sys[0][0] > 1:
            true_dia.append([0, true_sys[0][0] - 1])
        if true_sys[-1][1] < (nframes - 2):
            true_dia.append([true_sys[-1][1], nframes - 1])
        for i in range(len(true_sys) - 1):
            true_dia.append([true_sys[i][1], true_sys[i + 1][0]])
    return true_dia


class PeakDetector:
    """Window-wise peak picker (reference :17-136)."""

    def __init__(self, peak_config: Optional[PeakDetectionConfig] = None,
                 cc_config: Optional[CardiacCycleConfig] = None):
        self.peak_config = peak_config or PeakDetectionConfig()
        self.cc_config = cc_config or CardiacCycleConfig()

    def detect_systolic_peaks(self, filt_lo: np.ndarray, sys_frames: Intervals,
                              lo_peaks_i: np.ndarray):
        sys_i, true_sys = [], []
        for start, stop in sys_frames:
            start, stop = int(start), int(stop)
            if self.peak_config.pick_peak_by_subset:
                candidate_i = peak_indexes(
                    -filt_lo[start:stop + 1],
                    thres=self.peak_config.peak_thres,
                    min_dist=self.peak_config.min_dist) + start
            else:
                candidate_i = [k for k in lo_peaks_i if start <= k <= stop]
            if len(candidate_i) > 0:
                vals = [filt_lo[i] for i in candidate_i]
                sys_i.append(int(candidate_i[int(np.argmin(vals))]))
                true_sys.append([start, stop])
            else:
                logger.warning("no systolic peak found! Using max value")
                sys_i.append(int(np.argmin(filt_lo[start:stop])) + start)
        return sys_i, true_sys

    def detect_diastolic_peaks(self, filt_hi: np.ndarray, dia_frames: Intervals,
                               hi_peaks_i: np.ndarray, nframes: int):
        e_i, l_i, a_i = [], [], []
        for start, stop in dia_frames:
            start, stop = int(start), int(stop)
            third = int(np.floor((stop - start) / 3))
            # (w0, w_last) per window, exactly the reference's
            # e/l/a_start..stop arithmetic (:80-85, note a_stop = stop + 1)
            windows = {
                "e": (start, start + third),
                "l": (start + third + 1, start + 2 * third + 1),
                "a": (start + 2 * third + 2, stop + 1),
            }
            for name, out in (("e", e_i), ("l", l_i), ("a", a_i)):
                w0, w_last = windows[name]
                if self.peak_config.pick_peak_by_subset:
                    cand = peak_indexes(
                        filt_hi[w0:w_last + 1],
                        thres=self.peak_config.peak_thres,
                        min_dist=self.peak_config.min_dist) + w0
                else:
                    cand = [k for k in hi_peaks_i if w0 <= k <= w_last]
                if len(cand) > 0:
                    vals = [filt_hi[i] for i in cand]
                    out.append(int(cand[int(np.argmax(vals))]))
                else:
                    logger.warning("no %s' peak found! Using max value", name)
                    seg = filt_hi[w0:w_last]
                    if seg.size == 0:
                        out.append(min(max(w0, 0), nframes - 1))
                    else:
                        out.append(int(np.argmax(seg)) + w0)
        return e_i, l_i, a_i


def calculate_radlong_peaks(hi_arr, lo_arr, frame_times, sys_frames: Intervals,
                            dia_frames: Intervals, nframes: int,
                            cc_method: str = "angle",
                            smooth_fraction: float = 0.3, pad_len: int = 20,
                            peak_thres: float = 0.5, min_dist: int = 5,
                            pick_peak_by_subset: bool = False) -> dict:
    """Smoothing + windowed peak extraction for a (hi, lo) trace pair
    (reference :139-226)."""
    filt_lo = spectral_smooth(np.asarray(lo_arr), smooth_fraction, pad_len)
    filt_hi = spectral_smooth(np.asarray(hi_arr), smooth_fraction, pad_len)

    hi_peaks_i = peak_indexes(filt_hi, thres=peak_thres, min_dist=min_dist)
    lo_peaks_i = peak_indexes(-filt_lo, thres=peak_thres, min_dist=min_dist)

    if cc_method == "angle":
        true_sys = sys_frames
        true_dia = _complement_diastole(true_sys, nframes)
    else:
        true_sys = sys_frames
        true_dia = dia_frames

    detector = PeakDetector(PeakDetectionConfig(
        peak_thres=peak_thres, min_dist=min_dist,
        pick_peak_by_subset=pick_peak_by_subset))
    sys_i, true_sys_updated = detector.detect_systolic_peaks(
        filt_lo, true_sys, lo_peaks_i)
    e_i, l_i, a_i = detector.detect_diastolic_peaks(
        filt_hi, true_dia, hi_peaks_i, nframes)

    frame_times = np.asarray(frame_times)
    return {
        "filt_hi": filt_hi,
        "filt_lo": filt_lo,
        "true_sys": true_sys_updated,
        "true_dia": true_dia,
        "sys_px": frame_times[sys_i], "sys_py": filt_lo[sys_i],
        "e_px": frame_times[e_i], "e_py": filt_hi[e_i],
        "l_px": frame_times[l_i], "l_py": filt_hi[l_i],
        "a_px": frame_times[a_i], "a_py": filt_hi[a_i],
    }


def calculate_single_peaks(filt_arr, frame_times, sys_frames: Intervals,
                           dia_frames: Intervals, nframes: int,
                           cc_method: str = "angle",
                           peak_thres: float = 0.2, min_dist: int = 5,
                           pick_peak_by_subset: bool = False,
                           show_all_peaks: bool = False) -> dict:
    """Single-trace analogue with argmax systole (reference :229-375)."""
    filt_arr = np.asarray(filt_arr)
    frame_times = np.asarray(frame_times)
    peaks_i = peak_indexes(filt_arr, thres=peak_thres, min_dist=min_dist)

    sys_i, true_sys = [], []
    for start, stop in sys_frames:
        start, stop = int(start), int(stop)
        if pick_peak_by_subset:
            cand = peak_indexes(filt_arr[start:stop + 1], thres=peak_thres,
                                min_dist=min_dist) + start
        else:
            cand = [k for k in peaks_i if start <= k <= stop]
        if len(cand) > 0:
            vals = [filt_arr[i] for i in cand]
            sys_i.append(int(cand[int(np.argmax(vals))]))
            true_sys.append([start, stop])
        else:
            logger.warning("no sys peak found! Using max value")
            sys_i.append(int(np.argmax(filt_arr[start:stop])) + start)

    if cc_method == "angle":
        true_dia = _complement_diastole(true_sys, nframes)
    else:
        true_dia = dia_frames
        true_sys = sys_frames

    detector = PeakDetector(PeakDetectionConfig(
        peak_thres=peak_thres, min_dist=min_dist,
        pick_peak_by_subset=pick_peak_by_subset))
    e_i, l_i, a_i = detector.detect_diastolic_peaks(
        filt_arr, true_dia, peaks_i, nframes)

    result = {
        "filt_arr": filt_arr,
        "true_sys": true_sys,
        "true_dia": true_dia,
        "sys_px": frame_times[sys_i], "sys_py": filt_arr[sys_i],
        "e_px": frame_times[e_i], "e_py": filt_arr[e_i],
        "l_px": frame_times[l_i], "l_py": filt_arr[l_i],
        "a_px": frame_times[a_i], "a_py": filt_arr[a_i],
    }
    if show_all_peaks:
        result["all_px"] = frame_times[peaks_i]
        result["all_py"] = filt_arr[peaks_i]
    return result
