"""Backward-compatibility surface for the reference's legacy monolith (the
JAX package's legacy.py).

The reference keeps a 1,620-line ``analyze_optical_flow.py`` whose
functions wrap the detector classes and duplicate the analysis/plot code
paths (reference analyze_optical_flow.py:102-199, :1361-1620). Users
migrating from it get the same names here, each delegating to the new
stack. New code should import from the real modules instead.

``percentile_plot`` and ``percentile_plot_radlong`` compute what their
docstrings say from the cohort row's building blocks: the trace through
``batch.cohort._cohort_traces``, one detection for the gate, and the
statistics from the manager's peak-line plot. (The JAX package's shims
call its ``_total_stats``/``_radlong_stats`` with one argument too few
and raise TypeError.) ``device`` is where the device passes run:
``cuda`` unless the caller asks for ``cpu``.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from .analysis import (
    calc_bidirectional_hist, calculate_3dhist, calculate_3dhist_radlong,
)
from .batch.cohort import run_cohort_analysis
from .config import CardiacCycleConfig, ProcessingConfig
from .io.tabular import aggregate_pkl_files as aggregate_pkl
from .signal.cycles import (
    AngleDetector, AreaDetector, ArterialDetector, ECGDetector,
    ECGLazyDetector, RTimeDetector,
)
from .viz.manager import VisualizationManager

__all__ = [
    "sysdia_frames_by_angle", "sysdia_frames_by_area",
    "sysdia_frames_by_RTime", "sysdia_frames_by_ecg_lazy",
    "sysdia_frames_by_ecg", "sysdia_frames_by_art",
    "calculate_3dhist", "calculate_3dhist_radlong", "calc_bidirectional_hist",
    "percentile_plot", "percentile_plot_radlong",
    "analyze_hdf5_folder", "aggregate_pkl",
]


def _cc(smooth_fraction=0.2, pad_len=20, **kw) -> CardiacCycleConfig:
    cfg = CardiacCycleConfig(smooth_fraction=smooth_fraction, pad_len=pad_len)
    for k, v in kw.items():
        if hasattr(cfg, k):
            setattr(cfg, k, v)
    return cfg


def sysdia_frames_by_angle(ds, param="velocity", label="rv_inner",
                           device=None, **kw):
    """(reference analyze_optical_flow.py:102-118)."""
    return AngleDetector(_cc(**kw), None, ProcessingConfig(),
                         device).detect(ds, param, label)


def sysdia_frames_by_area(ds, label="rv_inner", device=None, **kw):
    return AreaDetector(_cc(**kw), None, ProcessingConfig(),
                        device).detect(ds, label)


def sysdia_frames_by_RTime(ds, **kw):
    return RTimeDetector(_cc(**kw), None, ProcessingConfig()).detect(ds)


def sysdia_frames_by_ecg_lazy(ds, ecg_arr, sampling_rate=500, **kw):
    return ECGLazyDetector(_cc(**kw), None, ProcessingConfig()).detect(
        ds, ecg_arr, sampling_rate)


def sysdia_frames_by_ecg(ds, ecg_arr, sampling_rate=500, **kw):
    return ECGDetector(_cc(**kw), None, ProcessingConfig()).detect(
        ds, ecg_arr, sampling_rate)


def sysdia_frames_by_art(ds, art_arr, sampling_rate=125, **kw):
    return ArterialDetector(_cc(**kw), None, ProcessingConfig()).detect(
        ds, art_arr, sampling_rate)


def _gated_traces(ds, param, label, cc_method, device, kw):
    """The statistics' inputs: the manager, the gate's (sys, dia) frames,
    the (total, radlong) traces, the frame times and the unit."""
    from .batch.cohort import _cohort_traces, _detect
    from .config import AnalysisConfig, VisualizationConfig

    manager = VisualizationManager(
        vis_config=VisualizationConfig(return_statistics=True))
    gate = "ecg" if "ecg" in cc_method else "art"
    sys_f, dia_f = _detect(ds, gate, _cc(**kw), ProcessingConfig())
    filt, traces = _cohort_traces(ds, param, label, manager,
                                  AnalysisConfig(), device)
    frame_times = np.arange(ds.nframes) / ds.frame_rate
    return manager, sys_f, dia_f, filt, traces, frame_times


def _plot_path(ds, save_dir, cc_method, param, label, kind):
    return os.path.join(save_dir, "plots",
                        f"{ds.filename}_{cc_method}_{param}_{label}_{kind}.png")


def percentile_plot(ds, param="velocity", label="rv", cc_method="ecg_lazy",
                    save_dir=".", device=None, **kw):
    """Legacy 9-tuple entry point (reference :1120-1359): total-magnitude
    percentile trace -> peak statistics; draws the peak-line plot under
    ``save_dir/plots``."""
    manager, sys_f, dia_f, filt, _, frame_times = _gated_traces(
        ds, param, label, cc_method, device, kw)
    if filt is None:
        raise RuntimeError(f"{ds.filename}: the total trace failed")
    return manager.plot_peak_line(
        filt, frame_times, sys_f, dia_f, ds.nframes, param,
        ds._param_unit(param), label,
        _plot_path(ds, save_dir, cc_method, param, label, "total"),
        cc_method=cc_method, print_report=False, return_statistics=True)


def percentile_plot_radlong(ds, param="velocity", label="rv",
                            cc_method="ecg_lazy", save_dir=".", device=None,
                            **kw):
    """Legacy 18-tuple entry point (reference :660-906): the radial and
    longitudinal percentile traces about the AV centroid -> peak
    statistics; draws the peak-line plot under ``save_dir/plots``."""
    manager, sys_f, dia_f, _, traces, frame_times = _gated_traces(
        ds, param, label, cc_method, device, kw)
    if traces is None:
        raise RuntimeError(f"{ds.filename}: the radial/longitudinal traces "
                           "failed or the clip has no av mask")
    rad_hi, rad_lo, long_hi, long_lo = traces
    return manager.plot_peak_line_radlong(
        rad_hi, rad_lo, long_hi, long_lo, frame_times, sys_f, dia_f,
        ds.nframes, param, ds._param_unit(param), label,
        _plot_path(ds, save_dir, cc_method, param, label, "radlong"),
        cc_method=cc_method, print_report=False, return_statistics=True)


def analyze_hdf5_folder(folder: str, save_dir: str,
                        param_list: Optional[List[str]] = None,
                        label_list: Optional[List[str]] = None,
                        nchunks: int = 1, chunk_index: int = 0,
                        recalculate: bool = False, verbose: bool = True,
                        device=None):
    """Legacy cohort loop (reference :1361-1516)."""
    return run_cohort_analysis(folder, save_dir, param_list, label_list,
                               nchunks=nchunks, chunk_index=chunk_index,
                               recalculate=recalculate, verbose=verbose,
                               device=device)
