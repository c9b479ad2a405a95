"""High-level API: analyze, plot, batch (the JAX package's api.py;
reference optical_flow/api.py:20-131).

The JAX package's two fixes of reference bugs are kept:
  * the histogram bin count comes from ``analysis_config.nbins`` (the
    reference passed ``av_savgol_window``, a savgol filter width, as
    nbins, api.py:55);
  * ``frame_times`` is a per-frame time array (the reference computed a
    scalar ``nframes * (1000/frame_rate)``, api.py:98).

Each function that computes takes ``device`` (``cuda`` unless the caller
asks for ``cpu``) and runs its histogram, centroid and detector passes
there.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

from .analysis import calculate_3dhist, calculate_3dhist_radlong
from .config import (
    AnalysisConfig, CardiacCycleConfig, ProcessingConfig, VisualizationConfig,
)
from .dataset import OpticalFlowDataset
from .signal.cycles import create_detector


def analyze_optical_flow(dataset: OpticalFlowDataset, param: str, label: str,
                         cc_config: Optional[CardiacCycleConfig] = None,
                         proc_config: Optional[ProcessingConfig] = None,
                         analysis_config: Optional[AnalysisConfig] = None,
                         device=None) -> dict:
    """Magnitude/angle histogram analysis of one masked parameter."""
    if not dataset._validate_param(param):
        raise ValueError(f"Invalid parameter: {param}. "
                         f"Must be one of {dataset.accepted_params}")
    if not dataset._validate_label(label):
        raise ValueError(f"Invalid label: {label}. "
                         f"Must be one of {dataset.accepted_labels}")
    analysis_config = analysis_config or AnalysisConfig()

    mag, ang, mag_edges, ang_edges, perc_hi = calculate_3dhist(
        dataset.device_masked_arr(param, label, device), dataset.nframes,
        nbins=analysis_config.nbins, percentile=analysis_config.percentile)
    return {
        "magnitude": mag,
        "angle": ang,
        "magnitude_edges": mag_edges,
        "angle_edges": ang_edges,
        "percentile_high": perc_hi,
    }


def analyze_radlong(dataset: OpticalFlowDataset, param: str,
                    av_label: str = "av",
                    analysis_config: Optional[AnalysisConfig] = None,
                    device=None) -> dict:
    """Radial/longitudinal decomposition about the AV centroid."""
    analysis_config = analysis_config or AnalysisConfig()
    label = ("rv" if "rv" in dataset.accepted_labels
             else dataset.accepted_labels[0])
    return calculate_3dhist_radlong(
        dataset.device_masked_arr(param, label, device),
        dataset.get_mask(av_label), dataset.nframes,
        nbins=analysis_config.nbins, perc_lo=analysis_config.perc_lo,
        perc_hi=analysis_config.perc_hi,
        av_filter_flag=analysis_config.av_filter_flag,
        av_savgol_window=analysis_config.av_savgol_window,
        av_savgol_poly=analysis_config.av_savgol_poly)


def detect_cardiac_cycle(dataset: OpticalFlowDataset, method: str = "angle",
                         param: str = "velocity", label: str = "rv_inner",
                         cc_config: Optional[CardiacCycleConfig] = None,
                         proc_config: Optional[ProcessingConfig] = None,
                         device=None):
    """Run a named detector with the dataset's own waveforms."""
    detector = create_detector(method, cc_config, None, proc_config, device)
    if method == "angle":
        return detector.detect(dataset, param, label)
    if method == "area":
        return detector.detect(dataset, label)
    if method == "metadata":
        return detector.detect(dataset)
    if method in ("ecg", "ecg_lazy"):
        return detector.detect(dataset, dataset.ecg,
                               int(dataset.ecg_sampling_rate))
    if method == "arterial":
        return detector.detect(dataset, dataset.art,
                               int(dataset.art_sampling_rate))
    raise ValueError(f"unknown method {method}")


def plot_results(dataset: OpticalFlowDataset, param: str, label: str,
                 save_path: str,
                 vis_config: Optional[VisualizationConfig] = None,
                 proc_config: Optional[ProcessingConfig] = None,
                 analysis_config: Optional[AnalysisConfig] = None,
                 device=None):
    """Heatmap plot of one masked parameter (reference api.py:68-105)."""
    from .viz.manager import VisualizationManager

    vis_config = vis_config or VisualizationConfig()
    proc_config = proc_config or ProcessingConfig()
    analysis_config = analysis_config or AnalysisConfig()

    manager = VisualizationManager(vis_config=vis_config,
                                   proc_config=proc_config)
    results = analyze_optical_flow(dataset, param, label,
                                   proc_config=proc_config,
                                   analysis_config=analysis_config,
                                   device=device)
    # per-frame times in ms (reference bug fix: was a scalar)
    frame_times = np.arange(dataset.nframes) * (1000.0 / dataset.frame_rate)
    return manager.plot_heatmap(
        results["magnitude"], results["angle"],
        results["magnitude_edges"], results["angle_edges"],
        frame_times, param, dataset._param_unit(param), save_path,
        nframes=dataset.nframes)


def batch_process(folder: str, save_dir: str, param_list: List[str],
                  label_list: List[str], process_func: Callable,
                  nchunks: int = 10, chunk_index: int = 0,
                  recalculate: bool = False, verbose: bool = True):
    """Cohort batch entry point (reference api.py:107-131)."""
    from .batch.processor import analyze_hdf5_folder

    return analyze_hdf5_folder(
        folder, save_dir, param_list, label_list, process_func,
        nchunks=nchunks, chunk_index=chunk_index,
        recalculate=recalculate, verbose=verbose)
