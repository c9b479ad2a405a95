"""Cohort-scale clinical analysis: HDF5 -> 69-value row -> CSV (the JAX
package's batch/cohort.py).

Parity with the reference's legacy cohort loop
(analyze_optical_flow.py:1361-1516): per file and (param, label), run the
ECG-gated and arterial-gated pipelines for both the total-magnitude trace
and the radial/longitudinal decomposition, assemble the 15 metadata
values + 9 + 9 + 18 + 18 statistics into one 69-value row (the schema of
file_io.py:207-247), zero-filling any gate that fails (reference
:1417-1470 wraps each in try/except).

The masked parameter goes to the device once per file; the histogram and
percentile passes and the AV centroid labelling run there, everything
after the traces on the host. ``_cohort_row`` computes the row without
matplotlib; ``analyze_cohort_file`` draws the peak-line plots around it
and fails when matplotlib is missing.
"""

from __future__ import annotations

import functools
import logging
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..analysis import calculate_3dhist, calculate_3dhist_radlong
from ..config import (
    AnalysisConfig, ProcessingConfig, VisualizationConfig,
    arterial_gated_config, ecg_gated_config,
)
from ..dataset import OpticalFlowDataset
from ..io.tabular import aggregate_pkl_files
from ..signal.cycles import ArterialDetector, ECGLazyDetector
from ..signal.smoother import spectral_smooth
from ..utils import safe_makedir
from ..viz.manager import VisualizationManager

logger = logging.getLogger(__name__)

_ZERO9 = tuple([0.0] * 8 + [0])
_ZERO18 = tuple([0.0] * 16 + [0, 0])
_GATES = (("ecg_lazy", "ecg"), ("arterial", "art"))


def _detect(ds, gate: str, cc_config, proc_config):
    if gate == "ecg":
        det = ECGLazyDetector(cc_config, None, proc_config)
        return det.detect(ds, ds.ecg, int(ds.ecg_sampling_rate))
    det = ArterialDetector(cc_config, None, proc_config)
    return det.detect(ds, ds.art, int(ds.art_sampling_rate))


def _total_trace(ds, masked, manager, analysis_config):
    """Gate-independent half of the total-magnitude analysis: the smoothed
    high-percentile trace. The gates differ only in which frames count as
    systole/diastole, which enters at peak detection — the reference's
    cohort loop recomputes this identically per gate
    (analyze_optical_flow.py:1410-1454); computing it once is
    bit-identical and halves the device passes per file."""
    _mag, _ang, _me, _ae, perc_hi = calculate_3dhist(
        masked, ds.nframes, nbins=analysis_config.nbins,
        percentile=analysis_config.percentile)
    return spectral_smooth(perc_hi, manager.peak_config.smooth_fraction,
                           manager.peak_config.pad_len)


def _radlong_traces(ds, masked, av_masks, analysis_config):
    """Gate-independent half of the radial/longitudinal analysis:
    (rad_hi, rad_lo, long_hi, long_lo)."""
    data = calculate_3dhist_radlong(
        masked, av_masks, ds.nframes, nbins=analysis_config.nbins,
        perc_lo=analysis_config.perc_lo, perc_hi=analysis_config.perc_hi,
        av_filter_flag=analysis_config.av_filter_flag,
        av_savgol_window=analysis_config.av_savgol_window,
        av_savgol_poly=analysis_config.av_savgol_poly)
    _f, _e, rad_hi, rad_lo = data["radial"]
    _f, _e, long_hi, long_lo = data["longitudinal"]
    return rad_hi, rad_lo, long_hi, long_lo


def _waveform_stats(ds):
    def mmm(arr):
        arr = np.asarray(arr, np.float64)
        return float(arr.mean()), float(arr.max()), float(arr.min())

    art = mmm(ds.art) if hasattr(ds, "art") else (0.0, 0.0, 0.0)
    cvp = mmm(ds.cvp) if getattr(ds, "cvp_exists", False) else (0.0, 0.0, 0.0)
    pap = mmm(ds.pap) if getattr(ds, "pap_exists", False) else (0.0, 0.0, 0.0)
    return art, cvp, pap


def _cohort_traces(ds, param: str, label: str, manager,
                   analysis_config: AnalysisConfig, device=None):
    """The row's device half: the smoothed total trace and the
    (rad_hi, rad_lo, long_hi, long_lo) traces, each None where it failed
    (the reference's per-gate recomputation would have failed
    identically). The masked parameter goes to ``device`` once."""
    masked_dev = ds.device_masked_arr(param, label, device)
    filt = traces = None
    try:
        filt = _total_trace(ds, masked_dev, manager, analysis_config)
    except Exception as exc:
        logger.warning("%s total trace failed: %s", ds.filename, exc)
    if "av" in ds.accepted_labels:
        try:
            traces = _radlong_traces(ds, masked_dev, ds.get_mask("av"),
                                     analysis_config)
        except Exception as exc:
            logger.warning("%s radlong traces failed: %s", ds.filename, exc)
    return filt, traces


def _cohort_sections(ds, filt, traces, manager,
                     proc_config: ProcessingConfig):
    """The row's host half from the traces: per gate, the detection, the
    peaks and the statistics, zero-filled where a step fails. Returns the
    four sections by name and, for each section that succeeded, the peak
    data its plot draws."""
    rows: Dict[str, Tuple] = {}
    peaks: Dict[str, Tuple] = {}
    frame_times = np.arange(ds.nframes) / ds.frame_rate
    for gate, gate_key in _GATES:
        cc_cfg = ecg_gated_config() if gate == "ecg_lazy" \
            else arterial_gated_config()
        # one detection per gate (deterministic: the reference's second
        # detect call per gate returns identical frames)
        sys_f = dia_f = None
        try:
            proc_gate = ProcessingConfig(recalculate=True,
                                         verbose=proc_config.verbose)
            sys_f, dia_f = _detect(ds, gate_key, cc_cfg, proc_gate)
        except Exception as exc:
            logger.warning("%s %s detect failed: %s", ds.filename, gate_key,
                           exc)
        try:
            if sys_f is None or filt is None:
                raise RuntimeError("gate detection or total trace failed")
            data = manager.single_peak_data(filt, frame_times, sys_f, dia_f,
                                            ds.nframes, cc_method=gate)
            rows[f"{gate_key}_total"] = manager.single_statistics(data)
            peaks[f"{gate_key}_total"] = (gate, sys_f, dia_f, data)
        except Exception as exc:
            logger.warning("%s %s total failed: %s", ds.filename, gate_key,
                           exc)
            rows[f"{gate_key}_total"] = _ZERO9
        try:
            if "av" in ds.accepted_labels:
                if sys_f is None or traces is None:
                    raise RuntimeError(
                        "gate detection or radlong traces failed")
                rad_hi, rad_lo, long_hi, long_lo = traces
                rad = manager.radlong_peak_data(
                    rad_hi, rad_lo, frame_times, sys_f, dia_f, ds.nframes,
                    cc_method=gate)
                lng = manager.radlong_peak_data(
                    long_hi, long_lo, frame_times, sys_f, dia_f, ds.nframes,
                    cc_method=gate)
                rows[f"{gate_key}_radlong"] = manager.radlong_statistics(
                    rad, lng)
                peaks[f"{gate_key}_radlong"] = (gate, sys_f, dia_f,
                                                (rad, lng))
            else:
                rows[f"{gate_key}_radlong"] = _ZERO18
        except Exception as exc:
            logger.warning("%s %s radlong failed: %s", ds.filename, gate_key,
                           exc)
            rows[f"{gate_key}_radlong"] = _ZERO18
    return rows, peaks


def _assemble_row(ds, rows: Dict[str, Tuple]) -> List:
    """15 metadata values + the four sections: 15 + 9 + 9 + 18 + 18 = 69
    (column order of file_io.py:207-247)."""
    art, cvp, pap = _waveform_stats(ds)
    meta = [
        ds.filename, str(getattr(ds, "ID", "")), float(ds.frame_rate),
        float(ds.pixel_spacing), 0, int(ds.nframes),
        art[0], art[1], art[2], cvp[0], cvp[1], cvp[2],
        pap[0], pap[1], pap[2],
    ]
    return (meta + list(rows["ecg_total"]) + list(rows["art_total"]) +
            list(rows["ecg_radlong"]) + list(rows["art_radlong"]))


def _cohort_row(ds, param: str, label: str,
                analysis_config: Optional[AnalysisConfig] = None,
                proc_config: Optional[ProcessingConfig] = None,
                device=None):
    """One dataset's row sections, without matplotlib: the device traces,
    then the host sections. Returns (sections, peaks) as _cohort_sections
    gives them; ``_assemble_row(ds, sections)`` is the 69-value row."""
    analysis_config = analysis_config or AnalysisConfig()
    proc_config = proc_config or ProcessingConfig()
    manager = VisualizationManager(
        vis_config=VisualizationConfig(show_img=False),
        proc_config=proc_config)
    filt, traces = _cohort_traces(ds, param, label, manager,
                                  analysis_config, device)
    return _cohort_sections(ds, filt, traces, manager, proc_config)


def _plot_sections(ds, param: str, label: str, save_dir: str, manager,
                   peaks: Dict[str, Tuple]) -> Dict[str, Tuple]:
    """The peak-line plot of each section that has peaks, under
    ``save_dir/plots``; a section whose plot fails is zero-filled, as the
    reference's try/except around its plot-and-statistics call does.
    Returns the zero-filled sections by name."""
    failed: Dict[str, Tuple] = {}
    frame_times = np.arange(ds.nframes) / ds.frame_rate
    unit = ds._param_unit(param)
    for key, (gate, sys_f, dia_f, data) in peaks.items():
        try:
            if key.endswith("_total"):
                manager.plot_peak_line(
                    None, frame_times, sys_f, dia_f, ds.nframes, param, unit,
                    label, os.path.join(
                        save_dir, "plots",
                        f"{ds.filename}_{gate}_{param}_{label}_total.png"),
                    cc_method=gate, peak_data=data, print_report=False,
                    return_statistics=True)
            else:
                rad, lng = data
                manager.plot_peak_line_radlong(
                    None, None, None, None, frame_times, sys_f, dia_f,
                    ds.nframes, param, unit, label, os.path.join(
                        save_dir, "plots",
                        f"{ds.filename}_{gate}_{param}_{label}_radlong.png"),
                    cc_method=gate, rad_peak_data=rad, long_peak_data=lng,
                    print_report=False, return_statistics=True)
        except Exception as exc:
            logger.warning("%s %s plot failed: %s", ds.filename, key, exc)
            failed[key] = _ZERO9 if key.endswith("_total") else _ZERO18
    return failed


def analyze_cohort_file(filepath: str, param: str = "velocity",
                        label: str = "rv", save_dir: str = ".",
                        analysis_config: Optional[AnalysisConfig] = None,
                        proc_config: Optional[ProcessingConfig] = None,
                        device=None) -> List:
    """One HDF5 -> one 69-value row (reference :1397-1499), its device
    passes on ``device`` (``cuda`` unless the caller asks for ``cpu``),
    and the peak-line plots under ``save_dir/plots``. Raises ImportError
    when matplotlib is missing."""
    import matplotlib  # noqa: F401  (the plots below need it)

    proc_config = proc_config or ProcessingConfig()
    manager = VisualizationManager(
        vis_config=VisualizationConfig(show_img=False),
        proc_config=proc_config)
    safe_makedir(os.path.join(save_dir, "plots"))
    with OpticalFlowDataset(filepath) as ds:
        rows, peaks = _cohort_row(ds, param, label, analysis_config,
                                  proc_config, device)
        rows.update(_plot_sections(ds, param, label, save_dir, manager,
                                   peaks))
        return _assemble_row(ds, rows)


def run_cohort_analysis(folder: str, save_dir: str,
                        param_list: Optional[List[str]] = None,
                        label_list: Optional[List[str]] = None,
                        nchunks: int = 1, chunk_index: int = 0,
                        recalculate: bool = False,
                        aggregate: bool = True, verbose: bool = True,
                        device=None):
    """Full cohort run: shard, analyze, merge to CSV (reference
    :1361-1620 + file_io.py:168-251), the device passes on ``device``."""
    from .processor import analyze_hdf5_folder

    param_list = param_list or ["velocity"]
    label_list = label_list or ["rv"]
    errors = analyze_hdf5_folder(
        folder, save_dir, param_list, label_list,
        functools.partial(analyze_cohort_file, device=device),
        nchunks=nchunks, chunk_index=chunk_index, recalculate=recalculate,
        verbose=verbose)
    if aggregate:
        aggregate_pkl_files(param_list, label_list, save_dir)
    return errors
