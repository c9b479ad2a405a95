"""VisualizationManager: the peak statistics, their printed report and the
S/e'/l'/a' peak-line plots (the JAX package's viz/manager.py, :255-509;
reference optical_flow/visualization.py:299-1043).

The statistics are the 9- and 18-value tuples of the cohort row
(reference :751-761, :1034-1041). They are computed without matplotlib
(``single_peak_data``, ``radlong_peak_data`` and the ``*_statistics``
methods), so a machine without it still gets the row; the plot methods
import matplotlib inside, draw, and return the same tuples. The heatmaps
and the overlay video of the JAX module are not ported yet.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Tuple

import numpy as np

from ..config import (
    CardiacCycleConfig, PeakDetectionConfig, ProcessingConfig,
    VisualizationConfig,
)
from ..peak_detection import calculate_radlong_peaks, calculate_single_peaks
from ..utils import fix_ecg, safe_makedir

logger = logging.getLogger(__name__)


class VisualizationManager:
    def __init__(self, vis_config: Optional[VisualizationConfig] = None,
                 cc_config: Optional[CardiacCycleConfig] = None,
                 peak_config: Optional[PeakDetectionConfig] = None,
                 proc_config: Optional[ProcessingConfig] = None):
        self.vis_config = vis_config or VisualizationConfig()
        self.cc_config = cc_config or CardiacCycleConfig()
        self.peak_config = peak_config or PeakDetectionConfig()
        self.proc_config = proc_config or ProcessingConfig()

    # ------------------------------------------------------------------
    # peaks and statistics (no matplotlib)
    # ------------------------------------------------------------------

    def single_peak_data(self, filt_arr, frame_times, sys_frames, dia_frames,
                         nframes: int, cc_method: str = "angle") -> Dict:
        """calculate_single_peaks under this manager's peak config (what
        plot_peak_line computes when no peak data is given)."""
        return calculate_single_peaks(
            filt_arr, frame_times, sys_frames, dia_frames, nframes,
            cc_method=cc_method, peak_thres=self.peak_config.peak_thres,
            min_dist=self.peak_config.min_dist,
            pick_peak_by_subset=self.peak_config.pick_peak_by_subset,
            show_all_peaks=self.peak_config.show_all_peaks)

    def radlong_peak_data(self, hi_arr, lo_arr, frame_times, sys_frames,
                          dia_frames, nframes: int,
                          cc_method: str = "angle") -> Dict:
        """calculate_radlong_peaks under this manager's peak config (what
        plot_peak_line_radlong computes for each component when no peak
        data is given)."""
        return calculate_radlong_peaks(
            hi_arr, lo_arr, frame_times, sys_frames, dia_frames, nframes,
            cc_method=cc_method,
            smooth_fraction=self.peak_config.smooth_fraction,
            pad_len=self.peak_config.pad_len,
            peak_thres=self.peak_config.peak_thres,
            min_dist=self.peak_config.min_dist,
            pick_peak_by_subset=self.peak_config.pick_peak_by_subset)

    @staticmethod
    def _stat_pair(values, use_abs: bool) -> Tuple[float, float]:
        values = np.asarray(values)
        if values.size == 0:
            return 0.0, 0.0
        v = np.abs(values) if use_abs else values
        return float(np.max(v)), float(np.mean(v))

    def _calculate_peak_statistics(self, rad_peak_data: Dict,
                                   long_peak_data: Dict) -> Dict:
        """18-value radial+long stats; |.| on both components
        (reference :299-378)."""
        stats = {}
        for prefix, data in (("rad", rad_peak_data), ("long", long_peak_data)):
            for key in ("sys", "e", "l", "a"):
                pk, mn = self._stat_pair(data.get(f"{key}_py", []),
                                         use_abs=True)
                stats[f"{prefix}_peak_{key}"] = pk
                stats[f"{prefix}_mean_{key}"] = mn
            stats[f"{prefix}_n_cycles"] = len(np.asarray(data.get("sys_py", [])))
        return stats

    def _calculate_single_peak_statistics(self, peak_data: Dict) -> Dict:
        """9-value single-trace stats; raw values, no |.|
        (reference :380-424)."""
        stats = {}
        for key in ("sys", "e", "l", "a"):
            pk, mn = self._stat_pair(peak_data.get(f"{key}_py", []),
                                     use_abs=False)
            stats[f"peak_{key}"] = pk
            stats[f"mean_{key}"] = mn
        stats["n_cycles"] = len(np.asarray(peak_data.get("sys_py", [])))
        return stats

    def radlong_statistics(self, rad_peak_data: Dict,
                           long_peak_data: Dict) -> Tuple:
        """The 18-tuple plot_peak_line_radlong returns."""
        stats = self._calculate_peak_statistics(rad_peak_data, long_peak_data)
        return (stats["rad_peak_sys"], stats["rad_mean_sys"],
                stats["rad_peak_e"], stats["rad_mean_e"],
                stats["rad_peak_l"], stats["rad_mean_l"],
                stats["rad_peak_a"], stats["rad_mean_a"],
                stats["long_peak_sys"], stats["long_mean_sys"],
                stats["long_peak_e"], stats["long_mean_e"],
                stats["long_peak_l"], stats["long_mean_l"],
                stats["long_peak_a"], stats["long_mean_a"],
                stats["rad_n_cycles"], stats["long_n_cycles"])

    def single_statistics(self, peak_data: Dict) -> Tuple:
        """The 9-tuple plot_peak_line returns."""
        stats = self._calculate_single_peak_statistics(peak_data)
        if stats["n_cycles"] == 0:
            logger.error("not complete cardiac cycle: systolic cycles=0")
        return (stats["peak_sys"], stats["mean_sys"],
                stats["peak_e"], stats["mean_e"],
                stats["peak_l"], stats["mean_l"],
                stats["peak_a"], stats["mean_a"],
                stats["n_cycles"])

    def _print_report(self, stats: Dict, label: str, param: str,
                      prefixes=("",)) -> None:
        names = {"sys": "peak systolic", "e": "early peak diastolic",
                 "l": "diastasis peak diastolic", "a": "late peak diastolic"}
        print("=====================")
        for prefix in prefixes:
            title = {"rad_": "RADIAL COMPONENT:",
                     "long_": "LONGITUDINAL COMPONENT:",
                     "": "COMPONENT:"}[prefix]
            print(title)
            print("----------------")
            for key in ("sys", "e", "l", "a"):
                pk = stats.get(f"{prefix}peak_{key}", 0.0)
                mn = stats.get(f"{prefix}mean_{key}", 0.0)
                print(f"Global {names[key]} {label.upper()} {param}: {pk}")
                print(f"Global mean {names[key].split()[0]} {label.upper()} "
                      f"{param}: {mn}")
            print(f"Number of cardiac cycles: "
                  f"{stats.get(prefix + 'n_cycles', 0)}")
        print("=====================")

    # ------------------------------------------------------------------
    # peak-line plots
    # ------------------------------------------------------------------

    def _annotate(self, ax, data: Dict) -> None:
        from .plotting_utils import annotate_peaks

        vc = self.vis_config
        for key, color in (("sys", vc.systolic_peak_color),
                           ("e", vc.diastolic_peak_color),
                           ("l", vc.diastolic_peak_color),
                           ("a", vc.diastolic_peak_color)):
            annotate_peaks(ax, data[f"{key}_px"], data[f"{key}_py"],
                           color=color, marker=vc.peak_marker_style,
                           size=vc.peak_marker_size,
                           fontsize=vc.peak_annotation_fontsize,
                           offset=vc.peak_annotation_offset,
                           show_annotations=vc.show_peak_annotations)

    @staticmethod
    def _plot_waveform(ax, waveform_data, waveform_times, cc_method: str,
                       sampling_rate: Optional[int]) -> None:
        wf = np.asarray(waveform_data)
        if "ecg" in cc_method and sampling_rate:
            wf = fix_ecg(wf, sampling_rate)
        times = (np.asarray(waveform_times) if waveform_times is not None
                 else np.arange(wf.size) / (sampling_rate or 1))
        ax.plot(times, wf, lw=0.8)
        ax.set_ylabel("Waveform")

    def _save(self, fig, plt, save_path: str) -> None:
        safe_makedir(os.path.dirname(save_path) or ".")
        fig.tight_layout()
        fig.savefig(save_path)
        if not self.vis_config.show_img:
            plt.close(fig)

    def plot_peak_line_radlong(self, hi_rad, lo_rad, hi_long, lo_long,
                               frame_times, sys_frames, dia_frames,
                               nframes: int, param: str, param_unit: str,
                               label: str, save_path: str,
                               cc_method: str = "angle",
                               rad_peak_data: Optional[Dict] = None,
                               long_peak_data: Optional[Dict] = None,
                               waveform_data=None, waveform_times=None,
                               sampling_rate: Optional[int] = None,
                               print_report: Optional[bool] = None,
                               return_statistics: Optional[bool] = None):
        """Radial + longitudinal S/e'/l'/a' peak plot. Computes peaks if
        not supplied (reference :495-517); waveform subplot when cc_method
        is gated (:521); returns the 18-tuple when return_statistics."""
        import matplotlib
        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        from .plotting_utils import add_systole_diastole_shading

        print_report = (self.vis_config.print_report
                        if print_report is None else print_report)
        return_statistics = (self.vis_config.return_statistics
                             if return_statistics is None
                             else return_statistics)

        if rad_peak_data is None:
            rad_peak_data = self.radlong_peak_data(
                hi_rad, lo_rad, frame_times, sys_frames, dia_frames, nframes,
                cc_method=cc_method)
        if long_peak_data is None:
            long_peak_data = self.radlong_peak_data(
                hi_long, lo_long, frame_times, sys_frames, dia_frames,
                nframes, cc_method=cc_method)

        show_waveform = (waveform_data is not None and
                         cc_method in ("ecg", "ecg_lazy", "arterial"))
        nrows = 3 if show_waveform else 2
        fig, axes = plt.subplots(nrows=nrows, ncols=1, figsize=(10, 4 * nrows),
                                 sharex=False)

        frame_times = np.asarray(frame_times)
        for ax, data, name in ((axes[0], rad_peak_data, "Radial"),
                               (axes[1], long_peak_data, "Longitudinal")):
            ax.plot(frame_times, data["filt_hi"], label="hi percentile")
            ax.plot(frame_times, data["filt_lo"], label="lo percentile")
            self._annotate(ax, data)
            if self.vis_config.show_sysdia_shading:
                src = (rad_peak_data
                       if self.vis_config.true_sysdia_mode == "radial"
                       else long_peak_data)
                add_systole_diastole_shading(ax, frame_times, src["true_sys"],
                                             src["true_dia"], nframes)
            ax.set_title(f"{name} {param.capitalize()} Peaks")
            ax.set_ylabel(f"{param.capitalize()} ({param_unit})")
            ax.legend(loc="lower right", fontsize=8)
        axes[nrows - 1].set_xlabel("Time (s)")

        if show_waveform:
            self._plot_waveform(axes[2], waveform_data, waveform_times,
                                cc_method, sampling_rate)

        if print_report:
            self._print_report(
                self._calculate_peak_statistics(rad_peak_data,
                                                long_peak_data),
                label, param, prefixes=("rad_", "long_"))
        self._save(fig, plt, save_path)

        if return_statistics:
            return self.radlong_statistics(rad_peak_data, long_peak_data)
        return fig

    def plot_peak_line(self, filt_arr, frame_times, sys_frames, dia_frames,
                       nframes: int, param: str, param_unit: str, label: str,
                       save_path: str, cc_method: str = "angle",
                       mode: str = "", peak_data: Optional[Dict] = None,
                       waveform_data=None, waveform_times=None,
                       sampling_rate: Optional[int] = None,
                       print_report: Optional[bool] = None,
                       return_statistics: Optional[bool] = None):
        """Single-trace peak plot; 9-tuple return (reference :765-1043).
        Cycle shading is suppressed in mode='otsu' (:964)."""
        import matplotlib
        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        from .plotting_utils import add_systole_diastole_shading

        print_report = (self.vis_config.print_report
                        if print_report is None else print_report)
        return_statistics = (self.vis_config.return_statistics
                             if return_statistics is None
                             else return_statistics)

        if peak_data is None:
            peak_data = self.single_peak_data(
                filt_arr, frame_times, sys_frames, dia_frames, nframes,
                cc_method=cc_method)

        show_waveform = (waveform_data is not None and
                         cc_method in ("ecg", "ecg_lazy", "arterial"))
        nrows = 2 if show_waveform else 1
        fig, axes = plt.subplots(nrows=nrows, ncols=1, figsize=(10, 4 * nrows))
        ax = axes[0] if show_waveform else axes

        frame_times = np.asarray(frame_times)
        ax.plot(frame_times, peak_data["filt_arr"], label=f"{param} trace")
        self._annotate(ax, peak_data)
        if self.vis_config.show_sysdia_shading and mode != "otsu":
            add_systole_diastole_shading(ax, frame_times,
                                         peak_data["true_sys"],
                                         peak_data["true_dia"], nframes)
        ax.set_title(f"{label} {param.capitalize()} Peaks")
        ax.set_ylabel(f"{param.capitalize()} ({param_unit})")
        ax.set_xlabel("Time (s)")
        ax.legend(loc="lower right", fontsize=8)

        if show_waveform:
            self._plot_waveform(axes[1], waveform_data, waveform_times,
                                cc_method, sampling_rate)
            axes[1].set_xlabel("Time (s)")

        if print_report:
            self._print_report(
                self._calculate_single_peak_statistics(peak_data), label,
                param, prefixes=("",))
        self._save(fig, plt, save_path)

        if return_statistics:
            return self.single_statistics(peak_data)
        return fig
