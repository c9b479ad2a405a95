"""VisualizationManager: heatmaps, the radial/longitudinal overlay
video, the peak statistics, their printed report and the S/e'/l'/a'
peak-line plots (the JAX package's viz/manager.py; reference
optical_flow/visualization.py:30-1052).

The statistics are the 9- and 18-value tuples of the cohort row
(reference :751-761, :1034-1041). They are computed without matplotlib
(``single_peak_data``, ``radlong_peak_data`` and the ``*_statistics``
methods), so a machine without it still gets the row; the plot methods
import matplotlib inside, draw, and return the same tuples.

The overlay video's frames come from ``radlong_overlay_frames``, on the
device its arrays lie on: matplotlib's ``CenteredNorm`` about 0, the
colormap lookup and the 50/50 blend with the echo (reference
:1046-1051), bit for bit; ``visualize_radlong`` writes them with imageio.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Tuple

import numpy as np

import torch

from ..config import (
    CardiacCycleConfig, PeakDetectionConfig, ProcessingConfig,
    VisualizationConfig,
)
from ..peak_detection import calculate_radlong_peaks, calculate_single_peaks
from ..core import as_device_tensor
from ..utils import fix_ecg, safe_makedir
from . import plotting_utils as pu

logger = logging.getLogger(__name__)


def _edges_for_pcolormesh(edges: np.ndarray, nbins: int) -> np.ndarray:
    """Reconstruct the dropped last edge when given nbins values
    (the calculate_3dhist_radlong quirk; reference :102-108)."""
    edges = np.asarray(edges)
    if len(edges) == nbins:
        width = edges[1] - edges[0] if len(edges) > 1 else 1.0
        edges = np.concatenate([edges, [edges[-1] + width]])
    return edges


def _frame_time_edges(frame_times: np.ndarray, nframes: int) -> np.ndarray:
    frame_times = np.asarray(frame_times)
    if len(frame_times) > 1:
        dt = frame_times[1] - frame_times[0]
        return np.linspace(frame_times[0] - dt / 2, frame_times[-1] + dt / 2,
                           nframes + 1)
    dt = 1000 / nframes if nframes > 0 else 1.0
    return np.linspace(frame_times[0] - dt / 2, frame_times[0] + dt / 2,
                       nframes + 1)


def _colormap_rgb(values: torch.Tensor, cmap: str) -> torch.Tensor:
    """``(cmap(CenteredNorm(0, max(|values|.max(), 1e-6))(values))[..., :3]
    * 255).astype(np.uint8)`` on the values' device, as matplotlib computes
    it: the norm's bounds are Python floats, so each of its two in-place
    steps is a float64 operation rounded to float32; the colormap scales
    by 256 in float32, takes the table row floor(x * 256) clipped to
    [0, 255], and NaN takes the bad colour."""
    table = pu.colormap_rgb_u8(cmap).to(values.device)
    n = table.shape[0] - 1
    h = torch.clamp(values.abs().max().to(torch.float64), min=1e-6)
    x = (values.to(torch.float64) + h).to(torch.float32)
    x = (x.to(torch.float64) / (2 * h)).to(torch.float32) * n
    idx = torch.where(torch.isnan(x), torch.full_like(x, n),
                      torch.clamp(x, 0, n - 1)).to(torch.long)
    return table[idx]


def radlong_overlay_frames(echo_arr, rad_arr, long_arr,
                           nframes: Optional[int] = None,
                           rad_cmap: str = "bwr", long_cmap: str = "BrBG",
                           device=None) -> torch.Tensor:
    """The overlay video's frames, (nframes, H, 2W, 3) uint8 on the device:
    left the echo blended 50/50 with the radial component under
    ``rad_cmap``, right with the longitudinal one under ``long_cmap``
    (reference :241-297, :1046-1051). Each component is normalised about
    0 by the largest magnitude of its whole array, the echo by its whole
    array's range, as the JAX package's visualize_radlong does. Tensors
    stay on their device unless ``device`` is given; host arrays go to
    ``device`` (``cuda`` by default)."""
    rad = as_device_tensor(rad_arr, device).to(torch.float32)
    dev = rad.device
    lng = as_device_tensor(long_arr, dev).to(torch.float32)
    echo = as_device_tensor(echo_arr, dev).to(torch.float32)
    nframes = nframes or rad.shape[0]

    echo = echo - echo.min()
    top = echo.max()
    echo = torch.where(top > 0, echo / top, echo)
    echo_u8 = (echo[:nframes] * 255).to(torch.uint8)
    frame = echo_u8[..., None].to(torch.int16)

    def blend(rgb: torch.Tensor) -> torch.Tensor:
        # (0.5 * a + 0.5 * b).astype(np.uint8) of two uint8 values is
        # exact in float64: floor((a + b) / 2)
        return ((frame + rgb[:nframes].to(torch.int16)) // 2).to(torch.uint8)

    return torch.cat([blend(_colormap_rgb(rad, rad_cmap)),
                      blend(_colormap_rgb(lng, long_cmap))], dim=2)


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
    # heatmaps
    # ------------------------------------------------------------------

    def plot_radlong_heatmap(self, rad_mag_freq_arr, long_mag_freq_arr,
                             rad_mag_edges, long_mag_edges, frame_times,
                             param: str, param_unit: str, save_path: str,
                             waveform_data=None, waveform_times=None,
                             sampling_rate: Optional[int] = None,
                             sys_frames=None, dia_frames=None,
                             nframes: Optional[int] = None,
                             cc_method: str = "angle",
                             show_sysdia: bool = False):
        """Radial + longitudinal LogNorm frequency heatmaps over time
        (reference :40-144)."""
        from matplotlib.colors import LogNorm

        plt = pu.pyplot()
        if os.path.exists(save_path) and not self.proc_config.recalculate:
            logger.info("%s already exists, skipping!", save_path)
            return None

        nframes = nframes or np.asarray(rad_mag_freq_arr).shape[0]
        show_waveform = waveform_data is not None and show_sysdia
        fig, axes = pu.create_heatmap_figure(show_waveform=show_waveform,
                                             show_sysdia=show_sysdia)
        if show_waveform:
            ax1, ax2, ax_t = axes
            if "ecg" in cc_method and sampling_rate:
                waveform_data = fix_ecg(waveform_data, sampling_rate)
            pu.plot_waveform_with_shading(ax_t, waveform_data,
                                          waveform_times, frame_times,
                                          sys_frames, dia_frames, nframes)
        elif show_sysdia:
            ax1, ax2, ax_t = axes
            pu.add_systole_diastole_shading(ax_t, frame_times, sys_frames,
                                            dia_frames, nframes)
            ax_t.set_xlabel("Time (ms)")
        else:
            ax1, ax2 = axes
            ax2.set_xlabel("Time (ms)")

        nbins = np.asarray(rad_mag_freq_arr).shape[1]
        rad_edges = _edges_for_pcolormesh(rad_mag_edges, nbins)
        long_edges = _edges_for_pcolormesh(long_mag_edges, nbins)
        t_edges = _frame_time_edges(frame_times, nframes)

        for ax, freq, edges, title in (
                (ax1, np.asarray(rad_mag_freq_arr), rad_edges, "Radial"),
                (ax2, np.asarray(long_mag_freq_arr), long_edges,
                 "Longitudinal")):
            norm = LogNorm(vmin=np.min(freq), vmax=np.max(freq))
            mesh = ax.pcolormesh(t_edges, edges, freq.T, norm=norm,
                                 cmap=self.vis_config.colormap_mag)
            ax.set_ylabel(f"{param.capitalize()} ({param_unit})")
            ax.set_title(f"{title} {param.capitalize()} vs Time (ms)")
            pu.setup_colorbar(mesh, ax, "log(freq)")
        if self.vis_config.invert_rad_yaxis:
            ax1.invert_yaxis()
        if self.vis_config.invert_long_yaxis:
            ax2.invert_yaxis()

        safe_makedir(os.path.dirname(save_path) or ".")
        fig.savefig(save_path)
        if not self.vis_config.show_img:
            plt.close(fig)
        return fig

    def plot_heatmap(self, mag_freq_arr, ang_freq_arr, mag_edges, ang_edges,
                     frame_times, param: str, param_unit: str, save_path: str,
                     nframes: Optional[int] = None, sys_frames=None,
                     dia_frames=None, show_sysdia: bool = False):
        """Magnitude + angle (degrees) panels (reference :146-239)."""
        from matplotlib.colors import LogNorm

        plt = pu.pyplot()
        if os.path.exists(save_path) and not self.proc_config.recalculate:
            logger.info("%s already exists, skipping!", save_path)
            return None

        mag_freq_arr = np.asarray(mag_freq_arr)
        ang_freq_arr = np.asarray(ang_freq_arr)
        nframes = nframes or mag_freq_arr.shape[0]
        fig, axes = pu.create_heatmap_figure(show_sysdia=show_sysdia)
        if show_sysdia:
            ax1, ax2, ax_t = axes
            pu.add_systole_diastole_shading(ax_t, frame_times, sys_frames,
                                            dia_frames, nframes)
            ax_t.set_xlabel("Time (ms)")
        else:
            ax1, ax2 = axes
            ax2.set_xlabel("Time (ms)")
        t_edges = _frame_time_edges(frame_times, nframes)

        mesh1 = ax1.pcolormesh(
            t_edges, _edges_for_pcolormesh(mag_edges, mag_freq_arr.shape[1]),
            mag_freq_arr.T,
            norm=LogNorm(vmin=mag_freq_arr.min(), vmax=mag_freq_arr.max()),
            cmap=self.vis_config.colormap_mag)
        ax1.set_ylabel(f"{param.capitalize()} ({param_unit})")
        ax1.set_title(f"{param.capitalize()} Magnitude vs Time (ms)")
        pu.setup_colorbar(mesh1, ax1, "log(freq)")

        ang_edges_deg = np.asarray(_edges_for_pcolormesh(
            ang_edges, ang_freq_arr.shape[1])) * 180.0 / np.pi
        mesh2 = ax2.pcolormesh(
            t_edges, ang_edges_deg, ang_freq_arr.T,
            norm=LogNorm(vmin=ang_freq_arr.min(), vmax=ang_freq_arr.max()),
            cmap=self.vis_config.colormap_ang)
        ax2.set_ylabel("Angle (deg)")
        ax2.set_title("Flow Angle vs Time (ms)")
        pu.setup_colorbar(mesh2, ax2, "log(freq)")

        safe_makedir(os.path.dirname(save_path) or ".")
        fig.savefig(save_path)
        if not self.vis_config.show_img:
            plt.close(fig)
        return fig

    # ------------------------------------------------------------------
    # overlay video
    # ------------------------------------------------------------------

    @staticmethod
    def _overlay3(dcm_frame: np.ndarray, rad_rgb: np.ndarray,
                  long_rgb: np.ndarray) -> np.ndarray:
        """50/50 blend of the echo frame with each component colormap
        (reference :1046-1051). Inputs uint8 (H, W, 3); output (H, 2W, 3).
        radlong_overlay_frames computes the same for a whole clip."""
        blend_rad = (0.5 * dcm_frame + 0.5 * rad_rgb).astype(np.uint8)
        blend_long = (0.5 * dcm_frame + 0.5 * long_rgb).astype(np.uint8)
        return np.concatenate([blend_rad, blend_long], axis=1)

    def visualize_radlong(self, echo_arr, rad_arr, long_arr, save_path: str,
                          nframes: Optional[int] = None, device=None):
        """Side-by-side radial/longitudinal overlay mp4 with CenteredNorm
        bwr / BrBG colormaps (reference :241-297): the frames from
        radlong_overlay_frames on ``device`` (tensors stay on theirs),
        written with imageio; GIF where imageio has no ffmpeg backend.
        Raises ImportError without imageio."""
        try:
            import imageio.v2 as iio
        except ImportError as exc:
            raise ImportError(
                "visualize_radlong writes the video with imageio, which is "
                "not installed; radlong_overlay_frames gives its frames "
                "without it") from exc

        if os.path.exists(save_path) and not self.proc_config.recalculate:
            logger.info("%s already exists, skipping!", save_path)
            return None

        frames = radlong_overlay_frames(
            echo_arr, rad_arr, long_arr, nframes,
            self.vis_config.colormap_rad, self.vis_config.colormap_long,
            device).cpu().numpy()

        safe_makedir(os.path.dirname(save_path) or ".")
        if save_path.endswith(".mp4"):
            try:
                import imageio_ffmpeg  # noqa: F401
            except ImportError:
                # no ffmpeg backend in this environment: fall back to GIF
                save_path = save_path[:-4] + ".gif"
                logger.warning("no mp4 encoder available; writing %s",
                               save_path)
        writer_kwargs = ({"macro_block_size": 1}
                         if save_path.endswith(".mp4") else {})
        with iio.get_writer(save_path, fps=self.vis_config.fps,
                            **writer_kwargs) as writer:
            for frame in frames:
                writer.append_data(frame)
        return save_path

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
        vc = self.vis_config
        for key, color in (("sys", vc.systolic_peak_color),
                           ("e", vc.diastolic_peak_color),
                           ("l", vc.diastolic_peak_color),
                           ("a", vc.diastolic_peak_color)):
            pu.annotate_peaks(ax, data[f"{key}_px"], data[f"{key}_py"],
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
        plt = pu.pyplot()
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
                pu.add_systole_diastole_shading(
                    ax, frame_times, src["true_sys"], src["true_dia"],
                    nframes)
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
        plt = pu.pyplot()
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
            pu.add_systole_diastole_shading(ax, frame_times,
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
