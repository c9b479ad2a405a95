"""End-to-end analysis CLI: one HDF5 -> peak plots / heatmaps / videos
(the JAX package's cli/peak_plots.py).

Parity with the reference's example_peak_plots.py:54-556:
same flags, the ecg/arterial -> 'angle' fallback when waveforms are
missing (:140-157), total-magnitude single-peak pipeline (:195-219), the
radial/longitudinal pipeline gated on the 'av' label (:231-274), optional
heatmaps (:384-451) and overlay videos (:454-549).

The compute and the drawing are apart: ``analyze_clip`` computes every
array the artifacts show, on ``--device`` (``cuda`` by default), without
matplotlib; ``main`` opens the file, calls it and draws. The AV
centroid track is labelled once and serves both the radial/longitudinal
histograms and the video (the JAX command labels it twice, with the same
arguments).
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np

logger = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Generate peak line plots from HDF5 optical flow files")
    parser.add_argument("hdf5_filepath", type=str)
    parser.add_argument("--output_dir", type=str, default="output")
    parser.add_argument("--cc_method", type=str, default="angle",
                        choices=["angle", "area", "ecg", "ecg_lazy",
                                 "arterial", "metadata"])
    parser.add_argument("--param", type=str, default="velocity",
                        choices=["velocity", "acceleration", "PWR"])
    parser.add_argument("--label", type=str, default="rv")
    parser.add_argument("--cc_label", type=str, default="rv_inner")
    parser.add_argument("--percentile", type=int, default=99)
    parser.add_argument("--smooth_fraction", type=float, default=0.5)
    parser.add_argument("--nbins", type=int, default=1000)
    parser.add_argument("--show_sysdia", action="store_true")
    parser.add_argument("--show_all_peaks", action="store_true")
    parser.add_argument("--generate_heatmaps", action="store_true")
    parser.add_argument("--generate_videos", action="store_true")
    parser.add_argument("--video_dir", type=str, default=None)
    parser.add_argument("--fps", type=int, default=30)
    parser.add_argument("--no_av_filter", action="store_true")
    parser.add_argument("--av_savgol_window", type=int, default=10)
    parser.add_argument("--av_savgol_poly", type=int, default=4)
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="where the analysis computes")
    return parser


def analyze_clip(ds, args, device=None) -> dict:
    """What the command draws, computed on ``device`` (``cuda`` unless the
    caller asks for ``cpu``): the detector (with the angle fallback when
    the gating waveform is missing), the cycles, the magnitude/angle pack
    and the smoothed high-percentile trace; with an 'av' label the
    radial/longitudinal pack; with ``args.generate_videos`` also the
    centroid track and the radial/longitudinal arrays, left on the
    device. ``args`` holds build_parser()'s fields."""
    from ..analysis import calculate_3dhist
    from ..analysis.centroid import calc_AV_centroid
    from ..analysis.components import calculate_comp_magnitude
    from ..analysis.histograms import _radlong_hists
    from ..config import CardiacCycleConfig, ProcessingConfig
    from ..signal.cycles import create_detector
    from ..signal.smoother import spectral_smooth

    # detector selection with waveform fallback (reference :136-159)
    cc_method = args.cc_method
    if cc_method in ("ecg", "ecg_lazy") and not hasattr(ds, "ecg"):
        logger.warning("no ECG waveform; falling back to cc_method=angle")
        cc_method = "angle"
    if cc_method == "arterial" and not hasattr(ds, "art"):
        logger.warning("no ART waveform; falling back to cc_method=angle")
        cc_method = "angle"
    cc_label = (args.cc_label if args.cc_label in ds.accepted_labels
                else ds.accepted_labels[0])
    label = (args.label if args.label in ds.accepted_labels
             else ds.accepted_labels[0])

    detector = create_detector(cc_method, CardiacCycleConfig(), None,
                               ProcessingConfig(recalculate=True), device)
    if cc_method == "angle":
        sys_frames, dia_frames = detector.detect(ds, args.param, cc_label)
    elif cc_method == "area":
        sys_frames, dia_frames = detector.detect(ds, cc_label)
    elif cc_method == "metadata":
        sys_frames, dia_frames = detector.detect(ds)
    elif cc_method in ("ecg", "ecg_lazy"):
        sys_frames, dia_frames = detector.detect(
            ds, ds.ecg, int(ds.ecg_sampling_rate))
    else:
        sys_frames, dia_frames = detector.detect(
            ds, ds.art, int(ds.art_sampling_rate))
    logger.info("detected %d systole / %d diastole intervals",
                len(sys_frames), len(dia_frames))

    # total-magnitude pipeline (reference :195-219)
    masked = ds.device_masked_arr(args.param, label, device)
    mag, ang, mag_edges, ang_edges, perc_hi = calculate_3dhist(
        masked, ds.nframes, nbins=args.nbins, percentile=args.percentile)
    gated_ecg = "ecg" in cc_method and hasattr(ds, "ecg")
    gated_art = cc_method == "arterial" and hasattr(ds, "art")
    out = dict(
        cc_method=cc_method, label=label, cc_label=cc_label,
        sys_frames=sys_frames, dia_frames=dia_frames,
        mag=mag, ang=ang, mag_edges=mag_edges, ang_edges=ang_edges,
        perc_hi=perc_hi,
        filt=spectral_smooth(perc_hi, args.smooth_fraction, 20),
        frame_times=np.arange(ds.nframes) / ds.frame_rate,
        unit=ds._param_unit(args.param),
        waveform=(getattr(ds, "ecg", None) if "ecg" in cc_method else
                  getattr(ds, "art", None) if cc_method == "arterial"
                  else None),
        sampling_rate=(int(ds.ecg_sampling_rate) if gated_ecg else
                       int(ds.art_sampling_rate) if gated_art else None),
        radlong=None)

    # radial/longitudinal pipeline, gated on the 'av' label (:231-274);
    # calculate_3dhist_radlong's steps at its default percentiles, with
    # the centroid track kept for the video
    if "av" in ds.accepted_labels:
        centroids = calc_AV_centroid(
            ds.get_mask("av"), ds.nframes, filter=not args.no_av_filter,
            savgol_window=args.av_savgol_window,
            savgol_poly=args.av_savgol_poly, device=masked.device)
        rad_arr, long_arr = calculate_comp_magnitude(masked, centroids)
        out["radlong"] = _radlong_hists(rad_arr, long_arr, ds.nframes,
                                        args.nbins, 1, 99)
        if args.generate_videos:
            out.update(centroids=centroids, rad_arr=rad_arr,
                       long_arr=long_arr)
    return out


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)

    from ..config import (
        PeakDetectionConfig, ProcessingConfig, VisualizationConfig,
    )
    from ..core import resolve_device
    from ..dataset import OpticalFlowDataset
    from ..utils import safe_makedir
    from ..viz.manager import VisualizationManager

    device = resolve_device(args.device)
    safe_makedir(args.output_dir)
    video_dir = args.video_dir or os.path.join(args.output_dir, "videos")

    with OpticalFlowDataset(args.hdf5_filepath) as ds:
        res = analyze_clip(ds, args, device)
        cc_method, label = res["cc_method"], res["label"]
        sys_frames, dia_frames = res["sys_frames"], res["dia_frames"]
        frame_times, unit = res["frame_times"], res["unit"]
        wf, sr = res["waveform"], res["sampling_rate"]
        stem = os.path.join(args.output_dir,
                            f"{ds.filename}_{label}_{args.param}")

        vis = VisualizationConfig(
            save_dir=args.output_dir, show_sysdia_shading=args.show_sysdia,
            fps=args.fps, print_report=True, return_statistics=False)
        peak_cfg = PeakDetectionConfig(
            smooth_fraction=args.smooth_fraction,
            show_all_peaks=args.show_all_peaks, pick_peak_by_subset=True)
        manager = VisualizationManager(
            vis_config=vis, peak_config=peak_cfg,
            proc_config=ProcessingConfig(recalculate=True))

        manager.plot_peak_line(
            res["filt"], frame_times, sys_frames, dia_frames, ds.nframes,
            args.param, unit, label, f"{stem}_{cc_method}_peaks.png",
            cc_method=cc_method, mode=ds.mode, waveform_data=wf,
            sampling_rate=sr)

        data = res["radlong"]
        if data is not None:
            _f, _e, rad_hi, rad_lo = data["radial"]
            _f2, _e2, long_hi, long_lo = data["longitudinal"]
            manager.plot_peak_line_radlong(
                rad_hi, rad_lo, long_hi, long_lo, frame_times, sys_frames,
                dia_frames, ds.nframes, args.param, unit, label,
                f"{stem}_{cc_method}_radlong_peaks.png",
                cc_method=cc_method, waveform_data=wf, sampling_rate=sr)

        if args.generate_heatmaps:
            manager.plot_heatmap(
                res["mag"], res["ang"], res["mag_edges"], res["ang_edges"],
                frame_times * 1000, args.param, unit, f"{stem}_heatmap.png",
                nframes=ds.nframes, sys_frames=sys_frames,
                dia_frames=dia_frames, show_sysdia=args.show_sysdia)
            if data is not None:
                rf, re_, _rh, _rl = data["radial"]
                lf, le, _lh, _ll = data["longitudinal"]
                manager.plot_radlong_heatmap(
                    rf, lf, re_, le, frame_times * 1000, args.param, unit,
                    f"{stem}_radlong_heatmap.png",
                    sys_frames=sys_frames, dia_frames=dia_frames,
                    nframes=ds.nframes, cc_method=cc_method,
                    show_sysdia=args.show_sysdia, waveform_data=wf,
                    sampling_rate=sr)

        if args.generate_videos and data is not None:
            safe_makedir(video_dir)
            manager.visualize_radlong(
                ds.get_echo()[:ds.nframes], res["rad_arr"], res["long_arr"],
                os.path.join(video_dir, f"{ds.filename}_{label}_"
                                        f"{args.param}_radlong.mp4"),
                nframes=ds.nframes)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
