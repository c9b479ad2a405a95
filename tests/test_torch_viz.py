"""The PyTorch port's analysis commands, heatmaps, colormaps and overlay
video against the JAX package's, on the CPU and the same seeded numpy
inputs (the gated clip of tests/test_viz_batch.py: rv + av masks, a
synthetic ECG and arterial trace; and its twin without the arterial one).

  * api.analyze_optical_flow / analyze_radlong: the packs bit-equal;
    api.detect_cardiac_cycle: equal cycles for every method;
    api.plot_results: the heatmap's arrays equal;
  * cli.peak_plots.main (--device cpu) against the JAX main, with
    heatmaps and videos: the same artifact names, every figure's
    pcolormesh coordinates and values and every line's data equal, the
    video's frames equal (GIF here: no ffmpeg backend); the arterial
    gate on the clip without an arterial trace falls back to angle in
    both;
  * cli.analyze.main against the JAX main: the CSV equal, as
    tests/test_torch_cohort.py holds it (floats within 1e-5 relative);
  * colormap_lut equal to matplotlib's table for bwr and BrBG, with and
    without matplotlib;
  * radlong_overlay_frames bit-equal to the JAX package's per-frame
    expression (viz/manager.py:226-249: _overlay3 over get_colormap and
    CenteredNorm), on random arrays and on the clip's own;
  * visualize_radlong raises without imageio.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the JAX reference runs on the CPU)

from tee_optical_flow_torch import api as t_api
from tee_optical_flow_torch.cli import analyze as t_analyze
from tee_optical_flow_torch.cli import peak_plots as t_pp
from tee_optical_flow_torch.dataset import OpticalFlowDataset as TDataset
from tee_optical_flow_torch.io.hdf5 import save_optical_flow_hdf5
from tee_optical_flow_torch.viz import plotting_utils as t_pu
from tee_optical_flow_torch.viz.manager import (
    VisualizationManager as TManager, radlong_overlay_frames,
)
from tee_optical_flow_tpu import api as j_api
from tee_optical_flow_tpu.cli import analyze as j_analyze
from tee_optical_flow_tpu.cli import peak_plots as j_pp
from tee_optical_flow_tpu.dataset import OpticalFlowDataset as JDataset
from tee_optical_flow_tpu.viz.manager import VisualizationManager as JManager

torch.set_num_threads(1)

ROW_RTOL = 1e-5
METHODS = ("angle", "area", "ecg", "ecg_lazy", "arterial")


def _gated_clip(path, art=True, n=40, h=24, w=24, frame_rate=20.0):
    """tests/test_viz_batch.py's gated clip (two beats), written by the
    port's writer; without ``art`` it has no arterial trace."""
    rng = np.random.default_rng(5)
    flow = rng.normal(scale=0.5, size=(n, h, w, 2)).astype(np.float32)
    t = np.arange(n) / frame_rate
    flow[..., 1] += np.sin(2 * np.pi * 1.0 * t)[:, None, None]
    echo = rng.uniform(size=(n, h, w)).astype(np.float32)
    masks = {"rv": np.zeros((n, h, w, 2), np.uint8),
             "av": np.zeros((n, h, w, 2), np.uint8)}
    masks["rv"][:, 4:20, 4:20, :] = 1
    masks["av"][:, 10:14, 10:14, :] = 1
    ecg_t = np.arange(int(2.0 * 500)) / 500.0
    ecg = 0.05 * np.sin(2 * np.pi * 0.4 * ecg_t)
    for beat in (0.25, 1.25):
        c = int(beat * 500)
        ecg[c - 10:c + 11] += 1.2 * np.hanning(21)
    abp_t = np.arange(int(2.0 * 125)) / 125.0
    abp = 80 + 20 * np.sin(2 * np.pi * 1.0 * (abp_t - 0.3))
    meta = {"frame_rate": frame_rate, "pixel_spacing": 0.05,
            "R_wave_data_present": False}
    waveforms = {"ecg": (True, ecg),
                 "art": (True, abp) if art else (False, None),
                 "cvp": (False, None), "pap": (False, None)}
    save_optical_flow_hdf5(path, flow, echo, masks, meta, waveforms,
                           mode="RVIO_2class", no_saliency=True,
                           include_waveforms=True,
                           patient_id="G1" if art else "G2")
    return path


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    folder = tmp_path_factory.mktemp("viz")
    return {name: _gated_clip(str(folder / f"{name}.hdf5"), art=art)
            for name, art in (("gated", True), ("noart", False))}


def _equal_tree(a, b, where=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _equal_tree(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal_tree(x, y, f"{where}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=where)


# --- api ---------------------------------------------------------------------

def test_api_packs_match_jax(clips):
    from tee_optical_flow_torch.config import AnalysisConfig as TCfg
    from tee_optical_flow_tpu.config import AnalysisConfig as JCfg

    with TDataset(clips["gated"]) as t_ds, JDataset(clips["gated"]) as j_ds:
        for nbins in (32, 1000):
            got = t_api.analyze_optical_flow(t_ds, "velocity", "rv",
                                             analysis_config=TCfg(nbins=nbins),
                                             device="cpu")
            ref = j_api.analyze_optical_flow(j_ds, "velocity", "rv",
                                             analysis_config=JCfg(nbins=nbins))
            assert got["magnitude"].shape == (t_ds.nframes, nbins)
            if nbins == 1000:
                # XLA compiles the percentile's interpolation at nbins
                # 1000 with another fused multiply-add than at 32 (the
                # port copies the one of the smaller programs): the trace
                # within one float32 step, the histograms bit-equal
                np.testing.assert_array_max_ulp(
                    got.pop("percentile_high"), ref.pop("percentile_high"),
                    maxulp=1)
            _equal_tree(got, ref, f"nbins {nbins}")
        _equal_tree(t_api.analyze_radlong(t_ds, "acceleration",
                                          analysis_config=TCfg(nbins=64),
                                          device="cpu"),
                    j_api.analyze_radlong(j_ds, "acceleration",
                                          analysis_config=JCfg(nbins=64)))
        with pytest.raises(ValueError):
            t_api.analyze_optical_flow(t_ds, "velocity", "nope",
                                       device="cpu")
        with pytest.raises(ValueError):
            t_api.analyze_optical_flow(t_ds, "speed", "rv", device="cpu")


@pytest.mark.parametrize("method", METHODS)
def test_api_detect_cardiac_cycle_matches_jax(clips, method):
    with TDataset(clips["gated"]) as t_ds, JDataset(clips["gated"]) as j_ds:
        kw = {"label": "rv"} if method in ("angle", "area") else {}
        got = t_api.detect_cardiac_cycle(t_ds, method, device="cpu", **kw)
        ref = j_api.detect_cardiac_cycle(j_ds, method, **kw)
    assert [list(map(list, g)) for g in got] == \
        [list(map(list, r)) for r in ref]
    if method in ("ecg_lazy", "arterial"):
        assert len(got[0]) >= 1, got


# --- figures: what they show -------------------------------------------------

@pytest.fixture()
def figures(monkeypatch):
    """Every figure saved while the fixture lives, by file name: each
    axis' pcolormesh coordinates and values and its lines' data."""
    from matplotlib.collections import QuadMesh
    from matplotlib.figure import Figure

    seen = {}
    inner = Figure.savefig

    def savefig(fig, fname, *args, **kwargs):
        content = []
        for ax in fig.axes:
            for c in ax.collections:
                if isinstance(c, QuadMesh):
                    content.append(("mesh", np.asarray(c.get_coordinates()),
                                    np.asarray(c.get_array())))
            for line in ax.get_lines():
                content.append(("line", np.asarray(line.get_xydata())))
        seen.setdefault(os.path.basename(str(fname)), []).append(content)
        return inner(fig, fname, *args, **kwargs)

    monkeypatch.setattr(Figure, "savefig", savefig)
    return seen


def test_api_plot_results_matches_jax(clips, tmp_path, figures):
    from tee_optical_flow_torch.config import AnalysisConfig as TCfg
    from tee_optical_flow_tpu.config import AnalysisConfig as JCfg

    with TDataset(clips["gated"]) as t_ds, JDataset(clips["gated"]) as j_ds:
        t_api.plot_results(t_ds, "velocity", "rv", str(tmp_path / "t.png"),
                           analysis_config=TCfg(nbins=32), device="cpu")
        j_api.plot_results(j_ds, "velocity", "rv", str(tmp_path / "j.png"),
                           analysis_config=JCfg(nbins=32))
    assert os.path.exists(tmp_path / "t.png")
    (got,), (ref,) = figures["t.png"], figures["j.png"]
    # two panels and their colorbars
    assert [c[0] for c in got].count("mesh") == 4
    _equal_tree(got, ref)


# --- cli/peak_plots ----------------------------------------------------------

@pytest.mark.parametrize("clip,method", [
    ("gated", "angle"), ("gated", "area"), ("gated", "ecg_lazy"),
    ("gated", "arterial"), ("noart", "arterial")])
def test_peak_plots_main_matches_jax(clips, tmp_path, figures, clip,
                                     method):
    import imageio.v2 as iio

    argv = [clips[clip], "--cc_method", method, "--nbins", "64",
            "--generate_heatmaps", "--generate_videos", "--show_sysdia"]
    out = {}
    for name, main, extra in (("jax", j_pp.main, []),
                              ("torch", t_pp.main, ["--device", "cpu"])):
        out[name] = str(tmp_path / name)
        assert main(argv + ["--output_dir", out[name]] + extra) == 0
    names = {k: sorted(os.listdir(v)) for k, v in out.items()}
    assert names["torch"] == names["jax"]
    videos = {k: sorted(os.listdir(os.path.join(v, "videos")))
              for k, v in out.items()}
    assert videos["torch"] == videos["jax"] and len(videos["jax"]) == 1
    used = "angle" if clip == "noart" else method
    pngs = [n for n in names["jax"] if n.endswith(".png")]
    assert f"{clip}._rv_velocity_{used}_peaks.png" in pngs
    assert f"{clip}._rv_velocity_radlong_heatmap.png" in pngs
    for png in pngs:
        ref, got = figures[png]   # saved once by each package, in turn
        _equal_tree(got, ref, png)
    meshes = sum(c[0] == "mesh" for png in pngs for c in figures[png][0])
    assert meshes == 8  # two heatmaps: two panels and two colorbars each
    frames = {k: np.stack(iio.mimread(os.path.join(v, "videos",
                                                   videos[k][0])))
              for k, v in out.items()}
    np.testing.assert_array_equal(frames["torch"], frames["jax"])
    assert frames["jax"].shape[0] == 38


def test_peak_plots_analyze_clip_needs_no_matplotlib(clips, monkeypatch):
    """The compute half runs without matplotlib and gives the arrays the
    drawing half shows."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    args = t_pp.build_parser().parse_args(
        [clips["gated"], "--cc_method", "ecg_lazy", "--nbins", "64",
         "--generate_videos"])
    ds = TDataset(clips["gated"])
    res = t_pp.analyze_clip(ds, args, device="cpu")
    assert res["cc_method"] == "ecg_lazy" and len(res["sys_frames"]) >= 1
    assert res["mag"].shape == (38, 64) and res["filt"].shape == (38,)
    assert res["rad_arr"].shape == (38, 24, 24)
    frames = radlong_overlay_frames(ds.get_echo()[:38], res["rad_arr"],
                                    res["long_arr"], 38)
    assert frames.shape == (38, 24, 48, 3) and frames.dtype == torch.uint8


# --- cli/analyze -------------------------------------------------------------

def test_analyze_main_csv_matches_jax(clips, tmp_path):
    import pandas as pd

    folder = os.path.dirname(clips["gated"])
    csv = {}
    for name, main, extra in (("jax", j_analyze.main, []),
                              ("torch", t_analyze.main,
                               ["--device", "cpu"])):
        save_dir = str(tmp_path / name)
        assert main(["--hdf5_folder", folder, "--save_dir", save_dir]
                    + extra) == 0
        csv[name] = pd.read_csv(os.path.join(save_dir, "csv",
                                             "rv_velocity_data.csv"))
    got, ref = csv["torch"], csv["jax"]
    assert list(got.columns) == list(ref.columns)
    assert got.shape == ref.shape == (2, 69)
    for col in ref.columns:
        if ref[col].dtype.kind == "f":
            np.testing.assert_allclose(got[col], ref[col], rtol=ROW_RTOL,
                                       atol=0, err_msg=col)
        else:
            assert got[col].tolist() == ref[col].tolist(), col


# --- colormaps and the overlay -----------------------------------------------

@pytest.mark.parametrize("name", ["bwr", "BrBG"])
@pytest.mark.parametrize("hide", [False, True])
def test_colormap_lut_matches_matplotlib(name, hide, monkeypatch):
    import matplotlib

    ref = matplotlib.colormaps[name]
    table = np.asarray(ref(np.arange(ref.N)), np.float32)
    if hide:
        monkeypatch.setitem(sys.modules, "matplotlib", None)
    got = t_pu.colormap_lut(name)
    assert got.dtype == torch.float32 and got.shape == (256, 4)
    np.testing.assert_array_equal(got.numpy(), table)
    np.testing.assert_array_equal(
        t_pu.colormap_rgb_u8(name)[:256].numpy(),
        (ref(np.arange(256))[:, :3] * 255).astype(np.uint8))


def test_colormap_lut_other_names(monkeypatch):
    import matplotlib

    np.testing.assert_array_equal(
        t_pu.colormap_lut("hot", n=16).numpy(),
        np.asarray(matplotlib.colormaps["hot"].resampled(16)(np.arange(16)),
                   np.float32))
    np.testing.assert_array_equal(t_pu.colormap_lut("no_such_map").numpy(),
                                  t_pu.colormap_lut("viridis").numpy())
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        t_pu.colormap_lut("viridis")


def _jax_overlay(echo, rad, lng, nframes, rad_cmap="bwr", long_cmap="BrBG"):
    """The JAX package's visualize_radlong frame loop
    (viz/manager.py:210-249), without the writer."""
    from matplotlib.colors import CenteredNorm

    from tee_optical_flow_tpu.viz.plotting_utils import get_colormap

    echo = np.asarray(echo, np.float32)
    rad = np.asarray(rad, np.float32)
    lng = np.asarray(lng, np.float32)
    rad_norm = CenteredNorm(vcenter=0, halfrange=max(np.abs(rad).max(),
                                                     1e-6))
    long_norm = CenteredNorm(vcenter=0, halfrange=max(np.abs(lng).max(),
                                                      1e-6))
    rc, lc = get_colormap(rad_cmap), get_colormap(long_cmap)
    echo = echo - echo.min()
    if echo.max() > 0:
        echo = echo / echo.max()
    echo_u8 = (echo * 255).astype(np.uint8)
    frames = []
    for i in range(nframes):
        frame = np.repeat(echo_u8[i][..., None], 3, axis=-1)
        rad_rgb = (rc(rad_norm(rad[i]))[:, :, :3] * 255).astype(np.uint8)
        long_rgb = (lc(long_norm(lng[i]))[:, :, :3] * 255).astype(np.uint8)
        frames.append(JManager._overlay3(frame, rad_rgb, long_rgb))
    return np.stack(frames)


@pytest.mark.parametrize("scale", [3.7, 1e-3, 1e-8, 0.0])
def test_radlong_overlay_frames_match_jax_expression(scale):
    """Bit-equal, at magnitudes that take the data's halfrange and the
    1e-6 floor, with values on the table's steps."""
    rng = np.random.default_rng(11)
    echo = rng.uniform(size=(7, 30, 44)).astype(np.float16)
    rad = (rng.normal(size=(6, 30, 44)) * scale).astype(np.float32)
    lng = (rng.normal(size=(6, 30, 44)) * scale).astype(np.float32)
    top = np.float32(np.abs(rad).max())
    rad[0, 0, :9] = top * np.linspace(-1, 1, 9, dtype=np.float32)
    rad[1, :3] = 0.0
    got = radlong_overlay_frames(echo[:5], rad, lng, 5, device="cpu")
    assert got.shape == (5, 30, 88, 3) and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_overlay(echo[:5], rad, lng, 5))


def test_radlong_overlay_frames_on_the_clip(clips):
    """On the clip's own radial/longitudinal arrays (the port's
    calculate_comp_magnitude about its AV centroid track), other
    colormaps included; the manager's _overlay3 is the JAX one."""
    from tee_optical_flow_torch.analysis.centroid import calc_AV_centroid
    from tee_optical_flow_torch.analysis.components import (
        calculate_comp_magnitude,
    )

    with TDataset(clips["gated"]) as ds:
        n = ds.nframes
        cents = calc_AV_centroid(ds.get_mask("av"), n, device="cpu")
        rad, lng = calculate_comp_magnitude(
            ds.device_masked_arr("velocity", "rv", "cpu"), cents)
        echo = ds.get_echo()[:n]
    for cmaps in (("bwr", "BrBG"), ("hot", "no_such_map")):
        got = radlong_overlay_frames(echo, rad, lng, n, *cmaps)
        np.testing.assert_array_equal(
            got.numpy(), _jax_overlay(echo, rad.numpy(), lng.numpy(), n,
                                      *cmaps))
    frame = np.zeros((2, 3, 3), np.uint8)
    np.testing.assert_array_equal(
        TManager._overlay3(frame, frame + 255, frame + 8),
        JManager._overlay3(frame, frame + 255, frame + 8))


def test_visualize_radlong_needs_imageio(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    z = np.zeros((2, 4, 4), np.float32)
    with pytest.raises(ImportError, match="imageio"):
        TManager().visualize_radlong(z, z, z, str(tmp_path / "v.mp4"),
                                     device="cpu")
    assert not os.listdir(tmp_path)
