"""The PyTorch port's WASE, waveforms, dataset and cohort row against the
JAX package's, on the CPU and the same seeded numpy inputs.

  * WASE against both JAX functions: float32 sums over the clip in
    another order, so the background may differ in its last bits; bound
    1e-6 px on unit-scale flow (and against a float64 background);
  * load_all_waveforms: equal results, with the ABP fallback and the flat
    and range rejections;
  * process_video(mode="RVIO_2class", bkgd_comp="WASE",
    include_waveforms=True) from an in-memory clip, port and JAX with one
    stub label callable: masks, echo and waveforms bit for bit, the flow
    within tests/test_torch_pipeline.py's bounds;
  * the dataset from a file and from the in-memory layout, equal to each
    other and to the JAX dataset;
  * analyze_cohort_file's 69 values against the JAX row on the gated clip
    of tests/test_viz_batch.py and on its no-ART twin (metadata and
    integers equal, floats within 1e-5 relative; the zero-filled sections
    exactly zero), and run_cohort_analysis' CSV against the JAX CSV.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the JAX reference runs on the CPU)

from tee_optical_flow_torch.batch import cohort as t_cohort
from tee_optical_flow_torch.config import (
    AnalysisConfig as TAnalysisConfig,
    OpticalFlowCalculationConfig as TorchConfig,
)
from tee_optical_flow_torch.dataset import OpticalFlowDataset as TDataset
from tee_optical_flow_torch.exceptions import ConfigurationError
from tee_optical_flow_torch.flow import pipeline as t_pipe
from tee_optical_flow_torch.io import hdf5 as t_hdf5
from tee_optical_flow_torch.io import waveforms as t_wf
from tee_optical_flow_tpu.batch import cohort as j_cohort
from tee_optical_flow_tpu.config import (
    AnalysisConfig as JAnalysisConfig,
    OpticalFlowCalculationConfig as JaxConfig,
)
from tee_optical_flow_tpu.dataset import OpticalFlowDataset as JDataset
from tee_optical_flow_tpu.flow import pipeline as j_pipe
from tee_optical_flow_tpu.io import waveforms as j_wf

torch.set_num_threads(1)

# tests/test_torch_segment.py's reduced config with bilinear warps and
# fixed iteration counts: the JAX solve's compile is most of this file's
# time (15.7 s against 22.6)
REDUCED = dict(min_mask_size=50, tvl1_nscales=3, tvl1_zoom_factor=0.5,
               tvl1_warps=3, tvl1_outer_iterations=2,
               tvl1_inner_iterations=15, tvl1_median_filtering=False,
               tvl1_interpolation="bilinear", tvl1_epsilon=0.0)
ROW_RTOL = 1e-5


def _ecg(seconds=2.0, beats=(0.25, 1.25), rate=500):
    t = np.arange(int(seconds * rate)) / rate
    ecg = 0.05 * np.sin(2 * np.pi * 0.4 * t)
    for beat in beats:
        c = int(beat * rate)
        ecg[c - 10:c + 11] += 1.2 * np.hanning(21)
    return ecg


def _abp(seconds=2.0, rate=125):
    t = np.arange(int(seconds * rate)) / rate
    return 80 + 20 * np.sin(2 * np.pi * 1.0 * (t - 0.3))


# --- WASE ------------------------------------------------------------------

def test_wase_matches_both_jax_functions(rng):
    flow = rng.normal(size=(5, 16, 20, 2)).astype(np.float32)
    flow[np.abs(flow) < 0.3] = 0.0
    flow[2] = 0.0  # no nonzero entry under the mask: background 0
    bkgd = rng.uniform(size=(6, 16, 20)) < 0.5
    bkgd4 = np.repeat(bkgd[..., None], 2, axis=3)
    bits = np.packbits(bkgd)
    ref = np.asarray(j_pipe._wase_background(flow, bkgd4))
    ref_p = np.asarray(j_pipe._wase_background_packed(flow, bits,
                                                      bkgd.shape))
    tf = torch.from_numpy(flow)
    got = {"(N,H,W,2)": t_pipe.wase_background(tf, torch.from_numpy(bkgd4)),
           "(N,H,W)": t_pipe.wase_background(tf, torch.from_numpy(bkgd)),
           "packed": t_pipe.wase_background_packed(tf, bits, bkgd.shape)}
    b_sum = bkgd.sum(axis=0).astype(np.float64)[..., None]
    f64 = flow.astype(np.float64)
    bg64 = ((f64 * b_sum).sum(axis=(1, 2, 3))
            / np.maximum(((f64 != 0) * b_sum).sum(axis=(1, 2, 3)), 1))
    for name, g in got.items():
        g = g.numpy()
        np.testing.assert_allclose(g, ref, rtol=0, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(g, ref_p, rtol=0, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(g, f64 - bg64[:, None, None, None],
                                   rtol=0, atol=1e-6, err_msg=name)
        np.testing.assert_array_equal(g[2], flow[2])
    assert np.abs(bg64).max() > 1e-3  # a background was subtracted


# --- waveforms -------------------------------------------------------------

def _write_waveforms(folder, base, **arrays):
    os.makedirs(folder, exist_ok=True)
    for suffix, arr in arrays.items():
        np.save(os.path.join(folder, f"{base}_{suffix}.npy"), arr)


@pytest.mark.parametrize("case", ["abp_fallback", "all_valid", "none",
                                  "flat_art_and_abp"])
def test_load_all_waveforms_matches_jax(tmp_path, case):
    folder = str(tmp_path / case)
    flat = np.full(250, 90.0)
    files = {
        # ART flat -> ABP; PAP too high, CVP too negative: rejected
        "abp_fallback": dict(II=_ecg(), ART=flat, ABP=_abp(),
                             PAP=_abp() + 40, CVP=_abp() * 0 - 20),
        "all_valid": dict(II=_ecg(), ART=_abp(), PAP=_abp() * 0.3,
                          CVP=_abp() * 0.1),
        "none": {},
        "flat_art_and_abp": dict(ART=flat, ABP=flat, PAP=flat * 0.3),
    }[case]
    _write_waveforms(folder, "clip_7", **files)
    got = t_wf.load_all_waveforms("/data/clip_7.dcm", folder,
                                  TorchConfig(), verbose=True)
    ref = j_wf.load_all_waveforms("/data/clip_7.dcm", folder, JaxConfig(),
                                  verbose=True)
    assert got.keys() == ref.keys() == {"ecg", "art", "cvp", "pap"}
    for name in got:
        assert got[name][0] == ref[name][0], name
        if ref[name][1] is None:
            assert got[name][1] is None
        else:
            np.testing.assert_array_equal(got[name][1], ref[name][1])
    if case == "abp_fallback":
        assert got["art"][0] and not got["pap"][0] and not got["cvp"][0]
        np.testing.assert_array_equal(got["art"][1], _abp())


# --- process_video with WASE and waveforms -----------------------------------

def _stub_labels(frames):
    """(N, H, W, 3) uint8 -> labels: 1 (rv) on the bright blob, 2 (av) on
    its rim, 0 elsewhere (tests/test_torch_segment.py)."""
    g = np.asarray(frames)[..., 0].astype(np.int32)
    return np.where(g > 150, 1, np.where(g > 60, 2, 0)).astype(np.uint8)


def _clip(rng, n=8, h=48, w=48):
    clip = (rng.uniform(size=(n, h, w)) * 40).astype(np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(n):
        blob = np.exp(-((yy - h // 2) ** 2 + (xx - w // 4 - i) ** 2)
                      / (2 * 8.0 ** 2))
        clip[i] = np.clip(clip[i] + blob * 215, 0, 255).astype(np.uint8)
    return np.repeat(clip[..., None], 3, axis=-1)


@pytest.mark.parametrize("waveforms", ["ecg_art", "none_valid"])
def test_process_video_wase_waveforms_matches_jax(tmp_path, waveforms):
    import h5py

    folder = str(tmp_path / "wf")
    if waveforms == "ecg_art":
        _write_waveforms(folder, "mem", II=_ecg(), ART=_abp())
    else:  # only a flat ART: neither ECG nor ART valid, none saved
        _write_waveforms(folder, "mem", ART=np.full(250, 90.0))
    meta = {"pixel_spacing": 0.05, "frame_rate": 30.0, "R_times": None,
            "R_wave_data_present": False}
    kw = dict(verbose=False, mode="RVIO_2class", no_saliency=True,
              OF_algo="TVL1", bkgd_comp="WASE", include_waveforms=True,
              waveform_folder=folder, _clip_override=_clip(
                  np.random.default_rng(7)), _metadata_override=meta)
    out_t, out_j = str(tmp_path / "t.hdf5"), str(tmp_path / "j.hdf5")
    t_pipe.process_video("mem.dcm", out_t, _stub_labels,
                         config=TorchConfig(**REDUCED), device="cpu", **kw)
    j_pipe.process_video("mem.dcm", out_j, _stub_labels,
                         config=JaxConfig(**REDUCED), **kw)
    with h5py.File(out_t, "r") as ft, h5py.File(out_j, "r") as fj:
        assert sorted(ft.keys()) == sorted(fj.keys())
        names = ["rv", "av", "bkgd", "echo"]
        if waveforms == "ecg_art":
            names += ["ecg", "art"]
            assert ft["ecg"].attrs["sampling_rate"] == 500
            assert ft["art"].attrs["sampling_rate"] == 125
        else:
            assert "ecg" not in ft and "art" not in ft
        for name in names:
            np.testing.assert_array_equal(ft[name][()], fj[name][()], name)
        assert ft["bkgd"][()].any()
        for key in ("nframes", "mode", "labels", "waveforms_present",
                    "units_converted"):
            np.testing.assert_array_equal(ft["flow"].attrs[key],
                                          fj["flow"].attrs[key])
        assert bool(ft["flow"].attrs["waveforms_present"]) == \
            (waveforms == "ecg_art")
        a = ft["flow"][()].astype(np.float32)
        b = fj["flow"][()].astype(np.float32)
    epe = np.hypot(a[..., 0] - b[..., 0], a[..., 1] - b[..., 1])
    assert epe.mean() < 0.01 and epe.max() < 0.05, (epe.mean(), epe.max())


def test_wase_needs_a_segmentor_mode(tmp_path):
    with pytest.raises(ConfigurationError, match="otsu"):
        t_pipe.process_video("mem.dcm", str(tmp_path / "x.hdf5"), None,
                             mode="otsu", bkgd_comp="WASE", device="cpu",
                             _clip_override=_clip(np.random.default_rng(0)))


# --- dataset and cohort row --------------------------------------------------

def _gated_arrays(art=True, n=40, h=24, w=24, frame_rate=20.0):
    """The gated clip of tests/test_viz_batch.py (rv + av masks, a
    synthetic ECG and, unless ``art`` is False, an ABP pair) as the
    writer's arguments."""
    rng = np.random.default_rng(5)
    flow = rng.normal(scale=0.5, size=(n, h, w, 2)).astype(np.float32)
    t = np.arange(n) / frame_rate
    flow[..., 1] += np.sin(2 * np.pi * 1.0 * t)[:, None, None]
    echo = rng.uniform(size=(n, h, w)).astype(np.float32)
    masks = {"rv": np.zeros((n, h, w, 2), np.uint8),
             "av": np.zeros((n, h, w, 2), np.uint8)}
    masks["rv"][:, 4:20, 4:20, :] = 1
    masks["av"][:, 10:14, 10:14, :] = 1
    meta = {"frame_rate": frame_rate, "pixel_spacing": 0.05,
            "R_wave_data_present": False}
    waveforms = {"ecg": (True, _ecg()),
                 "art": (True, _abp()) if art else (False, None),
                 "cvp": (False, None), "pap": (False, None)}
    kw = dict(mode="RVIO_2class", no_saliency=True, include_waveforms=True,
              patient_id="G1" if art else "G2")
    return (flow, echo, masks, meta, waveforms), kw


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """{name: (hdf5 path, in-memory layout)} for the gated clip and its
    no-ART twin, each in a folder of its own."""
    out = {}
    for name, art in (("gated", True), ("noart", False)):
        args, kw = _gated_arrays(art)
        path = str(tmp_path_factory.mktemp(name) / f"{name}.hdf5")
        t_hdf5.save_optical_flow_hdf5(path, *args, **kw)
        out[name] = (path, t_hdf5.optical_flow_layout(*args, **kw))
    return out


_DS_ATTRS = ("filename", "nframes", "mode", "RTimePresent",
             "waveforms_present", "units_converted_flag", "frame_rate",
             "pixel_spacing", "ID", "cvp_exists", "pap_exists",
             "accepted_labels", "accepted_params")


@pytest.mark.parametrize("name", ["gated", "noart"])
def test_dataset_file_and_memory_equal(clips, name):
    path, layout = clips[name]
    mem = TDataset(path, _file_override=layout)
    with TDataset(path) as f, JDataset(path) as j:
        for other in (f, j):
            for attr in _DS_ATTRS:
                assert getattr(mem, attr) == getattr(other, attr), attr
            for attr in ("vel_array", "accel_array", "pwr_array"):
                np.testing.assert_array_equal(getattr(mem, attr),
                                              getattr(other, attr))
            np.testing.assert_array_equal(mem.get_echo(), other.get_echo())
            np.testing.assert_array_equal(mem.ecg, other.ecg)
            assert int(mem.ecg_sampling_rate) == int(other.ecg_sampling_rate)
            assert hasattr(mem, "art") == hasattr(other, "art")
            for param in ("velocity", "acceleration", "PWR"):
                np.testing.assert_array_equal(
                    mem.get_masked_arr(param, "rv"),
                    other.get_masked_arr(param, "rv"))
            assert mem._param_unit("PWR") == other._param_unit("PWR")
    assert mem.vel_array.dtype == np.float32 and mem.nframes == 38
    dev = mem.device_masked_arr("acceleration", "av", device="cpu")
    np.testing.assert_array_equal(dev.numpy(),
                                  mem.get_masked_arr("acceleration", "av"))
    assert mem.device_masked_arr("velocity", "nope", device="cpu") is None
    assert mem.get_masked_arr("speed", "rv") is None
    lazy = TDataset(path, keep_file_open=True)
    np.testing.assert_array_equal(lazy.get_mask("av"), mem.get_mask("av"))
    lazy.close()


@pytest.fixture(scope="module")
def jax_rows(clips, tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_rows")
    return {name: j_cohort.analyze_cohort_file(
        path, param="velocity", label="rv", save_dir=str(out / name),
        analysis_config=JAnalysisConfig(nbins=32))
        for name, (path, _) in clips.items()}


def _assert_rows_equal(got, ref):
    assert len(got) == len(ref) == 69
    assert got[:15] == ref[:15]  # filename .. PAP: the metadata
    for i, (g, r) in enumerate(zip(got, ref)):
        if i < 15:
            continue
        if isinstance(r, (int, np.integer)) and not isinstance(r, bool):
            assert g == r, (i, g, r)
        elif r == 0:
            assert g == 0, (i, g)
        else:
            assert abs(g - r) <= ROW_RTOL * abs(r), (i, g, r)


@pytest.mark.parametrize("name", ["gated", "noart"])
def test_cohort_row_matches_jax(clips, jax_rows, tmp_path, name):
    path, _ = clips[name]
    row = t_cohort.analyze_cohort_file(
        path, param="velocity", label="rv", save_dir=str(tmp_path),
        analysis_config=TAnalysisConfig(nbins=32), device="cpu")
    ref = jax_rows[name]
    _assert_rows_equal(row, ref)
    if name == "noart":
        assert all(v == 0 for v in row[24:33] + row[51:69])
        assert any(v != 0 for v in row[15:24])
        assert any(v != 0 for v in row[33:51])
    else:
        assert row[23] >= 1 and row[32] >= 1  # n_cycles, both gates
    plots = os.listdir(tmp_path / "plots")
    assert f"{name}._ecg_lazy_velocity_rv_total.png" in plots
    assert (f"{name}._arterial_velocity_rv_radlong.png" in plots) == \
        (name == "gated")


def test_cohort_row_needs_no_matplotlib(clips, jax_rows, tmp_path,
                                        monkeypatch):
    """Without matplotlib the in-memory row is still made; the plotting
    entry fails loudly instead of skipping its plots."""
    path, layout = clips["gated"]
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    ds = TDataset(path, _file_override=layout)
    sections, peaks = t_cohort._cohort_row(
        ds, "velocity", "rv", TAnalysisConfig(nbins=32), device="cpu")
    _assert_rows_equal(t_cohort._assemble_row(ds, sections),
                       jax_rows["gated"])
    assert set(peaks) == {"ecg_total", "art_total", "ecg_radlong",
                          "art_radlong"}
    with pytest.raises(ImportError):
        t_cohort.analyze_cohort_file(path, save_dir=str(tmp_path),
                                     device="cpu")


def test_cohort_csv_matches_jax(clips, tmp_path):
    import pandas as pd

    folder = os.path.dirname(clips["gated"][0])
    csv = {}
    for name, mod in (("torch", t_cohort), ("jax", j_cohort)):
        save_dir = str(tmp_path / name)
        kw = dict(nchunks=1, chunk_index=0, verbose=False)
        if name == "torch":
            kw["device"] = "cpu"
        # analyze_cohort_file's default nbins (1000), as the CLI runs it
        assert mod.run_cohort_analysis(folder, save_dir, ["velocity"],
                                       ["rv"], **kw) == []
        csv[name] = pd.read_csv(os.path.join(save_dir, "csv",
                                             "rv_velocity_data.csv"))
    got, ref = csv["torch"], csv["jax"]
    assert list(got.columns) == list(ref.columns)
    assert got.shape == ref.shape == (1, 69)
    for col in ref.columns:
        if ref[col].dtype.kind == "f":
            np.testing.assert_allclose(got[col], ref[col], rtol=ROW_RTOL,
                                       atol=0, err_msg=col)
        else:
            assert got[col].tolist() == ref[col].tolist(), col
