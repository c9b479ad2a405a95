"""The PyTorch port's host signal code and cardiac-cycle detectors against
the JAX package's, on the CPU and the same seeded numpy inputs: peaks, ECG
cleaning and R peaks, the spectral smoother and the helpers bit-equal; the
six detectors and create_detector with equal intervals on one gated clip
(each package reading it with its own dataset); the S/e'/l'/a' peak
extraction equal; the analysis configurations' JSON round trip between
the packages."""

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the JAX reference runs on the CPU)

from tee_optical_flow_torch import config as t_cfg
from tee_optical_flow_torch import peak_detection as t_pk
from tee_optical_flow_torch.dataset import OpticalFlowDataset as TDataset
from tee_optical_flow_torch.signal import cycles as t_cyc
from tee_optical_flow_torch.signal import ecg as t_ecg
from tee_optical_flow_torch.signal import peaks as t_peaks
from tee_optical_flow_torch.signal import smoother as t_sm
from tee_optical_flow_torch.utils import helpers as t_help
from tee_optical_flow_tpu import config as j_cfg
from tee_optical_flow_tpu import peak_detection as j_pk
from tee_optical_flow_tpu.dataset import OpticalFlowDataset as JDataset
from tee_optical_flow_tpu.io.hdf5 import save_optical_flow_hdf5
from tee_optical_flow_tpu.signal import cycles as j_cyc
from tee_optical_flow_tpu.signal import ecg as j_ecg
from tee_optical_flow_tpu.signal import peaks as j_peaks
from tee_optical_flow_tpu.signal import smoother as j_sm
from tee_optical_flow_tpu.utils import helpers as j_help

torch.set_num_threads(1)


def _ecg(seconds=2.0, beats=(0.25, 1.25), rate=500):
    """The synthetic ECG of tests/test_viz_batch.py: a slow wander and a
    Hann-window R wave per beat."""
    t = np.arange(int(seconds * rate)) / rate
    ecg = 0.05 * np.sin(2 * np.pi * 0.4 * t)
    for beat in beats:
        c = int(beat * rate)
        ecg[c - 10:c + 11] += 1.2 * np.hanning(21)
    return ecg


def _signals(rng):
    """Traces with peaks, plateaus (at the edges too), a flat run and
    noise."""
    t = np.linspace(0, 4 * np.pi, 90)
    plateau = np.round(np.sin(t) * 3) / 3
    plateau[:4] = plateau[4]
    plateau[-5:] = plateau[-6]
    return [np.sin(t) + 0.1 * rng.normal(size=t.size), plateau,
            np.abs(rng.normal(size=60)).cumsum() % 3.0, np.ones(20),
            np.array([0.0, 1.0])]


def test_peaks_bit_equal(rng):
    for y in _signals(rng):
        for thres, min_dist in ((0.3, 1), (0.2, 5), (0.9, 50)):
            np.testing.assert_array_equal(
                t_peaks.peak_indexes(y, thres=thres, min_dist=min_dist),
                j_peaks.peak_indexes(y, thres=thres, min_dist=min_dist))
        if y.size > 4:
            np.testing.assert_array_equal(t_peaks.poly_baseline(y),
                                          j_peaks.poly_baseline(y))
    y = _signals(rng)[0]
    np.testing.assert_array_equal(
        t_peaks.peak_indexes(y, thres=0.5, thres_abs=True),
        j_peaks.peak_indexes(y, thres=0.5, thres_abs=True))


@pytest.mark.parametrize("rate", [500, 125])
def test_ecg_and_smoother_bit_equal(rng, rate):
    ecg = _ecg(rate=rate) + 0.01 * rng.normal(size=int(2 * rate))
    np.testing.assert_array_equal(t_ecg.ecg_clean(ecg, rate),
                                  j_ecg.ecg_clean(ecg, rate))
    got = t_ecg.detect_r_peaks(ecg, rate)
    np.testing.assert_array_equal(got, j_ecg.detect_r_peaks(ecg, rate))
    assert got.size == 2
    np.testing.assert_array_equal(
        t_ecg.detect_r_peaks(np.zeros(1000), rate),
        j_ecg.detect_r_peaks(np.zeros(1000), rate))
    np.testing.assert_array_equal(t_help.fix_ecg(ecg, rate),
                                  j_help.fix_ecg(ecg, rate))
    for frac, pad in ((0.2, 20), (0.3, 5), (0.5, 0)):
        np.testing.assert_array_equal(t_sm.spectral_smooth(ecg, frac, pad),
                                      j_sm.spectral_smooth(ecg, frac, pad))
    two = np.stack([ecg, ecg[::-1]])
    np.testing.assert_array_equal(t_sm.spectral_smooth(two),
                                  j_sm.spectral_smooth(two))


def test_helpers_equal():
    for vals in ([3, -1, 2, 0.5], [-1, -2], []):
        assert t_help.index_smallest_positive(vals) == \
            j_help.index_smallest_positive(vals)
    for arr in ([], [4], [1, 2, 3, 7, 8, 10], [0, 2, 4]):
        assert t_help.find_start_stop(np.asarray(arr)) == \
            j_help.find_start_stop(np.asarray(arr))
    times = np.arange(20) * 0.05
    intervals = [[0.0, 0.31], [0.4, 0.42], [0.5, 2.0], [3.0, 4.0]]
    assert t_help.timeinterval2index(intervals, times) == \
        j_help.timeinterval2index(intervals, times)
    assert t_help.frame2time([[0, 250], [250, 600]], 500) == \
        j_help.frame2time([[0, 250], [250, 600]], 500)


def test_analysis_configs_round_trip_between_packages(tmp_path):
    pairs = [(t_cfg.CardiacCycleConfig, j_cfg.CardiacCycleConfig),
             (t_cfg.VisualizationConfig, j_cfg.VisualizationConfig),
             (t_cfg.ProcessingConfig, j_cfg.ProcessingConfig),
             (t_cfg.PeakDetectionConfig, j_cfg.PeakDetectionConfig),
             (t_cfg.AnalysisConfig, j_cfg.AnalysisConfig),
             (t_cfg.CardiacCycleMethodConfig, j_cfg.CardiacCycleMethodConfig)]
    for tcls, jcls in pairs:
        assert tcls().to_dict() == jcls().to_dict()
    jv = j_cfg.VisualizationConfig(peak_annotation_offset=(2.0, 0.5), nbins=7)
    tv = t_cfg.VisualizationConfig.from_json(jv.to_json())
    assert tv == t_cfg.VisualizationConfig(peak_annotation_offset=(2.0, 0.5),
                                           nbins=7)
    assert j_cfg.VisualizationConfig.from_json(tv.to_json()) == jv
    for name in ("default_cardiac_cycle_config", "default_visualization_config",
                 "default_processing_config", "default_peak_detection_config",
                 "default_analysis_config", "ecg_gated_config",
                 "arterial_gated_config", "angle_detection_config",
                 "area_detection_config"):
        assert getattr(t_cfg, name)().to_dict() == \
            getattr(j_cfg, name)().to_dict(), name


@pytest.fixture(scope="module")
def gated_file(tmp_path_factory):
    """The gated 40-frame 24x24 clip of tests/test_viz_batch.py, with R-wave
    times too (the metadata detector's input), and a pulsing rv mask (the
    area detector's input)."""
    rng = np.random.default_rng(5)
    n, h, w, frame_rate = 40, 24, 24, 20.0
    flow = rng.normal(scale=0.5, size=(n, h, w, 2)).astype(np.float32)
    t = np.arange(n) / frame_rate
    flow[..., 1] += np.sin(2 * np.pi * 1.0 * t)[:, None, None]
    echo = rng.uniform(size=(n, h, w)).astype(np.float32)
    masks = {"rv": np.zeros((n, h, w, 2), np.uint8),
             "av": np.zeros((n, h, w, 2), np.uint8)}
    for i in range(n):
        r = 6 + int(round(2 * np.sin(2 * np.pi * t[i])))
        masks["rv"][i, 12 - r:12 + r, 12 - r:12 + r, :] = 1
    masks["av"][:, 10:14, 10:14, :] = 1
    abp_t = np.arange(int(2.0 * 125)) / 125.0
    abp = 80 + 20 * np.sin(2 * np.pi * 1.0 * (abp_t - 0.3))
    meta = {"frame_rate": frame_rate, "pixel_spacing": 0.05,
            "R_wave_data_present": True, "R_times": [250.0, 1250.0]}
    waveforms = {"ecg": (True, _ecg()), "art": (True, abp),
                 "cvp": (False, None), "pap": (False, None)}
    path = str(tmp_path_factory.mktemp("signal") / "gated.hdf5")
    save_optical_flow_hdf5(path, flow, echo, masks, meta, waveforms,
                           mode="RVIO_2class", no_saliency=True,
                           include_waveforms=True, patient_id="S1")
    return path


_DETECT_ARGS = {
    "angle": lambda ds: dict(param="velocity", label="rv"),
    "area": lambda ds: dict(label="rv"),
    "ecg": lambda ds: dict(ecg_arr=ds.ecg, sampling_rate=500),
    "ecg_lazy": lambda ds: dict(ecg_arr=ds.ecg, sampling_rate=500),
    "metadata": lambda ds: {},
    "arterial": lambda ds: dict(art_arr=ds.art, sampling_rate=125),
}


@pytest.mark.parametrize("method", list(_DETECT_ARGS))
def test_detectors_match_jax(gated_file, method):
    cc = j_cfg.CardiacCycleConfig()
    with JDataset(gated_file) as jds:
        ref = j_cyc.create_detector(method, cc).detect(
            jds, **_DETECT_ARGS[method](jds))
    tds = TDataset(gated_file)
    det = t_cyc.create_detector(method, t_cfg.CardiacCycleConfig(),
                                device="cpu")
    got = det.detect(tds, **_DETECT_ARGS[method](tds))
    assert [list(map(int, s)) for s in got[0]] == \
        [list(map(int, s)) for s in ref[0]]
    assert [list(map(int, s)) for s in got[1]] == \
        [list(map(int, s)) for s in ref[1]]
    assert tds.CARDIACCYCLE_CALCULATED and tds.sys_frames == got[0]
    # the angle split of this noise may be one run, and the synthetic ECG
    # has no T wave for the ecg detector to find
    if method not in ("angle", "ecg"):
        assert len(got[0]) >= 1, got
    # no recalculation: the dataset's frames come back
    again = t_cyc.create_detector(
        method, proc_config=t_cfg.ProcessingConfig(recalculate=False),
        device="cpu").detect(tds, **_DETECT_ARGS[method](tds))
    assert again == got
    with pytest.raises(ValueError):
        t_cyc.create_detector("nope")


def test_angle_mode_series_matches_jax(gated_file):
    """The per-frame mode angle, on the device twin: equal where torch's
    and XLA's atan2 put every angle in the same centi-radian bucket."""
    import jax.numpy as jnp

    tds = TDataset(gated_file)
    arr = tds.get_masked_arr("velocity", "rv")[:tds.nframes]
    got = t_cyc.angle_mode_series(torch.from_numpy(arr)).numpy()
    ref = np.asarray(j_cyc.angle_mode_series(jnp.asarray(arr)))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("method", ["ecg_lazy", "angle", "arterial"])
@pytest.mark.parametrize("subset", [True, False])
def test_peak_extraction_matches_jax(rng, method, subset):
    n = 40
    t = np.arange(n) / 20.0
    hi = np.sin(2 * np.pi * t) + 1.5 + 0.05 * rng.normal(size=n)
    lo = -hi + 0.05 * rng.normal(size=n)
    times = t
    sys_f, dia_f = [[2, 8], [22, 28]], [[9, 21], [29, 39]]
    kw = dict(cc_method=method, pick_peak_by_subset=subset)
    got = t_pk.calculate_single_peaks(hi, times, sys_f, dia_f, n,
                                      show_all_peaks=True, **kw)
    ref = j_pk.calculate_single_peaks(hi, times, sys_f, dia_f, n,
                                      show_all_peaks=True, **kw)
    assert got.keys() == ref.keys()
    for k in got:
        np.testing.assert_array_equal(np.asarray(got[k], dtype=object),
                                      np.asarray(ref[k], dtype=object), k)
    got = t_pk.calculate_radlong_peaks(hi, lo, times, sys_f, dia_f, n,
                                       peak_thres=0.2, **kw)
    ref = j_pk.calculate_radlong_peaks(hi, lo, times, sys_f, dia_f, n,
                                       peak_thres=0.2, **kw)
    assert got.keys() == ref.keys()
    for k in got:
        np.testing.assert_array_equal(np.asarray(got[k], dtype=object),
                                      np.asarray(ref[k], dtype=object), k)
