"""The port's legacy shim and PromptAutoEncoder against the JAX package's,
on the CPU and the same seeded inputs (the JAX package's
tests/test_extras.py holds its own only by name).

  * legacy: the six ``sysdia_frames_by_*`` detectors equal the JAX
    shim's; ``percentile_plot`` and ``percentile_plot_radlong`` equal the
    JAX package's building blocks called with the right arguments
    (``_detect``, ``_total_trace``/``_radlong_traces`` and
    ``_total_stats``/``_radlong_stats``; the JAX shims themselves call the
    last two with one argument too few and raise TypeError, which is
    recorded here too). The traces come from the histograms at nbins
    1000, where XLA fuses the percentile interpolation with another
    multiply-add than the port's (tests/test_torch_viz.py): floats within
    1e-5 relative, integers equal.
  * PromptAutoEncoder: the dense embedding against JAX's with the
    variables carried across (``prompt_autoencoder_state_dict_from_flax``)
    within 1e-5 max-abs (float32 convolutions and layer norms summed in
    another order), its shape quirk (66^2 in -> 16^2 out) and the
    zero-width sparse output.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tee_optical_flow_torch import legacy as t_legacy
from tee_optical_flow_torch.dataset import OpticalFlowDataset as TDataset
from tee_optical_flow_torch.io import hdf5 as t_hdf5
from tee_optical_flow_torch.models.convert import (
    prompt_autoencoder_state_dict_from_flax,
)
from tee_optical_flow_torch.models.prompt_encoder import (
    PromptAutoEncoder as TPromptAutoEncoder,
)
from tee_optical_flow_tpu import legacy as j_legacy
from tee_optical_flow_tpu.batch import cohort as j_cohort
from tee_optical_flow_tpu.config import (
    AnalysisConfig, ProcessingConfig, VisualizationConfig,
)
from tee_optical_flow_tpu.dataset import OpticalFlowDataset as JDataset
from tee_optical_flow_tpu.models.prompt_encoder import (
    PromptAutoEncoder as JPromptAutoEncoder,
)
from tee_optical_flow_tpu.viz.manager import VisualizationManager

torch.set_num_threads(1)

ROW_RTOL = 1e-5
PAE_ATOL = 1e-5


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


@pytest.fixture(scope="module")
def gated(tmp_path_factory):
    """The gated clip of tests/test_torch_cohort.py (rv + av masks, a
    synthetic ECG and ABP, 40 frames at 20 frames/s), as an HDF5."""
    rng = np.random.default_rng(5)
    n, h, w, fps = 40, 24, 24, 20.0
    flow = rng.normal(scale=0.5, size=(n, h, w, 2)).astype(np.float32)
    t = np.arange(n) / fps
    flow[..., 1] += np.sin(2 * np.pi * 1.0 * t)[:, None, None]
    echo = rng.uniform(size=(n, h, w)).astype(np.float32)
    masks = {"rv": np.zeros((n, h, w, 2), np.uint8),
             "av": np.zeros((n, h, w, 2), np.uint8)}
    masks["rv"][:, 4:20, 4:20, :] = 1
    masks["av"][:, 10:14, 10:14, :] = 1
    meta = {"frame_rate": fps, "pixel_spacing": 0.05,
            "R_wave_data_present": False}
    waveforms = {"ecg": (True, _ecg()), "art": (True, _abp()),
                 "cvp": (False, None), "pap": (False, None)}
    path = str(tmp_path_factory.mktemp("legacy") / "gated.hdf5")
    t_hdf5.save_optical_flow_hdf5(path, flow, echo, masks, meta, waveforms,
                                  mode="RVIO_2class", no_saliency=True,
                                  include_waveforms=True, patient_id="G1")
    return path


def _same(got, ref):
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        if isinstance(r, (int, np.integer)) or r == 0:
            assert g == r, (i, g, r)
        else:
            assert abs(g - r) <= ROW_RTOL * abs(r), (i, g, r)


@pytest.mark.parametrize("name", ["angle", "area", "RTime", "ecg_lazy",
                                  "ecg", "art"])
def test_sysdia_detectors_match_jax(gated, name):
    """Equal (sys, dia) frames. The angle, lazy-ECG and arterial detectors
    find a systole on this clip; the area (its rv mask keeps its area),
    R-time (no R-wave times) and full ECG detectors need not."""
    with TDataset(gated) as tds, JDataset(gated) as jds:
        def call(mod, ds, **kw):
            if name == "angle":
                return mod.sysdia_frames_by_angle(ds, "velocity", "rv", **kw)
            if name == "area":
                return mod.sysdia_frames_by_area(ds, "rv", **kw)
            if name == "RTime":
                return mod.sysdia_frames_by_RTime(ds)
            if name == "art":
                return mod.sysdia_frames_by_art(ds, ds.art, 125, **kw)
            fn = getattr(mod, f"sysdia_frames_by_{name}")
            return fn(ds, ds.ecg, 500, **kw)

        kw = {"device": "cpu"} if name in ("angle", "area") else {}
        got = call(t_legacy, tds, **kw)
        ref = call(j_legacy, jds)
    assert [list(map(list, g)) for g in got] == \
        [list(map(list, r)) for r in ref]
    assert name in ("area", "RTime", "ecg") or len(got[0]) > 0


def _jax_stats(jds, save_dir, param, label, cc_method, radlong):
    """What the JAX shim means to return: its building blocks called with
    the right arguments."""
    manager = VisualizationManager(
        vis_config=VisualizationConfig(return_statistics=True))
    gate = "ecg" if "ecg" in cc_method else "art"
    sys_f, dia_f = j_cohort._detect(jds, gate, j_legacy._cc(),
                                    ProcessingConfig())
    masked = jnp.asarray(jds.get_masked_arr(param, label))
    cfg = AnalysisConfig()
    frame_times = np.arange(jds.nframes) / jds.frame_rate
    if radlong:
        traces = j_cohort._radlong_traces(jds, masked, jds.get_mask("av"),
                                          cfg)
        return j_cohort._radlong_stats(jds, param, label, cc_method, sys_f,
                                       dia_f, manager, save_dir, traces,
                                       frame_times)
    filt = j_cohort._total_trace(jds, masked, manager, cfg)
    return j_cohort._total_stats(jds, param, label, cc_method, sys_f, dia_f,
                                 manager, save_dir, filt, frame_times)


@pytest.mark.parametrize("radlong", [False, True])
@pytest.mark.parametrize("cc_method", ["ecg_lazy", "arterial"])
def test_percentile_plots_match_jax_building_blocks(gated, tmp_path,
                                                    cc_method, radlong):
    pytest.importorskip("matplotlib")
    t_dir, j_dir = str(tmp_path / "t"), str(tmp_path / "j")
    with TDataset(gated) as tds, JDataset(gated) as jds:
        fn = (t_legacy.percentile_plot_radlong if radlong
              else t_legacy.percentile_plot)
        got = fn(tds, "velocity", "rv", cc_method, save_dir=t_dir,
                 device="cpu")
        ref = _jax_stats(jds, j_dir, "velocity", "rv", cc_method, radlong)
        kind = "radlong" if radlong else "total"
        name = f"{tds.filename}_{cc_method}_velocity_rv_{kind}.png"
    assert len(got) == (18 if radlong else 9)
    _same(got, ref)
    assert any(v != 0 for v in got)
    assert os.path.exists(os.path.join(t_dir, "plots", name))
    assert os.path.exists(os.path.join(j_dir, "plots", name))


@pytest.mark.parametrize("radlong", [False, True])
def test_jax_percentile_shims_raise_type_error(gated, tmp_path, radlong):
    """The known difference: the JAX shims pass 9 arguments to functions
    that take 10 (ROADMAP, known differences)."""
    fn = (j_legacy.percentile_plot_radlong if radlong
          else j_legacy.percentile_plot)
    with JDataset(gated) as jds, pytest.raises(TypeError):
        fn(jds, "velocity", "rv", "ecg_lazy", save_dir=str(tmp_path))


def test_legacy_reexports():
    from tee_optical_flow_torch import analysis
    from tee_optical_flow_torch.io import tabular

    assert t_legacy.calculate_3dhist is analysis.calculate_3dhist
    assert t_legacy.calculate_3dhist_radlong is \
        analysis.calculate_3dhist_radlong
    assert t_legacy.calc_bidirectional_hist is \
        analysis.calc_bidirectional_hist
    assert t_legacy.aggregate_pkl is tabular.aggregate_pkl_files
    assert sorted(t_legacy.__all__) == sorted(j_legacy.__all__)


def _random_params(tree, rng):
    """Seeded random values of a flax params tree's shapes: biases and
    norms off their identities."""
    if isinstance(tree, dict):
        return {k: _random_params(v, rng) for k, v in tree.items()}
    return (rng.normal(size=tree.shape) * 0.3).astype(np.float32)


@pytest.mark.parametrize("size", [66, 129])
def test_prompt_autoencoder_matches_jax(size):
    """66^2 -> 16^2 (the reference parity test's shape) and 129^2 -> 31^2
    (the valid-padding quirk on an odd size)."""
    kw = dict(image_embedding_size=(16, 16), input_image_size=(size, size),
              mask_in_chans=16, embed_dim=32)
    rng = np.random.default_rng(3)
    img = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    jm = JPromptAutoEncoder(**kw)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), img)
    params = _random_params(shapes["params"], rng)
    sparse_j, dense_j = jm.apply({"params": params}, jnp.asarray(img))

    tm = TPromptAutoEncoder(**kw)
    tm.load_state_dict(prompt_autoencoder_state_dict_from_flax(params),
                       strict=True)
    with torch.no_grad():
        sparse_t, dense_t = tm(torch.from_numpy(img.transpose(0, 3, 1, 2)))
    out = (size - 2) // 4
    assert tuple(sparse_t.shape) == sparse_j.shape == (2, 0, 32)
    assert tuple(dense_t.shape) == (2, 32, out, out)
    ref = np.asarray(dense_j).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(dense_t.numpy(), ref, rtol=0, atol=PAE_ATOL)
    assert np.abs(ref).max() > 0.1
