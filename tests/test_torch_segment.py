"""The PyTorch port's segmentor masks against the JAX package's, on the
CPU: ``clean_mask`` for every mode, ``predict_movie``'s two routes, and
``process_video(mode="RVIO_2class")`` end to end from an in-memory clip,
and the segmentor options the port does not have yet.

Masks and labels are integers and booleans: every comparison is
bit-equal. The pipeline test drives both packages with one stub label
callable (a fixed threshold of the frames), so that no argmax tie between
two models' logits can flip a mask; the SAM models themselves are held to
JAX in tests/test_torch_sam.py."""

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the JAX reference runs on the CPU)

from tee_optical_flow_torch.config import (
    OpticalFlowCalculationConfig as TorchConfig,
)
from tee_optical_flow_torch.exceptions import (
    ConfigurationError, ShardingError,
)
from tee_optical_flow_torch.flow import pipeline as t_pipe
from tee_optical_flow_torch.flow import segment as t_seg
from tee_optical_flow_torch.models.registry import (
    build_sam_vit_t, sam_model_registry,
)
from tee_optical_flow_torch.models.sam import make_clip_segmentor
from tee_optical_flow_torch.parallel.mesh import make_mesh
from tee_optical_flow_tpu.config import (
    OpticalFlowCalculationConfig as JaxConfig,
)
from tee_optical_flow_tpu.flow import pipeline as j_pipe
from tee_optical_flow_tpu.flow import segment as j_seg

torch.set_num_threads(1)

REDUCED = dict(min_mask_size=50, tvl1_nscales=3, tvl1_zoom_factor=0.5,
               tvl1_warps=3, tvl1_outer_iterations=2,
               tvl1_inner_iterations=15, tvl1_median_filtering=False)


def _label_movie(rng, n=6, h=40, w=48, classes=9):
    """Blobby labels of every class (smoothed noise, quantised), with
    holes and specks for the cleanup to fill and remove."""
    from scipy import ndimage

    noise = ndimage.gaussian_filter(rng.normal(size=(n, h, w)),
                                    (0.8, 3.0, 3.0))
    ranks = noise.argsort(axis=None).argsort().reshape(noise.shape)
    return (ranks * classes // noise.size).astype(np.uint8)


@pytest.mark.parametrize("mode", ["A4C", "RVIO_2class", "MouseRV_A4C"])
def test_clean_mask_matches_jax(rng, mode):
    labels = _label_movie(rng)
    kw = dict(min_mask_size=30)
    ref = j_seg.clean_mask(labels, mode, config=JaxConfig(**kw))
    got = t_seg.clean_mask(labels, mode, config=TorchConfig(**kw),
                           device="cpu")
    assert list(got) == list(ref) == list(t_seg.LABEL_MAPS[mode]) + ["bkgd"]
    for name in ref:
        assert got[name].shape == (6, 40, 48, 2) and got[name].dtype == bool
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
    # the cleanup did something: some masks are neither empty nor full
    assert any(0 < m.mean() < 1 for m in got.values())
    # a tensor goes through on its device, as the pipeline hands it over
    dev = t_seg.clean_mask(torch.from_numpy(labels), mode,
                           config=TorchConfig(**kw))
    for name in ref:
        np.testing.assert_array_equal(dev[name], ref[name])


def test_clean_mask_frame_depends_on_its_window(rng):
    """A frame's masks depend only on the labels of frames k-1 to k+2 (the
    moving average's window; the cleanup is per frame): clean_mask of
    that window gives frame k's masks of the whole clip, at the ends too."""
    labels = _label_movie(rng, n=9)
    cfg = TorchConfig(min_mask_size=30)
    whole = t_seg.clean_mask(labels, "RVIO_2class", config=cfg,
                             device="cpu")
    for k in range(9):
        lo = max(k - 1, 0)
        part = t_seg.clean_mask(labels[lo:k + 3], "RVIO_2class", config=cfg,
                                device="cpu")
        for name in whole:
            np.testing.assert_array_equal(part[name][k - lo],
                                          whole[name][k], f"{name} {k}")


def test_clean_mask_unknown_mode_is_none(rng):
    labels = _label_movie(rng)
    assert t_seg.clean_mask(labels, "nope", device="cpu") is None
    assert j_seg.clean_mask(labels, "nope") is None


def test_predict_movie_routes_agree(rng):
    """make_clip_segmentor's callable through predict_movie: the device
    route (the pipeline's clip tensor, labels never leave it) and the host
    route (the callable on host frames) give the same masks."""
    model = build_sam_vit_t(num_classes=3, image_size=64, seed=0,
                            device="cpu")
    seg = make_clip_segmentor(model, micro_batch=2)
    gray = (rng.uniform(size=(3, 40, 48)) * 255).astype(np.uint8)
    frames = np.repeat(gray[..., None], 3, axis=-1)
    cfg = TorchConfig(min_mask_size=5)
    host = t_seg.predict_movie(frames, seg, mode="RVIO_2class", config=cfg,
                               device="cpu")
    dev = t_seg.predict_movie(frames, seg, mode="RVIO_2class", config=cfg,
                              _clip_dev=torch.from_numpy(gray))
    assert set(host) == {"rv", "av", "bkgd"}
    for name in host:
        np.testing.assert_array_equal(dev[name], host[name])


def _stub_labels(frames):
    """(N, H, W, 3) uint8 -> labels: 1 (rv) on the bright blob, 2 (av) on
    its rim, 0 elsewhere."""
    g = np.asarray(frames)[..., 0].astype(np.int32)
    return np.where(g > 150, 1, np.where(g > 60, 2, 0)).astype(np.uint8)


def _clip(rng, n=8, h=48, w=48):
    """The blob drifting +1 px/frame on dark speckle of
    tests/test_torch_pipeline.py."""
    clip = (rng.uniform(size=(n, h, w)) * 40).astype(np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(n):
        blob = np.exp(-((yy - h // 2) ** 2 + (xx - w // 4 - i) ** 2)
                      / (2 * 8.0 ** 2))
        clip[i] = np.clip(clip[i] + blob * 215, 0, 255).astype(np.uint8)
    return np.repeat(clip[..., None], 3, axis=-1)


def test_process_video_rvio_matches_jax(tmp_path):
    """process_video(mode="RVIO_2class") from an in-memory clip, port and
    JAX with the same stub segmentor: the masks and the echo bit for bit,
    the flow within float16 rounding plus the solvers' float32 drift (the
    bounds of tests/test_torch_pipeline.py), the attributes equal."""
    import h5py

    clip = _clip(np.random.default_rng(7))
    meta = {"pixel_spacing": 0.05, "frame_rate": 30.0, "R_times": None,
            "R_wave_data_present": False}
    kw = dict(verbose=False, mode="RVIO_2class", no_saliency=True,
              OF_algo="TVL1", include_waveforms=False,
              _clip_override=clip, _metadata_override=meta)
    out_t, out_j = str(tmp_path / "t.hdf5"), str(tmp_path / "j.hdf5")
    t_pipe.process_video("mem.dcm", out_t, _stub_labels,
                         config=TorchConfig(**REDUCED), device="cpu", **kw)
    j_pipe.process_video("mem.dcm", out_j, _stub_labels,
                         config=JaxConfig(**REDUCED), **kw)
    with h5py.File(out_t, "r") as ft, h5py.File(out_j, "r") as fj:
        assert sorted(ft.keys()) == sorted(fj.keys())
        assert {"rv", "av", "bkgd"} <= set(ft.keys())
        for name in ("rv", "av", "bkgd", "echo"):
            np.testing.assert_array_equal(ft[name][()], fj[name][()], name)
        assert ft["rv"][()].any() and ft["av"][()].any()
        for key in ("nframes", "mode", "frame_rate", "pixel_spacing",
                    "labels", "ID", "HR", "no_saliency", "units_converted"):
            np.testing.assert_array_equal(ft["flow"].attrs[key],
                                          fj["flow"].attrs[key])
        a = ft["flow"][()].astype(np.float32)
        b = fj["flow"][()].astype(np.float32)
    epe = np.hypot(a[..., 0] - b[..., 0], a[..., 1] - b[..., 1])
    assert epe.mean() < 0.01 and epe.max() < 0.05, (epe.mean(), epe.max())


def test_segmentor_mode_needs_a_segmentor(tmp_path):
    with pytest.raises(ConfigurationError, match="requires a segmentor"):
        t_pipe.process_video("mem.dcm", str(tmp_path / "x.hdf5"), None,
                             mode="RVIO_2class", device="cpu",
                             _clip_override=_clip(np.random.default_rng(0)))


def test_unported_options_are_refused():
    # the PEFT adapters came with training, vit_b/l/h and int8 weights
    # after it, the mesh last: they build now; what is refused is what
    # the JAX package refuses, a micro-batch the data axis does not divide
    adapted = build_sam_vit_t(num_classes=3, image_size=64, device="cpu",
                              adapter_stages=(1,), use_decoder_adapter=True)
    keys = adapted.state_dict()
    assert "image_encoder.layers.1.blocks.0.Space_Adapter.D_fc1.weight" in keys
    assert "mask_decoder.transformer.layers.1.MLP_Adapter.D_fc2.bias" in keys
    assert not any("Adapter" in k and ".layers.2." in k for k in keys)
    model = build_sam_vit_t(num_classes=3, image_size=64, device="cpu")
    assert callable(make_clip_segmentor(model, weights_int8=True))
    assert sam_model_registry["vit_b"] is not build_sam_vit_t
    mesh = make_mesh(devices=["cpu"] * 3)
    with pytest.raises(ShardingError, match="micro_batch=4 not divisible "
                       r"by the mesh data axis \(3\)"):
        make_clip_segmentor(model, mesh=mesh)
    assert callable(make_clip_segmentor(model, micro_batch=6, mesh=mesh))
