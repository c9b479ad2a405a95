"""The PyTorch port's Otsu mask path against the JAX package's, on the
CPU. Masks and labels are integers and booleans: every comparison is
bit-equal. The Otsu thresholds are float32 arithmetic whose cumsum order
differs between the two; they must still be equal on this content."""

import numpy as np
import torch

import jax  # noqa: F401  (the JAX reference runs on the CPU)

from tee_optical_flow_torch.flow import segment as t_seg
from tee_optical_flow_torch.ops import morphology as t_m
from tee_optical_flow_torch.ops import otsu as t_otsu
from tee_optical_flow_tpu.flow import segment as j_seg
from tee_optical_flow_tpu.ops import morphology as j_m
from tee_optical_flow_tpu.ops import otsu as j_otsu

torch.set_num_threads(1)


def _clip(rng, n=6, h=40, w=44):
    """Bright drifting blobs with holes on dark speckle, plus small specks:
    components to label, holes to fill, objects to remove."""
    yy, xx = np.mgrid[0:h, 0:w]
    clip = rng.uniform(size=(n, h, w)) * 0.2
    for i in range(n):
        ring = np.hypot(yy - h / 2, xx - (w / 3 + i)) < 11
        hole = np.hypot(yy - h / 2, xx - (w / 3 + i)) < 3
        clip[i][ring & ~hole] += 0.7
        clip[i][5:8, w - 8:w - 5] += 0.7  # a 9-px speck
        clip[i][h - 12:h - 4, 4:12] += 0.6  # a block with a notch
        clip[i][h - 9, 4:7] = 0.05
    return clip.astype(np.float32)


def test_otsu_thresholds_equal(rng):
    clip = _clip(rng)
    for frame in clip:
        assert float(j_otsu.threshold_otsu(frame)) == \
            float(t_otsu.threshold_otsu(torch.from_numpy(frame)))
    np.testing.assert_array_equal(
        np.asarray(j_otsu.otsu_mask_stack(clip)),
        t_otsu.otsu_mask_stack(torch.from_numpy(clip)).numpy())


def test_morphology_bit_equal(rng):
    masks = np.array(j_otsu.otsu_mask_stack(_clip(rng)))
    tm = torch.from_numpy(masks)
    for conn in (1, 2):
        ref = np.stack([np.asarray(j_m.connected_components(m, conn))
                        for m in masks])
        np.testing.assert_array_equal(
            ref, t_m.connected_components(tm, conn).numpy())
    filled = np.stack([np.asarray(j_m.binary_fill_holes(m)) for m in masks])
    np.testing.assert_array_equal(filled,
                                  t_m.binary_fill_holes(tm).numpy())
    assert (filled != masks).any()  # the holes were filled
    small = np.stack([np.asarray(j_m.remove_small_objects(m, min_size=20))
                      for m in masks])
    np.testing.assert_array_equal(
        small, t_m.remove_small_objects(tm, min_size=20).numpy())
    assert (small != masks).any()  # the specks went
    np.testing.assert_array_equal(
        np.asarray(j_m.clean_binary_stack(masks, min_size=20)),
        t_m.clean_binary_stack(tm, min_size=20).numpy())
    np.testing.assert_array_equal(
        np.asarray(j_m.moving_avg_mask(masks)),
        t_m.moving_avg_mask(tm).numpy())
    # single-frame forms keep the (H, W) layout
    np.testing.assert_array_equal(
        np.asarray(j_m.connected_components(masks[0])),
        t_m.connected_components(tm[0]).numpy())


def test_mask_bit_packing_matches_jax(rng):
    mask = rng.uniform(size=(3, 7, 11)) > 0.5  # 231 bits: a ragged last byte
    packed = t_m.pack_mask_bits(torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(np.asarray(j_m.pack_mask_bits(mask)),
                                  packed)
    np.testing.assert_array_equal(t_m.unpack_mask_bits(packed, mask.shape),
                                  mask)


def test_predict_movie_thres_bit_equal(rng):
    from tee_optical_flow_tpu.config import OpticalFlowCalculationConfig

    gray = _clip(rng, n=8)
    rgb = np.repeat((gray * 255).astype(np.uint8)[..., None], 3, axis=-1)
    cfg = OpticalFlowCalculationConfig(min_mask_size=20)
    ref = j_seg.predict_movie_thres(rgb, config=cfg)
    got = t_seg.predict_movie_thres(rgb, config=cfg, device="cpu")
    assert list(got) == ["otsu"]
    assert got["otsu"].shape == (8, 40, 44, 2)
    np.testing.assert_array_equal(ref["otsu"], got["otsu"])
    assert got["otsu"].any() and not got["otsu"].all()
