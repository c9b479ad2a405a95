"""The PyTorch port's plain device ops against the JAX package's, on the
CPU: imaging, stencils, pyramid, resizes, the 5x5 median and the two
warps. Inputs are made with numpy from a seed and handed to both."""

import numpy as np
import pytest
import torch

import jax

from tee_optical_flow_torch.ops import imaging as t_img
from tee_optical_flow_torch.ops import warp as tw
from tee_optical_flow_tpu.ops import imaging as j_img
from tee_optical_flow_tpu.ops import warp as jw

torch.set_num_threads(1)

# float32 rounding of values up to 255: one ulp there is 1.5e-5, and the
# JAX CPU backend rounds some fused multiply-adds and sums in another
# order than torch, so elementwise results may differ by a few ulps
ULPS_255 = 2e-4


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0, atol=atol)


def test_imaging_matches_jax(rng):
    rgb = rng.integers(0, 256, size=(3, 20, 24, 3), dtype=np.uint8)
    # luma: a 3-term dot product, one rounding order each side
    _close(j_img.rgb2gray(rgb), t_img.rgb2gray(_t(rgb)), 1e-6)
    gray = np.repeat(rgb[..., :1], 3, axis=-1)
    _close(j_img.gray_from_clip(gray), t_img.gray_from_clip(_t(gray)), 1e-6)
    # the one-channel path is exact: luma of R=G=B is the channel / 255
    np.testing.assert_array_equal(
        np.asarray(j_img.gray_from_clip(gray[..., 0])),
        t_img.gray_from_clip(_t(gray[..., 0])).numpy())
    frames = rng.uniform(size=(3, 20, 24)).astype(np.float32)
    ref = np.stack([np.asarray(j_img.img2uint8_jnp(f)) for f in frames])
    np.testing.assert_array_equal(ref, t_img.img2uint8(_t(frames)).numpy())


def test_stencils_and_pyramid_match_jax(rng):
    img = (rng.uniform(size=(2, 37, 45)) * 255).astype(np.float32)
    for a, b in zip(jw.centered_gradient(img), tw.centered_gradient(_t(img))):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for a, b in zip(jw.forward_diff(img), tw.forward_diff(_t(img))):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    p2 = img[::-1].copy()
    np.testing.assert_array_equal(np.asarray(jw.divergence(img, p2)),
                                  tw.divergence(_t(img), _t(p2)).numpy())
    # the blur sums its taps in the JAX order: exact
    np.testing.assert_array_equal(np.asarray(jw.gaussian_blur(img, 0.8)),
                                  tw.gaussian_blur(_t(img), 0.8).numpy())
    shapes = jw.pyramid_shapes(37, 45, 5, 0.8)
    assert tw.pyramid_shapes(37, 45, 5, 0.8) == shapes
    assert tw.pyramid_shapes(480, 640, 5, 0.8) == \
        jw.pyramid_shapes(480, 640, 5, 0.8)
    for a, b in zip(jw.build_pyramid(img, shapes),
                    tw.build_pyramid(_t(img), shapes)):
        _close(a, b, ULPS_255)


@pytest.mark.parametrize("method", ["bilinear", "cubic"])
@pytest.mark.parametrize("out_shape", [(30, 36), (24, 29), (48, 64), (37, 60)])
def test_resize_matches_jax_image_resize(rng, method, out_shape):
    """jax.image.resize's antialiased down shapes and its up shapes (the
    pyramid's flow upsampling), against the port's weight matrices: the
    weights' normalising sums and the matrix products round in another
    order (a few ulps of 255)."""
    img = (rng.uniform(size=(2, 37, 45)) * 255).astype(np.float32)
    ref = jax.image.resize(img, (2,) + out_shape, method=method)
    fn = tw.resize_bilinear if method == "bilinear" else tw.resize_cubic
    _close(ref, fn(_t(img), *out_shape), ULPS_255)


def test_median_5x5_bit_equal(rng):
    f = rng.normal(size=(3, 23, 31)).astype(np.float32)
    f[:, 4:9, 4:9] = 0.25  # ties
    ref = np.asarray(jw.median_filter_5x5(f))
    np.testing.assert_array_equal(ref, tw.median_filter_5x5(_t(f)).numpy())
    # the plain K1's gate: a frozen pair passes through, an active one is
    # filtered
    err = torch.tensor([1.0, 0.0, 5.0])
    got = tw.median_filter_5x5_plain(_t(f), err=err, thresh=0.5).numpy()
    np.testing.assert_array_equal(got[[0, 2]], ref[[0, 2]])
    np.testing.assert_array_equal(got[1], f[1])


def test_median_networks_match_jax_and_cuda_source():
    assert tw.SORT5_NETWORK == jw.SORT5_NETWORK
    assert tw.COLUMN_MEDIAN_25_NETWORK == jw.COLUMN_MEDIAN_25_NETWORK
    assert tw.COLUMN_MEDIAN_25_TARGET == jw.COLUMN_MEDIAN_25_TARGET
    # the CUDA median spells the networks out as macro lists
    import re
    from pathlib import Path

    import tee_optical_flow_torch

    src = (Path(tee_optical_flow_torch.__file__).parent / "csrc"
           / "tvl1.cu").read_text()

    def network(name):
        body = src.split(f"#define {name}(w)")[1].split("\n\n")[0]
        return tuple((int(i), int(j))
                     for i, j in re.findall(r"CE\(w, (\d+), (\d+)\)", body))

    assert network("SORT5") == jw.SORT5_NETWORK
    assert network("COLUMN_MEDIAN_25") == jw.COLUMN_MEDIAN_25_NETWORK
    assert "return w[14];" in src  # the answer wire


def _flows(rng, shape, scale):
    u = (rng.normal(size=shape) * scale).astype(np.float32)
    v = (rng.normal(size=shape) * scale).astype(np.float32)
    return u, v


@pytest.mark.parametrize("kernel", ["bilinear", "bicubic"])
def test_warp_many_shift_matches_jax(rng, kernel):
    """The gather form against the JAX shift-sum: same taps, same weights,
    same order; the JAX CPU backend rounds the rolled row loop's
    multiply-adds differently (measured a few ulps of 255)."""
    img = (rng.uniform(size=(2, 30, 36)) * 255).astype(np.float32)
    gx, gy = jw.centered_gradient(img)
    imgs = (img, np.asarray(gx), np.asarray(gy))
    # small flow inside the bound, and flow that hits the +-(r - 1e-3) clip
    for scale in (0.7, 6.0):
        u, v = _flows(rng, img.shape, scale)
        ref = jw.warp_many_shift(imgs, u, v, max_disp=4, kernel=kernel)
        got = tw.warp_many_shift(tuple(_t(x) for x in imgs), _t(u), _t(v),
                                 max_disp=4, kernel=kernel)
        for a, b in zip(ref, got):
            _close(a, b, ULPS_255 * 2)


@pytest.mark.parametrize("kernel", ["bilinear", "bicubic"])
def test_warp_tiled2d_matches_jax(rng, kernel):
    """Per-tile integer bases and residual clamps, on a shape whose tiles
    pad (edge tiles take zero flow into their min/max), for flow whose
    per-tile span stays inside the residual radius and for flow that
    engages the [-8, 9) residual clamp and the +-(16 - 1e-3) clip."""
    img = (rng.uniform(size=(2, 37, 45)) * 255).astype(np.float32)
    imgs = (img,)  # one image: the JAX eager tiled warp is slow on the CPU
    yy, xx = np.mgrid[0:37, 0:45].astype(np.float32)
    smooth_u = np.stack([0.2 * (xx - 22) + 3.0, -0.15 * (yy - 18)])
    smooth_v = np.stack([0.1 * (yy - 18) - 2.0, 0.12 * (xx - 22)])
    wild_u, wild_v = _flows(rng, img.shape, 9.0)
    for u, v in ((smooth_u, smooth_v), (wild_u, wild_v)):
        u = u.astype(np.float32)
        v = v.astype(np.float32)
        ref = jw.warp_many_shift_tiled2d(imgs, u, v, max_disp=16, local_r=8,
                                         kernel=kernel)
        got = tw.warp_many_shift_tiled2d(tuple(_t(x) for x in imgs), _t(u),
                                         _t(v), max_disp=16, local_r=8,
                                         kernel=kernel)
        for a, b in zip(ref, got):
            _close(a, b, ULPS_255)


@pytest.mark.parametrize("method", ["bilinear", "linear", "bicubic",
                                    "cubic"])
@pytest.mark.parametrize("channels", [0, 3])
def test_resize_frames_and_normalize_match_jax(rng, method, channels):
    """ops.resize_frames (a shrink on one axis, a stretch on the other, a
    single-channel and an RGB stack) against jax.image.resize's weights,
    and normalize_imagenet, to float32 rounding of values up to 255."""
    shape = (2, 21, 18) + ((channels,) if channels else ())
    frames = rng.integers(0, 256, size=shape, dtype=np.uint8)
    _close(j_img.resize_frames(frames, 13, 29, method),
           t_img.resize_frames(_t(frames), 13, 29, method), ULPS_255)
    x = rng.uniform(size=(2, 5, 6, 3)).astype(np.float32)
    _close(j_img.normalize_imagenet(x), t_img.normalize_imagenet(_t(x)),
           1e-6)
    with pytest.raises(ValueError, match="method"):
        t_img.resize_frames(_t(frames), 13, 29, "lanczos3")


def test_host_helpers_match_jax(rng):
    """utils.img2uint8 (the host form, uint8) and utils.bucket_shape, equal
    to the JAX package's."""
    from tee_optical_flow_torch import utils as t_utils
    from tee_optical_flow_tpu import utils as j_utils

    img = rng.normal(size=(7, 9)) * 40 + 10
    np.testing.assert_array_equal(t_utils.img2uint8(img),
                                  j_utils.img2uint8(img))
    np.testing.assert_array_equal(t_utils.img2uint8(np.zeros((3, 3))),
                                  j_utils.img2uint8(np.zeros((3, 3))))
    for shape in ((33, 480, 640, 3), (7, 100, 129)):
        assert t_utils.bucket_shape(shape) == j_utils.bucket_shape(shape)
        assert t_utils.bucket_shape(shape, 4, 32) == \
            j_utils.bucket_shape(shape, 4, 32)
