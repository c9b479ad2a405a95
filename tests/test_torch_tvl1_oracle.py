"""The PyTorch port's TV-L1 solver against the float64 NumPy oracle (the
IPOL/OpenCV algorithm), on the CPU; and the port's copies of the two
oracles against the JAX package's originals.

The slow tests take the settings and bounds of the JAX package's own
oracle tests (tests/test_tvl1.py: a 96x120 texture under smooth
non-rigid motion, and the production protocol on a 240x320 echo sector).
The fast one holds every Tier-1 run to the oracle at a reduced size:
48x64, 2 scales, 3 warps, 4 x 15 iterations with the median. Over seeds
0-3 it measured an interior median end-point error of 0.029-0.034 px and
a p95 of 0.082-0.101 px; its bounds are 0.06 and 0.2 px. The gamma
solver is held the same way (the JAX package's gamma oracle test, marked
slow as there, and a reduced one), and on the JAX package's brightness-ramp
case.
"""

import numpy as np
import pytest
import torch
from scipy import ndimage

from tee_optical_flow_torch.ops import deepflow_oracle as t_df
from tee_optical_flow_torch.ops import tvl1_oracle as t_or
from tee_optical_flow_torch.ops.tvl1 import tvl1_flow_pairs
from tee_optical_flow_torch.synthetic import (
    echo_sector_masks, make_echo_pair,
)
from tee_optical_flow_tpu.ops import deepflow_oracle as j_df
from tee_optical_flow_tpu.ops import tvl1_oracle as j_or

torch.set_num_threads(1)


def _texture(rng, h, w, smooth=3.0):
    img = ndimage.gaussian_filter(rng.uniform(size=(h, w)), smooth)
    img = (img - img.min()) / (img.max() - img.min())
    return (img * 255.0).astype(np.float32)


def _nonrigid(img):
    """``img`` moved by u = 1.5 sin(2 pi y / h), v = -cos(2 pi x / w)
    (bicubic resampling)."""
    h, w = img.shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    u = 1.5 * np.sin(2 * np.pi * yy / h)
    v = -1.0 * np.cos(2 * np.pi * xx / w)
    return ndimage.map_coordinates(img, [yy + v, xx + u], order=3,
                                   mode="nearest").astype(np.float32)


def _solve(i0, i1, **kw):
    return tvl1_flow_pairs(torch.from_numpy(i0[None]),
                           torch.from_numpy(i1[None]), use_median=True,
                           **kw)[0].numpy()


def test_oracle_copies_equal_the_originals(rng):
    """The port's oracles are copies: on one small pair each returns the
    JAX package's result bit for bit (TV-L1 at epsilon 0 and 0.01;
    DeepFlow without and with a matching field and seed)."""
    img = _texture(rng, 32, 40)
    i1 = _nonrigid(img)
    for eps in (0.0, 0.01):
        kw = dict(nscales=2, warps=2, outer_iters=2, inner_iters=5,
                  epsilon=eps)
        np.testing.assert_array_equal(t_or.tvl1_flow_oracle(img, i1, **kw),
                                      j_or.tvl1_flow_oracle(img, i1, **kw))
    kw = dict(nscales=2, fp_iters=2, psi_iters=2, sor_iters=4)
    np.testing.assert_array_equal(t_df.deepflow_flow_oracle(img, i1, **kw),
                                  j_df.deepflow_flow_oracle(img, i1, **kw))
    h, w = 16, 20  # the coarsest level of 32x40 at zoom 0.5
    field = rng.normal(size=(h, w)) * 0.5
    kw.update(matches={1: (field, -field, np.ones((h, w)))},
              init=(field, field), beta=0.3)
    np.testing.assert_array_equal(t_df.deepflow_flow_oracle(img, i1, **kw),
                                  j_df.deepflow_flow_oracle(img, i1, **kw))
    np.testing.assert_array_equal(t_or.epe(i1, img), j_or.epe(i1, img))


def test_tvl1_matches_oracle_reduced(rng):
    img = _texture(rng, 48, 64)
    i1 = _nonrigid(img)
    kw = dict(nscales=2, zoom=0.8, warps=3, outer_iters=4, inner_iters=15)
    golden = t_or.tvl1_flow_oracle(img, i1, epsilon=0.0, median_kernel=5,
                                   **kw)
    err = t_or.epe(_solve(img, i1, **kw), golden)[8:-8, 8:-8]
    assert np.median(err) < 0.06, np.median(err)
    assert np.percentile(err, 95) < 0.2, np.percentile(err, 95)


@pytest.mark.slow
def test_tvl1_matches_oracle(rng):
    """tests/test_tvl1.py's golden test for the port: 96x120, 3 scales,
    5 warps, 10 x 30 iterations, epsilon 0 on both sides; interior median
    under 0.05 px, p95 under 0.1 px (measured 0.026 and 0.078 px)."""
    img = _texture(rng, 96, 120)
    i1 = _nonrigid(img)
    kw = dict(nscales=3, zoom=0.8, warps=5, outer_iters=10, inner_iters=30)
    golden = t_or.tvl1_flow_oracle(img, i1, epsilon=0.0, median_kernel=5,
                                   **kw)
    err = t_or.epe(_solve(img, i1, **kw), golden)[8:-8, 8:-8]
    assert np.median(err) < 0.05, np.median(err)
    assert np.percentile(err, 95) < 0.1, np.percentile(err, 95)


@pytest.mark.slow
def test_tvl1_matches_oracle_at_production_defaults():
    """The production protocol of tests/test_tvl1.py on the port: bicubic
    warps and epsilon 0.01 on both sides, a 240x320 echo sector
    contracting by 5%; interior median, wall p95 and sector p95 all under
    0.1 px (measured 0.032, 0.042 and 0.056 px)."""
    h, w = 240, 320
    i0, i1 = make_echo_pair(101, h, w, contraction=0.05)
    kw = dict(nscales=4, zoom=0.8, warps=5, outer_iters=10, inner_iters=30)
    golden = t_or.tvl1_flow_oracle(i0, i1, epsilon=0.01, median_kernel=5,
                                   **kw)
    err = t_or.epe(_solve(i0, i1, epsilon=0.01, interpolation="bicubic",
                          **kw), golden)
    masks = echo_sector_masks(h, w)
    interior = np.zeros((h, w), bool)
    interior[8:-8, 8:-8] = True
    assert np.median(err[interior]) < 0.1, np.median(err[interior])
    wall = err[masks["wall"] & interior]
    sector = err[masks["sector"] & interior]
    assert np.percentile(wall, 95) < 0.1, np.percentile(wall, 95)
    assert np.percentile(sector, 95) < 0.1, np.percentile(sector, 95)


def _ramp_pair(rng):
    """tests/test_tvl1.py's gamma case: a 64x80 texture in [20, 220]
    shifted by (dx, dy) = (1.5, -1.0) px, with a 0-30 brightness ramp
    across the second frame."""
    img = ndimage.gaussian_filter(rng.uniform(size=(64, 80)), 2.5)
    img = ((img - img.min()) / (img.max() - img.min()) * 200 + 20
           ).astype(np.float32)
    shifted = ndimage.shift(img, (-1.0, 1.5), order=3, mode="nearest")
    ramp = np.linspace(0, 30, 80, dtype=np.float32)[None, :]
    return img, np.clip(shifted + ramp, 0, 255).astype(np.float32)


def test_gamma_recovers_motion_under_a_brightness_ramp(rng):
    """tests/test_tvl1.py's gamma test on the port: the ramp breaks the
    gamma=0 data term (interior median end-point error above 0.5 px),
    the illumination field absorbs it at gamma=1 (below 0.1 px)."""
    img, i1 = _ramp_pair(rng)
    kw = dict(nscales=3, zoom=0.8, warps=5, outer_iters=6, inner_iters=20)
    dx, dy = 1.5, -1.0
    for gamma, bound in ((0.0, None), (1.0, 0.1)):
        flow = _solve(img, i1, gamma=gamma, **kw)[10:-10, 10:-10]
        med = np.median(np.hypot(flow[..., 0] - dx, flow[..., 1] - dy))
        if bound is None:
            assert med > 0.5, med
        else:
            assert med < bound, med


def test_gamma_matches_oracle_reduced(rng):
    """The gamma solver against the float64 oracle's gamma path at the
    reduced settings of test_tvl1_matches_oracle_reduced (a 48x64 crop of
    the ramp pair, 2 scales, 3 warps, 4 x 15 iterations, epsilon 0). Over
    seeds 0-3 it measured an interior median end-point error of
    0.024-0.040 px and a p95 of 0.12-0.23 px (the short budget leaves the
    illumination field unconverged near the ramp's steep edge); its bounds
    are 0.08 and 0.4 px."""
    img, i1 = _ramp_pair(rng)
    img, i1 = img[8:56, 8:72].copy(), i1[8:56, 8:72].copy()
    kw = dict(nscales=2, zoom=0.8, warps=3, outer_iters=4, inner_iters=15)
    golden = t_or.tvl1_flow_oracle(img, i1, epsilon=0.0, median_kernel=5,
                                   gamma=1.0, **kw)
    err = t_or.epe(_solve(img, i1, gamma=1.0, **kw), golden)[8:-8, 8:-8]
    assert np.median(err) < 0.08, np.median(err)
    assert np.percentile(err, 95) < 0.4, np.percentile(err, 95)


@pytest.mark.slow
def test_gamma_solver_matches_oracle(rng):
    """tests/test_tvl1.py's gamma oracle test on the port: the ramp pair,
    3 scales, 5 warps, 6 x 20 iterations, epsilon 0, gamma 1 on both
    sides; interior median under 0.05 px, p95 under 0.15 px."""
    img, i1 = _ramp_pair(rng)
    kw = dict(nscales=3, zoom=0.8, warps=5, outer_iters=6, inner_iters=20)
    golden = t_or.tvl1_flow_oracle(img.astype(np.float64),
                                   i1.astype(np.float64), epsilon=0.0,
                                   median_kernel=5, gamma=1.0, **kw)
    err = t_or.epe(_solve(img, i1, gamma=1.0, epsilon=0.0, **kw),
                   golden)[8:-8, 8:-8]
    assert np.median(err) < 0.05, np.median(err)
    assert np.percentile(err, 95) < 0.15, np.percentile(err, 95)
