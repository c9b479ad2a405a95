"""The PyTorch port's analysis device passes against the JAX package's, on
the CPU and the same seeded numpy inputs: ops/histogram (counts and
percentiles bit-equal, empty frames and carry-forward included), the
morphology additions (bit-equal), the AV centroid, the radial /
longitudinal decomposition, cart_to_polar, both 3dhist functions, and the
savgol and spectral smoothers in numpy and torch.

The port rounds each multiply-add as XLA's CPU backend contracts it
(core.fma32) and takes correctly rounded roots (core.sqrt32), so the
magnitudes and the radial / longitudinal components are bit-equal too.
Tolerances, where a comparison is not bit-equal: radial_vecgrid and
calc_proj_mag (not on the cohort row's path), whose programs XLA
contracts otherwise, 1e-6 absolute on unit-scale values; torch's atan2 against
XLA's, 1 ulp at 2*pi (5e-7), and the angle histogram's counts may move
between neighbouring bins by that ulp; the float32 FFT and the float32
savgol against XLA's, 1e-5 of the series' range."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tee_optical_flow_torch.analysis import centroid as t_cent
from tee_optical_flow_torch.analysis import components as t_comp
from tee_optical_flow_torch.analysis import histograms as t_hist
from tee_optical_flow_torch.ops import histogram as t_oh
from tee_optical_flow_torch.ops import morphology as t_morph
from tee_optical_flow_torch.ops import smoothing as t_smooth
from tee_optical_flow_torch.signal import smoother as t_sm
from tee_optical_flow_tpu.analysis import centroid as j_cent
from tee_optical_flow_tpu.analysis import components as j_comp
from tee_optical_flow_tpu.analysis import histograms as j_hist
from tee_optical_flow_tpu.ops import histogram as j_oh
from tee_optical_flow_tpu.ops import morphology as j_morph
from tee_optical_flow_tpu.ops import smoothing as j_smooth
from tee_optical_flow_tpu.signal import smoother as j_sm

torch.set_num_threads(1)

N, H, W = 6, 12, 16


def _masked_flow(rng, n=N, h=H, w=W):
    """(n, h, w, 2) float32 flow, zero outside a blob mask, with frame 1
    empty and frame 3 holding a single nonzero pixel."""
    flow = rng.normal(scale=2.0, size=(n, h, w, 2)).astype(np.float32)
    mask = rng.uniform(size=(n, h, w)) < 0.6
    mask[1] = False
    mask[3] = False
    mask[3, 5, 7] = True
    return flow * mask[..., None]


def _blob_masks(rng, n=N, h=H, w=W):
    """(n, h, w) bool: two blobs of random size per frame, frame 0 empty."""
    masks = np.zeros((n, h, w), bool)
    for i in range(1, n):
        for _ in range(2):
            r0, c0 = rng.integers(0, h - 3), rng.integers(0, w - 3)
            masks[i, r0:r0 + rng.integers(1, 5), c0:c0 + rng.integers(1, 6)] = 1
    return masks


@pytest.mark.parametrize("channel", [0, 1])
def test_histogram_and_percentile_bit_equal(rng, channel):
    frames = _masked_flow(rng)[..., channel]
    lo, hi = np.float32(frames.min()), np.float32(frames.max())
    percs = np.asarray([1, 50, 99], np.float32)
    got = t_oh.masked_histogram(torch.from_numpy(frames), torch.tensor(lo),
                                torch.tensor(hi), nbins=32)
    ref = j_oh.masked_histogram(jnp.asarray(frames), lo, hi, nbins=32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    vals, valid = t_oh.masked_percentile(torch.from_numpy(frames), percs)
    rvals, rvalid = j_oh.masked_percentile(jnp.asarray(frames),
                                           jnp.asarray(percs))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(rvals))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(rvalid))
    assert not valid[1] and valid[3]


@pytest.mark.parametrize("grouped", [False, True])
def test_hist_pack_bit_equal(rng, grouped):
    flow = _masked_flow(rng)
    percs = np.asarray([[1, 99], [5, 50]], np.float32)
    if grouped:
        frames = np.stack([flow[..., 0], flow[..., 1]])
        got = t_oh.framewise_hist_pack_group(torch.from_numpy(frames),
                                             torch.from_numpy(percs), 32)
        ref = j_oh.framewise_hist_pack_group(jnp.asarray(frames),
                                             jnp.asarray(percs), nbins=32)
    else:
        got = t_oh.framewise_hist_pack(torch.from_numpy(flow[..., 0]),
                                       percs[0], 32)
        ref = j_oh.framewise_hist_pack(jnp.asarray(flow[..., 0]),
                                       jnp.asarray(percs[0]), nbins=32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_carry_forward_and_edges(rng):
    vals = rng.normal(size=(7, 3))
    valid = np.array([0, 1, 0, 0, 1, 1, 0], bool)
    np.testing.assert_array_equal(t_oh.carry_forward(vals, valid, -1.0),
                                  j_oh.carry_forward(vals, valid, -1.0))
    np.testing.assert_array_equal(t_oh.histogram_edges(-1.5, 2.0, 32),
                                  j_oh.histogram_edges(-1.5, 2.0, 32))


def test_morphology_additions_bit_equal(rng):
    masks = _blob_masks(rng)
    got = t_morph.largest_centroid_series(torch.from_numpy(masks))
    ref = j_morph.largest_centroid_series(jnp.asarray(masks))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    got = t_morph.first_area_series(torch.from_numpy(masks))
    ref = j_morph.first_area_series(jnp.asarray(masks))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    # one frame at a time, as the JAX functions take it
    for k in (0, 2):
        one = torch.from_numpy(masks[k])
        for g, r in zip(t_morph.component_areas_and_centroids(one),
                        j_morph.component_areas_and_centroids(
                            jnp.asarray(masks[k]))):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        for g, r in zip(t_morph.label_first_area(one),
                        j_morph.label_first_area(jnp.asarray(masks[k]))):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("filt", [False, True])
def test_av_centroid_matches_jax(rng, filt):
    """Carry-forward of the empty frame 0 (the image centre) and the
    savgol: the float32 centroids are whole-number sums under 2**24 here,
    so the track is bit-equal."""
    masks = _blob_masks(rng, n=12)
    masks[5] = False  # a middle empty frame takes the previous centroid
    stack = np.repeat(masks[..., None], 2, axis=3)
    got = t_cent.calc_AV_centroid(stack, 12, filter=filt, device="cpu")
    ref = j_cent.calc_AV_centroid(stack, 12, filter=filt)
    np.testing.assert_array_equal(got, ref)
    assert t_cent.find_correct_centroid([3, 9, 1], [(0, 0), (1, 2), (3, 3)]) \
        == j_cent.find_correct_centroid([3, 9, 1], [(0, 0), (1, 2), (3, 3)])


def test_components_match_jax(rng):
    flow = _masked_flow(rng)
    cents = rng.uniform(0, 12, size=(N, 2))
    cents[2] = (4.0, 9.0)  # the centroid on a pixel: a zero unit vector
    grid = t_comp.radial_vecgrid(torch.zeros(H, W), cents)
    rgrid = j_comp.radial_vecgrid(jnp.zeros((H, W)), jnp.asarray(cents))
    # XLA contracts this program's multiply-adds otherwise than
    # calculate_comp_magnitude's (bit-equal below): ulps
    np.testing.assert_allclose(grid.numpy(), np.asarray(rgrid), rtol=0,
                               atol=1e-6)
    assert float(grid[2, 4, 9].abs().sum()) == 0.0
    np.testing.assert_allclose(
        t_comp.calc_proj_mag(torch.from_numpy(flow), grid).numpy(),
        np.asarray(j_comp.calc_proj_mag(jnp.asarray(flow), rgrid)),
        rtol=0, atol=1e-6)  # a plain sum: XLA may contract it
    rad, lng = t_comp.calculate_comp_magnitude(torch.from_numpy(flow),
                                               cents[:5])
    rrad, rlng = j_comp.calculate_comp_magnitude(flow, cents[:5])
    assert rad.shape == (5, H, W)
    np.testing.assert_array_equal(rad.numpy(), np.asarray(rrad))
    np.testing.assert_array_equal(lng.numpy(), np.asarray(rlng))


def test_cart_to_polar_matches_jax(rng):
    flow = _masked_flow(rng)
    mag, ang = t_hist.cart_to_polar(torch.from_numpy(flow))
    rmag, rang = j_hist.cart_to_polar(jnp.asarray(flow))
    np.testing.assert_array_equal(mag.numpy(), np.asarray(rmag))
    np.testing.assert_allclose(ang.numpy(), np.asarray(rang), rtol=0,
                               atol=5e-7)
    assert float(ang.min()) >= 0 and float(ang.max()) < 2 * np.pi + 1e-6


def test_calculate_3dhist_matches_jax(rng):
    flow = _masked_flow(rng)
    got = t_hist.calculate_3dhist(torch.from_numpy(flow), N - 1, nbins=32,
                                  percentile=99)
    ref = j_hist.calculate_3dhist(jnp.asarray(flow), N - 1, nbins=32,
                                  percentile=99)
    mag_f, ang_f, mag_e, ang_e, perc = got
    np.testing.assert_array_equal(mag_f, ref[0])
    np.testing.assert_array_equal(mag_e, ref[2])
    np.testing.assert_array_equal(perc, ref[4])
    # an ulp of atan2 may move an angle to the neighbouring bin
    assert np.abs(ang_f - ref[1]).sum(axis=1).max() <= 2
    np.testing.assert_allclose(ang_e, ref[3], rtol=0, atol=1e-6)
    assert mag_f.shape == (N - 1, 32) and perc[1] == perc[0]  # carried


def test_calculate_3dhist_radlong_matches_jax(rng):
    flow = _masked_flow(rng, n=12)
    av = np.repeat(_blob_masks(rng, n=12)[..., None], 2, axis=3)
    got = t_hist.calculate_3dhist_radlong(torch.from_numpy(flow), av, 11,
                                          nbins=32)
    ref = j_hist.calculate_3dhist_radlong(jnp.asarray(flow), av, 11,
                                          nbins=32)
    for key in ("radial", "longitudinal"):
        freq, edges, hi, lo = got[key]
        rfreq, redges, rhi, rlo = ref[key]
        assert edges.shape == (32,)  # the reference's dropped last edge
        np.testing.assert_array_equal(freq, rfreq)
        np.testing.assert_array_equal(edges, redges)
        np.testing.assert_array_equal(hi, rhi)
        np.testing.assert_array_equal(lo, rlo)
    # one device pass per component equals the grouped pass
    rad, lng = t_comp.calculate_comp_magnitude(
        torch.from_numpy(flow), t_cent.calc_AV_centroid(av, 11, device="cpu"))
    freq, edges, hi, lo = t_hist.calc_bidirectional_hist(rad, 11, nbins=32)
    np.testing.assert_array_equal(hi, got["radial"][2])
    np.testing.assert_array_equal(edges[:-1], got["radial"][1])
    rfreq, redges, rhi, rlo = j_hist.calc_bidirectional_hist(
        np.asarray(rad), 11, nbins=32)
    np.testing.assert_array_equal(freq, rfreq)
    np.testing.assert_array_equal(lo, rlo)


@pytest.mark.parametrize("window,poly", [(10, 4), (7, 2)])
def test_savgol_matches_jax(rng, window, poly):
    track = np.cumsum(rng.normal(size=(23, 2)), axis=0) * 3.0
    np.testing.assert_array_equal(t_smooth.savgol_coeffs(window, poly),
                                  j_smooth.savgol_coeffs(window, poly))
    np.testing.assert_array_equal(
        t_smooth.savgol_filter_np(track, window, poly),
        j_smooth.savgol_filter_np(track, window, poly))
    got = t_smooth.savgol_filter_torch(
        torch.from_numpy(track.astype(np.float32)), window, poly)
    ref = j_smooth.savgol_filter_jnp(track.astype(np.float32), window, poly)
    span = float(np.ptp(track))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5 * span)
    # and the float32 twin within 1e-5 of the range of the float64 filter
    np.testing.assert_allclose(got.numpy(),
                               t_smooth.savgol_filter_np(track, window, poly),
                               rtol=0, atol=1e-5 * span)
    one = t_smooth.savgol_filter_torch(torch.from_numpy(
        track[:, 0].astype(np.float32)), window, poly)
    assert one.shape == (23,)
    with pytest.raises(ValueError):
        t_smooth.savgol_filter_torch(torch.zeros(window - 1), window, poly)


@pytest.mark.parametrize("n,pad", [(40, 20), (9, 20), (2, 20)])
def test_spectral_smooth_torch_matches_jax(rng, n, pad):
    series = rng.normal(size=(3, n)).cumsum(axis=1).astype(np.float32)
    got = t_sm.spectral_smooth_torch(torch.from_numpy(series), 0.3, pad)
    ref = j_sm.spectral_smooth_jnp(series, 0.3, pad)
    span = float(np.ptp(series)) or 1.0
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5 * span)
    np.testing.assert_allclose(got.numpy(), t_sm.spectral_smooth(series, 0.3,
                                                                 pad),
                               rtol=0, atol=1e-5 * span)
