"""Per-frame flow histograms + percentile traces (the JAX package's
analysis/histograms.py).

Parity with reference analysis.py:166-327, including its load-bearing
quirks, which downstream plotting depends on:
  * histogram counts get ``+1`` so LogNorm never sees zero (:207);
  * ``calculate_3dhist_radlong`` returns ``edges[:-1]`` (nbins values, not
    nbins+1; the viz layer reconstructs the final edge, :325-326);
  * empty frames carry the previous frame's values forward.

The per-frame work (cartToPolar, nonzero histograms over a clip-global
range, nonzero percentiles) runs batched on the device of the array it is
given (a host array goes to ``device``, ``cuda`` by default); each pass
comes back to the host in one copy, where the carry-forward runs.
"""

from __future__ import annotations

import logging
import math
from typing import Tuple

import numpy as np
import torch

from ..core import as_device_tensor, fma32, sqrt32
from ..ops.histogram import (
    carry_forward, framewise_hist_pack, framewise_hist_pack_group,
    histogram_edges,
)
from .centroid import calc_AV_centroid
from .components import calculate_comp_magnitude

logger = logging.getLogger(__name__)


def cart_to_polar(flow: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """cv2.cartToPolar semantics: magnitude and angle in [0, 2*pi).
    flow: (..., 2) -> (mag, ang) each (...). The magnitude rounds
    ``x*x + y*y`` once, as XLA does (core.fma32), and takes the correctly
    rounded root (core.sqrt32); the angle is torch's atan2, which may
    differ from XLA's by an ulp."""
    x = flow[..., 0].to(torch.float32)
    y = flow[..., 1].to(torch.float32)
    mag = sqrt32(fma32(x, x, y * y))
    ang = torch.atan2(y, x)
    ang = torch.where(ang < 0, ang + 2 * math.pi, ang)
    return mag, ang


def _framewise_hist_and_percentiles(arr, nframes: int, percs, nbins: int,
                                    device=None):
    """Shared device pass: global range, per-frame nonzero histogram (+1)
    and nonzero percentiles with reference carry-forward policy; one copy
    to the host (ops/histogram.framewise_hist_pack)."""
    dev = as_device_tensor(arr, device)[:nframes]
    pack = framewise_hist_pack(
        dev, torch.tensor(np.asarray(percs, np.float32)), nbins=nbins)
    return _unpack_one(pack.cpu().numpy(), nbins, len(percs))


def _unpack_one(pack, nbins: int, nperc: int):
    """Host-side unpack of one framewise_hist_pack result."""
    freq = pack[:-1, :nbins]
    vals = pack[:-1, nbins:nbins + nperc]
    valid = pack[:-1, -1] > 0
    gmin = float(pack[-1, 0])
    gmax = float(pack[-1, 1])
    for i in np.where(~valid)[0]:
        logger.warning("len(flat_nonzero) is 0 for frame %d", i)
    freq = carry_forward(freq + 1.0, valid, np.ones(nbins))
    edges = histogram_edges(gmin, gmax, nbins)
    return freq, edges, vals, valid, gmin, gmax


def _framewise_group(arrs, nframes: int, percs_list, nbins: int):
    """G same-shape device arrays through one grouped pack with one copy
    to the host (ops/histogram.framewise_hist_pack_group); per-element
    results identical to G separate _framewise_hist_and_percentiles
    calls. ``percs_list`` is a (G, P) list of per-element percentiles."""
    dev = torch.stack([a[:nframes] for a in arrs])
    p = np.asarray(percs_list, np.float32)
    packs = framewise_hist_pack_group(dev, torch.from_numpy(p),
                                      nbins=nbins).cpu().numpy()
    return [_unpack_one(packs[g], nbins, p.shape[1])
            for g in range(len(arrs))]


def calc_bidirectional_hist(mag_arr, nframes: int, perc_lo: int = 1,
                            perc_hi: int = 99, nbins: int = 1000,
                            device=None):
    """(freq (N, nbins), edges (nbins+1,), hi (N,), lo (N,)) —
    reference analysis.py:166-212."""
    freq, edges, vals, valid, gmin, gmax = _framewise_hist_and_percentiles(
        mag_arr, nframes, [perc_lo, perc_hi], nbins, device)
    lo = carry_forward(vals[:, 0], valid, gmin)
    hi = carry_forward(vals[:, 1], valid, gmax)
    return freq, edges, hi, lo


def calculate_3dhist(masked_arr, nframes: int, nbins: int = 1000,
                     percentile: int = 99, device=None):
    """(mag_freq, ang_freq, mag_edges, ang_edges, perc_hi) —
    reference analysis.py:215-286."""
    dev = as_device_tensor(masked_arr, device)[:nframes]
    mag, ang = cart_to_polar(dev)
    # mag and ang stay on the device, through one grouped pass
    (mag_freq, mag_edges, mvals, mvalid, _mmin, mmax), \
        (ang_freq, ang_edges, _avals, _avalid, _amin, _amax) = \
        _framewise_group((mag, ang), nframes, [[percentile], [50]], nbins)
    perc_hi = carry_forward(mvals[:, 0], mvalid, mmax)

    return mag_freq, ang_freq, mag_edges, ang_edges, perc_hi


def calculate_3dhist_radlong(param_arr, av_masks, nframes: int,
                             nbins: int = 1000, perc_lo: int = 1,
                             perc_hi: int = 99, av_filter_flag: bool = True,
                             av_savgol_window: int = 10,
                             av_savgol_poly: int = 4,
                             verbose: bool = False, device=None) -> dict:
    """Radial + longitudinal bidirectional histograms about the AV centroid
    (reference analysis.py:289-327). Returns dict with 'radial' and
    'longitudinal' -> (freq, edges[:-1], hi, lo). The centroids are
    labelled on the device ``param_arr`` lies on (or is sent to)."""
    param_dev = as_device_tensor(param_arr, device)
    centroids = calc_AV_centroid(av_masks, nframes, filter=av_filter_flag,
                                 savgol_window=av_savgol_window,
                                 savgol_poly=av_savgol_poly, verbose=verbose,
                                 device=param_dev.device)
    rad_arr, long_arr = calculate_comp_magnitude(param_dev, centroids)
    return _radlong_hists(rad_arr, long_arr, nframes, nbins, perc_lo,
                          perc_hi)


def _radlong_hists(rad_arr, long_arr, nframes: int, nbins: int,
                   perc_lo: int, perc_hi: int) -> dict:
    """calculate_3dhist_radlong's histograms from the radial and
    longitudinal arrays: one grouped device pass, results identical to
    two calc_bidirectional_hist calls."""
    percs = [[perc_lo, perc_hi]] * 2
    (rfreq, redges, rvals, rvalid, rmin, rmax), \
        (lfreq, ledges, lvals, lvalid, lmin, lmax) = \
        _framewise_group((rad_arr, long_arr), nframes, percs, nbins)
    rad = (rfreq, redges, carry_forward(rvals[:, 1], rvalid, rmax),
           carry_forward(rvals[:, 0], rvalid, rmin))
    lng = (lfreq, ledges, carry_forward(lvals[:, 1], lvalid, lmax),
           carry_forward(lvals[:, 0], lvalid, lmin))
    # the reference drops the last edge here (analysis.py:325-326); the viz
    # layer reconstructs it, preserved for artifact compatibility
    return {
        "radial": (rad[0], rad[1][:-1], rad[2], rad[3]),
        "longitudinal": (lng[0], lng[1][:-1], lng[2], lng[3]),
    }
