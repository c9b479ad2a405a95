"""Synthetic content with analytic ground-truth motion: textured pairs
and TEE-like sector echo pairs (the port's copy of the JAX package's
synthetic.py; ``bicubic_sample`` is the port's oracle copy's).

The masks report accuracy over the regions the pipeline consumes: the
masked analysis reads flow inside segmentation masks (myocardium/wall),
never the black outside-sector region or the near-zero-signal cavity.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from .ops.tvl1_oracle import bicubic_sample


def make_textured_pair(seed: int, h: int, w: int, shift=(2.0, -3.0)):
    """Smoothed speckle and its bicubic subpixel global shift by
    ``shift`` (rows, columns)."""
    from scipy import ndimage

    rng = np.random.default_rng(seed)
    img = ndimage.gaussian_filter(rng.uniform(size=(h, w)), 3.0)
    img = (img - img.min()) / (img.max() - img.min()) * 255.0
    i1 = ndimage.shift(img, shift, order=3, mode="nearest")
    return img.astype(np.float32), i1.astype(np.float32)


def echo_sector_masks(h: int, w: int) -> Dict[str, np.ndarray]:
    """Geometry masks for make_echo_pair's sector: 'sector' (inside the
    fan), 'wall' (the speckled myocardial ring), 'cavity' (dark
    near-zero-signal pool)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    ay, ax = -20.0, w / 2.0
    ang = np.arctan2(xx - ax, yy - ay)
    rad = np.hypot(xx - ax, yy - ay)
    sector = (np.abs(ang) < np.radians(38)) & (rad < 0.95 * h)
    cy, cx = 0.55 * h, 0.5 * w
    r_ell = np.hypot((yy - cy) / (0.28 * h), (xx - cx) / (0.22 * w))
    wall = (r_ell >= 0.75) & (r_ell < 1.35) & sector
    cavity = (r_ell < 0.75) & sector
    return {"sector": sector, "wall": wall, "cavity": cavity}


def make_echo_pair(seed: int, h: int, w: int, contraction: float = 0.04
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Synthetic TEE-like sector: speckled myocardial ring around a dark
    cavity inside a fan-shaped sector, contracting radially toward the
    ring centre (0.55 h, 0.5 w) by ``contraction`` (fraction of radius,
    ~3 px at the ring): i1(x) = i0(x + c (x - centre))."""
    from scipy import ndimage

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    masks = echo_sector_masks(h, w)
    sector = masks["sector"]

    # speckle field (multiplicative, echo-like)
    speckle = ndimage.gaussian_filter(rng.uniform(size=(h, w)), 1.2)
    speckle = (speckle - speckle.min()) / (speckle.max() - speckle.min())

    # myocardial ring around an elliptical cavity
    cy, cx = 0.55 * h, 0.5 * w
    r_ell = np.hypot((yy - cy) / (0.28 * h), (xx - cx) / (0.22 * w))
    ring = np.exp(-((r_ell - 1.0) / 0.25) ** 2)  # bright wall
    cavity = r_ell < 0.75
    img = (30.0 + 200.0 * ring) * (0.35 + 0.65 * speckle)
    img[cavity] *= 0.15
    img[~sector] = 0.0
    img = np.clip(img, 0, 255)

    # radial contraction about the cavity center: sample i0 at
    # x + c*(x - center) -> material moves inward by ~c*r
    dy = contraction * (yy - cy)
    dx = contraction * (xx - cx)
    i1 = bicubic_sample(img, xx + dx, yy + dy)
    i1[~sector] = 0.0
    return img.astype(np.float32), np.clip(i1, 0, 255).astype(np.float32)
