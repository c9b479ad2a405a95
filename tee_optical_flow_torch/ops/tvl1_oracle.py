"""Plain-NumPy TV-L1 reference oracle for golden-testing the solver.

The port's own copy of the JAX package's ops/tvl1_oracle.py (the port
imports nothing of that package, and the card's machine has no JAX); the
code is the same, and tests/test_torch_tvl1_oracle.py holds the two
bit-equal.

This is a faithful, sequential implementation of the published algorithm
OpenCV's ``cv2.optflow.createOptFlow_DualTVL1`` implements — Sánchez,
Meinhardt-Llopis & Facciolo, "TV-L1 Optical Flow Estimation", IPOL 2013
(itself Zach-Pock-Bischof 2007) — which is the reference pipeline's flow
backend (reference calculate_optical_flow.py:577-578, λ=0.15).

It exists because the environment has no cv2.optflow (cv2 5.0.0 without
contrib) and the reference's golden HDF5 artifacts are stripped: it is the
independent EPE oracle for BASELINE.md's "<0.1 px vs reference" north
star. Everything is double-precision NumPy with the IPOL paper's exact
discretizations:

- Catmull-Rom bicubic warping of I1 and its gradient (IPOL
  bicubic_interpolation.c), clamped (Neumann) borders;
- centered gradient with half-difference borders; forward-difference TV
  with zero far border; divergence as its negative adjoint;
- the thresholded data step / proximal dual update loop with the IPOL
  epsilon stopping criterion (mean-squared flow update > epsilon^2
  continues; OpenCV's area-scaled sum is the same test);
- OpenCV's additions on top of IPOL: the outer(10) x inner(30) iteration
  split and 5x5 median filtering of the flow at each outer iteration
  (BORDER_REPLICATE), enabled by default to match the reference solver;
- Gaussian anti-alias + bicubic pyramid downsampling with
  sigma = 0.6 * sqrt(1/zoom^2 - 1) (IPOL zoom.c), bicubic flow
  upsampling scaled by the per-axis size ratio.

NOT for production use: O(pairs * scales * warps * iters) sequential
NumPy, minutes per VGA pair. The production path is ops/tvl1.py.
"""

from __future__ import annotations

import math

import numpy as np

GRAD_IS_ZERO = 1e-10
ZOOM_SIGMA_ZERO = 0.6


def _cubic(v0, v1, v2, v3, x):
    """Catmull-Rom cubic convolution (the IPOL kernel)."""
    return v1 + 0.5 * x * (
        v2 - v0 + x * (2.0 * v0 - 5.0 * v1 + 4.0 * v2 - v3
                       + x * (3.0 * (v1 - v2) + v3 - v0)))


def bicubic_sample(img: np.ndarray, sx: np.ndarray, sy: np.ndarray) -> np.ndarray:
    """Sample ``img`` at float coords (sx, sy), clamped borders."""
    h, w = img.shape
    x0 = np.floor(sx).astype(np.int64)
    y0 = np.floor(sy).astype(np.int64)
    fx = sx - x0
    fy = sy - y0
    rows = []
    for dy in (-1, 0, 1, 2):
        yc = np.clip(y0 + dy, 0, h - 1)
        cols = [img[yc, np.clip(x0 + dx, 0, w - 1)] for dx in (-1, 0, 1, 2)]
        rows.append(_cubic(cols[0], cols[1], cols[2], cols[3], fx))
    return _cubic(rows[0], rows[1], rows[2], rows[3], fy)


def bicubic_warp(img: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    h, w = img.shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    return bicubic_sample(img, xx + u, yy + v)


def centered_gradient(img: np.ndarray):
    """IPOL mask_centered_gradient: half differences at the borders
    (identical to replicate-pad centered differences)."""
    px = np.pad(img, ((0, 0), (1, 1)), mode="edge")
    py = np.pad(img, ((1, 1), (0, 0)), mode="edge")
    dx = 0.5 * (px[:, 2:] - px[:, :-2])
    dy = 0.5 * (py[2:, :] - py[:-2, :])
    return dx, dy


def forward_gradient(f: np.ndarray):
    dx = np.zeros_like(f)
    dy = np.zeros_like(f)
    dx[:, :-1] = f[:, 1:] - f[:, :-1]
    dy[:-1, :] = f[1:, :] - f[:-1, :]
    return dx, dy


def divergence(p1: np.ndarray, p2: np.ndarray) -> np.ndarray:
    d1 = np.empty_like(p1)
    d1[:, 0] = p1[:, 0]
    d1[:, 1:-1] = p1[:, 1:-1] - p1[:, :-2]
    d1[:, -1] = -p1[:, -2]
    d2 = np.empty_like(p2)
    d2[0, :] = p2[0, :]
    d2[1:-1, :] = p2[1:-1, :] - p2[:-2, :]
    d2[-1, :] = -p2[-2, :]
    return d1 + d2


def median_5x5(f: np.ndarray) -> np.ndarray:
    """5x5 median, BORDER_REPLICATE (OpenCV medianBlur semantics)."""
    p = np.pad(f, 2, mode="edge")
    h, w = f.shape
    taps = np.stack([p[dy:dy + h, dx:dx + w]
                     for dy in range(5) for dx in range(5)], axis=-1)
    return np.median(taps, axis=-1)


def gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """Separable Gaussian, replicate borders (IPOL gaussian smoothing)."""
    if sigma <= 0:
        return img
    radius = max(1, int(math.ceil(3.0 * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    ph = np.pad(img, ((0, 0), (radius, radius)), mode="edge")
    out = sum(k[i] * ph[:, i:i + img.shape[1]] for i in range(k.size))
    pv = np.pad(out, ((radius, radius), (0, 0)), mode="edge")
    return sum(k[i] * pv[i:i + img.shape[0], :] for i in range(k.size))


def zoom_out(img: np.ndarray, nh: int, nw: int, zoom: float) -> np.ndarray:
    """IPOL zoom.c: anti-alias Gaussian then bicubic subsampling."""
    sigma = ZOOM_SIGMA_ZERO * math.sqrt(1.0 / (zoom * zoom) - 1.0)
    smoothed = gaussian_blur(img, sigma)
    h, w = img.shape
    yy, xx = np.mgrid[0:nh, 0:nw].astype(np.float64)
    return bicubic_sample(smoothed, xx * (w / nw), yy * (h / nh))


def zoom_in(f: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """Bicubic upsampling of a flow component to (nh, nw)."""
    h, w = f.shape
    yy, xx = np.mgrid[0:nh, 0:nw].astype(np.float64)
    return bicubic_sample(f, xx * (w / nw), yy * (h / nh))


def tvl1_scale_oracle(i0, i1, u, v, *, lam, tau, theta, warps, outer_iters,
                      inner_iters, epsilon, median_kernel, gamma=0.0,
                      w_illum=None):
    """One pyramid level of the IPOL/OpenCV primal-dual solver.

    ``gamma`` > 0 adds OpenCV DualTVL1's illumination term: a third primal
    field ``w_illum`` absorbing additive brightness change with its own TV
    dual, rho gaining +gamma*w and the data-step denominator gaining
    +gamma^2 (the float64 twin of ops/tvl1._tvl1_scale_gamma)."""
    l_t = lam * theta
    taut = tau / theta
    g2 = gamma * gamma
    i1x, i1y = centered_gradient(i1)
    h, w = i0.shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    p11 = np.zeros_like(u)
    p12 = np.zeros_like(u)
    p21 = np.zeros_like(u)
    p22 = np.zeros_like(u)
    wi = np.zeros_like(u) if w_illum is None else w_illum
    p31 = np.zeros_like(u)
    p32 = np.zeros_like(u)

    for _ in range(warps):
        sx, sy = xx + u, yy + v
        i1w = bicubic_sample(i1, sx, sy)
        i1wx = bicubic_sample(i1x, sx, sy)
        i1wy = bicubic_sample(i1y, sx, sy)
        grad = i1wx * i1wx + i1wy * i1wy + g2
        rho_c = i1w - i1wx * u - i1wy * v - i0

        error = np.inf
        for _outer in range(outer_iters):
            if error <= epsilon * epsilon:
                break
            if median_kernel == 5:
                u = median_5x5(u)
                v = median_5x5(v)
            for _inner in range(inner_iters):
                if error <= epsilon * epsilon:
                    break
                rho = rho_c + i1wx * u + i1wy * v + gamma * wi
                th = l_t * grad
                mask_lo = rho < -th
                mask_hi = rho > th
                mask_mid = ~(mask_lo | mask_hi) & (grad > GRAD_IS_ZERO)
                d1 = np.where(mask_lo, l_t * i1wx,
                              np.where(mask_hi, -l_t * i1wx, 0.0))
                d2 = np.where(mask_lo, l_t * i1wy,
                              np.where(mask_hi, -l_t * i1wy, 0.0))
                d3 = np.where(mask_lo, l_t * gamma,
                              np.where(mask_hi, -l_t * gamma, 0.0))
                safe_grad = np.where(grad > GRAD_IS_ZERO, grad, 1.0)
                d1 = np.where(mask_mid, -rho * i1wx / safe_grad, d1)
                d2 = np.where(mask_mid, -rho * i1wy / safe_grad, d2)
                d3 = np.where(mask_mid, -rho * gamma / safe_grad, d3)
                v1 = u + d1
                v2 = v + d2
                v3 = wi + d3
                uk, vk = u, v
                u = v1 + theta * divergence(p11, p12)
                v = v2 + theta * divergence(p21, p22)
                error = float(np.mean((u - uk) ** 2 + (v - vk) ** 2))
                ux, uy = forward_gradient(u)
                vx, vy = forward_gradient(v)
                ng1 = 1.0 + taut * np.sqrt(ux * ux + uy * uy)
                ng2 = 1.0 + taut * np.sqrt(vx * vx + vy * vy)
                p11 = (p11 + taut * ux) / ng1
                p12 = (p12 + taut * uy) / ng1
                p21 = (p21 + taut * vx) / ng2
                p22 = (p22 + taut * vy) / ng2
                if gamma > 0.0:
                    wi = v3 + theta * divergence(p31, p32)
                    wx_, wy_ = forward_gradient(wi)
                    ng3 = 1.0 + taut * np.sqrt(wx_ * wx_ + wy_ * wy_)
                    p31 = (p31 + taut * wx_) / ng3
                    p32 = (p32 + taut * wy_) / ng3
    return u, v, wi


def tvl1_flow_oracle(i0: np.ndarray, i1: np.ndarray, *,
                     lam: float = 0.15, tau: float = 0.25, theta: float = 0.3,
                     nscales: int = 5, zoom: float = 0.8, warps: int = 5,
                     outer_iters: int = 10, inner_iters: int = 30,
                     epsilon: float = 0.01, median_kernel: int = 5,
                     gamma: float = 0.0, min_size: int = 16) -> np.ndarray:
    """Dense TV-L1 flow for one frame pair, (H, W) in [0, 255] ->
    (H, W, 2) with flow[..., 0]=dx, flow[..., 1]=dy.

    Defaults are OpenCV's DualTVL1 defaults with the reference's λ=0.15
    already OpenCV's default. ``median_kernel=0`` gives the pure IPOL
    algorithm (no flow median); ``epsilon=0`` disables early stopping;
    ``gamma`` > 0 enables the illumination term (OpenCV default 0).
    """
    i0 = np.asarray(i0, np.float64)
    i1 = np.asarray(i1, np.float64)
    h, w = i0.shape
    shapes = [(h, w)]
    for _ in range(1, nscales):
        nh = int(round(shapes[-1][0] * zoom))
        nw = int(round(shapes[-1][1] * zoom))
        if nh < min_size or nw < min_size:
            break
        shapes.append((nh, nw))
    pyr0, pyr1 = [i0], [i1]
    for (nh, nw) in shapes[1:]:
        pyr0.append(zoom_out(pyr0[-1], nh, nw, zoom))
        pyr1.append(zoom_out(pyr1[-1], nh, nw, zoom))

    ch, cw = shapes[-1]
    u = np.zeros((ch, cw))
    v = np.zeros((ch, cw))
    wi = np.zeros((ch, cw))
    for lvl in range(len(shapes) - 1, -1, -1):
        u, v, wi = tvl1_scale_oracle(
            pyr0[lvl], pyr1[lvl], u, v, lam=lam, tau=tau, theta=theta,
            warps=warps, outer_iters=outer_iters, inner_iters=inner_iters,
            epsilon=epsilon, median_kernel=median_kernel, gamma=gamma,
            w_illum=wi)
        if lvl > 0:
            nh, nw = shapes[lvl - 1]
            u = zoom_in(u, nh, nw) * (nw / shapes[lvl][1])
            v = zoom_in(v, nh, nw) * (nh / shapes[lvl][0])
            # illumination is an intensity: upsampled without scaling
            wi = zoom_in(wi, nh, nw)
    return np.stack([u, v], axis=-1)


def epe(flow_a: np.ndarray, flow_b: np.ndarray) -> np.ndarray:
    """Per-pixel end-point error between two (..., 2) flow fields."""
    d = np.asarray(flow_a, np.float64) - np.asarray(flow_b, np.float64)
    return np.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2)
