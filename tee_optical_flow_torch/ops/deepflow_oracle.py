"""Plain-NumPy Brox/DeepFlow reference oracle for golden-testing the
second flow backend.

The port's own copy of the JAX package's ops/deepflow_oracle.py (the port
imports nothing of that package, and the card's machine has no JAX); the
code is the same, and tests/test_torch_tvl1_oracle.py holds the two
bit-equal.

The reference pipeline's second algorithm is
``cv2.optflow.createOptFlow_DeepFlow`` (reference
calculate_optical_flow.py:565-568): DeepMatching correspondences feeding
the Brox et al. 2004 variational energy ("High Accuracy Optical Flow
Estimation Based on a Theory for Warping") with the matching soft
constraint of Weinzaepfel et al., ICCV 2013 (eq. 2):

    E(w) = integral  delta * Psi(|I1(x+w) - I0(x)|^2)
         +           gamma * Psi(|grad I1(x+w) - grad I0(x)|^2)
         +           alpha * Psi(|grad u|^2 + |grad v|^2)
         +           beta  * conf(x) * Psi(|w - w_match|^2)

with Psi(s^2) = sqrt(s^2 + eps^2), eps = 1e-3. This oracle minimizes that
energy with the *published* sequential numerics — independent of the TPU
backend in ops/deepflow.py, which is the point of an oracle:

- coarse-to-fine pyramid (IPOL zoom.c anti-alias Gaussian + bicubic
  subsampling, reusing ops/tvl1_oracle helpers);
- Catmull-Rom bicubic warping of I1 and its four derivative images;
- nested fixed-point scheme: outer re-warp loop, lagged-nonlinearity
  (Psi-weight) loop, and a red-black successive-over-relaxation (SOR)
  solve of the coupled per-pixel 2x2 linear system — Gauss-Seidel
  ordering, not the backend's damped Jacobi;
- edge-averaged diffusivities w_{i+1/2,j} = (psi'_i + psi'_{i+1})/2 for
  div(psi' grad u) — the textbook discretization. Round 4: the backend
  now uses the same discretization (its previous central-weight
  approximation agreed with this only where psi' varies slowly, and was
  the dominant term of the round-3 echo EPE gap); the remaining numeric
  difference is damped Jacobi vs this oracle's red-black SOR ordering.

Matching enters exactly as in the backend: ``matches`` maps a pyramid
level index to that level's (um, vm, conf) fields, and ``init`` seeds the
coarsest level — pass the backend's own cost-volume outputs to compare
the variational solves under identical constraints (the matcher itself is
pinned by ground-truth displacement tests, test_deepflow_trainloop.py).

NOT for production use: sequential double-precision NumPy, ~10 s per VGA
pair. The production path is ops/deepflow.py.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from .tvl1_oracle import (
    bicubic_warp, centered_gradient, epe, zoom_in, zoom_out,
)

__all__ = ["deepflow_flow_oracle", "epe"]

_PSI_EPS2 = 1e-6  # eps^2 for Psi'(s^2) = 1 / (2 sqrt(s^2 + eps^2))


def _psi_deriv(s2: np.ndarray) -> np.ndarray:
    return 1.0 / (2.0 * np.sqrt(s2 + _PSI_EPS2))


def _shift(f: np.ndarray, dy: int, dx: int) -> np.ndarray:
    """f shifted so out[i, j] = f[i+dy, j+dx], zero outside."""
    h, w = f.shape
    out = np.zeros_like(f)
    ys = slice(max(dy, 0), h + min(dy, 0))
    yd = slice(max(-dy, 0), h + min(-dy, 0))
    xs = slice(max(dx, 0), w + min(dx, 0))
    xd = slice(max(-dx, 0), w + min(-dx, 0))
    out[yd, xd] = f[ys, xs]
    return out


def _edge_weights(w: np.ndarray):
    """Edge-averaged diffusivities; zero across the image border
    (homogeneous Neumann: no smoothness flux leaves the domain)."""
    wN = np.zeros_like(w)
    wS = np.zeros_like(w)
    wW = np.zeros_like(w)
    wE = np.zeros_like(w)
    wN[1:, :] = 0.5 * (w[1:, :] + w[:-1, :])
    wS[:-1, :] = 0.5 * (w[:-1, :] + w[1:, :])
    wW[:, 1:] = 0.5 * (w[:, 1:] + w[:, :-1])
    wE[:, :-1] = 0.5 * (w[:, :-1] + w[:, 1:])
    return wN, wS, wW, wE


def deepflow_scale_oracle(i0: np.ndarray, i1: np.ndarray,
                          u: np.ndarray, v: np.ndarray, *,
                          alpha: float, delta: float, gamma: float,
                          fp_iters: int, psi_iters: int, sor_iters: int,
                          omega: float,
                          match: Optional[Tuple[np.ndarray, np.ndarray,
                                                np.ndarray]] = None,
                          beta: float = 0.0):
    """One pyramid level of the Brox/DeepFlow fixed-point + SOR solver."""
    h, w_ = i0.shape
    yy, xx = np.mgrid[0:h, 0:w_]
    red = ((yy + xx) % 2 == 0)
    colors = (red, ~red)

    i0x, i0y = centered_gradient(i0)
    i1x, i1y = centered_gradient(i1)
    i1xx, i1xy = centered_gradient(i1x)
    _, i1yy = centered_gradient(i1y)

    if match is not None:
        um, vm, conf = (np.asarray(a, np.float64) for a in match)

    for _ in range(fp_iters):
        i1w = bicubic_warp(i1, u, v)
        i1wx = bicubic_warp(i1x, u, v)
        i1wy = bicubic_warp(i1y, u, v)
        i1wxx = bicubic_warp(i1xx, u, v)
        i1wxy = bicubic_warp(i1xy, u, v)
        i1wyy = bicubic_warp(i1yy, u, v)
        it = i1w - i0
        itx = i1wx - i0x
        ity = i1wy - i0y

        du = np.zeros_like(u)
        dv = np.zeros_like(v)
        for _ in range(psi_iters):
            # lagged data-term robust weights at the current increment
            r_int = it + i1wx * du + i1wy * dv
            r_gx = itx + i1wxx * du + i1wxy * dv
            r_gy = ity + i1wxy * du + i1wyy * dv
            psi_d = _psi_deriv(r_int * r_int) * delta
            psi_g = _psi_deriv(r_gx * r_gx + r_gy * r_gy) * gamma

            a11 = psi_d * i1wx * i1wx + psi_g * (i1wxx * i1wxx + i1wxy * i1wxy)
            a12 = psi_d * i1wx * i1wy + psi_g * (i1wxx * i1wxy + i1wxy * i1wyy)
            a22 = psi_d * i1wy * i1wy + psi_g * (i1wxy * i1wxy + i1wyy * i1wyy)
            b1 = -(psi_d * i1wx * it + psi_g * (i1wxx * itx + i1wxy * ity))
            b2 = -(psi_d * i1wy * it + psi_g * (i1wxy * itx + i1wyy * ity))

            if match is not None:
                ru = u + du - um
                rv = v + dv - vm
                a_m = beta * conf * _psi_deriv(ru * ru + rv * rv)
                a11 = a11 + a_m
                a22 = a22 + a_m
                b1 = b1 + a_m * (um - u)
                b2 = b2 + a_m * (vm - v)

            # lagged smoothness diffusivity on the full flow
            uf = u + du
            vf = v + dv
            ufx, ufy = centered_gradient(uf)
            vfx, vfy = centered_gradient(vf)
            psi_s = _psi_deriv(ufx * ufx + ufy * ufy +
                               vfx * vfx + vfy * vfy) * alpha
            wN, wS, wW, wE = _edge_weights(psi_s)
            wsum = wN + wS + wW + wE

            # constant part of the smoothness rhs: flux of the level's
            # base flow u across each edge (du part updates inside SOR)
            su0 = (wN * _shift(u, -1, 0) + wS * _shift(u, 1, 0) +
                   wW * _shift(u, 0, -1) + wE * _shift(u, 0, 1) - wsum * u)
            sv0 = (wN * _shift(v, -1, 0) + wS * _shift(v, 1, 0) +
                   wW * _shift(v, 0, -1) + wE * _shift(v, 0, 1) - wsum * v)

            for _ in range(sor_iters):
                for mask in colors:
                    dun = (wN * _shift(du, -1, 0) + wS * _shift(du, 1, 0) +
                           wW * _shift(du, 0, -1) + wE * _shift(du, 0, 1))
                    dvn = (wN * _shift(dv, -1, 0) + wS * _shift(dv, 1, 0) +
                           wW * _shift(dv, 0, -1) + wE * _shift(dv, 0, 1))
                    rhs1 = b1 + su0 + dun
                    rhs2 = b2 + sv0 + dvn
                    det = (a11 + wsum) * (a22 + wsum) - a12 * a12
                    det = np.where(np.abs(det) > 1e-12, det, 1e-12)
                    du_star = ((a22 + wsum) * rhs1 - a12 * rhs2) / det
                    dv_star = ((a11 + wsum) * rhs2 - a12 * rhs1) / det
                    du[mask] = (1.0 - omega) * du[mask] + omega * du_star[mask]
                    dv[mask] = (1.0 - omega) * dv[mask] + omega * dv_star[mask]
        u = u + du
        v = v + dv
    return u, v


def deepflow_flow_oracle(
        i0: np.ndarray, i1: np.ndarray, *,
        alpha: float = 8.0, delta: float = 0.5, gamma: float = 5.0,
        nscales: int = 5, zoom: float = 0.5,
        fp_iters: int = 3, psi_iters: int = 5, sor_iters: int = 25,
        omega: float = 1.6, min_size: int = 16,
        matches: Optional[Dict[int, Tuple[np.ndarray, np.ndarray,
                                          np.ndarray]]] = None,
        beta: float = 0.3,
        init: Optional[Tuple[np.ndarray, np.ndarray]] = None) -> np.ndarray:
    """Dense Brox/DeepFlow flow for one (H, W) frame pair in [0, 255] ->
    (H, W, 2) with flow[..., 0]=dx, flow[..., 1]=dy.

    Defaults mirror the TPU backend's (ops/deepflow.py): alpha/delta/gamma
    on raw [0, 255] intensities, the same pyramid-shape formula (round,
    levels dropped under ``min_size``). ``matches`` maps level index ->
    (um, vm, conf) at that level's resolution (the two coarsest levels in
    the backend); ``init`` seeds the coarsest level's flow.
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
    if init is not None:
        u = np.asarray(init[0], np.float64).copy()
        v = np.asarray(init[1], np.float64).copy()
    else:
        u = np.zeros((ch, cw))
        v = np.zeros((ch, cw))
    for lvl in range(len(shapes) - 1, -1, -1):
        match = matches.get(lvl) if matches else None
        u, v = deepflow_scale_oracle(
            pyr0[lvl], pyr1[lvl], u, v, alpha=alpha, delta=delta,
            gamma=gamma, fp_iters=fp_iters, psi_iters=psi_iters,
            sor_iters=sor_iters, omega=omega, match=match, beta=beta)
        if lvl > 0:
            nh, nw = shapes[lvl - 1]
            u = zoom_in(u, nh, nw) * (nw / shapes[lvl][1])
            v = zoom_in(v, nh, nw) * (nh / shapes[lvl][0])
    return np.stack([u, v], axis=-1)
