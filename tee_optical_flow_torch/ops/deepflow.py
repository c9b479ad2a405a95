"""DeepFlow-style variational optical flow, batched over frame pairs: the
port of the JAX package's ops/deepflow.py (BASELINE config 2).

The reference's second flow algorithm is cv2.optflow.createOptFlow_DeepFlow
(calculate_optical_flow.py:565-568): DeepMatching correspondences feeding a
Brox-style variational energy with intensity + gradient constancy and a
smoothness term (Weinzaepfel et al., ICCV 2013). As in the JAX package:

- the variational refinement: coarse-to-fine warping, a fixed-point
  scheme of lagged-nonlinearity (psi) recomputes x red-black SOR sweeps
  (omega=1.6) per level. The solve is K3
  (``deepflow_kernels.sor_sweeps``): CUDA kernels on a card tensor, plain
  PyTorch on a CPU tensor;
- the matching term: dense patch-ZNCC matches over a bounded integer
  search window at the two coarsest levels, forward-backward verified,
  entering the energy as beta * conf * psi(|w - w_match|^2).

``deepflow_use_pallas`` in the configuration is kept for JSON
compatibility and read by nothing here. On the TPU it sent levels too
large for VMEM to the XLA solve, which computes the same function as the
kernel; on the card K3 runs at every level, whatever the flag says.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core import as_device_tensor
from .warp import (
    bilinear_warp, build_pyramid, centered_gradient, pyramid_shapes,
    resize_bilinear, resize_cubic, warp_many_shift, warp_many_shift_tiled2d,
)

# shift-warp residual radius above which the 2-D tiled decomposition
# takes over (same scheme as ops/tvl1.py)
_DF_LOCAL_R = 8


def _robust(x2: torch.Tensor) -> torch.Tensor:
    """Charbonnier penalty derivative psi'(x^2) = 1 / (2 sqrt(x^2 + eps^2))."""
    return 1.0 / (2.0 * torch.sqrt(x2 + 1e-6))


def _smoothness_weights(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """psi' of the flow gradient magnitude, per pixel."""
    ux, uy = centered_gradient(u)
    vx, vy = centered_gradient(v)
    return _robust(ux * ux + uy * uy + vx * vx + vy * vy)


def _box_mean(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Mean over a (2r+1)^2 window, zero-padded with true-count division
    (``lax.reduce_window`` "SAME" in the JAX package). Not saliency's
    edge-padded box mean."""
    k = 2 * radius + 1
    return F.avg_pool2d(x[:, None], k, stride=1, padding=radius,
                        count_include_pad=False)[:, 0]


def _shifts4(f: torch.Tensor):
    """(N, S, W, E) single-pixel shifts, edge-replicated: the border
    neighbour is the pixel itself, so border-edge flux vanishes."""
    p = F.pad(f[None], (1, 1, 1, 1), mode="replicate")[0]
    return (p[:, :-2, 1:-1], p[:, 2:, 1:-1],
            p[:, 1:-1, :-2], p[:, 1:-1, 2:])


def _checkerboard(shape, device=None) -> torch.Tensor:
    """Red pixels, (y + x) even, of a (..., H, W) shape."""
    h, w = shape[-2], shape[-1]
    yy = torch.arange(h, device=device).view(h, 1)
    xx = torch.arange(w, device=device).view(1, w)
    return (((yy + xx) % 2) == 0).expand(shape)


def _tie_bias(n2: int, tie_bias: float, r2max: float) -> float:
    """tie_bias * n2 / r2max in float32 steps, as the JAX scan rounds it
    (a float32 weak scalar times the int32 displacement norm)."""
    return float(np.float32(np.float32(tie_bias) * np.float32(n2))
                 / np.float32(r2max))


def coarse_match(i0: torch.Tensor, i1: torch.Tensor, *, radius: int = 4,
                 patch: int = 3, ncc_min: float = 0.3, fb_tol: float = 1.5,
                 margin_min: float = 0.02):
    """Dense integer matching via a patch-ZNCC cost volume.

    For every pixel of ``i0`` (B, h, w), searches ``i1`` over the
    (2*radius+1)^2 integer displacements (dy outer, dx inner) with
    zero-mean NCC over a (2*patch+1)^2 patch. The first strict maximum
    wins; ``second`` is the running runner-up, ties included. A NaN score
    (a slightly negative variance product from E[x^2] - m^2 rounding) never
    wins and poisons the runner-up, as in the JAX scan; candidates whose
    target patch leaves the image score -inf. Matches are forward-backward
    verified and must beat the runner-up by ``margin_min``.

    Returns (um, vm, conf): the match displacement fields and a {0, 1}
    confidence mask."""
    r2max = 2.0 * radius * radius
    tie_bias = margin_min / 2.0

    def best_match(a0, a1):
        b, h, w = a0.shape
        dev = a0.device
        m0 = _box_mean(a0, patch)
        var0 = _box_mean(a0 * a0, patch) - m0 * m0
        m1 = _box_mean(a1, patch)
        var1 = _box_mean(a1 * a1, patch) - m1 * m1
        pad = (radius, radius, radius, radius)
        p1, pm1, pv1 = (F.pad(t, pad) for t in (a1, m1, var1))
        yy = torch.arange(h, device=dev).view(h, 1)
        xx = torch.arange(w, device=dev).view(1, w)
        best = torch.full((b, h, w), float("-inf"), device=dev)
        second = best
        bu = torch.zeros((b, h, w), device=dev)
        bv = torch.zeros((b, h, w), device=dev)
        for dy in range(-radius, radius + 1):
            for dx in range(-radius, radius + 1):
                ys = slice(radius + dy, radius + dy + h)
                xs = slice(radius + dx, radius + dx + w)
                s1, sm1, sv1 = (t[:, ys, xs] for t in (p1, pm1, pv1))
                cov = _box_mean(a0 * s1, patch) - m0 * sm1
                ncc = cov * torch.rsqrt(var0 * sv1 + 1e-8)
                ncc = ncc - _tie_bias(dy * dy + dx * dx, tie_bias, r2max)
                valid = ((yy + dy >= patch) & (yy + dy < h - patch) &
                         (xx + dx >= patch) & (xx + dx < w - patch))
                ncc = torch.where(valid, ncc, float("-inf"))
                take = ncc > best
                second = torch.where(take, best, torch.maximum(second, ncc))
                best = torch.where(take, ncc, best)
                bu = torch.where(take, float(dx), bu)
                bv = torch.where(take, float(dy), bv)
        return bu, bv, best, second

    a0 = i0.to(torch.float32)
    a1 = i1.to(torch.float32)
    uf, vf, ncc_f, second_f = best_match(a0, a1)
    ub, vb, _, _ = best_match(a1, a0)
    # backward match sampled at the forward-matched position
    ub_at = bilinear_warp(ub, uf, vf)
    vb_at = bilinear_warp(vb, uf, vf)
    fb_ok = ((torch.abs(uf + ub_at) <= fb_tol) &
             (torch.abs(vf + vb_at) <= fb_tol))
    # ambiguous matches (runner-up within margin) carry no information
    informative = (ncc_f - second_f) > margin_min
    # source patches straddling the border are z-normalised on truncated
    # windows; don't trust them
    _, h, w = uf.shape
    yy = torch.arange(h, device=uf.device).view(h, 1)
    xx = torch.arange(w, device=uf.device).view(1, w)
    interior = ((yy >= patch) & (yy < h - patch) &
                (xx >= patch) & (xx < w - patch))
    conf = (fb_ok & informative & interior &
            (ncc_f > ncc_min)).to(torch.float32)
    return uf, vf, conf


def _sor_sweeps(i0, i1w, i1wx, i1wy, i1wxx, i1wxy, i1wyy, u0, v0, *,
                alpha, delta, gamma, psi_iters, sor_iters, omega,
                match=None, beta=0.0):
    """Fixed-point solve for the flow increment (du, dv): the temporal and
    gradient-constancy differences, then K3 (``sor_sweeps``)."""
    # imported here: deepflow_kernels imports this module's helpers
    from .deepflow_kernels import sor_sweeps

    it = i1w - i0                      # temporal intensity difference
    i0x, i0y = centered_gradient(i0)
    itx = i1wx - i0x                   # gradient-constancy temporal diffs
    ity = i1wy - i0y
    planes = [t.contiguous() for t in
              (i1wx, i1wy, i1wxx, i1wxy, i1wyy, it, itx, ity, u0, v0)]
    if match is not None:
        match = tuple(t.contiguous() for t in match)
    return sor_sweeps(
        *planes, match, psi_iters=psi_iters, sor_iters=sor_iters,
        omega=omega, alpha=alpha, delta=delta, gamma=gamma, beta=beta)


def deepflow_pairs(i0: torch.Tensor, i1: torch.Tensor, *,
                   alpha: float = 8.0, delta: float = 0.5, gamma: float = 5.0,
                   nscales: int = 5, zoom: float = 0.5,
                   iters: int = 12, psi_iters: int = 3, omega: float = 1.6,
                   matching: bool = True, match_radius: int = 4,
                   beta: float = 0.3, fp_iters: int = 3, max_disp: int = 16,
                   interpolation: str = "bilinear") -> torch.Tensor:
    """Variational flow for (B, H, W) pairs -> (B, H, W, 2), on the device
    of ``i0``. The keywords are the JAX package's (see its docstring):
    ``matching`` seeds the coarsest level and adds the matching term at
    the two coarsest levels; ``fp_iters`` re-warps per level, each with
    ``psi_iters`` x ``iters`` red-black SOR sweeps (relaxation ``omega``);
    ``max_disp`` bounds the finest-level displacement of the shift warp;
    ``interpolation`` picks the warp kernel and the inter-level upsample,
    "bilinear" or "bicubic"."""
    if interpolation not in ("bilinear", "bicubic"):
        raise ValueError(f"unknown interpolation {interpolation!r}")
    i0 = i0.to(torch.float32)
    i1 = i1.to(torch.float32).to(i0.device)
    b, h, w = i0.shape
    shapes = pyramid_shapes(h, w, nscales, zoom)
    pyr0 = build_pyramid(i0, shapes)
    pyr1 = build_pyramid(i1, shapes)
    match_levels = {len(shapes) - 1, len(shapes) - 2} if matching else set()

    ch, cw = shapes[-1]
    u = torch.zeros((b, ch, cw), dtype=torch.float32, device=i0.device)
    v = torch.zeros_like(u)
    coarsest_match = None
    if matching:
        # matches seed the coarsest level; unconfident pixels take a
        # confidence-weighted neighbourhood fill of the confident ones
        coarsest_match = coarse_match(pyr0[-1], pyr1[-1],
                                      radius=match_radius)
        um, vm, conf = coarsest_match
        fill = max(ch, cw) // 4 + 1
        wsum = _box_mean(conf, fill) + 1e-6
        u = _box_mean(um * conf, fill) / wsum
        v = _box_mean(vm * conf, fill) / wsum
    resize = resize_bilinear if interpolation == "bilinear" else resize_cubic
    for lvl in range(len(shapes) - 1, -1, -1):
        a0 = pyr0[lvl]
        a1 = pyr1[lvl]
        # per-level displacement bound of the shift warp: motion in
        # level-lvl pixels scales by zoom^lvl; the coarsest levels also
        # carry the matching seed (<= match_radius)
        lvl_disp = max(match_radius + 1 if matching else 3,
                       int(round(max_disp * (zoom ** lvl))) + 1)
        if lvl == len(shapes) - 1 and coarsest_match is not None:
            match = coarsest_match  # reuse the seed's cost volume
        elif lvl in match_levels:
            match = coarse_match(a0, a1, radius=match_radius)
        else:
            match = None
        # fixed-point outer loop: re-warp I1 and its five derivative
        # images around the updated flow, then solve for the increment
        i1x, i1y = centered_gradient(a1)
        i1xx, i1xy = centered_gradient(i1x)
        _, i1yy = centered_gradient(i1y)
        imgs = (a1, i1x, i1y, i1xx, i1xy, i1yy)
        for _ in range(fp_iters):
            if lvl_disp > _DF_LOCAL_R:
                warped = warp_many_shift_tiled2d(
                    imgs, u, v, max_disp=lvl_disp, local_r=_DF_LOCAL_R,
                    kernel=interpolation)
            else:
                warped = warp_many_shift(imgs, u, v, max_disp=lvl_disp,
                                         kernel=interpolation)
            du, dv = _sor_sweeps(a0, *warped, u, v, alpha=alpha,
                                 delta=delta, gamma=gamma,
                                 psi_iters=psi_iters, sor_iters=iters,
                                 omega=omega, match=match, beta=beta)
            u = u + du
            v = v + dv
        if lvl > 0:
            nh, nw = shapes[lvl - 1]
            sx = nw / shapes[lvl][1]
            sy = nh / shapes[lvl][0]
            u = resize(u, nh, nw) * sx
            v = resize(v, nh, nw) * sy
    return torch.stack([u, v], dim=-1)


def deepflow_config_kwargs(config=None) -> dict:
    """``deepflow_pairs``' keywords under ``config`` (the JAX package's
    clip defaults without one), as the clip entries pass them."""
    params = dict(alpha=8.0, delta=0.5, gamma=5.0, nscales=5, zoom=0.5,
                  iters=12, psi_iters=3, omega=1.6, matching=True,
                  match_radius=4, beta=0.3, fp_iters=3, max_disp=16,
                  interpolation="bicubic")
    if config is not None:
        params.update(alpha=config.deepflow_alpha, delta=config.deepflow_delta,
                      gamma=config.deepflow_gamma,
                      iters=config.deepflow_sor_iterations,
                      psi_iters=config.deepflow_psi_iterations,
                      omega=config.deepflow_omega,
                      nscales=config.deepflow_nscales,
                      matching=config.deepflow_matching,
                      match_radius=config.deepflow_match_radius,
                      beta=config.deepflow_beta,
                      fp_iters=config.deepflow_fp_iterations,
                      max_disp=config.deepflow_max_displacement,
                      interpolation=config.deepflow_interpolation)
    return params


def deepflow_clip_flow(frames, config=None, device=None, **overrides
                       ) -> torch.Tensor:
    """Flow for all consecutive pairs of a (N, H, W) clip -> (N-1, H, W, 2).

    ``frames`` is a tensor (its device is used unless ``device`` is given)
    or a host array (sent to ``device``, ``cuda`` by default)."""
    params = dict(deepflow_config_kwargs(config), **overrides)
    frames = as_device_tensor(frames, device)
    return deepflow_pairs(frames[:-1], frames[1:], **params)
