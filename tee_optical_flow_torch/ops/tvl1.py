"""Duality-based TV-L1 optical flow (Zach-Pock-Bischof), batched over
frame pairs: the port of the JAX package's ops/tvl1.py.

Algorithm and defaults follow OpenCV's DualTVL1 (tau=0.25, lambda=0.15,
theta=0.3, 5 scales at zoom 0.8, 5 warps, 10 outer x 30 inner iterations,
5x5 median of the flow at each outer iteration; Sanchez et al., IPOL
2013). Intensities are expected in [0, 255].

Each warp of each pyramid level runs one of two stopping rules, as the
TPU reference does (``_tvl1_scale``):

  * K1 (``tvl1_kernels.tvl1_outer_loop``): OpenCV's epsilon stop checked
    per pair before every median and every inner iteration;
  * K2 (``tvl1_kernels.tvl1_inner_block``) inside ``_tvl1_outer_eps_block``:
    a pair stops after two quiet 30-iteration blocks in a row.

Both are CUDA kernels on a card and plain PyTorch on the CPU.
"""

from __future__ import annotations

import functools

import torch

from ..core import as_device_tensor, pad_to_multiple
from .tvl1_kernels import tvl1_inner_block, tvl1_outer_loop
from .warp import (
    build_pyramid, centered_gradient, median_filter_5x5, pyramid_shapes,
    resize_bilinear, resize_cubic, warp_many_shift, warp_many_shift_tiled2d,
)

# the tiled warp takes over above this displacement bound (JAX package:
# per-tile integer bases + a small residual; radius 8, see
# warp.warp_many_shift_tiled2d)
_WARP_LOCAL_R = 8


def per_iteration_stop(h: int, w: int) -> bool:
    """Whether a pyramid level of (h, w) takes K1's per-iteration epsilon
    stop (True) or K2 inside the two-quiet-blocks stop (False).

    This is the arithmetic of the JAX package's ``fits_vmem_fused``
    (ops/tvl1_pallas.py:377-381): 11 planes of the image padded to the
    TPU's (8, 128) float32 tiling, with 2x headroom, within 40 MiB of
    VMEM. Hopper has no VMEM and the CUDA kernels have no size limit; the
    figure stays because on the TPU it decides which stopping rule, and so
    which answer, a level of each size gets, and the port gives the TPU
    reference's answer at every size."""
    padded = pad_to_multiple(h, 8) * pad_to_multiple(w, 128)
    return 11 * padded * 4 * 2 <= 40 * 1024 * 1024


def _tvl1_outer_eps_block(inner_block, u, v, p11, p12, p21, p22, *,
                          outer_iters, use_median, epsilon):
    """Epsilon stop at outer-block granularity (JAX package
    ops/tvl1.py:175-233), the rule of the levels K2 runs: a pair freezes
    after TWO CONSECUTIVE inner blocks each moved less than
    epsilon^2 * area in total (net block delta).

    ``inner_block(u, v, p11, p12, p21, p22) -> same 6-tuple`` runs one full
    inner block. The loop runs the whole budget with frozen pairs masked,
    which gives the JAX while_loop's result without a host wait."""
    bb, hh, ww = u.shape
    thresh = float(torch.tensor(epsilon * epsilon * hh * ww,
                                dtype=torch.float32))
    strikes = torch.zeros((bb,), dtype=torch.int32, device=u.device)
    state = (u, v, p11, p12, p21, p22)
    for _ in range(outer_iters):
        u, v, p11, p12, p21, p22 = state
        act = strikes < 2
        m = act[:, None, None]
        if use_median:
            um = torch.where(m, median_filter_5x5(u), u)
            vm = torch.where(m, median_filter_5x5(v), v)
        else:
            um, vm = u, v
        nu, nv, n11, n12, n21, n22 = inner_block(um, vm, p11, p12, p21, p22)
        derr = torch.sum((nu - um) ** 2 + (nv - vm) ** 2, dim=(1, 2))
        strikes = torch.where(
            act, torch.where(derr < thresh, strikes + 1,
                             torch.zeros_like(strikes)), strikes)
        state = (torch.where(m, nu, um), torch.where(m, nv, vm),
                 torch.where(m, n11, p11), torch.where(m, n12, p12),
                 torch.where(m, n21, p21), torch.where(m, n22, p22))
    return state


def _tvl1_scale(i0, i1, u, v, *, lam, tau, theta, warps, outer_iters,
                inner_iters, use_median, max_disp, use_pallas=False,
                epsilon=0.0, warp_kernel="bilinear"):
    """Run the primal-dual solver at one pyramid level. All (B, H, W).

    ``use_pallas`` selects the TPU reference's per-size rule
    (``per_iteration_stop``); without it every size takes K1's rule, as
    the JAX package's XLA path does."""
    i1x, i1y = centered_gradient(i1)
    l_t = lam * theta
    taut = tau / theta
    zeros = torch.zeros_like(u)
    p11, p12, p21, p22 = zeros, zeros, zeros, zeros
    k1 = per_iteration_stop(i0.shape[1], i0.shape[2]) if use_pallas else True

    for _ in range(warps):
        if max_disp > _WARP_LOCAL_R:
            i1w, i1wx, i1wy = warp_many_shift_tiled2d(
                (i1, i1x, i1y), u, v, max_disp=max_disp,
                local_r=_WARP_LOCAL_R, kernel=warp_kernel)
        else:
            i1w, i1wx, i1wy = warp_many_shift((i1, i1x, i1y), u, v,
                                              max_disp=max_disp,
                                              kernel=warp_kernel)
        grad = i1wx * i1wx + i1wy * i1wy
        rho_c = i1w - i1wx * u - i1wy * v - i0

        if k1:
            u, v, p11, p12, p21, p22 = tvl1_outer_loop(
                rho_c, i1wx, i1wy, grad, u, v, p11, p12, p21, p22,
                outer_iters=outer_iters, inner_iters=inner_iters,
                use_median=use_median, l_t=l_t, theta=theta, taut=taut,
                epsilon=epsilon)
            continue

        inner = functools.partial(tvl1_inner_block, rho_c, i1wx, i1wy, grad,
                                  n_iters=inner_iters, l_t=l_t, theta=theta,
                                  taut=taut)
        if epsilon > 0.0:
            u, v, p11, p12, p21, p22 = _tvl1_outer_eps_block(
                inner, u, v, p11, p12, p21, p22, outer_iters=outer_iters,
                use_median=use_median, epsilon=epsilon)
            continue
        for _ in range(outer_iters):
            if use_median:
                u = median_filter_5x5(u)
                v = median_filter_5x5(v)
            u, v, p11, p12, p21, p22 = inner(u, v, p11, p12, p21, p22)
    return u, v


def tvl1_flow_pairs(i0: torch.Tensor, i1: torch.Tensor, *,
                    lam: float = 0.15, tau: float = 0.25, theta: float = 0.3,
                    nscales: int = 5, zoom: float = 0.8, warps: int = 5,
                    outer_iters: int = 10, inner_iters: int = 30,
                    use_median: bool = True, max_disp: int = 16,
                    use_pallas: bool = False, epsilon: float = 0.0,
                    gamma: float = 0.0,
                    interpolation: str = "bilinear") -> torch.Tensor:
    """Dense flow for a batch of frame pairs, on the device of ``i0``.

    i0, i1: (B, H, W) float in [0, 255]. Returns (B, H, W, 2) float32 with
    flow[..., 0] = dx (columns), flow[..., 1] = dy (rows). The keywords
    are the JAX package's (see its docstring); ``use_pallas`` selects the
    TPU reference's per-size stopping rule (``per_iteration_stop``), and
    ``gamma`` > 0 (OpenCV's illumination term) is not yet ported."""
    if gamma > 0.0:
        raise NotImplementedError(
            "tvl1_gamma > 0 (the JAX package's _tvl1_scale_gamma) is not "
            "ported yet: ROADMAP.md, 'TV-L1 gamma'")
    if interpolation not in ("bilinear", "bicubic"):
        raise ValueError(f"unknown interpolation {interpolation!r}")
    i0 = i0.to(torch.float32)
    i1 = i1.to(torch.float32).to(i0.device)
    b, h, w = i0.shape
    shapes = pyramid_shapes(h, w, nscales, zoom)
    pyr0 = build_pyramid(i0, shapes)
    pyr1 = build_pyramid(i1, shapes)

    ch, cw = shapes[-1]
    u = torch.zeros((b, ch, cw), dtype=torch.float32, device=i0.device)
    v = torch.zeros_like(u)
    resize = resize_bilinear if interpolation == "bilinear" else resize_cubic
    for lvl in range(len(shapes) - 1, -1, -1):
        # motion measured in level-lvl pixels scales by zoom^lvl
        lvl_disp = max(3, int(round(max_disp * (zoom ** lvl))) + 1)
        u, v = _tvl1_scale(pyr0[lvl], pyr1[lvl], u, v,
                           lam=lam, tau=tau, theta=theta, warps=warps,
                           outer_iters=outer_iters, inner_iters=inner_iters,
                           use_median=use_median, max_disp=lvl_disp,
                           use_pallas=use_pallas, epsilon=epsilon,
                           warp_kernel=interpolation)
        if lvl > 0:
            nh, nw = shapes[lvl - 1]
            sx = nw / shapes[lvl][1]
            sy = nh / shapes[lvl][0]
            u = resize(u, nh, nw) * sx
            v = resize(v, nh, nw) * sy
    return torch.stack([u, v], dim=-1)


def tvl1_clip_flow(frames, config=None, device=None, **overrides
                   ) -> torch.Tensor:
    """Flow for all consecutive pairs of a (N, H, W) clip -> (N-1, H, W, 2).

    ``frames`` is a tensor (its device is used unless ``device`` is given)
    or a host array (sent to ``device``, ``cuda`` by default)."""
    params = dict(lam=0.15, tau=0.25, theta=0.3, nscales=5, zoom=0.8,
                  warps=5, outer_iters=10, inner_iters=30, use_median=True)
    if config is not None:
        params.update(
            lam=config.lambda_value, tau=config.tvl1_tau,
            theta=config.tvl1_theta, nscales=config.tvl1_nscales,
            zoom=config.tvl1_zoom_factor, warps=config.tvl1_warps,
            outer_iters=config.tvl1_outer_iterations,
            inner_iters=config.tvl1_inner_iterations,
            use_median=config.tvl1_median_filtering,
            max_disp=config.tvl1_max_displacement,
            epsilon=config.tvl1_epsilon,
            gamma=config.tvl1_gamma,
            interpolation=config.tvl1_interpolation,
            use_pallas=config.tvl1_use_pallas,
        )
    params.update(overrides)
    frames = as_device_tensor(frames, device)
    return tvl1_flow_pairs(frames[:-1], frames[1:], **params)

