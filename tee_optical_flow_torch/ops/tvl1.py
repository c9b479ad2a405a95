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
  * the block loop (``tvl1_kernels.tvl1_block_loop``, K2's steps with the
    median fused in): a pair stops after two quiet 30-iteration blocks in
    a row.

Both run the whole per-warp loop on the device in one call on a card, and
plain PyTorch on the CPU.

With ``gamma`` > 0 (OpenCV's illumination term) every level takes
``_tvl1_scale_gamma`` instead: plain PyTorch on either device, as the JAX
package runs it in XLA outside any Pallas kernel; its 5x5 medians go
through ``warp.median_filter_5x5`` (the standalone CUDA median on a card).
"""

from __future__ import annotations

import torch

from ..core import as_device_tensor, pad_to_multiple
from ..utils.tracing import count_sync, trace_stage
from .tvl1_kernels import (
    _GRAD_EPS, _threshold, tvl1_block_loop, tvl1_outer_loop,
)
from .warp import (
    build_pyramid, centered_gradient, divergence, forward_diff,
    median_filter_5x5, pyramid_shapes, resize_bilinear, resize_cubic,
    warp_many_shift, warp_many_shift_tiled2d,
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


def _warp_level(i1, i1x, i1y, u, v, max_disp, warp_kernel):
    """I1 and its gradient warped by the flow (u, v)."""
    if max_disp > _WARP_LOCAL_R:
        return warp_many_shift_tiled2d(
            (i1, i1x, i1y), u, v, max_disp=max_disp, local_r=_WARP_LOCAL_R,
            kernel=warp_kernel)
    return warp_many_shift((i1, i1x, i1y), u, v, max_disp=max_disp,
                           kernel=warp_kernel)


def _gamma_step(consts, u, v, w, p11, p12, p21, p22, p31, p32, *, gamma,
                theta, taut):
    """One primal-dual iteration of the gamma solver in the JAX step's
    operation order (ops/tvl1.py:268-289 of the JAX package); ``consts``
    is (rho_c, i1wx, i1wy, th, inv_grad, ltx, lty, ltg). Returns (u, v,
    w, p11, p12, p21, p22, p31, p32)."""
    rho_c, i1wx, i1wy, th, inv_grad, ltx, lty, ltg = consts
    rho = rho_c + i1wx * u + i1wy * v + gamma * w
    neg = rho < -th
    pos = rho > th
    rg = rho * inv_grad
    d1 = torch.where(neg, ltx, torch.where(pos, -ltx, -rg * i1wx))
    d2 = torch.where(neg, lty, torch.where(pos, -lty, -rg * i1wy))
    d3 = torch.where(neg, ltg, torch.where(pos, -ltg, -rg * gamma))
    un = (u + d1) + theta * divergence(p11, p12)
    vn = (v + d2) + theta * divergence(p21, p22)
    wn = (w + d3) + theta * divergence(p31, p32)
    ux, uy = forward_diff(un)
    vx, vy = forward_diff(vn)
    wx, wy = forward_diff(wn)
    ng1 = 1.0 + taut * torch.sqrt(ux * ux + uy * uy)
    ng2 = 1.0 + taut * torch.sqrt(vx * vx + vy * vy)
    ng3 = 1.0 + taut * torch.sqrt(wx * wx + wy * wy)
    return (un, vn, wn,
            (p11 + taut * ux) / ng1, (p12 + taut * uy) / ng1,
            (p21 + taut * vx) / ng2, (p22 + taut * vy) / ng2,
            (p31 + taut * wx) / ng3, (p32 + taut * wy) / ng3)


def _tvl1_scale_gamma(i0, i1, u, v, w, *, lam, tau, theta, gamma, warps,
                      outer_iters, inner_iters, use_median, max_disp,
                      epsilon=0.0, warp_kernel="bilinear", level=None):
    """One pyramid level of the gamma-extended solver (the JAX package's
    ``_tvl1_scale_gamma``, ops/tvl1.py:236-348): a third primal field w
    models additive illumination change, the residual gains gamma*w, the
    data-step threshold uses grad + gamma^2, and w has its own TV dual
    (p31, p32). All (B, H, W).

    With epsilon > 0, the JAX package's two while-loops: per warp, err (a
    pair's sum of squared u/v updates of its last step) starts at +inf; a
    pair whose err is not above eps^2*H*W is frozen (its state kept) at
    every median and every step; err carries from the last step of an
    outer iteration into the next. Here the inner loop runs its full count
    (a frozen pair stays bit-still, so the state equals the while-loop's)
    and the outer loop ends once no pair is active: one host check per
    outer iteration, not one per step. ``level`` is the pyramid level,
    an attribute of the warp's ``tvl1_warp`` and ``tvl1_loop`` spans."""
    b, h, w_ = u.shape
    i1x, i1y = centered_gradient(i1)
    l_t = lam * theta
    taut = tau / theta
    kw = dict(gamma=gamma, theta=theta, taut=taut)
    thresh = _threshold(epsilon, h, w_) if epsilon > 0.0 else None
    ps = (torch.zeros_like(u),) * 6  # p11, p12, p21, p22, p31, p32

    for _ in range(warps):
        with trace_stage("tvl1_warp", level=level):
            i1w, i1wx, i1wy = _warp_level(i1, i1x, i1y, u, v, max_disp,
                                          warp_kernel)
            grad = i1wx * i1wx + i1wy * i1wy + gamma * gamma
            rho_c = i1w - i1wx * u - i1wy * v - i0
            th = l_t * grad
            inv_grad = torch.where(grad > _GRAD_EPS,
                                   1.0 / torch.clamp_min(grad, _GRAD_EPS),
                                   torch.zeros_like(grad))
            consts = (rho_c, i1wx, i1wy, th, inv_grad, l_t * i1wx, l_t * i1wy,
                      l_t * gamma)
            state = (u, v, w, *ps)
        with trace_stage("tvl1_loop", level=level):
            if thresh is None:
                for _ in range(outer_iters):
                    uu, vv, *rest = state
                    if use_median:
                        uu, vv = median_filter_5x5(uu), median_filter_5x5(vv)
                    state = (uu, vv, *rest)
                    for _ in range(inner_iters):
                        state = _gamma_step(consts, *state, **kw)
            else:
                err = torch.full((b,), float("inf"), dtype=torch.float32,
                                 device=u.device)
                for _ in range(outer_iters):
                    act = err > thresh
                    count_sync(act.device)
                    if not bool(act.any()):
                        break
                    if use_median:
                        m = act[:, None, None]
                        uu, vv, *rest = state
                        state = (torch.where(m, median_filter_5x5(uu), uu),
                                 torch.where(m, median_filter_5x5(vv), vv),
                                 *rest)
                    for _ in range(inner_iters):
                        act = err > thresh
                        new = _gamma_step(consts, *state, **kw)
                        derr = torch.sum((new[0] - state[0]) ** 2
                                         + (new[1] - state[1]) ** 2,
                                         dim=(1, 2))
                        err = torch.where(act, derr, err)
                        m = act[:, None, None]
                        state = tuple(torch.where(m, a, c)
                                      for a, c in zip(new, state))
        u, v, w, *ps = state
    return u, v, w


def _tvl1_scale(i0, i1, u, v, *, lam, tau, theta, warps, outer_iters,
                inner_iters, use_median, max_disp, use_pallas=False,
                epsilon=0.0, warp_kernel="bilinear", level=None):
    """Run the primal-dual solver at one pyramid level. All (B, H, W).

    ``use_pallas`` selects the TPU reference's per-size rule
    (``per_iteration_stop``); without it every size takes K1's rule, as
    the JAX package's XLA path does. Each warp is two spans, ``tvl1_warp``
    (the warp and the residual terms) and ``tvl1_loop`` (the loop's
    call), with ``level`` as their attribute."""
    i1x, i1y = centered_gradient(i1)
    l_t = lam * theta
    taut = tau / theta
    zeros = torch.zeros_like(u)
    p11, p12, p21, p22 = zeros, zeros, zeros, zeros
    k1 = per_iteration_stop(i0.shape[1], i0.shape[2]) if use_pallas else True

    loop = tvl1_outer_loop if k1 else tvl1_block_loop
    for _ in range(warps):
        with trace_stage("tvl1_warp", level=level):
            i1w, i1wx, i1wy = _warp_level(i1, i1x, i1y, u, v, max_disp,
                                          warp_kernel)
            grad = i1wx * i1wx + i1wy * i1wy
            rho_c = i1w - i1wx * u - i1wy * v - i0
        with trace_stage("tvl1_loop", level=level):
            u, v, p11, p12, p21, p22 = loop(
                rho_c, i1wx, i1wy, grad, u, v, p11, p12, p21, p22,
                outer_iters=outer_iters, inner_iters=inner_iters,
                use_median=use_median, l_t=l_t, theta=theta, taut=taut,
                epsilon=epsilon)
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
    TPU reference's per-size stopping rule (``per_iteration_stop``).
    ``gamma`` > 0 (OpenCV's illumination term) takes the gamma solver at
    every level, whatever ``use_pallas`` says, as in the JAX package."""
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
    w = torch.zeros_like(u)  # gamma's illumination field
    resize = resize_bilinear if interpolation == "bilinear" else resize_cubic
    kw = dict(lam=lam, tau=tau, theta=theta, warps=warps,
              outer_iters=outer_iters, inner_iters=inner_iters,
              use_median=use_median, epsilon=epsilon,
              warp_kernel=interpolation)
    for lvl in range(len(shapes) - 1, -1, -1):
        # motion measured in level-lvl pixels scales by zoom^lvl
        lvl_disp = max(3, int(round(max_disp * (zoom ** lvl))) + 1)
        if gamma > 0.0:
            u, v, w = _tvl1_scale_gamma(pyr0[lvl], pyr1[lvl], u, v, w,
                                        gamma=gamma, max_disp=lvl_disp,
                                        level=lvl, **kw)
        else:
            u, v = _tvl1_scale(pyr0[lvl], pyr1[lvl], u, v,
                               max_disp=lvl_disp, use_pallas=use_pallas,
                               level=lvl, **kw)
        if lvl > 0:
            nh, nw = shapes[lvl - 1]
            sx = nw / shapes[lvl][1]
            sy = nh / shapes[lvl][0]
            u = resize(u, nh, nw) * sx
            v = resize(v, nh, nw) * sy
            if gamma > 0.0:
                # illumination is an intensity, not a displacement: no
                # per-axis scale on upsampling
                w = resize(w, nh, nw)
    return torch.stack([u, v], dim=-1)


def tvl1_config_kwargs(config=None) -> dict:
    """``tvl1_flow_pairs``' keywords under ``config`` (the JAX package's
    defaults without one), as the clip entries pass them."""
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
    return params


def tvl1_clip_flow(frames, config=None, device=None, **overrides
                   ) -> torch.Tensor:
    """Flow for all consecutive pairs of a (N, H, W) clip -> (N-1, H, W, 2).

    ``frames`` is a tensor (its device is used unless ``device`` is given)
    or a host array (sent to ``device``, ``cuda`` by default)."""
    params = dict(tvl1_config_kwargs(config), **overrides)
    frames = as_device_tensor(frames, device)
    return tvl1_flow_pairs(frames[:-1], frames[1:], **params)
