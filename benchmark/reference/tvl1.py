"""Plain TV-L1 optical flow: the yardstick the clip cells' flow is held to.

A frozen copy of the plain PyTorch path of ``tee_optical_flow_torch``
(``ops/tvl1.tvl1_flow_pairs`` with ``tvl1_outer_loop_plain`` and
``tvl1_block_loop_plain`` from ``ops/tvl1_kernels.py``; the warps,
stencils, pyramid, resize and median of ``ops/warp.py``), taken at the
commit that defined the benchmark, so that a later change to the program
cannot move it. It imports nothing of the program.

Two additions of the benchmark's own:

  * ``dtype``: the whole solve in another floating type (the control
    computes in bfloat16);
  * ``Work``: per warp's loop (the program's K1 at levels under the size
    rule, the block loop above it), the pair-steps, the pair-medians and
    the evaluations of a pair's stop that the epsilon stop let run on
    these inputs, counted as the solve runs. ``benchmark/counts.py`` turns
    them into the least time the chip needs for the clip's TV-L1 work.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

GRAD_EPS = 1e-10
WARP_LOCAL_R = 8
# images per resize product on a card (the program's RESIZE_GROUP): an
# image's resize then does not depend on the images beside it
RESIZE_GROUP = 8


@dataclass
class Work:
    """Per warp's loop: (pairs, h, w, pair-steps, pair-medians, stop
    checks), a stop check being one pair's error sum (after every step
    under the per-iteration rule, after every block under the block
    rule); the counts stay on the device until ``calls`` is read."""

    _calls: List[tuple] = field(default_factory=list)

    def add(self, b: int, h: int, w: int, steps, medians, checks) -> None:
        self._calls.append((b, h, w, steps, medians, checks))

    @property
    def calls(self) -> List[Tuple[int, int, int, int, int, int]]:
        return [(b, h, w, int(s), int(m), int(c))
                for b, h, w, s, m, c in self._calls]


def pad_to_multiple(n: int, m: int) -> int:
    return int(math.ceil(n / m) * m) if m > 1 else int(n)


def per_iteration_stop(h: int, w: int) -> bool:
    """Whether a level of (h, w) takes the per-iteration epsilon stop (the
    TPU program's fused kernel fits VMEM: 11 float32 planes padded to
    (8, 128) tiles, 2x headroom, within 40 MiB) or the stop after two
    quiet 30-step blocks."""
    padded = pad_to_multiple(h, 8) * pad_to_multiple(w, 128)
    return 11 * padded * 4 * 2 <= 40 * 1024 * 1024


def _pad_edge(x, top, bottom, left, right):
    return F.pad(x[None], (left, right, top, bottom), mode="replicate")[0]


def _hat_weight(t):
    return torch.clamp_min(1.0 - torch.abs(t), 0.0)


def _catmull_rom_weight(t):
    a = torch.abs(t)
    w_inner = ((1.5 * a - 2.5) * a) * a + 1.0
    w_outer = ((-0.5 * a + 2.5) * a - 4.0) * a + 2.0
    return torch.where(a <= 1.0, w_inner,
                       torch.where(a < 2.0, w_outer, torch.zeros_like(a)))


def _gather_warp(imgs, ru, rv, base_x, base_y, kernel):
    """Sample each (B, H, W) image at (x + base_x + ru, y + base_y + rv)
    with the kernel's taps, edge-replicated; weights summed kx, then ky."""
    weight, extra = ((_hat_weight, 0) if kernel == "bilinear"
                     else (_catmull_rom_weight, 1))
    b, h, w = imgs[0].shape
    dev = ru.device
    x0 = torch.floor(ru)
    y0 = torch.floor(rv)
    offs = [float(j - extra) for j in range(2 + 2 * extra)]
    cols = torch.arange(w, device=dev, dtype=torch.int64).view(1, 1, w)
    rows = torch.arange(h, device=dev, dtype=torch.int64).view(1, h, 1)
    ix0 = cols + x0.to(torch.int64)
    iy0 = rows + y0.to(torch.int64)
    if base_x is not None:
        ix0 = ix0 + base_x.to(torch.int64)
        iy0 = iy0 + base_y.to(torch.int64)
    flat = [img.reshape(b, h * w) for img in imgs]
    wxs = [weight(ru - (x0 + o)) for o in offs]
    ixs = [torch.clamp(ix0 + int(o), 0, w - 1) for o in offs]
    outs = [None] * len(imgs)
    for oy in offs:
        wy = weight(rv - (y0 + oy))
        iy = torch.clamp(iy0 + int(oy), 0, h - 1) * w
        rowacc = [None] * len(imgs)
        for wx, ix in zip(wxs, ixs):
            idx = (iy + ix).reshape(b, h * w)
            for i, f in enumerate(flat):
                term = wx * torch.gather(f, 1, idx).reshape(b, h, w)
                rowacc[i] = term if rowacc[i] is None else rowacc[i] + term
        for i in range(len(imgs)):
            term = wy * rowacc[i]
            outs[i] = term if outs[i] is None else outs[i] + term
    return tuple(outs)


def warp_many_shift(imgs, u, v, max_disp, kernel):
    lim = float(int(max_disp)) - 1e-3
    return _gather_warp(imgs, torch.clamp(u, -lim, lim),
                        torch.clamp(v, -lim, lim), None, None, kernel)


def warp_many_shift_tiled2d(imgs, u, v, max_disp, local_r, kernel):
    """Per tile (quarter height rounded up to 8, half width rounded up to
    32) an integer base floor((min + max) / 2) of the clipped flow, zero
    flow in the padded part of edge tiles, and a clamped residual."""
    b, h, w = imgs[0].shape
    tile_h = pad_to_multiple(-(-h // 4), 8)
    tile_w = pad_to_multiple(-(-w // 2), 32)
    r, lr = int(max_disp), int(local_r)
    lim = float(r) - 1e-3
    u = torch.clamp(u, -lim, lim)
    v = torch.clamp(v, -lim, lim)
    nty, ntx = -(-h // tile_h), -(-w // tile_w)
    ph_, pw_ = nty * tile_h, ntx * tile_w

    def base(f):
        fp = F.pad(f, (0, pw_ - w, 0, ph_ - h))
        ft = fp.reshape(b, nty, tile_h, ntx, tile_w)
        lo = torch.amin(ft, dim=(2, 4))
        hi = torch.amax(ft, dim=(2, 4))
        t = torch.clamp(torch.floor((lo + hi) * 0.5), -r, r)
        full = t.repeat_interleave(tile_h, dim=1).repeat_interleave(
            tile_w, dim=2)
        return full[:, :h, :w]

    bx, by = base(u), base(v)
    rlim = float(lr) + 1.0 - 1e-3
    ru = torch.clamp(u - bx, -float(lr), rlim)
    rv = torch.clamp(v - by, -float(lr), rlim)
    return _gather_warp(imgs, ru, rv, bx, by, kernel)


def centered_gradient(img):
    px = _pad_edge(img, 0, 0, 1, 1)
    py = _pad_edge(img, 1, 1, 0, 0)
    return (0.5 * (px[:, :, 2:] - px[:, :, :-2]),
            0.5 * (py[:, 2:, :] - py[:, :-2, :]))


def forward_diff(f):
    dx = torch.cat([f[:, :, 1:] - f[:, :, :-1],
                    torch.zeros_like(f[:, :, :1])], dim=2)
    dy = torch.cat([f[:, 1:, :] - f[:, :-1, :],
                    torch.zeros_like(f[:, :1, :])], dim=1)
    return dx, dy


def divergence(p1, p2):
    d1 = torch.cat([p1[:, :, :1], p1[:, :, 1:-1] - p1[:, :, :-2],
                    -p1[:, :, -2:-1]], dim=2)
    d2 = torch.cat([p2[:, :1, :], p2[:, 1:-1, :] - p2[:, :-2, :],
                    -p2[:, -2:-1, :]], dim=1)
    return d1 + d2


@functools.lru_cache(maxsize=16)
def _gaussian_kernel(sigma: float, radius: int) -> Tuple[float, ...]:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    return tuple(float(c) for c in k.astype(np.float32))


def gaussian_blur(img, sigma: float):
    """Separable gaussian, replicate borders, summed tap by tap."""
    radius = max(1, int(math.ceil(3.0 * sigma)))
    k = _gaussian_kernel(float(sigma), radius)
    h, w = img.shape[1], img.shape[2]
    ph = _pad_edge(img, 0, 0, radius, radius)
    out = torch.zeros_like(img)
    for i in range(2 * radius + 1):
        out = out + k[i] * ph[:, :, i:i + w]
    pv = _pad_edge(out, radius, radius, 0, 0)
    out2 = torch.zeros_like(img)
    for i in range(2 * radius + 1):
        out2 = out2 + k[i] * pv[:, i:i + h, :]
    return out2


def _triangle_kernel(x):
    return np.maximum(np.float32(0.0), 1 - np.abs(x))


def _keys_cubic_kernel(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.
    out = np.where(x >= 1., ((-0.5 * x + 2.5) * x - 4.) * x + 2., out)
    return np.where(x >= 2., np.float32(0.), out).astype(np.float32)


@functools.lru_cache(maxsize=64)
def resize_weights(in_size: int, out_size: int, method: str) -> np.ndarray:
    """(in_size, out_size) float32 matrix of ``jax.image.resize``'s
    antialiased resampling (kernel widened by 1/scale when shrinking,
    renormalised at the borders, zero outside the input)."""
    kernel = _triangle_kernel if method == "bilinear" else _keys_cubic_kernel
    inv_scale = in_size / out_size
    kernel_scale = np.float32(max(inv_scale, 1.0))
    sample_f = ((np.arange(out_size, dtype=np.float32) + 0.5)
                * np.float32(inv_scale) - 0.5)
    x = (np.abs(sample_f[np.newaxis, :]
                - np.arange(in_size, dtype=np.float32)[:, np.newaxis])
         / kernel_scale)
    weights = kernel(x)
    total = np.sum(weights, axis=0, keepdims=True, dtype=np.float32)
    weights = np.where(
        np.abs(total) > 1000. * float(np.finfo(np.float32).eps),
        weights / np.where(total != 0, total, np.float32(1)),
        np.float32(0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[np.newaxis, :], weights,
                    np.float32(0)).astype(np.float32)


def resize(img, h: int, w: int, method: str):
    """(B, H, W) -> (B, h, w), one product per resized axis, over groups of
    RESIZE_GROUP images on a card."""
    b, in_h, in_w = img.shape
    ww = wh = None
    if in_w != w:
        ww = torch.from_numpy(resize_weights(in_w, w, method)).to(
            img.device, img.dtype)
    if in_h != h:
        wh = torch.from_numpy(resize_weights(in_h, h, method)).to(
            img.device, img.dtype)

    def products(x):
        if ww is not None:
            x = torch.matmul(x, ww)
        if wh is not None:
            x = torch.matmul(wh.t(), x)
        return x

    if img.device.type != "cuda":
        return products(img).contiguous()
    pad = (-b) % RESIZE_GROUP
    if pad:
        img = torch.cat([img, img[-1:].expand(pad, in_h, in_w)])
    return torch.cat([products(img[k:k + RESIZE_GROUP])
                      for k in range(0, b + pad, RESIZE_GROUP)])[:b]


def pyramid_shapes(h: int, w: int, nscales: int, zoom: float,
                   min_size: int = 16):
    shapes = [(h, w)]
    for _ in range(1, nscales):
        nh = int(round(shapes[-1][0] * zoom))
        nw = int(round(shapes[-1][1] * zoom))
        if nh < min_size or nw < min_size:
            break
        shapes.append((nh, nw))
    return shapes


SORT5_NETWORK = ((0, 1), (3, 4), (2, 4), (2, 3), (0, 3),
                 (0, 2), (1, 4), (1, 3), (1, 2))
COLUMN_MEDIAN_25_NETWORK = (
    (0, 5), (4, 9), (4, 5), (2, 7), (2, 4), (7, 5), (1, 6), (3, 8),
    (3, 6), (1, 2), (3, 4), (6, 7), (8, 5), (10, 15), (14, 19), (14, 15),
    (12, 17), (12, 14), (17, 15), (11, 16), (13, 18), (13, 16), (11, 12),
    (13, 14), (16, 17), (18, 15), (0, 10), (5, 15), (5, 10), (4, 14),
    (4, 5), (14, 10), (2, 12), (7, 17), (7, 12), (7, 5), (12, 14),
    (1, 11), (9, 19), (9, 11), (6, 16), (6, 9), (16, 11), (3, 13),
    (8, 18), (8, 13), (8, 9), (13, 16), (8, 5), (9, 12), (13, 14),
    (10, 20), (5, 10), (14, 24), (14, 10), (15, 22), (12, 15), (12, 14),
    (11, 21), (9, 11), (16, 11), (19, 23), (13, 19), (8, 13), (13, 16),
    (13, 14))
COLUMN_MEDIAN_25_TARGET = 14


def _compare_exchange(wires, network):
    for (i, j) in network:
        lo = torch.minimum(wires[i], wires[j])
        hi = torch.maximum(wires[i], wires[j])
        wires[i] = lo
        wires[j] = hi


def median_5x5(f):
    """5x5 median with edge replication (min/max only: exact)."""
    _, h, w = f.shape
    pv = _pad_edge(f, 2, 2, 0, 0)
    planes = [pv[:, dy:dy + h, :] for dy in range(5)]
    _compare_exchange(planes, SORT5_NETWORK)
    padded = [_pad_edge(p, 0, 0, 2, 2) for p in planes]
    wires = [padded[p][:, :, dx:dx + w] for dx in range(5) for p in range(5)]
    _compare_exchange(wires, COLUMN_MEDIAN_25_NETWORK)
    return wires[COLUMN_MEDIAN_25_TARGET]


def _step(rho_c, i1wx, i1wy, th, inv_grad, u, v, p11, p12, p21, p22, *,
          l_t, theta, taut):
    """One primal-dual iteration; returns (u, v, p11, p12, p21, p22)."""
    ltx = l_t * i1wx
    lty = l_t * i1wy
    rho = rho_c + i1wx * u + i1wy * v
    neg = rho < -th
    pos = rho > th
    rg = rho * inv_grad
    d1 = torch.where(neg, ltx, torch.where(pos, -ltx, -rg * i1wx))
    d2 = torch.where(neg, lty, torch.where(pos, -lty, -rg * i1wy))
    un = (u + d1) + theta * divergence(p11, p12)
    vn = (v + d2) + theta * divergence(p21, p22)
    ux, uy = forward_diff(un)
    vx, vy = forward_diff(vn)
    ng1 = 1.0 + taut * torch.sqrt(ux * ux + uy * uy)
    ng2 = 1.0 + taut * torch.sqrt(vx * vx + vy * vy)
    return (un, vn, (p11 + taut * ux) / ng1, (p12 + taut * uy) / ng1,
            (p21 + taut * vx) / ng2, (p22 + taut * vy) / ng2)


def _threshold(epsilon: float, h: int, w: int) -> float:
    """eps^2 * H * W rounded to float32."""
    return float(np.float32(epsilon * epsilon * h * w))


def _per_iteration_loop(consts, state, *, outer_iters, inner_iters,
                        use_median, epsilon, kw, work: Optional[Work]):
    """The per-iteration epsilon stop: err, a pair's sum of squared flow
    updates of its last step, starts at +inf; a pair whose err is not
    above eps^2*H*W is frozen before every median and every step."""
    b, h, w = state[0].shape
    if epsilon <= 0.0:
        for _ in range(outer_iters):
            if use_median:
                state = [median_5x5(state[0]), median_5x5(state[1]),
                         *state[2:]]
            for _ in range(inner_iters):
                state = list(_step(*consts, *state, **kw))
        if work is not None:
            work.add(b, h, w, b * outer_iters * inner_iters,
                     b * outer_iters if use_median else 0, 0)
        return state
    thresh = _threshold(epsilon, h, w)
    err = torch.full((b,), float("inf"), dtype=torch.float32,
                     device=state[0].device)
    steps = torch.zeros((), dtype=torch.int64, device=err.device)
    medians = torch.zeros_like(steps)
    for _ in range(outer_iters):
        if not bool((err > thresh).any()):
            break
        if use_median:
            act = err > thresh
            medians = medians + act.sum()
            m = act[:, None, None]
            state[0] = torch.where(m, median_5x5(state[0]), state[0])
            state[1] = torch.where(m, median_5x5(state[1]), state[1])
        for _ in range(inner_iters):
            act = err > thresh
            if not bool(act.any()):
                break
            steps = steps + act.sum()
            new = _step(*consts, *state, **kw)
            derr = torch.sum((new[0] - state[0]) ** 2
                             + (new[1] - state[1]) ** 2,
                             dim=(1, 2)).to(torch.float32)
            err = torch.where(act, derr, err)
            m = act[:, None, None]
            state = [torch.where(m, a, c) for a, c in zip(new, state)]
    if work is not None:
        work.add(b, h, w, steps, medians, steps)
    return state


def _block_loop(consts, state, *, outer_iters, inner_iters, use_median,
                epsilon, kw, work: Optional[Work]):
    """The stop after two quiet blocks: a pair freezes once two
    consecutive 30-step blocks each moved its flow (against the flow after
    the block's median) by less than eps^2*H*W in total."""
    b, h, w = state[0].shape
    thresh = _threshold(epsilon, h, w) if epsilon > 0 else -1.0
    strikes = torch.zeros((b,), dtype=torch.int32, device=state[0].device)
    blocks = torch.zeros((), dtype=torch.int64, device=state[0].device)
    for _ in range(outer_iters):
        act = strikes < 2
        if epsilon > 0 and not bool(act.any()):
            break
        blocks = blocks + act.sum()
        m = act[:, None, None]
        u, v = state[0], state[1]
        um = torch.where(m, median_5x5(u), u) if use_median else u
        vm = torch.where(m, median_5x5(v), v) if use_median else v
        new = [um, vm, *state[2:]]
        for _ in range(inner_iters):
            new = list(_step(*consts, *new, **kw))
        derr = torch.sum((new[0] - um) ** 2 + (new[1] - vm) ** 2,
                         dim=(1, 2)).to(torch.float32)
        if epsilon > 0:
            strikes = torch.where(
                act, torch.where(derr < thresh, strikes + 1,
                                 torch.zeros_like(strikes)), strikes)
        state = [torch.where(m, a, c)
                 for a, c in zip(new, [um, vm, *state[2:]])]
    if work is not None:
        work.add(b, h, w, blocks * inner_iters,
                 blocks if use_median else 0, blocks if epsilon > 0 else 0)
    return state


def _scale(i0, i1, u, v, *, lam, tau, theta, warps, outer_iters,
           inner_iters, use_median, max_disp, use_pallas, epsilon,
           warp_kernel, work):
    i1x, i1y = centered_gradient(i1)
    l_t = lam * theta
    taut = tau / theta
    kw = dict(l_t=l_t, theta=theta, taut=taut)
    zeros = torch.zeros_like(u)
    ps = [zeros, zeros, zeros, zeros]
    per_iter = (per_iteration_stop(i0.shape[1], i0.shape[2])
                if use_pallas else True)
    for _ in range(warps):
        if max_disp > WARP_LOCAL_R:
            i1w, i1wx, i1wy = warp_many_shift_tiled2d(
                (i1, i1x, i1y), u, v, max_disp, WARP_LOCAL_R, warp_kernel)
        else:
            i1w, i1wx, i1wy = warp_many_shift((i1, i1x, i1y), u, v,
                                              max_disp, warp_kernel)
        grad = i1wx * i1wx + i1wy * i1wy
        rho_c = i1w - i1wx * u - i1wy * v - i0
        th = l_t * grad
        inv_grad = torch.where(grad > GRAD_EPS,
                               1.0 / torch.clamp_min(grad, GRAD_EPS),
                               torch.zeros_like(grad))
        consts = (rho_c, i1wx, i1wy, th, inv_grad)
        loop_kw = dict(outer_iters=outer_iters, inner_iters=inner_iters,
                       use_median=use_median, epsilon=epsilon, kw=kw)
        if per_iter:
            state = _per_iteration_loop(consts, [u, v, *ps], work=work,
                                        **loop_kw)
        else:
            state = _block_loop(consts, [u, v, *ps], work=work, **loop_kw)
        u, v, ps = state[0], state[1], state[2:]
    return u, v


def flow_pairs(i0, i1, *, lam, tau, theta, nscales, zoom, warps,
               outer_iters, inner_iters, use_median, max_disp, use_pallas,
               epsilon, interpolation, work: Optional[Work] = None):
    """(B, H, W) pairs in [0, 255] -> (B, H, W, 2) flow (u = columns,
    v = rows), in the dtype of ``i0``."""
    b, h, w = i0.shape
    shapes = pyramid_shapes(h, w, nscales, zoom)
    pyr0, pyr1 = [i0], [i1]
    for (lh, lw) in shapes[1:]:
        pyr0.append(resize(gaussian_blur(pyr0[-1], 0.8), lh, lw, "bilinear"))
        pyr1.append(resize(gaussian_blur(pyr1[-1], 0.8), lh, lw, "bilinear"))
    ch, cw = shapes[-1]
    u = torch.zeros((b, ch, cw), dtype=i0.dtype, device=i0.device)
    v = torch.zeros_like(u)
    method = "bilinear" if interpolation == "bilinear" else "cubic"
    for lvl in range(len(shapes) - 1, -1, -1):
        lvl_disp = max(3, int(round(max_disp * (zoom ** lvl))) + 1)
        u, v = _scale(pyr0[lvl], pyr1[lvl], u, v, lam=lam, tau=tau,
                      theta=theta, warps=warps, outer_iters=outer_iters,
                      inner_iters=inner_iters, use_median=use_median,
                      max_disp=lvl_disp, use_pallas=use_pallas,
                      epsilon=epsilon, warp_kernel=interpolation, work=work)
        if lvl > 0:
            nh, nw = shapes[lvl - 1]
            sx = nw / shapes[lvl][1]
            sy = nh / shapes[lvl][0]
            u = resize(u, nh, nw, method) * sx
            v = resize(v, nh, nw, method) * sy
    return torch.stack([u, v], dim=-1)


def flow_kwargs(flow_cfg: dict) -> dict:
    """``flow_pairs``' keywords from a configuration file's ``flow``
    group (the program's OpticalFlowCalculationConfig field names)."""
    return dict(lam=flow_cfg["lambda_value"], tau=flow_cfg["tvl1_tau"],
                theta=flow_cfg["tvl1_theta"],
                nscales=flow_cfg["tvl1_nscales"],
                zoom=flow_cfg["tvl1_zoom_factor"],
                warps=flow_cfg["tvl1_warps"],
                outer_iters=flow_cfg["tvl1_outer_iterations"],
                inner_iters=flow_cfg["tvl1_inner_iterations"],
                use_median=flow_cfg["tvl1_median_filtering"],
                max_disp=flow_cfg["tvl1_max_displacement"],
                use_pallas=flow_cfg["tvl1_use_pallas"],
                epsilon=flow_cfg["tvl1_epsilon"],
                interpolation=flow_cfg["tvl1_interpolation"])


def clip_flow(images, flow_cfg: dict, work: Optional[Work] = None,
              dtype=torch.float32):
    """(N, H, W) flow-input images in [0, 255] -> (N-1, H, W, 2) flow of
    the consecutive pairs, solved at the spatial bucket (edge-replicated)
    when the configuration buckets shapes."""
    images = images.to(dtype)
    n, h, w = images.shape
    if flow_cfg["bucket_shapes"] and flow_cfg["spatial_bucket"] > 1:
        hb = pad_to_multiple(h, flow_cfg["spatial_bucket"])
        wb = pad_to_multiple(w, flow_cfg["spatial_bucket"])
        if (hb, wb) != (h, w):
            images = F.pad(images[None], (0, wb - w, 0, hb - h),
                           mode="replicate")[0]
    flow = flow_pairs(images[:-1].contiguous(), images[1:].contiguous(),
                      work=work, **flow_kwargs(flow_cfg))
    return flow[:, :h, :w, :]


def img2uint8(img):
    """Per-frame min-shift, max-scale to [0, 255]."""
    lo = torch.amin(img, dim=(-2, -1), keepdim=True)
    mx = torch.amax(img, dim=(-2, -1), keepdim=True)
    shifted = img - lo
    scaled = torch.where(mx > 0, shifted / mx, shifted)
    return torch.clamp(scaled, 0.0, 1.0) * 255.0
