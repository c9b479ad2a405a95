"""Warping, stencils, pyramid and median primitives for the flow solvers
(the JAX package's ops/warp.py), as plain PyTorch batched over the leading
(pair) axis, on whatever device the tensors lie.

Conventions (as in the JAX package):
  * images are (B, H, W) float32;
  * flow is (u, v) = (column/x displacement, row/y displacement);
  * gradients use centred differences with replicated borders;
  * divergence is the negative adjoint of the forward-difference gradient.

The warps are written as gathers. The JAX package sums statically shifted
copies over every tap of a (2r+2)^2 window because gathers were slow on
the TPU. Taps outside the interpolation kernel's support carry weights of
exactly 0 and add exact zeros, so a gather of the 2x2 (hat) or 4x4
(Catmull-Rom) taps at the clamped position, with the same weights summed
in the same kx-then-ky order, is the same function at 1/25 of the
arithmetic. Index clamping is the JAX package's edge-replicate padding.

``median_filter_5x5`` is one of the port's CUDA kernels: on a CUDA tensor
it launches ``csrc/tvl1.cu``'s median kernel, on a CPU tensor it runs
``median_filter_5x5_plain`` beside it.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.helpers import pad_to_multiple
from ..utils.tracing import count, count_sync, trace_stage
from .cuda_lib import check_launch, launch_context, load_library, ptr


def _pad_edge(x: torch.Tensor, top: int, bottom: int, left: int,
              right: int) -> torch.Tensor:
    """Edge-replicate pad the last two axes of a (B, H, W) tensor."""
    return F.pad(x[None], (left, right, top, bottom), mode="replicate")[0]


def _hat_weight(t: torch.Tensor) -> torch.Tensor:
    """Bilinear hat kernel: w(t) = max(0, 1 - |t|), support (-1, 1)."""
    return torch.clamp_min(1.0 - torch.abs(t), 0.0)


def _catmull_rom_weight(t: torch.Tensor) -> torch.Tensor:
    """Catmull-Rom cubic-convolution kernel (Keys, a = -0.5), the kernel
    of the IPOL reference's bicubic_interpolation.c. Support (-2, 2)."""
    a = torch.abs(t)
    w_inner = ((1.5 * a - 2.5) * a) * a + 1.0          # |t| <= 1
    w_outer = ((-0.5 * a + 2.5) * a - 4.0) * a + 2.0   # 1 < |t| < 2
    return torch.where(a <= 1.0, w_inner,
                       torch.where(a < 2.0, w_outer, torch.zeros_like(a)))


def _kernel_taps(kernel: str):
    """(weight_fn, extra): the kernel reaches ``extra`` taps beyond the
    hat's two on each side."""
    if kernel == "bilinear":
        return _hat_weight, 0
    if kernel == "bicubic":
        return _catmull_rom_weight, 1
    raise ValueError(f"unknown warp kernel {kernel!r}")


def _gather_warp(imgs: Sequence[torch.Tensor], ru: torch.Tensor,
                 rv: torch.Tensor, base_x: Optional[torch.Tensor],
                 base_y: Optional[torch.Tensor], kernel: str):
    """Sample each (B, H, W) image at (x + base_x + ru, y + base_y + rv)
    with the kernel's taps, edge-replicated. ``base_*`` are integer-valued
    float offsets (None = 0); ``ru``/``rv`` the residuals the weights are
    evaluated at, exactly as the JAX shift-sum evaluates them."""
    weight, extra = _kernel_taps(kernel)
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


def bilinear_warp(img: torch.Tensor, u: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """Sample img at (x + u, y + v) with bilinear interpolation, the
    coordinates clamped to the border (replicate). img/u/v: (B, H, W).
    The JAX package's gather warp (ops/warp.py:56-85), weights and sums in
    its order."""
    b, h, w = img.shape
    dev = img.device
    rows = torch.arange(h, dtype=torch.float32, device=dev).view(1, h, 1)
    cols = torch.arange(w, dtype=torch.float32, device=dev).view(1, 1, w)
    ys = torch.clamp(rows + v, 0.0, h - 1.0)
    xs = torch.clamp(cols + u, 0.0, w - 1.0)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = ys - y0
    wx = xs - x0
    y0i = y0.to(torch.int64)
    x0i = x0.to(torch.int64)
    y1i = torch.clamp_max(y0i + 1, h - 1)
    x1i = torch.clamp_max(x0i + 1, w - 1)
    flat = img.reshape(b, h * w)

    def gather(yy, xx):
        idx = (yy * w + xx).reshape(b, h * w)
        return torch.gather(flat, 1, idx).reshape(b, h, w)

    top = gather(y0i, x0i) * (1 - wx) + gather(y0i, x1i) * wx
    bot = gather(y1i, x0i) * (1 - wx) + gather(y1i, x1i) * wx
    return top * (1 - wy) + bot * wy


def warp_many_shift(imgs, u: torch.Tensor, v: torch.Tensor,
                    max_disp: int = 8, kernel: str = "bilinear"):
    """Warp several images by the same flow, sharing the interpolation
    weights: each sample is taken at (x + u, y + v) with u, v clipped to
    +-(max_disp - 1e-3), as the JAX shift-sum's displacement bound."""
    lim = float(int(max_disp)) - 1e-3
    u = torch.clamp(u, -lim, lim)
    v = torch.clamp(v, -lim, lim)
    return _gather_warp(imgs, u, v, None, None, kernel)


def _tile_geometry(h: int, w: int) -> Tuple[int, int]:
    """The JAX package's adaptive tile: quarter height rounded up to 8,
    half width rounded up to 32 (ops/warp.py:247-250)."""
    return pad_to_multiple(-(-h // 4), 8), pad_to_multiple(-(-w // 2), 32)


def warp_many_shift_tiled2d(imgs, u: torch.Tensor, v: torch.Tensor,
                            max_disp: int = 16, local_r: int = 8,
                            kernel: str = "bilinear"):
    """The JAX package's 2-D tiled warp: the flow, clipped to
    +-(max_disp - 1e-3), splits per tile into an integer base
    floor((min + max) / 2) (clipped to +-max_disp) and a residual clamped
    to [-local_r, local_r + 1 - 1e-3]. The min and max run over the tile as
    the JAX package pads it, zero flow included in the padded part of edge
    tiles. Sampling happens at x + base + residual."""
    b, h, w = imgs[0].shape
    tile_h, tile_w = _tile_geometry(h, w)
    r = int(max_disp)
    lr = int(local_r)
    lim = float(r) - 1e-3
    u = torch.clamp(u, -lim, lim)
    v = torch.clamp(v, -lim, lim)
    nty = -(-h // tile_h)
    ntx = -(-w // tile_w)
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

    bx = base(u)
    by = base(v)
    rlim = float(lr) + 1.0 - 1e-3
    ru = torch.clamp(u - bx, -float(lr), rlim)
    rv = torch.clamp(v - by, -float(lr), rlim)
    return _gather_warp(imgs, ru, rv, bx, by, kernel)


def centered_gradient(img: torch.Tensor):
    """(dx, dy) via centred differences, replicate borders. img: (B, H, W)."""
    px = _pad_edge(img, 0, 0, 1, 1)
    py = _pad_edge(img, 1, 1, 0, 0)
    dx = 0.5 * (px[:, :, 2:] - px[:, :, :-2])
    dy = 0.5 * (py[:, 2:, :] - py[:, :-2, :])
    return dx, dy


def forward_diff(f: torch.Tensor):
    """Forward differences with zero at the far border (TV discretisation)."""
    dx = torch.cat([f[:, :, 1:] - f[:, :, :-1],
                    torch.zeros_like(f[:, :, :1])], dim=2)
    dy = torch.cat([f[:, 1:, :] - f[:, :-1, :],
                    torch.zeros_like(f[:, :1, :])], dim=1)
    return dx, dy


def divergence(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """div(p) = backward-diff_x(p1) + backward-diff_y(p2), the negative
    adjoint of forward_diff."""
    d1 = torch.cat([p1[:, :, :1],
                    p1[:, :, 1:-1] - p1[:, :, :-2],
                    -p1[:, :, -2:-1]], dim=2)
    d2 = torch.cat([p2[:, :1, :],
                    p2[:, 1:-1, :] - p2[:, :-2, :],
                    -p2[:, -2:-1, :]], dim=1)
    return d1 + d2


@functools.lru_cache(maxsize=16)
def _gaussian_kernel(sigma: float, radius: int) -> Tuple[float, ...]:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    return tuple(float(c) for c in k.astype(np.float32))


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable gaussian with replicate borders, summed tap by tap in the
    JAX package's order. img: (B, H, W)."""
    if sigma <= 0:
        return img
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


def _triangle_kernel(x: np.ndarray) -> np.ndarray:
    return np.maximum(np.float32(0.0), 1 - np.abs(x))


def _keys_cubic_kernel(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.
    out = np.where(x >= 1., ((-0.5 * x + 2.5) * x - 4.) * x + 2., out)
    return np.where(x >= 2., np.float32(0.), out).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _resize_weights(in_size: int, out_size: int, method: str) -> np.ndarray:
    """(in_size, out_size) float32 resampling matrix of
    ``jax.image.resize`` (its ``compute_weight_mat`` with antialiasing:
    the kernel widens by 1/scale on downsampling, weights renormalise at
    the borders, samples outside the input get weight 0). Written from
    its definition; torch's ``interpolate`` differs (no antialiasing here,
    a=-0.75 cubic, clamped borders)."""
    kernel = _triangle_kernel if method == "bilinear" else _keys_cubic_kernel
    scale = out_size / in_size
    inv_scale = 1.0 / scale
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


# images per product of a resize on a card (see _resize)
RESIZE_GROUP = 8


def _resize(img: torch.Tensor, h: int, w: int, method: str) -> torch.Tensor:
    """(B, H, W) -> (B, h, w): one float32 matrix product per resized axis
    (an unchanged axis is skipped, as jax.image.resize skips it).

    On a card the products run over groups of RESIZE_GROUP images, the
    last group padded with copies of the last image: cuBLAS picks its
    kernel, and with it the order of a dot product's sums, from the
    product's shape, and one product over the batch has a shape that
    grows with the batch (a 30x40 -> 60x80 cubic resize of 16 images
    differed from the same images' rows of a 32-image product by 3e-5 on
    an H100: PERF.md section 6, one-off measurements). With one shape for
    every group, an image's resize does not depend on the images beside
    it, and a pair's flow not on the pairs solved with it
    (flow/pipeline.compute_clip_flow_sharded is bit-equal to the
    unsharded solve)."""
    with trace_stage("resize"):
        b, in_h, in_w = img.shape
        ww = wh = None
        # the weights are pageable uploads: each waits on the card
        if in_w != w:
            ww = torch.from_numpy(_resize_weights(in_w, w, method)).to(
                img.device)
            count_sync(img.device)
        if in_h != h:
            wh = torch.from_numpy(_resize_weights(in_h, h, method)).to(
                img.device)
            count_sync(img.device)

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


def resize_bilinear(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, H, W) -> (B, h, w), ``jax.image.resize(method="bilinear")``."""
    return _resize(img, h, w, "bilinear")


def resize_cubic(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, H, W) -> (B, h, w) with the Keys a=-0.5 cubic,
    ``jax.image.resize(method="cubic")``."""
    return _resize(img, h, w, "cubic")


def pyramid_shapes(h: int, w: int, nscales: int, zoom: float,
                   min_size: int = 16):
    """Static per-level (H, W) list, finest first. Levels are dropped once
    either side would fall below ``min_size`` (OpenCV does the same)."""
    shapes = [(h, w)]
    for _ in range(1, nscales):
        nh = int(round(shapes[-1][0] * zoom))
        nw = int(round(shapes[-1][1] * zoom))
        if nh < min_size or nw < min_size:
            break
        shapes.append((nh, nw))
    return shapes


def build_pyramid(img: torch.Tensor, shapes, blur_sigma: float = 0.8):
    """Gaussian-blur + downsample chain; returns list finest-first."""
    levels = [img]
    for (h, w) in shapes[1:]:
        levels.append(resize_bilinear(gaussian_blur(levels[-1], blur_sigma),
                                      h, w))
    return levels


# Optimal 9-comparator sort-5 network (the JAX package's SORT5_NETWORK).
SORT5_NETWORK = ((0, 1), (3, 4), (2, 4), (2, 3), (0, 3),
                 (0, 2), (1, 4), (1, 3), (1, 2))

# Rank 12 (the median) of 25 values given as 5 PRE-SORTED columns of 5
# (wire c*5+p = position p, ascending, of column c): the JAX package's
# 66-comparator network; the answer lands on wire COLUMN_MEDIAN_25_TARGET.
# csrc/tvl1.cu spells out the same two networks (a test holds them equal).
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


def median_filter_5x5_plain(f: torch.Tensor, *,
                            err: Optional[torch.Tensor] = None,
                            thresh: float = 0.0) -> torch.Tensor:
    """5x5 median with edge replication, the plain version of the CUDA
    median (and the JAX package's ``median_filter_5x5``): sort the 5
    vertical-shift planes with SORT5_NETWORK, then select rank 12 of the
    25 with COLUMN_MEDIAN_25_NETWORK. Min/max only, so it is exact.

    With ``err`` ((B,) float32) a pair whose err is not above ``thresh``
    passes through unchanged (the epsilon stop's frozen pairs)."""
    _, h, w = f.shape
    pv = _pad_edge(f, 2, 2, 0, 0)
    planes = [pv[:, dy:dy + h, :] for dy in range(5)]
    _compare_exchange(planes, SORT5_NETWORK)
    padded = [_pad_edge(p, 0, 0, 2, 2) for p in planes]
    wires = [padded[p][:, :, dx:dx + w] for dx in range(5) for p in range(5)]
    _compare_exchange(wires, COLUMN_MEDIAN_25_NETWORK)
    med = wires[COLUMN_MEDIAN_25_TARGET]
    if err is None:
        return med
    return torch.where((err > thresh)[:, None, None], med, f)


def median_filter_5x5(f: torch.Tensor) -> torch.Tensor:
    """5x5 median of each (H, W) plane of a (B, H, W) float32 tensor.

    On a CUDA tensor this launches ``tvl1_median5x5`` from
    ``csrc/tvl1.cu`` (the standalone form of the on-chip median ``med5``
    of the TPU kernel ``_fused_scale_kernel``, ops/tvl1_pallas.py:248,
    which K1 and the block loop run inside their own kernels; the TV-L1
    gamma solver calls this one); on a CPU tensor it runs
    ``median_filter_5x5_plain``.
    Counts its launches in the ``launches.median_filter_5x5`` counter."""
    if f.device.type == "cpu":
        return median_filter_5x5_plain(f)
    if f.device.type != "cuda" or f.dtype != torch.float32 or f.ndim != 3 or not f.is_contiguous():
        raise ValueError("median_filter_5x5 takes a contiguous (B, H, W) "
                         f"float32 tensor, got {f.dtype} {tuple(f.shape)} "
                         f"on {f.device}")
    b, h, w = f.shape
    out = torch.empty_like(f)
    lib = load_library()
    with launch_context(f.device) as stream:
        check_launch("tvl1_median5x5", lib.tvl1_median5x5(
            ptr(f), ptr(out), b, h, w, stream))
    count("launches.median_filter_5x5")
    return out
