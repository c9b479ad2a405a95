"""Luma, per-frame normalisation and resizing (the JAX package's
ops/imaging.py).

Replaces skimage's rgb2gray and the reference's img2uint8 on the hot path
(reference calculate_optical_flow.py:399/586) with tensor ops batched over
frames, on whatever device the tensor lies; holds the ImageNet statistics
the SAM segmentor normalises with.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.tracing import count_sync
from .warp import _resize

# ITU-R BT.601 luma weights, matching skimage.color.rgb2gray
_LUMA = np.asarray([0.2125, 0.7154, 0.0721], dtype=np.float32)

# torchvision ImageNet statistics (reference calculate_optical_flow.py:59),
# the SAM segmentor's input normalisation
IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], dtype=np.float32)


def rgb2gray(frames: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) uint8/float -> (..., H, W) float32 luma in [0, 1]."""
    if frames.dtype == torch.uint8:
        frames = frames.to(torch.float32) / 255.0
    else:
        frames = frames.to(torch.float32)
    count_sync(frames.device)  # the weights' pageable upload waits
    return frames @ torch.from_numpy(_LUMA).to(frames.device)


def gray_from_clip(clip: torch.Tensor) -> torch.Tensor:
    """Luma for a clip that is either (..., H, W, 3) RGB or already a
    single (..., H, W) channel (a grayscale clip sent without its two
    redundant RGB copies: the luma weights sum to 1, so rgb2gray of
    R=G=B frames IS the channel)."""
    if clip.ndim >= 3 and clip.shape[-1] == 3:
        return rgb2gray(clip)
    if clip.dtype == torch.uint8:
        return clip.to(torch.float32) / 255.0
    return clip.to(torch.float32)


def img2uint8(img: torch.Tensor) -> torch.Tensor:
    """Min-shift, max-scale each (H, W) frame to [0, 255] (reference
    optical_flow_utils.py:30-31 semantics), kept float32 for the flow
    solver. ``img`` is (H, W) or (N, H, W); the min and max are taken per
    frame, as the JAX package's ``jax.vmap(img2uint8_jnp)`` does."""
    img = img.to(torch.float32)
    lo = torch.amin(img, dim=(-2, -1), keepdim=True)
    mx = torch.amax(img, dim=(-2, -1), keepdim=True)
    shifted = img - lo
    scaled = torch.where(mx > 0, shifted / mx, shifted)
    return torch.clamp(scaled, 0.0, 1.0) * 255.0


def normalize_imagenet(frames: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) in [0, 1] -> ImageNet-normalised."""
    mean = torch.from_numpy(IMAGENET_MEAN).to(frames.device)
    std = torch.from_numpy(IMAGENET_STD).to(frames.device)
    count_sync(frames.device, 2)  # two pageable uploads
    return (frames - mean) / std


# jax.image.resize's method names -> the port's resampling kernels
_RESIZE_METHODS = {"bilinear": "bilinear", "linear": "bilinear",
                   "bicubic": "cubic", "cubic": "cubic"}


def resize_frames(frames: torch.Tensor, height: int, width: int,
                  method: str = "bilinear") -> torch.Tensor:
    """Batched spatial resize of (N, H, W, C) or (N, H, W) to float32, with
    ``jax.image.resize``'s weights (antialiased when shrinking)."""
    if method not in _RESIZE_METHODS:
        raise ValueError(f"unsupported resize method {method!r}")
    frames = frames.to(torch.float32)
    kind = _RESIZE_METHODS[method]
    if frames.ndim == 3:
        return _resize(frames, height, width, kind)
    n, h, w, c = frames.shape
    planes = frames.permute(0, 3, 1, 2).reshape(n * c, h, w)
    out = _resize(planes, height, width, kind)
    return out.reshape(n, c, height, width).permute(0, 2, 3, 1).contiguous()
