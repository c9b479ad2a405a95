"""Clip-shape bucketing and the device an entry point runs on.

Bucketing follows the JAX package's ``core.py``: pad the frame axis by
repeating the last frame (exact for every real frame, sliced off after),
and pad the flow solver's H/W by edge replication (the solve equals the
unpadded one away from the padded edge). On the TPU bucketing bounded jit
recompiles; the port keeps it because it decides the solver's shapes, and
with them the results.

``resolve_device`` is the port's rule for entry points: they run on
``cuda`` unless the caller asks for ``cpu``, and they raise when no CUDA
device is present and the CPU was not asked for.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from .utils.helpers import pad_to_multiple

__all__ = [
    "as_device_tensor", "bucketed_frame_count", "bucketed_spatial",
    "pad_clip_frames", "pad_spatial_edge", "pad_to_multiple",
    "resolve_device",
]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``cuda`` by default; raise if CUDA was meant and is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is present; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def as_device_tensor(x, device=None) -> torch.Tensor:
    """A tensor stays on its device unless ``device`` is given; a host
    array goes to ``device`` (``cuda`` by default, see resolve_device)."""
    if isinstance(x, torch.Tensor) and device is None:
        return x
    dev = resolve_device(device)
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


def bucketed_frame_count(n: int, frame_bucket: int) -> int:
    """Padded clip length: next multiple of ``frame_bucket`` (>= n)."""
    return pad_to_multiple(n, frame_bucket)


def bucketed_spatial(h: int, w: int, spatial_bucket: int) -> Tuple[int, int]:
    """Padded (H, W): next multiples of ``spatial_bucket``."""
    return (pad_to_multiple(h, spatial_bucket),
            pad_to_multiple(w, spatial_bucket))


def pad_clip_frames(clip: np.ndarray, n_target: int) -> np.ndarray:
    """Pad a (N, ...) host clip to ``n_target`` frames by repeating the
    last frame."""
    n = clip.shape[0]
    if n_target <= n:
        return clip
    reps = np.repeat(clip[-1:], n_target - n, axis=0)
    return np.concatenate([clip, reps], axis=0)


def pad_spatial_edge(images: torch.Tensor, h_target: int, w_target: int
                     ) -> torch.Tensor:
    """Edge-replicate pad (N, H, W) images on the bottom/right to
    (h_target, w_target); no-op when already at target."""
    h, w = images.shape[-2], images.shape[-1]
    ph, pw = h_target - h, w_target - w
    if ph == 0 and pw == 0:
        return images
    return F.pad(images[None], (0, pw, 0, ph), mode="replicate")[0]
