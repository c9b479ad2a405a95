"""Clip-shape bucketing and the device an entry point runs on.

Bucketing follows the JAX package's ``core.py``: pad the frame axis by
repeating the last frame (exact for every real frame, sliced off after),
and pad the flow solver's H/W by edge replication (the solve equals the
unpadded one away from the padded edge). On the TPU bucketing bounded jit
recompiles; the port keeps it because it decides the solver's shapes, and
with them the results.

``fma32`` rounds ``a*b + c`` once, as XLA's CPU backend does where the JAX
package writes ``a*b + c*d``; ``sqrt32`` is the correctly rounded float32
square root on every device.

``resolve_device`` is the port's rule for entry points: they run on
``cuda`` unless the caller asks for ``cpu``, and they raise when no CUDA
device is present and the CPU was not asked for.

``enable_compilation_cache`` is the port's counterpart of the JAX
package's persistent XLA cache: what the port compiles and keeps across
runs is its CUDA kernel library, so the function moves where that
library is built and looked for.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from .utils.helpers import pad_to_multiple

__all__ = [
    "as_device_tensor", "bucketed_frame_count", "bucketed_spatial",
    "enable_compilation_cache", "fma32",
    "pad_clip_frames", "pad_spatial_edge", "pad_to_multiple",
    "resolve_device", "sqrt32",
]


def enable_compilation_cache(cache_dir: str) -> bool:
    """Build and look for the CUDA kernel library (``ops/cuda_lib``) under
    ``cache_dir`` instead of ``build/kernels/`` in the checkout, so every
    run that points at the same directory after the first loads the
    library built there and skips nvcc. The port has no XLA executables
    to keep: the kernel library is the only thing it compiles and reuses
    across processes. A library already loaded in this process stays in
    use.

    Wired from ``DeviceConfig.compilation_cache_dir`` (cli/process
    --compilation_cache_dir / --config). Returns False, with a warning,
    when the directory cannot be made, instead of failing the run."""
    from .ops import cuda_lib

    try:
        os.makedirs(cache_dir, exist_ok=True)
    except OSError as exc:
        logging.getLogger(__name__).warning(
            "kernel build cache %s disabled (%r)", cache_dir, exc)
        return False
    cuda_lib.BUILD_DIR = Path(cache_dir)
    return True


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


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
          ) -> torch.Tensor:
    """float32 ``a*b + c`` with one rounding. XLA's CPU backend contracts
    the JAX package's float32 ``a*b + c*d`` into ``fma(a, b, c*d)`` (the
    first product fused), so this gives its bits: the product of two
    float32 is exact in float64, and the float64 sum is rounded to float32
    (a double rounding, which differs from a true fma only when the
    float64 sum falls exactly halfway between two float32 values)."""
    return (a.to(torch.float64) * b.to(torch.float64)
            + c.to(torch.float64)).to(torch.float32)


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root: torch's float32 sqrt on the
    CPU can be an ulp off (XLA's and CUDA's are IEEE); the float64 root of
    a float32, rounded to float32, is the correctly rounded one."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


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
