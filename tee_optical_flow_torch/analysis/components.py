"""Radial / longitudinal flow decomposition about the AV centroid (the JAX
package's analysis/components.py).

Parity with reference analysis.py:89-163, in closed form batched over
frames: unit = (c - p)/||c - p||, radial = <flow, unit>, longitudinal =
<flow, (unit_1, -unit_0)>, on the flow's device.

The radial and longitudinal ``a*b + c*d`` are rounded as XLA's CPU
backend rounds the JAX package's (core.fma32; it leaves the norm's sum
uncontracted there), and the norm's root is correctly rounded
(core.sqrt32), so calculate_comp_magnitude agrees with it bit for bit.

Channel convention is preserved exactly as the reference pairs them
(analysis.py:104-119): unit channel 0 is the *row* delta and is dotted
with flow channel 0, channel 1 is the *column* delta dotted with flow
channel 1.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import as_device_tensor, fma32, sqrt32


def _centroid_tensor(centroids, device) -> torch.Tensor:
    """(N, 2) float32 centroids on ``device`` from a tensor or host array."""
    if isinstance(centroids, torch.Tensor):
        return centroids.to(device, torch.float32)
    return torch.as_tensor(np.asarray(centroids), dtype=torch.float32,
                           device=device)


def _unit_towards(centroids: torch.Tensor, h: int, w: int):
    """(N, H, W) row and column components of the unit vectors from every
    pixel towards its frame's centroid; 0 at the centroid itself."""
    dev = centroids.device
    rows = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    cols = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    dr = centroids[:, 0, None, None] - rows
    dc = centroids[:, 1, None, None] - cols
    norm = sqrt32(dr * dr + dc * dc)
    inv = torch.where(norm > 0, 1.0 / torch.clamp_min(norm, 1e-20),
                      torch.zeros((), dtype=torch.float32, device=dev))
    return dr * inv, dc * inv


def radial_vecgrid(h_w_dummy: torch.Tensor, centroids) -> torch.Tensor:
    """Unit-vector field toward per-frame centroids.

    h_w_dummy: any (H, W) tensor fixing the spatial shape and the device.
    centroids: (N, 2) as (row, col).
    Returns (N, H, W, 2) with nan-at-center replaced by 0
    (reference analysis.py:89-119).
    """
    h, w = h_w_dummy.shape
    ur, uc = _unit_towards(_centroid_tensor(centroids, h_w_dummy.device),
                           h, w)
    return torch.stack([ur, uc], dim=-1)


def calc_proj_mag(of_arr: torch.Tensor, unitvec_arr: torch.Tensor
                  ) -> torch.Tensor:
    """Dot product along the vector channel (reference analysis.py:122-134)."""
    return torch.sum(of_arr * unitvec_arr, dim=3)


def calculate_comp_magnitude(of_arr, centroids, verbose: bool = False):
    """(N, H, W, 2) flow + (N, 2) centroids -> (rad (N, H, W), long
    (N, H, W)) on the flow's device.

    Truncates flow to the centroid-track length like the reference
    (analysis.py:146)."""
    of_arr = as_device_tensor(of_arr)
    cents = _centroid_tensor(centroids, of_arr.device)
    nframes = cents.shape[0]
    flow = of_arr[:nframes].to(torch.float32)
    ur, uc = _unit_towards(cents, flow.shape[1], flow.shape[2])
    f0, f1 = flow[..., 0], flow[..., 1]
    rad = fma32(f0, ur, f1 * uc)
    # orthogonal unit = (uc, -ur)  (reference analysis.py:157)
    lng = fma32(f0, uc, -(f1 * ur))
    return rad, lng
