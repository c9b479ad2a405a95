"""Static fine-grained saliency (center-surround), batched on the device:
the port of the JAX package's ops/saliency.py, the flow input that
``process_video(no_saliency=False)`` feeds the solver.

Replaces cv2.saliency.StaticSaliencyFineGrained (reference
calculate_optical_flow.py:559-560, :585-586): on/off center-surround
differences over box surrounds of increasing size (Montabone & Soto
2010), summed over scales and min-max normalised to [0, 1] per frame.

Box means come from 2-D cumulative sums (integral images), summed here in
float64: in float32 a 480x640 integral image reaches ~8e7, where one ulp
is 8, and the normalised saliency loses ~1e-3 (the JAX package's float32
sums differ from the exact box mean by 7.6e-4 there). In float64 the
result is the exact box mean rounded once to float32, whichever device
sums it.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def _box_mean(img: torch.Tensor, radius: int) -> torch.Tensor:
    """Box mean over (2r+1)^2 windows with edge-replicated padding.
    img: (B, H, W) float32."""
    p = F.pad(img[None], (radius + 1, radius, radius + 1, radius),
              mode="replicate")[0].to(torch.float64)
    ii = torch.cumsum(torch.cumsum(p, dim=1), dim=2)
    k = 2 * radius + 1
    s = (ii[:, k:, k:] - ii[:, :-k, k:] - ii[:, k:, :-k] + ii[:, :-k, :-k])
    return (s / float(k * k)).to(torch.float32)


def fine_grained_saliency(frames: torch.Tensor,
                          radii: Sequence[int] = (2, 4, 8, 16)
                          ) -> torch.Tensor:
    """(B, H, W) grayscale in any range -> (B, H, W) saliency in [0, 1],
    on the device of ``frames``."""
    img = frames.to(torch.float32)
    on = torch.zeros_like(img)
    off = torch.zeros_like(img)
    for r in radii:
        surround = _box_mean(img, r)
        on = on + torch.clamp_min(img - surround, 0.0)
        off = off + torch.clamp_min(surround - img, 0.0)
    sal = on + off
    flat = sal.reshape(sal.shape[0], -1)
    lo = torch.amin(flat, dim=1)[:, None, None]
    hi = torch.amax(flat, dim=1)[:, None, None]
    return (sal - lo) / torch.clamp_min(hi - lo, 1e-12)
