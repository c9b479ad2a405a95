"""Otsu thresholding (the JAX package's ops/otsu.py: skimage
threshold_otsu semantics, 256 bins over [min, max], maximise the
inter-class variance, return the bin centre). Used by the no-SAM mask path
(reference predict_movie_thres, calculate_optical_flow.py:184-213).

The arithmetic stays float32 as in the reference. The weighted cumsum
feeds an argmax: another summation order (the CPU and the card each have
their own) can move a near-tie by one bin, so the tests hold the
thresholds equal on their content, and the first maximum is taken as
``jnp.argmax`` takes it.
"""

from __future__ import annotations

import torch


def _otsu_thresholds(frames: torch.Tensor, nbins: int) -> torch.Tensor:
    """(N, ...) -> (N,) float32 Otsu thresholds, one per leading index."""
    x = frames.to(torch.float32).reshape(frames.shape[0], -1)
    lo = torch.amin(x, dim=1, keepdim=True)
    hi = torch.amax(x, dim=1, keepdim=True)
    span = torch.clamp_min(hi - lo, 1e-12)
    bucket = torch.clamp(((x - lo) / span * nbins).to(torch.int64),
                         0, nbins - 1)
    # integer counts are exact in float32 at any clip size the path sees
    hist = torch.zeros((x.shape[0], nbins), dtype=torch.float32,
                       device=x.device)
    hist.scatter_add_(1, bucket, torch.ones_like(x))
    ar = torch.arange(nbins, dtype=torch.float32, device=x.device)
    centers = lo + (ar + 0.5) * span / nbins

    w1 = torch.cumsum(hist, dim=1)
    w2 = w1[:, -1:] - w1
    s1 = torch.cumsum(hist * centers, dim=1)
    mu1 = s1 / torch.clamp_min(w1, 1e-12)
    mu2 = (s1[:, -1:] - s1) / torch.clamp_min(w2, 1e-12)
    variance12 = w1 * w2 * (mu1 - mu2) ** 2
    # exclude the final bin (one class would be empty)
    variance12[:, -1] = -1.0
    idx = torch.argmax(variance12, dim=1, keepdim=True)  # first maximum
    return torch.gather(centers, 1, idx)[:, 0]


def threshold_otsu(image: torch.Tensor, nbins: int = 256) -> torch.Tensor:
    """Scalar Otsu threshold of one image (any shape)."""
    return _otsu_thresholds(image.reshape(1, -1), nbins)[0]


def otsu_mask_stack(frames: torch.Tensor, nbins: int = 256) -> torch.Tensor:
    """Per-frame Otsu binarisation of a (N, H, W) grayscale clip."""
    th = _otsu_thresholds(frames, nbins)
    return frames.to(torch.float32) > th[:, None, None]
