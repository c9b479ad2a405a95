"""Per-frame masked histograms and percentiles, batched on the device (the
JAX package's ops/histogram.py).

The reference computes, frame by frame in Python, a histogram and
percentiles of the *nonzero* pixels with a clip-global bin range
(analysis.py:166-212, :215-286). Here the whole clip is a few tensor ops:
a scatter-add histogram and a sort-based masked percentile per frame.
Empty frames are flagged, and the reference's carry-forward policy is
applied by ``carry_forward`` on the host (tiny data, ragged policy).

Bit-equal to the JAX functions: the bucket is ``(x - lo) / span * nbins``
in float32 in XLA's order, floored and clipped; counts are whole numbers
added into float32, exact in any order; the percentile fraction is
``q * float32(1/100)``, as XLA computes the JAX source's ``q / 100.0``
(its simplifier turns a division by a constant into a product with the
float32 reciprocal: 99 / 100 gives 0.98999995, not 0.99), and the
interpolation ``lo*(1-frac) + hi*frac`` with XLA's fused multiply-add
(core.fma32). Which product XLA fuses depends on the program around it:
the second in ``masked_percentile`` compiled alone, the first inside
``framewise_hist_pack`` (the analysis's pass); each port function rounds
as its JAX twin does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import fma32

# XLA's float32 reciprocal of the constant 100 (see the module docstring)
INV_100 = np.float32(1.0) / np.float32(100.0)


def masked_histogram(frames: torch.Tensor, lo: torch.Tensor,
                     hi: torch.Tensor, nbins: int = 1000) -> torch.Tensor:
    """Histogram of nonzero pixels per frame over the global [lo, hi]
    range, np.histogram edge semantics (right-inclusive last bin).

    frames: (N, ...) -> returns (N, nbins) float32 counts.
    """
    n = frames.shape[0]
    flat = frames.reshape(n, -1).to(torch.float32)
    lo = torch.as_tensor(lo, dtype=torch.float32, device=flat.device)
    hi = torch.as_tensor(hi, dtype=torch.float32, device=flat.device)
    span = torch.clamp_min(hi - lo, 1e-12)
    scaled = (flat - lo) / span * nbins
    # np.histogram places x == hi in the last bin: the clip does it
    bucket = torch.clamp(torch.floor(scaled).to(torch.int32), 0, nbins - 1)
    # nonzero and in range, like np.histogram of the nonzero values
    weights = ((flat != 0) & (flat >= lo) & (flat <= hi)).to(torch.float32)
    counts = torch.zeros((n, nbins), dtype=torch.float32, device=flat.device)
    return counts.scatter_add_(1, bucket.to(torch.int64), weights)


def masked_percentile(frames: torch.Tensor, percentiles):
    """Per-frame percentiles of nonzero pixels (linear interpolation,
    np.percentile default).

    frames: (N, ...); percentiles: (P,) in [0, 100].
    Returns (values (N, P), valid (N,)) where valid marks frames with at
    least one nonzero pixel.
    """
    return _masked_percentile(frames, percentiles, fuse_lo=False)


def _masked_percentile(frames: torch.Tensor, percentiles, fuse_lo: bool):
    """masked_percentile, its interpolation's ``lo*(1-frac)`` product fused
    into the sum when ``fuse_lo``, else ``hi*frac`` (module docstring)."""
    n = frames.shape[0]
    flat = frames.reshape(n, -1).to(torch.float32)
    m = flat.shape[1]
    nonzero = flat != 0
    counts = nonzero.sum(dim=1)
    # push zeros (masked-out) to +inf so ascending sort packs the k nonzero
    # values into the first k slots
    srt = torch.sort(torch.where(nonzero, flat, torch.inf), dim=1).values

    q = torch.as_tensor(percentiles, device=flat.device).to(
        torch.float32) * torch.tensor(INV_100, device=flat.device)
    last = torch.clamp_min(counts - 1, 0)
    km1 = last.to(torch.float32)
    pos = q[None, :] * km1[:, None]            # (N, P) fractional index
    lo_i = torch.floor(pos).to(torch.int32)
    hi_i = torch.minimum(lo_i + 1, last[:, None].to(torch.int32))
    frac = pos - lo_i.to(torch.float32)
    lo_v = torch.gather(srt, 1, torch.clamp(lo_i, 0, m - 1).to(torch.int64))
    hi_v = torch.gather(srt, 1, torch.clamp(hi_i, 0, m - 1).to(torch.int64))
    if fuse_lo:
        vals = fma32(lo_v, 1 - frac, hi_v * frac)
    else:
        vals = fma32(hi_v, frac, lo_v * (1 - frac))
    return vals, counts > 0


def framewise_hist_pack(frames: torch.Tensor, percentiles,
                        nbins: int = 1000) -> torch.Tensor:
    """The whole per-frame analysis pass in one array: nonzero histogram
    over the clip-global range (zeros included in the range), nonzero
    percentiles, validity, and the global min/max; one copy to the host
    reads it all.

    Returns (N+1, nbins + P + 1) float32: rows 0..N-1 are
    [hist | percentile values | valid], row N is [gmin, gmax, 0...].
    """
    frames = frames.to(torch.float32)
    gmin = frames.min()
    gmax = frames.max()
    freq = masked_histogram(frames, gmin, gmax, nbins=nbins)
    vals, valid = _masked_percentile(frames, percentiles, fuse_lo=True)
    rows = torch.cat([freq, vals, valid.to(torch.float32)[:, None]], dim=1)
    tail = torch.zeros((1, rows.shape[1]), dtype=torch.float32,
                       device=rows.device)
    tail[0, 0] = gmin
    tail[0, 1] = gmax
    return torch.cat([rows, tail], dim=0)


def framewise_hist_pack_group(frames: torch.Tensor, percentiles,
                              nbins: int = 1000) -> torch.Tensor:
    """``framewise_hist_pack`` over a leading group axis: G independent
    arrays, each with its own global range and percentiles, returned as
    one tensor (one copy to the host).

    frames: (G, N, ...), percentiles: (G, P) -> (G, N+1, nbins + P + 1).
    """
    percentiles = torch.as_tensor(percentiles)
    return torch.stack([framewise_hist_pack(f, p, nbins=nbins)
                        for f, p in zip(frames, percentiles)])


def histogram_edges(lo: float, hi: float, nbins: int) -> np.ndarray:
    """np.histogram's bin edges for the global range (host helper)."""
    return np.linspace(lo, hi, nbins + 1)


def carry_forward(values: np.ndarray, valid: np.ndarray, default
                  ) -> np.ndarray:
    """Apply the reference's empty-frame policy on host: invalid frames
    take the previous valid frame's value; a leading invalid run takes
    ``default`` (analysis.py:192-202)."""
    values = np.array(values)
    valid = np.asarray(valid)
    out = values.copy()
    last = None
    for i in range(len(values)):
        if valid[i]:
            last = out[i]
        elif last is not None:
            out[i] = last
        else:
            out[i] = default
    return out
