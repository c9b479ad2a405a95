"""Spectral (Fourier low-pass) smoothing (the JAX package's
signal/smoother.py).

Replaces tsmoothie's ``SpectralSmoother`` used throughout the reference
(e.g. peak_detection.py:165-170, cardiac_cycle_detection.py:117-122): the
series is symmetric-padded by ``pad_len`` samples per side, transformed
with a real FFT, all bins with normalized frequency above
``smooth_fraction / 2`` are zeroed (i.e. the lowest ``smooth_fraction``
of the spectrum is kept), and the inverse transform is cropped back.

``spectral_smooth`` is the NumPy path (host waveforms and traces, the JAX
package's code line for line); ``spectral_smooth_torch`` is the twin of
its ``spectral_smooth_jnp`` for batched float32 series on a device.
"""

from __future__ import annotations

import numpy as np
import torch


def _pad_amount(n: int, pad_len: int) -> int:
    # symmetric padding cannot exceed the series length
    return int(max(0, min(pad_len, n - 1)))


def spectral_smooth(arr, smooth_fraction: float = 0.3, pad_len: int = 20):
    """Low-pass an array along its last axis. NumPy in, NumPy out."""
    arr = np.asarray(arr, dtype=np.float64)
    squeeze = arr.ndim == 1
    data = arr[None, :] if squeeze else arr
    n = data.shape[-1]
    if n < 3:
        return arr.copy()
    p = _pad_amount(n, pad_len)
    padded = np.pad(data, [(0, 0)] * (data.ndim - 1) + [(p, p)],
                    mode="symmetric")
    spectrum = np.fft.rfft(padded, axis=-1)
    freqs = np.fft.rfftfreq(padded.shape[-1])
    spectrum[..., freqs > smooth_fraction / 2.0] = 0.0
    smoothed = np.fft.irfft(spectrum, n=padded.shape[-1], axis=-1)
    out = smoothed[..., p:p + n]
    return out[0] if squeeze else out


def spectral_smooth_torch(arr: torch.Tensor, smooth_fraction: float = 0.3,
                          pad_len: int = 20) -> torch.Tensor:
    """Float32 low-pass of a (..., N) tensor along its last axis, on its
    device (the JAX package's ``spectral_smooth_jnp``)."""
    arr = arr.to(torch.float32)
    n = arr.shape[-1]
    if n < 3:
        return arr
    p = _pad_amount(n, pad_len)
    # numpy's "symmetric" pad: the edge sample is repeated in the mirror
    padded = torch.cat([arr[..., :p].flip(-1), arr,
                        arr[..., n - p:].flip(-1)], dim=-1)
    spectrum = torch.fft.rfft(padded, dim=-1)
    freqs = np.fft.rfftfreq(padded.shape[-1])  # host-computed mask
    keep = torch.from_numpy(freqs <= smooth_fraction / 2.0).to(arr.device)
    smoothed = torch.fft.irfft(spectrum * keep, n=padded.shape[-1], dim=-1)
    return smoothed[..., p:p + n]
