"""Savitzky-Golay filtering (the JAX package's ops/smoothing.py).

Replaces scipy.signal.savgol_filter used on centroid tracks
(analysis.py:75-81). Coefficients are computed on the host;
``savgol_filter_np`` is the float64 host path (the JAX package's code line
for line), ``savgol_filter_torch`` the float32 device twin of its
``savgol_filter_jnp``: a correlation along the leading axis, with
scipy's default 'interp' edge mode as polynomial fits of the first and
last windows.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=32)
def savgol_coeffs(window: int, poly: int) -> np.ndarray:
    """Least-squares smoothing coefficients for the window centre at
    (window - 1) / 2, as scipy places it (the reference passes the even
    window 10, where scipy's centre is 4.5)."""
    if poly >= window:
        raise ValueError("polyorder must be less than window_length")
    pos = (window - 1) / 2.0
    x = np.arange(window, dtype=np.float64) - pos
    a = np.vander(x, poly + 1, increasing=True)  # (window, poly+1)
    # coefficients = first row of pinv: evaluate fitted poly at 0
    pinv = np.linalg.pinv(a)
    return pinv[0]


def savgol_filter_np(arr: np.ndarray, window: int, poly: int) -> np.ndarray:
    """scipy-compatible savgol along axis 0 with 'interp' edges."""
    arr = np.asarray(arr, dtype=np.float64)
    squeeze = arr.ndim == 1
    data = arr[:, None] if squeeze else arr
    n = data.shape[0]
    if n < window:
        raise ValueError("input shorter than window")
    coeffs = savgol_coeffs(window, poly)
    halflo = int(np.floor((window - 1) / 2.0))
    halfhi = window - 1 - halflo

    out = np.empty_like(data)
    # interior via correlation
    for j in range(data.shape[1]):
        conv = np.convolve(data[:, j], coeffs[::-1], mode="valid")
        out[halflo:n - halfhi, j] = conv
        # edge handling: fit a poly to the first/last window and evaluate
        x_head = np.arange(window)
        p_head = np.polyfit(x_head, data[:window, j], poly)
        out[:halflo, j] = np.polyval(p_head, x_head[:halflo])
        p_tail = np.polyfit(x_head, data[n - window:, j], poly)
        out[n - halfhi:, j] = np.polyval(p_tail, x_head[window - halfhi:])
    return out[:, 0] if squeeze else out


def savgol_filter_torch(arr: torch.Tensor, window: int, poly: int
                        ) -> torch.Tensor:
    """Float32 savgol of a (N,) or (N, C) tensor along axis 0 on its
    device: the interior as a correlation with the coefficients, the edges
    through the least-squares projectors of the first and last windows."""
    arr = arr.to(torch.float32)
    squeeze = arr.ndim == 1
    data = arr[:, None] if squeeze else arr
    n = data.shape[0]
    if n < window:
        raise ValueError("input shorter than window")
    dev = data.device
    coeffs = torch.from_numpy(savgol_coeffs(window, poly)).to(
        dev, torch.float32)
    halflo = int(np.floor((window - 1) / 2.0))
    halfhi = window - 1 - halflo

    # interior: (n - window + 1) valid positions, one correlation per column
    windows = data.unfold(0, window, 1)              # (n-window+1, C, window)
    interior = (windows * coeffs).sum(dim=-1)

    # edge projectors: evaluate the LS poly fit of the first/last window
    x = np.arange(window, dtype=np.float64)
    v = np.vander(x, poly + 1, increasing=True)
    proj = v @ np.linalg.pinv(v)  # (window, window) maps samples -> fit
    head_p = torch.from_numpy(proj[:halflo]).to(dev, torch.float32)
    tail_p = torch.from_numpy(proj[window - halfhi:]).to(dev, torch.float32)

    out = torch.cat([head_p @ data[:window], interior,
                     tail_p @ data[n - window:]], dim=0)
    return out[:, 0] if squeeze else out
