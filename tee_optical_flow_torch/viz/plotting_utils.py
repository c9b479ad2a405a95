"""Plotting helpers (the JAX package's viz/plotting_utils.py; reference
optical_flow/plotting_utils.py:13-162) and the colormap tables of the
overlay video.

This module imports no matplotlib: the helpers that make figures or look
up colormaps import it inside, and the ones that draw on an axis use the
axis the caller made. ``colormap_lut`` gives a colormap's lookup table
without matplotlib for the two colormaps the overlay video uses by
default (``VisualizationConfig.colormap_rad`` ``bwr`` and
``colormap_long`` ``BrBG``), from the port's own copy of matplotlib's
data for them, interpolated as matplotlib's ``LinearSegmentedColormap``
does; with matplotlib it takes the colormap's own table.
"""

from __future__ import annotations

import numpy as np
import torch

# matplotlib's _cm._bwr_data and _cm._BrBG_data (ColorBrewer BrBG): the
# colours LinearSegmentedColormap.from_list spaces evenly over [0, 1]
_LIST_COLORS = {
    "bwr": ((0.0, 0.0, 1.0), (1.0, 1.0, 1.0), (1.0, 0.0, 0.0)),
    "BrBG": (
        (0.32941176470588235, 0.18823529411764706, 0.0196078431372549),
        (0.5490196078431373, 0.3176470588235294, 0.0392156862745098),
        (0.7490196078431373, 0.5058823529411764, 0.17647058823529413),
        (0.8745098039215686, 0.7607843137254902, 0.49019607843137253),
        (0.9647058823529412, 0.9098039215686274, 0.7647058823529411),
        (0.9607843137254902, 0.9607843137254902, 0.9607843137254902),
        (0.7803921568627451, 0.9176470588235294, 0.8980392156862745),
        (0.5019607843137255, 0.803921568627451, 0.7568627450980392),
        (0.20784313725490197, 0.592156862745098, 0.5607843137254902),
        (0.00392156862745098, 0.4, 0.3686274509803922),
        (0.0, 0.23529411764705882, 0.18823529411764706)),
}


def pyplot():
    """matplotlib.pyplot, imported here on first use (Agg backend unless
    one is chosen already)."""
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def add_systole_diastole_shading(ax, frame_times, sys_frames, dia_frames,
                                 nframes: int, sys_color: str = "0.8",
                                 dia_color: str = "0.95") -> None:
    """Shade systole (dark) / diastole (light) frame intervals on a
    time axis (reference plotting_utils.py:13-57)."""
    frame_times = np.asarray(frame_times)
    first = True
    for start, stop in (sys_frames or []):
        start = int(np.clip(start, 0, nframes - 1))
        stop = int(np.clip(stop, 0, nframes - 1))
        ax.axvspan(frame_times[start], frame_times[stop], facecolor=sys_color,
                   alpha=0.5, label="systole" if first else None)
        first = False
    first = True
    for start, stop in (dia_frames or []):
        start = int(np.clip(start, 0, nframes - 1))
        stop = int(np.clip(stop, 0, nframes - 1))
        ax.axvspan(frame_times[start], frame_times[stop], facecolor=dia_color,
                   alpha=0.4, label="diastole" if first else None)
        first = False


def plot_waveform_with_shading(ax, waveform_data, waveform_times, frame_times,
                               sys_frames, dia_frames, nframes: int,
                               ylabel: str = "") -> None:
    """Waveform subplot under a heatmap with cycle shading
    (reference plotting_utils.py:60-82)."""
    waveform_data = np.asarray(waveform_data)
    if waveform_times is None:
        waveform_times = np.linspace(frame_times[0], frame_times[-1],
                                     waveform_data.size)
    ax.plot(np.asarray(waveform_times), waveform_data, lw=0.8)
    add_systole_diastole_shading(ax, frame_times, sys_frames, dia_frames,
                                 nframes)
    ax.set_xlabel("Time (ms)")
    if ylabel:
        ax.set_ylabel(ylabel)
    ax.set_xlim(frame_times[0], frame_times[-1])


def create_heatmap_figure(show_waveform: bool = False,
                          show_sysdia: bool = False):
    """Two heatmap panels + optional timeline strip, gridspec height
    ratios [4,4,1] / [4,4,0.5] (reference plotting_utils.py:85-116)."""
    plt = pyplot()
    if show_waveform:
        fig = plt.figure(figsize=(10, 9))
        gs = fig.add_gridspec(3, 1, height_ratios=[4, 4, 1])
        axes = [fig.add_subplot(gs[i]) for i in range(3)]
    elif show_sysdia:
        fig = plt.figure(figsize=(10, 8.5))
        gs = fig.add_gridspec(3, 1, height_ratios=[4, 4, 0.5])
        axes = [fig.add_subplot(gs[i]) for i in range(3)]
    else:
        fig = plt.figure(figsize=(10, 8))
        gs = fig.add_gridspec(2, 1)
        axes = [fig.add_subplot(gs[i]) for i in range(2)]
    return fig, axes


def setup_colorbar(mappable, ax, label: str = "") -> None:
    """(reference plotting_utils.py:119-128)."""
    cbar = pyplot().colorbar(mappable, ax=ax)
    if label:
        cbar.set_label(label)


def get_colormap(name: str):
    """Named matplotlib colormap with graceful viridis fallback
    (reference plotting_utils.py:131-141)."""
    plt = pyplot()
    try:
        return plt.get_cmap(name)
    except ValueError:
        return plt.get_cmap("viridis")


def annotate_peaks(ax, px, py, color: str = "r", marker: str = "+",
                   size: int = 8, fontsize: int = 8,
                   offset=(1.5, 1.5), fmt: str = "{:.1f}",
                   show_annotations: bool = True) -> None:
    """Scatter + value labels on detected peaks
    (reference plotting_utils.py:144-162)."""
    px = np.asarray(px)
    py = np.asarray(py)
    ax.plot(px, py, marker, color=color, markersize=size)
    if show_annotations:
        for x, y in zip(px, py):
            ax.annotate(fmt.format(float(y)), (x, y),
                        xytext=(x + offset[0], y + offset[1]),
                        fontsize=fontsize, color=color)


def _lookup_table(n: int, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """matplotlib's colors._create_lookup_table for a continuous segment
    (y0 == y1) at gamma 1: ``n`` float64 samples of the piecewise-linear
    map through (x, y), clipped to [0, 1]."""
    if n == 1:
        return np.clip(np.array([y[-1]]), 0.0, 1.0)
    x = x * (n - 1)
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y[0]], distance * (y[ind] - y[ind - 1])
                          + y[ind - 1], [y[-1]]])
    return np.clip(lut, 0.0, 1.0)


def _lut64(name: str, n: int = 256) -> np.ndarray:
    """(n, 4) float64 RGBA lookup table of a colormap: matplotlib's own
    where it imports (unknown names fall back to viridis, as
    get_colormap does); else the built-in ``bwr`` and ``BrBG``."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        colors = _LIST_COLORS.get(name)
        if colors is None:
            raise ImportError(
                f"colormap {name!r} needs matplotlib, which is not "
                f"installed; without it only {sorted(_LIST_COLORS)} are "
                "built in") from None
        rgb = np.asarray(colors, np.float64)
        vals = np.linspace(0, 1, len(colors))
        lut = np.ones((n, 4), np.float64)
        for c in range(3):
            lut[:, c] = _lookup_table(n, vals, rgb[:, c])
        return lut
    cmap = get_colormap(name)
    if cmap.N != n:
        cmap = cmap.resampled(n)
    # an integer argument indexes the table itself
    return np.asarray(cmap(np.arange(n)), np.float64)


def colormap_lut(name: str, n: int = 256) -> torch.Tensor:
    """(n, 4) float32 RGBA lookup table of the colormap ``name`` (row k
    is the colour of values in [k/n, (k+1)/n)); see the module
    docstring. Raises ImportError for a name other than ``bwr`` and
    ``BrBG`` when matplotlib is missing."""
    return torch.from_numpy(_lut64(name, n).astype(np.float32))


def colormap_rgb_u8(name: str, n: int = 256) -> torch.Tensor:
    """(n + 1, 3) uint8 table: row k is ``(lut[k, :3] * 255)`` truncated,
    as ``(cmap(x)[..., :3] * 255).astype(np.uint8)`` computes it (in
    float64), and row n is matplotlib's default colour for NaN (zeros)."""
    rgb = (_lut64(name, n)[:, :3] * 255).astype(np.uint8)
    return torch.from_numpy(np.concatenate([rgb, np.zeros((1, 3),
                                                          np.uint8)]))
