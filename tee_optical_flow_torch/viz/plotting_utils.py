"""Plotting helpers of the peak-line plots (the JAX package's
viz/plotting_utils.py ``add_systole_diastole_shading`` and
``annotate_peaks``; reference optical_flow/plotting_utils.py:13-57,
:144-162).

They draw on an axis the caller made, so this module imports no
matplotlib: the manager imports it inside the methods that plot.
"""

from __future__ import annotations

import numpy as np


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
