from .plotting_utils import (
    add_systole_diastole_shading, annotate_peaks, colormap_lut,
    create_heatmap_figure, get_colormap, plot_waveform_with_shading,
    setup_colorbar,
)
from .manager import VisualizationManager, radlong_overlay_frames

__all__ = [
    "VisualizationManager", "add_systole_diastole_shading", "annotate_peaks",
    "colormap_lut", "create_heatmap_figure", "get_colormap",
    "plot_waveform_with_shading", "radlong_overlay_frames", "setup_colorbar",
]
