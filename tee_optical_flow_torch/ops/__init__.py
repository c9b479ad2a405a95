"""Device ops of the PyTorch port: plain PyTorch, plus the CUDA kernels of
``csrc/tvl1.cu`` behind ``warp.median_filter_5x5`` and
``tvl1_kernels.tvl1_outer_loop`` / ``tvl1_inner_block``, and of
``csrc/deepflow.cu`` behind ``deepflow_kernels.sor_sweeps``.

The names are the JAX package's ``ops`` names; the two that JAX suffixes
with ``_jnp`` carry the port's own: ``img2uint8_jnp`` is ``img2uint8``,
``savgol_filter_jnp`` is ``savgol_filter_torch``."""

from .histogram import carry_forward, masked_histogram, masked_percentile
from .imaging import img2uint8, normalize_imagenet, resize_frames, rgb2gray
from .morphology import (
    binary_fill_holes, clean_binary_stack, component_areas_and_centroids,
    connected_components, label_first_area, largest_centroid_series,
    moving_avg_mask, remove_small_objects,
)
from .otsu import threshold_otsu
from .smoothing import savgol_coeffs, savgol_filter_torch

__all__ = [
    "rgb2gray", "img2uint8", "normalize_imagenet", "resize_frames",
    "connected_components", "remove_small_objects", "binary_fill_holes",
    "moving_avg_mask", "clean_binary_stack", "component_areas_and_centroids",
    "label_first_area", "largest_centroid_series",
    "threshold_otsu", "masked_histogram", "masked_percentile", "carry_forward",
    "savgol_filter_torch", "savgol_coeffs",
]
