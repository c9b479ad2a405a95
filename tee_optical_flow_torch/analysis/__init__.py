from .centroid import calc_AV_centroid, find_correct_centroid
from .components import radial_vecgrid, calc_proj_mag, calculate_comp_magnitude
from .histograms import (
    calc_bidirectional_hist,
    calculate_3dhist,
    calculate_3dhist_radlong,
    cart_to_polar,
)

__all__ = [
    "calc_AV_centroid", "find_correct_centroid",
    "radial_vecgrid", "calc_proj_mag", "calculate_comp_magnitude",
    "calc_bidirectional_hist", "calculate_3dhist", "calculate_3dhist_radlong",
    "cart_to_polar",
]
