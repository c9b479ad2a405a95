from .smoother import spectral_smooth, spectral_smooth_torch
from .peaks import peak_indexes, poly_baseline
from .ecg import ecg_clean, detect_r_peaks

__all__ = ["spectral_smooth", "spectral_smooth_torch", "peak_indexes",
           "poly_baseline", "ecg_clean", "detect_r_peaks"]
