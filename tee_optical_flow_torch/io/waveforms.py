"""Load + physiologically validate companion waveforms of a DICOM clip
(the port's copy of the JAX package's io/waveforms.py, host NumPy).

Behavioral parity with reference optical_flow/waveform_loader.py:14-184:
same file-name scheme (``<base>_II/_ART/_ABP/_PAP/_CVP.npy``), same
flatness test (max gradient < threshold), same range checks (PAP mean in
[0, pap_max_mean]; CVP mean in [cvp_min_mean, cvp_max_mean]), and the same
ART -> ABP fallback when the ART trace is flat or missing.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Tuple

import numpy as np

from ..config import OpticalFlowCalculationConfig, default_optical_flow_config

logger = logging.getLogger(__name__)

WaveformResult = Tuple[bool, Optional[np.ndarray]]


def _load_waveform_file(path: str) -> Optional[np.ndarray]:
    """np.load with graceful None on missing/corrupt files
    (reference waveform_loader.py:14-31)."""
    if not os.path.exists(path):
        return None
    try:
        return np.load(path)
    except (IOError, ValueError) as exc:
        logger.warning("Error loading waveform from %s: %s", path, exc)
        return None


def is_flat(waveform: np.ndarray, threshold: float) -> bool:
    """A trace is 'flat' when its max sample-to-sample gradient is below
    threshold (reference waveform_loader.py:33-44)."""
    return bool(np.max(np.gradient(np.asarray(waveform, dtype=np.float64))) < threshold)


def validate_range(waveform: np.ndarray, min_val: float, max_val: float,
                   name: str) -> Tuple[bool, str]:
    """Mean-value range check (reference waveform_loader.py:47-66)."""
    mean_val = float(np.mean(waveform))
    if mean_val > max_val:
        return False, f"{name} waveform is too high, mean > {max_val}mmHg!"
    if mean_val < min_val:
        return False, f"{name} waveform is too negative, mean < {min_val}mmHg!"
    return True, ""


def waveform_paths(dcm_path: str, waveform_folder: str) -> Dict[str, str]:
    base = os.path.basename(dcm_path)
    if base.lower().endswith(".dcm"):
        base = base[:-4]
    return {
        "ecg": os.path.join(waveform_folder, base + "_II.npy"),
        "art": os.path.join(waveform_folder, base + "_ART.npy"),
        "abp": os.path.join(waveform_folder, base + "_ABP.npy"),
        "pap": os.path.join(waveform_folder, base + "_PAP.npy"),
        "cvp": os.path.join(waveform_folder, base + "_CVP.npy"),
    }


def load_all_waveforms(dcm_path: str, waveform_folder: str,
                       config: Optional[OpticalFlowCalculationConfig] = None,
                       verbose: bool = False) -> Dict[str, WaveformResult]:
    """Load/validate ecg/art/cvp/pap companions of ``dcm_path``.

    Returns {'ecg'|'art'|'cvp'|'pap': (valid, array_or_None)} exactly as the
    reference (waveform_loader.py:69-184).
    """
    if config is None:
        config = default_optical_flow_config()
    paths = waveform_paths(dcm_path, waveform_folder)

    results: Dict[str, WaveformResult] = {
        "ecg": (False, None), "art": (False, None),
        "cvp": (False, None), "pap": (False, None),
    }

    # PAP: flat-reject, then mean in [0, pap_max_mean]
    pap = _load_waveform_file(paths["pap"])
    if pap is not None:
        if is_flat(pap, config.waveform_flatness_threshold):
            _log(verbose, "PAP waveform is flat!")
        elif np.mean(pap) > config.pap_max_mean:
            _log(verbose, f"PAP waveform is too high, mean > {config.pap_max_mean}mmHg!")
        elif np.mean(pap) < 0:
            _log(verbose, "PAP waveform is negative, mean < 0mmHg!")
        else:
            results["pap"] = (True, pap)

    # CVP: mean in [cvp_min_mean, cvp_max_mean]
    cvp = _load_waveform_file(paths["cvp"])
    if cvp is not None:
        ok, msg = validate_range(cvp, config.cvp_min_mean, config.cvp_max_mean, "CVP")
        if ok:
            results["cvp"] = (True, cvp)
        else:
            _log(verbose, msg)

    # ECG: no validation beyond loadability
    ecg = _load_waveform_file(paths["ecg"])
    if ecg is not None:
        results["ecg"] = (True, ecg)
    else:
        _log(verbose, f"{paths['ecg']} doesnt exist! No ECG waveform detected")

    # ART with ABP fallback when flat or missing
    art = _load_waveform_file(paths["art"])
    if art is not None and not is_flat(art, config.waveform_flatness_threshold):
        results["art"] = (True, art)
    else:
        abp = _load_waveform_file(paths["abp"])
        if abp is not None and not is_flat(abp, config.waveform_flatness_threshold):
            results["art"] = (True, abp)
        elif art is not None or abp is not None:
            _log(verbose, "ART and ABP waveforms given are flat!")
        else:
            _log(verbose, "ART and ABP path doesnt exist!")

    return results


def _log(verbose: bool, msg: str) -> None:
    if verbose:
        logger.warning("ERROR %s", msg)
