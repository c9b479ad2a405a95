"""ECG cleaning and R-peak detection (the port's copy of the JAX
package's signal/ecg.py, the same NumPy/SciPy code line for line).

The reference delegates to neurokit2 (``ecg_clean(method='vg')`` +
``ecg_peaks(method='khamis2016', correct_artifacts=True)``,
cardiac_cycle_detection.py:296-309). Neither library exists here, so this
module implements the same two capabilities:

  * ``ecg_clean``: zero-phase 2nd-order Butterworth band-pass (4-45 Hz by
    default, the passband the 'vg' cleaner uses) — removes baseline wander
    and mains noise while preserving QRS energy.
  * ``detect_r_peaks``: Pan-Tompkins-style detector (derivative -> square
    -> moving-window integration -> adaptive threshold) with RR-interval
    artifact correction (drop implausibly-close beats, in the spirit of
    neurokit's ``correct_artifacts``).

Exact sample-level parity with neurokit is not a goal (SURVEY.md §7
"exact-match of heuristic signal code"); detectors are validated at the
beat/interval level.
"""

from __future__ import annotations

import numpy as np
from scipy import signal as sps


def ecg_clean(ecg: np.ndarray, sampling_rate: float,
              lowcut: float = 4.0, highcut: float = 45.0) -> np.ndarray:
    ecg = np.asarray(ecg, dtype=np.float64)
    nyq = sampling_rate / 2.0
    high = min(highcut, 0.99 * nyq)
    low = max(lowcut, 0.01)
    if low >= high:  # degenerate sampling rates: just detrend
        return ecg - np.mean(ecg)
    b, a = sps.butter(2, [low / nyq, high / nyq], btype="band")
    padlen = min(3 * max(len(a), len(b)), ecg.size - 1)
    return sps.filtfilt(b, a, ecg, padlen=padlen)


def detect_r_peaks(ecg: np.ndarray, sampling_rate: float,
                   correct_artifacts: bool = True) -> np.ndarray:
    """Return sample indices of R peaks.

    Pipeline: clean -> derivative -> square -> moving integration over a
    QRS-width window -> threshold at mean+0.5*std -> local-max refinement
    on the cleaned signal -> (optional) drop beats closer than 200 ms,
    keeping the larger-amplitude beat of each offending pair.
    """
    ecg = np.asarray(ecg, dtype=np.float64)
    n = ecg.size
    if n < int(0.2 * sampling_rate):
        return np.array([], dtype=np.int64)

    cleaned = ecg_clean(ecg, sampling_rate)

    # flat / disconnected-lead guard: a real ECG carries most of its QRS
    # energy in the 4-45 Hz passband; a constant or slowly drifting lead
    # leaves only filter residue there (~machine epsilon), and the
    # relative threshold below would then "detect" beats in pure noise.
    # The relative cut is 0.1% (not 1%): a lead with extreme baseline
    # wander or a large DC step can legitimately carry <1% of its total
    # RMS in-band while the QRS complexes are still cleanly isolated —
    # only true filter residue sits orders of magnitude below the raw
    # signal.
    rms_in_band = float(np.sqrt(np.mean(cleaned ** 2)))
    rms_total = float(np.sqrt(np.mean((ecg - ecg.mean()) ** 2)))
    if rms_in_band < max(1e-3 * rms_total, 1e-10):
        return np.array([], dtype=np.int64)

    deriv = np.gradient(cleaned)
    squared = deriv ** 2
    win = max(1, int(round(0.12 * sampling_rate)))  # ~QRS width
    kernel = np.ones(win) / win
    energy = np.convolve(squared, kernel, mode="same")

    # threshold statistics are computed on energy clipped at its 99th
    # percentile: a single broadband transient (lead reconnection, DC
    # step) otherwise inflates mean and std enough to mask every real
    # QRS; on a clean trace the clip only shaves the very tips of the
    # QRS energy bursts and barely moves the threshold.
    e_clip = np.minimum(energy, np.percentile(energy, 99))
    thresh = e_clip.mean() + 0.5 * e_clip.std()
    above = energy > thresh

    # group contiguous above-threshold regions; one beat per region
    edges = np.diff(above.astype(np.int8))
    starts = list(np.where(edges == 1)[0] + 1)
    ends = list(np.where(edges == -1)[0] + 1)
    if above[0]:
        starts.insert(0, 0)
    if above[-1]:
        ends.append(n)

    peaks = []
    search = max(1, int(round(0.05 * sampling_rate)))
    for s, e in zip(starts, ends):
        if e - s < max(2, win // 4):
            continue  # too narrow to be a QRS complex
        region_peak = s + int(np.argmax(energy[s:e]))
        # refine on the cleaned ECG: true R is the max |amplitude| nearby
        lo = max(0, region_peak - search)
        hi = min(n, region_peak + search + 1)
        peaks.append(lo + int(np.argmax(np.abs(cleaned[lo:hi]))))
    peaks = np.asarray(sorted(set(peaks)), dtype=np.int64)

    if correct_artifacts and peaks.size > 1:
        min_rr = int(round(0.2 * sampling_rate))  # physiologic refractory
        kept = [int(peaks[0])]
        for p in peaks[1:]:
            if p - kept[-1] < min_rr:
                if np.abs(cleaned[p]) > np.abs(cleaned[kept[-1]]):
                    kept[-1] = int(p)
            else:
                kept.append(int(p))
        peaks = np.asarray(kept, dtype=np.int64)

    return peaks
