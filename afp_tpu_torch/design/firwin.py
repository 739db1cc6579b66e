"""Windowed-sinc FIR design with the reference's exact normalization rules.

Re-creates the math of ``design_fir_filter(method='window', ...)``
(`filter_methods.py:19-75`) without scipy:

* time axis ``t = n − (numtaps−1)/2`` with the zero-guard ``t[t==0] = 1e-20``
  (`filter_methods.py:22-24`),
* cutoffs normalized to Nyquist (`:26-28`),
* ideal responses per filter type (`:35-50`),
* window applied *after* the full impulse response (`:53`),
* per-type unity-gain normalization (`:58-74`):
  - lowpass:  ``h /= Σh``  (DC gain),
  - highpass: normalize at Nyquist via ``Σ h·cos(2π·0.5·t)``,
  - bandpass: unity at the geometric-mean center frequency, located on the
    8000-pt ``freqz`` grid,
  - bandstop: divide by the mean of the band-edge gains on the same grid.

All math is float64 on the host; the resulting taps are handed to the device
as float32.  Golden tests diff against a scipy replica at < −120 dB.
"""
from __future__ import annotations

from typing import Sequence, Union

import numpy as np

from .freqz import freqz
from .windows import get_window

__all__ = ["design_windowed_sinc", "FILTER_TYPES"]

FILTER_TYPES = ("lowpass", "highpass", "bandpass", "bandstop")

CutoffT = Union[float, Sequence[float]]


def design_windowed_sinc(
    cutoff: CutoffT,
    numtaps: int = 101,
    window: Union[str, tuple, np.ndarray, None] = "hamming",
    filter_type: str = "lowpass",
    samplerate: float = 44100.0,
) -> np.ndarray:
    """Design an FIR filter by the windowed-sinc method (float64).

    Parameters mirror `filter_methods.py:6`. `window` may be a
    name string, a ``('kaiser', beta)`` tuple, an explicit array, or None
    (treated as rectangular, matching `filter_methods.py:30-33` where a
    non-string window argument degrades to ones).
    """
    if cutoff is None:
        raise ValueError("Cutoff frequency must be provided.")
    numtaps = int(numtaps)
    if numtaps < 1:
        raise ValueError("numtaps must be >= 1")

    n = np.arange(numtaps, dtype=np.float64)
    t = n - (numtaps - 1) / 2.0
    # Reference's zero-guard (np.sinc already handles 0, but the reference
    # substitutes 1e-20 *before* sinc, which is numerically identical for
    # np.sinc; keep it for exactness of the highpass/bandstop center tap).
    t[t == 0] = 1e-20

    cutoff_arr = np.asarray(cutoff, dtype=np.float64)
    nyq = samplerate / 2.0
    cutoff_n = cutoff_arr / nyq

    if isinstance(window, str) and window.lower() == "kaiser":
        # the reference's window wrapper injects beta=8.6 for kaiser
        # (`window_types.py:35-42`)
        window = ("kaiser", 8.6)
    if isinstance(window, (str, tuple)):
        window_vals = np.asarray(get_window(window, numtaps), dtype=np.float64)
    elif window is None:
        window_vals = np.ones(numtaps)
    else:
        window_vals = np.asarray(window, dtype=np.float64)
        if window_vals.shape != (numtaps,):
            raise ValueError("explicit window must have length numtaps")

    if filter_type == "lowpass":
        if cutoff_n.ndim != 0:
            raise ValueError("lowpass takes a scalar cutoff")
        h = cutoff_n * np.sinc(cutoff_n * t)
    elif filter_type == "highpass":
        if cutoff_n.ndim != 0:
            raise ValueError("highpass takes a scalar cutoff")
        h = np.sinc(t) - cutoff_n * np.sinc(cutoff_n * t)
    elif filter_type == "bandpass":
        if cutoff_n.shape != (2,):
            raise ValueError("bandpass takes a [low, high] cutoff pair")
        h = cutoff_n[1] * np.sinc(cutoff_n[1] * t) - cutoff_n[0] * np.sinc(cutoff_n[0] * t)
    elif filter_type == "bandstop":
        if cutoff_n.shape != (2,):
            raise ValueError("bandstop takes a [low, high] cutoff pair")
        h = np.sinc(t) - (
            cutoff_n[1] * np.sinc(cutoff_n[1] * t) - cutoff_n[0] * np.sinc(cutoff_n[0] * t)
        )
    else:
        raise ValueError("Invalid filter type")

    if numtaps % 2 == 0 and filter_type in ("highpass", "bandstop"):
        # a type-II FIR (even length, symmetric) has a structural zero at
        # Nyquist: the reference's own contract is odd numtaps
        # (`filter_methods.py:12`), and the highpass normalization below
        # would divide by a ~1e-14 cos-sum and return ~1e14-scaled garbage
        raise ValueError(
            f"{filter_type} requires odd numtaps (even-length symmetric "
            "FIRs have zero response at Nyquist)")
    h = h * window_vals

    # --- unity-gain normalization, reference rules verbatim ---
    if filter_type == "lowpass":
        h = h / np.sum(h)
    elif filter_type == "highpass":
        # degenerate-input guard (r5 fuzz find): at cutoff ≥ Nyquist the
        # windowed sinc difference is identically zero and the cos-sum
        # normalization below returns silent NaNs — reject loudly (the
        # engine's validate() clamps highpass cutoffs strictly inside
        # Nyquist so its never-raise contract is unaffected)
        if float(cutoff_n) >= 1.0:
            raise ValueError(
                f"highpass cutoff {float(cutoff_arr):g} Hz is at or above "
                f"Nyquist ({samplerate / 2:g} Hz) — the design is "
                "identically zero")
        h = h / np.sum(h * np.cos(2 * np.pi * 0.5 * t))
    elif filter_type == "bandpass":
        w, H = freqz(h, worN=8000, fs=samplerate)
        center_freq = np.sqrt(cutoff_arr[0] * cutoff_arr[1])
        center_idx = int(np.argmin(np.abs(w - center_freq)))
        h = h / np.abs(H[center_idx])
    elif filter_type == "bandstop":
        w, H = freqz(h, worN=8000, fs=samplerate)
        idx1 = int(np.argmin(np.abs(w - cutoff_arr[0])))
        idx2 = int(np.argmin(np.abs(w - cutoff_arr[1])))
        gain = (np.abs(H[idx1]) + np.abs(H[idx2])) / 2.0
        h = h / gain
    return h
