"""API-compatible filter-design facade.

Mirrors the reference's public design surface:

* ``create_fir_filter(...)``   — `fir_filter.py:5-55`
* ``design_fir_filter(...)``   — `filter_methods.py:6-99`
* ``get_window(name, numtaps)`` — `window_types.py:5-53`
  (kaiser gets the reference's default beta=8.6; all errors → ValueError)

plus the Remez transition-band heuristics of `filter_methods.py:77-95` — with
a *working* Remez exchange (the reference calls an unimported symbol at
`filter_methods.py:96`).
"""
from __future__ import annotations

import numpy as np

from . import windows as _win
from .firwin import design_windowed_sinc
from .minphase import is_symmetric, minimum_phase, normalize_peak
from .remez import remez

__all__ = ["create_fir_filter", "design_fir_filter", "get_window", "to_minimum_phase"]

#: Reference default Kaiser beta (`window_types.py:39`).
KAISER_DEFAULT_BETA = 8.6


def get_window(name, numtaps: int) -> np.ndarray:
    """Window generator with the reference wrapper's semantics."""
    try:
        if isinstance(name, str) and name.lower() == "kaiser":
            return _win.get_window(("kaiser", KAISER_DEFAULT_BETA), numtaps)
        return _win.get_window(name, numtaps)
    except ValueError:
        raise
    except Exception as e:  # normalize all errors to ValueError, like the reference
        raise ValueError(
            f"Window type '{name}' not recognized or invalid parameters. "
            f"Supported types: {', '.join(_win.WINDOW_NAMES)}. Original error: {e}"
        )


def design_fir_filter(
    method: str = "window",
    cutoff=None,
    numtaps: int = 101,
    window="hamming",
    filter_type: str = "lowpass",
    samplerate: float = 44100,
) -> np.ndarray:
    """Core design dispatch, signature-compatible with `filter_methods.py:6`."""
    if method == "window":
        if cutoff is None:
            raise ValueError("Cutoff frequency must be provided.")
        if isinstance(window, str) and window.lower() == "kaiser":
            window = ("kaiser", KAISER_DEFAULT_BETA)
        elif not isinstance(window, (str, tuple)) and window is not None:
            # reference treats a non-string window argument as rectangular
            # (`filter_methods.py:30-33`)
            window = None
        return design_windowed_sinc(
            cutoff=cutoff,
            numtaps=numtaps,
            window=window,
            filter_type=filter_type,
            samplerate=samplerate,
        )
    elif method == "remez":
        # reference band tables + transition-width heuristics
        # (`filter_methods.py:77-95`)
        if filter_type == "lowpass":
            trans_width = min(1000, (samplerate / 2 - cutoff) / 2)
            high_cut = min(samplerate / 2, cutoff + trans_width)
            if cutoff >= high_cut:
                raise ValueError(
                    "Cutoff frequency too close to Nyquist for given transition width."
                )
            bands = [0, cutoff, high_cut, samplerate / 2]
            desired = [1, 0]
        elif filter_type == "highpass":
            trans_width = min(1000, cutoff / 2)
            low_cut = max(0, cutoff - trans_width)
            bands = [0, low_cut, cutoff, samplerate / 2]
            desired = [0, 1]
        elif filter_type == "bandpass":
            # the reference's band table (`filter_methods.py:90-92`) is
            # malformed (2 band pairs vs 3 desired values — scipy.signal.remez
            # rejects it); build a well-formed table with the same
            # transition-width heuristic
            lo, hi = cutoff[0], cutoff[1]
            tw = min(1000, lo / 2, (samplerate / 2 - hi) / 2)
            if tw <= 0:
                raise ValueError("bandpass edges too close to 0 or Nyquist")
            bands = [0, lo - tw, lo, hi, hi + tw, samplerate / 2]
            desired = [0, 1, 0]
        elif filter_type == "bandstop":
            # same fix for the malformed table at `filter_methods.py:93-95`
            lo, hi = cutoff[0], cutoff[1]
            tw = min(1000, lo / 2, (samplerate / 2 - hi) / 2)
            if tw <= 0:
                raise ValueError("bandstop edges too close to 0 or Nyquist")
            bands = [0, lo - tw, lo, hi, hi + tw, samplerate / 2]
            desired = [1, 0, 1]
        else:
            raise ValueError("Invalid filter type")
        return remez(numtaps, bands, desired, fs=samplerate)
    else:
        raise NotImplementedError(f"Method '{method}' not implemented.")


def create_fir_filter(
    method: str = "window",
    cutoff=0.3,
    numtaps: int = 101,
    window_type: str = "hamming",
    filter_type: str = "lowpass",
    samplerate: float = 44100,
) -> np.ndarray:
    """User-facing facade, signature-compatible with `fir_filter.py:5-7`."""
    if method == "window":
        # the reference materializes the window here only to validate the name
        # (`fir_filter.py:39-40`); keep the validation side effect
        get_window(window_type, numtaps)
    return design_fir_filter(
        method=method,
        cutoff=cutoff,
        numtaps=numtaps,
        window=window_type,
        filter_type=filter_type,
        samplerate=samplerate,
    )


def to_minimum_phase(h: np.ndarray, fs: float, tol: float = 1e-8) -> np.ndarray:
    """GUI post-pass: min-phase conversion gated on symmetry, then peak
    normalization (`stream_process_EQ_GUI.py:57-63, 377-379`).

    Returns `h` unchanged when it is not linear-phase symmetric.
    """
    h = np.asarray(h, dtype=np.float64)
    if not is_symmetric(h, tol=tol):
        return h
    h_min = minimum_phase(h, method="hilbert")
    return normalize_peak(h_min, fs)
