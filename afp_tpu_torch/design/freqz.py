"""FIR frequency-response evaluation (first-party `freqz`).

The reference's band-filter normalization is *defined in terms of* an 8000-pt
`scipy.signal.freqz` evaluation (`filter_methods.py:63-74`)
and the response plots use the same grid (`plot_filter.py:49`).
To keep the −90 dB contract we evaluate on exactly scipy's grid:

    w = linspace(0, fs/2, worN, endpoint=False)
    H[k] = Σ_n h[n] · exp(−j·2π·(w[k]/fs)·n)

computed — as scipy's fast path does — via a zero-padded real FFT of length
``2·worN``, which is bit-for-bit the same evaluation points.

The port's copy holds the numpy path only (the design path); `afp_tpu`'s
`freqz_jax` has no counterpart here.
"""
from __future__ import annotations

import numpy as np

__all__ = ["freqz"]


def freqz(h: np.ndarray, worN: int = 8000, fs: float = 2 * np.pi):
    """Frequency response of an FIR filter on scipy's half-spectrum grid.

    Returns ``(w, H)`` with `w` in the same units as `fs` (Hz when `fs` is a
    samplerate), matching ``scipy.signal.freqz(h, worN=worN, fs=fs)``.
    """
    h = np.asarray(h, dtype=np.float64)
    if h.ndim != 1:
        raise ValueError("freqz expects a 1-D coefficient vector")
    worN = int(worN)
    if worN < 1:
        raise ValueError("worN must be >= 1")
    n_fft = 2 * worN
    if len(h) <= n_fft:
        # scipy's FFT fast path: rfft of length 2*worN, keep the first worN
        # bins => response at w = linspace(0, pi, worN, endpoint=False).
        H = np.fft.rfft(h, n=n_fft)[:worN]
    else:
        # Filter longer than the grid: direct evaluation, chunked over the
        # frequency axis — the full [worN, n_taps] phase matrix is quadratic
        # memory (12.8 GB complex128 at the 100k-tap kernels kp.py handles);
        # cap each chunk at ~4M elements (≤64 MB), same as the JAX path.
        wr = np.linspace(0, np.pi, worN, endpoint=False)
        n = np.arange(len(h))
        H = np.empty(worN, dtype=np.complex128)
        chunk = max(8, (1 << 22) // len(h))
        for s in range(0, worN, chunk):
            H[s : s + chunk] = np.exp(-1j * np.outer(wr[s : s + chunk], n)) @ h
    w = np.linspace(0, fs / 2, worN, endpoint=False)
    return w, H
