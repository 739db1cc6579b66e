"""FIR frequency-response evaluation (first-party `freqz`).

The reference's band-filter normalization is *defined in terms of* an 8000-pt
`scipy.signal.freqz` evaluation (`filter_methods.py:63-74`)
and the response plots use the same grid (`plot_filter.py:49`).
To keep the −90 dB contract we evaluate on exactly scipy's grid:

    w = linspace(0, fs/2, worN, endpoint=False)
    H[k] = Σ_n h[n] · exp(−j·2π·(w[k]/fs)·n)

computed — as scipy's fast path does — via a zero-padded real FFT of length
``2·worN``, which is bit-for-bit the same evaluation points.

A numpy path (float64, the design path; `afp_tpu`'s, copied) and a torch
path (:func:`freqz_torch`, float32 on a device; the counterpart of
`afp_tpu`'s `freqz_jax`).
"""
from __future__ import annotations

import numpy as np

__all__ = ["freqz", "freqz_torch"]


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


def freqz_torch(h, worN: int = 8000, fs: float = 2 * np.pi):
    """Torch version of :func:`freqz` (`afp_tpu/design/freqz.py:83-131`):
    taps [..., n] as float32 on their tensor's device (numpy on the CPU),
    returning ``(w, H)`` as float32 and complex64 tensors there.

    Matches the numpy path on both branches: the rfft fast path for
    ``len(h) <= 2·worN`` and, for longer filters, direct evaluation chunked
    over frequency (an rfft of a too-long `h` would alias taps past
    ``2·worN`` back onto the grid).  The phase π·k·n/worN reaches ~1e5 rad
    for long filters, where float32 trig arguments lose ~1e-2, so it is
    reduced exactly in integers first: m = (k·n) mod 2·worN, in int64.
    ``2·worN`` is capped at 2^20 as in the reference (past it m no longer
    converts to float32 exactly)."""
    import torch

    h = torch.as_tensor(h, dtype=torch.float32)
    worN = int(worN)
    M = 2 * worN
    n_taps = h.shape[-1]
    if n_taps <= M:
        H = torch.fft.rfft(h, n=M)[..., :worN]
    else:
        if M > (1 << 20):
            raise ValueError(
                f"worN={worN} exceeds the exact-phase-reduction bound "
                "(2*worN must be <= 2^20); evaluate on the numpy path")
        # the [worN, n_taps] phase matrix of a 100k-tap kernel would be
        # ~6.4 GB complex64: evaluate ~4M elements at a time
        chunk = max(8, min(worN, (1 << 22) // max(n_taps, 1)))
        n = torch.arange(n_taps, dtype=torch.int64, device=h.device)
        hc = h.to(torch.complex64)
        scale = torch.tensor(np.pi / worN, dtype=torch.float32,
                             device=h.device)
        parts = []
        for s in range(0, worN, chunk):
            k = torch.arange(s, min(worN, s + chunk), dtype=torch.int64,
                             device=h.device)
            m = (k[:, None] * n[None, :]) % M
            E = torch.exp(-1j * (scale * m.to(torch.float32)))
            parts.append(torch.einsum("wn,...n->...w", E, hc))
        H = torch.cat(parts, dim=-1)
    w = torch.as_tensor(np.linspace(0.0, fs / 2, worN, endpoint=False),
                        dtype=torch.float32, device=h.device)
    return w, H
