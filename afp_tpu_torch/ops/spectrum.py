"""Spectrum analysis ops (counterpart of `afp_tpu/ops/spectrum.py`).

The live spectrum and waterfall math of the reference GUIs:

* per-block windowed rfft magnitude in dB with peak pick
  (`stream_process_EQ_GUI.py:395-411`),
* the waterfall ring of the last 50 spectra
  (`stream_process_GUI_Waterfall.py:112, 471-478`),
* the rfft bin frequencies.

:func:`spectrum_db` runs on the input tensor's device in float32 (cuFFT
on the card); :func:`spectrum_db_np` and :func:`spectrum_freqs` are the
reference's numpy code, copied.  All ops are batched ([..., T]).  The ring
is newest-last, primed with the −200 dB floor, and :func:`waterfall_push`
returns a new tensor: the ring passed in stays intact, as `jnp.roll` leaves
it (the pipeline's state contract).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..design.windows import hann

__all__ = ["spectrum_db", "spectrum_db_np", "spectrum_freqs", "spectrum_peak",
           "waterfall_init", "waterfall_push", "WATERFALL_DEPTH"]

#: History depth of the reference's waterfall deque
#: (`stream_process_GUI_Waterfall.py:112`).
WATERFALL_DEPTH = 50


def spectrum_db(x, window=None, floor: float = 1e-10) -> torch.Tensor:
    """Windowed |rfft| in dB: [..., T] → [..., T//2+1], float32 on the
    device of `x` (a tensor stays where it is; numpy lands on the CPU).

    The default window is `hann(T)`, the reference's analysis window
    (`stream_process_GUI_Waterfall.py:471-474`), cast to float32; a caller
    that analyses many blocks may pass it once as a tensor."""
    x = torch.as_tensor(x, dtype=torch.float32)
    if window is None:
        window = hann(x.shape[-1])
    w = torch.as_tensor(window, dtype=torch.float32, device=x.device)
    mag = torch.fft.rfft(x * w).abs()
    return 20.0 * torch.log10(mag + floor)


def spectrum_freqs(T: int, fs: float) -> np.ndarray:
    """rfft bin frequencies in Hz (host-side, static)."""
    return np.fft.rfftfreq(T, d=1.0 / fs)


def spectrum_db_np(x: np.ndarray, window: np.ndarray | None = None,
                   floor: float = 1e-10) -> np.ndarray:
    """Host-side (numpy) :func:`spectrum_db`: the serving drain tap's
    analysis path (`runtime.serving.RingServer(spectrum_every=)`), where the
    drained block is already host-resident.  Same Hann window and dB
    mapping as the device version (float32 end to end)."""
    x = np.asarray(x, dtype=np.float32)
    T = x.shape[-1]
    if window is None:
        window = hann(T)
    w = np.asarray(window, dtype=np.float32)
    mag = np.abs(np.fft.rfft(x * w)).astype(np.float32)
    return 20.0 * np.log10(mag + np.float32(floor))


def spectrum_peak(db, freqs: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
    """Peak (freq, level) per spectrum, the first bin on ties as
    `jnp.argmax` picks it: the GUI's peak annotation
    (`stream_process_EQ_GUI.py:404-409`)."""
    db = torch.as_tensor(db)
    idx = torch.argmax(db, dim=-1)
    f = torch.as_tensor(np.asarray(freqs), dtype=torch.float32,
                        device=db.device)[idx]
    return f, torch.take_along_dim(db, idx[..., None], dim=-1)[..., 0]


def waterfall_init(n_bins: int, depth: int = WATERFALL_DEPTH,
                   batch_shape: tuple = (), device="cpu") -> torch.Tensor:
    """Fixed-shape spectrum history ring [..., depth, n_bins], primed with
    the dB floor."""
    return torch.full(tuple(batch_shape) + (depth, n_bins), -200.0,
                      dtype=torch.float32, device=device)


def waterfall_push(ring: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """A new ring: `ring` rolled one row and `db` appended (newest last,
    like the reference's deque append).  One copy of the ring; `ring`
    itself is left as it was."""
    db = torch.as_tensor(db, dtype=ring.dtype, device=ring.device)
    return torch.cat([ring[..., 1:, :], db[..., None, :]], dim=-2)
