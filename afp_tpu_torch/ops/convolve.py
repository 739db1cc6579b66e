"""FFT convolution ops in PyTorch (counterpart of `afp_tpu/ops/convolve.py`).

* ``scipy.signal.oaconvolve(x, h, mode=...)`` → :func:`fft_convolve`: one
  rfft/irfft round trip at a power-of-two length, batched over leading
  axes, fp32.
* the sliding-buffer + valid-mode streaming pattern → :class:`OverlapSave`:
  the carry is the last ``N−1`` input samples, and the blocked output
  equals the one-shot convolution.
* the reference's ``OverlapAddFilter`` → :class:`OverlapAdd`: the same
  pow-2 FFT sizing and ``N−1`` overlap carry, accumulated so that streaming
  equals one shot for every (N, L) pair.

The streaming classes are small immutable state objects over tensors:
``process(block)`` returns ``(new_state, out)`` and leaves the state it was
called on intact, and ``with_kernel`` swaps taps without a shape change.
A state lives on the device of its tensors; ``torch.fft`` runs there
(cuFFT on the card).

Shapes: signals are ``[..., T]`` (any leading batch axes), kernels ``[N]``
(shared) or broadcastable ``[..., N]`` (per-stream filter banks).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["next_pow2", "fft_convolve", "OverlapSave", "OverlapAdd",
           "kernel_rfft"]


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (reference FFT sizing,
    `stream_process_GUI_Presets.py:56-57`)."""
    return 1 << (int(n) - 1).bit_length()


def _f32(a, device=None) -> torch.Tensor:
    """`a` as a float32 tensor on `device` (a read-only numpy array, such
    as a cached resampler kernel, is copied first)."""
    if isinstance(a, np.ndarray) and not a.flags.writeable:
        a = np.array(a)
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def _mode_slice(full: torch.Tensor, T: int, N: int, mode: str) -> torch.Tensor:
    """Slice a full convolution [..., T+N-1] down to the requested mode."""
    if mode == "full":
        return full
    if mode == "same":
        start = (N - 1) // 2
        return full[..., start:start + T]
    if mode == "valid":
        if T < N:
            raise ValueError("valid mode requires len(x) >= len(h)")
        return full[..., N - 1:T]
    raise ValueError(f"mode must be 'full', 'same' or 'valid', got {mode!r}")


def fft_convolve(x, h, mode: str = "full") -> torch.Tensor:
    """Linear convolution via one pow-2 rfft round trip (oaconvolve-
    compatible).  `x`: [..., T]; `h`: [N] or [..., N] (broadcast against x's
    batch axes), moved to x's device.  Returns fp32 with scipy's mode
    semantics (output length follows `x`)."""
    x = _f32(x)
    h = _f32(h, x.device)
    T, N = x.shape[-1], h.shape[-1]
    nfft = next_pow2(T + N - 1)
    X = torch.fft.rfft(x, n=nfft)
    H = torch.fft.rfft(h, n=nfft)
    full = torch.fft.irfft(X * H, n=nfft)[..., : T + N - 1]
    return _mode_slice(full, T, N, mode)


def kernel_rfft(h, nfft: int, device=None) -> torch.Tensor:
    """Precompute a kernel spectrum for repeated block convolution."""
    return torch.fft.rfft(_f32(h, device), n=nfft)


class OverlapSave(NamedTuple):
    """Streaming overlap-save convolution state.

    The reference's sliding input buffer of ``N + L − 1`` samples
    (`stream_process.py:45-46, 97-98`): `tail` holds the last ``N−1`` input
    samples; each block emits exactly ``L`` valid-mode outputs.  The
    initial state is zeros, as the reference's zero-primed buffer."""

    tail: torch.Tensor  # [..., N-1] input history
    H: torch.Tensor  # [..., nfft//2+1] precomputed kernel spectrum
    taps: int  # N
    block: int  # L
    nfft: int

    @classmethod
    def init(cls, h, block: int, batch_shape: tuple = (),
             device=None) -> "OverlapSave":
        h = _f32(h, device)
        N, L = h.shape[-1], int(block)
        nfft = next_pow2(L + N - 1)
        tail = torch.zeros(tuple(batch_shape) + (N - 1,), dtype=torch.float32,
                           device=h.device)
        return cls(tail=tail, H=kernel_rfft(h, nfft), taps=N, block=L,
                   nfft=nfft)

    def process(self, block) -> tuple["OverlapSave", torch.Tensor]:
        """One streaming step: [..., L] in → (new state, [..., L] out)."""
        x = torch.cat([self.tail, _f32(block, self.tail.device)], dim=-1)
        y = torch.fft.irfft(torch.fft.rfft(x, n=self.nfft) * self.H, n=self.nfft)
        # valid-mode outputs live at offsets [N-1, N-1+L); copies, so a
        # caller keeping them does not pin the whole FFT buffer
        out = y[..., self.taps - 1: self.taps - 1 + self.block].clone()
        new_tail = x[..., x.shape[-1] - (self.taps - 1):].clone()
        return self._replace(tail=new_tail), out

    def with_kernel(self, h) -> "OverlapSave":
        """Glitch-free kernel swap: same shapes, new spectrum."""
        h = _f32(h, self.H.device)
        if h.shape[-1] != self.taps:
            raise ValueError("kernel swap must preserve tap count (shape-static)")
        return self._replace(H=kernel_rfft(h, self.nfft))


class OverlapAdd(NamedTuple):
    """Streaming overlap-add state, the reference's ``OverlapAddFilter``
    (`stream_process_GUI_Presets.py:35-123`): pow-2 FFT of ``L+N−1``, carry
    the ``N−1`` tail of each block's convolution.  Unlike the reference,
    whose filter replaces the carry each block and so is wrong whenever
    ``N−1 > L``, the shifted remainder of the previous carry accumulates
    (`afp_tpu/ops/convolve.py:125-186`), so streaming equals one shot for
    every (N, L) pair."""

    overlap: torch.Tensor  # [..., N-1] carried convolution tail
    H: torch.Tensor
    taps: int
    block: int
    nfft: int

    @classmethod
    def init(cls, h, block: int, batch_shape: tuple = (),
             device=None) -> "OverlapAdd":
        h = _f32(h, device)
        if h.shape[-1] == 0:
            h = torch.ones(1, dtype=torch.float32, device=h.device)  # identity
        N, L = h.shape[-1], int(block)
        nfft = next_pow2(L + N - 1)
        overlap = torch.zeros(tuple(batch_shape) + (max(N - 1, 1),),
                              dtype=torch.float32, device=h.device)
        return cls(overlap=overlap, H=kernel_rfft(h, nfft), taps=N, block=L,
                   nfft=nfft)

    def process(self, block) -> tuple["OverlapAdd", torch.Tensor]:
        """One streaming step: [..., L] in → (new state, [..., L] out)."""
        x = _f32(block, self.overlap.device)
        conv = torch.fft.irfft(torch.fft.rfft(x, n=self.nfft) * self.H,
                               n=self.nfft)  # [..., nfft]
        L, N = self.block, self.taps
        out = conv[..., :L].clone()
        if N == 1:
            return self, out
        ov = min(L, N - 1)
        out = torch.cat([out[..., :ov] + self.overlap[..., :ov],
                         out[..., ov:]], dim=-1)
        new_overlap = conv[..., L:L + N - 1].clone()
        if N - 1 > L:
            # long-filter regime: the previous carry extends past this
            # block — shift it left by L and accumulate
            rem = self.overlap[..., L:]
            new_overlap = torch.cat([new_overlap[..., :N - 1 - L] + rem,
                                     new_overlap[..., N - 1 - L:]], dim=-1)
        return self._replace(overlap=new_overlap), out

    def with_kernel(self, h) -> "OverlapAdd":
        h = _f32(h, self.H.device)
        if h.shape[-1] != self.taps:
            raise ValueError("kernel swap must preserve tap count (shape-static)")
        return self._replace(H=kernel_rfft(h, self.nfft))
