"""Polyphase resampling in PyTorch (counterpart of `afp_tpu/ops/resample.py`).

The framework publishes its resampling kernels as quality tiers, a
kaiser-windowed-sinc family standing in for the reference's soxr tiers
(`afp_tpu/ops/resample.py` gives each tier's measured stopband); the
'fast' tier is the scipy ``resample_poly`` recipe.  The kernel design runs
on the host in float64 (bit-identical to the reference's,
`tests/test_torch_ops.py`); the fused single-rate chain builds its
cascade taps from it (`engine/pipeline.py:Pipeline.device_params`).

The device ops serve the literal multirate chain and the ASRC:

* :func:`upfirdn` — zero-stuff by `up`, FIR, decimate by `down`, as the
  reference computes it: explicit zero-stuffing, one pow-2 FFT
  convolution (:func:`~afp_tpu_torch.ops.convolve.fft_convolve`) and a
  stride slice.  Its intermediates are ``(T−1)·up + K`` long: at 48 →
  44.1 kHz (up 147, down 160) a 2048-sample block becomes a ~301 k-sample
  row and a 2^19-point FFT, so size batches for it;
* :func:`resample_poly` — scipy's zero-phase centering around it;
* :class:`PolyResampler` — the exact streaming resampler: a carried input
  history makes the blocked output equal the one-shot causal transform;
* :func:`decimate` — the naive stride decimation after an anti-alias FIR.

Copied rather than imported: `afp_tpu.ops.resample` imports jax at module
level.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..design.firwin import design_windowed_sinc
from ..design.windows import kaiser as kaiser_window

__all__ = [
    "QUALITY_TIERS",
    "design_resample_kernel",
    "quality_kernel",
    "streaming_kernel",
    "output_len",
    "upfirdn",
    "resample_poly",
    "decimate",
    "PolyResampler",
]

#: quality tier → (half_len_mult, kaiser β); see `afp_tpu/ops/resample.py`
#: for each tier's measured stopband and its soxr analog
QUALITY_TIERS = {
    "fast": (10, 5.0),
    "hq": (40, 12.26),
    "vhq": (64, 14.47),
}


def _reduce_ratio(up: int, down: int) -> tuple[int, int]:
    """Lowest terms of the rational ratio."""
    up, down = int(up), int(down)
    g = math.gcd(up, down)
    return up // g, down // g


def _prepad_kernel(h: np.ndarray, down: int):
    """scipy's centering pre-pad: ``(h_padded, n_pre_remove)``."""
    half_len = (len(h) - 1) // 2
    n_pre_pad = down - half_len % down
    n_pre_remove = (half_len + n_pre_pad) // down
    return np.concatenate([np.zeros(n_pre_pad), h]), n_pre_remove


def quality_kernel(up: int, down: int, quality: str = "fast") -> np.ndarray:
    """The published tier kernel for a rational `up/down` resample."""
    try:
        mult, beta = QUALITY_TIERS[quality]
    except KeyError:
        raise ValueError(
            f"unknown resample quality {quality!r}; "
            f"expected one of {sorted(QUALITY_TIERS)}") from None
    return design_resample_kernel(up, down, half_len_mult=mult, beta=beta)


@lru_cache(maxsize=64)
def design_resample_kernel(up: int, down: int, half_len_mult: int = 10,
                           beta: float = 5.0) -> np.ndarray:
    """Anti-alias/anti-image FIR for a rational `up/down` resample: a
    kaiser(beta)-windowed sinc, cutoff 1/max(up, down) of Nyquist,
    ``2·half_len_mult·max(up,down)+1`` taps, scaled by `up` (float64)."""
    up, down = _reduce_ratio(up, down)
    if up == down == 1:
        return np.ones(1)
    max_rate = max(up, down)
    half_len = half_len_mult * max_rate
    numtaps = 2 * half_len + 1
    win = kaiser_window(numtaps, beta, sym=True)
    h = design_windowed_sinc(
        cutoff=1.0 / max_rate,
        numtaps=numtaps,
        window=win,
        filter_type="lowpass",
        samplerate=2.0,  # Nyquist-normalized axis
    )
    h = h * up
    # cached and shared by every caller: freeze it against in-place edits
    h.setflags(write=False)
    return h


def streaming_kernel(up: int, down: int, h: np.ndarray | None = None,
                     quality: str = "fast") -> np.ndarray:
    """The pre-padded kernel of the causal streaming resampler — its exact
    impulse response, for building fused cascade kernels (float64)."""
    up, down = _reduce_ratio(up, down)
    if h is None:
        h = quality_kernel(up, down, quality)
    h = np.asarray(h, dtype=np.float64)
    if up == down == 1:
        return h
    return _prepad_kernel(h, down)[0]


def output_len(len_h: int, in_len: int, up: int, down: int) -> int:
    """upfirdn output length (scipy `_output_len` semantics)."""
    return (((in_len - 1) * up + len_h) - 1) // down + 1


def upfirdn(h, x, up: int = 1, down: int = 1) -> torch.Tensor:
    """Zero-stuff by `up`, filter by `h`, decimate by `down` (scipy-
    compatible).  `x`: [..., T] (any leading batch axes); `h`: [K], moved
    to x's device.  Returns [..., output_len(K, T, up, down)] in fp32:
    explicit zero-stuffing, one pow-2 FFT convolution, a stride slice
    (`afp_tpu/ops/resample.py:147-172`)."""
    from .convolve import _f32, fft_convolve

    x = _f32(x)
    h = _f32(h, x.device)
    K, T = h.shape[-1], x.shape[-1]
    if up > 1:
        xd = x.new_zeros(x.shape[:-1] + ((T - 1) * up + 1,))
        xd[..., ::up] = x
    else:
        xd = x
    full = fft_convolve(xd, h, mode="full")  # [..., (T-1)*up + K]
    y = full[..., ::down] if down > 1 else full
    # a copy: a view would pin the whole zero-stuffed convolution
    return y[..., :output_len(K, T, up, down)].contiguous()


def _poly_pad(h_len: int, in_len: int, up: int, down: int):
    """scipy resample_poly's centering: pre/post zero-padding of the kernel
    and the number of leading outputs to drop."""
    half_len = (h_len - 1) // 2
    n_out = in_len * up
    n_out = n_out // down + bool(n_out % down)
    n_pre_pad = down - half_len % down
    n_post_pad = 0
    n_pre_remove = (half_len + n_pre_pad) // down
    while (output_len(h_len + n_pre_pad + n_post_pad, in_len, up, down)
           < n_out + n_pre_remove):
        n_post_pad += 1
    return n_pre_pad, n_post_pad, n_pre_remove, n_out


def resample_poly(x, up: int, down: int, h: np.ndarray | None = None,
                  quality: str = "fast") -> torch.Tensor:
    """Rational-ratio resample with zero-phase centering: at the 'fast'
    tier scipy's ``resample_poly(x, up, down)`` recipe, at 'hq'/'vhq' the
    steeper tier kernels with the same centering.  `x`: [..., T].  Output:
    [..., ceil(T·up/down)]."""
    from .convolve import _f32

    up, down = _reduce_ratio(up, down)
    x = _f32(x)
    if up == down == 1:
        return x
    if h is None:
        h = quality_kernel(up, down, quality)
    h = np.asarray(h)
    n_pre_pad, n_post_pad, n_pre_remove, n_out = _poly_pad(
        len(h), x.shape[-1], up, down)
    h_padded = np.concatenate([np.zeros(n_pre_pad), h, np.zeros(n_post_pad)])
    y = upfirdn(h_padded, x, up, down)
    return y[..., n_pre_remove:n_pre_remove + n_out].clone()


def decimate(x: torch.Tensor, factor: int, offset: int = 0) -> torch.Tensor:
    """Naive stride decimation (`stream_process.py:106`): relies on a
    preceding lowpass as the anti-alias stage."""
    return x[..., offset::factor]


class PolyResampler(NamedTuple):
    """Streaming rational resampler with carried input history.

    Per block of `L` input samples it emits exactly ``L·up/down`` outputs
    (`L` a multiple of `down`).  The streamed sequence equals the *causal*
    full-signal ``upfirdn(h, x, up, down)``, i.e. :func:`resample_poly`'s
    centered output delayed by :attr:`delay_outputs` samples::

        streamed[G] == resample_poly(x, up, down)[G - delay_outputs]

    With `hist_len` a multiple of `down` and ``hist_len·up ≥ K−1`` every
    output's receptive field lies inside ``[hist | block]``, so the blocked
    output equals the one-shot transform (`afp_tpu/ops/resample.py:236-312`).
    ``process`` returns ``(new_state, out)`` and leaves the state it was
    called on intact; the state lives on the device of ``hist``."""

    hist: torch.Tensor  # [..., hist_len] input history
    h: torch.Tensor  # [K] pre-padded kernel, float32
    up: int
    down: int
    hist_len: int
    skip: int  # leading outputs of each windowed conv to drop
    delay_outputs: int  # streamed-vs-centered output delay

    @classmethod
    def init(cls, up: int, down: int, block: int, batch_shape: tuple = (),
             h: np.ndarray | None = None, quality: str = "fast",
             device=None) -> "PolyResampler":
        up, down = _reduce_ratio(up, down)
        if block % down:
            raise ValueError("block length must be a multiple of down")
        if h is None:
            h = quality_kernel(up, down, quality)
        h = np.array(h, dtype=np.float64)
        shape = tuple(batch_shape)
        if up == down == 1:
            return cls(hist=torch.zeros(shape + (0,), device=device),
                       h=torch.as_tensor(h, dtype=torch.float32, device=device),
                       up=1, down=1, hist_len=0, skip=0, delay_outputs=0)
        h_padded, n_pre_remove = _prepad_kernel(h, down)
        K = len(h_padded)
        # smallest multiple of `down` with hist_len*up >= K-1
        hist_len = -(-(K - 1) // up)
        hist_len = -(-hist_len // down) * down
        return cls(hist=torch.zeros(shape + (hist_len,), device=device),
                   h=torch.as_tensor(h_padded, dtype=torch.float32,
                                     device=device),
                   up=up, down=down, hist_len=hist_len,
                   skip=(hist_len * up) // down, delay_outputs=n_pre_remove)

    def process(self, block) -> tuple["PolyResampler", torch.Tensor]:
        """[..., L] in → (new state, [..., L·up/down] out)."""
        x = torch.as_tensor(block, dtype=torch.float32,
                            device=self.hist.device)
        if self.up == self.down == 1:
            return self, x
        L = x.shape[-1]
        if L % self.down:
            # a ragged block would shift the decimation phase of every
            # later block (`afp_tpu/ops/resample.py:300-306`)
            raise ValueError(
                f"block length {L} must be a multiple of down={self.down}")
        n_out = (L * self.up) // self.down
        ext = torch.cat([self.hist, x], dim=-1)
        y = upfirdn(self.h, ext, self.up, self.down)
        # copies: views would pin the whole windowed conv and extension
        out = y[..., self.skip:self.skip + n_out].clone()
        new_hist = ext[..., ext.shape[-1] - self.hist_len:].clone()
        return self._replace(hist=new_hist), out
