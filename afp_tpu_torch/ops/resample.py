"""Resampler kernel design (host, float64 numpy) — the part of
`afp_tpu/ops/resample.py` that the fused single-rate chain needs.

The fused pipeline never resamples on the device: upsample → FIR →
downsample collapses into one base-rate FIR whose taps are built on the
host from these kernels (`engine/pipeline.py:Pipeline.device_params`).  The
streaming and one-shot device resamplers (`upfirdn`, `resample_poly`,
`PolyResampler`) belong to the literal multirate chain, ROADMAP §1 item 10.

Copied rather than imported: `afp_tpu.ops.resample` imports jax at module
level.  The float64 results are bit-identical to the reference's
(`tests/test_torch_ops.py`).
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

from ..design.firwin import design_windowed_sinc
from ..design.windows import kaiser as kaiser_window

__all__ = [
    "QUALITY_TIERS",
    "design_resample_kernel",
    "quality_kernel",
    "streaming_kernel",
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
