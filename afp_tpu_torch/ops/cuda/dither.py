"""K2: the standalone dither kernel (replaces
`afp_tpu/ops/pallas/dither_pl.py:dither_pallas`).

The pipeline adds dither here when the conv does not fuse it (the 'fft'
strategy).  A CPU tensor takes the plain version (`ops/dither.py`), a CUDA
tensor the kernel in `csrc/dither.cu`; the two add bit-identical noise.
``dither_cuda.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from ..dither import dither_plain, lsb_for_bits
from . import _build
from .fir_td import _M32, _on_cuda, _raise_on, _stream

__all__ = ["dither_cuda"]


def dither_cuda(x: torch.Tensor, key: tuple[int, int], bit_depth: int = 24,
                kind: str = "tpdf") -> torch.Tensor:
    """Add requantization dither to `x` ([..., T] float32) under
    ``key = (seed, block counter)``; the flat element index is the noise
    counter.  Same contract as :func:`~afp_tpu_torch.ops.dither.dither_plain`."""
    if kind == "off":
        return x
    if kind not in ("rpdf", "tpdf"):
        raise ValueError(f"kind must be 'rpdf', 'tpdf' or 'off', got {kind!r}")
    if x.dtype != torch.float32:
        raise ValueError(f"x must be float32, got {x.dtype}")
    if not _on_cuda(x):
        return dither_plain(x, key, bit_depth, kind)
    x = x.contiguous()
    y = torch.empty_like(x)
    seed, counter = key
    lib = _build.load()
    with torch.cuda.device(x.device):
        rc = lib.afp_dither(x.data_ptr(), y.data_ptr(), x.numel(),
                            2 if kind == "tpdf" else 1, int(seed) & _M32,
                            int(counter) & _M32, lsb_for_bits(bit_depth),
                            _stream(x))
    _raise_on(rc, "dither_cuda (K2)")
    dither_cuda.launches += 1
    return y


dither_cuda.launches = 0
dither_cuda.kernels = 1
