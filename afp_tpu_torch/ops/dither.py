"""Requantization dither: the plain PyTorch noise (counterpart of
`afp_tpu/ops/dither.py` and of the noise math in
`afp_tpu/ops/pallas/dither_pl.py:tile_noise`).

The noise is counter-based, so any tiling of the work gives the same bits:

* **Generator** — Philox4x32-10 (Salmon et al., SC'11), written here in
  torch integer arithmetic and in `csrc/philox.cuh` for the kernels.
* **Key** — ``(seed, counter)``: the stream state's seed and its block
  counter.  Each block draws under its own key; a dispatch of n steps uses
  counters ``c, c+1, …, c+n−1``, exactly as n single steps do.
* **Counter** — the flat element index ``i`` of the block's output
  (``b·T + t``): element ``i`` takes word ``i mod 4`` of
  ``philox(ctr=i // 4, key)``.  Never a tile index.
* **Noise math** — `tile_noise`'s: TPDF ``(u₁ − u₂)·lsb/65536`` from the
  16-bit halves of one 32-bit draw, RPDF ``((b >> 8)/2²⁴ − 0.5)·lsb``,
  with ``lsb = 2^(1−bits)``.  Every step is exact in float32, so the plain
  version, the standalone kernel (K2) and the conv epilogues (K1/K3/K4)
  add bit-identical noise.

The bits differ from the TPU's hardware PRNG and from jax's threefry by
construction; the distributions and the "same key ⇒ same noise" contract
are the reference's.
"""
from __future__ import annotations

import torch

__all__ = ["philox4x32", "noise_bits", "noise", "dither_plain",
           "lsb_for_bits"]

_M0, _M1 = 0xD2511F53, 0xCD9E8D57  # Philox4x32 round multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85  # Weyl key increments
_MASK32 = 0xFFFFFFFF
_MASK16 = 0xFFFF


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit words of ``a · m`` for uint32 values held in int64.

    There is no unsigned 64-bit multiply in torch, and a 32×32 product
    overflows int64, so the product is formed from 16-bit limbs."""
    a_hi, a_lo = a >> 16, a & _MASK16
    m_hi, m_lo = m >> 16, m & _MASK16
    p0 = a_lo * m_lo
    p1 = a_hi * m_lo + a_lo * m_hi  # < 2^33
    p2 = a_hi * m_hi
    low = p0 + ((p1 & _MASK16) << 16)  # < 2^33
    lo = low & _MASK32
    hi = (p2 + (p1 >> 16) + (low >> 32)) & _MASK32
    return hi, lo


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 on int64 tensors holding uint32 counter words; the key
    ``(k0, k1)`` is two Python ints.  Returns the four output words."""
    k0 &= _MASK32
    k1 &= _MASK32
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def noise_bits(numel: int, key: tuple[int, int],
               device: torch.device | str = "cpu") -> torch.Tensor:
    """The 32-bit draw of each flat element index ``0 … numel−1`` under
    ``key = (seed, counter)``, as int64 values in [0, 2^32)."""
    n4 = -(-int(numel) // 4)
    ctr = torch.arange(n4, dtype=torch.int64, device=device)
    zero = torch.zeros_like(ctr)
    words = philox4x32(ctr & _MASK32, ctr >> 32, zero, zero, *key)
    return torch.stack(words, dim=-1).reshape(-1)[:numel]


def lsb_for_bits(bit_depth: int) -> float:
    """Dither amplitude ``2/2**bits`` (the reference's, exact in f32)."""
    return 2.0 ** (1 - int(bit_depth))


def noise(shape, key: tuple[int, int], lsb: float, tpdf: bool,
          device: torch.device | str = "cpu") -> torch.Tensor:
    """f32 dither noise of `shape` (`tile_noise`'s math on the Philox
    stream; flat row-major element index as the counter)."""
    shape = tuple(shape)
    numel = 1
    for s in shape:
        numel *= s
    b = noise_bits(numel, key, device)
    if tpdf:
        u1 = (b & _MASK16).to(torch.float32)
        u2 = (b >> 16).to(torch.float32)
        n = (u1 - u2) * (lsb / 65536.0)
    else:
        u1 = (b >> 8).to(torch.float32) * (1.0 / (1 << 24))
        n = (u1 - 0.5) * lsb
    return n.reshape(shape)


def dither_plain(x: torch.Tensor, key: tuple[int, int], bit_depth: int = 24,
                 kind: str = "tpdf") -> torch.Tensor:
    """Add requantization dither to `x` ([..., T] f32); one key per block."""
    if kind == "off":
        return x
    if kind not in ("rpdf", "tpdf"):
        raise ValueError(f"kind must be 'rpdf', 'tpdf' or 'off', got {kind!r}")
    return x + noise(x.shape, key, lsb_for_bits(bit_depth), kind == "tpdf",
                     x.device)
