"""The fused FIR of the filter chain: kernels K1, K3, K4 and their plain
PyTorch versions (counterpart of `afp_tpu/ops/pallas/fir_td.py`).

Every output is the causal/valid convolution

    y[b, t] = Σ_k h[k] · ext[b, t + H − k]

of an extended signal ``ext`` (H history columns, then the block) with the
fused cascade taps ``h``, in the TPU's bf16×3 numerics class: x and h are
split into bf16 hi/lo halves (:func:`split_bf16`) and the three products
hi·hi + hi·lo + lo·hi accumulate in fp32.  The clip, then the dither, fuse
into the store.

===  ====================================  ================================
K    wrapper (CUDA kernel in csrc/fir_td)  replaces (afp_tpu/ops/pallas/…)
===  ====================================  ================================
K1   :func:`fir_td_mxu`                    fir_td.py:fir_td_mxu
K3   :func:`fir_td_mxu_ring_f32`           fir_td.py:fir_td_mxu_ring_f32
K4   :func:`fir_td_mxu_ring_mega_f32`      fir_td.py:fir_td_mxu_ring_mega_f32
===  ====================================  ================================

Each wrapper dispatches on the device of its input: a CPU tensor takes the
plain version beside it (``*_plain``: the three split products as fp32
matmuls against :func:`band_matrix` — bf16 values multiply exactly in fp32),
a CUDA tensor launches the kernel or raises.  ``<wrapper>.launches`` counts
kernel launches.  Noise is keyed by ``dither_key = (seed, block counter)``
(see `afp_tpu_torch/ops/dither.py`); a ring dispatch of n steps uses block
counters ``counter … counter+n−1``.
"""
from __future__ import annotations

import contextlib

import torch

from ..dither import lsb_for_bits, noise
from . import _build

__all__ = ["LANE", "split_bf16", "merge_bf16", "band_matrix", "ring_k_pad",
           "fir_td_mxu", "fir_td_mxu_plain",
           "fir_td_mxu_ring_f32", "fir_td_mxu_ring_f32_plain",
           "fir_td_mxu_ring_mega_f32", "fir_td_mxu_ring_mega_f32_plain"]

#: output-tile width of the band-matrix form and the granule of the block
#: length and of the ring tail (`fir_td.py:LANE`)
LANE = 128

_M32 = 0xFFFFFFFF


def split_bf16(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact hi/lo bf16 split of an f32 tensor (`fir_td.py:69-84`): hi = v
    rounded to bf16 by the integer round-to-nearest-even mask, lo =
    bf16(v − hi).  The uint32 arithmetic runs in int64 and wraps back to 32
    bits, as uint32 does."""
    v = v.to(torch.float32)
    u = v.view(torch.int32).to(torch.int64) & _M32
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    u = torch.where(u >= 2 ** 31, u - 2 ** 32, u)  # int32 two's complement
    hi32 = u.to(torch.int32).view(torch.float32)
    return hi32.to(torch.bfloat16), (v - hi32).to(torch.bfloat16)


def merge_bf16(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`split_bf16` to combined-bf16 precision."""
    return hi.to(torch.float32) + lo.to(torch.float32)


def _split_f32(v: torch.Tensor):
    hi, lo = split_bf16(v)
    return hi.to(torch.float32), lo.to(torch.float32)


def band_matrix(h, tile: int = LANE) -> torch.Tensor:
    """Banded-Toeplitz operator [N−1+tile, tile], ``T_h[i, j] = h[N−1+j−i]``
    (zero outside the band), on `h`'s device (`fir_td.py:101-117`)."""
    h = torch.as_tensor(h, dtype=torch.float32)
    n = h.shape[0]
    i = torch.arange(n - 1 + tile, device=h.device)[:, None]
    j = torch.arange(tile, device=h.device)[None, :]
    k = n - 1 + j - i
    inside = (k >= 0) & (k < n)
    return torch.where(inside, h[k.clamp(0, n - 1)], torch.zeros((), device=h.device))


def ring_k_pad(n_taps: int) -> int:
    """Width of the carried ring tail: n_taps−1 rounded up to a LANE
    multiple (`pipeline.py:355`)."""
    return -(-max(n_taps - 1, 1) // LANE) * LANE


def _finish(y, out_clip, dither_key, dither_bits, dither_tpdf):
    """Plain output stage, `fir_td.py:_finish_tile`'s order: clip, then
    dither (flat index of `y` [B, T] as the noise counter)."""
    if out_clip is not None:
        y = torch.clamp(y, -out_clip, out_clip)
    if dither_bits is not None:
        y = y + noise(y.shape, dither_key, lsb_for_bits(dither_bits),
                      dither_tpdf, y.device)
    return y


def _check_taps(h: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    if h.ndim != 1 or h.dtype != torch.float32 or h.device != ref.device:
        raise ValueError(
            f"taps must be 1-D float32 on {ref.device}, got {tuple(h.shape)} "
            f"{h.dtype} on {h.device}")
    return h.contiguous()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def _epi(out_clip, dither_key, dither_bits, dither_tpdf) -> tuple:
    seed, counter = dither_key if dither_bits is not None else (0, 0)
    return (int(out_clip is not None),
            float(out_clip) if out_clip is not None else 0.0,
            0 if dither_bits is None else (2 if dither_tpdf else 1),
            int(seed) & _M32, int(counter) & _M32,
            lsb_for_bits(dither_bits) if dither_bits is not None else 0.0)


def _on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; anything else raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


@contextlib.contextmanager
def _full_fp32_matmul():
    """The plain versions multiply in full fp32: TF32 would cut them to the
    −60 dB class on the card (the setting is restored afterwards)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# ---------------------------------------------------------------- K1


def fir_td_mxu_plain(x_ext: torch.Tensor, h: torch.Tensor, out_clip=None,
                     dither_key=(0, 0), dither_bits=None,
                     dither_tpdf=True) -> torch.Tensor:
    """Plain K1: ``[B, n−1+T] → [B, T]``, one fp32 matmul per split
    product over LANE-wide output tiles (`fir_td.py:_fir_kernel_b3`)."""
    B, text = x_ext.shape
    n = h.shape[0]
    T = text - (n - 1)
    bh, bl = _split_f32(band_matrix(h))
    xh, xl = _split_f32(x_ext)
    rows = n - 1 + LANE
    wh = xh.unfold(1, rows, LANE)  # [B, T/LANE, rows]
    wl = xl.unfold(1, rows, LANE)
    with _full_fp32_matmul():
        y = (wh @ bh + wh @ bl + wl @ bh).reshape(B, T)
    return _finish(y, out_clip, dither_key, dither_bits, dither_tpdf)


def fir_td_mxu(x_ext: torch.Tensor, h: torch.Tensor, out_clip=None,
               dither_key=(0, 0), dither_bits=None,
               dither_tpdf=True) -> torch.Tensor:
    """K1: causal/valid conv of ``x_ext`` [B, n−1+T] with taps ``h`` [n] →
    [B, T] f32, with the optional clip then dither fused into the store.
    ``T`` must be a multiple of :data:`LANE` (`fir_td.py:1665-1698`)."""
    if x_ext.ndim != 2 or x_ext.dtype != torch.float32:
        raise ValueError(f"x_ext must be [B, n-1+T] float32, got "
                         f"{tuple(x_ext.shape)} {x_ext.dtype}")
    h = _check_taps(h, x_ext)
    B, text = x_ext.shape
    n = h.shape[0]
    T = text - (n - 1)
    if T <= 0 or T % LANE:
        raise ValueError(f"output length {T} must be a multiple of {LANE}")
    if not _on_cuda(x_ext):
        return fir_td_mxu_plain(x_ext, h, out_clip, dither_key, dither_bits,
                                dither_tpdf)
    x_ext = x_ext.contiguous()
    out = torch.empty((B, T), dtype=torch.float32, device=x_ext.device)
    lib = _build.load()
    with torch.cuda.device(x_ext.device):
        rc = lib.afp_fir_td(
            x_ext.data_ptr(), h.data_ptr(), out.data_ptr(), B, T, n,
            *_epi(out_clip, dither_key, dither_bits, dither_tpdf),
            _stream(x_ext))
    _raise_on(rc, "fir_td_mxu (K1)")
    fir_td_mxu.launches += 1
    return out


fir_td_mxu.launches = 0


# ---------------------------------------------------------------- K3 / K4


def _ring_args(ring, tail, h, out_ring):
    """Shared checks of the ring forms (`fir_td.py:_ring_geometry`): the LANE
    rule on the slot length, and a narrow tail zero-padded on the left to
    k_pad (the padded history meets only zero taps)."""
    if ring.ndim != 3 or ring.dtype != torch.float32:
        raise ValueError(f"ring must be [S, B, T] float32, got "
                         f"{tuple(ring.shape)} {ring.dtype}")
    S, B, T = ring.shape
    if T % LANE:
        raise ValueError(f"T={T} must be a multiple of {LANE}")
    if out_ring.shape != ring.shape or out_ring.dtype != torch.float32:
        raise ValueError(f"out_ring must be {tuple(ring.shape)} float32, got "
                         f"{tuple(out_ring.shape)} {out_ring.dtype}")
    if not out_ring.is_contiguous() or out_ring.data_ptr() % 16:
        # written in place, four outputs per 16-byte store
        raise ValueError("out_ring must be contiguous and 16-byte aligned")
    h = _check_taps(h, ring)
    if tail.dtype != torch.float32 or tail.device != ring.device:
        raise ValueError(f"tail must be float32 on {ring.device}, got "
                         f"{tail.dtype} on {tail.device}")
    k_pad = ring_k_pad(h.shape[0])
    if tail.ndim != 2 or tail.shape[0] != B or tail.shape[1] > k_pad:
        raise ValueError(f"tail must be [{B}, <= {k_pad}], got "
                         f"{tuple(tail.shape)}")
    if tail.shape[1] < k_pad:
        tail = torch.nn.functional.pad(tail, (k_pad - tail.shape[1], 0))
    return h, tail.contiguous(), k_pad


def fir_td_mxu_ring_f32_plain(ring, idx, tail, h, out_ring, out_clip=None,
                              dither_key=(0, 0), dither_bits=None,
                              dither_tpdf=True):
    """Plain K3: concat(tail, ring[idx]) through the plain K1; writes
    ``out_ring[idx]`` in place.  Returns ``(out_ring, next_tail)``."""
    n = h.shape[0]
    k_pad = tail.shape[1]
    ext = torch.cat([tail, ring[idx]], dim=-1)
    out_ring[idx] = fir_td_mxu_plain(ext[:, k_pad - (n - 1):], h, out_clip,
                                     dither_key, dither_bits, dither_tpdf)
    return out_ring, ext[:, -k_pad:].clone()


def fir_td_mxu_ring_f32(ring: torch.Tensor, idx: int, tail: torch.Tensor,
                        h: torch.Tensor, out_ring: torch.Tensor, out_clip=None,
                        dither_key=(0, 0), dither_bits=None, dither_tpdf=True):
    """K3: one serving step over an f32 input ring [S, B, T].  Convolves slot
    `idx` behind the carried tail [B, k_pad] (narrower tails are zero-padded)
    into slot `idx` of `out_ring`, in place.  Returns ``(out_ring,
    next_tail)``; the next tail is the last k_pad samples of
    concat(tail, slot) (`fir_td.py:1058-1063`)."""
    h, tail, k_pad = _ring_args(ring, tail, h, out_ring)
    S, B, T = ring.shape
    idx = int(idx) % S
    if not _on_cuda(ring):
        return fir_td_mxu_ring_f32_plain(ring, idx, tail, h, out_ring,
                                         out_clip, dither_key, dither_bits,
                                         dither_tpdf)
    ring = ring.contiguous()
    new_tail = torch.empty((B, k_pad), dtype=torch.float32, device=ring.device)
    lib = _build.load()
    with torch.cuda.device(ring.device):
        rc = lib.afp_fir_td_ring(
            ring.data_ptr(), tail.data_ptr(), h.data_ptr(), out_ring.data_ptr(),
            new_tail.data_ptr(), S, B, T, k_pad, h.shape[0], idx,
            *_epi(out_clip, dither_key, dither_bits, dither_tpdf),
            _stream(ring))
    _raise_on(rc, "fir_td_mxu_ring_f32 (K3)")
    fir_td_mxu_ring_f32.launches += 1
    return out_ring, new_tail


fir_td_mxu_ring_f32.launches = 0


def fir_td_mxu_ring_mega_f32_plain(ring, start, tail, h, out_ring, n_steps,
                                   out_clip=None, dither_key=(0, 0),
                                   dither_bits=None, dither_tpdf=True):
    """Plain K4: the plain K3 looped over slots ``(start+i) mod S``, block
    counter ``counter+i`` for step i."""
    S = ring.shape[0]
    seed, counter = dither_key
    for i in range(n_steps):
        out_ring, tail = fir_td_mxu_ring_f32_plain(
            ring, (start + i) % S, tail, h, out_ring, out_clip,
            (seed, counter + i), dither_bits, dither_tpdf)
    return out_ring, tail


def fir_td_mxu_ring_mega_f32(ring: torch.Tensor, start: int,
                             tail: torch.Tensor, h: torch.Tensor,
                             out_ring: torch.Tensor, n_steps: int,
                             out_clip=None, dither_key=(0, 0),
                             dither_bits=None, dither_tpdf=True):
    """K4: ``n_steps`` K3 steps over slots ``(start+i) mod S`` in one launch,
    equal to chained :func:`fir_td_mxu_ring_f32` calls (same per-step math
    and noise).  ``k_pad > T`` and ``n_steps > S`` are both allowed.
    Returns ``(out_ring, next_tail)``."""
    h, tail, k_pad = _ring_args(ring, tail, h, out_ring)
    S, B, T = ring.shape
    n_steps = int(n_steps)
    if not 1 <= n_steps <= 65535:
        raise ValueError(f"n_steps must be in [1, 65535], got {n_steps}")
    start = int(start) % S
    if not _on_cuda(ring):
        return fir_td_mxu_ring_mega_f32_plain(ring, start, tail, h, out_ring,
                                              n_steps, out_clip, dither_key,
                                              dither_bits, dither_tpdf)
    ring = ring.contiguous()
    new_tail = torch.empty((B, k_pad), dtype=torch.float32, device=ring.device)
    lib = _build.load()
    with torch.cuda.device(ring.device):
        rc = lib.afp_fir_td_ring_mega(
            ring.data_ptr(), tail.data_ptr(), h.data_ptr(), out_ring.data_ptr(),
            new_tail.data_ptr(), S, B, T, k_pad, h.shape[0], start, n_steps,
            *_epi(out_clip, dither_key, dither_bits, dither_tpdf),
            _stream(ring))
    _raise_on(rc, "fir_td_mxu_ring_mega_f32 (K4)")
    fir_td_mxu_ring_mega_f32.launches += 1
    return out_ring, new_tail


fir_td_mxu_ring_mega_f32.launches = 0
