"""The fused FIR of the filter chain: kernels K1, K3, K4, K7, K8, K10, K11,
K12, K13, K15 and their plain PyTorch versions (counterpart of
`afp_tpu/ops/pallas/fir_td.py`).

Every output is the causal/valid convolution

    y[b, t] = Σ_k h[k] · ext[b, t + H − k]

of an extended signal ``ext`` (H history columns, then the block) with the
fused cascade taps ``h``, in the TPU's bf16×3 numerics class: x and h are
split into bf16 hi/lo halves (:func:`split_bf16`) and the three products
hi·hi + hi·lo + lo·hi accumulate in fp32.  The clip, then the dither, then
(``emit='pcm16'``) the int16 quantizer :func:`quantize_pcm16` fuse into
the store.

===  ======================================  ================================
K    wrapper (CUDA kernel in csrc/fir_td)    replaces (afp_tpu/ops/pallas/…)
===  ======================================  ================================
K1   :func:`fir_td_mxu`                      fir_td.py:fir_td_mxu
K3   :func:`fir_td_mxu_ring_f32`             fir_td.py:fir_td_mxu_ring_f32
K4   :func:`fir_td_mxu_ring_mega_f32`        fir_td.py:fir_td_mxu_ring_mega_f32
K8   :func:`fir_td_mxu_pair`                 fir_td.py:fir_td_mxu_pair
K7   :func:`fir_td_mxu_pair_to_ring`         fir_td.py:fir_td_mxu_pair_to_ring
K12  :func:`fir_td_mxu_ring_pcm16`           fir_td.py:fir_td_mxu_ring_pcm16
K12  :func:`fir_td_mxu_ring_mega_pcm16`      fir_td.py:fir_td_mxu_ring_mega_pcm16
K13  :func:`fir_td_mxu_ring`                 fir_td.py:fir_td_mxu_ring
K13  :func:`fir_td_mxu_ring_mega`            fir_td.py:fir_td_mxu_ring_mega
K10  :func:`fir_td_mxu_banked`               fir_td.py:fir_td_mxu_banked
K11  :func:`fir_td_mxu_per_stream`           fir_td.py:fir_td_mxu_per_stream
K11  :func:`fir_td_mxu_per_stream_pair`     none: K11 with K8's loader
K11  ``fir_td_mxu_per_stream_pair_to_ring``  none: and K7's slot store
K15  ``precision=`` of K1 and K11             fir_td.py:_fir_td_call (HIGHEST,
                                             B3F, B3C), _fir_td_ps_call
===  ======================================  ================================

K15, the conv's precision (`AFP_TD_PRECISION` in `afp_tpu`, an argument
here): ``'B3'`` (the default) is the bf16×3 class above.  ``'B3F'`` and
``'B3C'`` are the same function in `afp_tpu`, with the input split inside
the TPU kernel or over time-chunk pairs; this body always reads one f32
input and splits it in its loader, so all three run the one bf16×3 body and
agree bit for bit.  ``'HIGHEST'`` is the conv in fp32 class, the TPU's own
route (the MXU's 6-pass emulation of fp32): x and the taps split exactly
into three bf16 halves (:func:`split3_bf16`) and six products per tap, for
K1 and K11 alike.  The ring, pair and bank forms are bf16×3 only, as in
`afp_tpu`.

Every form runs on the tensor cores (`csrc/fir_td.cu`, `csrc/band_mma.cuh`):
a block's staged window times the Toeplitz tiles of the taps
(:func:`band_tiles`, which every kernel builds in shared memory from the
taps pointer, entry for entry), ``mma.sync`` m16n8k16 with
fp32 accumulation.  The k-steps of 16 window positions are summed in
chunks of :data:`ACC_STEPS`, each in a fresh fragment, the chunk sums added
in fp32 round-to-nearest; an output's sum order depends only on its column
in its 8-wide tile, so every form of the body, and K11 with one band at
gain 1.0, give the same bits on the same window.  Long filters stage their
window in chunks of k-steps that fit the shared memory
(:func:`conv_geometry`, checked against the built library by
:func:`built_conv_geometry`), so every tap count runs.

The bank option (per-stream filter banks, `engine/batch.py`): K10 is K1 over
a tap bank ``[D, n]`` with a per-tile design assignment ``assign``
``[B / bt]`` (int32; row ``b`` takes design ``assign[b // bt]``), and K3,
K4 and K12 take the same ``assign=`` (the reference's banked ring forms).
The tile ``bt`` is ``B / len(assign)``: a multiple of 8, or the whole batch
when ``B <= 8`` (the reference's tile ladder), so no 8-row group of a
block straddles two designs.  The kernel selects a group's taps by
address and runs a block once per distinct design among its groups,
each row keeping its own design's sums, so a banked row equals the
shared-taps form run with its design, bit for bit.
An entry of ``assign`` outside ``[0, D)`` reads no taps: its rows come out
NaN (−32768 in an int16 store), on the card and in the plain version alike,
so a bad assignment shows in the output without a synchronize per launch.  K11
mixes K band convs per stream, ``y[b] = Σ_k gains[b, k]·(x[b] ⊛ h_k)``, on
the tensor cores: each band is the product of the split window with its
Toeplitz tiles, built in shared memory from the band kernels.  Its pair
forms read the AGC apply kernel's (hi, lo) block behind the pair tail, as
K8 does, the staged form into a new block and the pair-to-ring form into a
slot of the serving ring, as K7 does; both emit the next pair tail.

K8, K7 and K13 take the block (or the rings) and the carried tail as bf16
(hi, lo) pairs, the form the AGC apply kernel (K6) stores and
``ingest='pair'`` delivers, and skip the split.  K12 reads raw int16 PCM
and converts ``n/32768`` in the kernel (exact, and so is the split of the
result), so K12 on ``n`` equals K3/K4 on ``n/32768`` bit for bit.

The int16 store: K1 and K8 take ``emit_i16``; the ring forms (K3, K4, K7,
K12, K13) quantize when their ``out_ring`` is int16, as `afp_tpu`'s ring
kernels follow their output ring's dtype.

Each wrapper dispatches on the device of its input: a CPU tensor takes the
plain version beside it (``*_plain``: the three split products as fp32
matmuls against :func:`band_matrix` — bf16 values multiply exactly in fp32),
a CUDA tensor launches the kernel or raises.  ``<wrapper>.launches`` counts
its calls on a card (``.banked_launches`` those with the bank option), and
``<wrapper>.kernels`` is the kernels each call launches (the ring and pair
forms launch ``ring_tail_kernel`` after the conv).  Noise
is keyed by ``dither_key = (seed, block counter)`` (see
`afp_tpu_torch/ops/dither.py`); a ring dispatch of n steps uses block
counters ``counter … counter+n−1``.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from ...utils import trace
from ..dither import lsb_for_bits, noise
from . import _build

__all__ = ["LANE", "PCM16_SCALE", "PRECISIONS", "ACC_STEPS", "split_bf16", "merge_bf16",
           "band_matrix", "split3_bf16", "band_steps", "conv_geometry",
           "built_conv_geometry", "band_tiles",
           "ring_k_pad", "quantize_pcm16", "pcm16_to_f32",
           "fir_td_mxu", "fir_td_mxu_plain",
           "fir_td_mxu_ring_f32", "fir_td_mxu_ring_f32_plain",
           "fir_td_mxu_ring_mega_f32", "fir_td_mxu_ring_mega_f32_plain",
           "fir_td_mxu_pair", "fir_td_mxu_pair_plain",
           "fir_td_mxu_pair_to_ring", "fir_td_mxu_pair_to_ring_plain",
           "fir_td_mxu_ring_pcm16", "fir_td_mxu_ring_pcm16_plain",
           "fir_td_mxu_ring_mega_pcm16", "fir_td_mxu_ring_mega_pcm16_plain",
           "fir_td_mxu_ring", "fir_td_mxu_ring_plain",
           "fir_td_mxu_ring_mega", "fir_td_mxu_ring_mega_plain",
           "fir_td_mxu_banked", "fir_td_mxu_banked_plain",
           "fir_td_mxu_per_stream", "fir_td_mxu_per_stream_plain",
           "fir_td_mxu_per_stream_pair", "fir_td_mxu_per_stream_pair_plain",
           "fir_td_mxu_per_stream_pair_to_ring",
           "fir_td_mxu_per_stream_pair_to_ring_plain"]

#: output-tile width of the band-matrix form and the granule of the block
#: length and of the ring tail (`fir_td.py:LANE`)
LANE = 128

#: int16 PCM full scale: sample n is n/32768 (`fir_td.py:207`).  A power of
#: two, so the convert is exact in f32.
PCM16_SCALE = 1.0 / 32768.0

#: the conv precisions (`fir_td.py:43-59`); see the module docstring (K15)
PRECISIONS = ("B3", "B3F", "B3C", "HIGHEST")

#: k-steps of the tensor-core conv summed in one fragment before the fp32
#: round-to-nearest add of the chunk sums (`csrc/fir_td.cu:kAccSteps`)
ACC_STEPS = 16

#: the body's block (`csrc/fir_td.cu:conv_geom`): 16 batch rows x 8 warps of
#: 64 outputs at both precisions, and the shared memory a block may take
_CONV_ROWS, _CONV_COLS = 16, 512
_SMEM_LIMIT = 227 * 1024

_M32 = 0xFFFFFFFF
_IN_F32, _IN_I16, _IN_PAIR = 0, 1, 2  # csrc/fir_td.cu kInF32, kInI16, kInPair


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


def quantize_pcm16(y: torch.Tensor) -> torch.Tensor:
    """f32 → int16 PCM, ``int16(clip(round(y·32768), −32768, 32767))`` with
    round half to even (`fir_td.py:210-218`): the quantizer of the kernels'
    int16 store, bit for bit."""
    return torch.clamp(torch.round(y * 32768.0), -32768.0,
                       32767.0).to(torch.int16)


def pcm16_to_f32(x: torch.Tensor) -> torch.Tensor:
    """int16 PCM → f32, ``n/32768`` (exact); f32 passes through."""
    return x.to(torch.float32) * PCM16_SCALE if x.dtype == torch.int16 else x


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


def split3_bf16(v: torch.Tensor):
    """The exact three-way bf16 split of an f32 tensor, HIGHEST's operand
    halves: hi = bf16(v) (:func:`split_bf16`'s hi), mid = bf16(v − hi),
    lo = bf16(v − hi − mid); both differences are exact in f32, and hi +
    mid + lo == v for every finite v with |v| ≥ 2⁻¹¹⁰ whose hi is finite
    (below that the lo half falls under bf16's normal range)."""
    hi, mid = split_bf16(v)
    r = v.to(torch.float32) - hi.to(torch.float32)
    return hi, mid, (r - mid.to(torch.float32)).to(torch.bfloat16)


def band_steps(n_taps: int) -> int:
    """K-steps of 16 window positions per 8-output column tile of the
    tensor-core conv, ``ceil((n+7)/16)``: the positions where the band of
    those outputs is nonzero (`csrc/band_mma.cuh`)."""
    return (n_taps + 7 + 15) // 16


def conv_geometry(n_taps: int, highest: bool = False) -> dict:
    """The geometry of the tensor-core conv body for ``n_taps`` taps, as
    `csrc/fir_td.cu:conv_geom` computes it: ``S`` k-steps
    (:func:`band_steps`); the window chunk of ``C`` steps (all ``S`` when
    they fit, else the largest multiple of :data:`ACC_STEPS` that does) and
    its ``W = cols − 8 + 16·C`` positions in rows of ``wp`` bf16; ``smem``,
    the bytes of shared memory a block takes (the window's P halves, or the
    f32 output tile over them, then the chunk's tiles), at most 227 KB;
    ``chunks``, the window chunks the k-steps take; ``rows`` and ``cols``
    of a block.  Raises when nothing fits."""
    P, cols = (3 if highest else 2), _CONV_COLS
    S = band_steps(n_taps)

    def layout(C):
        W = cols - 8 + 16 * C
        wp = (W - 8 + 63) // 64 * 64 + 8
        region = max(P * _CONV_ROWS * wp * 2, 4 * _CONV_ROWS * (cols + 8))
        return dict(S=S, C=C, W=W, wp=wp, smem=region + C * P * 256,
                    rows=_CONV_ROWS, cols=cols)

    g = layout(S)
    C = S // ACC_STEPS * ACC_STEPS
    while g["smem"] > _SMEM_LIMIT and C > 0:
        g = layout(C)
        C -= ACC_STEPS
    if g["smem"] > _SMEM_LIMIT:
        raise ValueError(f"no window chunk of the conv fits {_SMEM_LIMIT} "
                         f"bytes at {n_taps} taps")
    g["chunks"] = -(-S // g["C"])
    return g


def built_conv_geometry(n_taps: int, highest: bool = False) -> dict:
    """The body's geometry as the built library computes it
    (`csrc/fir_td.cu:afp_conv_geometry`), in :func:`conv_geometry`'s keys
    plus ``acc_steps`` and ``min_blocks`` (the blocks an SM holds); ``C`` is
    0 where nothing fits.  Builds the library: the card's machine only."""
    out = (ctypes.c_longlong * 9)()
    _raise_on(_build.load().afp_conv_geometry(int(n_taps), int(bool(highest)), out),
              "afp_conv_geometry")
    keys = ("S", "C", "W", "wp", "smem", "rows", "cols", "acc_steps", "min_blocks")
    g = dict(zip(keys, map(int, out)))
    g["chunks"] = -(-g["S"] // g["C"]) if g["C"] else 0
    return g


def band_tiles(kernels: torch.Tensor, highest: bool = False) -> torch.Tensor:
    """The B operands of the tensor-core conv (`csrc/band_mma.cuh`): for
    each band kernel h [K, n] and step s < :func:`band_steps`, the 16×8
    Toeplitz tile ``B[i][j] = h[n−1−16s+j−i]`` (zero outside the taps),
    entry for entry :func:`band_matrix`'s ``[p0+i, c0+j]`` at ``p0 = c0 +
    16s``, split into bf16 halves (:func:`split_bf16`, or
    :func:`split3_bf16` for HIGHEST) and laid out in the mma B-fragment
    order: lane l (g = l // 4, t = l % 4) holds ``B[2t][g], B[2t+1][g],
    B[2t+8][g], B[2t+9][g]``.  Returns [K, S, P, 32, 4] bfloat16 on the
    kernels' device (P = 2, or 3 for HIGHEST).  K11 takes them from here;
    the body builds the same entries in shared memory
    (`csrc/fir_td.cu:build_tiles`)."""
    idx, inside = _tile_taps(kernels.shape[1], kernels.device)
    vals = kernels.to(torch.float32)[:, idx] * inside  # [K, S, 32, 4]
    halves = split3_bf16(vals) if highest else split_bf16(vals)
    return torch.stack(halves, dim=2)


@functools.lru_cache(maxsize=16)
def _tile_taps(n: int, device: torch.device):
    """The tap index of every fragment entry of the band tiles [S, 32, 4]
    (clamped into the taps) and its 0/1 mask of entries inside them."""
    lane = torch.arange(32, device=device)
    g, t = lane // 4, lane % 4
    i = torch.stack([2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9], dim=-1)  # [32, 4]
    s = torch.arange(band_steps(n), device=device)[:, None, None]
    k = n - 1 - 16 * s + g[:, None] - i  # [S, 32, 4]
    return k.clamp(0, n - 1), ((k >= 0) & (k < n)).to(torch.float32)


def ring_k_pad(n_taps: int) -> int:
    """Width of the carried ring tail: n_taps−1 rounded up to a LANE
    multiple (`pipeline.py:355`)."""
    return -(-max(n_taps - 1, 1) // LANE) * LANE


def _finish(y, out_clip, dither_key, dither_bits, dither_tpdf, emit_i16=False):
    """Plain output stage, `fir_td.py:_finish_tile`'s order: clip, then
    dither (flat index of `y` [B, T] as the noise counter), then the int16
    quantizer with ``emit_i16``."""
    if out_clip is not None:
        y = torch.clamp(y, -out_clip, out_clip)
    if dither_bits is not None:
        y = y + noise(y.shape, dither_key, lsb_for_bits(dither_bits),
                      dither_tpdf, y.device)
    return quantize_pcm16(y) if emit_i16 else y


def is_highest(precision) -> bool:
    """True for ``'HIGHEST'``, False for the bf16×3 modes; anything else
    raises (case-insensitive, as `afp_tpu` reads ``AFP_TD_PRECISION``)."""
    p = str(precision).upper()
    if p not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{precision!r}")
    return p == "HIGHEST"


def _check_taps(h: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    if h.ndim != 1 or h.dtype != torch.float32 or h.device != ref.device:
        raise ValueError(
            f"taps must be 1-D float32 on {ref.device}, got {tuple(h.shape)} "
            f"{h.dtype} on {h.device}")
    return h.contiguous()


def _check_bank(bank: torch.Tensor, assign, B: int, ref: torch.Tensor):
    """Checks of the bank option: the bank [D, n] f32 and the per-tile
    assignment [B / bt] int32 on `ref`'s device, and the tile bt it
    implies.  Returns (bank, assign, bt)."""
    if bank.ndim != 2 or bank.dtype != torch.float32 or bank.device != ref.device:
        raise ValueError(
            f"a tap bank must be [D, n] float32 on {ref.device}, got "
            f"{tuple(bank.shape)} {bank.dtype} on {bank.device}")
    if (assign.ndim != 1 or assign.dtype != torch.int32
            or assign.device != ref.device or not 0 < assign.shape[0] <= B
            or B % assign.shape[0]):
        raise ValueError(
            f"assign must be the per-tile design index [B / bt] int32 on "
            f"{ref.device} (B = {B}), got {tuple(assign.shape)} "
            f"{assign.dtype} on {assign.device}")
    tile = B // assign.shape[0]
    if tile % 8 and not (tile == B <= 8):
        raise ValueError(f"bt={tile} must be a multiple of 8, or the whole "
                         "batch when it is at most 8 rows")
    return bank.contiguous(), assign.contiguous(), tile


def _taps(h, assign, B, ref):
    """The taps of a conv form: shared taps [n], or with `assign` the bank
    [D, n].  Returns (taps, assign, bt, n_taps)."""
    if assign is None:
        h = _check_taps(h, ref)
        return h, None, 0, h.shape[0]
    h, assign, bt = _check_bank(h, assign, B, ref)
    return h, assign, bt, h.shape[1]


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


def _out_ring_emit(out_ring: torch.Tensor, shape, device) -> bool:
    """Checks of an output ring written in place, four outputs per store
    (16 bytes f32, 8 bytes int16).  Returns True for an int16 ring (the
    int16 store)."""
    if tuple(out_ring.shape) != tuple(shape) or out_ring.dtype not in (
            torch.float32, torch.int16):
        raise ValueError(f"out_ring must be {tuple(shape)} float32 or int16, "
                         f"got {tuple(out_ring.shape)} {out_ring.dtype}")
    emit = out_ring.dtype == torch.int16
    align = 8 if emit else 16
    if not out_ring.is_contiguous() or out_ring.data_ptr() % align:
        raise ValueError(f"out_ring must be contiguous and {align}-byte "
                         "aligned")
    if _on_cuda(out_ring) and out_ring.device != device:
        raise ValueError(f"out_ring must be on {device}, got {out_ring.device}")
    return emit


# ---------------------------------------------------------------- K1


def _conv_split(xh: torch.Tensor, xl: torch.Tensor, h: torch.Tensor):
    """The bf16×3 conv of the split extended signal (hi, lo as f32,
    [B, n−1+T]) → [B, T]: one fp32 matmul per split product over LANE-wide
    output tiles (`fir_td.py:_fir_kernel_b3`)."""
    B, text = xh.shape
    n = h.shape[0]
    T = text - (n - 1)
    bh, bl = _split_f32(band_matrix(h))
    rows = n - 1 + LANE
    wh = xh.unfold(1, rows, LANE)  # [B, T/LANE, rows]
    wl = xl.unfold(1, rows, LANE)
    with _full_fp32_matmul():
        return (wh @ bh + wh @ bl + wl @ bh).reshape(B, T)


def _conv_f32(x_ext: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """K15's HIGHEST conv of the f32 extended signal [B, n−1+T] → [B, T]:
    one full-fp32 matmul over LANE-wide output tiles against the band
    matrix (`fir_td.py:_fir_kernel`)."""
    B, text = x_ext.shape
    n = h.shape[0]
    T = text - (n - 1)
    w = x_ext.unfold(1, n - 1 + LANE, LANE)  # [B, T/LANE, rows]
    with _full_fp32_matmul():
        return (w @ band_matrix(h)).reshape(B, T)


def _conv(x_ext: torch.Tensor, h: torch.Tensor, highest: bool):
    """The conv of K1 at a precision: fp32 (HIGHEST) or bf16×3."""
    return _conv_f32(x_ext, h) if highest else _conv_split(*_split_f32(x_ext), h)


def fir_td_mxu_plain(x_ext: torch.Tensor, h: torch.Tensor, out_clip=None,
                     dither_key=(0, 0), dither_bits=None,
                     dither_tpdf=True, emit_i16=False,
                     precision="B3") -> torch.Tensor:
    """Plain K1: ``[B, n−1+T] → [B, T]`` at `precision`."""
    y = _conv(x_ext, h, is_highest(precision))
    return _finish(y, out_clip, dither_key, dither_bits, dither_tpdf, emit_i16)


def fir_td_mxu(x_ext: torch.Tensor, h: torch.Tensor, out_clip=None,
               dither_key=(0, 0), dither_bits=None,
               dither_tpdf=True, emit_i16=False,
               precision="B3") -> torch.Tensor:
    """K1: causal/valid conv of ``x_ext`` [B, n−1+T] with taps ``h`` [n] →
    [B, T] f32 (int16 PCM with ``emit_i16``), with the optional clip then
    dither fused into the store.  ``T`` must be a multiple of :data:`LANE`
    (`fir_td.py:1665-1698`).  On the card it runs on the tensor cores:
    bf16×3 (the bf16×3 modes share one body), or with
    ``precision='HIGHEST'`` K15's fp32-class conv, the six products of the
    exact three-way bf16 split (``.highest_launches`` counts it); the
    k-steps sum in chunks of :data:`ACC_STEPS` (module docstring), so the
    result equals :func:`fir_td_mxu_per_stream` with the one band ``h`` at
    gain 1.0.  Any tap count runs (:func:`conv_geometry`)."""
    highest = is_highest(precision)
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
                                dither_tpdf, emit_i16, precision)
    x_ext = x_ext.contiguous()
    out = torch.empty((B, T), dtype=torch.int16 if emit_i16 else torch.float32,
                      device=x_ext.device)
    lib = _build.load()
    with torch.cuda.device(x_ext.device):
        rc = lib.afp_fir_td(
            x_ext.data_ptr(), h.data_ptr(), out.data_ptr(), B, T, n, None, 0, 0,
            int(highest), *_epi(out_clip, dither_key, dither_bits, dither_tpdf),
            int(bool(emit_i16)), _stream(x_ext))
    _raise_on(rc, "fir_td_mxu (K15)" if highest else "fir_td_mxu (K1)")
    fir_td_mxu.launches += 1
    fir_td_mxu.highest_launches += int(highest)
    return out


fir_td_mxu.launches = 0
fir_td_mxu.kernels = 1
fir_td_mxu.highest_launches = 0


# ---------------------------------------------------------------- K10


def fir_td_mxu_banked_plain(x_ext: torch.Tensor, bank: torch.Tensor, assign,
                            out_clip=None, dither_key=(0, 0),
                            dither_bits=None, dither_tpdf=True,
                            emit_i16=False) -> torch.Tensor:
    """Plain K10: the plain K1 with each design of the bank over every row,
    each row kept from its own design's run (so a row equals the plain K1
    on its design bit for bit); rows of a design outside the bank come out
    NaN (−32768 with `emit_i16`), as the kernel writes them."""
    bank, assign, bt = _check_bank(bank, assign, x_ext.shape[0], x_ext)
    D = bank.shape[0]
    rows = assign.long().repeat_interleave(bt)[:, None]
    y = None
    for d in torch.unique(assign.clamp(0, D - 1)).tolist():
        yd = fir_td_mxu_plain(x_ext, bank[d], out_clip, dither_key,
                              dither_bits, dither_tpdf, emit_i16)
        y = yd if y is None else torch.where(rows == d, yd, y)
    bad = torch.tensor(-32768 if emit_i16 else float("nan"), dtype=y.dtype,
                       device=y.device)
    return torch.where((rows < 0) | (rows >= D), bad, y)


def fir_td_mxu_banked(x_ext: torch.Tensor, bank: torch.Tensor, assign,
                      out_clip=None, dither_key=(0, 0),
                      dither_bits=None, dither_tpdf=True,
                      emit_i16=False) -> torch.Tensor:
    """K10: :func:`fir_td_mxu` with per-stream filter banks: row ``b`` of
    ``x_ext`` [B, n−1+T] is convolved with design ``assign[b // bt]`` of
    the tap bank ``bank`` [D, n] (``assign`` the per-tile design index
    [B / bt] int32; ``bt = B / len(assign)``), with K1's fused clip, dither
    and int16 store (`fir_td.py:556-596`).  Rows of an entry outside
    ``[0, D)`` come out NaN (−32768 with `emit_i16`)."""
    if x_ext.ndim != 2 or x_ext.dtype != torch.float32:
        raise ValueError(f"x_ext must be [B, n-1+T] float32, got "
                         f"{tuple(x_ext.shape)} {x_ext.dtype}")
    B, text = x_ext.shape
    bank, assign, bt = _check_bank(bank, assign, B, x_ext)
    D, n = bank.shape
    T = text - (n - 1)
    if T <= 0 or T % LANE:
        raise ValueError(f"output length {T} must be a multiple of {LANE}")
    if not _on_cuda(x_ext):
        return fir_td_mxu_banked_plain(x_ext, bank, assign, out_clip,
                                       dither_key, dither_bits, dither_tpdf,
                                       emit_i16)
    x_ext = x_ext.contiguous()
    out = torch.empty((B, T), dtype=torch.int16 if emit_i16 else torch.float32,
                      device=x_ext.device)
    lib = _build.load()
    with torch.cuda.device(x_ext.device):
        rc = lib.afp_fir_td(
            x_ext.data_ptr(), bank.data_ptr(), out.data_ptr(), B, T, n,
            assign.data_ptr(), bt, D, 0,
            *_epi(out_clip, dither_key, dither_bits, dither_tpdf),
            int(bool(emit_i16)), _stream(x_ext))
    _raise_on(rc, "fir_td_mxu_banked (K10)")
    fir_td_mxu_banked.launches += 1
    return out


fir_td_mxu_banked.launches = 0
fir_td_mxu_banked.kernels = 1


# ---------------------------------------------------------------- K11


def _check_per_stream(x_ext, kernels, gains):
    """Checks of K11: returns (B, T, n, K)."""
    if x_ext.ndim != 2 or x_ext.dtype != torch.float32:
        raise ValueError(f"x_ext must be [B, n-1+T] float32, got "
                         f"{tuple(x_ext.shape)} {x_ext.dtype}")
    B, text = x_ext.shape
    for name, t in (("kernels", kernels), ("gains", gains)):
        if t.ndim != 2 or t.dtype != torch.float32 or t.device != x_ext.device:
            raise ValueError(f"{name} must be 2-D float32 on {x_ext.device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    K, n = kernels.shape
    if tuple(gains.shape) != (B, K):
        raise ValueError(f"gains must be [{B}, {K}], got {tuple(gains.shape)}")
    T = text - (n - 1)
    if T <= 0 or T % LANE:
        raise ValueError(f"output length {T} must be a multiple of {LANE}")
    return B, T, n, K


def fir_td_mxu_per_stream_plain(x_ext, kernels, gains, out_clip=None,
                                dither_key=(0, 0), dither_bits=None,
                                dither_tpdf=True, emit_i16=False,
                                precision="B3"):
    """Plain K11: each band's conv (the plain K1's, at `precision`), mixed
    as ``y = y + gains[:, k]·z_k`` in band order, then K1's output stage."""
    B, T, _, _ = _check_per_stream(x_ext, kernels, gains)
    if is_highest(precision):
        y = _mix(lambda h: _conv_f32(x_ext, h), kernels, gains, (B, T))
    else:
        xh, xl = _split_f32(x_ext)
        y = _mix(lambda h: _conv_split(xh, xl, h), kernels, gains, (B, T))
    return _finish(y, out_clip, dither_key, dither_bits, dither_tpdf, emit_i16)


def _mix(band, kernels, gains, shape):
    """The plain K11 mix: ``y = y + gains[:, k]·band(kernels[k])`` in band
    order, from zeros of `shape`."""
    y = torch.zeros(shape, dtype=torch.float32, device=gains.device)
    for k in range(kernels.shape[0]):
        y = y + gains[:, k:k + 1] * band(kernels[k])
    return y


def fir_td_mxu_per_stream(x_ext: torch.Tensor, kernels: torch.Tensor,
                          gains: torch.Tensor, out_clip=None,
                          dither_key=(0, 0), dither_bits=None,
                          dither_tpdf=True, emit_i16=False,
                          precision="B3") -> torch.Tensor:
    """K11: the per-stream EQ mix ``y[b] = Σ_k gains[b, k]·(x[b] ⊛
    kernels[k])`` of ``x_ext`` [B, n−1+T] with K band kernels [K, n] and
    per-stream gains [B, K] → [B, T] (`fir_td.py:1784-1810`), each band in
    the bf16×3 class on the tensor cores (`mma.sync`, fp32 accumulate,
    against the band's :func:`band_tiles`, built in shared memory from
    ``kernels``), mixed ``y = y + g·z`` in fp32 per chunk
    of :data:`ACC_STEPS` k-steps, in band order (one band at gain 1.0 is
    :func:`fir_td_mxu` bit for bit as values).  The output
    stage is K1's (clip, dither, int16 store), fused: the same bits as
    K11, then clip, then :func:`~afp_tpu_torch.ops.cuda.dither.dither_cuda`,
    then :func:`quantize_pcm16`.  Any batch runs (rows are masked).
    ``precision='HIGHEST'`` runs each band as the six products of the
    three-way bf16 split (K15, `fir_td.py:_fir_kernel_ps`, the MXU's 6-pass
    fp32; ``.highest_launches`` counts it).  An output's sums depend only on
    its column, so a row run alone equals the same row in any batch.  Any
    number of bands runs; the kernel takes up to 1033 taps (457 for
    HIGHEST) and raises beyond.  (`afp_tpu`
    sends every mode but 'B3' to its fp32 kernel here; the port keeps B3F
    and B3C what they are elsewhere, the bf16×3 function.)"""
    highest = is_highest(precision)
    B, T, n, K = _check_per_stream(x_ext, kernels, gains)
    if not _on_cuda(x_ext):
        return fir_td_mxu_per_stream_plain(x_ext, kernels, gains, out_clip,
                                           dither_key, dither_bits,
                                           dither_tpdf, emit_i16, precision)
    x_ext, kernels, gains = x_ext.contiguous(), kernels.contiguous(), gains.contiguous()
    out = torch.empty((B, T), dtype=torch.int16 if emit_i16 else torch.float32,
                      device=x_ext.device)
    lib = _build.load()
    with torch.cuda.device(x_ext.device):
        rc = lib.afp_fir_td_ps(
            x_ext.data_ptr(), kernels.data_ptr(), gains.data_ptr(),
            out.data_ptr(), B, T, n, K, int(highest),
            *_epi(out_clip, dither_key, dither_bits, dither_tpdf),
            int(bool(emit_i16)), _stream(x_ext))
    _raise_on(rc, "fir_td_mxu_per_stream (K15)" if highest
              else "fir_td_mxu_per_stream (K11)")
    fir_td_mxu_per_stream.launches += 1
    fir_td_mxu_per_stream.highest_launches += int(highest)
    return out


fir_td_mxu_per_stream.launches = 0
fir_td_mxu_per_stream.kernels = 1
fir_td_mxu_per_stream.highest_launches = 0

# ---------------------------------------------------------------- ring forms


def _ring_args(ring, tail, h, out_ring, dtype, assign=None):
    """Shared checks of the raw-input ring forms, K3/K4 (f32) and K12
    (int16) (`fir_td.py:_ring_geometry`, `_ring_assign`): the ring and tail
    dtype, the LANE rule on the slot length, the taps (shared, or with
    `assign` the bank), and a narrow tail zero-padded on the left to k_pad
    (the padded history meets only zero taps).  Returns (h, tail, k_pad,
    emit_i16, assign, bt)."""
    name = "float32" if dtype == torch.float32 else "int16"
    if ring.ndim != 3 or ring.dtype != dtype:
        raise ValueError(f"ring must be [S, B, T] {name}, got "
                         f"{tuple(ring.shape)} {ring.dtype}")
    S, B, T = ring.shape
    if T % LANE:
        raise ValueError(f"T={T} must be a multiple of {LANE}")
    emit = _out_ring_emit(out_ring, ring.shape, ring.device)
    h, assign, bt, n = _taps(h, assign, B, ring)
    if tail.dtype != dtype or tail.device != ring.device:
        raise ValueError(f"tail must be {name} on {ring.device}, got "
                         f"{tail.dtype} on {tail.device}")
    k_pad = ring_k_pad(n)
    if tail.ndim != 2 or tail.shape[0] != B or tail.shape[1] > k_pad:
        raise ValueError(f"tail must be [{B}, <= {k_pad}], got "
                         f"{tuple(tail.shape)}")
    if tail.shape[1] < k_pad:
        tail = torch.nn.functional.pad(tail, (k_pad - tail.shape[1], 0))
        if tail.is_cuda:  # the pad's fill and copy
            trace.add(ops=2)
    return h, tail.contiguous(), k_pad, emit, assign, bt


def _launch_ring(kind, rings, tails, h, out_ring, k_pad, start, n_steps,
                 epi, emit, what, assign=None, bt=0):
    """Launch `csrc/fir_td.cu:afp_fir_td_ring` over `rings` (the ring, or
    the (hi, lo) pair) behind `tails`; returns the next tail(s)."""
    S, B, T = rings[0].shape
    rings = [r.contiguous() for r in rings]
    new = [torch.empty((B, k_pad), dtype=t.dtype, device=t.device)
           for t in tails]
    lo = (lambda ts: ts[1].data_ptr() if len(ts) > 1 else None)
    lib = _build.load()
    with torch.cuda.device(rings[0].device):
        rc = lib.afp_fir_td_ring(
            rings[0].data_ptr(), lo(rings), tails[0].data_ptr(), lo(tails),
            h.data_ptr(), out_ring.data_ptr(), new[0].data_ptr(), lo(new),
            kind, S, B, T, k_pad, h.shape[-1], start, n_steps,
            None if assign is None else assign.data_ptr(), bt,
            0 if assign is None else h.shape[0], *epi,
            int(emit), _stream(rings[0]))
    _raise_on(rc, what)
    return new


def _ring_plain(ring, idx, tail, h, out_ring, out_clip, dither_key,
                dither_bits, dither_tpdf, assign=None):
    """One plain ring step over an f32 or int16 ring: concat(tail,
    ring[idx]) (converted n/32768 when int16) through the plain K1 (K10
    with `assign`) into ``out_ring[idx]`` (quantized when the ring is
    int16); the next tail is the raw last k_pad samples."""
    n = h.shape[-1]
    k_pad = tail.shape[1]
    cat = torch.cat([tail, ring[idx]], dim=-1)
    ext = pcm16_to_f32(cat[:, k_pad - (n - 1):])
    epi = (out_clip, dither_key, dither_bits, dither_tpdf,
           out_ring.dtype == torch.int16)
    out_ring[idx] = (fir_td_mxu_plain(ext, h, *epi) if assign is None else
                     fir_td_mxu_banked_plain(ext, h, assign, *epi))
    return out_ring, cat[:, -k_pad:].clone()


def _ring_mega_plain(ring, start, tail, h, out_ring, n_steps, out_clip,
                     dither_key, dither_bits, dither_tpdf, assign=None):
    """The plain ring step looped over slots ``(start+i) mod S``, block
    counter ``counter+i`` for step i."""
    S = ring.shape[0]
    seed, counter = dither_key
    for i in range(n_steps):
        out_ring, tail = _ring_plain(ring, (start + i) % S, tail, h, out_ring,
                                     out_clip, (seed, counter + i),
                                     dither_bits, dither_tpdf, assign)
    return out_ring, tail


def _count(wrapper, assign) -> None:
    wrapper.launches += 1
    if assign is not None:
        wrapper.banked_launches += 1


def fir_td_mxu_ring_f32_plain(ring, idx, tail, h, out_ring, out_clip=None,
                              dither_key=(0, 0), dither_bits=None,
                              dither_tpdf=True, assign=None):
    """Plain K3: concat(tail, ring[idx]) through the plain K1 (K10 with
    `assign`); writes ``out_ring[idx]`` in place.  Returns ``(out_ring,
    next_tail)``."""
    return _ring_plain(ring, idx, tail, h, out_ring, out_clip, dither_key,
                       dither_bits, dither_tpdf, assign)


def fir_td_mxu_ring_f32(ring: torch.Tensor, idx: int, tail: torch.Tensor,
                        h: torch.Tensor, out_ring: torch.Tensor, out_clip=None,
                        dither_key=(0, 0), dither_bits=None, dither_tpdf=True,
                        assign=None):
    """K3: one serving step over an f32 input ring [S, B, T].  Convolves slot
    `idx` behind the carried tail [B, k_pad] (narrower tails are zero-padded)
    into slot `idx` of `out_ring` (f32, or int16 for the int16 store), in
    place.  Returns ``(out_ring, next_tail)``; the next tail is the last
    k_pad samples of concat(tail, slot) (`fir_td.py:1058-1063`).  With
    ``assign`` (the per-tile design index [B / bt]) ``h`` is a tap bank
    [D, n]: the banked form (`fir_td.py:1173-1213`)."""
    h, tail, k_pad, emit, assign, bt = _ring_args(ring, tail, h, out_ring,
                                                  torch.float32, assign)
    idx = int(idx) % ring.shape[0]
    if not _on_cuda(ring):
        return fir_td_mxu_ring_f32_plain(ring, idx, tail, h, out_ring,
                                         out_clip, dither_key, dither_bits,
                                         dither_tpdf, assign)
    (new_tail,) = _launch_ring(
        _IN_F32, (ring,), (tail,), h, out_ring, k_pad, idx, 1,
        _epi(out_clip, dither_key, dither_bits, dither_tpdf), emit,
        "fir_td_mxu_ring_f32 (K3)", assign, bt)
    _count(fir_td_mxu_ring_f32, assign)
    return out_ring, new_tail


fir_td_mxu_ring_f32.launches = 0
fir_td_mxu_ring_f32.kernels = 2
fir_td_mxu_ring_f32.banked_launches = 0


def _check_steps(n_steps) -> int:
    n_steps = int(n_steps)
    if not 1 <= n_steps <= 65535:
        raise ValueError(f"n_steps must be in [1, 65535], got {n_steps}")
    return n_steps


def fir_td_mxu_ring_mega_f32_plain(ring, start, tail, h, out_ring, n_steps,
                                   out_clip=None, dither_key=(0, 0),
                                   dither_bits=None, dither_tpdf=True,
                                   assign=None):
    """Plain K4: the plain K3 looped over slots ``(start+i) mod S``, block
    counter ``counter+i`` for step i."""
    return _ring_mega_plain(ring, start, tail, h, out_ring, n_steps, out_clip,
                            dither_key, dither_bits, dither_tpdf, assign)


def fir_td_mxu_ring_mega_f32(ring: torch.Tensor, start: int,
                             tail: torch.Tensor, h: torch.Tensor,
                             out_ring: torch.Tensor, n_steps: int,
                             out_clip=None, dither_key=(0, 0),
                             dither_bits=None, dither_tpdf=True,
                             assign=None):
    """K4: ``n_steps`` K3 steps over slots ``(start+i) mod S`` in one launch,
    equal to chained :func:`fir_td_mxu_ring_f32` calls (same per-step math
    and noise).  ``k_pad > T`` and ``n_steps > S`` are both allowed; so is
    the bank option.  Returns ``(out_ring, next_tail)``."""
    h, tail, k_pad, emit, assign, bt = _ring_args(ring, tail, h, out_ring,
                                                  torch.float32, assign)
    n_steps = _check_steps(n_steps)
    start = int(start) % ring.shape[0]
    if not _on_cuda(ring):
        return fir_td_mxu_ring_mega_f32_plain(ring, start, tail, h, out_ring,
                                              n_steps, out_clip, dither_key,
                                              dither_bits, dither_tpdf,
                                              assign)
    (new_tail,) = _launch_ring(
        _IN_F32, (ring,), (tail,), h, out_ring, k_pad, start, n_steps,
        _epi(out_clip, dither_key, dither_bits, dither_tpdf), emit,
        "fir_td_mxu_ring_mega_f32 (K4)", assign, bt)
    _count(fir_td_mxu_ring_mega_f32, assign)
    return out_ring, new_tail


fir_td_mxu_ring_mega_f32.launches = 0
fir_td_mxu_ring_mega_f32.kernels = 2
fir_td_mxu_ring_mega_f32.banked_launches = 0


# ---------------------------------------------------------------- K12


def fir_td_mxu_ring_pcm16_plain(ring, idx, tail, h, out_ring, out_clip=None,
                                dither_key=(0, 0), dither_bits=None,
                                dither_tpdf=True, assign=None):
    """Plain K12: the plain K3 on the int16 ring and tail converted
    n/32768 (exact); the next tail is the raw int16 history."""
    return _ring_plain(ring, idx, tail, h, out_ring, out_clip, dither_key,
                       dither_bits, dither_tpdf, assign)


def fir_td_mxu_ring_pcm16(ring: torch.Tensor, idx: int, tail: torch.Tensor,
                          h: torch.Tensor, out_ring: torch.Tensor,
                          out_clip=None, dither_key=(0, 0), dither_bits=None,
                          dither_tpdf=True, assign=None):
    """K12: :func:`fir_td_mxu_ring_f32` over a raw int16 PCM ring [S, B, T]
    and int16 tail [B, <= k_pad]; the kernel converts ``n/32768`` and
    splits (both exact), so the output equals K3's on the f32 ring of
    ``n/32768`` bit for bit, at half the input bytes.  Returns ``(out_ring,
    next_tail)``, the next tail in int16 (`fir_td.py:1270-1304`); the bank
    option as K3's."""
    h, tail, k_pad, emit, assign, bt = _ring_args(ring, tail, h, out_ring,
                                                  torch.int16, assign)
    idx = int(idx) % ring.shape[0]
    if not _on_cuda(ring):
        return fir_td_mxu_ring_pcm16_plain(ring, idx, tail, h, out_ring,
                                           out_clip, dither_key, dither_bits,
                                           dither_tpdf, assign)
    (new_tail,) = _launch_ring(
        _IN_I16, (ring,), (tail,), h, out_ring, k_pad, idx, 1,
        _epi(out_clip, dither_key, dither_bits, dither_tpdf), emit,
        "fir_td_mxu_ring_pcm16 (K12)", assign, bt)
    _count(fir_td_mxu_ring_pcm16, assign)
    return out_ring, new_tail


fir_td_mxu_ring_pcm16.launches = 0
fir_td_mxu_ring_pcm16.kernels = 2
fir_td_mxu_ring_pcm16.banked_launches = 0


def fir_td_mxu_ring_mega_pcm16_plain(ring, start, tail, h, out_ring, n_steps,
                                     out_clip=None, dither_key=(0, 0),
                                     dither_bits=None, dither_tpdf=True,
                                     assign=None):
    """Plain K12 megakernel: the plain K12 step looped over slots
    ``(start+i) mod S``, block counter ``counter+i`` for step i."""
    return _ring_mega_plain(ring, start, tail, h, out_ring, n_steps, out_clip,
                            dither_key, dither_bits, dither_tpdf, assign)


def fir_td_mxu_ring_mega_pcm16(ring: torch.Tensor, start: int,
                               tail: torch.Tensor, h: torch.Tensor,
                               out_ring: torch.Tensor, n_steps: int,
                               out_clip=None, dither_key=(0, 0),
                               dither_bits=None, dither_tpdf=True,
                               assign=None):
    """K12, megakernel form: ``n_steps`` :func:`fir_td_mxu_ring_pcm16` steps
    in one launch (K4's form over the int16 ring; `fir_td.py:1638-1662`),
    with the bank option.  Returns ``(out_ring, next_tail)``."""
    h, tail, k_pad, emit, assign, bt = _ring_args(ring, tail, h, out_ring,
                                                  torch.int16, assign)
    n_steps = _check_steps(n_steps)
    start = int(start) % ring.shape[0]
    if not _on_cuda(ring):
        return fir_td_mxu_ring_mega_pcm16_plain(
            ring, start, tail, h, out_ring, n_steps, out_clip, dither_key,
            dither_bits, dither_tpdf, assign)
    (new_tail,) = _launch_ring(
        _IN_I16, (ring,), (tail,), h, out_ring, k_pad, start, n_steps,
        _epi(out_clip, dither_key, dither_bits, dither_tpdf), emit,
        "fir_td_mxu_ring_mega_pcm16 (K12)", assign, bt)
    _count(fir_td_mxu_ring_mega_pcm16, assign)
    return out_ring, new_tail


fir_td_mxu_ring_mega_pcm16.launches = 0
fir_td_mxu_ring_mega_pcm16.kernels = 2
fir_td_mxu_ring_mega_pcm16.banked_launches = 0


# ---------------------------------------------------------------- K8 / K7


def _pair_tail_args(B, tail_hi, tail_lo, n, ref):
    """The pair tail [B, n−1 .. k_pad] for `n` taps, zero-padded on the
    left to k_pad (`fir_td.py:727-738`; the padded history meets only zero
    taps).  Returns (tail_hi, tail_lo, k_pad)."""
    for name, t in (("tail_hi", tail_hi), ("tail_lo", tail_lo)):
        if t.dtype != torch.bfloat16 or t.ndim != 2 or t.device != ref.device:
            raise ValueError(f"{name} must be 2-D bfloat16 on {ref.device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    k_pad = ring_k_pad(n)
    if tail_lo.shape != tail_hi.shape or tail_hi.shape[0] != B or (
            not n - 1 <= tail_hi.shape[1] <= k_pad):
        raise ValueError(f"the tail pair must be two [{B}, n-1 .. {k_pad}] "
                         f"halves, got {tuple(tail_hi.shape)} and "
                         f"{tuple(tail_lo.shape)}")
    pad = k_pad - tail_hi.shape[1]
    if pad:
        tail_hi = torch.nn.functional.pad(tail_hi, (pad, 0))
        tail_lo = torch.nn.functional.pad(tail_lo, (pad, 0))
        if tail_hi.is_cuda:  # each pad's fill and copy
            trace.add(ops=4)
    return tail_hi.contiguous(), tail_lo.contiguous(), k_pad


def _pair_block(x_hi, x_lo) -> int:
    """A bf16 block pair [B, T] on one device with T a multiple of LANE
    (K8/K7 and K11's pair forms).  Returns B."""
    for name, t in (("x_hi", x_hi), ("x_lo", x_lo)):
        if t.dtype != torch.bfloat16 or t.ndim != 2 or t.device != x_hi.device:
            raise ValueError(f"{name} must be 2-D bfloat16 on {x_hi.device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    B, T = x_hi.shape
    if x_lo.shape != x_hi.shape or T % LANE:
        raise ValueError(f"the block pair must be two [B, T] halves with T a "
                         f"multiple of {LANE}, got {tuple(x_hi.shape)} and "
                         f"{tuple(x_lo.shape)}")
    return B


def _pair_args(x_hi, x_lo, tail_hi, tail_lo, h):
    """Shared checks of K8/K7: the block pair (:func:`_pair_block`), the
    taps [n] and the pair tail (:func:`_pair_tail_args`).  Returns (h,
    tail_hi, tail_lo, k_pad)."""
    B = _pair_block(x_hi, x_lo)
    h = _check_taps(h, x_hi)
    return (h, *_pair_tail_args(B, tail_hi, tail_lo, h.shape[0], x_hi))


def _next_pair_tail(tail, x, k_pad):
    """The last k_pad samples of concat(tail, x) (`fir_td.py:296-308`)."""
    T = x.shape[1]
    if k_pad <= T:
        return x[:, T - k_pad:].clone()
    return torch.cat([tail[:, T:], x], dim=-1)


def fir_td_mxu_pair_plain(x_hi, x_lo, tail_hi, tail_lo, h, out_clip=None,
                          dither_key=(0, 0), dither_bits=None,
                          dither_tpdf=True, emit_i16=False):
    """Plain K8: the pairs widened to f32 (exact) and concatenated, then
    the split conv of the plain K1."""
    h, tail_hi, tail_lo, k_pad = _pair_args(x_hi, x_lo, tail_hi, tail_lo, h)
    n = h.shape[0]
    eh = torch.cat([tail_hi, x_hi], dim=-1)[:, k_pad - (n - 1):].float()
    el = torch.cat([tail_lo, x_lo], dim=-1)[:, k_pad - (n - 1):].float()
    y = _finish(_conv_split(eh, el, h), out_clip, dither_key, dither_bits,
                dither_tpdf, emit_i16)
    return (y, _next_pair_tail(tail_hi, x_hi, k_pad),
            _next_pair_tail(tail_lo, x_lo, k_pad))


def _launch_pair(x_hi, x_lo, tail_hi, tail_lo, h, k_pad, out, S, idx, epi,
                 emit, what):
    B, T = x_hi.shape
    th = torch.empty((B, k_pad), dtype=torch.bfloat16, device=x_hi.device)
    tl = torch.empty_like(th)
    x_hi, x_lo = x_hi.contiguous(), x_lo.contiguous()
    lib = _build.load()
    with torch.cuda.device(x_hi.device):
        rc = lib.afp_fir_td_pair(
            x_hi.data_ptr(), x_lo.data_ptr(), tail_hi.data_ptr(),
            tail_lo.data_ptr(), h.data_ptr(), out.data_ptr(), th.data_ptr(),
            tl.data_ptr(), S, B, T, k_pad, h.shape[0], idx, *epi, int(emit),
            _stream(x_hi))
    _raise_on(rc, what)
    return th, tl


def fir_td_mxu_pair(x_hi: torch.Tensor, x_lo: torch.Tensor,
                    tail_hi: torch.Tensor, tail_lo: torch.Tensor,
                    h: torch.Tensor, out_clip=None, dither_key=(0, 0),
                    dither_bits=None, dither_tpdf=True, emit_i16=False):
    """K8: causal/valid conv of the bf16 pair of the block [B, T] behind the
    carried pair tail [B, n−1 .. k_pad] (narrower tails are zero-padded)
    with taps ``h``, clip then dither fused into the store as in K1 (and
    the int16 quantizer with ``emit_i16``).  Equal to K1 on concat(tail,
    block) when the pairs are :func:`split_bf16` of f32 inputs.  Returns
    ``(y, next_tail_hi, next_tail_lo)``: y [B, T] f32 (int16) and the last
    k_pad samples of concat(tail, block), the pair tail of the next block
    (`fir_td.py:700-743` with ``emit_tail``)."""
    if not _on_cuda(x_hi):
        return fir_td_mxu_pair_plain(x_hi, x_lo, tail_hi, tail_lo, h,
                                     out_clip, dither_key, dither_bits,
                                     dither_tpdf, emit_i16)
    h, tail_hi, tail_lo, k_pad = _pair_args(x_hi, x_lo, tail_hi, tail_lo, h)
    y = torch.empty(x_hi.shape,
                    dtype=torch.int16 if emit_i16 else torch.float32,
                    device=x_hi.device)
    th, tl = _launch_pair(x_hi, x_lo, tail_hi, tail_lo, h, k_pad, y, 1, 0,
                          _epi(out_clip, dither_key, dither_bits, dither_tpdf),
                          emit_i16, "fir_td_mxu_pair (K8)")
    fir_td_mxu_pair.launches += 1
    return y, th, tl


fir_td_mxu_pair.launches = 0
fir_td_mxu_pair.kernels = 2


def fir_td_mxu_pair_to_ring_plain(x_hi, x_lo, tail_hi, tail_lo, h, idx,
                                  out_ring, out_clip=None, dither_key=(0, 0),
                                  dither_bits=None, dither_tpdf=True):
    """Plain K7: the plain K8 with its tail, written into ``out_ring[idx]``
    in place (quantized when the ring is int16)."""
    y, th, tl = fir_td_mxu_pair_plain(x_hi, x_lo, tail_hi, tail_lo, h,
                                      out_clip, dither_key, dither_bits,
                                      dither_tpdf,
                                      out_ring.dtype == torch.int16)
    out_ring[int(idx) % out_ring.shape[0]] = y
    return out_ring, th, tl


def fir_td_mxu_pair_to_ring(x_hi: torch.Tensor, x_lo: torch.Tensor,
                            tail_hi: torch.Tensor, tail_lo: torch.Tensor,
                            h: torch.Tensor, idx: int, out_ring: torch.Tensor,
                            out_clip=None, dither_key=(0, 0),
                            dither_bits=None, dither_tpdf=True):
    """K7: :func:`fir_td_mxu_pair` writing its output into slot ``idx`` of
    ``out_ring`` [S, B, T] (f32, or int16 for the int16 store) in place
    (every other slot untouched), the same body and so the same bits as
    K8.  Returns ``(out_ring, next_tail_hi, next_tail_lo)``
    (`fir_td.py:828-862`)."""
    if out_ring.ndim != 3:
        raise ValueError(f"out_ring must be [S, {x_hi.shape[0]}, "
                         f"{x_hi.shape[-1]}], got {tuple(out_ring.shape)}")
    emit = _out_ring_emit(out_ring, (out_ring.shape[0], *x_hi.shape),
                          x_hi.device)
    if not _on_cuda(x_hi):
        return fir_td_mxu_pair_to_ring_plain(
            x_hi, x_lo, tail_hi, tail_lo, h, idx, out_ring, out_clip,
            dither_key, dither_bits, dither_tpdf)
    h, tail_hi, tail_lo, k_pad = _pair_args(x_hi, x_lo, tail_hi, tail_lo, h)
    S = out_ring.shape[0]
    th, tl = _launch_pair(x_hi, x_lo, tail_hi, tail_lo, h, k_pad, out_ring, S,
                          int(idx) % S,
                          _epi(out_clip, dither_key, dither_bits, dither_tpdf),
                          emit, "fir_td_mxu_pair_to_ring (K7)")
    fir_td_mxu_pair_to_ring.launches += 1
    return out_ring, th, tl


fir_td_mxu_pair_to_ring.launches = 0
fir_td_mxu_pair_to_ring.kernels = 2


# ---------------------------------------------------------------- K11 pair


def _ps_pair_args(x_hi, x_lo, tail_hi, tail_lo, kernels, gains):
    """Checks of K11's pair forms: the block pair and pair tail as K8's
    (:func:`_pair_block`, :func:`_pair_tail_args`), the band kernels [K, n] and the gains [B, K]
    float32 on the block's device.  Returns (kernels, gains, tail_hi,
    tail_lo, k_pad)."""
    for name, t in (("kernels", kernels), ("gains", gains)):
        if t.ndim != 2 or t.dtype != torch.float32 or t.device != x_hi.device:
            raise ValueError(f"{name} must be 2-D float32 on {x_hi.device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    if tuple(gains.shape) != (x_hi.shape[0], kernels.shape[0]):
        raise ValueError(f"gains must be [{x_hi.shape[0]}, "
                         f"{kernels.shape[0]}], got {tuple(gains.shape)}")
    tail_hi, tail_lo, k_pad = _pair_tail_args(
        _pair_block(x_hi, x_lo), tail_hi, tail_lo, kernels.shape[1], x_hi)
    return (kernels.contiguous(), gains.contiguous(), tail_hi, tail_lo, k_pad)


def fir_td_mxu_per_stream_pair_plain(x_hi, x_lo, tail_hi, tail_lo, kernels,
                                     gains, out_clip=None, dither_key=(0, 0),
                                     dither_bits=None, dither_tpdf=True,
                                     emit_i16=False):
    """Plain K11, pair form: the pairs widened to f32 (exact) and
    concatenated, as the plain K8, then the plain K11's band products and
    mix.  Returns ``(y, next_tail_hi, next_tail_lo)``."""
    kernels, gains, tail_hi, tail_lo, k_pad = _ps_pair_args(
        x_hi, x_lo, tail_hi, tail_lo, kernels, gains)
    n = kernels.shape[1]
    eh = torch.cat([tail_hi, x_hi], dim=-1)[:, k_pad - (n - 1):].float()
    el = torch.cat([tail_lo, x_lo], dim=-1)[:, k_pad - (n - 1):].float()
    y = _mix(lambda h: _conv_split(eh, el, h), kernels, gains,
             tuple(x_hi.shape))
    y = _finish(y, out_clip, dither_key, dither_bits, dither_tpdf, emit_i16)
    return (y, _next_pair_tail(tail_hi, x_hi, k_pad),
            _next_pair_tail(tail_lo, x_lo, k_pad))


def _launch_ps_pair(x_hi, x_lo, tail_hi, tail_lo, kernels, gains, k_pad, out,
                    S, idx, epi, emit, what):
    B, T = x_hi.shape
    th = torch.empty((B, k_pad), dtype=torch.bfloat16, device=x_hi.device)
    tl = torch.empty_like(th)
    x_hi, x_lo = x_hi.contiguous(), x_lo.contiguous()
    K, n = kernels.shape
    lib = _build.load()
    with torch.cuda.device(x_hi.device):
        rc = lib.afp_fir_td_ps_pair(
            x_hi.data_ptr(), x_lo.data_ptr(), tail_hi.data_ptr(),
            tail_lo.data_ptr(), kernels.data_ptr(), gains.data_ptr(),
            out.data_ptr(), th.data_ptr(), tl.data_ptr(), S, B, T, k_pad, n,
            K, idx, *epi, int(emit), _stream(x_hi))
    _raise_on(rc, what)
    return th, tl


def fir_td_mxu_per_stream_pair(x_hi: torch.Tensor, x_lo: torch.Tensor,
                               tail_hi: torch.Tensor, tail_lo: torch.Tensor,
                               kernels: torch.Tensor, gains: torch.Tensor,
                               out_clip=None, dither_key=(0, 0),
                               dither_bits=None, dither_tpdf=True,
                               emit_i16=False):
    """K11, staged pair form: the per-stream EQ mix of
    :func:`fir_td_mxu_per_stream` over the bf16 pair of the block [B, T]
    behind the carried pair tail [B, n−1 .. k_pad] (K8's loader: the AGC
    apply kernel's pair store, read without a split), with K11's fused
    clip, dither and int16 store.  Equal to K11 on concat(tail, block) when
    the pairs are :func:`split_bf16` of f32 inputs.  Returns ``(y,
    next_tail_hi, next_tail_lo)``, the tail as K8's.  bf16×3 only: the
    HIGHEST K11 has no pair form."""
    if not _on_cuda(x_hi):
        return fir_td_mxu_per_stream_pair_plain(
            x_hi, x_lo, tail_hi, tail_lo, kernels, gains, out_clip,
            dither_key, dither_bits, dither_tpdf, emit_i16)
    kernels, gains, tail_hi, tail_lo, k_pad = _ps_pair_args(
        x_hi, x_lo, tail_hi, tail_lo, kernels, gains)
    y = torch.empty(x_hi.shape,
                    dtype=torch.int16 if emit_i16 else torch.float32,
                    device=x_hi.device)
    th, tl = _launch_ps_pair(
        x_hi, x_lo, tail_hi, tail_lo, kernels, gains, k_pad, y, 1, 0,
        _epi(out_clip, dither_key, dither_bits, dither_tpdf), emit_i16,
        "fir_td_mxu_per_stream_pair (K11)")
    fir_td_mxu_per_stream_pair.launches += 1
    return y, th, tl


fir_td_mxu_per_stream_pair.launches = 0
fir_td_mxu_per_stream_pair.kernels = 2


def fir_td_mxu_per_stream_pair_to_ring_plain(x_hi, x_lo, tail_hi, tail_lo,
                                             kernels, gains, idx, out_ring,
                                             out_clip=None, dither_key=(0, 0),
                                             dither_bits=None,
                                             dither_tpdf=True):
    """Plain K11, pair-to-ring form: the plain staged pair form written
    into ``out_ring[idx]`` in place (quantized when the ring is int16)."""
    y, th, tl = fir_td_mxu_per_stream_pair_plain(
        x_hi, x_lo, tail_hi, tail_lo, kernels, gains, out_clip, dither_key,
        dither_bits, dither_tpdf, out_ring.dtype == torch.int16)
    out_ring[int(idx) % out_ring.shape[0]] = y
    return out_ring, th, tl


def fir_td_mxu_per_stream_pair_to_ring(x_hi: torch.Tensor, x_lo: torch.Tensor,
                                       tail_hi: torch.Tensor,
                                       tail_lo: torch.Tensor,
                                       kernels: torch.Tensor,
                                       gains: torch.Tensor, idx: int,
                                       out_ring: torch.Tensor, out_clip=None,
                                       dither_key=(0, 0), dither_bits=None,
                                       dither_tpdf=True):
    """K11, pair-to-ring form: :func:`fir_td_mxu_per_stream_pair` writing
    its output into slot ``idx`` of ``out_ring`` [S, B, T] (f32, or int16
    for the int16 store) in place, every other slot untouched: K7's store
    around the same kernel, so the slot equals the staged pair form's
    output bit for bit.  Returns ``(out_ring, next_tail_hi,
    next_tail_lo)``."""
    if out_ring.ndim != 3:
        raise ValueError(f"out_ring must be [S, {x_hi.shape[0]}, "
                         f"{x_hi.shape[-1]}], got {tuple(out_ring.shape)}")
    emit = _out_ring_emit(out_ring, (out_ring.shape[0], *x_hi.shape),
                          x_hi.device)
    if not _on_cuda(x_hi):
        return fir_td_mxu_per_stream_pair_to_ring_plain(
            x_hi, x_lo, tail_hi, tail_lo, kernels, gains, idx, out_ring,
            out_clip, dither_key, dither_bits, dither_tpdf)
    kernels, gains, tail_hi, tail_lo, k_pad = _ps_pair_args(
        x_hi, x_lo, tail_hi, tail_lo, kernels, gains)
    S = out_ring.shape[0]
    th, tl = _launch_ps_pair(
        x_hi, x_lo, tail_hi, tail_lo, kernels, gains, k_pad, out_ring, S,
        int(idx) % S, _epi(out_clip, dither_key, dither_bits, dither_tpdf),
        emit, "fir_td_mxu_per_stream_pair_to_ring (K11)")
    fir_td_mxu_per_stream_pair_to_ring.launches += 1
    return out_ring, th, tl


fir_td_mxu_per_stream_pair_to_ring.launches = 0
fir_td_mxu_per_stream_pair_to_ring.kernels = 2


# ---------------------------------------------------------------- K13


def _pair_ring_args(ring_hi, ring_lo, tail_hi, tail_lo, h, out_ring):
    """Shared checks of K13: bf16 pair rings [S, B, T] on one device, the
    LANE rule, the pair tail and the output ring.  Returns (h, tail_hi,
    tail_lo, k_pad, emit_i16)."""
    for name, t in (("ring_hi", ring_hi), ("ring_lo", ring_lo)):
        if t.dtype != torch.bfloat16 or t.ndim != 3 or (
                t.device != ring_hi.device):
            raise ValueError(f"{name} must be [S, B, T] bfloat16 on "
                             f"{ring_hi.device}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    if ring_lo.shape != ring_hi.shape:
        raise ValueError(f"the ring pair must be two [S, B, T] halves, got "
                         f"{tuple(ring_hi.shape)} and {tuple(ring_lo.shape)}")
    S, B, T = ring_hi.shape
    if T % LANE:
        raise ValueError(f"T={T} must be a multiple of {LANE}")
    emit = _out_ring_emit(out_ring, ring_hi.shape, ring_hi.device)
    h = _check_taps(h, ring_hi)
    return (h, *_pair_tail_args(B, tail_hi, tail_lo, h.shape[0], ring_hi),
            emit)


def fir_td_mxu_ring_plain(ring_hi, ring_lo, idx, tail_hi, tail_lo, h,
                          out_ring, out_clip=None, dither_key=(0, 0),
                          dither_bits=None, dither_tpdf=True):
    """Plain K13: the plain K7 on slot ``idx`` of the pair rings."""
    idx = int(idx) % ring_hi.shape[0]
    return fir_td_mxu_pair_to_ring_plain(
        ring_hi[idx], ring_lo[idx], tail_hi, tail_lo, h, idx, out_ring,
        out_clip, dither_key, dither_bits, dither_tpdf)


def fir_td_mxu_ring(ring_hi: torch.Tensor, ring_lo: torch.Tensor, idx: int,
                    tail_hi: torch.Tensor, tail_lo: torch.Tensor,
                    h: torch.Tensor, out_ring: torch.Tensor, out_clip=None,
                    dither_key=(0, 0), dither_bits=None, dither_tpdf=True):
    """K13: one serving step over the bf16 (hi, lo) pair rings [S, B, T]
    (``ingest='pair'``): slot ``idx`` behind the pair tail into slot
    ``idx`` of `out_ring` (f32 or int16), in place.  Equal to K7 on that
    slot's views, and to K3 on the f32 ring when the pairs are its
    :func:`split_bf16`.  Returns ``(out_ring, next_tail_hi, next_tail_lo)``
    (`fir_td.py:946-996` with ``emit_tail``)."""
    h, tail_hi, tail_lo, k_pad, emit = _pair_ring_args(
        ring_hi, ring_lo, tail_hi, tail_lo, h, out_ring)
    idx = int(idx) % ring_hi.shape[0]
    if not _on_cuda(ring_hi):
        return fir_td_mxu_ring_plain(ring_hi, ring_lo, idx, tail_hi, tail_lo,
                                     h, out_ring, out_clip, dither_key,
                                     dither_bits, dither_tpdf)
    th, tl = _launch_ring(
        _IN_PAIR, (ring_hi, ring_lo), (tail_hi, tail_lo), h, out_ring, k_pad,
        idx, 1, _epi(out_clip, dither_key, dither_bits, dither_tpdf), emit,
        "fir_td_mxu_ring (K13)")
    fir_td_mxu_ring.launches += 1
    return out_ring, th, tl


fir_td_mxu_ring.launches = 0
fir_td_mxu_ring.kernels = 2


def fir_td_mxu_ring_mega_plain(ring_hi, ring_lo, start, tail_hi, tail_lo, h,
                               out_ring, n_steps, out_clip=None,
                               dither_key=(0, 0), dither_bits=None,
                               dither_tpdf=True):
    """Plain K13 megakernel: the plain K13 step looped over slots
    ``(start+i) mod S``, block counter ``counter+i`` for step i."""
    S = ring_hi.shape[0]
    seed, counter = dither_key
    for i in range(n_steps):
        out_ring, tail_hi, tail_lo = fir_td_mxu_ring_plain(
            ring_hi, ring_lo, (start + i) % S, tail_hi, tail_lo, h, out_ring,
            out_clip, (seed, counter + i), dither_bits, dither_tpdf)
    return out_ring, tail_hi, tail_lo


def fir_td_mxu_ring_mega(ring_hi: torch.Tensor, ring_lo: torch.Tensor,
                         start: int, tail_hi: torch.Tensor,
                         tail_lo: torch.Tensor, h: torch.Tensor,
                         out_ring: torch.Tensor, n_steps: int, out_clip=None,
                         dither_key=(0, 0), dither_bits=None,
                         dither_tpdf=True):
    """K13, megakernel form: ``n_steps`` :func:`fir_td_mxu_ring` steps over
    slots ``(start+i) mod S`` in one launch, equal to the chained steps
    (`fir_td.py:1445-1485`).  Returns ``(out_ring, next_tail_hi,
    next_tail_lo)``."""
    h, tail_hi, tail_lo, k_pad, emit = _pair_ring_args(
        ring_hi, ring_lo, tail_hi, tail_lo, h, out_ring)
    n_steps = _check_steps(n_steps)
    start = int(start) % ring_hi.shape[0]
    if not _on_cuda(ring_hi):
        return fir_td_mxu_ring_mega_plain(
            ring_hi, ring_lo, start, tail_hi, tail_lo, h, out_ring, n_steps,
            out_clip, dither_key, dither_bits, dither_tpdf)
    th, tl = _launch_ring(
        _IN_PAIR, (ring_hi, ring_lo), (tail_hi, tail_lo), h, out_ring, k_pad,
        start, n_steps, _epi(out_clip, dither_key, dither_bits, dither_tpdf),
        emit, "fir_td_mxu_ring_mega (K13)")
    fir_td_mxu_ring_mega.launches += 1
    return out_ring, th, tl


fir_td_mxu_ring_mega.launches = 0
fir_td_mxu_ring_mega.kernels = 2
