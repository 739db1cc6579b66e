"""K5: moving RMS → desired AGC gain (replaces
`afp_tpu/ops/pallas/agc_rms.py:rms_desired_pallas`).

    d = clip(target / (sqrt(boxcar_W(x²)) + 1e−10), 0, max_gain)

with numpy's 'same' zero padding (``lp = W//2``, ``rp = W−1−W//2``), from
the raw block in one pass.  The numerics are the TPU kernel's: x² is split
into bf16 halves and the halves are summed; a window that is a multiple of
128 runs the two-level form (128-wide sums of weight 1, the ``W/128``
shifted sums added, then ``· (1/W)`` in fp32); any other window weighs the
sums with the band's bf16-split ``1/w`` (a third product when ``1/w`` is
not exact in bf16).  x is f32 or, under ``ingest='pcm16'``, raw int16 PCM
that the kernel converts ``n/32768`` as it loads (exact: the result is the
f32 form's bit for bit, `agc_rms.py:111-113`).  ``target`` and
``max_gain`` are scalars or, for per-stream AGC policies, [B] vectors;
either vector promotes both (`agc_rms.py:377-390`).  A CPU tensor takes
:func:`rms_desired_plain` (the window sums of the split x² as float64
reductions, rounded once), a CUDA tensor launches `csrc/agc_rms.cu` or
raises.  :func:`rms_desired_model` is the kernel's own summation order in
plain float32 ops (chunk suffix + whole-chunk totals + chunk prefix, as
warp scans), which the kernel equals bit for bit; the tests hold it to the
plain version.  ``rms_desired.launches`` counts
kernel launches, ``rms_desired.vector_launches`` those with [B] vectors.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build
from .fir_td import (LANE, _on_cuda, _raise_on, _split_f32, _stream,
                     pcm16_to_f32)

__all__ = ["rms_desired", "rms_desired_plain", "rms_desired_model",
           "band_is_exact_bf16", "knobs"]

_LAYOUT_BT, _LAYOUT_TB, _LAYOUT_MEANS = 0, 1, 2


def band_is_exact_bf16(band) -> bool:
    """True iff every band entry survives an f32 → bf16 → f32 round trip:
    then the lo half of the boxcar weight is zero and the third product can
    be skipped (`agc_rms.py:43-47`)."""
    b = torch.as_tensor(np.asarray(band, dtype=np.float32))
    return bool(torch.equal(b.to(torch.bfloat16).to(torch.float32), b))


def knobs(B: int, device, **values):
    """AGC knobs as the kernels take them: ``(False, {name: float})`` when
    every value is a scalar; when any is a [B] vector (a per-stream policy
    bank, `engine/batch.py:with_per_stream_agc`), ``(True, {name: [B]
    float32 tensor on device})`` for all of them, a scalar broadcast (one
    vector promotes its siblings)."""
    ts = {k: torch.as_tensor(v).to(torch.float32) for k, v in values.items()}
    if all(t.ndim == 0 for t in ts.values()):
        return False, {k: float(t) for k, t in ts.items()}
    for k, t in ts.items():
        if t.ndim > 1 or (t.ndim == 1 and t.shape[0] != B):
            raise ValueError(f"{k} must be a scalar or a [{B}] vector, got "
                             f"shape {tuple(t.shape)}")
    return True, {k: torch.broadcast_to(t.to(device), (B,)).contiguous()
                  for k, t in ts.items()}


def carry_buffer(carry_out, B: int, device) -> torch.Tensor:
    """The [B] float32 tensor an AGC kernel stores its gain carry into: a
    fresh one, or the given `carry_out` (contiguous, on `device`; not the
    ``init`` the kernel reads)."""
    if carry_out is None:
        return torch.empty(B, dtype=torch.float32, device=device)
    if (tuple(carry_out.shape) != (B,) or carry_out.dtype != torch.float32
            or carry_out.device != device or not carry_out.is_contiguous()):
        raise ValueError(f"carry_out must be a contiguous [{B}] float32 on "
                         f"{device}, got {tuple(carry_out.shape)} "
                         f"{carry_out.dtype} on {carry_out.device}")
    return carry_out


def _check(x, band, lp, rp, transposed, ring_idx, mean_chunk):
    """Shared argument checks: returns (the [B, T] block, W)."""
    if mean_chunk and (not transposed or LANE % mean_chunk
                       or mean_chunk & (mean_chunk - 1)):
        raise ValueError(
            f"mean_chunk={mean_chunk} requires transposed=True and a power "
            f"of two dividing {LANE} (the 1/chunk weight must be exact)")
    if x.dtype not in (torch.float32, torch.int16):
        raise ValueError(f"x must be float32 or int16 PCM, got {x.dtype}")
    if ring_idx is not None:
        if x.ndim != 3:
            raise ValueError(f"ring mode needs an [S, B, T] ring, got "
                             f"{tuple(x.shape)}")
        x = x[int(ring_idx) % x.shape[0]]  # a view: no staging copy
    elif x.ndim != 2:
        raise ValueError(f"x must be [B, T], got {tuple(x.shape)}")
    if x.shape[-1] % LANE:
        raise ValueError(f"block length {x.shape[-1]} must be a multiple of {LANE}")
    if band.ndim != 2 or band.shape[1] != LANE or band.shape[0] < LANE:
        raise ValueError(f"band must be [W-1+{LANE}, {LANE}], got {tuple(band.shape)}")
    W = band.shape[0] - LANE + 1
    if lp < 0 or rp < 0 or lp + rp != W - 1:
        raise ValueError(f"pads lp={lp}, rp={rp} must sum to W-1 = {W - 1}")
    return x, W


def _two_level(W: int) -> bool:
    return W >= LANE and W % LANE == 0


def _window_sums(v: torch.Tensor, w: int) -> torch.Tensor:
    """Every w-wide window sum of v [B, L] → [B, L − w + 1], summed in
    float64 by a reduction (no GEMM: the CPU's f32 GEMM has been seen to
    return another rounding in a few fresh processes) and rounded once to
    f32."""
    return v.double().unfold(1, w, 1).sum(-1).float()


def _desired(s: torch.Tensor, vec: bool, kn: dict) -> torch.Tensor:
    """The window sums s [B, T] (weighted) → d, as the kernels' epilogue."""
    # sqrt in float64, rounded once to f32: the correctly rounded f32 sqrt
    # of the kernel's __fsqrt_rn (torch's f32 sqrt on the CPU is not)
    rms = torch.sqrt(torch.clamp_min(s, 0.0).double()).float()
    # a true division (a Python float over a tensor would multiply by the
    # reciprocal); per-stream values broadcast along the rows
    t, mg = (torch.as_tensor(kn[k], dtype=torch.float32, device=s.device)
             for k in ("target", "max_gain"))
    if vec:
        t, mg = t[:, None], mg[:, None]
    return torch.minimum(torch.clamp_min(t / (rms + 1e-10), 0.0), mg)


def rms_desired_plain(x: torch.Tensor, band: torch.Tensor, lp: int, rp: int,
                      target, max_gain, exact_band: bool,
                      transposed: bool = False, ring_idx=None,
                      mean_chunk: int = 0) -> torch.Tensor:
    """Plain K5, same contract as :func:`rms_desired`: the padded x² split
    into bf16 halves and their window sums (two-level: the LANE-wide sums,
    then the W/LANE shifted sums added in f32 and ``· (1/W)``; direct: the
    sums of hi + lo weighted by the bf16 halves of the band's ``1/w``, the
    lo weight over the sums of hi alone unless ``1/w`` is exact in bf16);
    int16 x converts n/32768 first."""
    x, W = _check(x, band, lp, rp, transposed, ring_idx, mean_chunk)
    x = pcm16_to_f32(x)
    B, T = x.shape
    vec, kn = knobs(B, x.device, target=target, max_gain=max_gain)
    sq = torch.nn.functional.pad(x * x, (lp, rp))  # [B, T + W − 1]
    sh, sl = _split_f32(sq)
    both = sh + sl  # exact: the halves' bits do not overlap
    if _two_level(W):
        s_lane = _window_sums(both, LANE)  # [B, T + W − LANE]
        s = s_lane[:, :T]
        for j in range(1, W // LANE):
            s = s + s_lane[:, j * LANE: j * LANE + T]
        s = s * (1.0 / W)
    else:
        wh, wl = _split_f32(band[W - 1, :1])  # the boxcar weight 1/w
        s = _window_sums(both, W) * wh
        if not exact_band:
            s = s + _window_sums(sh, W) * wl
    d = _desired(s, vec, kn)
    if mean_chunk:
        # the chunk means of d's bf16 halves, each half summed in float64
        # and rounded once (1/chunk is exact)
        dh, dl = (h.double().reshape(B, T // mean_chunk, mean_chunk).sum(-1)
                  for h in _split_f32(d))
        m = (dh.float() * (1.0 / mean_chunk) + dl.float() * (1.0 / mean_chunk))
        return m.T.contiguous()  # [T/mean_chunk, B]
    return d.T.contiguous() if transposed else d


def _lane_scans(v: torch.Tensor):
    """The kernel's warp scans of 128-sample chunks v [..., 128], lane l
    holding positions 4l .. 4l+3, every add an f32 add in the kernel's
    order: the exclusive prefix sums P, the inclusive suffix sums S and
    the chunk totals [...] (the prefix scan's last inclusive sum)."""
    v0, v1, v2, v3 = v.reshape(*v.shape[:-1], 32, 4).unbind(-1)
    a0 = v0  # in-lane prefix sums ...
    a1 = a0 + v1
    a2 = a1 + v2
    a3 = a2 + v3
    b3 = v3  # ... and suffix sums
    b2 = v2 + b3
    b1 = v1 + b2
    b0 = v0 + b1
    x, y = a3, b0
    for off in (1, 2, 4, 8, 16):  # Kogge-Stone across the lanes
        x = torch.cat([x[..., :off], x[..., :-off] + x[..., off:]], -1)
        y = torch.cat([y[..., :-off] + y[..., off:], y[..., -off:]], -1)
    zero = torch.zeros_like(x[..., :1])
    e = torch.cat([zero, x[..., :-1]], -1)  # sum of the lanes below
    f = torch.cat([y[..., 1:], zero], -1)  # sum of the lanes above
    p = torch.stack([e, e + a0, e + a1, e + a2], -1)
    s = torch.stack([f + b0, f + b1, f + b2, f + b3], -1)
    return p.flatten(-2), s.flatten(-2), x[..., 31]


def rms_desired_model(x: torch.Tensor, band: torch.Tensor, lp: int, rp: int,
                      target, max_gain, exact_band: bool,
                      transposed: bool = False, ring_idx=None,
                      mean_chunk: int = 0) -> torch.Tensor:
    """K5's summation order as plain float32 ops (for the tests: the kernel
    equals it bit for bit on the card, and it stays within the class of
    :func:`rms_desired_plain`).  Two-level form, with 128-sample chunks of
    the padded row (chunk k holds padded positions 128k .. 128k+127): the
    window of output t = 128c + r is

        s = (S_c[r] + (T_{c+1} + … + T_{c+m−1})) + P_{c+m}[r],   m = W/128

    the suffix of chunk c from r, the totals of the m−1 whole chunks in
    order from 0, and the exclusive prefix of chunk c+m to r
    (:func:`_lane_scans`); then ``· f32(1/W)``.  Every term is a sum of
    non-negative samples, so no difference cancels.  Direct form: the old
    doubling, p_2k[u] = p_k[u] + p_k[u+k], the levels of W's set bits added
    low to high.  Chunk means: the bf16 halves of d summed in time order."""
    x, W = _check(x, band, lp, rp, transposed, ring_idx, mean_chunk)
    x = pcm16_to_f32(x)
    B, T = x.shape
    vec, kn = knobs(B, x.device, target=target, max_gain=max_gain)
    sh, sl = _split_f32(torch.nn.functional.pad(x * x, (lp, rp + 1)))
    both = sh + sl  # [B, T + W], exact
    if _two_level(W):
        m, nc = W // LANE, T // LANE
        p, s, tot = _lane_scans(both.reshape(B, -1, LANE))
        mid = torch.zeros((B, nc), dtype=torch.float32, device=x.device)
        for j in range(1, m):
            mid = mid + tot[:, j: j + nc]
        s = (s[:, :nc] + mid[..., None]) + p[:, m: m + nc]
        s = s.reshape(B, T) * torch.tensor(1.0 / W, dtype=torch.float32,
                                            device=x.device)
    else:
        acc = hacc = torch.zeros((B, T), dtype=torch.float32, device=x.device)
        cur, hcur, off, w = both[:, :-1], sh[:, :-1], 0, 1
        while w <= W:
            if W & w:
                acc = acc + cur[:, off: off + T]
                hacc = hacc + hcur[:, off: off + T]
                off += w
            if 2 * w <= W:
                cur = cur[:, :-w] + cur[:, w:]
                hcur = hcur[:, :-w] + hcur[:, w:]
            w *= 2
        wh, wl = _split_f32(band[W - 1, :1])
        s = acc * wh
        if not exact_band:
            s = s + hacc * wl
    d = _desired(s, vec, kn)
    if mean_chunk:
        dh, dl = (h.reshape(B, T // mean_chunk, mean_chunk)
                  for h in _split_f32(d))
        ah = al = torch.zeros((B, T // mean_chunk), dtype=torch.float32,
                               device=x.device)
        for q in range(mean_chunk):
            ah, al = ah + dh[..., q], al + dl[..., q]
        inv = 1.0 / mean_chunk  # exact
        return (ah * inv + al * inv).T.contiguous()
    return d.T.contiguous() if transposed else d


def rms_desired(x: torch.Tensor, band: torch.Tensor, lp: int, rp: int,
                target, max_gain, exact_band: bool, transposed: bool = False,
                ring_idx=None, mean_chunk: int = 0) -> torch.Tensor:
    """K5: the desired AGC gain of the block ``x`` [B, T], f32 or int16 PCM
    (or of slot ``ring_idx`` of an [S, B, T] ring, read in place).
    ``band`` is the boxcar band matrix [W−1+LANE, LANE] of ``ones(W)/W``
    (:func:`~afp_tpu_torch.ops.cuda.fir_td.band_matrix`); ``lp``/``rp`` the
    'same' pads; ``target``/``max_gain`` scalars or [B] vectors (either
    promotes both); ``exact_band`` from
    :func:`band_is_exact_bf16`.  Returns d [B, T], or [T, B] with
    ``transposed``, or with ``mean_chunk`` (needs ``transposed``) the
    time-major chunk means [T/mean_chunk, B] that the blockwise recurrence
    consumes (`agc_rms.py:330-420`)."""
    if not _on_cuda(x):
        return rms_desired_plain(x, band, lp, rp, target, max_gain,
                                 exact_band, transposed, ring_idx, mean_chunk)
    xs, W = _check(x, band, lp, rp, transposed, ring_idx, mean_chunk)
    vec, kn = knobs(xs.shape[0], xs.device, target=target, max_gain=max_gain)
    if band.device != xs.device or band.dtype != torch.float32:
        raise ValueError(f"band must be float32 on {xs.device}, got "
                         f"{band.dtype} on {band.device}")
    xs, band = xs.contiguous(), band.contiguous()
    B, T = xs.shape
    if mean_chunk:
        layout, shape = _LAYOUT_MEANS, (T // mean_chunk, B)
    elif transposed:
        layout, shape = _LAYOUT_TB, (T, B)
    else:
        layout, shape = _LAYOUT_BT, (B, T)
    out = torch.empty(shape, dtype=torch.float32, device=xs.device)
    lib = _build.load()
    with torch.cuda.device(xs.device):
        rc = lib.afp_rms_desired(
            xs.data_ptr(), band.data_ptr(), out.data_ptr(), B, T, W, int(lp),
            int(_two_level(W)), int(bool(exact_band)), layout, int(mean_chunk),
            int(xs.dtype == torch.int16),
            *((0.0, 0.0) if vec else (kn["target"], kn["max_gain"])), 1.0 / W,
            *((kn["target"].data_ptr(), kn["max_gain"].data_ptr()) if vec
              else (None, None)), _stream(xs))
    _raise_on(rc, "rms_desired (K5)")
    rms_desired.launches += 1
    rms_desired.vector_launches += int(vec)
    return out


rms_desired.launches = 0
rms_desired.kernels = 1
rms_desired.vector_launches = 0
