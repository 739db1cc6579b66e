"""K14: the one-kernel AGC (replaces
`afp_tpu/ops/pallas/agc_fused.py:agc_rms_apply_pallas`).

Moving RMS, desired gain, the attack/release recurrence, the gain clip and
the apply in one pass over the raw block:

    W  = chunk-prefix moving sum of x² (TC = 128, w = 2h·TC, 'same')
    d  = clip(target / (sqrt(max(W·(1/w), 0)) + 1e−10), 0, max_gain)
    g  = the recurrence over d from ``init`` (or restarting at d[0])
    y  = clip(x · clip(g, 0.1, max_gain), ±out_clip);  carry = clip(g_last, …)

The window sums are the function's point (`agc_fused.py:35-47`): for output
sample t of chunk i, ``W = (base_i − C_{i−h}[t]) + C_{i+h}[t]``, with
``C_k[t]`` chunk k's own running sum of x² before t and ``base_i`` the 2h
chunk totals ``S_{i−h} … S_{i+h−1}`` — every term window-local (≈2⁻²⁴
where the two-kernel chain's bf16 boxcar reaches ≈2⁻¹⁷).  The plain
version repeats the reference kernel's rounding as XLA's CPU backend
evaluates it, which a CPU test holds bit for bit: running sums ``c + x·x``,
``base`` summed from 0 in ring-slot order (total k in slot k mod 2h, read
before step h+i writes slot (h+i) mod 2h), ``(base − C_old) + C_new``, and
the recurrence ``fma(a, d, (1 − a)·g)`` (:func:`~afp_tpu_torch.ops.agc.fma_f32`).

A CPU tensor takes :func:`agc_rms_apply_plain`, a CUDA tensor launches
`csrc/agc_fused.cu` or raises.  ``agc_rms_apply.launches`` counts kernel
launches.  The knobs are scalars: `afp_tpu`'s pipeline runs the two-kernel
chain under per-stream AGC vectors, and so does the port's.
"""
from __future__ import annotations

import torch

from ..agc import fma_f32
from . import _build
from .agc_rms import carry_buffer, knobs
from .fir_td import _on_cuda, _raise_on, _stream, pcm16_to_f32, split_bf16

__all__ = ["TC", "fused_rms_supported", "agc_rms_apply", "agc_rms_apply_plain"]

#: the time chunk of the window decomposition (`agc_fused.py:86`)
TC = 128


def fused_rms_supported(B: int, T: int, w: int, lp: int) -> bool:
    """The gate of the one-kernel AGC (`agc_fused.py:115-127`): a window
    that is whole chunk pairs, ``w ≥ 2·TC`` and ``w % (2·TC) == 0``, with
    exact 'same' centering ``lp == w/2``, and a block of whole chunks.  The
    reference's batch ladder (`pick_sub_fused`, a VMEM budget) has no job
    here: the kernel masks rows, so any batch runs."""
    return (B > 0 and w >= 2 * TC and w % (2 * TC) == 0 and lp == w // 2
            and T > 0 and T % TC == 0)


def _check(x, w, init, ring_idx):
    """Shared argument checks: returns (the [B, T] block, init or None)."""
    if x.dtype not in (torch.float32, torch.int16):
        raise ValueError(f"x must be float32 or int16 PCM, got {x.dtype}")
    if ring_idx is not None:
        if x.ndim != 3:
            raise ValueError(f"ring mode needs an [S, B, T] ring, got "
                             f"{tuple(x.shape)}")
        x = x[int(ring_idx) % x.shape[0]]  # a view: no staging copy
    elif x.ndim != 2:
        raise ValueError(f"x must be [B, T], got {tuple(x.shape)}")
    B, T = x.shape
    w = int(w)
    if not fused_rms_supported(B, T, w, w // 2):
        raise ValueError(
            f"shape [B={B}, T={T}], w={w} not supported by the one-kernel "
            "AGC: gate with fused_rms_supported()")
    if init is not None:
        init = torch.as_tensor(init, dtype=torch.float32, device=x.device)
        init = torch.broadcast_to(init.reshape(-1), (B,)).contiguous()
    return x, init


def _scalars(B, device, a_att, a_rel, target, max_gain):
    vec, kn = knobs(B, device, a_att=a_att, a_rel=a_rel, target=target,
                    max_gain=max_gain)
    if vec:
        raise ValueError("the one-kernel AGC takes scalar knobs (per-stream "
                         "AGC policies run the two-kernel chain)")
    return kn["a_att"], kn["a_rel"], kn["target"], kn["max_gain"]


def _window_sums(xf: torch.Tensor, w: int) -> torch.Tensor:
    """The moving sums W [B, nch, TC] of x² by the chunk-prefix
    decomposition, in the kernel's order of operations."""
    B, T = xf.shape
    nch, h = T // TC, w // (2 * TC)
    sq = (xf * xf).reshape(B, nch, TC)
    C = torch.empty_like(sq)  # C[k][t]: chunk k's running sum before t
    c = torch.zeros((B, nch), dtype=torch.float32, device=xf.device)
    for t in range(TC):
        C[..., t] = c
        c = c + sq[..., t]
    # output chunk i is finished at step j = i + h, where slot s of the ring
    # holds total k = the latest k < j with k ≡ s (mod 2h), 0 if none
    j = torch.arange(nch, device=xf.device) + h
    base = torch.zeros((B, nch), dtype=torch.float32, device=xf.device)
    for s in range(2 * h):
        k = j - 1 - torch.remainder(j - 1 - s, 2 * h)
        ok = (k >= 0) & (k < nch)
        base = base + torch.where(ok, c[:, k.clamp(0, nch - 1)],
                                  torch.zeros((), device=xf.device))
    pad = torch.zeros((B, h, TC), dtype=torch.float32, device=xf.device)
    Cp = torch.cat([pad, C, pad], dim=1)  # chunk k at k + h
    return (base[..., None] - Cp[:, :nch]) + Cp[:, 2 * h:2 * h + nch]


def agc_rms_apply_plain(x: torch.Tensor, w: int, a_att, a_rel, target,
                        max_gain, init=None, out_clip: float = 0.99,
                        emit_split: bool = False, ring_idx=None):
    """Plain K14, same contract as :func:`agc_rms_apply`: the window sums
    vectorised over chunks, the recurrence a loop over time of whole-batch
    ops, in the kernel's order."""
    x, init = _check(x, w, init, ring_idx)
    B, T = x.shape
    a_att, a_rel, target, mg = _scalars(B, x.device, a_att, a_rel, target,
                                        max_gain)
    xf = pcm16_to_f32(x)
    W = _window_sums(xf, int(w)).reshape(B, T)
    inv_w, target = (torch.tensor(v, dtype=torch.float32, device=x.device)
                     for v in (1.0 / int(w), target))
    # sqrt in float64, rounded once to f32: the correctly rounded f32 sqrt
    # (torch's f32 sqrt on the CPU is not)
    rms = torch.sqrt(torch.clamp_min(W * inv_w, 0.0).double()).float()
    # a tensor numerator: `float / tensor` is reciprocal() * float in torch
    d = torch.clamp(target / (rms + 1e-10), 0.0, mg)
    gs = torch.empty((B, T), dtype=torch.float32, device=x.device)
    g = init
    for t in range(T):
        if t == 0 and init is None:
            g = d[:, 0]  # the restart: g_{-1} := d[0]
        else:
            a = torch.where(d[:, t] > g, a_att, a_rel)
            g = fma_f32(a, d[:, t], (1 - a) * g)
        gs[:, t] = g
    gc = torch.clamp(gs, 0.1, mg)
    y = torch.clamp(xf * gc, -out_clip, out_clip)
    carry = torch.clamp(g, 0.1, mg)
    return (split_bf16(y) if emit_split else y), carry


def agc_rms_apply(x: torch.Tensor, w: int, a_att, a_rel, target, max_gain,
                  init=None, out_clip: float = 0.99, emit_split: bool = False,
                  ring_idx=None, carry_out=None):
    """K14: the whole AGC stage of ``x`` [B, T], f32 or int16 PCM (or of slot
    ``ring_idx`` of an [S, B, T] ring, read in place), with moving-RMS window
    ``w`` (:func:`fused_rms_supported` must hold).  ``init`` [B] is the
    carried gain, or None to restart at the block's first desired gain.
    Returns ``(y, carry)``: y [B, T] f32 or, with ``emit_split``, its bf16
    pair ``(y_hi, y_lo)`` for K8/K7; carry [B] the clipped last gain
    (`agc_fused.py:295-358`), stored into ``carry_out`` where given, as
    K6's."""
    if not _on_cuda(x):
        y, carry = agc_rms_apply_plain(x, w, a_att, a_rel, target, max_gain,
                                       init, out_clip, emit_split, ring_idx)
        return y, carry if carry_out is None else carry_out.copy_(carry)
    xs, init = _check(x, w, init, ring_idx)
    B, T = xs.shape
    a_att, a_rel, target, mg = _scalars(B, xs.device, a_att, a_rel, target,
                                        max_gain)
    xs = xs.contiguous()
    dev = xs.device
    carry = carry_buffer(carry_out, B, dev)
    if emit_split:
        yh = torch.empty((B, T), dtype=torch.bfloat16, device=dev)
        yl = torch.empty((B, T), dtype=torch.bfloat16, device=dev)
        ptrs = (None, yh.data_ptr(), yl.data_ptr())
    else:
        y = torch.empty((B, T), dtype=torch.float32, device=dev)
        ptrs = (y.data_ptr(), None, None)
    lib = _build.load()
    with torch.cuda.device(dev):
        rc = lib.afp_agc_fused(
            xs.data_ptr(), None if init is None else init.data_ptr(), *ptrs,
            carry.data_ptr(), B, T, int(w), int(xs.dtype == torch.int16),
            a_att, a_rel, target, mg, float(out_clip), _stream(xs))
    _raise_on(rc, "agc_rms_apply (K14)")
    agc_rms_apply.launches += 1
    return ((yh, yl) if emit_split else y), carry


agc_rms_apply.launches = 0
agc_rms_apply.kernels = 1
