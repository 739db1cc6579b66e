"""K6: the AGC gain recurrence, clip, apply and carry in one kernel
(replaces `afp_tpu/ops/pallas/agc_scan.py:smooth_gain_apply_pallas`); K9:
the recurrence alone (:func:`smooth_gain_scan`, replaces
`agc_scan.py:smooth_gain_scan_pallas`).

Per stream, over the time-major desired gain ``d`` [T, B]:

    a = a_att if d[t] > g else a_rel;   g = a·d[t] + (1 − a)·g
    y = clip(x · clip(g, 0.1, max_gain), ±out_clip);  carry = clip(g_last, …)

The start value is ``init`` when given, else the first chunk mean
(blockwise) or ``d[0]`` (`agc_scan.py:472-482`).  Blockwise ('fast' mode):
one step per chunk mean with the compounded alphas ``1 − (1 − a)^chunk``
(f32, by repeated squaring as `lax.integer_pow` does), and the ramp
``g + (gn − g)·(t+1)/chunk`` inside the chunk.  The alphas and max gain
are scalars or, for per-stream AGC policies, [B] vectors (any one promotes
all three, `agc_scan.py:460-471`; 'fast' compounds per stream).  x is f32
or, under
``ingest='pcm16'``, raw int16 PCM that the kernel converts ``n/32768`` as it
reads (exact, `agc_scan.py:273-277`).  A CPU tensor takes
:func:`smooth_gain_apply_plain` (a loop over time of whole-batch torch ops),
a CUDA tensor launches `csrc/agc_scan.cu` or raises.  Both round the
updates as XLA's CPU backend rounds the reference's expressions,
``fma(a, d, (1 − a)·g)`` and ``fma(gn − g, fr, g)``
(:func:`~afp_tpu_torch.ops.agc.fma_f32`), so the kernel, the plain version
and `afp_tpu` agree bit for bit given the same ``d``.
``smooth_gain_apply.launches`` counts kernel launches,
``smooth_gain_apply.vector_launches`` those with [B] vectors.

K9's plain version is :func:`~afp_tpu_torch.ops.agc.smooth_gain_scan`
itself (bit-exact to `afp_tpu`'s); the kernel rounds each step as K6 does and
restarts without a carry at ``g = d[0]``, so the two agree bit for bit.
``smooth_gain_scan.launches`` counts K9's launches.
"""
from __future__ import annotations

import torch

from ..agc import compound_alpha, fma_f32
from ..agc import smooth_gain_scan as _scan
from . import _build
from .agc_rms import carry_buffer, knobs
from .fir_td import _on_cuda, _raise_on, _stream, pcm16_to_f32, split_bf16

__all__ = ["smooth_gain_apply", "smooth_gain_apply_plain", "smooth_gain_scan",
           "smooth_gain_scan_plain"]


def _chunk_mean(rows: torch.Tensor) -> torch.Tensor:
    """Mean of the chunk's rows [chunk, B], summed in row order (the
    kernel's order), then times 1/chunk."""
    s = rows[0]
    for r in rows[1:]:
        s = s + r
    return s * (1.0 / rows.shape[0])


def _check(desired_tm, x, init, ring_idx, blockwise, d_is_means):
    """Shared argument checks: returns (d, the [B, T] block, init, T, B)."""
    if d_is_means and not blockwise:
        raise ValueError("d_is_means requires blockwise")
    if blockwise is not None and (blockwise <= 0 or 128 % blockwise):
        raise ValueError(f"blockwise chunk {blockwise} must divide 128")
    if desired_tm.ndim != 2 or desired_tm.dtype != torch.float32:
        raise ValueError(f"desired_tm must be [T, B] float32, got "
                         f"{tuple(desired_tm.shape)} {desired_tm.dtype}")
    if x.dtype not in (torch.float32, torch.int16):
        raise ValueError(f"x must be float32 or int16 PCM, got {x.dtype}")
    if ring_idx is not None:
        if x.ndim != 3:
            raise ValueError(f"ring mode needs an [S, B, T] ring, got "
                             f"{tuple(x.shape)}")
        x = x[int(ring_idx) % x.shape[0]]  # a view: no staging copy
    Td, B = desired_tm.shape
    T = Td * blockwise if d_is_means else Td
    if x.shape != (B, T) or x.device != desired_tm.device:
        raise ValueError(f"x must be [{B}, {T}] on {desired_tm.device}, got "
                         f"{tuple(x.shape)} on {x.device}")
    if blockwise and T % blockwise:
        raise ValueError(f"block length {T} must be a multiple of the "
                         f"blockwise chunk {blockwise}")
    if init is not None:
        init = torch.as_tensor(init, dtype=torch.float32, device=x.device)
        init = torch.broadcast_to(init.reshape(-1), (B,)).contiguous()
    return desired_tm, x, init, T, B


def _alphas(kn: dict, vec: bool, blockwise):
    """(a_att, a_rel, max_gain) from :func:`~.agc_rms.knobs`, the alphas
    compounded ``1 − (1 − a)^chunk`` for the blockwise recurrence (per
    stream for vectors, the same f32 squarings as for scalars)."""
    a_att, a_rel, mg = kn["a_att"], kn["a_rel"], kn["max_gain"]
    if blockwise:
        a_att, a_rel = (compound_alpha(a, blockwise) for a in (a_att, a_rel))
        if not vec:
            a_att, a_rel = float(a_att), float(a_rel)
    return a_att, a_rel, mg


def smooth_gain_apply_plain(desired_tm: torch.Tensor, x: torch.Tensor,
                            a_att, a_rel, max_gain, init=None,
                            out_clip: float = 0.99, emit_split: bool = False,
                            ring_idx=None, blockwise: int | None = None,
                            d_is_means: bool = False):
    """Plain K6, same contract as :func:`smooth_gain_apply`: the recurrence
    as a loop over time of whole-batch ops, in the kernel's order."""
    d, x, init, T, B = _check(desired_tm, x, init, ring_idx, blockwise,
                              d_is_means)
    vec, kn = knobs(B, x.device, a_att=a_att, a_rel=a_rel, max_gain=max_gain)
    a_att, a_rel, max_gain = _alphas(kn, vec, blockwise)
    gs = torch.empty((T, B), dtype=torch.float32, device=x.device)
    if blockwise:
        if init is not None:
            g = init
        else:
            g = d[0] if d_is_means else _chunk_mean(d[:blockwise])
        fr = ((torch.arange(blockwise, dtype=torch.float32, device=x.device)
               + 1.0) * (1.0 / blockwise))[:, None]
        for c in range(T // blockwise):
            m = d[c] if d_is_means else _chunk_mean(
                d[c * blockwise:(c + 1) * blockwise])
            a = torch.where(m > g, a_att, a_rel)
            gn = fma_f32(a, m, (1 - a) * g)
            gs[c * blockwise:(c + 1) * blockwise] = fma_f32(gn - g, fr, g)
            g = gn
    else:
        g = init if init is not None else d[0]
        for t in range(T):
            a = torch.where(d[t] > g, a_att, a_rel)
            g = fma_f32(a, d[t], (1 - a) * g)
            gs[t] = g
    mg = torch.as_tensor(max_gain, dtype=torch.float32, device=x.device)
    gc = torch.minimum(torch.clamp_min(gs, 0.1), mg).T
    y = torch.clamp(pcm16_to_f32(x) * gc, -out_clip, out_clip)
    carry = torch.minimum(torch.clamp_min(g, 0.1), mg)
    return (split_bf16(y) if emit_split else y), carry


def smooth_gain_apply(desired_tm: torch.Tensor, x: torch.Tensor, a_att, a_rel,
                      max_gain, init=None, out_clip: float = 0.99,
                      emit_split: bool = False, ring_idx=None,
                      blockwise: int | None = None, d_is_means: bool = False,
                      carry_out=None):
    """K6: the attack/release recurrence over ``desired_tm`` [T, B] (the
    layout :func:`~afp_tpu_torch.ops.cuda.agc_rms.rms_desired` emits with
    ``transposed``), applied to ``x`` [B, T], f32 or int16 PCM (or to slot
    ``ring_idx`` of an [S, B, T] ring, read in place).  ``init`` [B] is the
    carried gain, or None to restart; ``a_att``/``a_rel``/``max_gain`` are
    scalars or [B] vectors (any one promotes all three).  Returns ``(y,
    carry)``: y [B, T] f32 or, with ``emit_split``, its bf16 pair ``(y_hi,
    y_lo)``; carry [B] the clipped last gain.  ``blockwise=chunk`` runs the
    'fast' recurrence; with ``d_is_means`` the input is the [T/chunk, B]
    chunk-mean matrix.  ``carry_out`` [B], where given, receives the carry
    (:func:`~afp_tpu_torch.ops.cuda.agc_rms.carry_buffer`)."""
    if not _on_cuda(x):
        y, carry = smooth_gain_apply_plain(desired_tm, x, a_att, a_rel,
                                           max_gain, init, out_clip,
                                           emit_split, ring_idx, blockwise,
                                           d_is_means)
        return y, carry if carry_out is None else carry_out.copy_(carry)
    d, xs, init, T, B = _check(desired_tm, x, init, ring_idx, blockwise,
                               d_is_means)
    vec, kn = knobs(B, xs.device, a_att=a_att, a_rel=a_rel, max_gain=max_gain)
    a_att, a_rel, max_gain = _alphas(kn, vec, blockwise)
    d, xs = d.contiguous(), xs.contiguous()
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
        rc = lib.afp_agc_apply(
            d.data_ptr(), xs.data_ptr(),
            None if init is None else init.data_ptr(), *ptrs,
            carry.data_ptr(), B, T, int(blockwise or 0), int(bool(d_is_means)),
            int(xs.dtype == torch.int16),
            *((0.0, 0.0, 0.0) if vec else (a_att, a_rel, max_gain)),
            float(out_clip),
            *((a_att.data_ptr(), a_rel.data_ptr(), max_gain.data_ptr()) if vec
              else (None, None, None)), _stream(xs))
    _raise_on(rc, "smooth_gain_apply (K6)")
    smooth_gain_apply.launches += 1
    smooth_gain_apply.vector_launches += int(vec)
    return ((yh, yl) if emit_split else y), carry


smooth_gain_apply.launches = 0
smooth_gain_apply.kernels = 1
smooth_gain_apply.vector_launches = 0


# ---------------------------------------------------------------- K9


def _scan_args(desired, time_major):
    """The [B, T] view of `desired` (time-major [T, B], or [..., T] with its
    leading axes flattened) and the output's leading shape."""
    d = torch.as_tensor(desired)
    if d.dtype != torch.float32 or d.ndim < 1 or (time_major and d.ndim != 2):
        raise ValueError(f"desired must be float32 [..., T] (time_major: "
                         f"[T, B]), got {tuple(d.shape)} {d.dtype}")
    if time_major:
        return d.T, (d.shape[1],)
    return d.reshape(-1, d.shape[-1]), tuple(d.shape[:-1])


def smooth_gain_scan_plain(desired, a_att, a_rel, init=None,
                           time_major: bool = False,
                           out_batch_major: bool = False) -> torch.Tensor:
    """Plain K9: :func:`~afp_tpu_torch.ops.agc.smooth_gain_scan` on the
    batch-major view (`out_batch_major` only chooses the kernel's store)."""
    d, lead = _scan_args(desired, time_major)
    if init is not None:
        init = torch.broadcast_to(torch.as_tensor(
            init, dtype=torch.float32, device=d.device).reshape(-1),
            (d.shape[0],))
    return _scan(d, a_att, a_rel, init).reshape(lead + (d.shape[-1],))


def smooth_gain_scan(desired: torch.Tensor, a_att, a_rel, init=None,
                     time_major: bool = False,
                     out_batch_major: bool = False) -> torch.Tensor:
    """K9: the exact attack/release recurrence over ``desired`` [..., T]
    (or [T, B] with ``time_major``, the layout K5 emits), from ``init``
    [...] or, without one, restarting at ``desired[..., 0]``; the drop-in
    for :func:`~afp_tpu_torch.ops.agc.smooth_gain_scan`
    (`agc_scan.py:142-201`).  The result is batch-major [..., T] (or
    [B, T]); the kernel stores it so with ``out_batch_major``, else it
    stores [T, B] and the result is that tensor's transposed view."""
    d, lead = _scan_args(desired, time_major)
    if not _on_cuda(d):
        return smooth_gain_scan_plain(desired, a_att, a_rel, init,
                                      time_major, out_batch_major)
    B, T = d.shape
    if init is not None:
        init = torch.broadcast_to(torch.as_tensor(
            init, dtype=torch.float32, device=d.device).reshape(-1),
            (B,)).contiguous()
    src = (d.T if time_major else d).contiguous()  # the layout as given
    out = torch.empty((B, T) if out_batch_major else (T, B),
                      dtype=torch.float32, device=d.device)
    lib = _build.load()
    with torch.cuda.device(d.device):
        rc = lib.afp_agc_scan(
            src.data_ptr(), None if init is None else init.data_ptr(),
            out.data_ptr(), B, T, int(bool(time_major)),
            int(not out_batch_major), float(a_att), float(a_rel), _stream(d))
    _raise_on(rc, "smooth_gain_scan (K9)")
    smooth_gain_scan.launches += 1
    g = out if out_batch_major else out.T
    return g.reshape(lead + (T,))


smooth_gain_scan.launches = 0
smooth_gain_scan.kernels = 1
