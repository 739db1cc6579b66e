"""Automatic gain control, plain PyTorch (counterpart of `afp_tpu/ops/agc.py`).

The reference's `apply_agc` (`stream_process_AGC.py:43-89`):

1. moving-window RMS, ``sqrt(convolve(x², ones(w)/w, 'same'))``;
2. desired gain ``clip(target/(rms + 1e-10), 0, max_gain)``;
3. per-sample attack/release one-pole smoothing, α = a_att while the
   desired gain rises above the smoothed one, a_rel otherwise, with
   ``α = 1 − exp(−1/τ)`` and τ truncated to whole samples (each update
   rounded as XLA's CPU backend rounds it, :func:`fma_f32`);
4. the final ``clip(gain, 0.1, max_gain)``.

:func:`smooth_gain_scan` is the exact recurrence (a loop over time of
whole-batch ops), :func:`smooth_gain_blockwise` the 'fast' chunk-granular
approximation.  The pipeline's hot path runs the same math in kernels K5
(`ops/cuda/agc_rms.py`) and K6 (`ops/cuda/agc_scan.py`); these functions are
the ops-level surface and the tests' reference: on every device they run
as written here.  :func:`apply_agc` on a CUDA tensor runs the recurrence as
kernel K9 (`ops/cuda/agc_scan.py:smooth_gain_scan`, bit-exact to
:func:`smooth_gain_scan`); on the CPU it stays plain.  :func:`smooth_gain_parallel` is the
branch-consistent associative-scan solver of ``agc_mode='parallel'``, the
recurrence's consistency oracle (torch ops on every device).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .convolve import next_pow2

__all__ = ["agc_alphas", "moving_rms", "desired_gain", "link_desired",
           "smooth_gain_scan", "smooth_gain_parallel",
           "smooth_gain_blockwise", "apply_agc",
           "AGCParams", "compound_alpha", "fma_f32"]


def agc_alphas(window_size: int, attack: float = 0.01, release: float = 0.1):
    """Reference α computation (`stream_process_AGC.py:56-58, 70-76`):
    τ = int(time·window_size) samples; α = 1 − exp(−1/τ); τ == 0 → α = 1."""
    attack_samples = int(attack * window_size)
    release_samples = int(release * window_size)
    a_att = 1.0 - math.exp(-1.0 / attack_samples) if attack_samples > 0 else 1.0
    a_rel = 1.0 - math.exp(-1.0 / release_samples) if release_samples > 0 else 1.0
    return a_att, a_rel


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


def fma_f32(x, y, z) -> torch.Tensor:
    """``x·y + z`` of float32 tensors with ONE rounding, as a fused
    multiply-add gives it.  The reference's recurrence ``a·d + (1−a)·g``
    rounds so on XLA's CPU backend (fma(a, d, (1−a)·g)), and kernel K6 uses
    the same fma, so the plain versions need it too.  The product is exact
    in float64; the sum is rounded to odd in float64 (round to nearest,
    then one step toward the exact value when inexact and even, found with
    TwoSum), and round-to-odd in 53 bits followed by round-to-nearest in 24
    is the correctly rounded result (Boldo & Melquiond, 2008)."""
    p = _f32(x).double() * _f32(y).double()  # exact: 24 + 24 bits
    z = _f32(z).double()
    s = p + z
    bp = s - p
    err = (p - (s - bp)) + (z - bp)  # TwoSum: s + err == p + z exactly
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf")).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def moving_rms(x, window_size: int) -> torch.Tensor:
    """sqrt of the boxcar moving average of x², mode='same' (zero-padded),
    by one power-of-two rfft round trip as `afp_tpu/ops/agc.py:52-70` does
    (a cumulative-sum difference would cancel on quiet samples).  `x`:
    [..., T]."""
    x = _f32(x)
    w = int(window_size)
    if w == 1:
        return torch.abs(x)
    T = x.shape[-1]
    nfft = next_pow2(T + w - 1)
    box = torch.full((w,), 1.0 / w, dtype=torch.float32, device=x.device)
    full = torch.fft.irfft(torch.fft.rfft(torch.square(x), n=nfft)
                           * torch.fft.rfft(box, n=nfft), n=nfft)
    start = (w - 1) // 2
    # sqrt in float64, rounded once: the correctly rounded f32 sqrt (torch's
    # f32 sqrt on the CPU is not)
    return torch.sqrt(torch.clamp_min(full[..., start:start + T], 0.0)
                      .double()).float()


def desired_gain(rms, target_level, max_gain) -> torch.Tensor:
    """``clip(target/(rms+1e-10), 0, max_gain)``; `target_level` and
    `max_gain` scalars or per-stream [B] vectors (then `rms` is [B, T])."""
    rms = _f32(rms)
    t = _f32(target_level).to(rms.device)
    m = _f32(max_gain).to(rms.device)
    if t.ndim == 1:
        t = t[:, None]
    if m.ndim == 1:
        m = m[:, None]
    q = t / (rms + 1e-10)
    return torch.minimum(torch.clamp_min(q, 0.0), m)


def link_desired(d, group: int, batch_axis: int = 0) -> torch.Tensor:
    """Link the AGC across groups of `group` adjacent streams: each stream
    takes its group's minimum desired gain, the gain its loudest member's
    RMS asks for (`afp_tpu/ops/agc.py:86-113`).  ``group=1`` is the
    identity."""
    if group == 1:
        return d
    b = d.shape[batch_axis]
    if b % group:
        raise ValueError(f"batch {b} is not a multiple of link group {group}")
    ax = batch_axis % d.ndim
    shape = d.shape[:ax] + (b // group, group) + d.shape[ax + 1:]
    dg = d.reshape(shape).amin(dim=ax + 1, keepdim=True)
    return dg.expand(shape).reshape(d.shape)


def smooth_gain_scan(desired, a_att, a_rel,
                     init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The exact attack/release recurrence.  `desired`: [..., T]; `init`:
    [...] the previous smoothed gain, or None to restart at
    ``desired[..., 0]`` (the reference's per-block behavior)."""
    d_t = _f32(desired).movedim(-1, 0)  # [T, ...]
    if init is None:
        g, seq = d_t[0], d_t[1:]
        gains = [g]
    else:
        g = torch.broadcast_to(_f32(init).to(d_t.device), d_t.shape[1:])
        seq, gains = d_t, []
    a_att, a_rel = _f32(a_att).to(d_t.device), _f32(a_rel).to(d_t.device)
    for d_i in seq:
        alpha = torch.where(d_i > g, a_att, a_rel)
        g = fma_f32(alpha, d_i, (1.0 - alpha) * g)
        gains.append(g)
    if not gains:
        return d_t.movedim(0, -1).clone()
    return torch.stack(gains).movedim(0, -1)


def _solve_linear_recurrence(alpha: torch.Tensor, d_t: torch.Tensor,
                             g0: torch.Tensor) -> torch.Tensor:
    """Solve g[t] = (1−α[t])·g[t−1] + α[t]·d[t] for t = 0..T−1 with
    g[−1] = g0 (`afp_tpu/ops/agc.py:144-162`): an inclusive scan over the
    composition of the affine maps g → A·g + B, in ⌈log₂T⌉ doubling steps
    of whole-tensor ops (each position composes the map 2^k places back
    with its own).  `alpha`, `d_t`: [T, ...]; `g0`: [...].  Returns
    [T, ...]."""
    A = 1.0 - alpha
    B = alpha * d_t
    # fold g0 into element 0 (the constant map g → g[0]), so the inclusive
    # prefix composition is g[t] itself, with no carry-in
    B = torch.cat([B[:1] + A[:1] * torch.broadcast_to(g0, d_t.shape[1:]),
                   B[1:]])
    A = torch.cat([torch.zeros_like(A[:1]), A[1:]])
    k, T = 1, d_t.shape[0]
    while k < T:
        # (a_l, b_l) then (a_r, b_r) composes to (a_l·a_r, b_l·a_r + b_r)
        B = torch.cat([B[:k], B[:-k] * A[k:] + B[k:]])
        A = torch.cat([A[:k], A[:-k] * A[k:]])
        k *= 2
    return B


def smooth_gain_parallel(desired, a_att, a_rel,
                         init: Optional[torch.Tensor] = None,
                         max_iters: int = 24) -> torch.Tensor:
    """The exact attack/release recurrence by branch-consistent fixed-point
    iteration (`afp_tpu/ops/agc.py:165-251`), ``agc_mode='parallel'``.

    Given the branch pattern ``b[t] = desired[t] > g[t−1]`` the recurrence
    is linear, and :func:`_solve_linear_recurrence` solves it in log depth.
    So: guess b (attack wherever the desired gain rises), solve, recompute b
    from the solved gains, and repeat until b is unchanged or `max_iters`
    solves have run.  Each solve extends the correct prefix of decisions,
    so the loop converges to the recurrence; it is the recurrence's
    consistency oracle (−105 dB against :func:`smooth_gain_scan`), not a
    performance mode.  Same signature as :func:`smooth_gain_scan`."""
    return _smooth_gain_parallel(desired, a_att, a_rel, init, max_iters)[0]


def _smooth_gain_parallel(desired, a_att, a_rel, init=None,
                          max_iters: int = 24):
    """:func:`smooth_gain_parallel` with its loop's record: returns
    ``(gains, solves, flipping)``, ``flipping`` the decisions (shaped as
    `desired`) that the last solve still changed, none if it converged."""
    d_t = _f32(desired).movedim(-1, 0)  # [T, ...]
    dev = d_t.device
    if init is None:
        g0, seq = d_t[0], d_t[1:]
    else:
        g0 = torch.broadcast_to(_f32(init).to(dev), d_t.shape[1:])
        seq = d_t
    it = 0
    if seq.shape[0] == 0:
        gains, flips = d_t.clone(), torch.zeros(d_t.shape, dtype=torch.bool,
                                                device=dev)
    else:
        # [B]-vector α broadcast over the time-major [T, B] decisions
        a_att, a_rel = _f32(a_att).to(dev), _f32(a_rel).to(dev)

        def prev(g):
            return torch.cat([g0[None], g[:-1]])

        b = seq > prev(seq)
        while True:
            g = _solve_linear_recurrence(torch.where(b, a_att, a_rel), seq, g0)
            b_new = seq > prev(g)
            it += 1
            flips = b_new != b
            if it >= max_iters or not bool(flips.any()):
                break
            b = b_new
        if init is None:
            gains = torch.cat([g0[None], g])
            flips = torch.cat([torch.zeros_like(flips[:1]), flips])
        else:
            gains = g
    return gains.movedim(0, -1), it, flips.movedim(0, -1)


def _int_pow(x: torch.Tensor, n: int) -> torch.Tensor:
    """x**n by binary exponentiation, the multiplications of
    `jax.lax.integer_pow` (`torch.pow` may round differently)."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def compound_alpha(a, chunk: int) -> torch.Tensor:
    """The per-chunk coefficient ``1 − (1 − a)^chunk`` of the blockwise
    recurrence, in float32 as the JAX package computes it from its f32
    alphas (five squarings for chunk 32, `agc_scan.py:458-459`)."""
    return 1.0 - _int_pow(1.0 - _f32(a), int(chunk))


def smooth_gain_blockwise(desired, a_att, a_rel, chunk: int = 32,
                          init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The 'fast' approximation of :func:`smooth_gain_scan`: the one-pole at
    `chunk` granularity on the chunk means, with ``α_c = 1 − (1−α)^chunk``,
    then a linear ramp within each chunk (`afp_tpu/ops/agc.py:254-290`).
    Python-float alphas compound in float64 and tensor alphas in float32,
    as the reference's do."""
    d = _f32(desired)
    T = d.shape[-1]
    if T % chunk:
        raise ValueError(f"signal length {T} must be a multiple of chunk {chunk}")
    n_chunks = T // chunk
    d_r = d.reshape(d.shape[:-1] + (n_chunks, chunk))
    d_c = d_r[..., 0]
    for q in range(1, chunk):  # summed in order, as XLA's CPU reduce does
        d_c = d_c + d_r[..., q]
    d_c = d_c / chunk

    def compound(a):
        if isinstance(a, (torch.Tensor, np.ndarray)):
            return compound_alpha(a, chunk)
        return 1.0 - (1.0 - a) ** chunk

    g_c = smooth_gain_scan(d_c, compound(a_att), compound(a_rel), init=init)
    first = (g_c[..., :1] if init is None else
             torch.broadcast_to(_f32(init).to(d.device)[..., None],
                                g_c[..., :1].shape))
    g_prev = torch.cat([first, g_c[..., :-1]], dim=-1)
    frac = (torch.arange(chunk, dtype=torch.float32, device=d.device) + 1.0) / chunk
    g = fma_f32((g_c - g_prev)[..., :, None], frac, g_prev[..., :, None])
    return g.reshape(d.shape)


class AGCParams:
    """Static AGC configuration (host side); the α values are precomputed
    so a gain change never rebuilds anything."""

    def __init__(self, target_level: float = 0.1, window_size: int = 512,
                 max_gain: float = 10.0, attack: float = 0.01,
                 release: float = 0.1):
        self.target_level = float(target_level)
        self.window_size = int(window_size)
        self.max_gain = float(max_gain)
        self.attack = float(attack)
        self.release = float(release)
        self.a_att, self.a_rel = agc_alphas(self.window_size, attack, release)

    @classmethod
    def from_config(cls, cfg) -> "AGCParams":
        """The AGC knobs of a `StreamConfig` (its ``agc_*`` fields)."""
        return cls(target_level=cfg.agc_target_level,
                   window_size=cfg.agc_window_size, max_gain=cfg.agc_max_gain,
                   attack=cfg.agc_attack, release=cfg.agc_release)


def apply_agc(x, params: AGCParams, carry: Optional[torch.Tensor] = None):
    """The whole AGC chain on a block: [..., T] → (gained [..., T],
    last gain [...]).  ``carry=None`` restarts every block, as the
    reference does; the returned gain carried into the next call makes the
    stream block-size invariant.  The recurrence runs as K9 on a CUDA
    tensor (the same bits as :func:`smooth_gain_scan`)."""
    from .cuda.agc_scan import smooth_gain_scan as scan  # K9 on the card

    x = _f32(x)
    rms = moving_rms(x, params.window_size)
    d = desired_gain(rms, params.target_level, params.max_gain)
    g = scan(d, params.a_att, params.a_rel, init=carry)
    g = torch.minimum(torch.clamp_min(g, 0.1), _f32(params.max_gain))
    return x * g, g[..., -1]
