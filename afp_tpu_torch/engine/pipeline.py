"""The fused streaming pipeline in PyTorch (counterpart of
`afp_tpu/engine/pipeline.py`).

The reference chain upsample → EQ + main FIR → downsample → clip → dither
runs as ONE base-rate FIR per block: `device_params` convolves
upsampler ⊛ (band ⊛) main (⊛ downsampler) in float64 on the host and keeps
the phase-0 polyphase component (the "fused single-rate" path of
`afp_tpu`).  Per block, the 'td_mxu' strategy runs that FIR as the bf16×3
conv kernel K1 with clip and dither fused into its store; the 'fft'
strategy runs overlap-save with `torch.fft`, then the clip, then the
dither kernel K2.  The serving forms `ring_step`/`run_ring` (K3) and
`run_ring_mega` (K4) read and write device-resident rings in place.

PyTorch idiom where the reference used JAX's: the device is explicit
(``Pipeline(cfg, device)``), functions run eagerly on tensors, and the
dither is counter-based Philox keyed by the state's ``(seed, step)`` rather
than a threefry key split per block.  The carried conv tail is always
k_pad = n_casc−1 rounded up to 128 wide (the ring kernels' width); the
extra leading history meets only zero taps, so it is inert
(`afp_tpu/engine/pipeline.py:1327-1330`).

Not in this slice: each raises NotImplementedError naming its ROADMAP.md §1
item (`_check_slice`).  Nothing falls back to another path.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.convolve import next_pow2
from ..ops.cuda.dither import dither_cuda
from ..ops.cuda.fir_td import (fir_td_mxu, fir_td_mxu_ring_f32,
                               fir_td_mxu_ring_mega_f32, ring_k_pad)
from ..ops.resample import streaming_kernel
from .config import PipelineParams, StreamConfig

__all__ = ["DeviceParams", "StreamState", "Pipeline"]


def _not_in_slice(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md §1 item {item}")


def _check_slice(cfg: StreamConfig) -> None:
    """Reject every configuration outside the ported f32 fused chain."""
    if cfg.agc_enabled:
        raise _not_in_slice("agc_enabled", "6 (AGC)")
    if cfg.ingest != "f32" or cfg.emit != "f32":
        raise _not_in_slice(f"ingest={cfg.ingest!r}/emit={cfg.emit!r}",
                            "8 (transport forms)")
    if cfg.waterfall_enabled:
        raise _not_in_slice("waterfall_enabled", "10 (remaining ops)")
    if cfg.source_samplerate and cfg.source_samplerate != cfg.samplerate:
        raise _not_in_slice("source_samplerate (ASRC)",
                            "5 (StreamEngine: host ASRC frontend)")
    if not cfg.fuse_rate_conversion or (
            cfg.output_rate == "upsampled" and cfg.upsample_factor > 1):
        raise _not_in_slice(
            "the literal multirate chain (fuse_rate_conversion=False or "
            "output_rate='upsampled')", "10 (remaining ops)")


class DeviceParams(NamedTuple):
    """Runtime parameter bank on the device.  Swapping it between blocks is
    the reference's glitch-free `filter_lock` swap: same shapes, no rebuild.
    """

    H_bands: torch.Tensor  # [n_bands, F] complex64 per-band cascade spectra
    H_main: torch.Tensor  # [F] complex64 no-EQ cascade spectrum
    eq_gains: torch.Tensor  # [n_bands] float32
    casc_bands: Optional[torch.Tensor] = None  # [n_bands, n_casc] ('td_mxu')
    casc_main: Optional[torch.Tensor] = None  # [n_casc] ('td_mxu')

    def _shared_gains(self) -> torch.Tensor:
        if self.eq_gains.ndim != 1:
            raise _not_in_slice("per-stream EQ gains (2-D eq_gains)",
                                "7 (per-stream banks)")
        return self.eq_gains

    def combined_response(self, eq_enabled: bool) -> torch.Tensor:
        """The live fused response [F]: the gain-combined per-band cascade
        spectra, or the no-EQ cascade.  A 9-term sum written out, so no
        matmul precision mode (TF32) can touch it."""
        if eq_enabled and self.H_bands.shape[0] > 0:
            g = self._shared_gains().to(self.H_bands.dtype)
            return (g[:, None] * self.H_bands).sum(0)
        return self.H_main

    def combined_cascade(self, eq_enabled: bool) -> torch.Tensor:
        """The live fused taps [n_casc] ('td_mxu'): the gain combination is
        linear in the taps, as in frequency."""
        if eq_enabled and self.casc_bands is not None and self.casc_bands.shape[0] > 0:
            return (self._shared_gains()[:, None] * self.casc_bands).sum(0)
        return self.casc_main


class StreamState(NamedTuple):
    """Carried streaming state: the conv tail on the device, and the dither
    key on the host — ``seed`` and ``step``, the count of blocks processed
    (block i dithers under Philox key ``(seed, step_i)``)."""

    conv_tail: torch.Tensor  # [B, k_pad] float32 input history
    seed: int
    step: int


class Pipeline:
    """Streaming pipeline for a fixed StreamConfig on one device.

    Usage::

        pipe = Pipeline(cfg, "cuda")
        params = pipe.device_params(PipelineParams.design(pipe.cfg))
        state = pipe.init_state(seed=0)
        state, out = pipe.step(params, state, block)      # [B, L] → [B, L]
        state, outs = pipe.run(params, state, blocks)     # [N, B, L]
    """

    def __init__(self, cfg: StreamConfig, device):
        cfg = cfg.validate()
        _check_slice(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        self.batch = cfg.batch
        self.block = cfg.blocksize
        self.upf = cfg.upsample_factor
        n_design = cfg.numtaps // 2 + cfg.numtaps % 2 if cfg.min_phase else cfg.numtaps
        self.n_kernel = n_design
        self.has_eq = cfg.eq_enabled and len(cfg.eq_bands) > 0
        self.n_fused = 2 * n_design - 1 if self.has_eq else n_design
        # upsample(U) → filter → downsample(U) at base-rate output is
        # y[n] = Σ_p cascade[U·(n−p)]·x[p]: one base-rate FIR whose taps
        # are the phase-0 polyphase component of the whole cascade
        if self.upf > 1:
            self._h_up_np = streaming_kernel(self.upf, 1,
                                             quality=cfg.resample_quality)
            self._h_down_np = (
                streaming_kernel(1, self.upf, quality=cfg.resample_quality)
                if cfg.downsample_mode == "resample" else None)
        else:
            self._h_up_np = np.ones(1)
            self._h_down_np = None
        n_total = len(self._h_up_np) + self.n_fused - 1
        if self._h_down_np is not None:
            n_total += len(self._h_down_np) - 1
        self.n_casc = -(-n_total // self.upf)  # ceil: decimated length
        self.nfft = next_pow2(self.block + self.n_casc - 1)
        self._use_td = cfg.conv_strategy == "td_mxu"
        self._k_pad = ring_k_pad(self.n_casc)

    # ---------------- reconfiguration and parameters ----------------

    def refresh_dynamic(self, cfg: StreamConfig) -> None:
        """Absorb a dynamic-only config change (same `static_key()`)."""
        if cfg.static_key() != self.cfg.static_key():
            raise ValueError("refresh_dynamic requires an identical static_key")
        self.cfg = cfg

    def _cascade(self, main64: np.ndarray, band: np.ndarray | None) -> np.ndarray:
        """float64 fused taps [n_casc]: upsampler ⊛ main (⊛ band)
        (⊛ downsampler), phase-0 polyphase component."""
        k = np.convolve(self._h_up_np, main64)
        if band is not None:
            k = np.convolve(k, band)
        if self._h_down_np is not None:
            k = np.convolve(k, self._h_down_np)
        k = k[:: self.upf]
        out = np.zeros(self.n_casc)
        out[: len(k)] = k
        return out

    def device_params(self, p: PipelineParams,
                      cfg: StreamConfig | None = None) -> DeviceParams:
        """Upload a designed parameter bank: per-band and no-EQ cascades,
        as taps ('td_mxu') and as spectra at the static FFT length.  `cfg`
        overrides the pipeline's dynamic fields, so a reconfiguration can
        build the new bank before it swaps it in."""
        cfg = cfg if cfg is not None else self.cfg
        dev = self.device
        n_b = p.eq_taps.shape[0] if (cfg.eq_enabled and len(cfg.eq_bands)) else 0
        main64 = np.asarray(p.main_taps, dtype=np.float64)

        def f32(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)

        bands = (np.stack([self._cascade(main64, np.asarray(b, np.float64))
                           for b in p.eq_taps]) if n_b
                 else np.zeros((0, self.n_casc)))
        casc = self._cascade(main64, None)
        gains = np.asarray(p.eq_gains, dtype=np.float32) if n_b else np.zeros(0)
        F = self.nfft // 2 + 1
        return DeviceParams(
            H_bands=(torch.fft.rfft(f32(bands), n=self.nfft, dim=-1) if n_b
                     else torch.zeros((0, F), dtype=torch.complex64, device=dev)),
            H_main=torch.fft.rfft(f32(casc), n=self.nfft),
            eq_gains=f32(gains),
            casc_bands=f32(bands) if self._use_td else None,
            casc_main=f32(casc) if self._use_td else None,
        )

    def params_from_numpy(self, arrays: dict) -> DeviceParams:
        """A parameter bank from `afp_tpu`'s ``DeviceParams`` fields as numpy
        arrays (``{name: np.asarray(field)}``).  AGC scalars and the
        per-stream ``casc_wide`` are not used by this slice and are ignored;
        per-stream filter banks raise."""
        if arrays.get("casc_bank") is not None:
            raise _not_in_slice("per-stream filter banks (casc_bank)",
                                "7 (per-stream banks)")
        dev = self.device

        def to(name, dtype):
            a = arrays.get(name)
            return None if a is None else torch.as_tensor(
                np.array(a), dtype=dtype, device=dev)

        return DeviceParams(
            H_bands=to("H_bands", torch.complex64),
            H_main=to("H_main", torch.complex64),
            eq_gains=to("eq_gains", torch.float32),
            casc_bands=to("casc_bands", torch.float32),
            casc_main=to("casc_main", torch.float32),
        )

    # ---------------- state ----------------

    def init_state(self, seed: int = 0) -> StreamState:
        return StreamState(
            conv_tail=torch.zeros((self.batch, self._k_pad),
                                  dtype=torch.float32, device=self.device),
            seed=int(seed), step=0)

    def state_from_numpy(self, conv_tail, seed: int, step: int) -> StreamState:
        """A state from `afp_tpu`'s carried conv tail (numpy, [B, ≤ k_pad]),
        zero-padded on the left to k_pad; `seed`/`step` key the dither."""
        t = torch.as_tensor(np.array(conv_tail, dtype=np.float32),
                            device=self.device)
        pad = self._k_pad - t.shape[-1]
        if t.shape != (self.batch, t.shape[-1]) or pad < 0:
            raise ValueError(f"conv_tail must be [{self.batch}, <= "
                             f"{self._k_pad}], got {tuple(t.shape)}")
        return StreamState(torch.nn.functional.pad(t, (pad, 0)), int(seed),
                           int(step))

    # ---------------- the staged step ----------------

    def _dither_kw(self, state: StreamState, out_clip) -> dict:
        cfg = self.cfg
        on = cfg.dither_kind != "off"
        return dict(out_clip=out_clip, dither_key=(state.seed, state.step),
                    dither_bits=cfg.dither_bits if on else None,
                    dither_tpdf=cfg.dither_kind == "tpdf")

    def _block(self, block) -> torch.Tensor:
        x = torch.as_tensor(block, dtype=torch.float32, device=self.device)
        if x.shape != (self.batch, self.block):
            raise ValueError(f"block must be [{self.batch}, {self.block}], "
                             f"got {tuple(x.shape)}")
        return x

    def step(self, params: DeviceParams, state: StreamState, block):
        """One block: [B, L] → (state, [B, L] out).  The state passed in is
        left intact (the engine's degradation ladder keeps it to recover
        from a failed step)."""
        cfg = self.cfg
        x = self._block(block)
        kp, n, L = self._k_pad, self.n_casc, self.block
        tail = state.conv_tail
        # the conv needs n−1 history columns; the carried tail is k_pad wide
        ext = torch.cat([tail[:, kp - (n - 1):], x], dim=-1)
        if self._use_td:
            y = fir_td_mxu(ext, params.combined_cascade(self.has_eq),
                           **self._dither_kw(state, cfg.output_clip))
        else:
            H = params.combined_response(self.has_eq)
            Y = torch.fft.rfft(ext, n=self.nfft) * H
            y = torch.fft.irfft(Y, n=self.nfft)[:, n - 1: n - 1 + L]
            if cfg.output_clip is not None:
                y = torch.clamp(y, -cfg.output_clip, cfg.output_clip)
            y = dither_cuda(y.contiguous(), (state.seed, state.step),
                            cfg.dither_bits, cfg.dither_kind)
        new_tail = (x[:, L - kp:].clone() if kp <= L
                    else torch.cat([tail[:, L:], x], dim=-1))
        return StreamState(new_tail, state.seed, state.step + 1), y

    def run(self, params: DeviceParams, state: StreamState, blocks):
        """Step over [N, B, L] blocks → (state, [N, B, L])."""
        blocks = torch.as_tensor(blocks, dtype=torch.float32, device=self.device)
        outs = []
        for blk in blocks:
            state, y = self.step(params, state, blk)
            outs.append(y)
        if not outs:
            return state, torch.zeros((0, self.batch, self.block),
                                      device=self.device)
        return state, torch.stack(outs)

    def process_signal(self, params: DeviceParams, state: StreamState,
                       signal, fold="auto"):
        """Whole-signal convenience: [B, T] → (state, [B, T'']), T'' the
        whole blocks of T.  ``fold=False`` and ``'auto'`` stream block by
        block; the offline fold ('prefer'/True) is ROADMAP §1 item 9 ('auto'
        may always decline to fold, `afp_tpu/engine/pipeline.py:1507-1514`).
        """
        if fold in (True, "prefer"):
            raise _not_in_slice(f"fold={fold!r} (the offline fold)",
                                "9 (offline fold)")
        if fold not in (False, "auto"):
            raise ValueError(
                f"fold must be 'auto', 'prefer', True, or False; got {fold!r}")
        signal = torch.as_tensor(signal, dtype=torch.float32, device=self.device)
        B, T = signal.shape
        L = self.block
        nb = T // L
        blocks = signal[:, : nb * L].reshape(B, nb, L).transpose(0, 1)
        state, outs = self.run(params, state, blocks)
        return state, outs.transpose(0, 1).reshape(B, nb * L)

    # ---------------- serving rings ----------------

    @property
    def supports_ring_step(self) -> bool:
        """True when the ring forms are available: the f32 conv ring, which
        needs the 'td_mxu' strategy (the other ring forms of `afp_tpu` are
        outside this slice and rejected at construction)."""
        return self._use_td

    def _ring_taps(self, params: DeviceParams, ring_lo) -> torch.Tensor:
        if ring_lo is not None:
            raise _not_in_slice("bf16 (hi, lo) pair rings (ingest='pair')",
                                "8 (transport forms)")
        if not self.supports_ring_step:
            raise ValueError(
                "ring_step requires the f32 conv ring: conv_strategy="
                "'td_mxu' (see supports_ring_step)")
        return params.combined_cascade(self.has_eq)

    def ring_step(self, params: DeviceParams, state: StreamState,
                  ring_hi: torch.Tensor, ring_lo, idx: int,
                  out_ring: torch.Tensor):
        """One serving step (K3): convolve slot `idx` of the f32 input ring
        ``ring_hi`` [S, B, L] into slot `idx` of `out_ring`, written in
        place.  ``ring_lo`` must be None (the pair form is not ported)."""
        h = self._ring_taps(params, ring_lo)
        out_ring, tail = fir_td_mxu_ring_f32(
            ring_hi, idx, state.conv_tail, h, out_ring,
            **self._dither_kw(state, self.cfg.output_clip))
        return StreamState(tail, state.seed, state.step + 1), out_ring

    def run_ring(self, params: DeviceParams, state: StreamState,
                 ring_hi: torch.Tensor, ring_lo, out_ring: torch.Tensor,
                 n_steps: int, start: int = 0):
        """`n_steps` ring steps over slots ``(start+i) mod S`` (one K3 launch
        each); `out_ring` is written in place."""
        S = ring_hi.shape[0]
        for i in range(int(n_steps)):
            state, out_ring = self.ring_step(params, state, ring_hi, ring_lo,
                                             (start + i) % S, out_ring)
        return state, out_ring

    def run_ring_mega(self, params: DeviceParams, state: StreamState,
                      ring_hi: torch.Tensor, ring_lo, out_ring: torch.Tensor,
                      n_steps: int, start: int = 0):
        """:meth:`run_ring` as ONE kernel launch (K4): same slots, outputs,
        tail and dither as the chained steps."""
        h = self._ring_taps(params, ring_lo)
        out_ring, tail = fir_td_mxu_ring_mega_f32(
            ring_hi, start, state.conv_tail, h, out_ring, n_steps,
            **self._dither_kw(state, self.cfg.output_clip))
        return StreamState(tail, state.seed, state.step + int(n_steps)), out_ring
