"""Typed, validated pipeline configuration — the port's copy of
`afp_tpu/engine/config.py` (same fields, `validate()` and `static_key()`;
`tests/test_torch_pipeline.py` holds the two to each other).  The port
imports nothing of `afp_tpu`, whose `engine/__init__.py` pulls in jax.

Original notes (SURVEY.md §5.6):

Carries the reference's three config generations forward into one dataclass:
module constants (`stream_process.py:19-30`), the GUI's
`applied_config` (`stream_process_EQ_GUI.py:182-195`), and the validated
Presets generation (`stream_process_GUI_Presets.py:358-398`) whose clamping
rules are enforced by :func:`StreamConfig.validate`:

* blocksize → next power of two, clamped to [256, 8192],
* numtaps clamped to [16, 2048],
* samplerate clamped to [8000, 192000],
* upsample factor clamped to [1, 4],
* cutoffs clamped to [20, samplerate/2].

Fields are split into **static** (shape-affecting → jit recompile when
changed: blocksize, upsample_factor, numtaps, batch, AGC window) and
**dynamic** (runtime arrays → glitch-free live update: EQ gains, kernels,
AGC target/alphas).  `derive_params()` builds the dynamic parameter bank.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..design import create_fir_filter

__all__ = ["EQBand", "StreamConfig", "DEFAULT_EQ_BANDS", "PipelineParams"]

#: The reference GUI's 9-band EQ table (`stream_process_EQ_GUI.py:161-171`).
DEFAULT_EQ_BANDS: Tuple[Tuple[str, Tuple[float, float]], ...] = (
    ("Low Bass", (20.0, 60.0)),
    ("Mid Bass", (60.0, 120.0)),
    ("High Bass", (120.0, 250.0)),
    ("Low Midrange", (250.0, 500.0)),
    ("Middle Midrange", (500.0, 1000.0)),
    ("High Midrange", (1000.0, 2000.0)),
    ("Low Treble", (2000.0, 4000.0)),
    ("Middle Treble", (4000.0, 8000.0)),
    ("High Treble", (8000.0, 16000.0)),
)


@dataclass(frozen=True)
class EQBand:
    name: str
    low: float
    high: float
    gain: float = 1.0


def _pow2_clamp(n: int, lo: int, hi: int) -> int:
    n = max(lo, min(hi, int(n)))
    return 1 << (n - 1).bit_length()


@dataclass(frozen=True)
class StreamConfig:
    """Full pipeline configuration.

    Defaults follow the GUI generation (`stream_process_EQ_GUI.py:182-191`):
    44.1 kHz, 2× upsample, block 2048, 129-tap hamming lowpass at 14 kHz.
    """

    # --- static (shape-affecting) ---
    samplerate: int = 44100
    blocksize: int = 2048
    upsample_factor: int = 2
    numtaps: int = 129
    batch: int = 1  # concurrent streams (the TPU scaling axis)
    agc_window_size: int = 512

    # --- design / dynamic ---
    filter_type: str = "lowpass"
    cutoff: float | Tuple[float, float] = 14000.0
    window_type: str = "hamming"
    design_method: str = "window"  # 'window' | 'remez'
    min_phase: bool = False
    eq_bands: Tuple[EQBand, ...] = tuple(
        EQBand(name, lo, hi) for name, (lo, hi) in DEFAULT_EQ_BANDS
    )
    eq_enabled: bool = True

    # AGC (`stream_process_AGC.py:132-144`)
    agc_enabled: bool = False
    agc_target_level: float = 0.1
    agc_max_gain: float = 10.0
    agc_attack: float = 0.01
    agc_release: float = 0.1
    # 'exact'    = per-sample recurrence (reference semantics): the Pallas
    #              hardware-loop kernel on TPU (measured 28k× RT at the C8
    #              point — as fast as 'fast'), lax.scan elsewhere;
    # 'parallel' = branch-consistent associative-scan solver (≡ exact once
    #              its fixed-point iteration converges — guaranteed within
    #              T iterations, capped at 24; see smooth_gain_parallel —
    #              for very long T / non-TPU backends);
    # 'fast'     = chunked one-pole + interpolation (approximate)
    agc_mode: str = "exact"
    # carry the smoothed gain across blocks (block-size-invariant stream).
    # False reproduces the reference's per-block restart at desired[0]
    # (`stream_process_AGC.py:66-67`) exactly.
    agc_carry: bool = True
    # link the AGC across groups of this many ADJACENT batch rows (e.g. the
    # channels of one stereo/multichannel stream): every row in a group gets
    # the gain its LOUDEST member's RMS demands (group-min of the desired
    # gain — `ops.agc.link_desired`), so inter-channel balance (the stereo
    # image) never moves.  1 = independent per-row gains (the reference is
    # mono, `stream_process_AGC.py:22` analog, and never faced the linked
    # case).  `batch` must be a multiple of the group.  Static (changes the
    # traced graph); a deployment-layout property, excluded from presets.
    agc_link_group: int = 1

    # ASRC (`stream_process_AGC.py:126-129`)
    source_samplerate: Optional[int] = None
    # 'exact'  = host AsrcFrontend regroups source pushes through a streaming
    #            polyphase resampler — block-exact for EVERY (rate, block)
    #            pair (supersedes the reference);
    # 'compat' = the reference's behavior: device-side streaming resampler
    #            when the block divides the reduced ratio, else stateless
    #            per-block conversion with pad/trim (block-edge artifacts,
    #            `stream_process_AGC.py:126-129`)
    asrc_mode: str = "exact"

    # Resampler quality tier ('fast' | 'hq' | 'vhq' — see
    # afp_tpu.ops.resample.QUALITY_TIERS): selects the published
    # anti-image/anti-alias kernel family for the up/down/ASRC stages,
    # mirroring the reference's soxr tiers (VHQ in the baseline hot path
    # `stream_process.py:69-74`, HQ in the GUI path
    # `stream_process_EQ_GUI.py:424`).  Static: the kernel length is
    # shape-affecting (resampler history, fused-cascade length).
    # Default 'hq' (−124 dB anti-imaging, matching the reference GUI
    # generation this config's other defaults follow): a default-config
    # user must sit inside the framework's −90 dB contract — 'fast'
    # (−54 dB, the scipy resample_poly recipe) is an explicit opt-in for
    # oracle compatibility, never the shipped default (VERDICT r3 weak #1).
    # Under conv_strategy='td_mxu' the longer tiers are nearly FREE: the
    # fused cascade grows but the banded-dot K extent rounds to the same
    # lane tile at the headline shapes (see docs/BENCHMARKS.md roofline).
    resample_quality: str = "hq"

    # output stage
    # 'base' returns blocksize samples at `samplerate` (the reference's duplex
    # contract); 'upsampled' returns blocksize·upf samples at the upsampled
    # rate (drive a high-rate DAC directly — skips the downsample stage and
    # the single-rate fusion)
    output_rate: str = "base"
    downsample_mode: str = "resample"  # 'resample' (soxr path) | 'decimate' (C5)
    dither_kind: str = "tpdf"  # 'tpdf' | 'rpdf' (reference math) | 'off'
    dither_bits: int = 24
    output_clip: Optional[float] = 0.99  # AGC engine clips ±0.99; None = off

    # TPU fast path: because the engine's output returns to the base rate,
    # the linear chain upsample→EQ→FIR→downsample collapses algebraically to
    # ONE single-rate FIR whose kernel is the phase-0 polyphase component of
    # the full cascade (identical output, ~upf× less compute, still linear in
    # the EQ gains).  Disable to run the literal multirate chain.
    fuse_rate_conversion: bool = True

    # Capture the output spectrum ring inside the device scan (depth-50
    # waterfall as part of the carried state — no host contact per block;
    # costs [batch, 50, L/2+1] HBM, so meant for monitoring-scale batches)
    waterfall_enabled: bool = False

    # Execution strategy for the fused convolution:
    #   'fft'    — overlap-save rfft/irfft (VPU/FFT units),
    #   'td_mxu' — Pallas banded-Toeplitz matmul on the MXU
    #              (wins for short cascade kernels).
    conv_strategy: str = "fft"

    # Input format at the Pipeline boundary:
    #   'f32'  — each block is a [B, L] float32 array (the reference's
    #            contract; default),
    #   'pair' — each block is the bf16 (hi, lo) pair of the float32 block
    #            (`ops.pallas.fir_td.split_bf16` semantics).  When the
    #            td_mxu strategy runs a bf16-class precision mode and no
    #            AGC/ASRC stage precedes the conv, the pair feeds the
    #            pair-input conv kernel directly — the on-device input
    #            staging pass (34% of headline device time, BENCHMARKS.md)
    #            disappears; the split happens wherever ingest lives (host
    #            CPU during DMA staging, or an upstream producer kernel),
    #   'pcm16' — each block is a [B, L] int16 array in the PCM full-scale
    #            convention (sample n ≡ n/32768, the format of WAV PCM and
    #            sound-card DMA).  The conv kernels convert on the VPU and
    #            split the bf16 pair in VMEM — EXACT for 16-bit data
    #            (fir_td.py:_load_f32), so outputs are bit-identical to
    #            feeding the n/32768 floats through 'pair' (and the f32
    #            conv ring; vs the unpadded staged 'f32' step the usual
    #            ≤ −110 dB strategy class applies), while input HBM
    #            traffic and host→device ingest bytes HALVE.
    #            Constraints: td_mxu, no ASRC, base-rate output.  AGC IS
    #            supported (unlike 'pair'): the AGC kernels read the raw
    #            int16 x and convert in VMEM — the C8 chain's two f32
    #            x-reads halve too — and the conv consumes the
    #            gain-applied bf16 pair as usual (the overlap tail then
    #            stays a pair, not int16).
    ingest: str = "f32"

    # Output format at the Pipeline boundary:
    #   'f32'   — [B, L] float32 blocks (the reference's contract; default),
    #   'pcm16' — [B, L] raw int16 PCM (n ≡ n/32768, the sound-card /
    #             16-bit-WAV transport format).  This is the DITHER'S
    #             ACTUAL TARGET: the reference dithers precisely so the
    #             card's 16-bit requantization decorrelates
    #             (`stream_process.py:83-90`); emit='pcm16' makes that
    #             quantization explicit and on-device —
    #             ``int16(clip(round(y·32768), ±fs))`` fused into the conv
    #             kernel's store on the td_mxu serving paths
    #             (`fir_td._finish_tile`), an XLA epilogue elsewhere.
    #             Output HBM bytes and the device→host drain HALVE.
    #             validate() clamps dither_bits to ≤16 when dither is on
    #             (deeper dither is inaudible under a 16-bit quantizer and
    #             would under-dither it).
    emit: str = "f32"

    @property
    def upsampled_rate(self) -> int:
        return self.samplerate * self.upsample_factor

    @property
    def upsampled_block(self) -> int:
        return self.blocksize * self.upsample_factor

    def validate(self) -> "StreamConfig":
        """Clamp to the Presets-generation valid ranges
        (`stream_process_GUI_Presets.py:358-398`). Returns a new config."""
        samplerate = max(8000, min(192000, int(self.samplerate)))
        blocksize = _pow2_clamp(self.blocksize, 256, 8192)
        upf = max(1, min(4, int(self.upsample_factor)))
        numtaps = max(16, min(2048, int(self.numtaps)))
        if numtaps % 2 == 0 and self.filter_type in ("highpass", "bandstop"):
            # type-II FIRs have a structural Nyquist zero — the design layer
            # rejects them (firwin.py); clamp to the next odd length instead
            # of failing the never-raise engine build
            numtaps += 1
        nyq = samplerate / 2
        if self.filter_type in ("bandpass", "bandstop"):
            c = self.cutoff if isinstance(self.cutoff, (tuple, list)) else (500.0, 15000.0)
            cutoff = (
                max(20.0, min(float(c[0]), nyq)),
                max(20.0, min(float(c[1]), nyq)),
            )
        else:
            c = self.cutoff if not isinstance(self.cutoff, (tuple, list)) else self.cutoff[0]
            # highpass clamps STRICTLY inside Nyquist: at upsample_factor 1
            # the design rate equals the engine rate, and a highpass AT
            # Nyquist is the identically-zero kernel (its normalization
            # returned silent NaNs — r5 fuzz find; firwin now rejects it,
            # and this clamp keeps the engine's never-raise contract)
            hi = 0.999 * nyq if self.filter_type == "highpass" else nyq
            cutoff = max(20.0, min(float(c), hi))
        if self.filter_type not in ("lowpass", "highpass", "bandpass", "bandstop"):
            raise ValueError(f"invalid filter_type {self.filter_type!r}")
        if self.design_method not in ("window", "remez"):
            raise ValueError(f"invalid design_method {self.design_method!r}")
        if self.downsample_mode not in ("resample", "decimate"):
            raise ValueError(f"invalid downsample_mode {self.downsample_mode!r}")
        if self.dither_kind not in ("tpdf", "rpdf", "off"):
            raise ValueError(f"invalid dither_kind {self.dither_kind!r}")
        if self.agc_mode not in ("exact", "parallel", "fast"):
            raise ValueError(f"invalid agc_mode {self.agc_mode!r}")
        if self.asrc_mode not in ("exact", "compat"):
            raise ValueError(f"invalid asrc_mode {self.asrc_mode!r}")
        if self.resample_quality not in ("fast", "hq", "vhq"):
            raise ValueError(
                f"invalid resample_quality {self.resample_quality!r}")
        if self.output_rate not in ("base", "upsampled"):
            raise ValueError(f"invalid output_rate {self.output_rate!r}")
        if self.conv_strategy not in ("fft", "td_mxu"):
            raise ValueError(f"invalid conv_strategy {self.conv_strategy!r}")
        if self.conv_strategy == "td_mxu" and not self.fuse_rate_conversion:
            raise ValueError("conv_strategy='td_mxu' requires fuse_rate_conversion")
        if self.ingest not in ("f32", "pair", "pcm16"):
            raise ValueError(f"invalid ingest {self.ingest!r}")
        if self.emit not in ("f32", "pcm16"):
            raise ValueError(f"invalid emit {self.emit!r}")
        dither_bits = int(self.dither_bits)
        if self.emit == "pcm16" and self.dither_kind != "off":
            # dither must sit at (or above) the output quantizer's LSB to
            # decorrelate it; 24-bit-deep dither under a 16-bit quantizer
            # leaves the truncation error correlated (under-dithered)
            dither_bits = min(dither_bits, 16)
        if self.ingest in ("pair", "pcm16"):
            if self.conv_strategy != "td_mxu":
                raise ValueError(
                    f"ingest={self.ingest!r} requires conv_strategy='td_mxu'")
            if self.ingest == "pair" and self.agc_enabled:
                # pcm16 + AGC is supported (the AGC kernels convert the raw
                # int16 x in VMEM — exact); a bf16 PAIR cannot feed the AGC
                # (it would need an on-device merge, re-adding the staging
                # pass pair ingest exists to remove)
                raise ValueError(
                    "ingest='pair' requires agc disabled (the AGC stage "
                    "consumes the f32 block before the conv; use "
                    "ingest='pcm16' or 'f32' with AGC)")
            if self.source_samplerate:
                raise ValueError(
                    f"ingest={self.ingest!r} requires asrc disabled (the "
                    "resampler consumes the f32 block before the chain)")
            if self.output_rate == "upsampled":
                raise ValueError(
                    f"ingest={self.ingest!r} requires output_rate='base' "
                    "(upsampled output disables the fused td_mxu path)")
        agc_window = max(1, min(int(self.agc_window_size), blocksize // 2))
        link = max(1, int(self.agc_link_group))
        batch = max(1, int(self.batch))
        if self.agc_enabled and batch % link:
            raise ValueError(
                f"batch {batch} must be a multiple of agc_link_group {link} "
                "(groups are adjacent batch rows, e.g. one file's channels; "
                "under ShardedPipeline the PER-SHARD batch must divide)")
        return dataclasses.replace(
            self,
            samplerate=samplerate,
            blocksize=blocksize,
            upsample_factor=upf,
            numtaps=numtaps,
            cutoff=cutoff,
            agc_window_size=agc_window,
            batch=batch,
            agc_link_group=link,
            dither_bits=dither_bits,
        )

    # --- static/dynamic split: the jit cache key ---
    def static_key(self) -> tuple:
        """Everything that forces a recompile when changed."""
        return (
            self.blocksize,
            self.upsample_factor,
            self.numtaps,
            self.batch,
            self.agc_window_size,
            self.min_phase,
            len(self.eq_bands),
            self.eq_enabled,
            self.agc_enabled,
            self.source_samplerate,
            self.samplerate if self.source_samplerate else None,
            self.asrc_mode if self.source_samplerate else None,
            self.downsample_mode,
            self.dither_kind,
            self.output_clip is not None,
            self.fuse_rate_conversion,
            self.conv_strategy,
            self.waterfall_enabled,
            self.agc_mode,
            self.agc_carry,
            self.agc_link_group,
            self.output_rate,
            self.ingest,
            self.emit,
            self.resample_quality,
        )

    # --- (de)serialization for presets/checkpoints ---
    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["eq_bands"] = [dataclasses.asdict(b) for b in self.eq_bands]
        d["cutoff"] = list(self.cutoff) if isinstance(self.cutoff, tuple) else self.cutoff
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "StreamConfig":
        d = dict(d)
        d["eq_bands"] = tuple(EQBand(**b) for b in d.get("eq_bands", ()))
        if isinstance(d.get("cutoff"), list):
            d["cutoff"] = tuple(d["cutoff"])
        return cls(**d)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "StreamConfig":
        return cls.from_dict(json.loads(s))


@dataclass
class PipelineParams:
    """Dynamic (runtime-array) parameter bank derived from a StreamConfig.

    Kernel coefficient changes and gain changes swap these arrays without
    recompiling — the TPU expression of the reference's double-buffered
    `filter_lock` swap (`stream_process_EQ_GUI.py:50-55, 380-385`).
    """

    main_taps: np.ndarray  # [numtaps'] main FIR (post-min-phase length)
    eq_taps: np.ndarray  # [n_bands, numtaps'] band kernels
    eq_gains: np.ndarray  # [n_bands]

    @classmethod
    def design(cls, cfg: StreamConfig) -> "PipelineParams":
        """Cold-path filter design, mirroring `update_fir_filter` +
        `precompute_eq_filters` (`stream_process_EQ_GUI.py:204-221, 364-388`)."""
        fs = cfg.upsampled_rate
        main = create_fir_filter(
            method=cfg.design_method,
            cutoff=cfg.cutoff,
            numtaps=cfg.numtaps,
            window_type=cfg.window_type,
            filter_type=cfg.filter_type,
            samplerate=fs,
        )
        # NOTE: the reference gates min-phase on exact symmetry
        # (`stream_process_EQ_GUI.py:377-379`), but its own periodic
        # (fftbins) windows leave every design ~1e-4 asymmetric, so that gate
        # NEVER fires — the GUI's min-phase toggle is dead code there.  Here
        # `min_phase=True` is explicit intent: convert directly (hilbert
        # method + peak normalization, the `update_fir_filter` recipe).
        if cfg.min_phase:
            from ..design.minphase import minimum_phase, normalize_peak

            main = normalize_peak(minimum_phase(main, method="hilbert"), fs)
        eq_list = []
        for band in cfg.eq_bands:
            coeffs = create_fir_filter(
                method="window",
                cutoff=(band.low, band.high),
                numtaps=cfg.numtaps,
                window_type="hamming",  # reference pins hamming for EQ bands
                filter_type="bandpass",
                samplerate=fs,
            )
            if cfg.min_phase:
                # EQ bands: min-phase without re-normalization
                # (`precompute_eq_filters`, `:217-218`)
                from ..design.minphase import minimum_phase

                coeffs = minimum_phase(coeffs, method="hilbert")
            eq_list.append(coeffs)
        eq = np.stack(eq_list) if eq_list else np.zeros((0, len(main)))
        gains = np.array([b.gain for b in cfg.eq_bands], dtype=np.float32)
        return cls(
            main_taps=np.asarray(main, dtype=np.float32),
            eq_taps=np.asarray(eq, dtype=np.float32),
            eq_gains=gains,
        )
