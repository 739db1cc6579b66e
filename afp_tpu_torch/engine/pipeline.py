"""The fused streaming pipeline in PyTorch (counterpart of
`afp_tpu/engine/pipeline.py`).

The reference chain AGC → upsample → EQ + main FIR → downsample → clip →
dither runs as ONE base-rate FIR per block: `device_params` convolves
upsampler ⊛ (band ⊛) main (⊛ downsampler) in float64 on the host and keeps
the phase-0 polyphase component (the "fused single-rate" path of
`afp_tpu`).  Per block, the 'td_mxu' strategy runs that FIR as the bf16×3
conv kernel K1 with clip and dither fused into its store; the 'fft'
strategy runs overlap-save with `torch.fft`, then the clip, then the
dither kernel K2.  The serving forms `ring_step`/`run_ring` (K3) and
`run_ring_mega` (K4) read and write device-resident rings in place.

PyTorch idiom where the reference used JAX's: the device is explicit
(``Pipeline(cfg, device)``, the card by default; a CPU device runs the
plain versions), functions run eagerly on tensors, and the
dither is counter-based Philox keyed by the state's ``(seed, step)`` rather
than a threefry key split per block.  The carried conv tail is always
k_pad = n_casc−1 rounded up to 128 wide (the ring kernels' width); the
extra leading history meets only zero taps, so it is inert
(`afp_tpu/engine/pipeline.py:1327-1330`).

With ``agc_enabled`` the AGC runs first, on the raw block, along the JAX
package's TPU route on every device (`pipeline.py:637-726`): K5
(`rms_desired`) gives the time-major desired gain, the ``agc_link_group``
group-min links it, and K6 (`smooth_gain_apply`) runs the recurrence,
clips, applies and carries the gain.  Under 'td_mxu' K6 stores the bf16
pair of its output, which K8 (`fir_td_mxu_pair`, staged) or K7
(`fir_td_mxu_pair_to_ring`, serving ring) convolves behind the carried pair
tail; under 'fft' K6 stores f32 for the overlap-save.  'fast' mode is the
same kernels with the blockwise options (chunk 32; the chunk means flow
from K5 to K6 unless the AGC is linked).

Transport forms (`pipeline.py:303-345`; `StreamConfig.validate` restricts
both ingest forms to 'td_mxu'):

* ``ingest='pcm16'``: blocks and rings are raw int16 PCM, ``n/32768``
  full scale, and floats are refused (never silently quantized).  Without
  AGC the conv reads the int16 block itself and carries its raw int16
  history: the serving rings run K12, and the staged step runs K12 over a
  one-slot view of the block (the same loader, so staged ≡ ring bit for
  bit).  With AGC, K5 and K6 read the int16 block or ring slot and the
  conv consumes K6's pair as for f32 input.  Every convert is exact, so
  the output equals the f32 chain's on ``n/32768`` bit for bit.
* ``ingest='pair'`` (no AGC): blocks arrive as the bf16 (hi, lo) pair, or
  as f32 split at entry; the staged step runs K8, the rings K13, behind
  the carried pair tail.
* ``emit='pcm16'``: the output is int16 PCM, the quantizer
  `quantize_pcm16` fused into the conv store after the clip and the
  dither ('td_mxu'), or run after K2 ('fft').  Output rings are int16.

A `RingServer` hands :meth:`Pipeline.run_ring` its cache of CUDA graphs
(`engine/ring_graphs.py`): on a card the AGC ring's chunk then runs its
steps eagerly the first time its first slot, length and rings are
dispatched, is captured the second time and is replayed from then on, one
launch a chunk, bit for bit the eager steps; the taps are built once per
params object, the dither's block counter is read on the device, and the
state returned lives in the cache's buffers.  Every other ring call (no
cache, the CPU, the conv rings, a sharded pipeline's shards) runs eagerly.

Per-stream banks (`engine/batch.py`; `pipeline.py:549-557, 813-904`):

* ``eq_gains`` [B, n_bands] (per-stream EQ): 'td_mxu' runs K11 on the f32
  extended block (a pair or int16 block and tail converted first), then
  its fused clip, dither and int16 store; 'fft' contracts the gains into a
  [B, F] response.  Behind the AGC (K6's or K14's pair store) K11 runs in
  its pair forms, as K8 and K7 do for shared taps: the staged step K5 →
  K6 → K11 pair, and the AGC ring K5 → K6 → K11 pair-to-ring, so served ≡
  staged bit for bit.  The conv rings without AGC, pair ingest, a filter
  bank beside the gains and `run_ring_mega` refuse them.
* ``casc_bank`` [D, n_casc] + ``casc_assign`` [B / bt] (per-stream main
  filters on 'td_mxu'): the staged step runs K10 (banked K12 over the
  one-slot view under pcm16 ingest without AGC), the f32 and int16 rings
  the banked K3/K4/K12.  Pair rings and the AGC ring refuse it; the offline
  fold is refused with ``fold=True``.
* [B] AGC vectors (per-stream AGC policies): K5 and K6 read them on every
  route.

Under a bank K6 stores f32, not the pair: the pair tail is merged for the
extended block and its next value re-split from the block's last k_pad
columns (`pipeline.py:715-720, 796-805, 960-971`).

The conv's precision (K15; `AFP_TD_PRECISION` in `afp_tpu`, the
``td_precision`` argument here, `pipeline.py:273-348`): 'B3' (the default),
'B3F' and 'B3C' run the one bf16×3 body.  'HIGHEST' runs K1 and K11 in
fp32 and keeps `afp_tpu`'s gates: pair and pcm16 ingest raise, there is no
ring form (``supports_ring_step`` is False), the AGC route stores K6's f32
output and the conv is HIGHEST K1 on the f32 extended block, banks stay on
K10's bf16×3 body, and 'fft' ignores it.

The one-kernel AGC (K14; `AFP_AGC_ONE_KERNEL=1` in `afp_tpu`, the
``agc_one_kernel`` argument here, `pipeline.py:242-264, 661-679,
1235-1246`): under 'exact' mode, ``agc_link_group == 1``, scalar AGC knobs
and K14's gate on the window and block, K14 replaces K5 → K6 on the staged
step (its pair store into K8; f32 under banks, per-stream gains or
HIGHEST) and on the AGC ring (over the slot, into K7).

The offline fold (`pipeline.py:1499-1808`): :meth:`process_signal` with
``fold=True``/``'prefer'`` (or ``'auto'`` under `afp_tpu`'s conditions,
"on the TPU" read as "on the card") folds a signal's blocks into the batch
axis and runs the conv chain as one batched call: K1 at the pipeline's
precision (K8 for pair and pcm16 ingest, K11 for per-stream gains), or one
batched cuFFT overlap-save then K2.  With no AGC each block depends only on
the signal window behind it, and the conv body's per-output sum order does
not depend on the batch, so on the card the fold equals the block-by-block
scan bit for bit with dither off.

The reference refuses int16-output ring serving and `run_ring_mega` with
dither on in its interpret mode (`pipeline.py:1133-1137, 1381-1386`): its
TPU dither has no interpret lowering.  Here the plain versions fuse the
same Philox noise as the kernels, so both forms run with dither on, on
every device.

The literal multirate chain (`pipeline.py:153-177, 974-994`):
``fuse_rate_conversion=False``, or ``output_rate='upsampled'`` with
``upsample_factor > 1`` (whose output keeps the upsampled grid, so there is
nothing to fuse), runs the chain as the reference wrote it: the ``up``
`PolyResampler`, overlap-save at the upsampled rate on the raw band and
main spectra (``H_eq · H_main``), then `decimate` or the ``down``
resampler (neither for upsampled output), then the clip, K2 over the
[B, U·L] or [B, L] output and the int16 quantize.  It runs on 'fft'
(cuFFT); `StreamConfig.validate` refuses 'td_mxu' without fusion, and
'td_mxu' with upsampled output runs it on 'fft' as the reference does.

Device ASRC (``source_samplerate`` ≠ ``samplerate`` under
``asrc_mode='compat'``, `pipeline.py:356-372, 619-633`) converts each
source-rate block before the AGC: the streaming `PolyResampler` when the
block is a multiple of the reduced decimation factor, else a stateless
`resample_poly` per block.  Either way the converted block is padded or
trimmed to ``blocksize``: the reference's compat semantics
(`stream_process_AGC.py:126-129`), reproduced as they are (at 88.2 → 44.1
kHz half a block of audio, then half a block of zeros).  ``asrc_mode=
'exact'`` is the StreamEngine's host frontend (`runtime/asrc.py`); the
pipeline then sees engine-rate blocks.

``agc_mode='parallel'`` (`pipeline.py:734-740`): K5 gives the batch-major
desired gain, `ops.agc.smooth_gain_parallel` solves the recurrence by
branch-consistent fixed-point iteration over an associative scan, and
torch ops clip and apply the gain; the conv reads the f32 result (K1 on
'td_mxu').

None of these has a ring form or folds (`supports_ring_step`,
`supports_fold`, `pipeline.py:1078, 1090-1091, 1604-1615`).

The carried waterfall (``waterfall_enabled``, `pipeline.py:530-535,
1027-1039`): the state carries ``wf`` [B, 50, n_bins], the dB spectra of
the last 50 output blocks, newest last, primed with −200 dB.  Each
:meth:`Pipeline.step` pushes `spectrum_db` (cuFFT on the card) of the
block's final output, after the clip, the dither and the int16 store
(int16 output dequantized ``n/32768``).  The push copies the ring into a
new tensor, so the state passed in stays intact.  Neither the rings nor
the fold carry it (`supports_ring_step`, `supports_fold`).
"""
from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..design.windows import hann
from ..ops.agc import AGCParams, link_desired, smooth_gain_parallel
from ..ops.convolve import next_pow2
from ..ops.cuda import device_launches
from ..ops.cuda.agc_fused import agc_rms_apply, fused_rms_supported
from ..ops.cuda.agc_rms import band_is_exact_bf16, rms_desired
from ..ops.cuda.agc_scan import smooth_gain_apply
from ..ops.cuda.dither import dither_cuda
from ..ops.cuda.fir_td import (band_matrix, fir_td_mxu, fir_td_mxu_banked,
                               fir_td_mxu_pair, fir_td_mxu_pair_to_ring,
                               fir_td_mxu_per_stream,
                               fir_td_mxu_per_stream_pair,
                               fir_td_mxu_per_stream_pair_to_ring,
                               fir_td_mxu_ring,
                               fir_td_mxu_ring_f32, fir_td_mxu_ring_mega,
                               fir_td_mxu_ring_mega_f32,
                               fir_td_mxu_ring_mega_pcm16,
                               fir_td_mxu_ring_pcm16, is_highest, merge_bf16,
                               pcm16_to_f32, quantize_pcm16, ring_k_pad,
                               split_bf16)
from ..ops.resample import (PolyResampler, decimate, resample_poly,
                            streaming_kernel)
from ..ops.spectrum import spectrum_db, waterfall_init, waterfall_push
from ..utils import trace
from .config import PipelineParams, StreamConfig

__all__ = ["DeviceParams", "StreamState", "Pipeline"]


def _host_scalar(v) -> torch.Tensor:
    """A runtime scalar (or, from `afp_tpu`, a [B] per-stream vector) as a
    float32 tensor on the host."""
    return torch.as_tensor(np.array(v, dtype=np.float32))


def bf16_tensor(a, device) -> torch.Tensor:
    """One bf16 half on `device`: a torch bfloat16 tensor, or a numpy array
    of `ml_dtypes`' bfloat16 (`afp_tpu`'s pairs; numpy has no bf16 of
    torch's, so the bits move as int16)."""
    if isinstance(a, torch.Tensor):
        if a.dtype != torch.bfloat16:
            raise ValueError(f"pair halves must be bfloat16, got {a.dtype}")
        return a.to(device)
    a = np.asarray(a)
    if a.dtype.name != "bfloat16":
        raise ValueError(f"pair halves must be bfloat16, got {a.dtype}")
    return torch.from_numpy(np.array(a).view(np.int16)).view(
        torch.bfloat16).to(device)


class DeviceParams(NamedTuple):
    """Runtime parameter bank on the device.  Swapping it between blocks is
    the reference's glitch-free `filter_lock` swap: same shapes, no rebuild.
    The AGC scalars are 0-d float32 tensors on the host: the kernels take
    them as launch arguments, as the TPU kernels took them in SMEM.  The
    per-stream banks (`engine/batch.py`) live on the device: [B, n_bands]
    EQ gains, a [B, F] ``H_main``, the 'td_mxu' filter bank
    ``casc_bank``/``casc_assign``, and [B] AGC vectors."""

    H_bands: torch.Tensor  # [n_bands, F] complex64 per-band cascade spectra
    H_main: torch.Tensor  # [F] (or per-stream [B, F]) no-EQ cascade spectrum
    eq_gains: torch.Tensor  # [n_bands] (or per-stream [B, n_bands]) float32
    casc_bands: Optional[torch.Tensor] = None  # [n_bands, n_casc] ('td_mxu')
    casc_main: Optional[torch.Tensor] = None  # [n_casc] ('td_mxu')
    agc_target: Optional[torch.Tensor] = None  # [] float32 host, or [B] device
    agc_max_gain: Optional[torch.Tensor] = None  # [] or [B]
    agc_a_att: Optional[torch.Tensor] = None  # [] or [B]
    agc_a_rel: Optional[torch.Tensor] = None  # [] or [B]
    #: per-stream filter banks on 'td_mxu': the deduplicated designs and the
    #: design of each batch tile (bt = B // len(casc_assign))
    casc_bank: Optional[torch.Tensor] = None  # [D, n_casc] float32
    casc_assign: Optional[torch.Tensor] = None  # [B // bt] int32

    def combined_response(self, eq_enabled: bool,
                          premultiplied: bool = True) -> torch.Tensor:
        """The live response, [F] or per-stream [B, F].  Fused
        (`premultiplied`): the H_bands are whole per-band cascades, so the
        response is their gain combination, or the no-EQ cascade H_main.
        Literal chain: the H_bands are raw band spectra, so the gain
        combination multiplies H_main.  The band sum is written out (for
        [B, n_bands] gains one band at a time, never a [B, K, F] product),
        so no matmul precision mode (TF32) can touch it."""
        if eq_enabled and self.H_bands.shape[0] > 0:
            g = self.eq_gains.to(self.H_bands.dtype)
            if g.ndim == 1:
                H = (g[:, None] * self.H_bands).sum(0)
            else:
                H = g[:, :1] * self.H_bands[0]
                for k in range(1, g.shape[1]):
                    H = H + g[:, k:k + 1] * self.H_bands[k]
            return H if premultiplied else H * self.H_main
        return self.H_main

    def combined_cascade(self, eq_enabled: bool) -> torch.Tensor:
        """The live fused taps, [n_casc] or per-stream [B, n_casc]
        ('td_mxu'): the gain combination is linear in the taps, as in
        frequency.  For [B, n_bands] gains the band sum is written out, as
        in :meth:`combined_response` (the streaming path never asks for
        it: K11 mixes the bands per stream in the kernel)."""
        if eq_enabled and self.casc_bands is not None and self.casc_bands.shape[0] > 0:
            g = self.eq_gains
            if g.ndim == 1:
                if self.casc_bands.is_cuda:  # the product and the band sum
                    trace.add(ops=2)
                return (g[:, None] * self.casc_bands).sum(0)
            k = g[:, :1] * self.casc_bands[0]
            for i in range(1, g.shape[1]):
                k = k + g[:, i:i + 1] * self.casc_bands[i]
            return k
        return self.casc_main


class StreamState(NamedTuple):
    """Carried streaming state: the conv tail and the AGC gain on the
    device, and the dither key on the host — ``seed`` and ``step``, the
    count of blocks processed (block i dithers under Philox key
    ``(seed, step_i)``; the offline fold dithers all its blocks under the
    one key of its first).  Under AGC with the bf16×3 'td_mxu' conv and
    under pair ingest the conv tail is the bf16 (hi, lo) pair of the conv
    input's history, the form K8/K7/K13 read; under pcm16 ingest without
    AGC it is the raw int16 history (K12).  The resamplers are None except
    where they run: ``asrc`` the streaming compat ASRC, ``up`` and
    ``down`` the literal chain's.  ``wf`` is the waterfall ring under
    ``waterfall_enabled``, else None."""

    conv_tail: "torch.Tensor | tuple[torch.Tensor, torch.Tensor]"  # [B, k_pad]
    seed: int
    step: int
    agc_gain: Optional[torch.Tensor] = None  # [B] float32 carried gain
    asrc: Optional[PolyResampler] = None
    up: Optional[PolyResampler] = None
    down: Optional[PolyResampler] = None
    #: [B, 50, n_bins] dB spectra of the last output blocks, newest last
    wf: Optional[torch.Tensor] = None


class Pipeline:
    """Streaming pipeline for a fixed StreamConfig on one device.

    ``td_precision`` is the 'td_mxu' conv's precision ('B3', 'B3F', 'B3C'
    or 'HIGHEST', K15) and ``agc_one_kernel`` opts into the one-kernel AGC
    (K14): the explicit form of `afp_tpu`'s ``AFP_TD_PRECISION`` and
    ``AFP_AGC_ONE_KERNEL``, with its gates.

    Usage::

        pipe = Pipeline(cfg)                              # on the card
        params = pipe.device_params(PipelineParams.design(pipe.cfg))
        state = pipe.init_state(seed=0)
        state, out = pipe.step(params, state, block)      # [B, L] → [B, L]
        state, outs = pipe.run(params, state, blocks)     # [N, B, L]
    """

    def __init__(self, cfg: StreamConfig, device="cuda", td_precision="B3",
                 agc_one_kernel: bool = False):
        cfg = cfg.validate()
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Pipeline: no CUDA device (torch.cuda.is_available() is "
                "False); pass device='cpu' to run the plain versions")
        self.batch = cfg.batch
        self.block = cfg.blocksize
        self.upf = cfg.upsample_factor
        n_design = cfg.numtaps // 2 + cfg.numtaps % 2 if cfg.min_phase else cfg.numtaps
        self.n_kernel = n_design
        self.has_eq = cfg.eq_enabled and len(cfg.eq_bands) > 0
        self.n_fused = 2 * n_design - 1 if self.has_eq else n_design
        self.up_block = self.block * self.upf
        # upsampled output keeps the literal multirate chain: the fusion
        # exists because the output returns to the base rate
        self.upsampled_out = cfg.output_rate == "upsampled" and self.upf > 1
        self.fused = bool(cfg.fuse_rate_conversion) and not self.upsampled_out
        #: samples per output block: U·L for upsampled output, else L
        self.out_block = self.up_block if self.upsampled_out else self.block
        #: the waterfall's analysis window over an output block, uploaded
        #: once (`spectrum_db`'s default, `hann(out_block)` in float32)
        self._wf_window = None
        if cfg.waterfall_enabled:
            self._wf_window = torch.as_tensor(
                hann(self.out_block), dtype=torch.float32, device=self.device)
        if self.fused:
            # upsample(U) → filter → downsample(U) at base-rate output is
            # y[n] = Σ_p cascade[U·(n−p)]·x[p]: one base-rate FIR whose
            # taps are the phase-0 polyphase component of the whole cascade
            if self.upf > 1:
                self._h_up_np = streaming_kernel(
                    self.upf, 1, quality=cfg.resample_quality)
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
        else:
            # the literal chain convolves band ⊛ main at the upsampled rate
            self.n_casc = None
            self.nfft = next_pow2(self.up_block + self.n_fused - 1)
        #: taps of the conv the tail feeds: the cascade, or band ⊛ main
        self._n_conv = self.n_casc if self.fused else self.n_fused
        self._use_td = self.fused and cfg.conv_strategy == "td_mxu"
        #: the 'td_mxu' conv's precision (K15): HIGHEST runs K1/K11 in fp32
        self.td_precision = str(td_precision).upper()
        self._highest = is_highest(td_precision) and self._use_td
        self._k_pad = ring_k_pad(self._n_conv)
        self.agc = AGCParams.from_config(cfg)
        self._agc_on = cfg.agc_enabled
        #: the associative-scan AGC solver ('parallel'): K5, then torch ops
        self._agc_parallel = self._agc_on and cfg.agc_mode == "parallel"
        # device ASRC runs only under 'compat'; under 'exact' the engine's
        # host frontend converts and the pipeline sees engine-rate blocks
        self._asrc_device = bool(
            cfg.source_samplerate and cfg.source_samplerate != cfg.samplerate
            and cfg.asrc_mode == "compat")
        # compat submode: streaming when the block is a multiple of the
        # reduced decimation factor, else the reference's stateless
        # per-block conversion (`stream_process_AGC.py:126-129`)
        self._asrc_stateless = self._asrc_device and bool(
            self.block % (cfg.source_samplerate
                          // math.gcd(cfg.samplerate, cfg.source_samplerate)))
        #: transport forms (`afp_tpu/engine/pipeline.py:303-345`): both need
        #: a bf16×3 conv (the pair IS its operand split).  K5 and K6 take
        #: int16 x on every route, so pcm16 + AGC needs no flag of its own
        #: (`_i16_agc_raw` in the reference)
        for form in ("pair", "pcm16"):
            if cfg.ingest == form and self._highest:
                raise ValueError(
                    f"ingest={form!r} requires a bf16-class conv precision "
                    f"(td_precision is {self.td_precision!r})")
        self._pair_ingest = cfg.ingest == "pair"
        self._i16_ingest = cfg.ingest == "pcm16"
        #: pcm16 without AGC: the conv reads x itself and carries its raw
        #: int16 history
        self._i16_tail = self._i16_ingest and not self._agc_on
        self._emit16 = cfg.emit == "pcm16"
        #: the conv reads a bf16 pair (K6's or K14's store, or the ingest's),
        #: and the tail is carried so; under HIGHEST and the 'parallel'
        #: solver the AGC stores f32 (`_agc_chain_pair`, `pipeline.py:296-302`)
        self._pair_tail = ((self._agc_on and self._use_td and not self._highest
                            and not self._agc_parallel)
                           or self._pair_ingest)
        #: the one-kernel AGC (K14) under the reference's conditions
        #: (`pipeline.py:256-264`); per-stream AGC vectors are checked per
        #: step, as the reference does
        self._agc_one_kernel = False
        if self._agc_on:
            w = cfg.agc_window_size
            band = band_matrix(np.full(w, 1.0 / w, dtype=np.float32))
            self._rms_band = band.to(self.device)  # [w−1+LANE, LANE] boxcar
            # numpy 'same' centering: out[t] covers x[t−w//2 … t+w−1−w//2]
            self._rms_pad = (w // 2, w - 1 - w // 2)
            self._rms_exact = band_is_exact_bf16(band)
            self._agc_blockwise = 32 if cfg.agc_mode == "fast" else None
            # K5 hands K6 the chunk means, unless the group-min must see
            # per-sample d first (min of means ≠ mean of mins)
            self._agc_means = bool(self._agc_blockwise
                                   and cfg.agc_link_group == 1)
            self._agc_one_kernel = bool(
                agc_one_kernel and cfg.agc_link_group == 1
                and cfg.agc_mode == "exact"
                and fused_rms_supported(self.batch, self.block, w,
                                        self._rms_pad[0]))

    # ---------------- reconfiguration and parameters ----------------

    def refresh_dynamic(self, cfg: StreamConfig) -> None:
        """Absorb a dynamic-only config change (same `static_key()`) and
        re-derive the AGC α values (`afp_tpu/engine/pipeline.py:383-397`)."""
        if cfg.static_key() != self.cfg.static_key():
            raise ValueError("refresh_dynamic requires an identical static_key")
        self.cfg = cfg
        self.agc = AGCParams.from_config(cfg)

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
                      cfg: StreamConfig | None = None,
                      agc: AGCParams | None = None) -> DeviceParams:
        """Upload a designed parameter bank: per-band and no-EQ cascades,
        as taps ('td_mxu') and as spectra at the static FFT length, and the
        AGC scalars; for the literal chain the raw band and main spectra
        (`afp_tpu/engine/pipeline.py:455-462`).  `cfg`/`agc` override the
        pipeline's dynamic fields, so a reconfiguration can build the new
        bank before it swaps it in."""
        cfg = cfg if cfg is not None else self.cfg
        agc = agc if agc is not None else self.agc
        dev = self.device
        n_b = p.eq_taps.shape[0] if (cfg.eq_enabled and len(cfg.eq_bands)) else 0
        main64 = np.asarray(p.main_taps, dtype=np.float64)

        def f32(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)

        if self.fused:
            bands = (np.stack([self._cascade(main64, np.asarray(b, np.float64))
                               for b in p.eq_taps]) if n_b
                     else np.zeros((0, self.n_casc)))
            casc = self._cascade(main64, None)
        else:
            bands = (np.asarray(p.eq_taps) if n_b
                     else np.zeros((0, self.n_kernel)))
            casc = main64
        gains = np.asarray(p.eq_gains, dtype=np.float32) if n_b else np.zeros(0)
        F = self.nfft // 2 + 1
        return DeviceParams(
            H_bands=(torch.fft.rfft(f32(bands), n=self.nfft, dim=-1) if n_b
                     else torch.zeros((0, F), dtype=torch.complex64, device=dev)),
            H_main=torch.fft.rfft(f32(casc), n=self.nfft),
            eq_gains=f32(gains),
            casc_bands=f32(bands) if self._use_td else None,
            casc_main=f32(casc) if self._use_td else None,
            agc_target=_host_scalar(cfg.agc_target_level),
            agc_max_gain=_host_scalar(cfg.agc_max_gain),
            agc_a_att=_host_scalar(agc.a_att),
            agc_a_rel=_host_scalar(agc.a_rel),
        )

    def params_from_numpy(self, arrays: dict) -> DeviceParams:
        """A parameter bank from `afp_tpu`'s ``DeviceParams`` fields as numpy
        arrays (``{name: np.asarray(field)}``), the per-stream banks
        included: [B, n_bands] gains, a [B, F] ``H_main``, ``casc_bank`` /
        ``casc_assign``, and AGC knobs as 0-d scalars (kept on the host) or
        [B] vectors (moved to the device).  ``casc_wide`` (the TPU's wide
        band matrix) is not used: K11 reads the band taps."""
        dev = self.device

        def to(name, dtype):
            a = arrays.get(name)
            return None if a is None else torch.as_tensor(
                np.array(a), dtype=dtype, device=dev)

        def knob(name, default):
            a = np.asarray(default if arrays.get(name) is None
                           else arrays[name], dtype=np.float32)
            return (_host_scalar(a) if a.ndim == 0
                    else torch.as_tensor(a, device=dev))

        assign = arrays.get("casc_assign")
        if assign is not None:
            bank = np.asarray(arrays["casc_bank"])
            assign = np.asarray(assign)
            if assign.ndim != 1 or self.batch % len(assign) or (
                    assign.min() < 0 or assign.max() >= bank.shape[0]):
                raise ValueError(
                    f"casc_assign must index the {bank.shape[0]} designs "
                    f"per tile of batch {self.batch}, got {assign.tolist()}")
        return DeviceParams(
            H_bands=to("H_bands", torch.complex64),
            H_main=to("H_main", torch.complex64),
            eq_gains=to("eq_gains", torch.float32),
            casc_bands=to("casc_bands", torch.float32),
            casc_main=to("casc_main", torch.float32),
            agc_target=knob("agc_target", self.cfg.agc_target_level),
            agc_max_gain=knob("agc_max_gain", self.cfg.agc_max_gain),
            agc_a_att=knob("agc_a_att", self.agc.a_att),
            agc_a_rel=knob("agc_a_rel", self.agc.a_rel),
            casc_bank=to("casc_bank", torch.float32),
            casc_assign=to("casc_assign", torch.int32),
        )

    # ---------------- state ----------------

    @property
    def out_dtype(self) -> torch.dtype:
        """The output's dtype: int16 PCM under ``emit='pcm16'``, else f32."""
        return torch.int16 if self._emit16 else torch.float32

    @property
    def in_dtype(self) -> torch.dtype:
        """A block's dtype: int16 PCM under ``ingest='pcm16'``, else f32
        (pair ingest also takes f32 blocks and splits them at entry)."""
        return torch.int16 if self._i16_ingest else torch.float32

    def _resamplers(self) -> dict:
        """The streaming resamplers this pipeline carries, at zero history
        (`afp_tpu/engine/pipeline.py:486-508`): the compat ASRC in its
        streaming submode, and the literal chain's ``up`` and (base-rate
        output under 'resample') ``down``."""
        cfg, B, dev = self.cfg, (self.batch,), self.device
        kw = dict(batch_shape=B, quality=cfg.resample_quality, device=dev)
        out = {}
        if self._asrc_device and not self._asrc_stateless:
            out["asrc"] = PolyResampler.init(
                cfg.samplerate, cfg.source_samplerate, block=self.block, **kw)
        if self.upf > 1 and not self.fused:
            out["up"] = PolyResampler.init(self.upf, 1, block=self.block, **kw)
            if cfg.downsample_mode == "resample" and not self.upsampled_out:
                out["down"] = PolyResampler.init(1, self.upf,
                                                 block=self.up_block, **kw)
        return out

    def init_state(self, seed: int = 0) -> StreamState:
        B, kp, dev = self.batch, self._k_pad, self.device
        if self._i16_tail:
            tail = torch.zeros((B, kp), dtype=torch.int16, device=dev)
        elif self._pair_tail:
            tail = (torch.zeros((B, kp), dtype=torch.bfloat16, device=dev),
                    torch.zeros((B, kp), dtype=torch.bfloat16, device=dev))
        else:
            tail = torch.zeros((B, kp), dtype=torch.float32, device=dev)
        # the gain carry starts at unity (`afp_tpu/engine/pipeline.py:529`)
        gain = (torch.ones(B, dtype=torch.float32, device=dev)
                if self._agc_on else None)
        return StreamState(tail, int(seed), 0, gain, **self._resamplers(),
                           wf=self._wf_init())

    def _wf_init(self) -> Optional[torch.Tensor]:
        """The primed waterfall ring [B, 50, out_block//2 + 1] under
        ``waterfall_enabled``, else None (`pipeline.py:530-535`)."""
        if self._wf_window is None:
            return None
        return waterfall_init(self.out_block // 2 + 1,
                              batch_shape=(self.batch,), device=self.device)

    def _padded(self, t: torch.Tensor) -> torch.Tensor:
        """[B, <= k_pad] → [B, k_pad], zero columns on the left."""
        pad = self._k_pad - t.shape[-1]
        if t.shape != (self.batch, t.shape[-1]) or pad < 0:
            raise ValueError(f"conv_tail must be [{self.batch}, <= "
                             f"{self._k_pad}], got {tuple(t.shape)}")
        return torch.nn.functional.pad(t, (pad, 0))

    def state_from_numpy(self, conv_tail, seed: int, step: int,
                         agc_gain=None, resampler_hist=None,
                         wf=None) -> StreamState:
        """A state from `afp_tpu`'s carried state as numpy arrays, each
        tail zero-padded on the left to k_pad.  The conv tail comes in any
        of `afp_tpu`'s forms: f32 [B, <= k_pad], the bf16 pair ``(hi, lo)``
        its fused AGC route and pair ingest carry (`pipeline.py:519-528`),
        converted to this pipeline's form (split, or widened), or the raw
        int16 history of pcm16 ingest without AGC (`pipeline.py:511-518`),
        which only such a pipeline takes.  ``agc_gain`` is the [B] gain
        carry (unity when absent); `seed`/`step` key the dither;
        ``resampler_hist`` maps each resampler this pipeline carries
        (``'asrc'``, ``'up'``, ``'down'``) to its [B, hist_len] input
        history (zero when absent); ``wf`` is the waterfall ring (primed
        when absent), which only a pipeline with the waterfall takes."""
        dev = self.device
        i16 = (not isinstance(conv_tail, (tuple, list))
               and np.asarray(conv_tail).dtype == np.int16)
        if i16 != self._i16_tail:
            raise ValueError(
                "the conv tail is int16 exactly when ingest='pcm16' runs "
                f"without AGC (this pipeline: ingest={self.cfg.ingest!r}, "
                f"agc_enabled={self._agc_on})")
        if i16:
            tail = self._padded(torch.from_numpy(
                np.array(conv_tail, dtype=np.int16)).to(dev))
        elif isinstance(conv_tail, (tuple, list)):
            hi, lo = (self._padded(bf16_tensor(a, dev)) for a in conv_tail)
            tail = (hi, lo) if self._pair_tail else merge_bf16(hi, lo)
        else:
            t = self._padded(torch.as_tensor(
                np.array(conv_tail, dtype=np.float32), device=dev))
            tail = split_bf16(t) if self._pair_tail else t
        gain = None
        if self._agc_on:
            gain = (torch.ones(self.batch, dtype=torch.float32, device=dev)
                    if agc_gain is None else torch.as_tensor(
                        np.array(agc_gain, dtype=np.float32), device=dev))
        rs = self._resamplers()
        hist = dict(resampler_hist or {})
        if set(hist) - set(rs):
            raise ValueError(f"this pipeline carries the resamplers "
                             f"{sorted(rs)}, not {sorted(set(hist) - set(rs))}")
        for name, h in hist.items():
            h = torch.as_tensor(np.array(h, dtype=np.float32), device=dev)
            if h.shape != rs[name].hist.shape:
                raise ValueError(f"{name} history must be "
                                 f"{tuple(rs[name].hist.shape)}, got {tuple(h.shape)}")
            rs[name] = rs[name]._replace(hist=h)
        ring = self._wf_init()
        if wf is not None:
            if ring is None:
                raise ValueError("a waterfall ring was given, but this "
                                 "pipeline runs without the waterfall")
            wf = torch.as_tensor(np.array(wf, dtype=np.float32), device=dev)
            if wf.shape != ring.shape:
                raise ValueError(f"wf must be {tuple(ring.shape)}, got "
                                 f"{tuple(wf.shape)}")
            ring = wf
        return StreamState(tail, int(seed), int(step), gain, **rs, wf=ring)

    # ---------------- the staged step ----------------

    def _dither_kw(self, state: StreamState, out_clip) -> dict:
        cfg = self.cfg
        on = cfg.dither_kind != "off"
        return dict(out_clip=out_clip, dither_key=(state.seed, state.step),
                    dither_bits=cfg.dither_bits if on else None,
                    dither_tpdf=cfg.dither_kind == "tpdf")

    def _signal(self, a) -> torch.Tensor:
        """A block, block stack or signal on the device in its transport
        dtype: int16 PCM under pcm16 ingest (floats are refused, never
        silently quantized, `pipeline.py:1540-1548`), else f32."""
        if not self._i16_ingest:
            return torch.as_tensor(a, dtype=torch.float32, device=self.device)
        t = torch.as_tensor(a, device=self.device)
        if t.dtype != torch.int16:
            raise ValueError(f"ingest='pcm16' blocks and signals must be "
                             f"int16, got {t.dtype}")
        return t

    def _block(self, block):
        """One [B, L] block in its transport form: int16 PCM (pcm16), the
        bf16 (hi, lo) pair (pair ingest: a pair as given, an f32 block split
        here, `pipeline.py:597-612`), else f32."""
        if self._pair_ingest:
            x = (tuple(bf16_tensor(a, self.device) for a in block)
                 if isinstance(block, (tuple, list))
                 else split_bf16(self._signal(block)))
            shapes = [tuple(t.shape) for t in x]
        else:
            x = self._signal(block)
            shapes = [tuple(x.shape)]
        if any(sh != (self.batch, self.block) for sh in shapes):
            raise ValueError(f"block must be [{self.batch}, {self.block}], "
                             f"got {shapes}")
        return x

    def _linked(self, d: torch.Tensor) -> torch.Tensor:
        """The ``agc_link_group`` group-min of the time-major desired gain
        [T, B] (`afp_tpu/engine/pipeline.py:559-568`); identity at 1."""
        return link_desired(d, self.cfg.agc_link_group, batch_axis=1)

    def _agc(self, params: DeviceParams, x: torch.Tensor, gain, ring_idx=None,
             emit_split=None, carry_out=None):
        """The AGC on the block ``x`` [B, L] (or on slot ``ring_idx`` of the
        ring ``x``): K5 → link → K6, or K14 alone under the one-kernel
        option with scalar knobs.  Returns (the gained block — its bf16
        pair when the conv reads pairs, unless `emit_split` says otherwise —
        and the new [B] gain carry, stored into `carry_out` where given)."""
        cfg = self.cfg
        emit = self._pair_tail if emit_split is None else emit_split
        init = gain if cfg.agc_carry else None
        if self._agc_parallel:
            return self._agc_solver(params, x, init, emit)
        if self._agc_one_kernel and not any(
                v.ndim for v in (params.agc_target, params.agc_max_gain,
                                 params.agc_a_att, params.agc_a_rel)):
            return agc_rms_apply(x, cfg.agc_window_size, params.agc_a_att,
                                 params.agc_a_rel, params.agc_target,
                                 params.agc_max_gain, init=init,
                                 out_clip=0.99, emit_split=emit,
                                 ring_idx=ring_idx, carry_out=carry_out)
        lp, rp = self._rms_pad
        mc = self._agc_blockwise if self._agc_means else 0
        d = rms_desired(x, self._rms_band, lp, rp, params.agc_target,
                        params.agc_max_gain, exact_band=self._rms_exact,
                        transposed=True, ring_idx=ring_idx, mean_chunk=mc)
        if not mc:
            d = self._linked(d)
        return smooth_gain_apply(
            d, x, params.agc_a_att, params.agc_a_rel, params.agc_max_gain,
            init=init, out_clip=0.99, emit_split=emit, ring_idx=ring_idx,
            blockwise=self._agc_blockwise, d_is_means=bool(mc),
            carry_out=carry_out)

    def _agc_solver(self, params: DeviceParams, x: torch.Tensor, init, emit):
        """``agc_mode='parallel'`` (`afp_tpu/engine/pipeline.py:637-740`):
        K5's batch-major desired gain [B, T], the group-min, the
        associative-scan solver, then the clip to [0.1, max_gain], the apply
        and the ±0.99 clip as torch ops.  Returns the f32 gained block (its
        pair with `emit`) and the [B] carry."""
        lp, rp = self._rms_pad
        d = rms_desired(x, self._rms_band, lp, rp, params.agc_target,
                        params.agc_max_gain, exact_band=self._rms_exact)
        d = link_desired(d, self.cfg.agc_link_group, batch_axis=0)
        g = smooth_gain_parallel(d, params.agc_a_att, params.agc_a_rel,
                                 init=init)
        mg = params.agc_max_gain.to(g.device)
        g = torch.minimum(torch.clamp_min(g, 0.1),
                          mg[:, None] if mg.ndim else mg)
        xf = pcm16_to_f32(x) if x.dtype == torch.int16 else x
        y = torch.clamp(xf * g, -0.99, 0.99)
        return (split_bf16(y) if emit else y), g[:, -1].contiguous()

    def _per_stream(self, params: DeviceParams) -> bool:
        """True when the params carry per-stream EQ gains."""
        return self.has_eq and params.eq_gains.ndim == 2

    @contextlib.contextmanager
    def _eq_mix_span(self, params: DeviceParams, block: int):
        """The span ``afp.pipe.eq_mix`` of one K11 launch over `params`'
        per-stream gains for block `block`, with the counts ``rows``,
        ``bands``, ``taps``, ``samples`` (rows × block) and ``bytes`` (the
        mix's output)."""
        g, bands = params.eq_gains, params.casc_bands
        samples = g.shape[0] * self.block
        with trace.span("afp.pipe.eq_mix", block=block,
                        nbytes=samples * self.out_dtype.itemsize):
            trace.add(rows=g.shape[0], bands=bands.shape[0],
                      taps=bands.shape[1], samples=samples)
            yield

    def _eq_mix(self, form, params: DeviceParams, tail, block: int, dkw: dict,
                x, *rest, **kw):
        """K11 in one of its pair forms (`form`) over the gained pair `x`
        behind the pair `tail`, with the band kernels, the per-stream gains,
        the dither `dkw` and `form`'s further arguments `rest`/`kw`; traced
        as :meth:`_eq_mix_span` of block `block`."""
        with self._eq_mix_span(params, block):
            return form(*x, *tail, params.casc_bands, params.eq_gains, *rest,
                        **dkw, **kw)

    def _ext(self, tail, x):
        """The f32 extended block [B, n−1+L] (the conv's history, then the
        block of any length L: a block, or a whole signal for the fold) and
        the next carried tail, from any tail and block form: an int16 tail
        and block converted n/32768 (the tail stays raw int16), a pair tail
        merged (the next tail the block's own pair, or, for an f32 block —
        K6's store under banks — the split of the last k_pad columns,
        `pipeline.py:796-805, 960-971`), or f32."""
        kp, n = self._k_pad, self._n_conv
        L = (x[0] if isinstance(x, tuple) else x).shape[-1]
        if self._i16_tail:
            raw = torch.cat([tail, x], dim=-1)
            return pcm16_to_f32(raw[:, kp - (n - 1):]), raw[:, -kp:].clone()
        if self._pair_tail:
            hist = merge_bf16(*tail)[:, kp - (n - 1):]
            if isinstance(x, tuple):
                nxt = tuple(h[:, L - kp:].clone() if kp <= L
                            else torch.cat([t[:, L:], h], dim=-1)
                            for t, h in zip(tail, x))
                return torch.cat([hist, merge_bf16(*x)], dim=-1), nxt
            ext = torch.cat([hist, x], dim=-1)
            return ext, split_bf16(ext[:, -kp:])
        ext = torch.cat([tail[:, kp - (n - 1):], x], dim=-1)
        return ext, (x[:, L - kp:].clone() if kp <= L
                     else torch.cat([tail[:, L:], x], dim=-1))

    def _asrc(self, x: torch.Tensor, asrc):
        """Compat ASRC (`afp_tpu/engine/pipeline.py:619-633`): the source-
        rate block through the streaming resampler (or, in the stateless
        submode, `resample_poly` alone), padded or trimmed to ``blocksize``
        as the reference does (`stream_process_AGC.py:126-129`)."""
        cfg = self.cfg
        if asrc is not None:
            asrc, x = asrc.process(x)
        else:
            x = resample_poly(x, cfg.samplerate, cfg.source_samplerate,
                              quality=cfg.resample_quality)
        n = x.shape[-1]
        x = (torch.nn.functional.pad(x, (0, self.block - n)) if n < self.block
             else x[..., :self.block])
        return x.contiguous(), asrc

    def _output_stage(self, y: torch.Tensor, state: StreamState):
        """The unfused output stage ('fft' and the literal chain): clip, K2
        under the state's key, and the int16 quantize under
        ``emit='pcm16'`` (the reference's XLA epilogue after its dither)."""
        cfg = self.cfg
        if cfg.output_clip is not None:
            y = torch.clamp(y, -cfg.output_clip, cfg.output_clip)
        y = dither_cuda(y.contiguous(), (state.seed, state.step),
                        cfg.dither_bits, cfg.dither_kind)
        return quantize_pcm16(y) if self._emit16 else y

    def step(self, params: DeviceParams, state: StreamState, block):
        """One block: [B, L] → (state, [B, L'] out), L' = U·L under
        upsampled output, else L.  The state passed in is left intact (the
        engine's degradation ladder keeps it to recover from a failed
        step).  Under ``waterfall_enabled`` the new state's ring holds the
        output's spectrum as its newest row (`pipeline.py:1027-1039`)."""
        new_state, y = self._step(params, state, block)
        if state.wf is None:
            return new_state, y
        db = spectrum_db(pcm16_to_f32(y) if self._emit16 else y,
                         self._wf_window)
        return new_state._replace(wf=waterfall_push(state.wf, db)), y

    def _step(self, params: DeviceParams, state: StreamState, block):
        """:meth:`step` without the waterfall."""
        cfg = self.cfg
        x = self._block(block)
        n, L = self._n_conv, self.block
        tail, gain = state.conv_tail, state.agc_gain
        asrc, up, down = state.asrc, state.up, state.down
        dkw = self._dither_kw(state, cfg.output_clip)
        per_stream = self._per_stream(params)
        banked = params.casc_bank is not None
        if self._asrc_device:
            x, asrc = self._asrc(x, asrc)
        if self._agc_on:
            x, gain = self._agc(params, x, gain, emit_split=(
                self._pair_tail and (per_stream or not banked)))

        def nxt(new_tail):
            return StreamState(new_tail, state.seed, state.step + 1, gain,
                               asrc, up, down)

        if not self.fused:
            # the literal chain (`afp_tpu/engine/pipeline.py:974-994`):
            # upsample, overlap-save at the upsampled rate, then decimate,
            # the down resampler, or neither for upsampled output
            if up is not None:
                up, x = up.process(x)
            ext, new_tail = self._ext(tail, x)
            H = params.combined_response(self.has_eq, premultiplied=False)
            Y = torch.fft.rfft(ext, n=self.nfft) * H
            y = torch.fft.irfft(Y, n=self.nfft)[:, n - 1: n - 1 + self.up_block]
            if self.upf > 1 and not self.upsampled_out:
                if cfg.downsample_mode == "decimate":
                    y = decimate(y, self.upf)
                else:
                    down, y = down.process(y)
            return nxt(new_tail), self._output_stage(y, state)
        if self._i16_tail and not per_stream:
            # K12 over a one-slot view of the block (banked K12 with a
            # bank): the serving ring's own loader (staged ≡ ring bit for
            # bit), emitting the int16 tail
            h, bkw = self._taps(params)
            out = torch.empty((1, self.batch, L), dtype=self.out_dtype,
                              device=self.device)
            out, new_tail = fir_td_mxu_ring_pcm16(x[None], 0, tail, h, out,
                                                  **dkw, **bkw)
            return nxt(new_tail), out[0]
        if isinstance(x, tuple) and per_stream and self._agc_on:
            # K11 over the AGC's pair store: the ring's form (staged ≡ ring)
            y, th, tl = self._eq_mix(fir_td_mxu_per_stream_pair, params,
                                     tail, state.step, dkw, x,
                                     emit_i16=self._emit16)
            return nxt((th, tl)), y
        if isinstance(x, tuple) and not (per_stream or banked):
            y, th, tl = fir_td_mxu_pair(
                x[0], x[1], tail[0], tail[1],
                params.combined_cascade(self.has_eq), emit_i16=self._emit16,
                **dkw)
            return nxt((th, tl)), y
        ext, new_tail = self._ext(tail, x)
        if not self._use_td:
            H = params.combined_response(self.has_eq)
            Y = torch.fft.rfft(ext, n=self.nfft) * H
            y = self._output_stage(
                torch.fft.irfft(Y, n=self.nfft)[:, n - 1: n - 1 + L], state)
        elif per_stream:
            y = fir_td_mxu_per_stream(ext, params.casc_bands, params.eq_gains,
                                      emit_i16=self._emit16,
                                      precision=self.td_precision, **dkw)
        elif banked:
            y = fir_td_mxu_banked(ext, params.casc_bank, params.casc_assign,
                                  emit_i16=self._emit16, **dkw)
        else:
            y = fir_td_mxu(ext, params.combined_cascade(self.has_eq),
                           emit_i16=self._emit16, precision=self.td_precision,
                           **dkw)
        return nxt(new_tail), y

    def run(self, params: DeviceParams, state: StreamState, blocks):
        """Step over [N, B, L] blocks → (state, [N, B, L']), L' as
        :meth:`step`.  Under pair ingest `blocks` may also be the
        ``(hi, lo)`` pair of [N, B, L] halves."""
        if self._pair_ingest and isinstance(blocks, tuple):
            blocks = zip(*(bf16_tensor(a, self.device) for a in blocks))
        else:
            blocks = self._signal(blocks)
        outs = []
        for blk in blocks:
            state, y = self.step(params, state, blk)
            outs.append(y)
        if not outs:
            return state, torch.zeros((0, self.batch, self.out_block),
                                      dtype=self.out_dtype, device=self.device)
        return state, torch.stack(outs)

    def process_signal(self, params: DeviceParams, state: StreamState,
                       signal, fold="auto"):
        """Whole-signal convenience: [B, T] → (state, [B, T'']), T'' the
        whole blocks of T (× U under upsampled output;
        `afp_tpu/engine/pipeline.py:1499-1538`).
        ``fold=False`` streams block by block; ``True`` requires the
        offline fold (:meth:`process_signal_folded`), ``'prefer'`` folds
        when :attr:`supports_fold`, and ``'auto'`` folds only where the fold
        equals the scan bit for bit: 'td_mxu', no per-stream gains, dither
        off, on the card, batch < 256 (:meth:`_fold_decision`).  Under pcm16
        ingest the signal is int16 PCM."""
        if self._fold_decision(fold, params):
            return self.process_signal_folded(params, state, signal)
        signal = self._signal(signal)
        B, T = signal.shape
        L = self.block
        nb = T // L
        blocks = signal[:, : nb * L].reshape(B, nb, L).transpose(0, 1)
        state, outs = self.run(params, state, blocks)
        return state, outs.transpose(0, 1).reshape(B, nb * self.out_block)

    # ---------------- the offline fold ----------------

    @property
    def supports_fold(self) -> bool:
        """True when the offline fold applies: the fused chain with no
        cross-block recurrence (AGC) and no streaming resampler (device
        ASRC), so each block's output depends only on the signal window
        behind it (`pipeline.py:1603-1615`), and no waterfall to carry."""
        return (self.fused and not self._agc_on and not self._asrc_device
                and not self.cfg.waterfall_enabled)

    def _fold_decision(self, fold, params: DeviceParams) -> bool:
        """Resolve `fold` ('auto', 'prefer', True, False) against this
        pipeline and `params` (`pipeline.py:1552-1601`)."""
        if params.casc_bank is not None:
            # the folded batch axis breaks the tile-constant assignment
            if fold is True:
                raise ValueError(
                    "fold=True is unsupported with per-stream filter banks "
                    "(the folded batch axis breaks the tile-constant "
                    "design assignment) — use fold='auto'")
            return False
        if fold is True:
            if not self.supports_fold:
                raise ValueError(
                    "fold=True but this pipeline cannot fold (needs the "
                    "fused single-rate chain without AGC, device ASRC or "
                    "waterfall)")
            return True
        if fold == "prefer":
            return self.supports_fold
        if fold == "auto":
            per_stream = params.eq_gains.ndim == 2 or params.H_main.ndim == 2
            return (self.supports_fold and self._use_td and not per_stream
                    and self.cfg.dither_kind == "off"
                    and self.device.type == "cuda" and self.batch < 256)
        if fold is not False:
            raise ValueError(
                f"fold must be 'auto', 'prefer', True, or False; got {fold!r}")
        return False

    def _frame_rows(self, ext: torch.Tensor, nb: int, W: int) -> torch.Tensor:
        """Frame [B, H + nb·L] into the hop-L windows [B·nb, W] (W = H + L),
        rows B-major (row b·nb + i is block i of stream b), in any dtype
        (`pipeline.py:1617-1631`)."""
        return ext.unfold(1, W, self.block)[:, :nb].reshape(-1, W)

    def process_signal_folded(self, params: DeviceParams, state: StreamState,
                              signal):
        """The offline fold: the [B, T] signal's blocks fold into the batch
        axis and the conv chain runs as ONE batched call over [B·nb, ·]
        rows (`pipeline.py:1633-1808`): K1 at the pipeline's precision; K8
        under pair and pcm16 ingest (framed in the split domain, or from the
        raw int16, both exact); K11 for per-stream gains (each stream's
        gains repeated over its blocks); or, for 'fft', one batched
        overlap-save, the clip, K2 and the int16 quantizer.  The dither
        draws from the one key ``(seed, step)`` over the folded rows (the
        scan walks one key per block: another realization of the same
        noise); the state comes back as the scan leaves it (the signal's
        last history columns, ``step`` advanced by the blocks).  The TPU's
        8-row padding is not needed: the kernels mask rows."""
        if not self.supports_fold:
            raise ValueError("this pipeline cannot fold (it runs the AGC, "
                             "device ASRC, the waterfall or the literal "
                             "chain)")
        cfg = self.cfg
        signal = self._signal(signal)
        B, T = signal.shape
        if B != self.batch:
            raise ValueError(f"signal must be [{self.batch}, T], got "
                             f"{tuple(signal.shape)}")
        L, n, kp = self.block, self.n_casc, self._k_pad
        nb = T // L
        if nb == 0:  # nothing to fold
            return state, torch.zeros((B, 0), dtype=self.out_dtype,
                                      device=self.device)
        signal = signal[:, : nb * L]
        tail = state.conv_tail
        dkw = self._dither_kw(state, cfg.output_clip)
        per_stream = self._per_stream(params)
        pair_conv = self._use_td and not per_stream and (
            self._i16_tail or self._pair_tail)
        if not pair_conv:
            # as the staged step: a pair-ingest signal rides as
            # merge(split(x)) for the per-stream mix
            ext, new_tail = self._ext(tail, merge_bf16(*split_bf16(signal))
                                      if self._pair_tail else signal)
            rows = self._frame_rows(ext, nb, n - 1 + L)
        if self._use_td and per_stream:
            gains = params.eq_gains.repeat_interleave(nb, dim=0)
            y = fir_td_mxu_per_stream(rows, params.casc_bands, gains,
                                      emit_i16=self._emit16,
                                      precision=self.td_precision, **dkw)
        elif self._use_td:
            h = params.combined_cascade(self.has_eq)
            if pair_conv:
                # K8 over the split domain (the split is elementwise, so it
                # commutes with the framing); the tail stays in its form
                if self._i16_tail:
                    raw = torch.cat([tail, signal], dim=-1)
                    eh, el = split_bf16(pcm16_to_f32(raw))
                    new_tail = raw[:, -kp:].clone()
                else:
                    eh, el = (torch.cat([t, x], dim=-1)
                              for t, x in zip(tail, split_bf16(signal)))
                    new_tail = (eh[:, -kp:].clone(), el[:, -kp:].clone())
                rh, rl = (self._frame_rows(e, nb, kp + L) for e in (eh, el))
                y, _, _ = fir_td_mxu_pair(rh[:, kp:], rl[:, kp:], rh[:, :kp],
                                          rl[:, :kp], h, emit_i16=self._emit16,
                                          **dkw)
            else:
                y = fir_td_mxu(rows, h, emit_i16=self._emit16,
                               precision=self.td_precision, **dkw)
        else:  # 'fft': one batched overlap-save pass
            H = params.combined_response(self.has_eq)
            if H.ndim == 2:  # per-stream responses, repeated over the blocks
                H = H.repeat_interleave(nb, dim=0)
            Y = torch.fft.rfft(rows, n=self.nfft) * H
            y = torch.fft.irfft(Y, n=self.nfft)[:, n - 1: n - 1 + L]
            if cfg.output_clip is not None:
                y = torch.clamp(y, -cfg.output_clip, cfg.output_clip)
            y = dither_cuda(y.contiguous(), (state.seed, state.step),
                            cfg.dither_bits, cfg.dither_kind)
            if self._emit16:
                y = quantize_pcm16(y)
        out = y.reshape(B, nb * L)
        return StreamState(new_tail, state.seed, state.step + nb,
                           state.agc_gain), out

    # ---------------- serving rings ----------------

    @property
    def supports_ring_step(self) -> bool:
        """True when the ring forms are available, which needs the bf16×3
        'td_mxu' conv (`pipeline.py:1055-1091`; not under HIGHEST): the conv
        ring over one f32 or int16 PCM input ring, the pair rings of pair
        ingest, or, with AGC, the fused AGC chain over one f32 or int16
        input ring.  Device ASRC, the 'parallel' AGC solver, the literal
        chain and the waterfall have no ring form (`pipeline.py:1078,
        1090-1091`)."""
        return (self._use_td and not self._highest and not self._asrc_device
                and not self._agc_parallel and not self.cfg.waterfall_enabled)

    def _taps(self, params: DeviceParams):
        """The conv's taps and bank keywords: the live shared taps, or the
        filter bank with its per-tile assignment."""
        if params.casc_bank is None:
            return params.combined_cascade(self.has_eq), {}
        return params.casc_bank, dict(assign=params.casc_assign)

    def check_ring_params(self, params: DeviceParams,
                          mega: bool = False) -> None:
        """Refuse params that the ring dispatch cannot serve (`mega`:
        `run_ring_mega`'s, else `ring_step`'s, which `run_ring` steps):
        per-stream EQ gains ride the AGC ring alone (K5 → K6 → K11
        pair-to-ring), so `run_ring_mega`, the conv rings without AGC, pair
        ingest and a filter bank beside the gains refuse them.
        `RingServer` asks at construction."""
        if not self._per_stream(params):
            return
        served = ("per-stream EQ gains are served on the AGC ring only "
                  "(run_ring: K5 → K6 → K11 pair-to-ring)")
        if mega:
            raise ValueError(f"run_ring_mega does not support per-stream EQ "
                             f"gains: {served}")
        if self._pair_ingest:
            raise ValueError(f"ring_step does not support per-stream EQ "
                             f"gains with pair ingest: {served} — use step()")
        if not self._agc_on:
            raise ValueError(f"ring_step does not support per-stream EQ gains "
                             f"on the conv rings without AGC: {served} — use "
                             "step()")
        if params.casc_bank is not None:
            raise ValueError(f"ring_step does not support per-stream EQ "
                             f"gains together with a filter bank: {served}, "
                             "with the shared band — use step()")

    def _ring_taps(self, params: DeviceParams, ring_hi, ring_lo, out_ring,
                   mega: bool = False):
        """:meth:`_check_ring`, then the taps and bank keywords: (None, {})
        under per-stream gains, whose band kernels K11 mixes itself."""
        self._check_ring(params, ring_hi, ring_lo, out_ring, mega)
        if self._per_stream(params):
            return None, {}
        return self._taps(params)

    def _check_ring(self, params: DeviceParams, ring_hi, ring_lo, out_ring,
                    mega: bool = False) -> None:
        """The checks of every ring form (`pipeline.py:1110-1191,
        1369-1401`): per-stream EQ gains on the AGC ring only
        (:meth:`check_ring_params`), pair rings exactly for pair ingest, an
        int16 input ring exactly for pcm16 ingest, an int16 output ring
        exactly under ``emit='pcm16'``, filter banks on the f32 and int16
        conv rings only."""
        cfg = self.cfg
        self.check_ring_params(params, mega)
        if not self.supports_ring_step:
            raise ValueError(
                "ring_step requires a conv ring: conv_strategy='td_mxu' "
                "with a bf16-class td_precision, waterfall disabled (see "
                "supports_ring_step)")
        if (ring_lo is None) == self._pair_ingest:
            raise ValueError(
                "ring form mismatch: pair-ingest pipelines take (hi, lo) "
                "rings, the others one ring (ring_lo=None)")
        if not self._pair_ingest and ring_hi.dtype != self.in_dtype:
            raise ValueError(
                f"ingest={cfg.ingest!r} serving rings must be "
                f"{self.in_dtype}, got {ring_hi.dtype}")
        if out_ring.dtype != self.out_dtype:
            raise ValueError(
                f"emit={cfg.emit!r} output rings must be {self.out_dtype}, "
                f"got {out_ring.dtype}")
        if params.casc_bank is not None and (self._pair_ingest
                                             or self._agc_on):
            raise ValueError(
                "per-stream filter banks ride the f32/pcm16 conv rings "
                "only — pair ingest and the fused AGC chain consume the "
                "shared band (use step(), or drop the bank)")

    def ring_step(self, params: DeviceParams, state: StreamState,
                  ring_hi: torch.Tensor, ring_lo, idx: int,
                  out_ring: torch.Tensor):
        """One serving step: convolve slot `idx` of the input ring
        ``ring_hi`` [S, B, L] into slot `idx` of `out_ring`, written in
        place: K3 over an f32 ring, K12 over an int16 PCM ring (each banked
        under a filter bank), K13 over the pair rings ``(ring_hi,
        ring_lo)`` of pair ingest.  With AGC, K5 and K6 (or K14 alone under
        the one-kernel option) read the slot in place and K7 convolves the
        gained pair into the output slot
        (`afp_tpu/engine/pipeline.py:1093-1299`); under per-stream EQ gains
        K11's pair-to-ring form mixes it there instead (the staged step's
        K11 pair form with K7's store: served ≡ staged).  ``ring_lo`` is
        None except under pair ingest."""
        if not self._agc_on:
            return self._conv_ring(params, state, ring_hi, ring_lo, out_ring,
                                   idx, 1, False), out_ring
        h, _ = self._ring_taps(params, ring_hi, ring_lo, out_ring)
        dkw = self._dither_kw(state, self.cfg.output_clip)
        out_ring, tail, gain = self._agc_ring_step(
            params, h, state.conv_tail, state.agc_gain, ring_hi, idx,
            out_ring, dkw, state.step)
        return StreamState(tail, state.seed, state.step + 1, gain), out_ring

    #: the conv ring wrappers by (ingest, mega): one step, or one launch of
    #: n steps
    _CONV_RINGS = {("f32", False): fir_td_mxu_ring_f32,
                   ("f32", True): fir_td_mxu_ring_mega_f32,
                   ("pcm16", False): fir_td_mxu_ring_pcm16,
                   ("pcm16", True): fir_td_mxu_ring_mega_pcm16,
                   ("pair", False): fir_td_mxu_ring,
                   ("pair", True): fir_td_mxu_ring_mega}

    def _conv_ring(self, params: DeviceParams, state: StreamState, ring_hi,
                   ring_lo, out_ring, start: int, n_steps: int,
                   mega: bool) -> StreamState:
        """The conv ring without AGC from slot `start` into `out_ring`, in
        place: one step (K3, K12 or K13; `n_steps` 1), or with `mega` one
        launch of `n_steps` (K4, K12's or K13's megakernel form), banked
        under a filter bank.  Returns the next state."""
        h, bkw = self._ring_taps(params, ring_hi, ring_lo, out_ring, mega)
        dkw = self._dither_kw(state, self.cfg.output_clip)
        pair = self._pair_ingest
        rings = (ring_hi, ring_lo) if pair else (ring_hi,)
        tails = state.conv_tail if pair else (state.conv_tail,)
        out_ring, *tail = self._CONV_RINGS[self.cfg.ingest, mega](
            *rings, start, *tails, h, out_ring, *((n_steps,) if mega else ()),
            **dkw, **bkw)
        return StreamState(tuple(tail) if pair else tail[0], state.seed,
                           state.step + int(n_steps))

    def _agc_ring_step(self, params: DeviceParams, h, tail, gain, ring, idx,
                       out_ring, dkw: dict, block: int, counter=None,
                       counter_add: int = 0, tail_out=None, carry_out=None):
        """One step of the AGC ring: K5 and K6 (K14 under the one-kernel
        option) over slot `idx` of `ring`, then K7 with the taps `h` into
        slot `idx` of `out_ring`, or K11's pair-to-ring form with `params`'
        per-stream gains where `h` is None; behind the pair `tail` and the
        gain carry `gain`, dithered as `dkw` says, traced as block `block`.
        Returns (out_ring, the next pair tail, the next gain carry).
        `counter`/`counter_add`/`tail_out` go to K7 or K11 and `carry_out`
        to K6 or K14 (a chunk's graph, :meth:`_agc_ring_chunk`)."""
        (xh, xl), gain = self._agc(params, ring, gain, ring_idx=idx,
                                   carry_out=carry_out)
        io = dict(counter=counter, counter_add=counter_add, tail_out=tail_out)
        if h is None:
            out_ring, th, tl = self._eq_mix(
                fir_td_mxu_per_stream_pair_to_ring, params, tail, block, dkw,
                (xh, xl), idx, out_ring, **io)
        else:
            out_ring, th, tl = fir_td_mxu_pair_to_ring(
                xh, xl, tail[0], tail[1], h, idx, out_ring, **dkw, **io)
        return out_ring, (th, tl), gain

    def _agc_ring_chunk(self, params: DeviceParams, h, home, ring, out_ring,
                        n_steps: int, start: int, dkw: dict, block: int,
                        counter: torch.Tensor) -> int:
        """`n_steps` AGC ring steps (:meth:`_agc_ring_step`) over slots
        ``(start+i) mod S``, from the state in `home` (the pair tail's two
        halves and the [B] gain carry) back into it: the body of a chunk's
        CUDA graph (`engine/ring_graphs.py`), run as it is the first time
        its chunk is dispatched.  Step i dithers under the block counter
        ``counter + i``, `counter` an int32 on the device that the last
        step's tail kernel advances by `n_steps`; the last step's kernels
        store the tail and the carry into `home`, except in a one-step
        chunk, which reads them, where three copies do.  Returns the device
        operations it enqueued besides the kernels' launches."""
        S = ring.shape[0]
        seed = dkw["dither_key"][0]
        tail, gain = home[:2], home[2]
        for i in range(n_steps):
            last = i == n_steps - 1
            into = last and n_steps > 1
            out_ring, tail, gain = self._agc_ring_step(
                params, h, tail, gain, ring, (start + i) % S, out_ring,
                {**dkw, "dither_key": (seed, i)}, block + i, counter=counter,
                counter_add=n_steps if last else 0,
                tail_out=home[:2] if into else None,
                carry_out=home[2] if into else None)
        if n_steps > 1:
            return 0
        for dst, src in zip(home, (*tail, gain)):
            dst.copy_(src)
        return 3

    def run_ring(self, params: DeviceParams, state: StreamState,
                 ring_hi: torch.Tensor, ring_lo, out_ring: torch.Tensor,
                 n_steps: int, start: int = 0, graphs=None):
        """`n_steps` ring steps over slots ``(start+i) mod S`` (one K3, K12
        or K13 launch each; with AGC, K5, K6 and K7 each, or K11's
        pair-to-ring form for K7 under per-stream gains); `out_ring` is
        written in place.  Traced as ``afp.pipe.run_ring``, K11's launches
        inside it as ``afp.pipe.eq_mix``.

        `graphs` is a server's :class:`~afp_tpu_torch.engine.ring_graphs.
        RingGraphs`.  With it, the AGC ring on a card with its AGC knobs all
        host scalars or all [B] vectors runs the chunk as a CUDA graph: the
        same steps, eagerly the first time this chunk (first slot, steps,
        rings) is dispatched, captured the second and replayed from then
        on, with the taps built once per bank; the state returned then
        holds the cache's own buffers, which the next chunk overwrites.
        Every other call runs the steps one launch at a time, as without
        it."""
        S = ring_hi.shape[0]
        with trace.span("afp.pipe.run_ring", block=state.step,
                        blocks=int(n_steps), counter=device_launches):
            if graphs is not None and graphs.engages(self, params, state,
                                                     ring_hi, ring_lo):
                return graphs.run(self, params, state, ring_hi, out_ring,
                                  int(n_steps), start)
            for i in range(int(n_steps)):
                state, out_ring = self.ring_step(params, state, ring_hi,
                                                 ring_lo, (start + i) % S,
                                                 out_ring)
        return state, out_ring

    def run_ring_mega(self, params: DeviceParams, state: StreamState,
                      ring_hi: torch.Tensor, ring_lo, out_ring: torch.Tensor,
                      n_steps: int, start: int = 0):
        """:meth:`run_ring` as ONE kernel launch (K4; K12 for pcm16, K13 for
        pair rings; banked K4/K12 under a filter bank): same slots, outputs,
        tail and dither as the chained steps.  The AGC chain has no such form
        (`afp_tpu/engine/pipeline.py:1358-1467`).  Traced as
        ``afp.pipe.run_ring_mega``."""
        if self._agc_on:
            raise ValueError(
                "run_ring_mega requires a conv ring without AGC: the AGC "
                "chain serves through run_ring")
        with trace.span("afp.pipe.run_ring_mega", block=state.step,
                        blocks=int(n_steps), counter=device_launches):
            state = self._conv_ring(params, state, ring_hi, ring_lo,
                                    out_ring, start, n_steps, True)
        return state, out_ring
