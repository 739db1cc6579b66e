"""StreamEngine — host-side orchestration of the device pipeline
(counterpart of `afp_tpu/engine/engine.py`).

Owns a :class:`~afp_tpu_torch.engine.pipeline.Pipeline`, its parameter bank
and streaming state, and implements the reference's two disciplines on top:

* **Glitch-free live reconfiguration** (`stream_process_EQ_GUI.py:280-306,
  364-388`): `apply_config()` re-designs on the host and swaps the device
  parameter tensors between blocks; only shape changes rebuild the pipeline.
* **Degradation ladder** (`stream_process.py:115-120`,
  `stream_process_AGC.py:493-496`): a failed block replays the last good
  block or emits silence, and the carried state (conv tail, AGC gain) stays
  that of the last good block; a failed design substitutes the reference's
  moving-average kernel; an underrun blends ``0.8·last``.  Every event is
  counted in :class:`EngineMetrics` — the ladder swallows exceptions by
  design, so callers that need to know read the counters.

Host blocks carry the transport dtypes (`afp_tpu/engine/engine.py:118-128`):
int16 PCM in under ``ingest='pcm16'`` (a float block raises ``ValueError``
before the ladder: coercing it would silently quantize), int16 PCM out
under ``emit='pcm16'`` (the ladder's silence and the underrun blend stay
int16; the blend requantizes).

On a card, `process_block` stages its copies through pinned memory (the
helper `RingServer` lands blocks with, `utils/staging.py:to_device`), and
`process_signal` can upload a long signal in chunks on a copy stream
behind the compute (``AFP_STAGE_CHUNK_MB``); both give the same bits as
the pageable one-shot copy.  :meth:`StreamEngine.process_frames` regroups chunks of any length
through the residual framers (`runtime/framer.py`), whose residuals
checkpoints carry (`engine/checkpoint.py`); under upsampled output it
emits ``upsample_factor`` samples per input sample.

Block-exact ASRC (``asrc_mode='exact'``, `afp_tpu/engine/engine.py:103-116,
202-252`): the host frontend (`runtime/asrc.py`) converts source-rate
pushes of any length on the engine's device and regroups them into engine
blocks; :meth:`StreamEngine.process_source_block` returns a block when one
is ready, :meth:`StreamEngine.drain_source_blocks` every block a push
completes, and a full output queue drops the incoming block and counts it.

Under ``waterfall_enabled`` the state carries the waterfall ring on the
device and :meth:`StreamEngine.waterfall_ring` fetches it.  Like the rest
of the state, the ring stays that of the last good block on a ladder
event, survives a dynamic `apply_config` and restarts primed on a rebuild.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from ..ops.agc import AGCParams
from ..utils import trace
from ..utils.log import RateLimited, get_logger
from ..utils.staging import to_device
from .config import PipelineParams, StreamConfig
from .metrics import EngineMetrics
from .pipeline import DeviceParams, Pipeline, StreamState

logger = get_logger("engine")
_rate = RateLimited(logger)

__all__ = ["StreamEngine"]

#: last-good-block history depth (`stream_process.py:50`).
LAST_GOOD_DEPTH = 4
#: engine blocks the ASRC output queue holds (`afp_tpu/engine/engine.py:116`)
ASRC_QUEUE_DEPTH = 64


def _fallback_params(n_kernel: int, n_bands: int) -> PipelineParams:
    """The reference's design-failure fallback: a 128-tap moving average
    (`stream_process_AGC.py:493-496`), zero-padded to the static kernel
    length; EQ bands pass through with zero gain."""
    k = min(128, n_kernel)
    main = np.zeros(n_kernel, dtype=np.float32)
    main[:k] = 1.0 / k
    eq = np.zeros((n_bands, n_kernel), dtype=np.float32)
    if n_bands:
        eq[:, 0] = 1.0
    return PipelineParams(
        main_taps=main, eq_taps=eq, eq_gains=np.zeros(n_bands, dtype=np.float32))


class StreamEngine:
    """Streaming engine over `cfg.batch` concurrent streams on `device` (the
    card by default; ``device='cpu'`` runs the plain versions).  Per-stream
    banks (`engine/batch.py`) ride :attr:`params` like any parameter bank:
    assign ``engine.params = with_per_stream_gains(engine.pipeline,
    engine.params, gains)`` (or a filter or AGC bank), and
    :meth:`set_eq_gains` then takes [batch, n_bands] gains.
    ``td_precision`` and ``agc_one_kernel`` go to every
    :class:`~afp_tpu_torch.engine.pipeline.Pipeline` the engine builds."""

    def __init__(self, cfg: StreamConfig, *, device="cuda", seed: int = 0,
                 td_precision="B3", agc_one_kernel: bool = False):
        self.cfg = cfg.validate()
        self.device = torch.device(device)
        self._pipe_kw = dict(td_precision=td_precision,
                             agc_one_kernel=agc_one_kernel)
        self.metrics = EngineMetrics(streams=self.cfg.batch)
        self._seed = seed
        # the reference's filter_lock (`stream_process_EQ_GUI.py:50-55`):
        # a dynamic swap is one attribute store; a rebuild replaces
        # pipeline, params and state together
        self._swap_lock = threading.Lock()
        self._build(self.cfg)

    # ---------------- construction / reconfig ----------------

    def _build(self, cfg: StreamConfig) -> None:
        self.pipeline = Pipeline(cfg, self.device, **self._pipe_kw)
        self.cfg = self.pipeline.cfg
        try:
            design = PipelineParams.design(self.cfg)
        except Exception as e:  # design-failure rung of the ladder
            logger.error("Filter design failed (%s); using moving-average fallback", e)
            self.metrics.design_fallbacks += 1
            design = _fallback_params(self.pipeline.n_kernel,
                                      len(self.cfg.eq_bands))
        #: the host-side design (raw taps) behind :attr:`params`
        self.design: PipelineParams = design
        self.params: DeviceParams = self.pipeline.device_params(design)
        self.state: StreamState = self.pipeline.init_state(seed=self._seed)
        self._last_good: deque = deque(maxlen=LAST_GOOD_DEPTH)
        self._in_dtype = np.int16 if self.pipeline._i16_ingest else np.float32
        self._out_dtype = np.int16 if self.pipeline._emit16 else np.float32
        self._block_seconds = self.cfg.blocksize / self.cfg.samplerate
        self._out_shape = (self.cfg.batch, self.pipeline.out_block)
        # block-exact host ASRC (asrc_mode='exact'): the frontend regroups
        # source-rate pushes into engine-rate blocks, converted on the
        # engine's device; the pipeline never sees the rate conversion
        self._asrc_frontend = None
        cfg = self.cfg
        if (cfg.source_samplerate and cfg.source_samplerate != cfg.samplerate
                and cfg.asrc_mode == "exact"):
            from ..runtime.asrc import AsrcFrontend

            self._asrc_frontend = AsrcFrontend(
                cfg.source_samplerate, cfg.samplerate, batch=cfg.batch,
                quality=cfg.resample_quality, device=self.device)
            self._asrc_outq: deque = deque(maxlen=ASRC_QUEUE_DEPTH)
        # lossless arbitrary-frames ingest (process_frames): residual
        # framers created on first use, the output side primed with ONE
        # block of silence (the fixed framing latency)
        self._in_framer = None
        self._out_framer = None

    def apply_config(self, new_cfg: StreamConfig) -> bool:
        """Apply a new configuration.  Returns True if the swap was
        glitch-free (dynamic-only), False if shapes changed and the pipeline
        was rebuilt (stream state resets, like the reference's re-init)."""
        new_cfg = new_cfg.validate()
        if new_cfg.static_key() == self.cfg.static_key():
            try:
                design = PipelineParams.design(new_cfg)
            except Exception as e:
                logger.error("Filter design failed (%s); keeping previous parameters", e)
                self.metrics.design_fallbacks += 1
                return True
            # the new bank, AGC scalars included, is built outside the swap
            # lock (host convolutions and uploads take tens of ms); the swap
            # itself is attribute stores
            params = self.pipeline.device_params(
                design, cfg=new_cfg, agc=AGCParams.from_config(new_cfg))
            with self._swap_lock:
                self.pipeline.refresh_dynamic(new_cfg)
                self.design = design
                self.params = params
                self.cfg = new_cfg
                self._block_seconds = new_cfg.blocksize / new_cfg.samplerate
            return True
        with self._swap_lock:
            self.cfg = new_cfg
            self._build(new_cfg)
        return False

    def set_eq_gains(self, gains) -> None:
        """Live gain update — runtime data only (no redesign, no rebuild):
        [n_bands], or [batch, n_bands] when the live params carry
        per-stream gains (the shape must match the live gains')."""
        g = torch.as_tensor(np.asarray(gains, dtype=np.float32),
                            device=self.device)
        with self._swap_lock:
            if g.shape != self.params.eq_gains.shape:
                raise ValueError(
                    "gain vector length must match the EQ band count")
            self.params = self.params._replace(eq_gains=g)

    # ---------------- block processing with the ladder ----------------

    def process_source_block(self, block: np.ndarray):
        """Block-exact ASRC: push a source-rate block of ANY length and get
        an engine-rate [batch, blocksize] output when one is ready, else
        None (the stream is still buffering).  Without the frontend this is
        :meth:`process_block`."""
        if self._asrc_frontend is None:
            return self.process_block(block)
        self._asrc_drain(block)
        return self._asrc_outq.popleft() if self._asrc_outq else None

    def drain_source_blocks(self, block: np.ndarray) -> list:
        """Push one source-rate block and return EVERY engine block it
        completes: none, one or several (up-conversion completes more
        engine blocks than it is handed).  The lockstep ASRC stream's
        surface: an output exists exactly when a whole converted block
        does, so no underrun blend or silence is fabricated.  Without the
        frontend: one block in, one block out."""
        if self._asrc_frontend is None:
            return [self.process_block(block)]
        self._asrc_drain(block)
        outs = list(self._asrc_outq)
        self._asrc_outq.clear()
        return outs

    def _asrc_drain(self, block: np.ndarray) -> None:
        """Push a source-rate block (any length; the batch coerced, the
        never-raises contract) and process EVERY completed engine block into
        the bounded queue: up-conversion completes more engine blocks than
        calls, so pulling one per call would grow the frontend without
        bound.  A full queue drops the INCOMING block and counts it (the
        reference's put_nowait, `stream_process_AGC.py:198-199`)."""
        block = np.asarray(block, dtype=np.float32)
        B = self.cfg.batch
        if block.ndim == 1:
            block = np.broadcast_to(block[None, :], (B, block.shape[-1]))
        elif block.shape[0] != B:
            fixed = np.zeros((B, block.shape[1]), np.float32)
            b = min(block.shape[0], B)
            fixed[:b] = block[:b]
            block = fixed
        self._asrc_frontend.push(block)
        while True:
            pulled = self._asrc_frontend.pull(self.cfg.blocksize)
            if pulled is None:
                break
            if len(self._asrc_outq) == self._asrc_outq.maxlen:
                self.metrics.drops += 1
                continue
            self._asrc_outq.append(self._process_engine_block(pulled))

    def process_block(self, block: np.ndarray) -> np.ndarray:
        """One [batch, blocksize] block in → [batch, blocksize·r] out
        (numpy; r = upsample_factor under upsampled output, else 1).  Never
        raises once the block has the ingest's dtype: on failure, degrades
        per the reference ladder.  Under exact-mode ASRC the block is
        source-rate and routes through the frontend; while it is still
        buffering the output is the underrun blend
        (:meth:`process_source_block` has the honest Optional)."""
        block = self._coerce_in(block)
        if self._asrc_frontend is not None:
            self._asrc_drain(block)
            if not self._asrc_outq:
                return self.underrun_block()
            return self._asrc_outq.popleft()
        if block.ndim == 1:
            block = block[None, :]
        return self._process_engine_block(block)

    def _coerce_in(self, block) -> np.ndarray:
        """The host block's dtype contract (`afp_tpu/engine/engine.py:273-284`):
        f32 ingest coerces; pcm16 ingest requires int16."""
        block = np.asarray(block)
        if self._in_dtype == np.int16:
            if block.dtype != np.int16:
                raise ValueError(f"ingest='pcm16' engine blocks must be "
                                 f"int16, got {block.dtype}")
            return block
        return np.asarray(block, dtype=np.float32)

    def process_frames(self, chunk: np.ndarray) -> np.ndarray:
        """Lossless arbitrary-frames ingest (`afp_tpu/engine/engine.py:
        286-337`): [batch, n] in → [batch, n·r] out for ANY n (r =
        upsample_factor under upsampled output, else 1), at a fixed
        one-block latency.

        The reference's residual-carrying callback
        (`stream_process_GUI_Presets.py:617-686`) made lossless: samples are
        regrouped into whole blocks, never padded or truncated, so the
        ladder's pad/trim rung fires only on true corruption.  The first
        ``blocksize`` output samples are the silence of the framing latency;
        thereafter output[k] is the processed stream one block late.  The
        residuals ride the transport dtypes (int16 under pcm16 ingest and
        ``emit='pcm16'``).  Exact-mode ASRC takes its chunks through
        :meth:`process_source_block` instead."""
        if self._asrc_frontend is not None:
            raise ValueError(
                "process_frames requires source_samplerate == samplerate; "
                "use process_source_block for exact-mode ASRC (it already "
                "accepts arbitrary chunk lengths)")
        chunk = self._coerce_in(chunk)
        if chunk.ndim == 1:
            chunk = np.broadcast_to(chunk[None, :],
                                    (self.cfg.batch, chunk.shape[-1]))
        if self._in_framer is None:
            from ..runtime.framer import BlockFramer

            self._in_framer = BlockFramer(self.cfg.batch, dtype=self._in_dtype)
            self._out_framer = BlockFramer(self.cfg.batch,
                                           dtype=self._out_dtype)
            self._out_framer.push(np.zeros(self._out_shape,
                                           dtype=self._out_dtype))
        self._in_framer.push(chunk)
        while True:
            blk = self._in_framer.pull(self.cfg.blocksize)
            if blk is None:
                break
            self._out_framer.push(self._process_engine_block(blk))
        # the one-block priming guarantees availability: emitted ≤ r·pushed,
        # buffered = prime + r·bs·floor(pushed/bs) ≥ r·pushed
        r = self._out_shape[1] // self.cfg.blocksize
        out = self._out_framer.pull(chunk.shape[1] * r)
        if out is None:
            raise RuntimeError("framer invariant violated")
        return out

    def _upload(self, block: np.ndarray):
        """A host block on the engine's device: on a card through pinned
        memory (:func:`~afp_tpu_torch.utils.staging.to_device`); on the
        CPU the array itself."""
        if self.device.type != "cuda":
            return block
        return to_device(torch.from_numpy(np.ascontiguousarray(block)),
                         device=self.device)

    def _download(self, out: torch.Tensor) -> np.ndarray:
        """A device output as numpy: on a card through pinned memory, waited
        for on the current stream."""
        if self.device.type != "cuda":
            return out.cpu().numpy()
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        with trace.span("afp.engine.download.wait"):
            torch.cuda.current_stream(self.device).synchronize()
        return host.numpy()

    def _process_engine_block(self, block: np.ndarray) -> np.ndarray:
        """One engine block through the ladder, traced as
        ``afp.engine.block`` around ``afp.engine.upload``, ``.step``,
        ``.download`` and ``.check``."""
        k = self.metrics.blocks_processed
        expected = (self.cfg.batch, self.cfg.blocksize)
        if block.shape != expected:
            # pad/trim rung (`stream_process_EQ.py:110-117`)
            fixed = np.zeros(expected, dtype=self._in_dtype)
            b = min(block.shape[0], expected[0])
            t = min(block.shape[1], expected[1])
            fixed[:b, :t] = block[:b, :t]
            block = fixed
        t0 = time.monotonic()
        with trace.span("afp.engine.block", block=k, blocks=1):
            try:
                with self._swap_lock:
                    pipeline, params, state_in = (self.pipeline, self.params,
                                                  self.state)
                with trace.span("afp.engine.upload", block=k, blocks=1):
                    x = self._upload(block)
                with trace.span("afp.engine.step", block=k, blocks=1):
                    state, out = pipeline.step(params, state_in, x)
                with trace.span("afp.engine.download", block=k, blocks=1):
                    out_np = self._download(out)  # waits for the device
                # int16 output is finite by construction: the rung guards
                # floats
                if out_np.dtype != np.int16:
                    with trace.span("afp.engine.check", block=k, blocks=1):
                        finite = np.all(np.isfinite(out_np))
                    if not finite:
                        raise FloatingPointError("non-finite output")
                with self._swap_lock:
                    if self.pipeline is pipeline:  # drop state if rebuilt
                        self.state = state
                self._last_good.append(out_np)
                busy = time.monotonic() - t0
                self.metrics.record_block(self.cfg.blocksize, busy,
                                          self._block_seconds)
                return out_np
            except Exception as e:  # replay / silence rungs
                _rate.warn("proc_err", "Processing error: %s", e)
                self.metrics.underruns += 1
                if self._last_good:
                    self.metrics.fallback_replays += 1
                    return self._last_good[-1]
                self.metrics.fallback_silence += 1
                return np.zeros(self._out_shape, dtype=self._out_dtype)

    def _scale_out(self, block: np.ndarray, factor: float) -> np.ndarray:
        """Scale an output block in the output dtype: f32 directly, int16
        PCM in float64 and requantized, round half to even
        (`afp_tpu/engine/engine.py:376-383`)."""
        if self._out_dtype == np.int16:
            return np.clip(np.round(factor * block.astype(np.float64)),
                           -32768, 32767).astype(np.int16)
        return (factor * block).astype(np.float32)

    def underrun_block(self) -> np.ndarray:
        """Output to emit when no processed block is ready: the reference's
        0.8·last + 0.2·silence blend (`stream_process_EQ_GUI.py:476-480`)."""
        self.metrics.underruns += 1
        if self._last_good:
            return self._scale_out(self._last_good[-1], 0.8)
        self.metrics.fallback_silence += 1
        return np.zeros(self._out_shape, dtype=self._out_dtype)

    def waterfall_ring(self) -> np.ndarray:
        """The carried spectrum ring on the host, [batch, 50, n_bins] dB,
        newest last (`afp_tpu/engine/engine.py:394-399`); ``ValueError``
        without ``waterfall_enabled``."""
        if self.state.wf is None:
            raise ValueError("waterfall_enabled=False: no on-device ring")
        return self.state.wf.cpu().numpy()

    def process_signal(self, signal: np.ndarray, fold="auto") -> np.ndarray:
        """Whole-signal convenience: [batch, T] → [batch, T''] (whole
        blocks), streamed block by block or folded; ``fold`` as
        :meth:`Pipeline.process_signal`.  Under exact-mode ASRC `signal` is
        source-rate: it streams through the frontend, and every completed
        engine block runs in order (`afp_tpu/engine/engine.py:426-456`)."""
        signal = self._coerce_in(signal)
        if signal.ndim == 1:
            signal = np.broadcast_to(
                signal[None, :], (self.cfg.batch, signal.shape[-1]))
        if self._asrc_frontend is not None:
            self._asrc_frontend.push(signal)
            L = self.cfg.blocksize
            nb = self._asrc_frontend.available() // L
            if nb == 0:
                return np.zeros((self.cfg.batch, 0), dtype=self._out_dtype)
            signal = self._asrc_frontend.pull(nb * L)
        t0 = time.monotonic()
        with self._swap_lock:
            pipeline, params, state_in = self.pipeline, self.params, self.state
        chunk = self._stage_chunk_blocks(signal)
        if chunk is not None and signal.shape[-1] // pipeline.block > chunk:
            state, out = self._process_chunked(pipeline, params, state_in,
                                               signal, chunk, fold)
        else:
            state, out = pipeline.process_signal(params, state_in, signal,
                                                 fold=fold)
        out = out.cpu().numpy()
        with self._swap_lock:
            if self.pipeline is pipeline:
                self.state = state
        busy = time.monotonic() - t0
        n = out.shape[-1]
        self.metrics.record_block(n, busy, n / self.cfg.samplerate)
        return out

    def _process_chunked(self, pipeline: Pipeline, params: DeviceParams,
                         state: StreamState, signal: np.ndarray, chunk: int,
                         fold):
        """:meth:`process_signal` over chunks of `chunk` blocks: on a card
        chunk k+1 is staged in pinned memory and uploaded on a copy stream
        while chunk k computes (`afp_tpu/engine/engine.py:457-500`).  Chunk
        bounds sit on whole blocks and the state threads through, so the
        scan's result is the one-shot scan's bit for bit; the fold runs per
        chunk (bit for bit with dither off on the card; with dither on each
        chunk draws under its own key, another realization of the noise).
        The trailing partial block is dropped, as the one-shot path drops
        it."""
        L = pipeline.block
        nb = signal.shape[-1] // L
        bounds = [(i * L, min(nb, i + chunk) * L) for i in range(0, nb, chunk)]
        cuda = self.device.type == "cuda"
        copy = torch.cuda.Stream(self.device) if cuda else None

        def stage(lo, hi):
            piece = np.ascontiguousarray(signal[:, lo:hi])
            if not cuda:
                return piece, None
            src = torch.from_numpy(piece)
            pinned = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            pinned.copy_(src)
            with torch.cuda.stream(copy):
                dev = pinned.to(self.device, non_blocking=True)
            return dev, copy.record_event()

        outs = []
        nxt = stage(*bounds[0])
        for j in range(len(bounds)):
            x, ev = nxt
            if ev is not None:
                compute = torch.cuda.current_stream(self.device)
                compute.wait_event(ev)
                x.record_stream(compute)  # allocated on the copy stream
            state, y = pipeline.process_signal(params, state, x, fold=fold)
            outs.append(y)
            if j + 1 < len(bounds):  # the next upload runs behind this chunk
                nxt = stage(*bounds[j + 1])
        return state, torch.cat(outs, dim=-1)

    def _stage_chunk_blocks(self, signal: np.ndarray) -> Optional[int]:
        """Blocks per staging chunk for :meth:`_process_chunked`, or None to
        stage the whole signal in one piece.  Opt-in, as in `afp_tpu`
        (``AFP_STAGE_CHUNK_MB=<mb>``, default off): a signal under two
        chunks has nothing to overlap."""
        mb = float(os.environ.get("AFP_STAGE_CHUNK_MB", "0"))
        if mb <= 0:
            return None
        if signal.size * signal.dtype.itemsize <= 2 * mb * 2 ** 20:
            return None
        row_bytes = signal.shape[0] * self.cfg.blocksize * signal.dtype.itemsize
        return max(1, int(mb * 2 ** 20 / max(row_bytes, 1)))

    @contextlib.contextmanager
    def profile(self, logdir: str):
        """A `torch.profiler` trace of the region (counterpart of
        `afp_tpu`'s `jax.profiler.trace`): host and, on a card, device
        activity, written on exit as one Chrome trace
        ``afp_trace_<pid>_<ns>.json`` in `logdir` (open it in Perfetto or
        chrome://tracing).  Usage::

            with engine.profile("traces") as prof:
                engine.process_signal(x)
        """
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(logdir, exist_ok=True)
        with profile(activities=acts) as prof:
            yield prof
        prof.export_chrome_trace(os.path.join(
            logdir, f"afp_trace_{os.getpid()}_{time.time_ns()}.json"))
