"""StreamEngine — host-side orchestration of the device pipeline
(counterpart of `afp_tpu/engine/engine.py`).

Owns a :class:`~afp_tpu_torch.engine.pipeline.Pipeline`, its parameter bank
and streaming state, and implements the reference's two disciplines on top:

* **Glitch-free live reconfiguration** (`stream_process_EQ_GUI.py:280-306,
  364-388`): `apply_config()` re-designs on the host and swaps the device
  parameter tensors between blocks; only shape changes rebuild the pipeline.
* **Degradation ladder** (`stream_process.py:115-120`,
  `stream_process_AGC.py:493-496`): a failed block replays the last good
  block or emits silence; a failed design substitutes the reference's
  moving-average kernel; an underrun blends ``0.8·last``.  Every event is
  counted in :class:`EngineMetrics` — the ladder swallows exceptions by
  design, so callers that need to know read the counters.

Not in this slice: the host ASRC frontend (`process_source_block`), the
arbitrary-frames framer (`process_frames`), checkpoints and the chunked
upload of `process_signal` (ROADMAP.md §1 item 5).
"""
from __future__ import annotations

import threading
import time
from collections import deque

import numpy as np
import torch

from ..utils.log import RateLimited, get_logger
from .config import PipelineParams, StreamConfig
from .metrics import EngineMetrics
from .pipeline import DeviceParams, Pipeline, StreamState, _not_in_slice

logger = get_logger("engine")
_rate = RateLimited(logger)

__all__ = ["StreamEngine"]

#: last-good-block history depth (`stream_process.py:50`).
LAST_GOOD_DEPTH = 4


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
    """Streaming engine over `cfg.batch` concurrent streams on `device`."""

    def __init__(self, cfg: StreamConfig, *, device, seed: int = 0):
        self.cfg = cfg.validate()
        self.device = torch.device(device)
        self.metrics = EngineMetrics(streams=self.cfg.batch)
        self._seed = seed
        # the reference's filter_lock (`stream_process_EQ_GUI.py:50-55`):
        # a dynamic swap is one attribute store; a rebuild replaces
        # pipeline, params and state together
        self._swap_lock = threading.Lock()
        self._build(self.cfg)

    # ---------------- construction / reconfig ----------------

    def _build(self, cfg: StreamConfig) -> None:
        self.pipeline = Pipeline(cfg, self.device)
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
        self._block_seconds = self.cfg.blocksize / self.cfg.samplerate
        self._out_shape = (self.cfg.batch, self.cfg.blocksize)

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
            # the new bank is built outside the swap lock (host convolutions
            # and uploads take tens of ms); the swap itself is attribute stores
            params = self.pipeline.device_params(design, cfg=new_cfg)
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
        """Live gain update — runtime data only (no redesign, no rebuild)."""
        g = torch.as_tensor(np.asarray(gains, dtype=np.float32),
                            device=self.device)
        with self._swap_lock:
            if g.shape != self.params.eq_gains.shape:
                raise ValueError(
                    "gain vector length must match the EQ band count")
            self.params = self.params._replace(eq_gains=g)

    # ---------------- block processing with the ladder ----------------

    def process_block(self, block: np.ndarray) -> np.ndarray:
        """One [batch, blocksize] block in → [batch, blocksize] out (numpy).
        Never raises: on failure, degrades per the reference ladder."""
        block = np.asarray(block, dtype=np.float32)
        if block.ndim == 1:
            block = block[None, :]
        return self._process_engine_block(block)

    def process_frames(self, chunk: np.ndarray) -> np.ndarray:
        """Arbitrary-length ingest through the residual framer."""
        raise _not_in_slice("StreamEngine.process_frames (the framer)",
                            "5 (StreamEngine)")

    def _process_engine_block(self, block: np.ndarray) -> np.ndarray:
        expected = (self.cfg.batch, self.cfg.blocksize)
        if block.shape != expected:
            # pad/trim rung (`stream_process_EQ.py:110-117`)
            fixed = np.zeros(expected, dtype=np.float32)
            b = min(block.shape[0], expected[0])
            t = min(block.shape[1], expected[1])
            fixed[:b, :t] = block[:b, :t]
            block = fixed
        t0 = time.monotonic()
        try:
            with self._swap_lock:
                pipeline, params, state_in = self.pipeline, self.params, self.state
            state, out = pipeline.step(params, state_in, block)
            out_np = out.cpu().numpy()  # waits for the device
            if not np.all(np.isfinite(out_np)):
                raise FloatingPointError("non-finite output")
            with self._swap_lock:
                if self.pipeline is pipeline:  # drop state if rebuilt mid-block
                    self.state = state
            self._last_good.append(out_np)
            busy = time.monotonic() - t0
            self.metrics.record_block(self.cfg.blocksize, busy, self._block_seconds)
            return out_np
        except Exception as e:  # replay / silence rungs
            _rate.warn("proc_err", "Processing error: %s", e)
            self.metrics.underruns += 1
            if self._last_good:
                self.metrics.fallback_replays += 1
                return self._last_good[-1]
            self.metrics.fallback_silence += 1
            return np.zeros(self._out_shape, dtype=np.float32)

    def underrun_block(self) -> np.ndarray:
        """Output to emit when no processed block is ready: the reference's
        0.8·last + 0.2·silence blend (`stream_process_EQ_GUI.py:476-480`)."""
        self.metrics.underruns += 1
        if self._last_good:
            return (0.8 * self._last_good[-1]).astype(np.float32)
        self.metrics.fallback_silence += 1
        return np.zeros(self._out_shape, dtype=np.float32)

    def process_signal(self, signal: np.ndarray, fold="auto") -> np.ndarray:
        """Whole-signal convenience: [batch, T] → [batch, T''] (whole
        blocks), streamed block by block; ``fold`` as
        :meth:`Pipeline.process_signal`."""
        signal = np.asarray(signal, dtype=np.float32)
        if signal.ndim == 1:
            signal = np.broadcast_to(
                signal[None, :], (self.cfg.batch, signal.shape[-1]))
        t0 = time.monotonic()
        with self._swap_lock:
            pipeline, params, state_in = self.pipeline, self.params, self.state
        state, out = pipeline.process_signal(params, state_in, signal, fold=fold)
        out = out.cpu().numpy()
        with self._swap_lock:
            if self.pipeline is pipeline:
                self.state = state
        busy = time.monotonic() - t0
        n = out.shape[-1]
        self.metrics.record_block(n, busy, n / self.cfg.samplerate)
        return out
