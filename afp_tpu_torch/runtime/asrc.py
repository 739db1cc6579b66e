"""Streaming ASRC frontend: block-exact arbitrary-rate conversion
(counterpart of `afp_tpu/runtime/asrc.py`).

The reference converts each block on its own and pads or trims it to the
block size (`stream_process_AGC.py:126-129`), with edge artifacts at every
block and a drifting timeline; the pipeline's ``asrc_mode='compat'``
reproduces that.  This frontend (``asrc_mode='exact'``) converts exactly:

* on the device, the streaming :class:`~afp_tpu_torch.ops.resample.
  PolyResampler` at a fixed super-block (`l_dev`, a multiple of the reduced
  decimation factor), whose blocked output equals the one-shot transform;
* on the host, two numpy accumulators regroup source pushes of any size
  into `l_dev` chunks and the engine's block pulls.

Feed `push()` source-rate audio of ANY chunking and `pull()` engine-rate
blocks; any chunking of the pushes gives the same bits as any other.
Latency: the resampler's group delay plus up to one `l_dev` super-block.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..ops.resample import PolyResampler

__all__ = ["AsrcFrontend"]


class AsrcFrontend:
    """Host-buffered exact streaming resampler, source rate → engine rate,
    with the resampler on `device` (the engine's; the card by default, as
    for `Pipeline` and `StreamEngine`)."""

    def __init__(self, source_rate: int, engine_rate: int, batch: int = 1,
                 l_dev: Optional[int] = None, quality: str = "fast",
                 device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "AsrcFrontend: no CUDA device (torch.cuda.is_available() is "
                "False); pass device='cpu' to run on the CPU")
        g = math.gcd(engine_rate, source_rate)
        self.up = engine_rate // g
        self.down = source_rate // g
        self.source_rate = source_rate
        self.engine_rate = engine_rate
        self.batch = batch
        if l_dev is None:
            # a super-block of roughly 4k source samples, divisible by `down`
            l_dev = max(1, round(4096 / self.down)) * self.down
        if l_dev % self.down:
            raise ValueError(f"l_dev must be a multiple of {self.down}")
        self.l_dev = l_dev
        self._state = PolyResampler.init(self.up, self.down, block=l_dev,
                                         batch_shape=(batch,),
                                         quality=quality, device=self.device)
        self._in = np.zeros((batch, 0), dtype=np.float32)
        self._out = np.zeros((batch, 0), dtype=np.float32)

    @property
    def delay_outputs(self) -> int:
        """Engine-rate samples of group delay vs the zero-phase transform."""
        return self._state.delay_outputs

    def push(self, block: np.ndarray) -> None:
        """Append source-rate samples ([batch, n] or [n]); any n."""
        block = np.asarray(block, dtype=np.float32)
        if block.ndim == 1:
            block = np.broadcast_to(block[None, :], (self.batch, block.shape[-1]))
        if block.shape[0] != self.batch:
            raise ValueError(f"expected batch {self.batch}, got {block.shape[0]}")
        self._in = np.concatenate([self._in, block], axis=1)
        n_chunks = self._in.shape[1] // self.l_dev
        if not n_chunks:
            return
        # ONE output concat per push (`afp_tpu/runtime/asrc.py:74-83`): a
        # whole-file push would otherwise rebuild the growing output
        # buffer; the chunks' outputs also come back in one copy
        src = torch.from_numpy(np.ascontiguousarray(
            self._in[:, :n_chunks * self.l_dev])).to(self.device)
        ys = []
        for i in range(n_chunks):
            self._state, y = self._state.process(
                src[:, i * self.l_dev:(i + 1) * self.l_dev])
            ys.append(y)
        # .copy(): the residual must not pin the whole input buffer
        self._in = self._in[:, n_chunks * self.l_dev:].copy()
        self._out = np.concatenate(
            [self._out, torch.cat(ys, dim=-1).cpu().numpy()], axis=1)

    def available(self) -> int:
        return self._out.shape[1]

    def pull(self, n: int) -> Optional[np.ndarray]:
        """Take exactly `n` engine-rate samples, or None if not yet buffered."""
        if self._out.shape[1] < n:
            return None
        out = self._out[:, :n]
        self._out = self._out[:, n:]
        return out

    def get_state(self) -> dict:
        """Snapshot (numpy arrays) for engine checkpointing."""
        return {
            "asrc_in": self._in.copy(),
            "asrc_out": self._out.copy(),
            "asrc_hist": self._state.hist.cpu().numpy(),
        }

    def set_state(self, state: dict) -> None:
        self._in = np.asarray(state["asrc_in"], dtype=np.float32)
        self._out = np.asarray(state["asrc_out"], dtype=np.float32)
        hist = torch.as_tensor(np.array(state["asrc_hist"], dtype=np.float32),
                               device=self.device)
        if hist.shape != self._state.hist.shape:
            raise ValueError(f"asrc_hist must be {tuple(self._state.hist.shape)},"
                             f" got {tuple(hist.shape)}")
        self._state = self._state._replace(hist=hist)

    def flush(self) -> np.ndarray:
        """End of stream: pad the input with enough zeros to flush both the
        residual super-block and the resampler's causal group delay,
        convert, and return all remaining output (`afp_tpu/runtime/
        asrc.py:113-126`)."""
        n_in = self._in.shape[1]
        need_src = -(-int(self._state.delay_outputs) * self.down // self.up)
        pad = -(-(n_in + need_src) // self.l_dev) * self.l_dev - n_in
        if pad:
            self.push(np.zeros((self.batch, pad), dtype=np.float32))
        out = self._out
        self._out = np.zeros((self.batch, 0), dtype=np.float32)
        return out
