"""Host pump for the device-resident serving rings (counterpart of
`afp_tpu/runtime/serving.py`, f32 conv-ring form).

The device side is `Pipeline.run_ring` (one K3 launch per block) or
`Pipeline.run_ring_mega` (one K4 launch per chunk): a dispatch advances
`chunk` blocks around a preallocated f32 input ring, writing the output
ring's slots in place.  This module is the pump:

1. land incoming [batch, blocksize] blocks in the next input slots (a
   host→device copy through pinned memory),
2. dispatch the chunk, starting at its first slot,
3. copy the chunk's output slots to pinned host memory right behind the
   dispatch, and hand them to the caller up to `max_inflight` chunks later.

Everything rides PyTorch's current stream, in order.  That is what makes
the in-place rings safe: a chunk's output copy is enqueued before any later
dispatch that could rewrite those slots, and a refill is enqueued after the
dispatch that read the slot it overwrites.  ``(max_inflight + 1) * chunk ≤
slots`` keeps refills away from slots whose output is still undrained.

Not in this slice: the spectrum tap (``spectrum_every``, ROADMAP.md §1
item 4) and stream packing for per-stream banks (``packing``, item 7).
"""
from __future__ import annotations

import time
import threading
from collections import deque
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from ..engine.config import PipelineParams, StreamConfig
from ..engine.pipeline import DeviceParams, Pipeline, StreamState, _not_in_slice
from ..utils.log import get_logger

logger = get_logger("serving")

__all__ = ["RingServer"]


class RingServer:
    """Sustained-throughput serving over device rings.

    Parameters are `afp_tpu`'s: `pipeline` (needs ``supports_ring_step``),
    `params` (defaults to the pipeline's own design), `slots` (ring depth),
    `chunk` (blocks per dispatch; divides `slots`), `max_inflight` (chunks
    dispatched ahead of the oldest undrained one), `seed`, and `mega`
    (dispatch each chunk as one K4 launch instead of one K3 launch per
    block — same outputs, bit for bit).
    """

    def __init__(self, pipeline: Pipeline,
                 params: Optional[DeviceParams] = None,
                 slots: int = 16, chunk: int = 4,
                 max_inflight: int = 2, seed: int = 0,
                 mega: bool = False, packing=None,
                 spectrum_every: int = 0, spectrum_row: int = 0):
        if packing is not None:
            raise _not_in_slice("RingServer(packing=...)",
                                "7 (per-stream banks)")
        if spectrum_every:
            raise _not_in_slice("RingServer(spectrum_every>0)",
                                "4 (serving: the spectrum tap)")
        if not pipeline.supports_ring_step:
            raise ValueError(
                "RingServer requires a ring-capable pipeline: the f32 conv "
                "ring, conv_strategy='td_mxu' (see Pipeline.supports_ring_step)")
        if slots % chunk:
            raise ValueError(f"chunk {chunk} must divide slots {slots}")
        if max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        if (max_inflight + 1) * chunk > slots:
            raise ValueError(
                f"(max_inflight+1)*chunk = {(max_inflight + 1) * chunk} "
                f"exceeds slots {slots}: refills would overwrite undrained "
                "output slots")
        B, T = pipeline.batch, pipeline.block
        if not 0 <= int(spectrum_row) < B:
            raise ValueError(
                f"spectrum_row {spectrum_row} out of range for batch {B}")
        self.mega = bool(mega)
        self.pipe = pipeline
        #: reconfig (control thread) vs dispatch (serving thread): a swap
        #: takes effect at the next chunk boundary, never mid-chunk
        self._swap_lock = threading.Lock()
        self.params = params if params is not None else (
            pipeline.device_params(PipelineParams.design(pipeline.cfg)))
        self.K = slots
        self.chunk = chunk
        self.max_inflight = max_inflight
        self._state: StreamState = pipeline.init_state(seed=seed)
        dev = pipeline.device
        self._cuda = dev.type == "cuda"
        self._ring = torch.zeros((slots, B, T), dtype=torch.float32, device=dev)
        self._out = torch.zeros((slots, B, T), dtype=torch.float32, device=dev)
        self.blocks_served = 0
        #: blocks landed into input slots so far
        self.blocks_landed = 0
        #: land→drain wall latency per served block (host clock, recent window)
        self._latencies: deque = deque(maxlen=65536)

    # -------------------------------------------------- live reconfiguration

    def swap_params(self, new_params: DeviceParams) -> None:
        """Atomically swap the parameter bank mid-serve.  Takes effect at the
        next dispatch (every block of a chunk runs one bank); chunks in
        flight keep the old one.  The carried tail is pure input history,
        so post-swap outputs equal a stream that ran the new bank from the
        start.  Shapes must not change."""
        old = self.params
        for name, o, n in zip(old._fields, old, new_params):
            if (o is None) != (n is None):
                raise ValueError(
                    f"swap_params: field {name!r} changes presence — "
                    "structural changes need a new RingServer")
            if o is None:
                continue
            if o.shape != n.shape or o.dtype != n.dtype:
                raise ValueError(
                    f"swap_params: field {name!r} changes shape/dtype "
                    f"{tuple(o.shape)}/{o.dtype} → {tuple(n.shape)}/{n.dtype}"
                    " — swaps must preserve shapes")
        with self._swap_lock:
            self.params = new_params

    def set_eq_gains(self, gains) -> None:
        """Live gain-only update, same chunk-boundary atomicity as
        :meth:`swap_params`."""
        g = torch.as_tensor(np.asarray(gains, dtype=np.float32),
                            device=self.pipe.device)
        with self._swap_lock:
            if g.shape != self.params.eq_gains.shape:
                raise ValueError(
                    "gain vector length must match the EQ band count")
            self.params = self.params._replace(eq_gains=g)

    def retune(self, new_cfg: StreamConfig) -> None:
        """Design a new bank from `new_cfg` (dynamic fields only) on the
        caller's thread and :meth:`swap_params` it in.  Static (shape)
        changes are rejected."""
        new_cfg = new_cfg.validate()
        if new_cfg.static_key() != self.pipe.cfg.static_key():
            raise ValueError(
                "retune is dynamic-only (same static_key); shape changes "
                "need a new Pipeline + RingServer")
        params = self.pipe.device_params(PipelineParams.design(new_cfg),
                                         cfg=new_cfg)
        self.pipe.refresh_dynamic(new_cfg)
        self.swap_params(params)

    # -------------------------------------------------- core pump

    def _land(self, slot: int, block) -> None:
        """Copy one [batch, blocksize] block into input slot `slot`."""
        src = torch.as_tensor(np.asarray(block, dtype=np.float32))
        if src.shape != self._ring.shape[1:]:
            raise ValueError(f"blocks must be {tuple(self._ring.shape[1:])}, "
                             f"got {tuple(src.shape)}")
        if self._cuda:
            # through pinned memory, so the copy queues behind the stream
            # instead of waiting for it (the host allocator keeps the
            # staging buffer until the copy has run)
            staged = torch.empty(src.shape, dtype=torch.float32, pin_memory=True)
            staged.copy_(src)
            self._ring[slot].copy_(staged, non_blocking=True)
        else:
            self._ring[slot].copy_(src)

    def _fetch(self, slot: int, n: int):
        """Queue the copy of output slots [slot, slot+n) to the host; returns
        (host tensor, event marking its completion or None)."""
        view = self._out[slot:slot + n]
        if not self._cuda:
            return view.clone(), None  # later dispatches rewrite these slots
        host = torch.empty(view.shape, dtype=view.dtype, pin_memory=True)
        host.copy_(view, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return host, ev

    def stream(self, source: Iterable) -> Iterator[np.ndarray]:
        """Pump `source` (an iterable of [batch, blocksize] f32 blocks)
        through the rings; yield one [batch, blocksize] output per input
        block, in order.  A short final chunk is served as is."""
        inflight: list = []
        land_ts: list[float] = []  # land time per pending block
        slot = 0
        pending = 0
        src = iter(source)
        exhausted = False
        while not exhausted or inflight or pending:
            while not exhausted and pending < self.chunk:
                try:
                    block = next(src)
                except StopIteration:
                    exhausted = True
                    break
                self._land(slot + pending, block)
                land_ts.append(time.perf_counter())
                pending += 1
                self.blocks_landed += 1
            if pending and (pending == self.chunk or exhausted):
                dispatch = (self.pipe.run_ring_mega if self.mega
                            else self.pipe.run_ring)
                with self._swap_lock:  # one bank for the whole chunk
                    params = self.params
                self._state, self._out = dispatch(
                    params, self._state, self._ring, None, self._out,
                    pending, start=slot)
                inflight.append((*self._fetch(slot, pending), land_ts))
                land_ts = []
                slot = (slot + self.chunk) % self.K
                pending = 0
            limit = 0 if exhausted else self.max_inflight
            while len(inflight) > limit:
                host, ev, ts = inflight.pop(0)
                if ev is not None:
                    ev.synchronize()
                arr = host.numpy()
                now = time.perf_counter()
                self._latencies.extend(now - t for t in ts)
                self.blocks_served += arr.shape[0]
                yield from arr

    def serve(self, source: Iterable,
              sink: Callable[[np.ndarray], None]) -> dict:
        """Pump the whole `source` through :meth:`stream` into `sink`;
        return simple throughput metrics (host clock)."""
        t0 = time.perf_counter()
        n = 0
        for out in self.stream(source):
            sink(out)
            n += 1
        wall = time.perf_counter() - t0
        cfg = self.pipe.cfg
        audio_s = n * self.pipe.batch * self.pipe.block / cfg.samplerate
        xrt = audio_s / wall if wall > 0 else float("inf")
        logger.info("served %d blocks, %.1f xRT", n, xrt)
        return {"blocks": n, "wall_s": wall, "xrt": xrt,
                "latency": self.latency_stats()}

    def latency_stats(self) -> dict:
        """Land→drain wall latency over the most recent served blocks:
        {n, p50_ms, p95_ms, max_ms, mean_ms} (zeros when empty)."""
        lat = np.asarray(self._latencies, dtype=np.float64)
        if not lat.size:
            return {"n": 0, "p50_ms": 0.0, "p95_ms": 0.0, "max_ms": 0.0,
                    "mean_ms": 0.0}
        q = np.quantile(lat, [0.5, 0.95])
        return {"n": int(lat.size),
                "p50_ms": float(q[0] * 1e3), "p95_ms": float(q[1] * 1e3),
                "max_ms": float(lat.max() * 1e3),
                "mean_ms": float(lat.mean() * 1e3)}

    @property
    def state(self) -> StreamState:
        """The carried state (conv tail, dither seed and block counter)."""
        return self._state
