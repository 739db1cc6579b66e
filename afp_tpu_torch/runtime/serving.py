"""Host pump for the device-resident serving rings (counterpart of
`afp_tpu/runtime/serving.py`: the conv rings and the AGC chain over one
input ring).

The device side is `Pipeline.run_ring` (one K3, K12 or K13 launch per
block; with AGC, K5 → K6 → K7 per block) or `Pipeline.run_ring_mega` (one
K4, K12 or K13 launch per chunk, no AGC): a dispatch advances `chunk`
blocks around preallocated input rings, writing the output ring's slots in
place.  The rings take the pipeline's transport forms: one f32 input ring,
one raw int16 PCM ring (``ingest='pcm16'``: half the ingest bytes), or the
bf16 (hi, lo) pair rings (``ingest='pair'``); the output ring is int16
under ``emit='pcm16'`` (half the drain bytes).  This module is the pump:

1. land incoming [batch, blocksize] blocks in the next input slots (a
   host→device copy through pinned memory),
2. dispatch the chunk, starting at its first slot,
3. copy the chunk's output slots to pinned host memory right behind the
   dispatch, and hand them to the caller up to `max_inflight` chunks later.

Every landing (one-device, per shard, each half of a pair, into packing's
staging) goes through `utils/staging.py:to_device`, which stages a host
buffer of ``NATIVE_MIN_BYTES`` and up (C5's f32 blocks) with the native
copy and a smaller one with ``copy_``, into pinned buffers that PyTorch's
caching host allocator keeps until their host→device copy has run.

Everything rides PyTorch's current stream, in order.  That is what makes
the in-place rings safe: a chunk's output copy is enqueued before any later
dispatch that could rewrite those slots, and a refill is enqueued after the
dispatch that read the slot it overwrites.  ``(max_inflight + 1) * chunk ≤
slots`` keeps refills away from slots whose output is still undrained.

With ``packing`` (the :class:`~afp_tpu_torch.engine.batch.StreamPacking`
of a per-stream filter bank) the caller's blocks land in device order and
the outputs drain in caller order (`afp_tpu/runtime/serving.py:143-147,
342-344, 419-420`): both permutations are gathers on the device, one into
the input slot after the host→device copy and one out of the output slots
before the device→host copy, never a host gather of the block.  Their
device staging (one landed block per dtype, one drained chunk) is allocated
once and reused: the copies and gathers ride one stream in order.

A :class:`~afp_tpu_torch.parallel.ShardedPipeline` is served as is
(`afp_tpu/runtime/serving.py:69-71, 162-166`): the rings follow its
published ``ring_layout``, one [slots, B/n, blocksize] ring per shard,
contiguous on its shard's device, so each shard's ring kernels read and
write their own ring in place.  A block lands as one host→device copy per
shard (its rows), and a chunk drains as one device→host copy per shard and
slot into one pinned host buffer.  Packing needs the one-device rings (its
gathers span the whole batch) and is refused there.

The drain-side spectrum tap (``spectrum_every``,
`afp_tpu/runtime/serving.py:98-123, 312-335`) observes every Nth drained
block on the host, with numpy: the block is already host-resident, so the
tap adds no device work and leaves the served outputs as they were.
"""
from __future__ import annotations

import time
import threading
from collections import deque
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from ..engine.batch import StreamPacking
from ..engine.config import PipelineParams, StreamConfig
from ..engine.pipeline import DeviceParams, Pipeline, StreamState, bf16_tensor
from ..ops.agc import AGCParams
from ..ops.cuda.fir_td import split_bf16
from ..ops.spectrum import WATERFALL_DEPTH, spectrum_db_np, spectrum_freqs
from ..utils import trace
from ..utils.log import get_logger
from ..utils.staging import to_device

logger = get_logger("serving")

__all__ = ["RingServer"]


class RingServer:
    """Sustained-throughput serving over device rings.

    Parameters are `afp_tpu`'s: `pipeline` (needs ``supports_ring_step``),
    `params` (defaults to the pipeline's own design), `slots` (ring depth),
    `chunk` (blocks per dispatch; divides `slots`), `max_inflight` (chunks
    dispatched ahead of the oldest undrained one), `seed`, `mega`
    (dispatch each chunk as one K4 launch instead of one K3 launch per
    block — same outputs, bit for bit), and `packing` (a `StreamPacking`:
    the caller sees its own stream order; an identity packing is None).
    The pipeline's options ride along: with ``agc_one_kernel`` its AGC ring
    step is K14 → K7; a ``td_precision='HIGHEST'`` pipeline, or one with
    the waterfall, has no ring form and is refused, as in `afp_tpu`.
    Per-stream EQ gains (`params` with [batch, n_bands] ``eq_gains``) are
    served on the AGC ring (K5 → K6 → K11 pair-to-ring,
    :meth:`set_eq_gains` swapping each listener's gains at a chunk
    boundary); with `mega`, without AGC, under pair ingest, beside a
    filter bank, with a `packing` or over a sharded pipeline they are
    refused here.

    `pipeline` may also be a `ShardedPipeline` (no `packing`): the rings
    then follow its ``ring_layout``.

    `spectrum_every` (the drain-side tap; 0 disables it, and it may be set
    after construction): every Nth drained block, the host-FFT dB spectrum
    (`spectrum_db_np`) of row `spectrum_row` is pushed into the server's
    own depth-50 :attr:`waterfall_ring` (newest last) and read out as
    :attr:`last_spectrum` and :attr:`spectrum_peak`; :attr:`spectrum_sink`,
    when set, also receives the observed f32 [batch, L] block (int16
    output dequantized ``n/32768``).
    """

    def __init__(self, pipeline: Pipeline,
                 params: Optional[DeviceParams] = None,
                 slots: int = 16, chunk: int = 4,
                 max_inflight: int = 2, seed: int = 0,
                 mega: bool = False, packing=None,
                 spectrum_every: int = 0, spectrum_row: int = 0):
        if not pipeline.supports_ring_step:
            raise ValueError(
                "RingServer requires a ring-capable pipeline: the f32 conv "
                "ring, conv_strategy='td_mxu' with a bf16-class td_precision, "
                "waterfall disabled (see Pipeline.supports_ring_step)")
        if mega and pipeline.cfg.agc_enabled:
            raise ValueError("mega=True has no fused-AGC form: the AGC chain "
                             "serves through run_ring (mega=False)")
        B, T = pipeline.batch, pipeline.block
        if slots % chunk:
            raise ValueError(f"chunk {chunk} must divide slots {slots}")
        if max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        if (max_inflight + 1) * chunk > slots:
            raise ValueError(
                f"(max_inflight+1)*chunk = {(max_inflight + 1) * chunk} "
                f"exceeds slots {slots}: refills would overwrite undrained "
                "output slots")
        if not 0 <= int(spectrum_row) < B:
            raise ValueError(
                f"spectrum_row {spectrum_row} out of range for batch {B}")
        self.mega = bool(mega)
        self.pipe = pipeline
        #: stream→tile design packing (None, or identity → no-op): pack at
        #: ingest, unpack on drain, on the device
        self.packing = None
        if packing is not None:
            if not isinstance(packing, StreamPacking) or not np.array_equal(
                    np.sort(packing.perm), np.arange(B)):
                raise ValueError(
                    f"packing must be a StreamPacking over the batch of {B} "
                    f"streams, got {packing!r}")
            if not packing.identity:
                self.packing = packing
        #: a sharded pipeline's per-shard ring placement, or None
        self._layout = getattr(pipeline, "ring_layout", None)
        if self._layout is not None and self.packing is not None:
            raise ValueError(
                "packing is not supported over a sharded pipeline (its "
                "gathers span the whole batch): pack the streams before "
                "they reach the server")
        #: reconfig (control thread) vs dispatch (serving thread): a swap
        #: takes effect at the next chunk boundary, never mid-chunk
        self._swap_lock = threading.Lock()
        self.params = params if params is not None else (
            pipeline.device_params(PipelineParams.design(pipeline.cfg)))
        # per-stream EQ gains ride the AGC ring alone: refused here, not at
        # the first dispatch
        pipeline.check_ring_params(
            self.params, "run_ring_mega" if self.mega else "ring_step")
        if self.packing is not None and self.params.eq_gains.ndim == 2:
            raise ValueError(
                "per-stream EQ gains are not served with a packing: it moves "
                "the streams' data into device order, not their params")
        self.K = slots
        self.chunk = chunk
        self.max_inflight = max_inflight
        self._state: StreamState = pipeline.init_state(seed=seed)
        dev = pipeline.device
        self._cuda = dev.type == "cuda"

        def ring(dtype):
            if self._layout is not None:
                return self._layout.zeros(slots, T, dtype)
            return torch.zeros((slots, B, T), dtype=dtype, device=dev)

        #: the rings by form (`afp_tpu/runtime/serving.py:170-192`)
        pair = pipeline._pair_ingest
        self._ring = ring(torch.bfloat16 if pair else pipeline.in_dtype)
        self._ring_lo = ring(torch.bfloat16) if pair else None
        self._out = ring(pipeline.out_dtype)
        #: packing's device staging: landed blocks by dtype, a drained chunk
        self._stage_in: dict = {}
        self._stage_out = (torch.empty((chunk, B, T), dtype=pipeline.out_dtype,
                                       device=dev)
                           if self.packing is not None and self._cuda else None)
        self.blocks_served = 0
        #: blocks landed into input slots so far
        self.blocks_landed = 0
        #: source→drain wall latency per served block (host clock, recent
        #: window)
        self._latencies: deque = deque(maxlen=65536)
        #: the drain-side spectrum tap (see the class docstring)
        self.spectrum_every = int(spectrum_every)
        self.spectrum_row = int(spectrum_row)
        self.spectrum_sink: Optional[Callable[[np.ndarray], None]] = None
        self.waterfall_ring: Optional[np.ndarray] = None  # [50, n_bins]
        self.last_spectrum: Optional[np.ndarray] = None  # [n_bins] dB
        self.spectrum_peak: Optional[tuple] = None  # (freq_hz, level_db)

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
        :meth:`swap_params`: the shared [n_bands] vector, or under per-stream
        params each listener's [batch, n_bands] matrix (the shape the
        server's params carry)."""
        g = torch.as_tensor(np.asarray(gains, dtype=np.float32),
                            device=self.pipe.device)
        with self._swap_lock:
            if g.shape != self.params.eq_gains.shape:
                raise ValueError(
                    "gain vector length must match the EQ band count, in "
                    f"the served params' shape {tuple(self.params.eq_gains.shape)}"
                    f", got {tuple(g.shape)}")
            self.params = self.params._replace(eq_gains=g)

    def retune(self, new_cfg: StreamConfig) -> None:
        """Design a new bank from `new_cfg` (dynamic fields only, the AGC
        knobs included) on the caller's thread and :meth:`swap_params` it
        in.  Static (shape) changes are rejected."""
        new_cfg = new_cfg.validate()
        if new_cfg.static_key() != self.pipe.cfg.static_key():
            raise ValueError(
                "retune is dynamic-only (same static_key); shape changes "
                "need a new Pipeline + RingServer")
        params = self.pipe.device_params(PipelineParams.design(new_cfg),
                                         cfg=new_cfg,
                                         agc=AGCParams.from_config(new_cfg))
        self.pipe.refresh_dynamic(new_cfg)
        self.swap_params(params)

    # -------------------------------------------------- spectrum tap

    def _tap_spectrum(self, block: np.ndarray) -> None:
        """Observe one drained [batch, L] block: the host-FFT dB of the
        chosen row into the depth-50 ring and the peak readout; the f32
        block to `spectrum_sink` when set."""
        if block.dtype == np.int16:  # emit='pcm16': dequantize (exact)
            block = block.astype(np.float32) / np.float32(32768.0)
        db = spectrum_db_np(block[self.spectrum_row])
        if (self.waterfall_ring is None
                or self.waterfall_ring.shape[-1] != db.shape[-1]):
            self.waterfall_ring = np.full(
                (WATERFALL_DEPTH, db.shape[-1]), -200.0, dtype=np.float32)
        self.waterfall_ring = np.roll(self.waterfall_ring, -1, axis=0)
        self.waterfall_ring[-1] = db
        self.last_spectrum = db
        freqs = spectrum_freqs(block.shape[-1], self.pipe.cfg.samplerate)
        i = int(np.argmax(db))
        self.spectrum_peak = (float(freqs[i]), float(db[i]))
        if self.spectrum_sink is not None:
            self.spectrum_sink(block)

    # -------------------------------------------------- core pump

    def _copy_in(self, dst: torch.Tensor, src: torch.Tensor) -> None:
        """Copy a host block into the device tensor `dst`
        (:func:`~afp_tpu_torch.utils.staging.to_device`: through pinned
        memory on a card)."""
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"blocks must be {tuple(dst.shape)}, "
                             f"got {tuple(src.shape)}")
        to_device(src, dst)

    def _land(self, slot: int, block) -> None:
        """Copy one [batch, blocksize] block into input slot `slot` in the
        pipeline's transport form (`afp_tpu/runtime/serving.py:339-363`):
        int16 PCM under pcm16 ingest (floats are refused, never silently
        quantized); under pair ingest a ``(hi, lo)`` pair as given, or an
        f32 block split on the device; else f32.  With a packing the block
        is gathered into device order on the device; over a sharded
        pipeline each shard's rows land in its own ring.  Traced as
        ``afp.serve.land``."""
        with trace.span("afp.serve.land", block=self.blocks_landed,
                        blocks=1):
            pair = self.pipe._pair_ingest and isinstance(block,
                                                         (tuple, list))
            if self._layout is None:
                self._land_rows(self._ring, self._ring_lo, slot, block, pair)
                return
            if not pair and not isinstance(block, torch.Tensor):
                block = np.asarray(block)
            for i, (r0, r1) in enumerate(self._layout.rows):
                rows = (tuple(h[r0:r1] for h in block) if pair
                        else block[r0:r1])
                lo = None if self._ring_lo is None else self._ring_lo[i]
                self._land_rows(self._ring[i], lo, slot, rows, pair)

    def _land_rows(self, ring, ring_lo, slot: int, block, pair: bool) -> None:
        """:meth:`_land` into the ring `ring` (and `ring_lo`)."""
        pipe = self.pipe
        if pair:
            for dst, half in zip((ring[slot], ring_lo[slot]), block):
                self._put(dst, bf16_tensor(half, "cpu"))
            return
        if pipe._i16_ingest:
            src = torch.as_tensor(np.asarray(block))
            if src.dtype != torch.int16:
                raise ValueError(
                    f"pcm16 RingServer blocks must be int16, got {src.dtype}")
        else:
            src = torch.as_tensor(np.asarray(block, dtype=np.float32))
        if not pipe._pair_ingest:
            self._put(ring[slot], src)
            return
        x = torch.empty(ring.shape[1:], dtype=torch.float32,
                        device=ring.device)
        self._put(x, src)
        hi, lo = split_bf16(x)
        ring[slot].copy_(hi)
        ring_lo[slot].copy_(lo)
        if self._cuda:  # the split's 14 elementwise kernels and 2 copies
            trace.add(ops=16)

    def _put(self, dst: torch.Tensor, src: torch.Tensor) -> None:
        """Land the host block `src` in the device tensor `dst`, gathered
        into device order when the server packs (the copy lands in the
        staging block of its dtype, then one ``index_select`` fills
        `dst`)."""
        if self.packing is None:
            self._copy_in(dst, src)
            return
        staging = self._stage_in.get(src.dtype)
        if staging is None:
            staging = self._stage_in[src.dtype] = torch.empty(
                dst.shape, dtype=src.dtype, device=dst.device)
        self._copy_in(staging, src)
        torch.index_select(staging, 0,
                           self.packing.index("perm", staging.device), out=dst)
        if self._cuda:
            trace.add(ops=1)

    def _fetch(self, slot: int, n: int):
        """Queue the copy of output slots [slot, slot+n) to the host; returns
        (host tensor, the events marking its completion: one per card, none
        on the CPU).  Traced as ``afp.serve.fetch``."""
        with trace.span("afp.serve.fetch", block=self.blocks_landed - n):
            if self._layout is not None:
                return self._fetch_shards(slot, n)
            view = self._out[slot:slot + n]
            if self.packing is not None:  # restore caller stream order
                view = torch.index_select(
                    view, 1, self.packing.index("inv", view.device),
                    out=None if self._stage_out is None
                    else self._stage_out[:n])
            if not self._cuda:
                trace.add(bytes=view.nbytes)
                return view.clone(), []  # later dispatches rewrite these slots
            host = torch.empty(view.shape, dtype=view.dtype, pin_memory=True)
            host.copy_(view, non_blocking=True)
            trace.add(bytes=view.nbytes, ops=1 + (self.packing is not None))
            ev = torch.cuda.Event()
            ev.record()
            return host, [ev]

    def _fetch_shards(self, slot: int, n: int):
        """:meth:`_fetch` over per-shard rings: each shard's rows of each
        slot in one copy.  A shard's rows of n slots are strided in the
        [n, B, T] host buffer, and torch stages a strided device→host copy
        through a pageable temporary and a host copy, so each copy is one
        contiguous [b, T] slab, landing where the drain reads it."""
        out = self._out
        host = torch.empty((n, self.pipe.batch, out[0].shape[-1]),
                           dtype=out[0].dtype, pin_memory=self._cuda)
        for ring, (r0, r1) in zip(out, self._layout.rows):
            for j in range(n):
                host[j, r0:r1].copy_(ring[slot + j], non_blocking=self._cuda)
        trace.add(bytes=host.nbytes,
                  ops=n * len(self._layout.rows) if self._cuda else 0)
        evs = []
        if self._cuda:
            for d in dict.fromkeys(self._layout.devices):
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(d))
                evs.append(ev)
        return host, evs

    def stream(self, source: Iterable) -> Iterator[np.ndarray]:
        """Pump `source` (an iterable of [batch, blocksize] f32 blocks, int16
        PCM blocks under pcm16 ingest, or bf16 ``(hi, lo)`` pairs under pair
        ingest) through the rings; yield one [batch, blocksize] output per
        input block (int16 under ``emit='pcm16'``), in order.  A short
        final chunk is served as is.  The drain's wait on a chunk's copy is
        traced as ``afp.serve.drain.wait``, closed before the chunk's
        blocks are yielded."""
        inflight: list = []
        taken: list[float] = []  # when each pending block left the source
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
                taken.append(time.perf_counter())
                self._land(slot + pending, block)
                pending += 1
                self.blocks_landed += 1
            if pending and (pending == self.chunk or exhausted):
                dispatch = (self.pipe.run_ring_mega if self.mega
                            else self.pipe.run_ring)
                with self._swap_lock:  # one bank for the whole chunk
                    params = self.params
                self._state, self._out = dispatch(
                    params, self._state, self._ring, self._ring_lo, self._out,
                    pending, start=slot)
                inflight.append((*self._fetch(slot, pending), taken))
                taken = []
                slot = (slot + self.chunk) % self.K
                pending = 0
            limit = 0 if exhausted else self.max_inflight
            while len(inflight) > limit:
                host, evs, ts = inflight.pop(0)
                with trace.span("afp.serve.drain.wait",
                                block=self.blocks_served, blocks=len(ts)):
                    for ev in evs:
                        ev.synchronize()
                arr = host.numpy()
                now = time.perf_counter()
                self._latencies.extend(now - t for t in ts)
                if not self.spectrum_every:
                    self.blocks_served += arr.shape[0]
                    yield from arr
                    continue
                for blk in arr:  # per-block drain: the Nth-block tap
                    if self.blocks_served % self.spectrum_every == 0:
                        self._tap_spectrum(blk)
                    self.blocks_served += 1
                    yield blk

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
        """Wall latency from the block's leaving the source (before it
        lands) to its drain, over the most recent served blocks: {n,
        p50_ms, p95_ms, max_ms, mean_ms} (zeros when empty)."""
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
