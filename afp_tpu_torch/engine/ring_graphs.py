"""CUDA graphs of the served AGC ring (`Pipeline.run_ring`'s ``graphs=``).

A `RingServer` dispatches its blocks a chunk at a time, and on the AGC
ring each step of a chunk is three or four launches through Python
wrappers: K5 → K6 → K7 and K7's tail kernel, K11's pair-to-ring form in
K7's place under per-stream EQ gains, or K14 → K7 under the one-kernel
AGC.  :class:`RingGraphs` runs a chunk's steps as one
`torch.cuda.CUDAGraph` instead: the steps themselves
(`Pipeline._agc_ring_chunk`) are captured, so the kernels, their order,
their inputs and their bits are the eager ones.

A chunk is keyed by its first slot, its steps, and the addresses, shapes
and dtypes of the input and output rings.  A key runs the body eagerly
the first time it is dispatched and is captured the second time, then
replayed; so a one-off short final chunk never captures, and a server's
warm-up (two laps of its slots) captures its full chunks.

What a graph reads is static, and is refreshed in stream order before a
replay, never by a capture:

* the state's home: the pair tail's halves and the [B] gain carry, which a
  chunk's first step reads and its last step writes back, and one int32,
  the dither's block counter, which step i reads as ``counter + i`` and
  the last step's tail kernel advances.  A state that is not the home
  (the server's first chunk, or a restored one) is copied in, and the
  counter is filled when the step it holds is not the state's.
* the live taps [n_casc], built once per bank (a new params object:
  `swap_params`, `set_eq_gains`, `retune`), or under per-stream gains the
  band kernels and the [B, n_bands] gains; and the [B] AGC vectors where
  given.

The host AGC scalars are launch arguments, frozen by a capture, as are the
dither's seed, kind and bits and the output clip: they make the setting,
and a new setting drops every graph.  The graphs share one memory pool and
replay on the current stream, in order with the pump's copies; nothing
allocated in the pool outlives a replay.
"""
from __future__ import annotations

import gc
from typing import NamedTuple

import torch

from ..ops.cuda import device_launches
from ..utils import trace
from .pipeline import DeviceParams, Pipeline, StreamState

__all__ = ["RingGraphs"]

_KNOBS = ("agc_target", "agc_max_gain", "agc_a_att", "agc_a_rel")
_M32 = 0xFFFFFFFF
#: device operations `CUDAGraph.capture_begin` runs itself, before it
#: captures: the default CUDA generator's seed and offset fills
_CAPTURE_BEGIN_OPS = 2


class _Graph(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    device: torch.device
    ops: int  # device operations one replay runs

    def replay(self) -> None:
        with torch.cuda.device(self.device):
            self.graph.replay()


class RingGraphs:
    """The CUDA graphs of one server's AGC ring chunks and the static
    buffers they read.  ``captures`` counts the graphs captured and
    ``graphed`` the blocks served by a replay."""

    def __init__(self):
        self._graphs: dict = {}
        self._seen: set = set()
        self._setting = None
        self._bank = None  # the params object the static inputs hold
        self._static = None  # those inputs by field ("taps": the live taps)
        self._params = None  # the bank over the static inputs
        self._taps = None
        self._home = None  # (tail_hi, tail_lo, gain)
        self._counter = None
        self._at = None  # the block counter the device word holds
        self._pool = None
        self._side = None
        self.captures = 0
        self.graphed = 0

    @staticmethod
    def engages(pipe: Pipeline, params: DeviceParams, state: StreamState,
                ring_hi: torch.Tensor, ring_lo) -> bool:
        """True for the AGC ring on a card, with the AGC knobs all host
        scalars or all [B] vectors on the device, and a [B, k_pad] pair
        tail: what a chunk's graph serves."""
        knobs = [getattr(params, k) for k in _KNOBS]
        tail = state.conv_tail
        return (ring_hi.is_cuda and ring_lo is None and pipe._agc_on
                and isinstance(tail, tuple)
                and all(tuple(t.shape) == (pipe.batch, pipe._k_pad)
                        for t in tail)
                and (all(k is not None and k.ndim == 0 and not k.is_cuda
                         for k in knobs)
                     or all(k is not None and k.ndim == 1 and k.is_cuda
                            for k in knobs)))

    def run(self, pipe: Pipeline, params: DeviceParams, state: StreamState,
            ring: torch.Tensor, out_ring: torch.Tensor, n_steps: int,
            start: int):
        """`Pipeline.run_ring` of one chunk through its graph (see the
        module).  Returns (the state, in the home buffers; out_ring)."""
        pipe._check_ring(params, ring, None, out_ring)
        dev = ring.device
        ops = self._bind(pipe, params, state, dev)
        dkw = pipe._dither_kw(state, pipe.cfg.output_clip)
        setting = (dkw["dither_key"][0], dkw["dither_bits"],
                   dkw["dither_tpdf"], dkw["out_clip"], pipe.cfg.agc_carry,
                   tuple(float(k) if k.ndim == 0 else None
                         for k in (getattr(params, n) for n in _KNOBS)))
        if setting != self._setting:
            self._drop()
            self._setting = setting
        start %= ring.shape[0]
        key = (start, n_steps, ring.data_ptr(), tuple(ring.shape), ring.dtype,
               out_ring.data_ptr(), tuple(out_ring.shape), out_ring.dtype)

        def body():
            return pipe._agc_ring_chunk(
                self._params, self._taps, self._home, ring, out_ring, n_steps,
                start, dkw, state.step, self._counter)

        g = self._graphs.get(key)
        if g is None and key in self._seen:
            g = self._graphs[key] = self._capture(body, dev)
        if g is None:
            self._seen.add(key)
            trace.add(ops=ops + body())
        else:
            g.replay()
            self.graphed += n_steps
            trace.add(ops=ops + g.ops, graphed=n_steps)
            if trace.on() and pipe._per_stream(self._params):
                for i in range(n_steps):
                    with pipe._eq_mix_span(self._params, state.step + i):
                        pass
        self._at = state.step + n_steps
        th, tl, gain = self._home
        return (StreamState((th, tl), state.seed, state.step + n_steps, gain),
                out_ring)

    def _drop(self) -> None:
        """Forget every graph and every key seen; the next capture takes a
        new pool (the allocator frees a pool whose graphs are gone)."""
        self._graphs.clear()
        self._seen.clear()
        self._pool = None

    def _bind(self, pipe: Pipeline, params: DeviceParams, state: StreamState,
              dev) -> int:
        """Bring the static inputs up to `params` and `state`, in stream
        order: the bank on a new params object, the home from a state that
        is not in it, the counter where it holds another step.  Returns the
        device operations enqueued (the taps' own two are counted where
        they are built)."""
        ops = 0
        if self._home is None:
            B, kp = pipe.batch, pipe._k_pad
            th = torch.empty((B, kp), dtype=torch.bfloat16, device=dev)
            self._home = (th, torch.empty_like(th),
                          torch.empty(B, dtype=torch.float32, device=dev))
            self._counter = torch.zeros(1, dtype=torch.int32, device=dev)
        if params is not self._bank:
            ops += self._bind_bank(pipe, params)
        for dst, src in zip(self._home, (*state.conv_tail, state.agc_gain)):
            if src is not dst:
                dst.copy_(src)
                ops += 1
        if self._at != state.step:
            v = state.step & _M32
            self._counter.fill_(v - (1 << 32) if v >> 31 else v)
            ops += 1
        return ops

    def _bind_bank(self, pipe: Pipeline, params: DeviceParams) -> int:
        """Copy the bank `params` into the static inputs: the live taps (or
        the band kernels and per-stream gains) and the [B] AGC vectors.
        Inputs of a new shape drop every graph."""
        want = ({"eq_gains": params.eq_gains, "casc_bands": params.casc_bands}
                if pipe._per_stream(params)
                else {"taps": params.combined_cascade(pipe.has_eq)})
        want.update((k, getattr(params, k)) for k in _KNOBS
                    if getattr(params, k).ndim)
        if self._static is None or {k: v.shape for k, v in want.items()} != {
                k: t.shape for k, t in self._static.items()}:
            self._static = {k: torch.empty_like(v) for k, v in want.items()}
            self._drop()
        for k, v in want.items():
            self._static[k].copy_(v)
        held = dict(self._static)
        self._taps = held.pop("taps", None)
        self._params = params._replace(**held)
        self._bank = params
        return len(want)

    def _capture(self, body, dev) -> _Graph:
        """Capture `body` (the chunk's steps) as a graph on a side stream,
        into the server's pool.  The launches it records are not run: the
        counts of the dispatch's span leave them out (and count the capture's
        own fills), and every replay counts them."""
        with torch.cuda.device(dev):
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            if self._side is None:
                self._side = torch.cuda.Stream(dev)
            graph = torch.cuda.CUDAGraph()
            cur = torch.cuda.current_stream(dev)
            self._side.wait_stream(cur)
            n0 = device_launches()
            # no collection inside: one could destroy another graph, which
            # is not permitted while a stream captures
            collecting = gc.isenabled()
            gc.disable()
            try:
                with trace.muted(), torch.cuda.stream(self._side):
                    graph.capture_begin(pool=self._pool,
                                        capture_error_mode="thread_local")
                    try:
                        extra = body()
                    finally:
                        graph.capture_end()
            finally:
                if collecting:
                    gc.enable()
            cur.wait_stream(self._side)
        launched = device_launches() - n0
        trace.add(ops=_CAPTURE_BEGIN_OPS - launched, captures=1)
        self.captures += 1
        return _Graph(graph, dev, launched + extra)
