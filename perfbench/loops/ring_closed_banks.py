"""A closed loop over `RingServer.stream` whose streams each carry their
own EQ gains: `ring_closed`'s loop, spans and window, with the server
built on per-stream params (``RingServer(params=…)``).  The gains are the
configuration's reference module's draw (`draw_gains(config, seed,
batch)`), so the program runs exactly what the reference checks: a
per-listener EQ farm pushing audio as fast as the card drains it.
"""
from __future__ import annotations

from pathlib import Path

from perfbench.harness.bench import Bench

_BENCH = Bench(Path(__file__).resolve().parents[2])
_CLOSED = _BENCH.loop("ring_closed")

SPANS = _CLOSED.SPANS
warm_blocks = _CLOSED.warm_blocks


def listener_params(ctx, pipe):
    """The pipeline's design with each stream's gains from the reference's
    draw for the run's configuration and seed."""
    from afp_tpu_torch.engine import batch
    from afp_tpu_torch.engine.config import PipelineParams

    gains = _BENCH.reference(ctx.config).draw_gains(ctx.config, ctx.seed,
                                                    pipe.batch)
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    return batch.with_per_stream_gains(pipe, params, gains)


class Session(_CLOSED.Session):
    """`ring_closed.Session` over a server of per-stream params: the same
    warm-up, traced wrappers, window and close."""

    def __init__(self, ctx):
        from afp_tpu_torch.engine import Pipeline
        from afp_tpu_torch.runtime import RingServer

        self.ctx = ctx
        sv = ctx.serving
        self.pipe = Pipeline(ctx.program_config(), ctx.device)
        self.server = RingServer(self.pipe, params=listener_params(ctx, self.pipe),
                                 slots=int(sv["slots"]), chunk=int(sv["chunk"]),
                                 max_inflight=int(sv["max_inflight"]),
                                 seed=ctx.dither_seed,
                                 mega=bool(sv.get("mega", False)))
        self.k = 0  # global index of the next block fed
        for _ in self.server.stream(self._blocks(warm_blocks(sv))):
            pass
        if ctx.tracer.enabled:  # spans around the pump's calls (traced runs)
            srv, tr = self.server, ctx.tracer
            srv._land = tr.wrap("land", srv._land)
            srv._fetch = tr.wrap("fetch", srv._fetch)
            name = "run_ring_mega" if srv.mega else "run_ring"
            setattr(self.pipe, name, tr.wrap("dispatch", getattr(self.pipe, name)))
