"""A closed loop over `RingServer.stream`: the next block is fed as soon as
the pump asks for one, as a mastering or transcoding farm pushes audio as
fast as the card drains it.

The window starts when the first block is offered and stops offering at
`seconds`; the pump then drains what it holds, and the window ends when the
last output is in hand.  ``audio_xrt`` is every stream's seconds of audio
returned in the window over the window's wall seconds (host clock).
"""
from __future__ import annotations

import time

SPANS = ("generate", "stream.next", "sink", "land", "dispatch", "fetch")


def warm_blocks(serving: dict) -> int:
    """Blocks fed before the window: every slot twice and a short final
    chunk, the shapes a window's closing drain uses."""
    return 2 * int(serving["slots"]) + 1


class Session:
    def __init__(self, ctx):
        from afp_tpu_torch.engine import Pipeline
        from afp_tpu_torch.runtime import RingServer

        self.ctx = ctx
        sv = ctx.serving
        self.pipe = Pipeline(ctx.program_config(), ctx.device)
        self.server = RingServer(self.pipe, slots=int(sv["slots"]),
                                 chunk=int(sv["chunk"]),
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

    def _blocks(self, n):
        for _ in range(n):
            blk = self.ctx.block_of(self.k)
            self.k += 1
            yield blk

    def window(self, seconds: float) -> dict:
        ctx, span = self.ctx, self.ctx.tracer.span
        first = self.k
        t0 = time.perf_counter()
        t_stop = t0 + seconds

        def source():
            while True:
                with span("generate"):
                    if time.perf_counter() >= t_stop:
                        return
                    blk = ctx.block_of(self.k)
                    self.k += 1
                yield blk

        got = 0
        it = self.server.stream(source())
        while True:
            with span("stream.next"):
                out = next(it, None)
            if out is None:
                break
            with span("sink"):
                ctx.keeper.offer(first + got, out)
            got += 1
        wall = time.perf_counter() - t0
        fed = self.k - first
        cfg = self.pipe.cfg
        audio_s = got * cfg.batch * cfg.blocksize / cfg.samplerate
        return {"attempted": fed, "returned": got, "unanswered": fed - got,
                "failed": fed - got,
                "e2e": {"audio_xrt": audio_s / wall},
                "report": {"blocks": got, "wall_s": wall,
                           "ms_per_block": 1e3 * wall / max(got, 1)}}

    def close(self) -> None:
        del self.server, self.pipe
