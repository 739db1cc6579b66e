"""An open loop over `StreamEngine.process_block`: block i is due at
t0 + i·blocksize/samplerate, the stream's own block period, as live
conferencing or broadcast audio arrives and as the upstream project's
audio callback fires.

Each block's latency runs from when it was due to when its output is in
hand, so a stall delays every later block and that wait counts.  A block
whose output returns later than one block period after it was due is a
dropout; it and every ladder event of the engine (the underrun count,
which each replay or silence raises once) count in ``failed``.
``block_p95_ms`` is the nearest-rank 95th percentile over every block of
the window.  The loop waits for a due time by sleeping to a millisecond
before it and spinning the rest.
"""
from __future__ import annotations

import time

from perfbench.harness import stats

SPANS = ("wait", "process_block", "sink", "upload", "step", "download")
#: spin instead of sleeping for the last this many seconds before a due time
SPIN_S = 1e-3


def _wait_until(t: float) -> None:
    rest = t - time.perf_counter()
    if rest > SPIN_S:
        time.sleep(rest - SPIN_S)
    while time.perf_counter() < t:
        pass


def warm_blocks(serving: dict) -> int:
    """Blocks processed before the window."""
    return int(serving.get("warm_blocks", 4))


class Session:
    def __init__(self, ctx):
        from afp_tpu_torch.engine import StreamEngine

        self.ctx = ctx
        self.eng = StreamEngine(ctx.program_config(), device=ctx.device,
                                seed=ctx.dither_seed)
        self.k = 0
        for _ in range(warm_blocks(ctx.serving)):
            self.eng.process_block(ctx.block_of(self.k))
            self.k += 1
        if ctx.tracer.enabled:  # spans around the engine's calls (traced runs)
            eng, tr = self.eng, ctx.tracer
            eng._upload = tr.wrap("upload", eng._upload)
            eng._download = tr.wrap("download", eng._download)
            eng.pipeline.step = tr.wrap("step", eng.pipeline.step)

    def window(self, seconds: float) -> dict:
        ctx, span, eng = self.ctx, self.ctx.tracer.span, self.eng
        cfg = eng.cfg
        period = cfg.blocksize / cfg.samplerate
        n = max(1, int(seconds / period))
        m = eng.metrics
        busy0, under0 = m.busy_seconds, m.underruns
        due, start, done, failed = [], [], [], 0
        t0 = time.perf_counter() + SPIN_S
        for i in range(n):
            d = t0 + i * period
            with span("wait"):
                _wait_until(d)
            s = time.perf_counter()
            under = m.underruns
            with span("process_block"):
                out = eng.process_block(ctx.block_of(self.k))
            e = time.perf_counter()
            with span("sink"):
                ctx.keeper.offer(self.k, out)
            self.k += 1
            due.append(d)
            start.append(s)
            done.append(e)
            if e - d > period or m.underruns != under:
                failed += 1
        lat = stats.open_loop_latencies(due, done)
        late = [s - d for d, s in zip(due, start)]
        return {"attempted": n, "returned": n, "unanswered": 0, "failed": failed,
                "e2e": {"block_p95_ms": 1e3 * stats.percentile(lat, 95)},
                "extra": {"engine_busy_s": m.busy_seconds - busy0},
                "report": {"blocks": n, "period_ms": 1e3 * period,
                           "p50_ms": 1e3 * stats.percentile(lat, 50),
                           "p95_ms": 1e3 * stats.percentile(lat, 95),
                           "max_ms": 1e3 * max(lat),
                           "late_p95_ms": 1e3 * stats.percentile(late, 95),
                           "late_max_ms": 1e3 * max(late),
                           "ladder_events": m.underruns - under0,
                           "dropouts": sum(x > period for x in lat)}}

    def close(self) -> None:
        del self.eng
