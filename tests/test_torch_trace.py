"""The port's spans and counters (`afp_tpu_torch/utils/trace.py`) on the
CPU: off without a profiler, and under `torch.profiler` the records of a
`RingServer` stream and a `StreamEngine` block, their nesting, block ids
and counts, the shared clock with the profiler's events, and the bound."""
import gc
import time

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from afp_tpu_torch.engine import (Pipeline, PipelineParams, StreamConfig,
                                  StreamEngine)
from afp_tpu_torch.runtime import RingServer
from afp_tpu_torch.utils import trace

#: the C5 chain at small size (as `test_torch_serving.py`)
KW = dict(samplerate=44100, blocksize=256, upsample_factor=4, numtaps=63,
          batch=4, cutoff=9000.0, eq_enabled=False, downsample_mode="decimate",
          output_clip=0.5, resample_quality="fast", conv_strategy="td_mxu",
          dither_kind="tpdf", dither_bits=16)
DISPATCH = ("afp.pipe.run_ring", "afp.pipe.run_ring_mega")


@pytest.fixture(autouse=True)
def empty_records():
    trace.clear()
    yield
    trace.clear()


def blocks(n, seed=0, B=4, L=256):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((B, L)) * 0.3).astype(np.float32)
            for _ in range(n)]


def server(mega=False):
    p = Pipeline(StreamConfig(**KW), "cpu")
    params = p.device_params(PipelineParams.design(p.cfg))
    return RingServer(p, params, slots=12, chunk=4, max_inflight=2, seed=3,
                      mega=mega)


def named(recs, name):
    return [(i, r) for i, r in enumerate(recs)
            if r is not None and r[0] == name]


def test_off_without_profiler():
    """No profiler: `span` hands back one shared object, reads no clock,
    and a whole stream leaves no record."""
    assert not trace.on()
    a = trace.span("afp.serve.land", block=7, blocks=1)
    b = trace.span("afp.pipe.run_ring", counter=lambda: 0)
    assert a is b
    with a as inside:
        trace.add(ops=3)
    assert inside is a
    out = list(server().stream(iter(blocks(10))))
    assert len(out) == 10 and trace.records() == [] and trace.dropped() == 0


def test_off_reads_no_clock(monkeypatch):
    def stop():
        raise AssertionError("the clock was read with tracing off")

    monkeypatch.setattr(trace.time, "time_ns", stop)
    with trace.span("afp.serve.fetch", block=1, nbytes=64):
        pass


@pytest.mark.parametrize("mega", [False, True])
def test_stream_records(mega):
    """Under the profiler, 10 blocks (chunk 4) give ten land spans with
    block ids 0-9, each over an `afp.h2d.copy` of the block's bytes; three
    dispatches of 4, 4 and 2 blocks; fetches of the chunks' bytes; drain
    waits over 10 blocks; and no span open while the pump is suspended at
    a yield (the consumer's time is never the pump's)."""
    srv = server(mega)
    blks = blocks(10, seed=1)
    suspended = []
    with profile(activities=[ProfilerActivity.CPU]):
        it = srv.stream(iter(blks))
        for _ in it:
            t0 = time.time_ns()
            time.sleep(0.001)
            suspended.append((t0, time.time_ns()))
    recs = trace.records()
    assert None not in recs and trace.dropped() == 0
    land = named(recs, "afp.serve.land")
    assert [r[4] for _, r in land] == list(range(10))
    for i, r in land:
        assert r[5] == {"blocks": 1}
        kids = [c for c in recs if c[3] == i]
        assert [c[0] for c in kids] == ["afp.h2d.copy"]
        assert kids[0][5]["bytes"] == blks[0].nbytes
        assert r[1] <= kids[0][1] <= kids[0][2] <= r[2]
    disp = [r for r in recs if r[0] in DISPATCH]
    assert {r[0] for r in disp} == {DISPATCH[mega]}
    assert [r[5]["blocks"] for r in disp] == [4, 4, 2]
    assert [r[4] for r in disp] == [0, 4, 8]
    assert all("ops" not in r[5] for r in disp)  # no device on the CPU
    fetch = [r for _, r in named(recs, "afp.serve.fetch")]
    assert [r[4] for r in fetch] == [0, 4, 8]
    assert [r[5]["bytes"] for r in fetch] == [4 * blks[0].nbytes] * 2 + [
        2 * blks[0].nbytes]
    wait = [r for _, r in named(recs, "afp.serve.drain.wait")]
    assert sum(r[5]["blocks"] for r in wait) == 10
    assert [r[4] for r in wait] == [0, 4, 8]
    assert all(r[3] == -1 for r in recs if r[0] != "afp.h2d.copy")
    for a, b in suspended:
        assert not [r for r in recs if r[1] < b and r[2] > a]


def test_engine_block_spans_nest():
    """`process_block` under the profiler: `afp.engine.block` around the
    upload, the step, the download and the check, all of one block id."""
    eng = StreamEngine(StreamConfig(**KW), device="cpu")
    eng.process_block(blocks(1)[0])  # before the profiler: no record
    with profile(activities=[ProfilerActivity.CPU]):
        for b in blocks(2, seed=2):
            eng.process_block(b)
    recs = trace.records()
    top = named(recs, "afp.engine.block")
    assert [r[4] for _, r in top] == [1, 2]
    for i, r in top:
        kids = [c for c in recs if c[3] == i]
        assert [c[0] for c in kids] == ["afp.engine.upload", "afp.engine.step",
                                        "afp.engine.download",
                                        "afp.engine.check"]
        for c in kids:
            assert c[4] == r[4] and c[5] == {"blocks": 1}
            assert r[1] <= c[1] <= c[2] <= r[2]
    assert len(recs) == 10


def test_records_share_the_profilers_clock():
    """Each record's start lies within 50 µs of the start the profiler
    stamps on a `record_function` event opened just before it (median over
    200 spans): the readers lay the records over the device's operations
    in the profiler's trace."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(200):
            with torch.profiler.record_function(f"afp.test.{i}"):
                with trace.span(f"afp.test.{i}"):
                    pass
    starts = {e.name(): e.start_ns() for e in
              prof.profiler.kineto_results.events()
              if e.name().startswith("afp.test.")
              and e.device_type() == DeviceType.CPU}
    recs = trace.records()
    assert len(recs) == 200 and len(starts) == 200
    diff = np.median([abs(r[1] - starts[r[0]]) for r in recs]) / 1e3
    print(f"record vs profiler event start: median {diff:.2f} us")
    assert diff <= 50.0


def test_counts_and_nesting():
    """`add` lands on the innermost open span; a counter's growth across a
    span adds to its ``ops``; parents are the enclosing spans' indices."""
    n = [0]

    def counter():
        return n[0]

    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("afp.a", block=5, nbytes=8):
            with trace.span("afp.b", ops=1, counter=counter):
                n[0] += 3
                trace.add(ops=2)
            trace.add(ops=1, blocks=4)
    a, b = trace.records()
    assert a[0] == "afp.a" and a[3] == -1 and a[4] == 5
    assert a[5] == {"bytes": 8, "ops": 1, "blocks": 4}
    assert b[0] == "afp.b" and b[3] == 0 and b[4] == -1
    assert b[5] == {"ops": 6}


def test_bound_counts_the_drops(monkeypatch):
    """Past `LIMIT` records spans are dropped, counted, and nothing of them
    is kept; `clear` resets both."""
    monkeypatch.setattr(trace, "LIMIT", 3)
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(5):
            with trace.span(f"afp.x.{i}"):
                pass
    assert [r[0] for r in trace.records()] == ["afp.x.0", "afp.x.1", "afp.x.2"]
    assert trace.dropped() == 2
    trace.clear()
    assert trace.records() == [] and trace.dropped() == 0


def test_held_records_escape_the_collector():
    """The records are held as tuples of strings and ints, which the
    garbage collector stops tracking, so a window's many records add
    nothing to a full collection's walk (a stall of the traced pump)."""
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(50):
            with trace.span("afp.serve.land", block=i, blocks=1):
                trace.add(ops=2)
    gc.collect()
    held = trace._records
    assert len(held) == 50 and not any(gc.is_tracked(r) for r in held)
    assert trace.records()[7][5] == {"blocks": 1, "ops": 2}
