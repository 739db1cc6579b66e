"""`ring_graphed_pct.serve` over synthetic records: 100 where every chunk's
dispatch was a graph's replay, 0 where every one ran eagerly, the share in
between, and nothing to read without an `afp.pipe.run_ring` span."""
from __future__ import annotations

import types
from pathlib import Path

import pytest

from perfbench.harness import program
from perfbench.harness.bench import Bench
from perfbench.harness.trace import TraceData

ROOT = Path(__file__).resolve().parents[2]
US = 1000  # ns in a µs: the records are in ns, the window in µs


def rec(name, s_us, e_us, **counts):
    return (name, s_us * US, e_us * US, -1, 0, counts)


def read(monkeypatch, recs, blocks=8):
    monkeypatch.setattr(program, "_source", lambda: types.SimpleNamespace(
        records=lambda: list(recs), dropped=lambda: 0))
    trace = TraceData(device_ops=[("fir_conv_kernel", 0, 10)], spans=[],
                      window=(0, 2000), blocks=blocks)
    return Bench(ROOT).reader("ring_graphed_pct.serve")(trace)


def test_replayed_eager_and_mixed_chunks(monkeypatch):
    replayed = [rec("afp.pipe.run_ring", 100 * i, 100 * i + 5, blocks=4,
                    ops=16, graphed=4) for i in range(2)]
    eager = [rec("afp.pipe.run_ring", 500 + 100 * i, 500 + 100 * i + 40,
                 blocks=4, ops=24) for i in range(2)]
    assert read(monkeypatch, replayed) == pytest.approx(100.0)
    assert read(monkeypatch, eager) == 0.0
    assert read(monkeypatch, replayed[:1] + eager[:1]) == pytest.approx(50.0)
    # a capture inside the window is counted, its blocks served by a replay
    captured = rec("afp.pipe.run_ring", 900, 990, blocks=4, ops=16,
                   graphed=4, captures=1)
    assert read(monkeypatch, [captured] + eager) == pytest.approx(50.0)


def test_nothing_to_read(monkeypatch):
    mega = [rec("afp.pipe.run_ring_mega", 0, 5, blocks=4, ops=2)]
    assert read(monkeypatch, mega) is None
    assert read(monkeypatch, []) is None
    ring = [rec("afp.pipe.run_ring", 0, 5, blocks=4, graphed=4)]
    assert read(monkeypatch, ring, blocks=0) is None
    monkeypatch.setattr(program, "_source", lambda: None)
    trace = TraceData(device_ops=[], spans=[], window=(0, 2000), blocks=8)
    assert Bench(ROOT).reader("ring_graphed_pct.serve")(trace) is None
