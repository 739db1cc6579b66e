"""The readers of the program's own spans (`harness/program.py` and the six
metrics over it): hand-computed values over a synthetic window, device
operations and records, and nothing to read without records, without a
block, outside the window or after a dropped record."""
from __future__ import annotations

import types
from pathlib import Path

import pytest

from perfbench.harness import program
from perfbench.harness.bench import Bench
from perfbench.harness.trace import TraceData

ROOT = Path(__file__).resolve().parents[2]

METRICS = ("land_ms.serve", "stage_gibps.serve", "drain_wait_ms.serve",
           "dispatch_ms.serve", "launches_per_block.serve",
           "idle_in_land_pct.serve")
US = 1000  # ns in a µs: the records are in ns, the window in µs


def rec(name, s_us, e_us, block=-1, parent=-1, **counts):
    return (name, s_us * US, e_us * US, parent, block, counts)


#: two blocks in a window of 0-2000 µs; a land span at each block's start
#: over its pin, stage and copy, one dispatch of both, one fetch, one wait,
#: and one land outside the window (before it opened)
RECORDS = [
    rec("afp.serve.land", -500, -100, 0, blocks=1),
    rec("afp.serve.land", 0, 400, 1, blocks=1),
    rec("afp.h2d.pin", 0, 100, parent=1),
    rec("afp.h2d.stage", 100, 300, parent=1, bytes=2**29),
    rec("afp.h2d.copy", 300, 400, parent=1, bytes=2**29, ops=1),
    rec("afp.serve.land", 1000, 1300, 2, blocks=1),
    rec("afp.h2d.pin", 1000, 1050, parent=5),
    rec("afp.h2d.stage", 1050, 1250, parent=5, bytes=2**29),
    rec("afp.h2d.copy", 1250, 1300, parent=5, bytes=2**29, ops=1),
    rec("afp.pipe.run_ring", 1300, 1340, 1, blocks=2, ops=10),
    rec("afp.serve.fetch", 1340, 1360, 1, bytes=2**30, ops=1),
    rec("afp.serve.drain.wait", 1360, 1900, 1, blocks=2),
    None,  # a span still open
]
#: the device busy 200-700 and 1200-1800 µs: idle 0-200, 700-1200, 1800-2000
OPS = [("Memcpy HtoD", 200, 700), ("fir_conv_kernel", 1200, 1800)]


def fake(recs, dropped=0):
    return types.SimpleNamespace(records=lambda: list(recs),
                                 dropped=lambda: dropped)


def window(blocks=2, ops=OPS):
    return TraceData(device_ops=list(ops), spans=[], window=(0, 2000),
                     blocks=blocks)


@pytest.fixture
def read(monkeypatch):
    def read(name, trace, recs=RECORDS, dropped=0):
        monkeypatch.setattr(program, "_source", lambda: fake(recs, dropped))
        return Bench(ROOT).reader(name)(trace)
    return read


def test_six_readers_by_hand(read):
    # land: 400 + 300 µs in the window over 2 blocks
    assert read("land_ms.serve", window()) == pytest.approx(0.35)
    # stage: 2 × 0.5 GiB in 400 µs
    assert read("stage_gibps.serve", window()) == pytest.approx(1 / 400e-6)
    assert read("drain_wait_ms.serve", window()) == pytest.approx(0.27)
    assert read("dispatch_ms.serve", window()) == pytest.approx(0.02)
    # two H2D copies, ten dispatched operations and one D2H copy: 13 / 2
    assert read("launches_per_block.serve", window()) == pytest.approx(6.5)
    # idle inside the land spans: 0-200 in the first, 1000-1200 in the
    # second: 400 µs of the 2000 µs window
    assert read("idle_in_land_pct.serve", window()) == pytest.approx(20.0)


def test_run_ring_mega_is_a_dispatch(read):
    recs = [r if r is None or r[0] != "afp.pipe.run_ring" else
            ("afp.pipe.run_ring_mega",) + r[1:] for r in RECORDS]
    assert read("dispatch_ms.serve", window(), recs) == pytest.approx(0.02)
    assert read("launches_per_block.serve", window(), recs) == \
        pytest.approx(6.5)


@pytest.mark.parametrize("name", METRICS)
def test_nothing_to_read(read, monkeypatch, name):
    assert read(name, window(), []) is None  # no record
    assert read(name, window(blocks=0)) is None  # no block
    assert read(name, window(), RECORDS, dropped=1) is None  # a partial list
    assert read(name, window(), RECORDS[:1]) is None  # none in the window
    monkeypatch.setattr(program, "_source", lambda: None)  # no trace module
    assert Bench(ROOT).reader(name)(window()) is None


def test_idle_needs_device_operations(read):
    assert read("idle_in_land_pct.serve", window(ops=[])) is None


def test_the_program_keeps_the_records():
    """The readers' source is the program's trace module, in this checkout."""
    src = program._source()
    assert src is not None and callable(src.records) and callable(src.dropped)
