"""`land_direct_pct.serve` over synthetic records: 100 where every block
landed by DMA from registered memory, 0 where every one was staged, the
share in between, and nothing to read without an `afp.serve.land` span or
from a program without direct landing."""
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


def read(monkeypatch, recs, blocks=4):
    monkeypatch.setattr(program, "_source", lambda: types.SimpleNamespace(
        records=lambda: list(recs), dropped=lambda: 0))
    trace = TraceData(device_ops=[("Memcpy HtoD", 0, 10)], spans=[],
                      window=(0, 2000), blocks=blocks)
    return Bench(ROOT).reader("land_direct_pct.serve")(trace)


def test_direct_staged_and_mixed_landings(monkeypatch):
    direct = [rec("afp.serve.land", 100 * i, 100 * i + 5, blocks=1,
                  ops=1, direct=1) for i in range(4)]
    staged = [rec("afp.serve.land", 500 + 100 * i, 500 + 100 * i + 40,
                  blocks=1, ops=1) for i in range(4)]
    assert read(monkeypatch, direct) == pytest.approx(100.0)
    assert read(monkeypatch, staged) == 0.0
    assert read(monkeypatch, direct[:2] + staged[:2]) == pytest.approx(50.0)


def test_nothing_to_read(monkeypatch):
    assert read(monkeypatch, [rec("afp.serve.fetch", 0, 5, ops=1)]) is None
    assert read(monkeypatch, []) is None
    land = [rec("afp.serve.land", 0, 5, blocks=1, direct=1)]
    assert read(monkeypatch, land, blocks=0) is None
    # a program without direct landing (no `staging.land`) reads nothing,
    # though its landings are there
    from afp_tpu_torch.utils import staging
    monkeypatch.delattr(staging, "land")
    assert read(monkeypatch, land) is None
