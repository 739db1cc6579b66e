"""The benchmark's arithmetic: percentiles over every block, open-loop
latency from the due time, unions of device intervals and idle shares, the
labelled idle gaps, the readers and the roofline's least bytes."""
from __future__ import annotations

import pytest

from perfbench.harness import peaks, readers, stats
from perfbench.harness.trace import TraceData, breakdown


def test_percentile_is_nearest_rank_over_every_value():
    vals = list(range(1, 101))  # 1..100
    assert stats.percentile(vals, 95) == 95
    assert stats.percentile(vals, 50) == 50
    assert stats.percentile(vals, 100) == 100
    assert stats.percentile([7.0], 95) == 7.0
    # one slow block in twenty sets the p95 of twenty
    assert stats.percentile([1.0] * 19 + [9.0], 95) == 1.0
    assert stats.percentile([1.0] * 18 + [9.0, 9.0], 95) == 9.0
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_open_loop_latency_counts_a_stall_in_every_later_block():
    period = 0.010
    due = [i * period for i in range(6)]
    service = 0.002
    done, t = [], 0.0
    for i, d in enumerate(due):
        start = max(d, t)  # a block cannot start before the last ended
        t = start + (0.035 if i == 1 else service)  # block 1 stalls
        done.append(t)
    lat = stats.open_loop_latencies(due, done)
    # block 1 stalls 35 ms; the blocks queued behind it carry its wait
    assert lat == pytest.approx([0.002, 0.035, 0.027, 0.019, 0.011, 0.003])


def test_union_and_idle_shares():
    ivs = [(0, 2), (1, 3), (5, 6), (5.5, 5.7)]
    assert stats.union(ivs) == [(0, 3), (5, 6)]
    assert stats.union_within(ivs, [(0, 10)]) == 4
    assert stats.idle_pct(ivs, [(0, 10)]) == pytest.approx(60.0)
    # inside service windows only
    assert stats.union_within(ivs, [(1, 2), (5.5, 8)]) == pytest.approx(1.5)
    assert stats.idle_pct(ivs, [(1, 2), (5.5, 8)]) == pytest.approx(100 * (1 - 1.5 / 3.5))
    assert stats.idle_pct([], [(0, 1)]) == 100.0


def test_gaps_are_labelled_by_the_innermost_span():
    ops = [(1, 2), (4, 5)]
    g = stats.gaps(ops, (0, 6))
    assert g == [(0, 1), (2, 4), (5, 6)]
    spans = [("outer", 0, 6), ("land", 2.5, 3.5), ("sink", 5, 6)]
    lab = stats.label_gaps(g, spans, default="window")
    assert lab["land"] == (2, 1)
    assert lab["outer"] == (1, 1)
    assert lab["sink"] == (1, 1)


def test_least_bytes_from_shapes_and_dtypes():
    assert peaks.least_bytes(4096, 4096, "f32", "f32") == 4096 * 4096 * 8
    assert peaks.least_bytes(4096, 4096, "pcm16", "pcm16") == 4096 * 4096 * 4
    assert peaks.least_bytes(2, 8, "pcm16", "f32") == 2 * 8 * 6
    # 134 MB of a C5 f32 block takes 40 us at 3.35 TB/s
    assert peaks.least_seconds(peaks.least_bytes(4096, 4096, "f32", "f32")) == \
        pytest.approx(40.06e-6, rel=1e-3)


def _trace():
    ops = [("Memcpy HtoD (Pinned -> Device)", 0, 300), ("fir_conv_kernel", 300, 340),
           ("Memcpy DtoH (Device -> Pinned)", 340, 500),
           ("Memcpy HtoD (Pinned -> Device)", 1000, 1300), ("fir_conv_kernel", 1300, 1340),
           ("Memcpy DtoH (Device -> Pinned)", 1340, 1500)]
    spans = [("process_block", 0, 600), ("process_block", 1000, 1600), ("wait", 600, 1000)]
    return TraceData(device_ops=ops, spans=spans, window=(0, 2000), blocks=2,
                     least_bytes=int(3.35e12 * 20e-6), extra={"engine_busy_s": 0.0012})


def test_readers():
    t = _trace()
    assert readers.copy_ms(t) == pytest.approx(0.46)
    # 20 us least over 40 us a block of non-copy device time
    assert readers.chain_roofline_pct(t) == pytest.approx(50.0)
    assert readers.idle_pct_window(t) == pytest.approx(50.0)
    assert readers.idle_pct_service(t) == pytest.approx(100 * (1 - 1000 / 1200))
    assert readers.engine_busy_ms(t) == pytest.approx(0.6)
    b = breakdown(t)
    assert b["device_ops"][0][0].startswith("Memcpy DtoH") or b["device_ops"][0][0].startswith("Memcpy HtoD")
    assert sum(v for _, v in b["idle_gaps"]) == pytest.approx(1000e-6)


def test_readers_return_nothing_without_device_work():
    t = TraceData(device_ops=[], spans=[], window=(0, 1), blocks=3, least_bytes=8)
    for fn in (readers.copy_ms, readers.chain_roofline_pct, readers.idle_pct_window,
               readers.idle_pct_service):
        assert fn(t) is None
    assert readers.engine_busy_ms(t) is None
