"""The traced readings of a cell on several cards are taken per card and
averaged: on one card each equals the single-timeline arithmetic it
replaced, exactly, on intervals drawn from a fixed seed; on four cards of
which one works, the device reads 75% idle, not 0%."""
from __future__ import annotations

import types

import numpy as np
import pytest

from perfbench.harness import program, readers, stats
from perfbench.harness.trace import WINDOW, TraceData, breakdown

US = 1000  # ns in a µs: the program's records are in ns


# The single-timeline arithmetic, as it read before the per-card one.

def old_busy_us(t):
    return stats.union_within([(s, e) for _, s, e in t.device_ops], [t.window])


def old_idle_pct_window(t):
    return stats.idle_pct([(s, e) for _, s, e in t.device_ops], [t.window])


def old_idle_pct_service(t):
    return stats.idle_pct([(s, e) for _, s, e in t.device_ops],
                          t.spans_named("process_block"))


def old_idle_in_spans_pct(t, names):
    mine = [r for r in program.records(t) if r[0] in names]
    gaps = stats.gaps([(s, e) for _, s, e in t.device_ops], t.window)
    idle = stats.union_within(gaps, [(s, e) for _, s, e, _, _ in mine])
    ws, we = t.window
    return 100.0 * idle / (we - ws)


def old_idle_gaps(t, top=10):
    gap = stats.gaps([(s, e) for _, s, e in t.device_ops], t.window)
    lab = stats.label_gaps(gap, t.spans, default=WINDOW)
    idle = sorted(lab.items(), key=lambda kv: -kv[1][0])[:top]
    return [[f"{n} ({c} gaps)", v / 1e6] for n, (v, c) in idle]


def draw(rng, n, lo, hi, longest):
    s = rng.uniform(lo, hi, n)
    return [(float(a), float(a + rng.uniform(0.1, longest))) for a in s]


def synthetic(seed: int, cards: int = 1, op_cards=None):
    """A window of 0-100 000 µs with drawn device operations (some
    overlapping, some over its edges) and host spans."""
    rng = np.random.default_rng(seed)
    names = ["fir_conv_kernel", "Memcpy HtoD (Pinned -> Device)",
             "Memcpy DtoH (Device -> Pinned)", "rms_desired_kernel"]
    ops = [(names[i % 4], s, e) for i, (s, e) in
           enumerate(draw(rng, 400, -500.0, 100_000.0, 300.0))]
    span_names = ["land", "fetch", "dispatch", "sink", "generate"]
    spans = [(span_names[i % 5], s, e) for i, (s, e) in
             enumerate(draw(rng, 300, 0.0, 100_000.0, 500.0))]
    recs = [("afp.serve.land", s * US, e * US, -1, i, {"blocks": 1})
            for i, (s, e) in enumerate(draw(rng, 200, 0.0, 99_000.0, 400.0))]
    if op_cards == "zeros":
        op_cards = [0] * len(ops)
    t = TraceData(device_ops=ops, spans=spans + [("process_block", 0.0, 60_000.0),
                                                 ("process_block", 70_000.0, 90_000.0)],
                  window=(0.0, 100_000.0), blocks=17, least_bytes=1 << 20,
                  op_cards=op_cards, cards=cards)
    return t, recs


@pytest.fixture
def records(monkeypatch):
    def use(recs):
        src = types.SimpleNamespace(records=lambda: list(recs), dropped=lambda: 0)
        monkeypatch.setattr(program, "_source", lambda: src)
    return use


@pytest.mark.parametrize("op_cards", [None, "zeros"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_one_card_reads_as_one_timeline_did(seed, op_cards, records):
    t, recs = synthetic(seed, op_cards=op_cards)
    records(recs)
    assert t.busy_us() == old_busy_us(t)
    assert readers.idle_pct_window(t) == old_idle_pct_window(t)
    assert readers.idle_pct_service(t) == old_idle_pct_service(t)
    names = ("afp.serve.land",)
    assert program.idle_in_spans_pct(t, names) == old_idle_in_spans_pct(t, names)
    b = breakdown(t)
    assert b["idle_gaps"] == old_idle_gaps(t)
    assert b["device_ops"] and all(v > 0 for _, v in b["device_ops"])


def test_four_cards_one_working_read_three_quarters_idle(records):
    window = (0.0, 1000.0)
    ops = [("fir_conv_kernel", 0.0, 600.0), ("Memcpy HtoD", 600.0, 1000.0)]
    t = TraceData(device_ops=ops, spans=[("land", 0.0, 1000.0)], window=window,
                  blocks=2, op_cards=[0, 0], cards=4)
    records([("afp.serve.land", 0, 1000 * US, -1, 0, {"blocks": 1})])
    assert readers.idle_pct_window(t) == pytest.approx(75.0)
    assert t.busy_us() == pytest.approx(250.0)
    assert program.idle_in_spans_pct(t, ("afp.serve.land",)) == pytest.approx(75.0)
    # the gaps of the three idle cards, averaged over four: 750 µs
    assert breakdown(t)["idle_gaps"] == [["land (3 gaps)", pytest.approx(750e-6)]]
    # device time is summed over the cards: unchanged by the idle ones
    assert readers.copy_ms(t) == pytest.approx(0.2)
    # the same operations on one card of one leave it busy
    one = TraceData(device_ops=ops, spans=[], window=window, blocks=2)
    assert readers.idle_pct_window(one) == 0.0


def test_each_card_has_its_own_timeline():
    # cards 0 and 1 each busy half the window, at different times: each
    # card reads 50% idle, though together they cover the whole window
    ops = [("k", 0.0, 500.0), ("k", 500.0, 1000.0)]
    t = TraceData(device_ops=ops, spans=[], window=(0.0, 1000.0), blocks=1,
                  op_cards=[0, 1], cards=2)
    assert readers.idle_pct_window(t) == pytest.approx(50.0)
    assert t.card_intervals() == [[(0.0, 500.0)], [(500.0, 1000.0)]]
    # an operation on a card outside the cell is refused, by its card and
    # name, on one card as on several
    for cards, bad in ((2, 5), (2, -1), (1, 1)):
        t = TraceData(device_ops=ops, spans=[], window=(0.0, 1000.0), blocks=1,
                      op_cards=[0, bad], cards=cards)
        with pytest.raises(ValueError, match=f"'k' at 500.0 us is on card {bad},"):
            readers.idle_pct_window(t)
