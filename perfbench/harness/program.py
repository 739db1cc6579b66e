"""The program's own spans in a traced window: the records that
`afp_tpu_torch.utils.trace` keeps while the profiler runs, on the clock of
the profiler's events, laid over the window and the device's operations.

Each reduction returns None where there is nothing to read: a program that
keeps no records (one older than its trace module), no record of the
spans asked for inside the window, no block returned, or any record
dropped (a number from a partial list would be wrong, not small).
"""
from __future__ import annotations

from . import stats
from .trace import TraceData

__all__ = ["records", "span_ms_per_block", "count_per_block", "rate",
           "idle_in_spans_pct"]

_CACHE = "_program_records"


def _source():
    """The program's trace module, or None where it has none."""
    try:
        from afp_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace


def records(trace: TraceData):
    """The program's closed records that lie inside the window, as (name,
    start_us, end_us, block, counts), or None (see the module)."""
    if _CACHE not in trace.extra:
        src = _source()
        if src is None or src.dropped():
            out = None
        else:
            ws, we = trace.window
            out = [(r[0], r[1] / 1e3, r[2] / 1e3, r[4], r[5])
                   for r in src.records() if r is not None
                   and r[1] / 1e3 >= ws and r[2] / 1e3 <= we] or None
        trace.extra[_CACHE] = out
    return trace.extra[_CACHE]


def _named(trace: TraceData, names):
    recs = records(trace)
    if recs is None or not trace.blocks:
        return None
    mine = [r for r in recs if r[0] in names]
    return mine or None


def span_ms_per_block(trace: TraceData, names):
    """The spans' whole durations (their children inside them) per block
    returned, in ms."""
    mine = _named(trace, names)
    if mine is None:
        return None
    return sum(e - s for _, s, e, _, _ in mine) / 1e3 / trace.blocks


def count_per_block(trace: TraceData, key: str, names):
    """The spans' count `key` per block returned."""
    mine = _named(trace, names)
    if mine is None:
        return None
    return sum(c.get(key, 0) for *_, c in mine) / trace.blocks


def rate(trace: TraceData, key: str, names):
    """The spans' count `key` over the time inside them, per second."""
    mine = _named(trace, names)
    if mine is None:
        return None
    us = sum(e - s for _, s, e, _, _ in mine)
    n = sum(c.get(key, 0) for *_, c in mine)
    return n / (us / 1e6) if us > 0 and n else None


def idle_in_spans_pct(trace: TraceData, names):
    """The device's idle time inside the spans, as a share of the window's
    wall, in %: the gaps between the device's operations intersected with
    the spans' intervals, on each of the cell's cards, averaged."""
    mine = _named(trace, names)
    if mine is None or not trace.device_ops:
        return None
    spans = [(s, e) for _, s, e, _, _ in mine]

    def idle(ivs):
        return stats.union_within(stats.gaps(ivs, trace.window), spans)

    ws, we = trace.window
    return 100.0 * trace.per_card_mean(idle) / (we - ws)
