"""The reductions the per-layer metrics' readers (`perfbench/metrics/`)
share.  Each returns None where the trace holds nothing to read (no device
operation, no block), never 0 for a share.  The idle shares are taken on
each of the cell's cards and averaged; the device times are summed over
every card's operations."""
from __future__ import annotations

from . import peaks, stats
from .trace import COPY_KEYS, TraceData

__all__ = ["copy_ms", "chain_roofline_pct", "idle_pct_window",
           "idle_pct_service", "engine_busy_ms"]


def _is_copy(name: str) -> bool:
    return any(k in name for k in COPY_KEYS)


def copy_ms(trace: TraceData):
    """Device ms of the host↔device copies per block returned.  Over
    several cards the copies of every card are summed: card-ms a block."""
    if not trace.blocks:
        return None
    us = sum(e - s for n, s, e in trace.device_ops if _is_copy(n))
    return us / 1e3 / trace.blocks if us > 0 else None


def chain_roofline_pct(trace: TraceData):
    """The least HBM time of a block (`peaks.least_bytes` at the peak rate)
    over the device time per block of every operation that is not a
    host↔device copy, in %.  Over several cards the device time is summed
    over every card (card-seconds) against one card's HBM peak: the share
    of the cards' aggregate peak."""
    if not trace.blocks or not trace.least_bytes:
        return None
    us = sum(e - s for n, s, e in trace.device_ops if not _is_copy(n))
    if us <= 0:
        return None
    least_us = peaks.least_seconds(trace.least_bytes) * 1e6
    return 100.0 * least_us / (us / trace.blocks)


def idle_pct_window(trace: TraceData):
    """1 − (union of the device intervals) / (the window's wall), in %,
    averaged over the cell's cards."""
    if not trace.device_ops:
        return None
    return trace.per_card_mean(lambda ivs: stats.idle_pct(ivs, [trace.window]))


def idle_pct_service(trace: TraceData):
    """1 − (union of the device intervals inside the blocks' service
    intervals) / (their union), in %: the share of the time the program
    was serving a block in which the device had nothing to do, averaged
    over the cell's cards."""
    service = trace.spans_named("process_block")
    if not trace.device_ops or not service:
        return None
    return trace.per_card_mean(lambda ivs: stats.idle_pct(ivs, service))


def engine_busy_ms(trace: TraceData):
    """`EngineMetrics.busy_seconds` gained in the window, per block, in ms."""
    busy = trace.extra.get("engine_busy_s")
    if busy is None or not trace.blocks:
        return None
    return 1e3 * busy / trace.blocks
