"""The arithmetic of the metrics: percentiles over every sample, unions of
device intervals and idle shares, open-loop latencies, and the labelling of
idle gaps by the host span active in them."""
from __future__ import annotations

import bisect
import math

__all__ = ["percentile", "union", "union_within", "idle_pct",
           "gaps", "label_gaps", "open_loop_latencies"]


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile (0 < q ≤ 100) over every value: the
    smallest value with at least q% of the values at or below it."""
    vals = sorted(values)
    if not vals:
        raise ValueError("percentile of no values")
    rank = max(1, math.ceil(q / 100.0 * len(vals)))
    return float(vals[rank - 1])


def union(intervals) -> list:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out: list = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def union_within(intervals, windows) -> float:
    """Total length of the union of `intervals` inside the union of
    `windows`."""
    a, w = union(intervals), union(windows)
    total, j = 0.0, 0
    for s, e in a:
        while j < len(w) and w[j][1] <= s:
            j += 1
        k = j
        while k < len(w) and w[k][0] < e:
            total += max(0.0, min(e, w[k][1]) - max(s, w[k][0]))
            k += 1
    return total


def idle_pct(intervals, windows) -> float:
    """1 − (device busy inside `windows`) / (length of `windows`), in %."""
    span = sum(e - s for s, e in union(windows))
    if span <= 0:
        raise ValueError("empty window")
    return 100.0 * (1.0 - union_within(intervals, windows) / span)


def gaps(intervals, window) -> list:
    """The idle (start, end) gaps between the busy intervals inside the
    single `window` (start, end)."""
    ws, we = window
    busy = union([(max(s, ws), min(e, we)) for s, e in intervals])
    out, t = [], ws
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if we > t:
        out.append((t, we))
    return out


def label_gaps(gap_list, spans, default: str = "other") -> dict:
    """Sum the gaps' lengths by the innermost span (name, start, end) that
    covers each gap's midpoint (the latest-starting one); `default` when
    none does.  Returns {label: (total length, count)}."""
    spans = sorted(spans, key=lambda s: s[1])
    starts = [s[1] for s in spans]
    out: dict = {}
    for s, e in gap_list:
        mid = 0.5 * (s + e)
        label = default
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(-1, i - 256), -1):  # the latest start first
            if spans[j][2] >= mid:
                label = spans[j][0]
                break
        tot, n = out.get(label, (0.0, 0))
        out[label] = (tot + (e - s), n + 1)
    return out


def open_loop_latencies(due, done) -> list:
    """Per request, the time from when it was due to when its answer was
    in hand: a stall delays every later request, and that wait counts."""
    return [d1 - d0 for d0, d1 in zip(due, done)]
