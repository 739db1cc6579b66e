"""The traced run: `torch.profiler` over the whole measured window, CUDA
activity for the device's operations and the benchmark's own host spans
(`record_function` ranges opened by the loops, never inside the program).

:class:`Tracer` opens the spans (a no-op when tracing is off) and, when on,
holds the profiler; :meth:`Tracer.collect` reduces what it recorded to a
:class:`TraceData`: the device operations with the card each ran on, and
the host spans, in microseconds on the profiler's one clock, and the
window.  Nothing is written to disk.

A cell on several cards has one timeline a card: the busy time, the idle
shares and the idle gaps are taken per card and averaged over the cell's
cards (:meth:`TraceData.per_card_mean`), so one card working does not
hide the idle ones.  On one card each is the single timeline's number.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

from . import stats

__all__ = ["Tracer", "TraceData", "COPY_KEYS", "breakdown"]

#: device operations that are host↔device copies
COPY_KEYS = ("Memcpy HtoD", "Memcpy DtoH")
#: the span that frames the measured window
WINDOW = "window"
NAME_CHARS = 96


@dataclass
class TraceData:
    """What a traced window recorded, and the run's own counts."""

    device_ops: list  # [(name, start_us, end_us)]
    spans: list  # [(name, start_us, end_us)], the benchmark's host spans
    window: tuple  # (start_us, end_us)
    blocks: int = 0  # blocks returned in the window
    least_bytes: int = 0  # least HBM bytes of one block (harness/peaks.py)
    extra: dict = field(default_factory=dict)  # counts a loop reads off
    op_cards: list | None = None  # the card of each device op (None: card 0)
    cards: int = 1  # the cell's cards, cuda:0 … cuda:{cards-1}

    def spans_named(self, name: str) -> list:
        return [(s, e) for n, s, e in self.spans if n == name]

    def card_intervals(self) -> list:
        """One list of (start, end) device intervals for each of the cell's
        cards.  An operation on a card outside the cell raises: the busy
        and idle readings would leave out what the device-time ones count."""
        out: list = [[] for _ in range(self.cards)]
        for (name, s, e), c in zip(self.device_ops,
                                   self.op_cards or [0] * len(self.device_ops),
                                   strict=True):
            if not 0 <= c < self.cards:
                raise ValueError(f"device operation {name!r} at {s} us is on "
                                 f"card {c}, outside the cell's {self.cards}")
            out[c].append((s, e))
        return out

    def per_card_mean(self, fn) -> float:
        """The mean over the cell's cards of `fn(intervals of the card)`."""
        per = [fn(ivs) for ivs in self.card_intervals()]
        return sum(per) / len(per)

    def busy_us(self) -> float:
        """The device's busy time inside the window, averaged over cards."""
        return self.per_card_mean(
            lambda ivs: stats.union_within(ivs, [self.window]))


class Tracer:
    """Host spans, and the profiler when `enabled`."""

    def __init__(self, enabled: bool):
        self.enabled = bool(enabled)
        self._prof = None
        self._record = None
        if self.enabled:
            from torch.profiler import record_function
            self._record = record_function

    def span(self, name: str):
        return self._record(name) if self.enabled else contextlib.nullcontext()

    def wrap(self, name: str, fn):
        """`fn` with every call inside the span `name`: how a loop times a
        call the program makes on its own, set on the loop's own instance."""
        def wrapped(*a, **k):
            with self.span(name):
                return fn(*a, **k)
        return wrapped

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            import torch
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            self._prof.__exit__(*exc)
        return False

    def collect(self, span_names, cards: int) -> TraceData:
        """The device operations and their cards, the host spans named in
        `span_names` (and the window), from the profiler's raw events, for
        a cell on `cards` cards."""
        from torch.autograd import DeviceType

        ops, op_cards, spans, window = [], [], [], None
        wanted = set(span_names) | {WINDOW}
        for e in self._prof.profiler.kineto_results.events():
            s = e.start_ns() / 1e3
            t = s + e.duration_ns() / 1e3
            if e.device_type() == DeviceType.CUDA:
                # a host span is mirrored on the device's timeline as a
                # user annotation: not a device operation
                if not (e.is_user_annotation() or e.name() in wanted):
                    ops.append((e.name(), s, t))
                    op_cards.append(e.device_index())
            elif e.name() in wanted:
                if e.name() == WINDOW:
                    window = (s, t)
                else:
                    spans.append((e.name(), s, t))
        if window is None:
            raise RuntimeError("the traced run recorded no window span")
        keep = [i for i, o in enumerate(ops)
                if o[2] > window[0] and o[1] < window[1]]
        return TraceData(device_ops=[ops[i] for i in keep], spans=spans,
                         window=window, op_cards=[op_cards[i] for i in keep],
                         cards=int(cards))


def breakdown(trace: TraceData, top: int = 10) -> dict:
    """The device operations that took most time (summed over the cell's
    cards), and the longest idle time by the host span active in it (each
    card's gaps, the time averaged over the cards, the gaps counted on all),
    each as [name, seconds]."""
    by: dict = {}
    for name, s, e in trace.device_ops:
        by[name] = by.get(name, 0.0) + (e - s)
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    lab: dict = {}
    for ivs in trace.card_intervals():
        gap = stats.gaps(ivs, trace.window)
        for n, (v, c) in stats.label_gaps(gap, trace.spans, default=WINDOW).items():
            tot, cnt = lab.get(n, (0.0, 0))
            lab[n] = (tot + v, cnt + c)
    idle = sorted(lab.items(), key=lambda kv: -kv[1][0])[:top]
    return {"device_ops": [[n[:NAME_CHARS], v / 1e6] for n, v in ops],
            "idle_gaps": [[f"{n} ({c} gaps)", v / trace.cards / 1e6]
                          for n, (v, c) in idle]}
