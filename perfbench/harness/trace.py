"""The traced run: `torch.profiler` over the whole measured window, CUDA
activity for the device's operations and the benchmark's own host spans
(`record_function` ranges opened by the loops, never inside the program).

:class:`Tracer` opens the spans (a no-op when tracing is off) and, when on,
holds the profiler; :meth:`Tracer.collect` reduces what it recorded to a
:class:`TraceData`: the device operations and the host spans, in
microseconds on the profiler's one clock, and the window.  Nothing is
written to disk.
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

    def spans_named(self, name: str) -> list:
        return [(s, e) for n, s, e in self.spans if n == name]

    def busy_us(self) -> float:
        return stats.union_within([(s, e) for _, s, e in self.device_ops],
                                  [self.window])


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

    def collect(self, span_names) -> TraceData:
        """The device operations, the host spans named in `span_names`
        (and the window), from the profiler's raw events."""
        from torch.autograd import DeviceType

        ops, spans, window = [], [], None
        wanted = set(span_names) | {WINDOW}
        for e in self._prof.profiler.kineto_results.events():
            s = e.start_ns() / 1e3
            t = s + e.duration_ns() / 1e3
            if e.device_type() == DeviceType.CUDA:
                # a host span is mirrored on the device's timeline as a
                # user annotation: not a device operation
                if not (e.is_user_annotation() or e.name() in wanted):
                    ops.append((e.name(), s, t))
            elif e.name() in wanted:
                if e.name() == WINDOW:
                    window = (s, t)
                else:
                    spans.append((e.name(), s, t))
        if window is None:
            raise RuntimeError("the traced run recorded no window span")
        inside = [o for o in ops if o[2] > window[0] and o[1] < window[1]]
        return TraceData(device_ops=inside, spans=spans, window=window)


def breakdown(trace: TraceData, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    time by the host span active in it, each as [name, seconds]."""
    by: dict = {}
    for name, s, e in trace.device_ops:
        by[name] = by.get(name, 0.0) + (e - s)
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    gap = stats.gaps([(s, e) for _, s, e in trace.device_ops], trace.window)
    lab = stats.label_gaps(gap, trace.spans, default=WINDOW)
    idle = sorted(lab.items(), key=lambda kv: -kv[1][0])[:top]
    return {"device_ops": [[n[:NAME_CHARS], v / 1e6] for n, v in ops],
            "idle_gaps": [[f"{n} ({c} gaps)", v / 1e6] for n, (v, c) in idle]}
