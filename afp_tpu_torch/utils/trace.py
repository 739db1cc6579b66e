"""Spans and counters inside the program, on the profiler's clock.

Tracing is on exactly while a `torch.profiler` records: nothing else turns
it on.  Under the profiler, :func:`span` keeps a record of the work inside
it in memory::

    (name, start_ns, end_ns, parent_index, block, counts)

``start_ns``/``end_ns`` are read from the clock the profiler's events are
stamped with (the Unix clock, ``time.time_ns``), so a reader lays the
records over the device's operations in the profiler's trace.  A span
opens no ``record_function`` range of its own: on the card such ranges
around the pump's copies and launches cost it ~0.1 ms a C8 block under
the profiler, against a few µs for the record.  ``parent_index`` is the
index in :func:`records` of the span it opened inside (-1 for none, per
thread); ``block`` is the global index of the block, or of a chunk's first
block, the span worked on (-1 where it has none), so the spans of one
block share an id; ``counts`` maps ``blocks``, ``bytes``, ``ops``
(device operations enqueued), ``threads`` (the threads of a native
stage copy) and the EQ mix's ``rows``, ``bands``, ``taps`` and
``samples`` to their totals, where non-zero.

With the profiler off, :func:`span` makes one check and returns one shared
no-op object: no allocation, no clock read.  The list is bounded by
:data:`LIMIT`; past it records are dropped and counted (:func:`dropped`),
and a reader should take no number from a partial list.  Nothing is
written anywhere: read the records with :func:`records`.

The spans and what each covers:

=========================  ==============================================
``afp.serve.land``         `RingServer._land`: one block into its input slot
``afp.h2d.pin``            the pinned staging buffer's allocation
``afp.h2d.stage``          the host copy of the block into it (``bytes``;
                           ``threads`` where the native copy ran)
``afp.h2d.copy``           the host→device copy enqueued (``bytes``, ``ops``)
``afp.serve.fetch``        a chunk's device→host copy enqueued (``bytes``,
                           ``ops``: the copies and packing's gather)
``afp.serve.drain.wait``   the wait on a chunk's copy (``blocks`` drained)
``afp.pipe.run_ring``,     a chunk's ring dispatch (``blocks``, ``ops``:
``afp.pipe.run_ring_mega`` every device operation it launched)
``afp.pipe.eq_mix``        K11's launch under per-stream EQ gains, inside
                           the step (``rows``, ``bands``, ``taps``,
                           ``samples`` = rows × block, ``bytes`` of its
                           output; its launches count in the parent's
                           ``ops``)
``afp.engine.block``       `StreamEngine`'s block, and inside it
``afp.engine.upload``,     the block's upload, the pipeline step, the
``afp.engine.step``,       download (and its ``.wait`` on the device) and
``afp.engine.download``,   the finiteness check of a float output
``afp.engine.check``
=========================  ==============================================
"""
from __future__ import annotations

import threading
import time

import torch

__all__ = ["LIMIT", "on", "span", "add", "records", "clear", "dropped"]

#: the most records the list holds
LIMIT = 1 << 22

#: True exactly while a `torch.profiler` records (one C call)
on = torch._C._autograd._profiler_enabled

_lock = threading.Lock()
_local = threading.local()
_records: list = []
_dropped = 0
_generation = 0  # bumped by clear(): a span opened before it is not kept


class _Off:
    """The span while tracing is off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "block", "counts", "counter", "idx", "gen",
                 "parent", "c0", "t0")

    def __init__(self, name, block, counts, counter):
        self.name, self.block = name, block
        self.counts, self.counter = counts, counter

    def __enter__(self):
        global _dropped
        stack = _stack()
        self.parent = stack[-1].idx if stack else -1
        with _lock:
            self.gen = _generation
            if len(_records) < LIMIT:
                self.idx = len(_records)
                _records.append(None)  # filled when the span closes
            else:
                self.idx = -1
                _dropped += 1
        stack.append(self)
        if self.counter is not None:
            self.c0 = self.counter()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        if self.counter is not None:
            _bump(self.counts, "ops", self.counter() - self.c0)
        _stack().pop()
        # held as one flat tuple of strings and ints (the counts as key,
        # value, ...), which the garbage collector stops tracking at its
        # first look: a window's 10^5-10^6 records held with a dict each
        # would make every full collection walk them (0.2 s at 10^5 on the
        # CPU), a stall of the pump they trace
        rec = (self.name, self.t0, t1, self.parent, self.block,
               *(x for kv in self.counts.items() for x in kv))
        with _lock:
            if self.idx >= 0 and self.gen == _generation:
                _records[self.idx] = rec
        return False


def _bump(counts: dict, key: str, n: int) -> None:
    if n:
        counts[key] = counts.get(key, 0) + n


def span(name: str, block: int = -1, blocks: int = 0, nbytes: int = 0,
         ops: int = 0, counter=None):
    """A context manager timing the work inside it as the span `name`, with
    the counts ``blocks``, ``bytes`` (`nbytes`) and ``ops`` known before the
    work; `counter`, a function returning a running count of device
    operations launched, adds its growth across the span to ``ops``.  With
    the profiler off: one shared object that does nothing."""
    if not on():
        return _OFF
    counts = {}
    if blocks:
        counts["blocks"] = blocks
    if nbytes:
        counts["bytes"] = nbytes
    if ops:
        counts["ops"] = ops
    return _Span(name, block, counts, counter)


def add(**counts) -> None:
    """Add counts known only after the work (device operations launched) to
    the innermost open span of this thread; nothing with the profiler off
    or no span open."""
    if not on():
        return
    stack = _stack()
    if stack:
        for key, n in counts.items():
            _bump(stack[-1].counts, key, n)


def records() -> list:
    """The records so far, in the order their spans opened (None for a span
    still open), each with its counts as a dict."""
    with _lock:
        held = list(_records)
    return [r if r is None else (*r[:5], dict(zip(r[5::2], r[6::2])))
            for r in held]


def dropped() -> int:
    """Spans not recorded because the list was full."""
    return _dropped


def clear() -> None:
    """Empty the list and the count of dropped spans."""
    global _dropped, _generation
    with _lock:
        _records.clear()
        _dropped = 0
        _generation += 1
