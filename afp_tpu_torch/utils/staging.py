"""The host→device copy of a block: the copy `RingServer` lands blocks
with and `StreamEngine` uploads them with, under the ``afp.h2d.*`` spans
(`utils/trace.py`).

Direct landing (:func:`land`, `RingServer` on a card over the one-device
rings, without packing or pair ingest): where the process's pin cache
(`utils/host_pins.py:PINS`) holds the block's memory owner page-locked
in place, the block is copied by DMA straight from the caller's memory,
behind the current stream (``afp.h2d.copy``), with no stage and no pinned
buffer.  The copy's event is returned: the caller must not hand the
block's memory back to its owner (ask the source for the next block, or
yield) before that event, and `RingServer` waits on it (``afp.h2d.wait``).
The owner stays page-locked until the caller drops it, the servers that
landed from it are closed, or the cache's budget evicts it, and is
unregistered after the last copy that read it.  Any other block :func:`land` is handed goes
through :func:`to_device`.

Staging (:func:`to_device`; every other landing and upload): on a card a
block is first staged: a pinned buffer of its shape comes from PyTorch's
caching host allocator (``afp.h2d.pin``), the block's bytes are copied
into it (``afp.h2d.stage``), and the host→device copy is queued behind
the current stream (``afp.h2d.copy``), on which the allocator records the
buffer's use, keeping it until that copy has run.  The stage adapts to the
block's size: a contiguous block of at least :data:`NATIVE_MIN_BYTES`
takes the native copy (`utils/host_copy.py`: a pool of threads, streaming
stores), and its span counts the ``threads`` it used; a smaller or
non-contiguous block takes ``staged.copy_(src)``.  Every staged caller
adapts through this one threshold: the served rings (`RingServer`'s misses,
per shard, pair ingest's halves, packing's staging) and `StreamEngine`'s
uploads.  On the CPU the copy is one ``dst.copy_(src)``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import trace
from .host_copy import copy_into

__all__ = ["NATIVE_MIN_BYTES", "land", "to_device"]

#: the smallest block the stage copies natively: the crossover against
#: ``torch``'s copy in the served pump on the card's host, even at 32 MiB,
#: won at 48, 64 and 96 (PERF.md §5)
NATIVE_MIN_BYTES = 48 << 20


def to_device(src: torch.Tensor, dst: Optional[torch.Tensor] = None,
              device=None) -> torch.Tensor:
    """Copy the host tensor `src` into `dst`, or into a new tensor of its
    shape and dtype on `device`; returns the device tensor.  On a card the
    block is staged into pinned memory, then copied behind the stream; on
    the CPU it is one copy."""
    if dst is None:
        dst = torch.empty(src.shape, dtype=src.dtype, device=device)
    n = src.nbytes
    if dst.device.type != "cuda":
        with trace.span("afp.h2d.copy", nbytes=n):
            dst.copy_(src)
        return dst
    with trace.span("afp.h2d.pin"):
        staged = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
    with trace.span("afp.h2d.stage", nbytes=n):
        if n >= NATIVE_MIN_BYTES and src.is_contiguous():
            trace.add(threads=copy_into(staged, src))
        else:
            staged.copy_(src)
    with trace.span("afp.h2d.copy", nbytes=n, ops=1):
        dst.copy_(staged, non_blocking=True)
    return dst


def land(src: torch.Tensor, dst: torch.Tensor, pins,
         host: np.ndarray, user=None) -> Optional["torch.cuda.Event"]:
    """Copy the host block `src` (a tensor over the array `host`) into the
    device tensor `dst` behind the current stream: by DMA from `host`'s own
    memory where the pin cache `pins` holds (or now takes) its owner
    page-locked, for the server `user`, returning the copy's event, which
    must complete before `host`'s memory is written again; else by
    :func:`to_device`, returning None."""
    with pins.lock:  # no eviction between the lookup and the event
        pin = pins.lookup(host, user)
        if pin is not None:
            with trace.span("afp.h2d.copy", nbytes=src.nbytes, ops=1):
                dst.copy_(src, non_blocking=True)
            pin.event = ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dst.device))
            return ev
    to_device(src, dst)
    return None
