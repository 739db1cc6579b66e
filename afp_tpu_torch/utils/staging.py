"""The host→device copy of a block, through pinned memory on a card: the
one copy `RingServer` lands blocks with and `StreamEngine` uploads them
with, under the ``afp.h2d.*`` spans (`utils/trace.py`).

On a card a block is first staged: a pinned buffer of its shape comes from
PyTorch's caching host allocator (``afp.h2d.pin``), which keeps it until
the host→device copy has run and then hands it back, the block's bytes are
copied into it (``afp.h2d.stage``), and the host→device copy is queued
behind the stream (``afp.h2d.copy``).  The stage adapts to the block's
size: a contiguous block of at least :data:`NATIVE_MIN_BYTES` takes the
native copy (`utils/host_copy.py`: a pool of threads, streaming stores),
and its span counts the ``threads`` it used; a smaller or non-contiguous
block takes ``staged.copy_(src)``.  Every caller adapts through this one
threshold: the served rings (`RingServer`: one-device, per shard, pair
ingest's halves, packing's staging) and `StreamEngine`'s uploads.  On the
CPU the copy is one ``dst.copy_(src)``.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import trace
from .host_copy import copy_into

__all__ = ["NATIVE_MIN_BYTES", "to_device"]

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
