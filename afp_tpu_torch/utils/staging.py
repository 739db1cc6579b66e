"""The host→device copy of a block, through pinned memory on a card: the
one copy `RingServer` lands blocks with and `StreamEngine` uploads them
with, under the ``afp.h2d.*`` spans (`utils/trace.py`)."""
from __future__ import annotations

from typing import Optional

import torch

from . import trace

__all__ = ["to_device"]


def to_device(src: torch.Tensor, dst: Optional[torch.Tensor] = None,
              device=None) -> torch.Tensor:
    """Copy the host tensor `src` into `dst`, or into a new tensor of its
    shape and dtype on `device`; returns the device tensor.  On a card the
    block is first copied into pinned memory of its own dtype, so the
    host→device copy queues behind the stream instead of waiting for it
    (the host allocator keeps the staging buffer until the copy has run);
    on the CPU it is one copy."""
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
        staged.copy_(src)
    with trace.span("afp.h2d.copy", nbytes=n, ops=1):
        dst.copy_(staged, non_blocking=True)
    return dst
