"""The two collectives of the parallel layer, for one controlling process
(the port's counterparts of ``lax.ppermute`` and ``lax.psum``).

One Python process drives every shard of a mesh, so a collective is a set
of device-to-device copies and a sum, in a fixed order (results are
deterministic; shards may share a device, where a copy is a no-op):

* :func:`shift_right`: the right-neighbour push of the halo exchange
  (`afp_tpu/parallel/halo.py:93-96`): shard i receives shard i−1's tensor,
  shard 0 zeros;
* :func:`psum`: the all-reduce sum of the kernel-parallel FIR
  (`afp_tpu/parallel/kp.py:104`), summed in shard order on one device.
  The reference replicates the sum on every shard; the one controller
  needs it once.

Copies use the current stream of each device: PyTorch orders a copy
between cards after the producer's current stream and before the
consumer's.  Each function counts its calls (``shift_right.calls``,
``psum.calls``), so tests can assert that a path runs none, the
reference's "zero hot-path collectives" (`tests/test_parallel.py:689-760`).
"""
from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["shift_right", "psum"]


def shift_right(parts: Sequence[torch.Tensor], devices: Sequence) -> list:
    """Shard i's tensor moved to ``devices[i + 1]``: shard 0 receives zeros
    of its own tensor's shape on ``devices[0]``."""
    if len(parts) != len(devices):
        raise ValueError(f"{len(parts)} parts for {len(devices)} devices")
    shift_right.calls += 1
    out = [torch.zeros_like(parts[0], device=devices[0])]
    for src, dev in zip(parts[:-1], devices[1:]):
        out.append(src.to(dev, non_blocking=True))
    return out


def psum(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The sum of `parts` on `device`, added in shard order (a new tensor,
    never one of `parts`)."""
    if not parts:
        raise ValueError("psum of no parts")
    psum.calls += 1
    total = parts[0].to(device, non_blocking=True, copy=True)
    for p in parts[1:]:
        total = total + p.to(device, non_blocking=True)
    return total


shift_right.calls = 0
psum.calls = 0
