"""The table of peaks and the least work of a block.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the
700 W power limit): a roofline share is stated against these, with the
card's power limit printed beside it.
"""
from __future__ import annotations

__all__ = ["PEAKS", "least_bytes", "least_seconds"]

PEAKS = {
    "hbm_bytes_per_s": 3.35e12,
    "bf16_flops": 989e12,
    "tf32_flops": 495e12,
    "fp32_flops": 67e12,
    "memory_bytes": 80e9,
}

_WIRE_BYTES = {"f32": 4, "pcm16": 2}


def least_bytes(batch: int, block: int, ingest: str, emit: str) -> int:
    """The bytes one block of the chain has to move through HBM at least:
    its input read once and its output written once, in the transport
    dtypes.  No intermediate and no tap is counted, so the number is the
    same whatever kernels implement the chain, fused or not."""
    return batch * block * (_WIRE_BYTES[ingest] + _WIRE_BYTES[emit])


def least_seconds(nbytes: float) -> float:
    """The least time to move `nbytes` through HBM at the peak rate."""
    return float(nbytes) / PEAKS["hbm_bytes_per_s"]
