"""The per-listener EQ mix (K11, the program's `fir_ps_kernel`) in a
traced window: its device time per block, and its share of the least time
a mix can take.

The least time of one mix is the larger of two terms, from the counts of
the program's ``afp.pipe.eq_mix`` span: one multiply-add per tap per
output sample (2 · ``samples`` · ``taps`` operations) at the bf16 dense
peak, and the mix's output (``bytes``, in the wire dtype) written once at
the HBM peak.  Neither the bands nor the bf16 split are counted, so a mix
of per-row combined taps, or one fused into the AGC's apply, cannot read
above 100%.

Each returns None where the trace holds nothing to read: no block, no
`fir_ps_kernel` operation, or a program without the span.
"""
from __future__ import annotations

from . import program
from .peaks import PEAKS
from .trace import TraceData

__all__ = ["KERNEL", "SPAN", "mix_ms", "least_us", "mix_roofline_pct"]

#: the device operations of the mix: the program's K11 kernel, every form
KERNEL = "fir_ps_kernel"
#: the program's span around each of the mix's launches
SPAN = "afp.pipe.eq_mix"


def mix_ms(trace: TraceData):
    """Device ms of the mix's kernels per block returned."""
    if not trace.blocks:
        return None
    us = sum(e - s for n, s, e in trace.device_ops if KERNEL in n)
    return us / 1e3 / trace.blocks if us > 0 else None


def least_us(counts: dict) -> float:
    """The least time of one mix with the span's `counts`, in µs."""
    flops = 2.0 * counts.get("samples", 0) * counts.get("taps", 0)
    return 1e6 * max(flops / PEAKS["bf16_flops"],
                     counts.get("bytes", 0) / PEAKS["hbm_bytes_per_s"])


def mix_roofline_pct(trace: TraceData):
    """The mixes' least time per block over their device time per block
    (:func:`mix_ms`), in %."""
    ms = mix_ms(trace)
    recs = program.records(trace)
    if ms is None or recs is None:
        return None
    mine = [c for name, _, _, _, c in recs if name == SPAN]
    if not mine:
        return None
    least = sum(least_us(c) for c in mine) / trace.blocks
    return 100.0 * least / (1e3 * ms)
