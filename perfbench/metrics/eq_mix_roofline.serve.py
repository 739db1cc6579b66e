"""The per-listener EQ mix's least time per block (a multiply-add per tap and output sample at the bf16 peak, or its output once at the HBM peak) over its device time per served block, %."""
from perfbench.harness import eq_mix


def read(trace):
    return eq_mix.mix_roofline_pct(trace)
