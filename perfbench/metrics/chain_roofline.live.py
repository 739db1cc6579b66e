"""The live chain's least HBM time per block over its device time per block outside the copies, %."""
from perfbench.harness import readers


def read(trace):
    return readers.chain_roofline_pct(trace)
