"""The device's idle share of the served window's wall, %."""
from perfbench.harness import readers


def read(trace):
    return readers.idle_pct_window(trace)
