"""The device's idle share of the time the engine was serving a block (due-paced, so the window is idle by design), %."""
from perfbench.harness import readers


def read(trace):
    return readers.idle_pct_service(trace)
