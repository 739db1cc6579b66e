"""EngineMetrics.busy_seconds per block over the window, ms."""
from perfbench.harness import readers


def read(trace):
    return readers.engine_busy_ms(trace)
