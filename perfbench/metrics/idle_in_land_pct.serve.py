"""The device's idle time while the pump lands blocks, % of the window: the gaps between device operations inside the program's `afp.serve.land` spans."""
from perfbench.harness import program


def read(trace):
    return program.idle_in_spans_pct(trace, ("afp.serve.land",))
