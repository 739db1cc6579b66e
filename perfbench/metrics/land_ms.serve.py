"""ms a served block spends landing in its input slot: the program's `afp.serve.land` spans per block returned."""
from perfbench.harness import program


def read(trace):
    return program.span_ms_per_block(trace, ("afp.serve.land",))
