"""Host ms a served block spends in the ring dispatch: the program's `afp.pipe.run_ring*` spans per block returned."""
from perfbench.harness import program


def read(trace):
    return program.span_ms_per_block(
        trace, ("afp.pipe.run_ring", "afp.pipe.run_ring_mega"))
