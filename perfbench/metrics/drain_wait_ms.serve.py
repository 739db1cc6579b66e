"""ms a served block's drain waits on its device->host copy: the program's `afp.serve.drain.wait` spans per block returned."""
from perfbench.harness import program


def read(trace):
    return program.span_ms_per_block(trace, ("afp.serve.drain.wait",))
