"""Device operations enqueued per served block: the `ops` of the program's landing, copy, fetch and dispatch spans per block returned."""
from perfbench.harness import program


def read(trace):
    return program.count_per_block(
        trace, "ops", ("afp.serve.land", "afp.h2d.copy", "afp.serve.fetch",
                       "afp.pipe.run_ring", "afp.pipe.run_ring_mega"))
