"""Share of the served blocks that a CUDA graph's replay dispatched, %: 100 × the `graphed` count of the program's `afp.pipe.run_ring` spans per block returned (0 where every chunk ran eagerly)."""
from perfbench.harness import program


def read(trace):
    n = program.count_per_block(trace, "graphed", ("afp.pipe.run_ring",))
    return None if n is None else 100.0 * n
