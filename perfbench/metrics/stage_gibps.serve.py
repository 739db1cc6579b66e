"""The host's copy rate into pinned staging, GiB/s: the bytes of the program's `afp.h2d.stage` spans over their time."""
from perfbench.harness import program


def read(trace):
    bps = program.rate(trace, "bytes", ("afp.h2d.stage",))
    return None if bps is None else bps / 2**30
