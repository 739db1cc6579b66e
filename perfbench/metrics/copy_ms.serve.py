"""Device ms of Memcpy HtoD + DtoH per served block (the serving pump's copies)."""
from perfbench.harness import readers


def read(trace):
    return readers.copy_ms(trace)
