"""Device ms of Memcpy HtoD + DtoH per live block (the engine's upload and download)."""
from perfbench.harness import readers


def read(trace):
    return readers.copy_ms(trace)
