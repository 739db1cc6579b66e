"""Device ms of the per-listener EQ mix (K11, `fir_ps_kernel`) per served block."""
from perfbench.harness import eq_mix


def read(trace):
    return eq_mix.mix_ms(trace)
