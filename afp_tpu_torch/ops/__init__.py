"""Device DSP ops of the port (counterpart of `afp_tpu/ops/`): host kernel
design (`resample`), FFT sizing (`convolve`), the plain dither noise
(`dither`), and the CUDA kernels with their plain versions (`cuda`)."""
from .convolve import next_pow2
from .dither import dither_plain
from .resample import QUALITY_TIERS, quality_kernel, streaming_kernel

__all__ = ["next_pow2", "dither_plain", "QUALITY_TIERS", "quality_kernel",
           "streaming_kernel"]
