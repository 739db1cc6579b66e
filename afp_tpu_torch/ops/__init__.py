"""Device DSP ops of the port (counterpart of `afp_tpu/ops/`): polyphase
resampling and its kernel design (`resample`), FFT convolution
(`convolve`), the AGC (`agc`), the plain dither noise (`dither`), and the
CUDA kernels with their plain versions (`cuda`)."""
from .convolve import (OverlapAdd, OverlapSave, fft_convolve, kernel_rfft,
                       next_pow2)
from .dither import dither_plain
from .resample import (QUALITY_TIERS, PolyResampler, decimate, output_len,
                       quality_kernel, resample_poly, streaming_kernel,
                       upfirdn)

__all__ = ["next_pow2", "fft_convolve", "kernel_rfft", "OverlapSave",
           "OverlapAdd", "dither_plain", "QUALITY_TIERS", "quality_kernel",
           "streaming_kernel", "output_len", "upfirdn", "resample_poly",
           "decimate", "PolyResampler"]
