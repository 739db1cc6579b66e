"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain PyTorch
versions — the port's counterpart of `afp_tpu/ops/pallas/`.  Importing this
package builds nothing: the kernels compile on first launch (`_build.py`)."""
from .dither import dither_cuda
from .fir_td import (LANE, band_matrix, fir_td_mxu, fir_td_mxu_plain,
                     fir_td_mxu_ring_f32, fir_td_mxu_ring_f32_plain,
                     fir_td_mxu_ring_mega_f32, fir_td_mxu_ring_mega_f32_plain,
                     merge_bf16, ring_k_pad, split_bf16)

#: every kernel wrapper of the package, each with its ``launches`` count
KERNELS = (fir_td_mxu, fir_td_mxu_ring_f32, fir_td_mxu_ring_mega_f32,
           dither_cuda)

__all__ = ["LANE", "KERNELS", "band_matrix", "dither_cuda", "fir_td_mxu",
           "fir_td_mxu_plain", "fir_td_mxu_ring_f32",
           "fir_td_mxu_ring_f32_plain", "fir_td_mxu_ring_mega_f32",
           "fir_td_mxu_ring_mega_f32_plain", "merge_bf16", "ring_k_pad",
           "split_bf16"]
