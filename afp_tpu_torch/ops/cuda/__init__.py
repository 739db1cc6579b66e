"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain PyTorch
versions — the port's counterpart of `afp_tpu/ops/pallas/`.  Importing this
package builds nothing: the kernels compile on first launch (`_build.py`)."""
from .agc_fused import agc_rms_apply, agc_rms_apply_plain, fused_rms_supported
from .agc_rms import band_is_exact_bf16, rms_desired, rms_desired_plain
from .agc_scan import (smooth_gain_apply, smooth_gain_apply_plain,
                       smooth_gain_scan, smooth_gain_scan_plain)
from .dither import dither_cuda
from .fir_td import (LANE, PCM16_SCALE, band_matrix, fir_td_mxu,
                     fir_td_mxu_banked, fir_td_mxu_banked_plain,
                     fir_td_mxu_pair, fir_td_mxu_pair_plain,
                     fir_td_mxu_pair_to_ring, fir_td_mxu_pair_to_ring_plain,
                     fir_td_mxu_per_stream, fir_td_mxu_per_stream_pair,
                     fir_td_mxu_per_stream_pair_plain,
                     fir_td_mxu_per_stream_pair_to_ring,
                     fir_td_mxu_per_stream_pair_to_ring_plain,
                     fir_td_mxu_per_stream_plain,
                     fir_td_mxu_plain, fir_td_mxu_ring, fir_td_mxu_ring_f32,
                     fir_td_mxu_ring_f32_plain, fir_td_mxu_ring_mega,
                     fir_td_mxu_ring_mega_f32, fir_td_mxu_ring_mega_f32_plain,
                     fir_td_mxu_ring_mega_pcm16,
                     fir_td_mxu_ring_mega_pcm16_plain,
                     fir_td_mxu_ring_mega_plain, fir_td_mxu_ring_pcm16,
                     fir_td_mxu_ring_pcm16_plain, fir_td_mxu_ring_plain,
                     merge_bf16, pcm16_to_f32, quantize_pcm16, ring_k_pad,
                     split_bf16)

#: every kernel wrapper of the package, each with its ``launches`` count
#: (calls on a card) and ``kernels`` (the kernels one call launches)
KERNELS = (fir_td_mxu, fir_td_mxu_ring_f32, fir_td_mxu_ring_mega_f32,
           dither_cuda, rms_desired, smooth_gain_apply, fir_td_mxu_pair_to_ring,
           fir_td_mxu_pair, fir_td_mxu_ring_pcm16, fir_td_mxu_ring_mega_pcm16,
           fir_td_mxu_ring, fir_td_mxu_ring_mega, fir_td_mxu_banked,
           fir_td_mxu_per_stream, agc_rms_apply, smooth_gain_scan,
           fir_td_mxu_per_stream_pair, fir_td_mxu_per_stream_pair_to_ring)


def device_launches() -> int:
    """The kernels the wrappers have launched on a card so far: each
    wrapper's ``launches`` times its ``kernels``."""
    return sum(k.launches * k.kernels for k in KERNELS)


__all__ = ["LANE", "KERNELS", "PCM16_SCALE", "agc_rms_apply",
           "agc_rms_apply_plain", "band_is_exact_bf16", "fused_rms_supported",
           "band_matrix", "device_launches", "dither_cuda", "fir_td_mxu",
           "fir_td_mxu_banked",
           "fir_td_mxu_banked_plain", "fir_td_mxu_pair",
           "fir_td_mxu_pair_plain", "fir_td_mxu_pair_to_ring",
           "fir_td_mxu_pair_to_ring_plain", "fir_td_mxu_per_stream",
           "fir_td_mxu_per_stream_pair", "fir_td_mxu_per_stream_pair_plain",
           "fir_td_mxu_per_stream_pair_to_ring",
           "fir_td_mxu_per_stream_pair_to_ring_plain",
           "fir_td_mxu_per_stream_plain", "fir_td_mxu_plain",
           "fir_td_mxu_ring", "fir_td_mxu_ring_f32",
           "fir_td_mxu_ring_f32_plain", "fir_td_mxu_ring_mega",
           "fir_td_mxu_ring_mega_f32", "fir_td_mxu_ring_mega_f32_plain",
           "fir_td_mxu_ring_mega_pcm16", "fir_td_mxu_ring_mega_pcm16_plain",
           "fir_td_mxu_ring_mega_plain", "fir_td_mxu_ring_pcm16",
           "fir_td_mxu_ring_pcm16_plain", "fir_td_mxu_ring_plain",
           "merge_bf16", "pcm16_to_f32", "quantize_pcm16", "ring_k_pad",
           "rms_desired", "rms_desired_plain", "smooth_gain_apply",
           "smooth_gain_apply_plain", "smooth_gain_scan",
           "smooth_gain_scan_plain", "split_bf16"]
