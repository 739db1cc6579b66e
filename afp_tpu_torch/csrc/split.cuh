// The exact bf16 hi/lo split shared by the conv (fir_td.cu), the moving-RMS
// (agc_rms.cu) and the AGC apply (agc_scan.cu) kernels.
//
// `split_bf16` of `afp_tpu/ops/pallas/fir_td.py:69-84`: hi = v rounded to bf16
// by the integer round-to-nearest-even mask, lo = bf16_rn(v - hi).  Both
// halves are returned as floats holding bf16 values (.x = hi, .y = lo), so a
// product of two halves is exact in fp32.  The plain PyTorch version is
// `afp_tpu_torch/ops/cuda/fir_td.py:split_bf16`; the two agree bit for bit.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace afp {

__device__ __forceinline__ float2 split_bf16(float v) {
  uint32_t u = __float_as_uint(v);
  u = u + 0x7FFFu + ((u >> 16) & 1u);
  const float hi = __uint_as_float(u & 0xFFFF0000u);
  const float lo = __bfloat162float(__float2bfloat16_rn(__fsub_rn(v, hi)));
  return make_float2(hi, lo);
}

// A bf16 value stored as its raw 16 bits, widened to float (exact).
__device__ __forceinline__ float bf16_bits_to_float(uint16_t bits) {
  return __uint_as_float(static_cast<uint32_t>(bits) << 16);
}

// The raw 16 bits of a float that holds a bf16 value (a half of split_bf16).
__device__ __forceinline__ uint16_t bf16_bits(float v) {
  return static_cast<uint16_t>(__float_as_uint(v) >> 16);
}

}  // namespace afp
