// K2: standalone requantization dither, y = x + noise.
//
// Replaces `afp_tpu/ops/pallas/dither_pl.py:dither_pallas` (the TPU kernel
// over the hardware PRNG).  Here the noise is Philox keyed by (seed, block
// counter) over the flat element index (philox.cuh), so it is independent of
// the launch geometry and bit-identical to the conv epilogue's and to the
// plain PyTorch version.
//
// Bound on H100: memory.  One f32 read and one f32 write per element (8 MiB
// each for a [512, 4096] block); the 10 Philox rounds cost ~2 integer
// multiplies per element per round, well under the integer rate at that
// byte count.  Design: one thread per group of four elements, one Philox
// call for all four, 16-byte loads and stores where aligned.
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace {

__global__ void dither_kernel(const float* __restrict__ x,
                              float* __restrict__ y, long long n, int kind,
                              uint32_t seed, uint32_t counter, float lsb,
                              int vec4) {
  const long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const long long i0 = g * 4;
  if (i0 >= n) return;
  const afp::U4 b = afp::noise_bits4(static_cast<uint64_t>(g), seed, counter);
  if (vec4 && i0 + 4 <= n) {
    float4 v = reinterpret_cast<const float4*>(x)[g];
    v.x = __fadd_rn(v.x, afp::noise_from_bits(b.w[0], kind, lsb));
    v.y = __fadd_rn(v.y, afp::noise_from_bits(b.w[1], kind, lsb));
    v.z = __fadd_rn(v.z, afp::noise_from_bits(b.w[2], kind, lsb));
    v.w = __fadd_rn(v.w, afp::noise_from_bits(b.w[3], kind, lsb));
    reinterpret_cast<float4*>(y)[g] = v;
    return;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (i0 + c < n)
      y[i0 + c] = __fadd_rn(x[i0 + c], afp::noise_from_bits(b.w[c], kind, lsb));
  }
}

}  // namespace

extern "C" int afp_dither(const void* x, void* y, long long n, int kind,
                          unsigned int seed, unsigned int counter, float lsb,
                          void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const long long groups = (n + 3) / 4;
  const long long blocks = (groups + threads - 1) / threads;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const int vec4 = ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(y)) & 15u) == 0;
  dither_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), n, kind, seed,
      counter, lsb, vec4);
  return static_cast<int>(cudaGetLastError());
}
