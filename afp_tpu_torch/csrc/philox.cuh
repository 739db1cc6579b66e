// Counter-based dither noise shared by the conv epilogue (fir_td.cu) and the
// standalone dither kernel (dither.cu).
//
// Philox4x32-10 (Salmon et al., SC'11), keyed by (stream seed, block counter);
// the counter is the flat element index i of the block's output: element i
// takes word i % 4 of philox(ctr = i / 4).  The noise math is the reference's
// `afp_tpu/ops/pallas/dither_pl.py:tile_noise`; every step is exact in f32,
// so the kernels and the plain PyTorch version (`afp_tpu_torch/ops/dither.py`)
// add bit-identical noise.
#pragma once

#include <cstdint>

namespace afp {

struct U4 {
  uint32_t w[4];
};

__device__ __forceinline__ U4 philox4x32_10(uint32_t c0, uint32_t c1,
                                            uint32_t c2, uint32_t c3,
                                            uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c0;
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2);
    const uint32_t n0 = hi1 ^ c1 ^ k0;
    const uint32_t n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  U4 out;
  out.w[0] = c0;
  out.w[1] = c1;
  out.w[2] = c2;
  out.w[3] = c3;
  return out;
}

// The four draws of flat elements 4g … 4g+3.
__device__ __forceinline__ U4 noise_bits4(uint64_t g, uint32_t seed,
                                          uint32_t counter) {
  return philox4x32_10(static_cast<uint32_t>(g), static_cast<uint32_t>(g >> 32),
                       0u, 0u, seed, counter);
}

// kind: 1 = RPDF, 2 = TPDF.  The _rn intrinsics keep nvcc from contracting
// the steps into an FMA (the products are exact anyway; this is belt and
// braces for bit-identity with the plain version).
__device__ __forceinline__ float noise_from_bits(uint32_t b, int kind,
                                                 float lsb) {
  if (kind == 2) {
    const float u1 = static_cast<float>(b & 0xFFFFu);
    const float u2 = static_cast<float>(b >> 16);
    return __fmul_rn(__fsub_rn(u1, u2), lsb * (1.0f / 65536.0f));
  }
  const float u = __fmul_rn(static_cast<float>(b >> 8), 1.0f / 16777216.0f);
  return __fmul_rn(__fsub_rn(u, 0.5f), lsb);
}

// Output stage in the reference's order (`fir_td.py:_finish_tile`):
// optional clip, then optional dither.
struct Epilogue {
  int has_clip;
  float clip;
  int dither;  // 0 off, 1 RPDF, 2 TPDF
  uint32_t seed;
  uint32_t counter;
  float lsb;
};

__device__ __forceinline__ float finish(float y, const Epilogue& e,
                                        uint32_t bits) {
  if (e.has_clip) y = fminf(fmaxf(y, -e.clip), e.clip);
  if (e.dither) y = __fadd_rn(y, noise_from_bits(bits, e.dither, e.lsb));
  return y;
}

}  // namespace afp
