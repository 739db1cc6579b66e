// Tensor-core building blocks of the banded-Toeplitz conv: the shared body
// (K1, K3, K4, K7, K8, K10, K12, K13 and HIGHEST K1) and K11, both in
// csrc/fir_td.cu.
//
// The conv y[b, c] = sum_j h[j] * w[b, c + n-1 - j] of a staged window w
// (window position p holds the extended-signal sample of output c + n-1 - j)
// is the product W[rows, positions] . Band[positions, outputs] with the
// Toeplitz band Band[p, c] = h[n-1 + c - p], the TPU's `band_matrix`
// (`afp_tpu/ops/pallas/fir_td.py:101`).  On the tensor cores it runs as
// mma.sync m16n8k16 (bf16 in, fp32 accumulate): A is 16 rows x 16 window
// positions, read from shared memory with ldmatrix; B is 16 positions x 8
// outputs of the band.  For an 8-output column tile at c0 the band is
// nonzero only at positions [c0, c0 + n+6], so the tile takes the k-steps
// p0 = c0 + 16 s, s = 0 .. S-1 with S = ceil((n+7) / 16) (no all-zero step
// is issued), and because the band is Toeplitz the B operand of step s does
// not depend on c0:
//
//   tile s: B[i][j] = h[n-1 - 16 s + j - i]   (zero outside [0, n)).
//
// So a band is S small tiles, laid out directly in the mma B-fragment order
// (built in shared memory from the taps, fir_td.cu:build_tiles, entry for
// entry as `ops/cuda/fir_td.py:band_tiles` builds them):
// lane l (group g = l / 4, t = l % 4) holds B[2t][g], B[2t+1][g],
// B[2t+8][g], B[2t+9][g] as four bf16, one 8-byte load.  A tile of one bf16
// half is 256 bytes.
//
// The products split each operand into bf16 halves: P = 2 halves (hi, lo)
// for bf16x3 (hi*hi + hi*lo + lo*hi), P = 3 (hi, mid, lo, an exact
// three-way split) for HIGHEST (hi*hi + hi*mid + mid*hi + hi*lo + lo*hi +
// mid*mid, the TPU's 6-pass fp32 emulation).  Each bf16 product is exact;
// the tensor core adds them into the fp32 accumulator, truncating (not
// rounding to nearest) inside one mma.
//
// Sum order: an output's accumulator takes the steps s = 0 .. S-1 in order,
// each step the products in the order above.  The callers run band_conv
// over chunks of steps, each into a fresh fragment whose sum they add in
// fp32 round-to-nearest (fir_td.cu:conv_chunks), which bounds the truncated
// adds behind any one rounding.  That sequence depends on nothing but the
// output's column within its 8-wide tile, never on its row, its row tile,
// the batch or the grid, so a row computed alone equals the same row inside
// any batch, bit for bit.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace afp {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices from shared memory (each lane passes one 16-byte
// row address): the A fragment of m16n8k16 when lanes 0-15 address rows
// 0-15 at column p0 and lanes 16-31 the same rows at column p0 + 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += A(16x16, row) * B(16x8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// The bf16 halves of v as raw bits: P = 2, split_bf16's (hi, lo); P = 3,
// the exact three-way split hi = bf16(v), mid = bf16(v - hi), lo = bf16(v -
// hi - mid) (both differences are exact in fp32).
template <int P>
__device__ __forceinline__ void split_halves(float v, uint16_t (&h)[P]) {
  const uint32_t u = __float_as_uint(v);
  const float hi =
      __uint_as_float((u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u);
  const float r = __fsub_rn(v, hi);
  const __nv_bfloat16 mid = __float2bfloat16_rn(r);
  h[0] = static_cast<uint16_t>(__float_as_uint(hi) >> 16);
  h[1] = __bfloat16_as_ushort(mid);
  if constexpr (P == 3)
    h[2] = __bfloat16_as_ushort(
        __float2bfloat16_rn(__fsub_rn(r, __bfloat162float(mid))));
}

// The products of one k-step into the accumulator, A and B split into P
// halves, in the order of the header comment.
template <int P>
__device__ __forceinline__ void mma_split(float (&d)[4],
                                          const uint32_t (&a)[P][4],
                                          const uint2 (&b)[P]) {
  mma_bf16(d, a[0], b[0]);
  mma_bf16(d, a[0], b[1]);
  mma_bf16(d, a[1], b[0]);
  if constexpr (P == 3) {
    mma_bf16(d, a[0], b[2]);
    mma_bf16(d, a[2], b[0]);
    mma_bf16(d, a[1], b[1]);
  }
}

// Step t of band_conv (A positions m = 2t, 2t + 1): the A fragments of
// both positions, then for each column tile pair q = 2j, 2j + 1 whose step
// s = t - j lies in [0, S) one B tile s, which serves both.  Without kGuard
// every s does (the steady middle of the loop): the body is one straight
// block, so the scheduler interleaves the independent accumulators' mma
// chains.
template <int P, int MT, int NQ, bool kGuard>
__device__ __forceinline__ void band_step(const uint16_t* __restrict__ win,
                                          int rows_stride, int wp, int acol,
                                          int arow,
                                          const unsigned char* __restrict__ tiles,
                                          int S, int t, int lane,
                                          float (&z)[MT][NQ][4]) {
  uint32_t a[2][MT][P][4];
#pragma unroll
  for (int par = 0; par < 2; ++par)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int p = 0; p < P; ++p)
        ldmatrix_x4(a[par][mt][p],
                    win + (static_cast<size_t>(p) * rows_stride + mt * 16 + arow) * wp +
                        acol + 8 * (2 * t + par));
#pragma unroll
  for (int j = 0; j < NQ / 2; ++j) {
    const int s = t - j;
    if (kGuard && (s < 0 || s >= S)) continue;
    uint2 b[P];
#pragma unroll
    for (int p = 0; p < P; ++p)
      b[p] = *reinterpret_cast<const uint2*>(tiles + ((s * P + p) * 32 + lane) * 8);
#pragma unroll
    for (int par = 0; par < 2; ++par)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_split<P>(z[mt][2 * j + par], a[par][mt], b);
  }
}

// One warp's conv of MT x 16 window rows against one band: the column
// tiles c = cbase + 8 q (q < NQ, NQ even) of z, from the window halves
// `win` (P arrays of `rows_stride` rows x `wp` bf16, row-major, wp = 8 mod
// 64 so the ldmatrix rows fall in distinct bank groups) and the band's S
// tiles `tiles` ([S][P][32 lanes] x 8 bytes in shared memory).  Column tile
// q takes step s at window position p0 = cbase + 8 (q + 2 s): the loop runs
// t = 0 .. NQ/2 + S - 2 over position pairs 2t, 2t + 1, whose A fragments
// serve the tiles q = 2j, 2j + 1 at step s = t - j, one B tile for both
// (so a warp reads each A fragment once and each B tile twice per chunk).
// For t in [NQ/2 - 1, S - 1] every q is valid; the edges run guarded.
template <int P, int MT, int NQ>
__device__ __forceinline__ void band_conv(const uint16_t* __restrict__ win,
                                          int rows_stride, int wp, int cbase,
                                          const unsigned char* __restrict__ tiles,
                                          int S, float (&z)[MT][NQ][4]) {
  static_assert(NQ % 2 == 0, "column tiles come in parity pairs");
  const int lane = threadIdx.x & 31;
  const int arow = lane & 15;
  const int acol = cbase + (lane >> 4) * 8;
  const int nt = NQ / 2 + S - 1;  // position pairs t
  const bool steady = NQ / 2 <= S;
  const int lo = steady ? NQ / 2 - 1 : 0;  // the steady t: [lo, hi)
  const int hi = steady ? S : 0;
#pragma unroll 1
  for (int t = 0; t < lo; ++t)
    band_step<P, MT, NQ, true>(win, rows_stride, wp, acol, arow, tiles, S, t,
                               lane, z);
#pragma unroll 1
  for (int t = lo; t < hi; ++t)
    band_step<P, MT, NQ, false>(win, rows_stride, wp, acol, arow, tiles, S, t,
                                lane, z);
#pragma unroll 1
  for (int t = hi; t < nt; ++t)
    band_step<P, MT, NQ, true>(win, rows_stride, wp, acol, arow, tiles, S, t,
                               lane, z);
}

}  // namespace afp
