// K14: the whole AGC stage in one kernel: moving RMS by chunk-prefix window
// sums, desired gain, the attack/release recurrence, the gain clip, the
// apply and the carry.
//
// Replaces `afp_tpu/ops/pallas/agc_fused.py:agc_rms_apply_pallas`
// (`_fused_call`, `_fused_kernel`).  Per stream, with time chunks of TC = 128
// samples and a window w = 2h * TC ('same' centering, lp = w/2), the moving
// sum at sample t of output chunk i is
//
//   W = (base_i - C_{i-h}[t]) + C_{i+h}[t]
//
// where C_k[t] is chunk k's own running sum of x^2 before sample t (zero for
// a chunk outside the block) and base_i the sum of the 2h chunk totals
// S_{i-h} .. S_{i+h-1}.  Every term is window-local, so the error stays at
// the window's own energy (about 2^-24), where the two-kernel chain's bf16
// boxcar reaches 2^-17 (`agc_fused.py:22-25, 35-47`).  Then
//
//   d = clip(target / (sqrt(max(W * (1/w), 0)) + 1e-10), 0, max_gain)
//   a = d > g ? a_att : a_rel;   g = a * d + (1 - a) * g
//   y = clip(x * clip(g, 0.1, max_gain), -out_clip, out_clip)
//   carry = clip(g_last, 0.1, max_gain)
//
// with the reference's restart without a carry (the first sample takes
// g = d), optionally storing y as its bf16 (hi, lo) pair for K8/K7.  x is f32
// or raw int16 PCM converted n * 2^-15 as it is read (exact).
//
// The rounding is the reference kernel's as XLA's CPU backend evaluates it
// (measured bit-exact on the CPU against the interpret-mode kernel): the
// running sums add the rounded square, c + x*x; base adds the 2h totals in
// ring-slot order (total k in slot k mod 2h, slots 0 .. 2h-1), from 0; W is
// (base - C_old) + C_new; the recurrence is fma(a, d, (1 - a) * g).  Every
// operation is an explicit _rn intrinsic, so nvcc contracts nothing else and
// the kernel equals its plain version (`ops/cuda/agc_fused.py:
// agc_rms_apply_plain`) bit for bit.
//
// What bounds it on H100 at the C8 point (batch 4096, block 2048, w 512):
// 32 MiB of x in and 32 MiB (or 2 x 16 MiB as the pair) out, ~20 us of
// bytes; the recurrence, serial in time per stream: 4096 chains of 2048
// dependent steps, one warp of 32 a block; and the correctly rounded sqrt
// and division of every sample.  The aim is the largest of these, not
// their sum, so each role runs in warps of its own and they overlap
// (`chip_agc_ablate.py` at the C8 point on an H100 80GB HBM3 at 700 W:
// the chain alone 0.028 ms, the apply alone 0.032, the window warps alone
// 0.052, of which the sqrt and division are 0.018; all together 0.077):
// the window warps set the time, latency-bound (8 of them are no faster
// than 6, 4 are slower).
//
// Design (the roles, the step and the barrier protocol are in
// `agc_roles.cuh`, shared with K6 and K9): a block owns 32 streams and runs
// three roles at once, 15 warps.
//   * kWindowWarps = 6 window warps, lane = stream.  C_k is chunk k's own
//     running sum from 0, so the sums of different output chunks do not
//     depend on each other: window warp w takes the output chunks
//     i = w (mod kWindowWarps), in rounds of kWindowWarps chunks.  A round
//     first closes the chunk totals it needs (S_k up to i + h, each warp
//     the k = w (mod kWindowWarps), into a ring of 2 kWindowWarps + 2h
//     totals), meets the other window warps at the round barrier, then
//     sums base_i in slot order and runs C_{i+h} and C_{i-h} (both
//     recomputed from x, which is read again from L2, so any w runs: no
//     chunk of C is kept) beside W -> d, the sqrt and the division off the
//     chain, and writes d into its own d slot [128][32] in shared memory,
//     handed to the recurrence warp through a pair of mbarriers.  x is read
//     along time, 16 samples (64 bytes) a lane at a time, the next 16
//     loaded before the current ones are used.
//   * Warp 0, the recurrence, as in K6: a chunk at a time in order, d from
//     the slot of the window warp that made it, 4 steps a float4 of raw
//     gains into one of two gain buffers; the restart g = d[0] at the first
//     sample without a carry.
//   * 8 apply warps, as in K6: 16-byte x and y, x of the next chunk loaded
//     before its gains exist, the gain clip.
#include <cuda_runtime.h>

#include <cstdint>

#include "agc_roles.cuh"

namespace {

using namespace afp_agc;

constexpr int kWindowWarps = 6;
constexpr int kThreads = kPairThreads + 32 * kWindowWarps;
constexpr int kSlot = kTC * kStreams;  // floats of one d chunk [kTC][32]
constexpr int kBarRound = 5;  // the window warps' round barrier
constexpr int kGroup = 16;    // samples a window lane loads at a time
constexpr int kTotalGroups = 4;  // groups a lane loads at once for a total

struct FusedArgs {
  Apply ap;           // x, y or the pair, B, T, max_gain, out_clip
  const float* init;  // [B] carried gain, or null (restart)
  float* carry;       // [B]
  int h;
  float a_att, a_rel, target, inv_w;
};

// Samples o .. o+15 of x as f32: 64 bytes (f32) or 32 bytes (int16) in
// 16-byte loads when `vec`, else one at a time.
__device__ __forceinline__ void load_group(const Apply& a, bool vec, long long o,
                                           float v[kGroup]) {
  if (!vec) {
#pragma unroll
    for (int q = 0; q < kGroup; ++q) v[q] = x_at(a.x, a.x_i16, o + q);
  } else if (a.x_i16) {
    const uint4* p = reinterpret_cast<const uint4*>(static_cast<const int16_t*>(a.x) + o);
    const uint4 u0 = p[0], u1 = p[1];
    const uint32_t w[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      v[2 * q] = pcm(static_cast<int16_t>(w[q] & 0xFFFFu));
      v[2 * q + 1] = pcm(static_cast<int16_t>(w[q] >> 16));
    }
  } else {
    const float4* p = reinterpret_cast<const float4*>(static_cast<const float*>(a.x) + o);
#pragma unroll
    for (int q = 0; q < kGroup / 4; ++q) {
      const float4 f = p[q];
      v[4 * q] = f.x;
      v[4 * q + 1] = f.y;
      v[4 * q + 2] = f.z;
      v[4 * q + 3] = f.w;
    }
  }
}

// Group g of a chunk that starts at o, or zeros when `in` is false.
__device__ __forceinline__ void group_or_zero(const Apply& a, bool vec, bool in,
                                              long long o, int g, float v[kGroup]) {
  if (in) {
    load_group(a, vec, o + g * kGroup, v);
  } else {
#pragma unroll
    for (int q = 0; q < kGroup; ++q) v[q] = 0.f;
  }
}

// S_k: chunk k's running sum c + x*x over its 128 samples, from 0; the
// loads of 64 samples are in flight together.
__device__ __forceinline__ float chunk_total(const Apply& a, bool vec, long long o) {
  float c = 0.f;
#pragma unroll 1
  for (int h = 0; h < kTC; h += kTotalGroups * kGroup) {
    float v[kTotalGroups * kGroup];
#pragma unroll
    for (int g = 0; g < kTotalGroups; ++g) load_group(a, vec, o + h + g * kGroup, v + g * kGroup);
#pragma unroll
    for (int q = 0; q < kTotalGroups * kGroup; ++q) c = __fadd_rn(c, __fmul_rn(v[q], v[q]));
  }
  return c;
}

__device__ __forceinline__ float desired(float s, float target, float max_gain) {
  const float rms = __fsqrt_rn(fmaxf(s, 0.f));
  return fminf(fmaxf(__fdiv_rn(target, __fadd_rn(rms, 1e-10f)), 0.f), max_gain);
}

// Window warp w: the chunk totals and the desired gain of output chunks
// i = w (mod kWindowWarps), into d slot w.
__device__ __forceinline__ void window_role(const FusedArgs& a, float* dslot,
                                            uint64_t* full, uint64_t* empty,
                                            float* tot, int b0, int nb, int nch,
                                            int w, int lane) {
  const Apply& ap = a.ap;
  const int h = a.h, h2 = 2 * a.h, ring = 2 * kWindowWarps + h2;
  const bool live = lane < nb;
  const long long row = static_cast<long long>(b0 + lane) * ap.T;
  const bool vec = reinterpret_cast<uintptr_t>(ap.x) % 16 == 0;
  int lo = 0;  // the totals below lo are written
  for (int r = 0; r * kWindowWarps < nch; ++r) {
    const int hi = min(nch, (r + 1) * kWindowWarps + h);
    for (int k = lo + ((w - lo) % kWindowWarps + kWindowWarps) % kWindowWarps; k < hi;
         k += kWindowWarps)
      tot[(k % ring) * kStreams + lane] = live ? chunk_total(ap, vec, row + k * kTC) : 0.f;
    lo = hi;
    bar_sync<32 * kWindowWarps>(kBarRound);  // the round's totals are written
    const int i = r * kWindowWarps + w;
    if (i >= nch) continue;
    float base = 0.f;  // S_{i-h} .. S_{i+h-1} in slot order
    for (int s = 0; s < h2; ++s) {
      const int k = i - h + ((s - (i - h)) % h2 + h2) % h2;
      if (k >= 0 && k < nch) base = __fadd_rn(base, tot[(k % ring) * kStreams + lane]);
    }
    const bool in_n = live && i + h < nch, in_o = live && i - h >= 0;
    const long long on = row + (i + h) * kTC, oo = row + (i - h) * kTC;
    float xn[kGroup], xo[kGroup], nn[kGroup], no[kGroup];
    group_or_zero(ap, vec, in_n, on, 0, xn);
    group_or_zero(ap, vec, in_o, oo, 0, xo);
    const int use = i / kWindowWarps;  // of slot w
    if (use >= 1) mbar_wait(empty, (use - 1) & 1);  // chunk i - kWindowWarps read
    float cn = 0.f, co = 0.f;
#pragma unroll 1
    for (int g = 0; g < kTC / kGroup; ++g) {
      if (g + 1 < kTC / kGroup) {
        group_or_zero(ap, vec, in_n, on, g + 1, nn);
        group_or_zero(ap, vec, in_o, oo, g + 1, no);
      }
#pragma unroll
      for (int q = 0; q < kGroup; ++q) {
        const float W = __fadd_rn(__fsub_rn(base, co), cn);
        dslot[(g * kGroup + q) * kStreams + lane] =
            desired(__fmul_rn(W, a.inv_w), a.target, ap.max_gain);
        cn = __fadd_rn(cn, __fmul_rn(xn[q], xn[q]));
        co = __fadd_rn(co, __fmul_rn(xo[q], xo[q]));
      }
#pragma unroll
      for (int q = 0; q < kGroup; ++q) {
        xn[q] = nn[q];
        xo[q] = no[q];
      }
    }
    mbar_arrive(full);
  }
}

__global__ void __launch_bounds__(kThreads, 1) agc_fused_kernel(FusedArgs a) {
  extern __shared__ float4 smem4[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem4);  // [kWindowWarps]
  uint64_t* empty = full + kWindowWarps;                 // [kWindowWarps]
  float* ds = reinterpret_cast<float*>(empty + kWindowWarps);  // [kWindowWarps][kTC][32]
  float* gs = ds + kWindowWarps * kSlot;        // [2][32][kGStride] gains
  float* tot = gs + 2 * kStreams * kGStride;    // [2 kWindowWarps + 2h][32]
  const int b0 = blockIdx.x * kStreams;
  const int nb = min(kStreams, a.ap.B - b0);
  const int nch = a.ap.T / kTC;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < kWindowWarps) {
    mbar_init(full + threadIdx.x, 32);
    mbar_init(empty + threadIdx.x, 32);
  }
  __syncthreads();  // the mbarriers are initialised

  if (threadIdx.x >= kPairThreads) {
    const int w = (threadIdx.x - kPairThreads) / 32;
    window_role(a, ds + w * kSlot, full + w, empty + w, tot, b0, nb, nch, w, lane);
    return;
  }
  if (threadIdx.x >= 32) {
    apply_role(a.ap, gs, b0, nb, nch, threadIdx.x - 32);
    return;
  }
  // ---------------- the recurrence warp: one lane per stream
  const bool live = lane < nb;
  float g = live && a.init != nullptr ? a.init[b0 + lane] : 0.f;
  const Alphas al = alphas(a.a_att, a.a_rel);
  for (int i = 0; i < nch; ++i) {
    const int w = i % kWindowWarps;
    mbar_wait(full + w, (i / kWindowWarps) & 1);               // chunk i's d
    if (i >= 2) bar_sync<kPairThreads>(kBarEmpty + (i & 1));  // i - 2 applied
    float* gl = gs + ((i & 1) * kStreams + lane) * kGStride;
    g = run_chain(g, RowsD{ds + w * kSlot + lane}, kTC,
                  a.init == nullptr && i == 0, gl, al);
    mbar_arrive(empty + w);
    bar_arrive<kPairThreads>(kBarFull + (i & 1));
  }
  if (live) a.carry[b0 + lane] = clip_gain(g, a.ap.max_gain);
}

}  // namespace

// K14.  x [B, T] f32 or (x_i16) int16 PCM, the window w (w >= 256, w % 256
// == 0, T % 128 == 0) -> y [B, T] f32 or the pair (yh, yl), and carry [B];
// init [B] or null for the per-block restart.
extern "C" int afp_agc_fused(const void* x, const void* init, void* y,
                             void* yh, void* yl, void* carry, int B, int T,
                             int w, int x_i16, float a_att, float a_rel,
                             float target, float max_gain, float out_clip,
                             void* stream) {
  if (B <= 0 || T <= 0 || T % kTC || w < 2 * kTC || w % (2 * kTC) ||
      (y == nullptr && (yh == nullptr || yl == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  FusedArgs a;
  a.ap.x = x;
  a.ap.y = static_cast<float*>(y);
  a.ap.yh = static_cast<uint16_t*>(yh);
  a.ap.yl = static_cast<uint16_t*>(yl);
  a.ap.B = B;
  a.ap.T = T;
  a.ap.x_i16 = x_i16;
  a.ap.max_gain = max_gain;
  a.ap.out_clip = out_clip;
  a.ap.v_max = nullptr;
  a.init = static_cast<const float*>(init);
  a.carry = static_cast<float*>(carry);
  a.h = w / (2 * kTC);
  a.a_att = a_att;
  a.a_rel = a_rel;
  a.target = target;
  a.inv_w = static_cast<float>(1.0 / w);  // f32(1/w), as the reference's
  const size_t smem = 2 * kWindowWarps * sizeof(uint64_t) +
                      sizeof(float) * (kWindowWarps * kSlot + 2 * kStreams * kGStride +
                                       (2u * kWindowWarps + 2u * a.h) * kStreams);
  if (smem > 227u * 1024u) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      agc_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  agc_fused_kernel<<<(B + kStreams - 1) / kStreams, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
