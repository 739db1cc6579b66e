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
// ring-slot order (slot k mod 2h), from 0; W is (base - C_old) + C_new; the
// recurrence is fma(a, d, (1 - a) * g).  Every operation is an explicit _rn
// intrinsic, so nvcc contracts nothing else and the kernel equals its plain
// version (`ops/cuda/agc_fused.py:agc_rms_apply_plain`) bit for bit.
//
// The TPU schedule does not carry over: its h-chunk lag, three HBM views of
// x per grid step, masked pre-lag writes and VMEM tile ladder exist because
// a TPU grid walks chunks in order with the carry in scratch.  Here a block
// of 256 threads owns 32 streams and walks the same steps j = 0 .. nch+h-1
// itself (step j closes chunk j's total and finishes output chunk j - h):
// all threads stage the squares of chunk j and of chunk j - 2h (transposed,
// coalesced along time) in shared memory; warp 0 runs the two running sums
// and writes W; all threads turn W into d (the sqrt and the division, off the
// serial chain); warp 0 runs the recurrence and writes the clipped gains;
// all threads apply them to chunk j - h, read and written along time.  The
// 2h chunk totals live in a shared ring, slot j mod 2h, as on the TPU.
//
// What bounds it on H100 at the C8 point (batch 4096, block 2048, w 512):
// 32 MiB of x in and 32 MiB (or 2 x 16 MiB as the pair) out, ~20 us of
// bytes; but the recurrence is serial in time per stream, so only 4096
// chains (128 warps, one per SM) run, each 2048 dependent steps plus the
// two running sums: latency, not bytes or operations, sets its time.
#include <cuda_runtime.h>

#include <cstdint>

#include "split.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStreams = 32;  // streams per block: one warp of recurrences
constexpr int kTC = 128;      // the chunk of the window decomposition
constexpr int kPad = kStreams + 1;  // shared rows padded: no bank conflicts

struct FusedArgs {
  const void* x;      // [B, T] f32, or int16 PCM with x_i16 (a ring slot is
                      // passed as its own view)
  const float* init;  // [B] carried gain, or null (restart)
  float* y;           // [B, T] f32 output, or null with the pair
  uint16_t* yh;       // [B, T] bf16 pair output (raw bits), or null
  uint16_t* yl;
  float* carry;       // [B]
  int B, T, h, x_i16;
  float a_att, a_rel, target, max_gain, out_clip, inv_w;
};

__device__ __forceinline__ float clip_gain(float g, float max_gain) {
  return fminf(fmaxf(g, 0.1f), max_gain);
}

__device__ __forceinline__ float load_x(const FusedArgs& a, long long o) {
  return a.x_i16 ? __fmul_rn(static_cast<float>(
                                 static_cast<const int16_t*>(a.x)[o]),
                             1.0f / 32768.0f)
                 : static_cast<const float*>(a.x)[o];
}

// Stage the squares of chunk k of the block's streams, time-major, into
// sq[t][r]; zeros for a chunk outside the block and for rows beyond B.
__device__ __forceinline__ void stage_squares(const FusedArgs& a, int b0,
                                              int nb, int k, int nch,
                                              float* sq) {
  const bool in = k >= 0 && k < nch;
  for (int i = threadIdx.x; i < kStreams * kTC; i += kThreads) {
    const int r = i / kTC;
    const int t = i - r * kTC;
    float v = 0.f;
    if (in && r < nb) {
      const float xv =
          load_x(a, static_cast<long long>(b0 + r) * a.T + k * kTC + t);
      v = __fmul_rn(xv, xv);
    }
    sq[t * kPad + r] = v;
  }
}

__global__ void __launch_bounds__(kThreads) agc_fused_kernel(FusedArgs a) {
  extern __shared__ float smem[];
  float* sq_new = smem;                // [kTC][kPad] squares of chunk j
  float* sq_old = sq_new + kTC * kPad;  // [kTC][kPad] squares of chunk j-2h
  float* wd = sq_old + kTC * kPad;      // [kTC][kPad] W, then d, then gains
  float* sring = wd + kTC * kPad;       // [2h][kStreams] chunk totals

  const int b0 = blockIdx.x * kStreams;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nb = min(kStreams, a.B - b0);
  const bool live = warp == 0 && lane < nb;
  const int h2 = 2 * a.h;
  const int nch = a.T / kTC;

  float g = 0.f;  // the recurrence state, held by warp 0
  if (live && a.init != nullptr) g = a.init[b0 + lane];
  for (int i = threadIdx.x; i < h2 * kStreams; i += kThreads) sring[i] = 0.f;

  for (int j = 0; j < nch + a.h; ++j) {
    const bool out = j >= a.h;  // step j finishes output chunk j - h
    stage_squares(a, b0, nb, j, nch, sq_new);
    if (out) stage_squares(a, b0, nb, j - h2, nch, sq_old);
    __syncthreads();
    if (warp == 0) {
      // base: the 2h totals before this step's, in slot order
      float base = 0.f;
      for (int s = 0; s < h2; ++s) base = __fadd_rn(base, sring[s * kStreams + lane]);
      float cn = 0.f, co = 0.f;
      if (out) {
        for (int t = 0; t < kTC; ++t) {
          wd[t * kPad + lane] = __fadd_rn(__fsub_rn(base, co), cn);
          cn = __fadd_rn(cn, sq_new[t * kPad + lane]);
          co = __fadd_rn(co, sq_old[t * kPad + lane]);
        }
      } else {
        for (int t = 0; t < kTC; ++t) cn = __fadd_rn(cn, sq_new[t * kPad + lane]);
      }
      sring[(j % h2) * kStreams + lane] = cn;  // S_j
    }
    if (!out) {
      __syncthreads();
      continue;
    }
    __syncthreads();
    // the desired gain of every (sample, stream) of the chunk
    for (int i = threadIdx.x; i < kTC * kStreams; i += kThreads) {
      const int t = i / kStreams;
      const int l = i - t * kStreams;
      const float W = wd[t * kPad + l];
      const float rms = __fsqrt_rn(fmaxf(__fmul_rn(W, a.inv_w), 0.f));
      wd[t * kPad + l] = fminf(
          fmaxf(__fdiv_rn(a.target, __fadd_rn(rms, 1e-10f)), 0.f), a.max_gain);
    }
    __syncthreads();
    const int ic = j - a.h;  // the output chunk
    if (warp == 0) {
      for (int t = 0; t < kTC; ++t) {
        const float d = wd[t * kPad + lane];
        if (a.init == nullptr && ic == 0 && t == 0) {
          g = d;  // the restart: g_{-1} := d[0]
        } else {
          const float al = d > g ? a.a_att : a.a_rel;
          g = __fmaf_rn(al, d, __fmul_rn(__fsub_rn(1.f, al), g));
        }
        wd[t * kPad + lane] = clip_gain(g, a.max_gain);
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nb * kTC; i += kThreads) {
      const int r = i / kTC;
      const int t = i - r * kTC;
      const long long o = static_cast<long long>(b0 + r) * a.T + ic * kTC + t;
      const float v = fminf(
          fmaxf(__fmul_rn(load_x(a, o), wd[t * kPad + r]), -a.out_clip),
          a.out_clip);
      if (a.y != nullptr) {
        a.y[o] = v;
      } else {
        const float2 s = afp::split_bf16(v);
        a.yh[o] = afp::bf16_bits(s.x);
        a.yl[o] = afp::bf16_bits(s.y);
      }
    }
    __syncthreads();  // wd and the staged squares are rewritten next step
  }
  if (live) a.carry[b0 + lane] = clip_gain(g, a.max_gain);
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
  a.x = x;
  a.init = static_cast<const float*>(init);
  a.y = static_cast<float*>(y);
  a.yh = static_cast<uint16_t*>(yh);
  a.yl = static_cast<uint16_t*>(yl);
  a.carry = static_cast<float*>(carry);
  a.B = B;
  a.T = T;
  a.h = w / (2 * kTC);
  a.x_i16 = x_i16;
  a.a_att = a_att;
  a.a_rel = a_rel;
  a.target = target;
  a.max_gain = max_gain;
  a.out_clip = out_clip;
  a.inv_w = static_cast<float>(1.0 / w);  // f32(1/w), as the reference's
  const size_t smem = sizeof(float) * (3u * kTC * kPad + 2u * a.h * kStreams);
  if (smem > 227u * 1024u) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      agc_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  agc_fused_kernel<<<(B + kStreams - 1) / kStreams, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
