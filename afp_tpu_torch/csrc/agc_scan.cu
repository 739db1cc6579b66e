// K6: the AGC attack/release recurrence, the gain clip, the apply and the
// carry, in one kernel; K9: the recurrence alone.
//
// Replaces `afp_tpu/ops/pallas/agc_scan.py:smooth_gain_apply_pallas`
// (`_agc_apply_call`, `_agc_apply_kernel`).  Per stream b, from the
// time-major desired gain d [T, B] and the start value g (the carry `init`;
// without one, d[0] or, blockwise, the first chunk mean):
//
//   a = d[t] > g ? a_att : a_rel;   g = a * d[t] + (1 - a) * g
//   y[b, t] = clip(x[b, t] * clip(g, 0.1, max_gain), -out_clip, out_clip)
//   carry[b] = clip(g_last, 0.1, max_gain)
//
// optionally storing y as its bf16 (hi, lo) pair for the pair-input conv
// (K8/K7).  x is f32 or, under `ingest='pcm16'`, the raw int16 PCM block or
// ring slot, converted n * 2^-15 as it is read (`agc_scan.py:273-277,
// 418-439`): exact, so the apply sees the bits of an f32 x of n/32768.
// The alphas and max_gain are scalars or, for per-stream AGC policies, [B]
// vectors on the device (any one promotes all three, `agc_scan.py:460-471`;
// blockwise alphas arrive compounded per stream), read once per stream by
// the lane that runs its recurrence.
// Blockwise ('fast' mode): one step per chunk mean (given, or the in-order
// sum of the chunk's rows times 1/chunk) with the compounded alphas from the
// wrapper, and the linear ramp g + (gn - g) * (t+1)/chunk
// inside the chunk.  The updates round as XLA's CPU backend evaluates the
// reference's expressions, a·d + (1−a)·g as fma(a, d, (1−a)·g) and the ramp
// as fma(gn − g, fr, g) (measured bit-exact against `afp_tpu` on the CPU);
// every operation is an explicit _rn intrinsic, so nvcc contracts nothing
// else and the kernel is bit-exact to the plain version (which computes the
// fma by rounding to odd in float64, `ops/agc.py:fma_f32`).
//
// What bounds it on H100 at the C8 shape (batch 4096, block 2048): the
// recurrence is serial in time for each stream, so only B = 4096 chains run
// in parallel, each 2048 dependent steps; the apply moves 32 MiB in and
// 32 MiB (or 2 x 16 MiB as the pair) out.  Design: a block of 256 threads
// owns 32 streams.  For each chunk of 128 time steps, all threads stage the
// chunk's d rows (one 128-byte row across the 32 streams per step) in shared
// memory; warp 0 runs the 32 recurrences over them from shared memory (no
// DRAM latency inside the serial chain) and writes the clipped gains back;
// then all 8 warps apply the gains to the [32, 128] tile of x, reading and
// writing along time so the batch-major x and y move coalesced.
//
// K9 replaces `afp_tpu/ops/pallas/agc_scan.py:smooth_gain_scan_pallas`
// (`_agc_scan_call`, `_agc_kernel`, `_agc_kernel_bm`): the exact recurrence
// alone, the drop-in for `ops.agc.smooth_gain_scan`.  From d (time-major
// [T, B], or batch-major [B, T]) and the carry `init`, or without one the
// restart g = d[0] at the first sample, it stores every g, unclipped, as
// [B, T] or time-major [T, B].  Its rounding is K6's step, so it equals the
// plain `smooth_gain_scan` bit for bit.  The same schedule as K6: per chunk
// of 128 steps all threads stage d in shared memory (coalesced along the
// batch for time-major d, along time for batch-major d: a transposed tile),
// warp 0 runs the 32 recurrences there, and all threads store the chunk in
// the requested layout, again coalesced (the batch-major store is the
// shared tile written transposed, as `_agc_kernel_bm` does).  Bound on H100
// at [4096, 2048]: 64 MiB of traffic (~20 us) against 4096 serial chains of
// 2048 steps: the chain's latency sets its time.
#include <cuda_runtime.h>

#include <cstdint>

#include "split.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStreams = 32;  // streams per block: one warp of recurrences
constexpr int kTC = 128;      // time steps per staged chunk

struct ScanArgs {
  const float* d;     // [T, B], or the chunk means [T / chunk, B]
  const void* x;      // [B, T] f32, or int16 PCM with x_i16 (a ring slot is
                      // passed as its own view)
  const float* init;  // [B] carried gain, or null
  float* y;           // [B, T] f32 output, or null with the pair
  uint16_t* yh;       // [B, T] bf16 pair output (raw bits), or null
  uint16_t* yl;
  float* carry;       // [B]
  int B, T;
  int chunk;    // 0: per-sample recurrence; else the blockwise chunk
  int d_means;  // blockwise: d holds the chunk means
  int x_i16;
  float a_att, a_rel, max_gain, out_clip;
  const float* v_att;  // [B] per-stream alphas and max gain, or null
  const float* v_rel;
  const float* v_max;
};

__device__ __forceinline__ float clip_gain(float g, float max_gain) {
  return fminf(fmaxf(g, 0.1f), max_gain);
}

__device__ __forceinline__ float step(float g, float d, float a_att,
                                      float a_rel) {
  const float a = d > g ? a_att : a_rel;
  return __fmaf_rn(a, d, __fmul_rn(__fsub_rn(1.f, a), g));
}

// Mean of `chunk` rows of stream column `col`, summed in row order.
__device__ __forceinline__ float chunk_mean(const float* rows, int stride,
                                            int chunk, float inv) {
  float s = rows[0];
  for (int q = 1; q < chunk; ++q) s = __fadd_rn(s, rows[q * stride]);
  return __fmul_rn(s, inv);
}

__global__ void __launch_bounds__(kThreads) agc_apply_kernel(ScanArgs a) {
  __shared__ float ds[kTC][kStreams];      // this chunk's d rows
  __shared__ float gs[kTC][kStreams + 1];  // clipped gains (padded: no conflicts)
  const int b0 = blockIdx.x * kStreams;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = b0 + lane;
  const bool live = b < a.B;
  const int nb = min(kStreams, a.B - b0);
  const bool means = a.chunk && a.d_means;
  const float inv = a.chunk ? 1.0f / static_cast<float>(a.chunk) : 0.f;

  float g = 0.f;  // the recurrence state, held by warp 0
  float a_att = a.a_att, a_rel = a.a_rel, max_gain = a.max_gain;
  if (warp == 0 && live) {
    if (a.v_att != nullptr) {
      a_att = a.v_att[b];
      a_rel = a.v_rel[b];
      max_gain = a.v_max[b];
    }
    if (a.init != nullptr)
      g = a.init[b];
    else if (a.chunk && !a.d_means)
      g = chunk_mean(a.d + b, a.B, a.chunk, inv);
    else
      g = a.d[b];
  }

  for (int tc = 0; tc < a.T; tc += kTC) {
    const int n = min(kTC, a.T - tc);  // time steps in this chunk
    const int nrows = means ? n / a.chunk : n;
    const int row0 = means ? tc / a.chunk : tc;
    for (int i = threadIdx.x; i < nrows * kStreams; i += kThreads) {
      const int r = i / kStreams;
      const int l = i - r * kStreams;
      ds[r][l] = l < nb ? a.d[static_cast<long long>(row0 + r) * a.B + b0 + l]
                        : 0.f;
    }
    __syncthreads();
    if (warp == 0) {
      if (!a.chunk) {
        for (int t = 0; t < n; ++t) {
          g = step(g, ds[t][lane], a_att, a_rel);
          gs[t][lane] = clip_gain(g, max_gain);
        }
      } else {
        for (int c = 0; c < n / a.chunk; ++c) {
          const float m = means ? ds[c][lane]
                                : chunk_mean(&ds[c * a.chunk][lane], kStreams,
                                             a.chunk, inv);
          const float gn = step(g, m, a_att, a_rel);
          const float dg = __fsub_rn(gn, g);
          for (int q = 0; q < a.chunk; ++q) {
            const float fr = __fmul_rn(static_cast<float>(q + 1), inv);
            gs[c * a.chunk + q][lane] =
                clip_gain(__fmaf_rn(dg, fr, g), max_gain);
          }
          g = gn;
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nb * n; i += kThreads) {
      const int r = i / n;
      const int t = i - r * n;
      const long long o = static_cast<long long>(b0 + r) * a.T + tc + t;
      const float xv =
          a.x_i16 ? __fmul_rn(static_cast<float>(
                                  static_cast<const int16_t*>(a.x)[o]),
                              1.0f / 32768.0f)
                  : static_cast<const float*>(a.x)[o];
      const float v = fminf(fmaxf(__fmul_rn(xv, gs[t][r]), -a.out_clip),
                            a.out_clip);
      if (a.y != nullptr) {
        a.y[o] = v;
      } else {
        const float2 s = afp::split_bf16(v);
        a.yh[o] = afp::bf16_bits(s.x);
        a.yl[o] = afp::bf16_bits(s.y);
      }
    }
    __syncthreads();  // ds and gs are rewritten by the next chunk
  }
  if (warp == 0 && live) a.carry[b] = clip_gain(g, max_gain);
}

struct ScanOnlyArgs {
  const float* d;     // [T, B] (time-major) or [B, T]
  const float* init;  // [B] carried gain, or null (restart at d[0])
  float* out;         // [B, T] or (out_time_major) [T, B]
  int B, T, d_time_major, out_time_major;
  float a_att, a_rel;
};

__global__ void __launch_bounds__(kThreads) agc_scan_kernel(ScanOnlyArgs a) {
  __shared__ float ds[kTC][kStreams + 1];  // this chunk: d, then g (padded)
  const int b0 = blockIdx.x * kStreams;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nb = min(kStreams, a.B - b0);

  float g = 0.f;  // the recurrence state, held by warp 0
  if (warp == 0 && lane < nb && a.init != nullptr) g = a.init[b0 + lane];

  for (int tc = 0; tc < a.T; tc += kTC) {
    const int n = min(kTC, a.T - tc);  // time steps in this chunk
    for (int i = threadIdx.x; i < n * kStreams; i += kThreads) {
      int t, l;
      if (a.d_time_major) {
        t = i / kStreams;
        l = i - t * kStreams;
      } else {
        l = i / n;
        t = i - l * n;
      }
      ds[t][l] = l >= nb ? 0.f
                 : a.d_time_major
                     ? a.d[static_cast<long long>(tc + t) * a.B + b0 + l]
                     : a.d[static_cast<long long>(b0 + l) * a.T + tc + t];
    }
    __syncthreads();
    if (warp == 0) {
      for (int t = 0; t < n; ++t) {
        const float d = ds[t][lane];
        g = a.init == nullptr && tc + t == 0 ? d : step(g, d, a.a_att, a.a_rel);
        ds[t][lane] = g;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n * nb; i += kThreads) {
      if (a.out_time_major) {
        const int t = i / nb;
        const int l = i - t * nb;
        a.out[static_cast<long long>(tc + t) * a.B + b0 + l] = ds[t][l];
      } else {
        const int l = i / n;
        const int t = i - l * n;
        a.out[static_cast<long long>(b0 + l) * a.T + tc + t] = ds[t][l];
      }
    }
    __syncthreads();  // ds is rewritten by the next chunk
  }
}

}  // namespace

// K9.  d [T, B] (d_time_major) or [B, T] -> g [B, T] or (out_time_major)
// [T, B], from init [B] or, when null, the restart at d[0].
extern "C" int afp_agc_scan(const void* d, const void* init, void* out, int B,
                            int T, int d_time_major, int out_time_major,
                            float a_att, float a_rel, void* stream) {
  if (B <= 0 || T <= 0) return static_cast<int>(cudaErrorInvalidValue);
  ScanOnlyArgs a;
  a.d = static_cast<const float*>(d);
  a.init = static_cast<const float*>(init);
  a.out = static_cast<float*>(out);
  a.B = B;
  a.T = T;
  a.d_time_major = d_time_major;
  a.out_time_major = out_time_major;
  a.a_att = a_att;
  a.a_rel = a_rel;
  agc_scan_kernel<<<(B + kStreams - 1) / kStreams, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// K6.  d [T, B] (or [T/chunk, B] means), x [B, T] f32 or (x_i16) int16 PCM
// -> y [B, T] f32 or the pair (yh, yl), and carry [B].  a_att/a_rel arrive
// compounded when blockwise (chunk > 0).  v_att/v_rel/v_max: [B] per-stream
// values (all three or none), else the scalars.
extern "C" int afp_agc_apply(const void* d, const void* x, const void* init,
                             void* y, void* yh, void* yl, void* carry, int B,
                             int T, int chunk, int d_means, int x_i16,
                             float a_att, float a_rel, float max_gain,
                             float out_clip, const void* v_att,
                             const void* v_rel, const void* v_max,
                             void* stream) {
  if (B <= 0 || T <= 0 || chunk < 0 || (chunk && (kTC % chunk || T % chunk)) ||
      (d_means && !chunk) || (y == nullptr && (yh == nullptr || yl == nullptr)) ||
      (v_att == nullptr) != (v_rel == nullptr) ||
      (v_att == nullptr) != (v_max == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  ScanArgs a;
  a.d = static_cast<const float*>(d);
  a.x = x;
  a.init = static_cast<const float*>(init);
  a.y = static_cast<float*>(y);
  a.yh = static_cast<uint16_t*>(yh);
  a.yl = static_cast<uint16_t*>(yl);
  a.carry = static_cast<float*>(carry);
  a.B = B;
  a.T = T;
  a.chunk = chunk;
  a.d_means = d_means;
  a.x_i16 = x_i16;
  a.a_att = a_att;
  a.a_rel = a_rel;
  a.max_gain = max_gain;
  a.out_clip = out_clip;
  a.v_att = static_cast<const float*>(v_att);
  a.v_rel = static_cast<const float*>(v_rel);
  a.v_max = static_cast<const float*>(v_max);
  agc_apply_kernel<<<(B + kStreams - 1) / kStreams, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
