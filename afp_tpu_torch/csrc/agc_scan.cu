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
// What bounds it on H100 at the C8 shape (batch 4096, block 2048): the apply
// moves 32 MiB in and 32 MiB (or 2 x 16 MiB as the pair) out, ~20 us at
// 3.35 TB/s; the recurrence is serial in time for each stream, so only
// B = 4096 chains run, each 2048 dependent steps, one warp of 32 a block:
// alone (the x/y traffic cut from a copy, `chip_agc_ablate.py`) they take
// 0.036 ms on an H100 80GB HBM3 at 700 W, the apply's traffic alone 0.040.
// The aim is the larger of the two, not their sum.
//
// Design (the roles, the step and the barrier protocol are in
// `agc_roles.cuh`, shared with K9 and K14): a block owns 32 streams.  Warp
// 0 runs the 32 recurrences, one lane a stream: it stages d's rows (128
// bytes across the block's streams per step) into a ring of three chunks
// with cp.async, two chunks ahead, and writes the raw gains of chunk c into
// one of two gain buffers, 4 steps a 16-byte store, while 8 more warps
// apply chunk c - 1 from the other.  An apply thread owns two runs of 8
// samples of a stream per chunk and moves 16 bytes at a time: two float4 of
// x (or 8 int16), two float4 of y or 8 bf16 halves of each pair store; it
// loads chunk c + 1's x before it waits for chunk c's gains, and it clips
// the gains (the recurrence warp's issue slots are the chain's).
//
// K9 replaces `afp_tpu/ops/pallas/agc_scan.py:smooth_gain_scan_pallas`
// (`_agc_scan_call`, `_agc_kernel`, `_agc_kernel_bm`): the exact recurrence
// alone, the drop-in for `ops.agc.smooth_gain_scan`.  From d (time-major
// [T, B], or batch-major [B, T]) and the carry `init`, or without one the
// restart g = d[0] at the first sample (stored as it is: no step, unlike
// K6's start), it stores every g, unclipped, as [B, T] or time-major
// [T, B], so it equals the plain `smooth_gain_scan` bit for bit.
// Bound on H100 at [4096, 2048]: 64 MiB of traffic (~20 us) against 4096
// serial chains of 2048 steps, so the store must hide behind the chain.
// Design: K6's schedule with a store in place of the apply.  Warp 0 stages
// d two chunks ahead with cp.async and runs the chain; 8 store warps drain
// the other gain buffer.  Time-major d is staged as K6 stages it; batch-major d
// in 16-byte copies along time (512 contiguous bytes a row) into a
// [32][128] tile whose 16-byte groups are XOR-swizzled by stream (group q
// of row r at q ^ (r & 7)), so a lane reads its 4 next steps as one float4
// without bank conflicts.  The batch-major store writes 16-byte runs along
// time, as K6's y store; the time-major store writes 128-byte rows across
// the block's streams.  Where T is not a multiple of 4 (or 8 for the
// store) or d is not 16-byte aligned, the same kernel takes 4-byte copies.
// Measured (`chip_agc_ablate.py`, H100 80GB HBM3 at 700 W): 0.042 ms from
// time-major d into the batch-major store, its chain with the d staging
// alone 0.035: the chain sets its time.
#include <cuda_runtime.h>

#include <cstdint>

#include "agc_roles.cuh"

namespace {

using namespace afp_agc;

constexpr int kDRing = 3;  // d chunks staged: the current, two ahead
constexpr int kSlot = kTC * kStreams;  // floats of one staged d chunk

struct ScanArgs {
  Apply ap;           // x, y or the pair, B, T, max_gain, out_clip, v_max
  const float* d;     // [T, B], or the chunk means [T / chunk, B]
  const float* init;  // [B] carried gain, or null
  float* carry;       // [B]
  int chunk;    // 0: per-sample recurrence; else the blockwise chunk
  int d_means;  // blockwise: d holds the chunk means
  float a_att, a_rel;
  const float* v_att;  // [B] per-stream alphas, or null
  const float* v_rel;
};

// Mean of `chunk` rows of stream column `col`, summed in row order.
__device__ __forceinline__ float chunk_mean(const float* rows, int stride,
                                            int chunk, float inv) {
  float s = rows[0];
  for (int q = 1; q < chunk; ++q) s = __fadd_rn(s, rows[q * stride]);
  return __fmul_rn(s, inv);
}

// Rows of d that chunk k (steps k*kTC ...) reads, and the first of them.
__device__ __forceinline__ int2 d_rows(const ScanArgs& a, int k) {
  const int n = min(kTC, a.ap.T - k * kTC);
  const bool means = a.chunk && a.d_means;
  return make_int2(means ? k * kTC / a.chunk : k * kTC, means ? n / a.chunk : n);
}

__global__ void __launch_bounds__(kPairThreads, 1) agc_apply_kernel(ScanArgs a) {
  extern __shared__ float4 smem4[];
  float* ds = reinterpret_cast<float*>(smem4);  // [kDRing][kTC][32] d rows
  float* gs = ds + kDRing * kSlot;              // [2][32][kGStride] gains
  const int B = a.ap.B, T = a.ap.T;
  const int b0 = blockIdx.x * kStreams;
  const int nb = min(kStreams, B - b0);
  const int nch = (T + kTC - 1) / kTC;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x < 32) {
    // ---------------- the recurrence warp: one lane per stream
    const int b = b0 + lane;
    const bool live = lane < nb;
    const bool means = a.chunk && a.d_means;
    const float inv = a.chunk ? 1.0f / static_cast<float>(a.chunk) : 0.f;
    const bool wide = nb == kStreams && B % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(a.d) % 16 == 0;
    float g = 0.f;
    float a_att = a.a_att, a_rel = a.a_rel, max_gain = a.ap.max_gain;
    if (live) {
      if (a.v_att != nullptr) {
        a_att = a.v_att[b];
        a_rel = a.v_rel[b];
        max_gain = a.ap.v_max[b];
      }
      if (a.init != nullptr)
        g = a.init[b];
      else if (a.chunk && !a.d_means)
        g = chunk_mean(a.d + b, B, a.chunk, inv);
      else
        g = a.d[b];
    }
    const Alphas al = alphas(a_att, a_rel);
    for (int k = 0; k < 2; ++k) {
      const int2 rows = k < nch ? d_rows(a, k) : make_int2(0, 0);
      stage_rows(a.d, B, rows.x, rows.y, b0, nb, wide, ds + k * kSlot, lane);
    }
    for (int c = 0; c < nch; ++c) {
      const int k = c + 2;
      const int2 rows = k < nch ? d_rows(a, k) : make_int2(0, 0);
      // slot k % 3 held chunk c - 1, which every lane read column by column:
      // all lanes are past those reads before a 16-byte copy refills it
      __syncwarp();
      stage_rows(a.d, B, rows.x, rows.y, b0, nb, wide, ds + (k % kDRing) * kSlot, lane);
      asm volatile("cp.async.wait_group 2;" ::: "memory");  // chunk c landed
      __syncwarp();
      if (c >= 2) bar_sync<kPairThreads>(kBarEmpty + (c & 1));  // c - 2 applied
      const float* dc = ds + (c % kDRing) * kSlot + lane;
      float* gl = gs + ((c & 1) * kStreams + lane) * kGStride;
      const int n = min(kTC, T - c * kTC);
      if (!a.chunk) {
        g = run_chain(g, RowsD{dc}, n, false, gl, al);
      } else {
        for (int cc = 0; cc < n / a.chunk; ++cc) {
          const float m = means ? dc[cc * kStreams]
                                : chunk_mean(dc + cc * a.chunk * kStreams, kStreams,
                                             a.chunk, inv);
          const float gn = step2(g, m, al.att, al.om_att, al.rel, al.om_rel);
          const float dg = __fsub_rn(gn, g);
          for (int q = 0; q < a.chunk; ++q) {
            const float fr = __fmul_rn(static_cast<float>(q + 1), inv);
            gl[cc * a.chunk + q] = __fmaf_rn(dg, fr, g);
          }
          g = gn;
        }
      }
      bar_arrive<kPairThreads>(kBarFull + (c & 1));
    }
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    if (live) a.carry[b] = clip_gain(g, max_gain);
    return;
  }
  apply_role(a.ap, gs, b0, nb, nch, threadIdx.x - 32);
}

// ---------------------------------------------------------------- K9

struct ScanOnlyArgs {
  const float* d;     // [T, B] (time-major) or [B, T]
  const float* init;  // [B] carried gain, or null (restart at d[0])
  float* out;         // [B, T] or (out_time_major) [T, B]
  int B, T, d_time_major, out_time_major;
  float a_att, a_rel;
};

// A batch-major d chunk in its swizzled tile [32][kTC]: the 16-byte group
// q (steps 4q .. 4q+3) of row r sits at group q ^ (r & 7).
__device__ __forceinline__ int tile_at(int r, int t) {
  return r * kTC + (((t >> 2) ^ (r & 7)) << 2) + (t & 3);
}

struct TileD {
  const float* tile;
  int r;  // the lane's row
  __device__ __forceinline__ float at(int t) const { return tile[tile_at(r, t)]; }
  __device__ __forceinline__ float4 quad(int t) const {
    return *reinterpret_cast<const float4*>(tile + tile_at(r, t));
  }
};

// Stage steps t0 .. t0+n-1 of the block's nb rows of batch-major d into the
// tile with cp.async: 16-byte copies along time when T % 4 == 0 and d is
// 16-byte aligned (`vec`: each warp instruction copies one row's 512
// contiguous bytes), else 4-byte copies.  One commit group.
__device__ __forceinline__ void stage_tile(const ScanOnlyArgs& a, int t0, int n,
                                           int b0, int nb, bool vec, float* dst,
                                           int lane) {
  if (vec) {
    for (int i = lane; i < nb * (kTC / 4); i += 32) {
      const int r = i / (kTC / 4), q = i % (kTC / 4);
      if (4 * q < n)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                         smem_addr(dst + tile_at(r, 4 * q))),
                     "l"(a.d + static_cast<long long>(b0 + r) * a.T + t0 + 4 * q)
                     : "memory");
    }
  } else {
    for (int i = lane; i < nb * kTC; i += 32) {
      const int r = i / kTC, t = i % kTC;
      if (t < n)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                         smem_addr(dst + tile_at(r, t))),
                     "l"(a.d + static_cast<long long>(b0 + r) * a.T + t0 + t)
                     : "memory");
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__global__ void __launch_bounds__(kPairThreads, 1) agc_scan_kernel(ScanOnlyArgs a) {
  extern __shared__ float4 smem4[];
  float* ds = reinterpret_cast<float*>(smem4);  // [kDRing] d chunks
  float* gs = ds + kDRing * kSlot;              // [2][32][kGStride] gains
  const int b0 = blockIdx.x * kStreams;
  const int nb = min(kStreams, a.B - b0);
  const int nch = (a.T + kTC - 1) / kTC;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x < 32) {
    // ---------------- the recurrence warp: one lane per stream
    float g = 0.f;
    if (lane < nb && a.init != nullptr) g = a.init[b0 + lane];
    const Alphas al = alphas(a.a_att, a.a_rel);
    const bool vec = a.d_time_major
                         ? nb == kStreams && a.B % 4 == 0 &&
                               reinterpret_cast<uintptr_t>(a.d) % 16 == 0
                         : a.T % 4 == 0 && reinterpret_cast<uintptr_t>(a.d) % 16 == 0;
    auto stage = [&](int k) {
      float* dst = ds + (k % kDRing) * kSlot;
      const int n = k < nch ? min(kTC, a.T - k * kTC) : 0;
      if (a.d_time_major)
        stage_rows(a.d, a.B, k * kTC, n, b0, nb, vec, dst, lane);
      else
        stage_tile(a, k * kTC, n, b0, nb, vec, dst, lane);
    };
    stage(0);
    stage(1);
    for (int c = 0; c < nch; ++c) {
      __syncwarp();  // every lane is past its reads of slot (c + 2) % 3
      stage(c + 2);
      asm volatile("cp.async.wait_group 2;" ::: "memory");  // chunk c landed
      __syncwarp();
      if (c >= 2) bar_sync<kPairThreads>(kBarEmpty + (c & 1));  // c - 2 stored
      const float* slot = ds + (c % kDRing) * kSlot;
      float* gl = gs + ((c & 1) * kStreams + lane) * kGStride;
      const int n = min(kTC, a.T - c * kTC);
      const bool restart = a.init == nullptr && c == 0;
      g = a.d_time_major ? run_chain(g, RowsD{slot + lane}, n, restart, gl, al)
                         : run_chain(g, TileD{slot, lane}, n, restart, gl, al);
      bar_arrive<kPairThreads>(kBarFull + (c & 1));
    }
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    return;
  }

  // ---------------- the store warps
  const int ct = threadIdx.x - 32;
  const bool vec = a.T % kRun == 0 && reinterpret_cast<uintptr_t>(a.out) % 16 == 0;
  for (int c = 0; c < nch; ++c) {
    bar_sync<kPairThreads>(kBarFull + (c & 1));
    const float* gb = gs + (c & 1) * kStreams * kGStride;
    const int n = min(kTC, a.T - c * kTC);
    if (a.out_time_major) {
      // a warp writes one step's 128 bytes across the block's streams
      for (int it = ct; it < n * kStreams; it += 32 * kConsumerWarps) {
        const int t = it / kStreams, l = it % kStreams;
        if (l < nb)
          a.out[static_cast<long long>(c * kTC + t) * a.B + b0 + l] = gb[l * kGStride + t];
      }
    } else {
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int it = ct + u * 32 * kConsumerWarps;
        const int r = it / kRuns, j = it % kRuns;
        if (r >= nb || j * kRun >= n) continue;
        const float* g = gb + r * kGStride + j * kRun;
        float* o = a.out + static_cast<long long>(b0 + r) * a.T + c * kTC + j * kRun;
        if (vec) {
          reinterpret_cast<float4*>(o)[0] = *reinterpret_cast<const float4*>(g);
          reinterpret_cast<float4*>(o)[1] = *reinterpret_cast<const float4*>(g + 4);
        } else {
          for (int q = 0; q < min(kRun, n - j * kRun); ++q) o[q] = g[q];
        }
      }
    }
    if (c + 2 < nch) bar_arrive<kPairThreads>(kBarEmpty + (c & 1));
  }
}

constexpr size_t kSmem = sizeof(float) * (kDRing * kSlot + 2 * kStreams * kGStride);

cudaError_t allow_smem(const void* kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(kSmem));
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
  const cudaError_t err = allow_smem(reinterpret_cast<const void*>(agc_scan_kernel));
  if (err != cudaSuccess) return static_cast<int>(err);
  agc_scan_kernel<<<(B + kStreams - 1) / kStreams, kPairThreads, kSmem,
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
  a.ap.x = x;
  a.ap.y = static_cast<float*>(y);
  a.ap.yh = static_cast<uint16_t*>(yh);
  a.ap.yl = static_cast<uint16_t*>(yl);
  a.ap.B = B;
  a.ap.T = T;
  a.ap.x_i16 = x_i16;
  a.ap.max_gain = max_gain;
  a.ap.out_clip = out_clip;
  a.ap.v_max = static_cast<const float*>(v_max);
  a.d = static_cast<const float*>(d);
  a.init = static_cast<const float*>(init);
  a.carry = static_cast<float*>(carry);
  a.chunk = chunk;
  a.d_means = d_means;
  a.a_att = a_att;
  a.a_rel = a_rel;
  a.v_att = static_cast<const float*>(v_att);
  a.v_rel = static_cast<const float*>(v_rel);
  const cudaError_t err = allow_smem(reinterpret_cast<const void*>(agc_apply_kernel));
  if (err != cudaSuccess) return static_cast<int>(err);
  agc_apply_kernel<<<(B + kStreams - 1) / kStreams, kPairThreads, kSmem,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
