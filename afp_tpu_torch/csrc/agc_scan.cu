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
// The aim is the larger of the two, not their sum.  The first
// design (per chunk of 128 steps: all warps stage d, warp 0 alone runs the
// chain while 7 warps wait, then all apply, one 4-byte load at a time with a
// division per element) added them up 16 times a block: 0.256 ms.
//
// Design: a block owns 32 streams and runs two roles at once.  Warp 0 runs
// the 32 recurrences, one lane a stream: it stages d's rows (128 bytes
// across the block's streams per step) into a ring of three chunks with
// cp.async, two chunks ahead, and writes the clipped gains of chunk c into
// one of two gain buffers while 8 more warps apply chunk c - 1 from the
// other.  Named barriers pair the roles (`bar.arrive` by the producer,
// `bar.sync` by the consumers for a full buffer, and the reverse for an
// empty one), so no whole-block barrier stalls the chain.  A consumer thread
// owns two runs of 8 samples of a stream per chunk and moves 16 bytes at a
// time: two float4 of x (or 8 int16), two float4 of y or 8 bf16 halves of
// each pair store; it loads chunk c + 1's x before it waits for chunk c's
// gains, since x does not depend on g.  The step keeps its bits with a
// shorter dependent path: both candidates fma(a, d, (1 - a) * g), 1 - a
// hoisted, then the select by d > g (multiply -> fma -> select).  The
// producer writes its raw gains 4 steps at a time as one 16-byte store, and
// the apply warps clip them (the recurrence warp's issue slots are the
// chain's).
//
// K9 replaces `afp_tpu/ops/pallas/agc_scan.py:smooth_gain_scan_pallas`
// (`_agc_scan_call`, `_agc_kernel`, `_agc_kernel_bm`): the exact recurrence
// alone, the drop-in for `ops.agc.smooth_gain_scan`.  From d (time-major
// [T, B], or batch-major [B, T]) and the carry `init`, or without one the
// restart g = d[0] at the first sample, it stores every g, unclipped, as
// [B, T] or time-major [T, B].  Its rounding is K6's step, so it equals the
// plain `smooth_gain_scan` bit for bit.  Per chunk of 128 steps all threads
// stage d in shared memory (coalesced along the batch for time-major d,
// along time for batch-major d: a transposed tile), warp 0 runs the 32
// recurrences there, and all threads store the chunk in the requested
// layout, again coalesced (the batch-major store is the shared tile written
// transposed, as `_agc_kernel_bm` does).  Bound on H100 at [4096, 2048]:
// 64 MiB of traffic (~20 us) against 4096 serial chains of 2048 steps: the
// chain's latency sets its time.
#include <cuda_runtime.h>

#include <cstdint>

#include "split.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStreams = 32;  // streams per block: one warp of recurrences
constexpr int kTC = 128;      // time steps per staged chunk

// K6's block: the recurrence warp, then the apply warps
constexpr int kApplyWarps = 8;
constexpr int kApplyThreads = 32 * (kApplyWarps + 1);
constexpr int kRun = 8;               // samples per consumer run (32 bytes of f32)
constexpr int kRuns = kTC / kRun;     // runs per stream and chunk
constexpr int kDRing = 3;             // d chunks staged: the current, two ahead
constexpr int kGStride = kTC + 4;     // gain rows, 16-byte aligned
constexpr int kBarFull = 1;           // named barriers 1, 2: gains ready
constexpr int kBarEmpty = 3;          // 3, 4: gains applied

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

// `step` with 1 - a hoisted (om_* = __fsub_rn(1, a_*)): the same operations
// on the same values, so the same bits, with the select last.
__device__ __forceinline__ float step2(float g, float d, float a_att,
                                       float om_att, float a_rel,
                                       float om_rel) {
  const float ga = __fmaf_rn(a_att, d, __fmul_rn(om_att, g));
  const float gr = __fmaf_rn(a_rel, d, __fmul_rn(om_rel, g));
  return d > g ? ga : gr;
}

// Mean of `chunk` rows of stream column `col`, summed in row order.
__device__ __forceinline__ float chunk_mean(const float* rows, int stride,
                                            int chunk, float inv) {
  float s = rows[0];
  for (int q = 1; q < chunk; ++q) s = __fadd_rn(s, rows[q * stride]);
  return __fmul_rn(s, inv);
}

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(kApplyThreads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(kApplyThreads) : "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Stage chunk k's rows of d (n_rows rows of the block's nb streams) into
// `dst` [kTC][32] with cp.async: 16-byte copies when the rows are whole and
// aligned, else 4-byte copies that zero-fill the streams beyond B.
__device__ __forceinline__ void stage_d(const ScanArgs& a, int row0,
                                        int n_rows, int b0, int nb, bool wide,
                                        float* dst, int lane) {
  if (wide) {
    for (int i = lane; i < n_rows * (kStreams / 4); i += 32) {
      const int r = i / (kStreams / 4), q = i % (kStreams / 4);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                       smem_addr(dst + r * kStreams + 4 * q)),
                   "l"(a.d + static_cast<long long>(row0 + r) * a.B + b0 + 4 * q)
                   : "memory");
    }
  } else {
    for (int r = 0; r < n_rows; ++r) {
      const bool in = lane < nb;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                       smem_addr(dst + r * kStreams + lane)),
                   "l"(a.d + (in ? static_cast<long long>(row0 + r) * a.B + b0 + lane
                                 : 0)),
                   "r"(in ? 4 : 0)
                   : "memory");
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Rows of d that chunk k (steps k*kTC ...) reads, and the first of them.
__device__ __forceinline__ int2 d_rows(const ScanArgs& a, int k) {
  const int n = min(kTC, a.T - k * kTC);
  const bool means = a.chunk && a.d_means;
  return make_int2(means ? k * kTC / a.chunk : k * kTC, means ? n / a.chunk : n);
}

// One consumer run: 8 samples of x from offset o, raw (two float4 of f32,
// or 8 int16 in the first).
struct Run {
  uint4 v[2];
};

__device__ __forceinline__ Run load_run(const ScanArgs& a, long long o) {
  Run r;
  if (a.x_i16) {
    r.v[0] = *reinterpret_cast<const uint4*>(static_cast<const int16_t*>(a.x) + o);
    r.v[1] = r.v[0];
  } else {
    const uint4* p = reinterpret_cast<const uint4*>(static_cast<const float*>(a.x) + o);
    r.v[0] = p[0];
    r.v[1] = p[1];
  }
  return r;
}

__device__ __forceinline__ float run_x(const ScanArgs& a, const Run& r, int q) {
  if (a.x_i16) {
    const uint32_t w = (&r.v[0].x)[q / 2];
    const int16_t n = static_cast<int16_t>(q % 2 ? w >> 16 : w & 0xFFFFu);
    return __fmul_rn(static_cast<float>(n), 1.0f / 32768.0f);
  }
  return __uint_as_float((&r.v[q / 4].x)[q % 4]);
}

__device__ __forceinline__ float x_at(const ScanArgs& a, long long o) {
  return a.x_i16 ? __fmul_rn(static_cast<float>(
                                 static_cast<const int16_t*>(a.x)[o]),
                             1.0f / 32768.0f)
                 : static_cast<const float*>(a.x)[o];
}

// y = clip(x * clip(g, 0.1, max_gain)) of one run, stored as f32 or as the
// bf16 pair, 16 bytes at a time; `g` the run's 8 gains (16-byte aligned in
// shared memory).
__device__ __forceinline__ void apply_run(const ScanArgs& a, const Run& r,
                                          const float* g, float max_gain,
                                          long long o) {
  const float4 g0 = *reinterpret_cast<const float4*>(g);
  const float4 g1 = *reinterpret_cast<const float4*>(g + 4);
  const float gv[kRun] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
  float v[kRun];
#pragma unroll
  for (int q = 0; q < kRun; ++q)
    v[q] = fminf(fmaxf(__fmul_rn(run_x(a, r, q), clip_gain(gv[q], max_gain)),
                       -a.out_clip),
                 a.out_clip);
  if (a.y != nullptr) {
    float4* p = reinterpret_cast<float4*>(a.y + o);
    p[0] = make_float4(v[0], v[1], v[2], v[3]);
    p[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    uint32_t h[kRun / 2], l[kRun / 2];
#pragma unroll
    for (int q = 0; q < kRun; q += 2) {
      const float2 s0 = afp::split_bf16(v[q]), s1 = afp::split_bf16(v[q + 1]);
      h[q / 2] = afp::bf16_bits(s0.x) | static_cast<uint32_t>(afp::bf16_bits(s1.x)) << 16;
      l[q / 2] = afp::bf16_bits(s0.y) | static_cast<uint32_t>(afp::bf16_bits(s1.y)) << 16;
    }
    *reinterpret_cast<uint4*>(a.yh + o) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(a.yl + o) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// The same for samples t0 .. t0+len-1 one at a time (a block length that
// is not whole runs, or unaligned x).
__device__ __forceinline__ void apply_scalar(const ScanArgs& a, const float* g,
                                             float max_gain, long long o,
                                             int len) {
  for (int q = 0; q < len; ++q) {
    const float v = fminf(
        fmaxf(__fmul_rn(x_at(a, o + q), clip_gain(g[q], max_gain)), -a.out_clip),
        a.out_clip);
    if (a.y != nullptr) {
      a.y[o + q] = v;
    } else {
      const float2 s = afp::split_bf16(v);
      a.yh[o + q] = afp::bf16_bits(s.x);
      a.yl[o + q] = afp::bf16_bits(s.y);
    }
  }
}

__global__ void __launch_bounds__(kApplyThreads, 1) agc_apply_kernel(ScanArgs a) {
  extern __shared__ float4 smem4[];
  float* ds = reinterpret_cast<float*>(smem4);  // [kDRing][kTC][32] d rows
  float* gs = ds + kDRing * kTC * kStreams;     // [2][32][kGStride] gains
  const int b0 = blockIdx.x * kStreams;
  const int nb = min(kStreams, a.B - b0);
  const int nch = (a.T + kTC - 1) / kTC;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x < 32) {
    // ---------------- the recurrence warp: one lane per stream
    const int b = b0 + lane;
    const bool live = lane < nb;
    const bool means = a.chunk && a.d_means;
    const float inv = a.chunk ? 1.0f / static_cast<float>(a.chunk) : 0.f;
    const bool wide = nb == kStreams && a.B % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(a.d) % 16 == 0;
    float g = 0.f;
    float a_att = a.a_att, a_rel = a.a_rel, max_gain = a.max_gain;
    if (live) {
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
    const float om_att = __fsub_rn(1.f, a_att), om_rel = __fsub_rn(1.f, a_rel);
    for (int k = 0; k < 2; ++k) {
      const int2 rows = k < nch ? d_rows(a, k) : make_int2(0, 0);
      stage_d(a, rows.x, rows.y, b0, nb, wide, ds + k * kTC * kStreams, lane);
    }
    for (int c = 0; c < nch; ++c) {
      const int k = c + 2;
      const int2 rows = k < nch ? d_rows(a, k) : make_int2(0, 0);
      // slot k % 3 held chunk c - 1, which every lane read column by column:
      // all lanes are past those reads before a 16-byte copy refills it
      __syncwarp();
      stage_d(a, rows.x, rows.y, b0, nb, wide, ds + (k % kDRing) * kTC * kStreams,
              lane);
      asm volatile("cp.async.wait_group 2;" ::: "memory");  // chunk c landed
      __syncwarp();
      if (c >= 2) bar_sync(kBarEmpty + (c & 1));  // chunk c - 2 applied
      const float* dc = ds + (c % kDRing) * kTC * kStreams + lane;
      float* gl = gs + ((c & 1) * kStreams + lane) * kGStride;
      const int n = min(kTC, a.T - c * kTC);
      if (!a.chunk) {
        // d of the next 4 steps is loaded while these 4 run: the loads do
        // not wait behind the gain stores
        float dn[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) dn[q] = q < n ? dc[q * kStreams] : 0.f;
        int t = 0;
        for (; t + 4 <= n; t += 4) {
          float dv[4], gv[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            dv[q] = dn[q];
            if (t + 8 <= n) dn[q] = dc[(t + 4 + q) * kStreams];
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            g = step2(g, dv[q], a_att, om_att, a_rel, om_rel);
            gv[q] = g;
          }
          *reinterpret_cast<float4*>(gl + t) = make_float4(gv[0], gv[1], gv[2], gv[3]);
        }
        for (; t < n; ++t) {
          g = step2(g, dc[t * kStreams], a_att, om_att, a_rel, om_rel);
          gl[t] = g;
        }
      } else {
        for (int cc = 0; cc < n / a.chunk; ++cc) {
          const float m = means ? dc[cc * kStreams]
                                : chunk_mean(dc + cc * a.chunk * kStreams, kStreams,
                                             a.chunk, inv);
          const float gn = step2(g, m, a_att, om_att, a_rel, om_rel);
          const float dg = __fsub_rn(gn, g);
          for (int q = 0; q < a.chunk; ++q) {
            const float fr = __fmul_rn(static_cast<float>(q + 1), inv);
            gl[cc * a.chunk + q] = __fmaf_rn(dg, fr, g);
          }
          g = gn;
        }
      }
      bar_arrive(kBarFull + (c & 1));
    }
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    if (live) a.carry[b] = clip_gain(g, max_gain);
    return;
  }

  // ---------------- the apply warps: runs (r, j) = (it / kRuns, it % kRuns)
  const int ct = threadIdx.x - 32;
  const bool vec =
      a.T % kRun == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0 &&
      (a.y != nullptr ? reinterpret_cast<uintptr_t>(a.y) % 16 == 0
                      : (reinterpret_cast<uintptr_t>(a.yh) |
                         reinterpret_cast<uintptr_t>(a.yl)) % 16 == 0);
  constexpr int kPer = kStreams * kRuns / (32 * kApplyWarps);  // runs a thread
  Run cur[kPer], nxt[kPer];
  auto load_chunk = [&](int c, Run* dst) {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int it = ct + u * 32 * kApplyWarps;
      const int r = it / kRuns, j = it % kRuns;
      if (r < nb && c * kTC + j * kRun < a.T)
        dst[u] = load_run(a, static_cast<long long>(b0 + r) * a.T + c * kTC + j * kRun);
    }
  };
  if (vec) load_chunk(0, cur);
  for (int c = 0; c < nch; ++c) {
    if (vec && c + 1 < nch) load_chunk(c + 1, nxt);
    bar_sync(kBarFull + (c & 1));
    const float* gb = gs + (c & 1) * kStreams * kGStride;
    const int n = min(kTC, a.T - c * kTC);
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int it = ct + u * 32 * kApplyWarps;
      const int r = it / kRuns, j = it % kRuns;
      if (r >= nb || j * kRun >= n) continue;
      const long long o = static_cast<long long>(b0 + r) * a.T + c * kTC + j * kRun;
      const float* g = gb + r * kGStride + j * kRun;
      const float mg = a.v_max != nullptr ? a.v_max[b0 + r] : a.max_gain;
      if (vec)
        apply_run(a, cur[u], g, mg, o);
      else
        apply_scalar(a, g, mg, o, min(kRun, n - j * kRun));
    }
    if (c + 2 < nch) bar_arrive(kBarEmpty + (c & 1));
#pragma unroll
    for (int u = 0; u < kPer; ++u) cur[u] = nxt[u];
  }
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
  const size_t smem =
      sizeof(float) * (kDRing * kTC * kStreams + 2 * kStreams * kGStride);
  cudaError_t err = cudaFuncSetAttribute(
      agc_apply_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  agc_apply_kernel<<<(B + kStreams - 1) / kStreams, kApplyThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
