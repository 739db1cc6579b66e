// The device code that the AGC recurrence kernels share: K6 (recurrence,
// clip, apply; `agc_scan.cu:agc_apply_kernel`), K9 (the recurrence alone;
// `agc_scan.cu:agc_scan_kernel`) and K14 (the whole AGC stage;
// `agc_fused.cu:agc_fused_kernel`).
//
// All three give a block 32 streams and run its roles at once in separate
// warps: warp 0 runs the 32 recurrences, one lane a stream, a chunk of 128
// steps at a time, and writes the raw gains of chunk c into one of two gain
// buffers while the consumer warps (the apply of K6 and K14, the store of
// K9) drain chunk c - 1 from the other.  K14 adds window warps that produce
// the desired gain d for the recurrence warp.
//
// The step: a = d > g ? a_att : a_rel;  g = fma(a, d, (1 - a) * g), as XLA's
// CPU backend rounds the reference's a·d + (1−a)·g.  `step2` computes both
// candidates with 1 - a hoisted and selects last: the same operations on
// the same values, so the same bits, with a shorter dependent path
// (multiply -> fma -> select).  Every operation is an explicit _rn
// intrinsic, so nvcc contracts nothing else.
//
// The barrier protocol.  Named barriers pair a producer role with a
// consumer role; `bar.arrive` by the producer, `bar.sync` by the consumer
// for a full buffer, and the reverse for an empty one.  The count of a
// barrier is the thread count of its two roles, never the block's: a wrong
// count hangs the card.  Ids (0 is __syncthreads, unused):
//   1, 2  gains of chunk c full   (c & 1): recurrence arrives after its
//         chunk, consumers sync before reading; count 32 * (1 + 8)
//   3, 4  gains of chunk c empty  (c & 1): consumers arrive after chunk c
//         when c + 2 < nch (the last two chunks skip it), the recurrence
//         syncs before writing chunk c when c >= 2; count 32 * (1 + 8)
//   5     K14 only: the window warps' round barrier (the chunk totals of a
//         round written); bar.sync by all window warps; count
//         32 * kWindowWarps
// A producer never arrives twice on one barrier before its consumer synced
// once: each arrival of a full barrier follows a sync on the matching empty
// one, and the reverse.
//
// K14's window warps hand d to the recurrence warp through mbarriers in
// shared memory (named barriers are 16 a block, too few for a pair per
// window warp).  Window warp w owns d slot w and the chunks i = w (mod
// kWindowWarps); the k-th use of slot w (k = i / kWindowWarps) is phase k
// of its two mbarriers, each initialised to 32 arrivals:
//   full[w]   the window warp's 32 lanes arrive after writing chunk i; the
//             recurrence warp waits for phase k (parity k & 1)
//   empty[w]  the recurrence warp's 32 lanes arrive after reading chunk i;
//             the window warp waits for phase k - 1 before writing chunk i
//             when k >= 1
// An arrival releases the lane's earlier shared-memory accesses and a
// completed wait acquires them.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "split.cuh"

namespace afp_agc {

constexpr int kStreams = 32;  // streams per block: one warp of recurrences
constexpr int kTC = 128;      // time steps per chunk
constexpr int kConsumerWarps = 8;  // apply or store warps
constexpr int kPairThreads = 32 * (kConsumerWarps + 1);  // ids 1-4
constexpr int kRun = 8;            // samples per consumer run (32 bytes of f32)
constexpr int kRuns = kTC / kRun;  // runs per stream and chunk
constexpr int kPer = kStreams * kRuns / (32 * kConsumerWarps);  // runs a thread
constexpr int kGStride = kTC + 4;  // gain rows, 16-byte aligned
constexpr int kBarFull = 1;        // named barriers 1, 2: gains ready
constexpr int kBarEmpty = 3;       // 3, 4: gains consumed

__device__ __forceinline__ float clip_gain(float g, float max_gain) {
  return fminf(fmaxf(g, 0.1f), max_gain);
}

__device__ __forceinline__ float step2(float g, float d, float a_att,
                                       float om_att, float a_rel,
                                       float om_rel) {
  const float ga = __fmaf_rn(a_att, d, __fmul_rn(om_att, g));
  const float gr = __fmaf_rn(a_rel, d, __fmul_rn(om_rel, g));
  return d > g ? ga : gr;
}

// The alphas of one lane's recurrence, with 1 - a hoisted.
struct Alphas {
  float att, om_att, rel, om_rel;
};

__device__ __forceinline__ Alphas alphas(float a_att, float a_rel) {
  return Alphas{a_att, __fsub_rn(1.f, a_att), a_rel, __fsub_rn(1.f, a_rel)};
}

template <int kCount>
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(kCount) : "memory");
}

template <int kCount>
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(kCount) : "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Wait until the phase of `bar` with parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// d of a chunk that a lane reads from shared memory: `at(t)` one step,
// `quad(t)` steps t .. t+3 (t a multiple of 4).
// Time-major rows [kTC][32]: the lane's column, one 4-byte read a step.
struct RowsD {
  const float* col;  // the chunk's row 0, offset by the lane
  __device__ __forceinline__ float at(int t) const { return col[t * kStreams]; }
  __device__ __forceinline__ float4 quad(int t) const {
    return make_float4(at(t), at(t + 1), at(t + 2), at(t + 3));
  }
};

// Steps 0 .. n-1 of one chunk of a recurrence from g, the raw gains written
// to gl[0 .. n-1] (16-byte aligned), 4 steps a store; d of the next 4 steps
// is read while these 4 run, so the reads do not wait behind the stores.
// `quad(t)` is asked for t a multiple of 4 with t <= n.
// `restart`: step 0 takes g = d[0] itself (the per-block restart without a
// carry).  Returns the last g.
template <class D>
__device__ __forceinline__ float run_chain(float g, const D& d, int n,
                                           bool restart, float* gl,
                                           const Alphas& al) {
  int t = 0;
  if (restart) {
    const int m = min(4, n);
    for (; t < m; ++t) {
      const float dv = d.at(t);
      g = t == 0 ? dv : step2(g, dv, al.att, al.om_att, al.rel, al.om_rel);
      gl[t] = g;
    }
  }
  // the read ahead is not conditional (a branch there would keep the loads
  // from overlapping the steps): at the chunk's end it reads 4 steps past
  // it, values it never uses, still inside the block's shared memory (every
  // d chunk is followed by the gain buffers)
  float4 dn = t + 4 <= n ? d.quad(t) : make_float4(0.f, 0.f, 0.f, 0.f);
  for (; t + 4 <= n; t += 4) {
    const float4 dv = dn;
    dn = d.quad(t + 4);
    const float g0 = step2(g, dv.x, al.att, al.om_att, al.rel, al.om_rel);
    const float g1 = step2(g0, dv.y, al.att, al.om_att, al.rel, al.om_rel);
    const float g2 = step2(g1, dv.z, al.att, al.om_att, al.rel, al.om_rel);
    g = step2(g2, dv.w, al.att, al.om_att, al.rel, al.om_rel);
    *reinterpret_cast<float4*>(gl + t) = make_float4(g0, g1, g2, g);
  }
  for (; t < n; ++t) {
    g = step2(g, d.at(t), al.att, al.om_att, al.rel, al.om_rel);
    gl[t] = g;
  }
  return g;
}

// Stage rows row0 .. row0+n_rows-1 of a time-major [., B] array (the
// block's nb streams from b0) into `dst` [kTC][32] with cp.async: 16-byte
// copies when the rows are whole and aligned (`wide`), else 4-byte copies
// that zero-fill the streams beyond B.  One commit group.
__device__ __forceinline__ void stage_rows(const float* src, int B, int row0,
                                           int n_rows, int b0, int nb,
                                           bool wide, float* dst, int lane) {
  if (wide) {
    for (int i = lane; i < n_rows * (kStreams / 4); i += 32) {
      const int r = i / (kStreams / 4), q = i % (kStreams / 4);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                       smem_addr(dst + r * kStreams + 4 * q)),
                   "l"(src + static_cast<long long>(row0 + r) * B + b0 + 4 * q)
                   : "memory");
    }
  } else {
    for (int r = 0; r < n_rows; ++r) {
      const bool in = lane < nb;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                       smem_addr(dst + r * kStreams + lane)),
                   "l"(src + (in ? static_cast<long long>(row0 + r) * B + b0 + lane
                                 : 0)),
                   "r"(in ? 4 : 0)
                   : "memory");
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// ------------------------------------------------------------ the apply

// What the apply warps read: x [B, T] f32 or int16 PCM (converted
// n * 2^-15 as it is read: exact), and write: y [B, T] f32 or the bf16
// pair (yh, yl) as raw bits.  max_gain is the scalar, or v_max [B].
struct Apply {
  const void* x;
  float* y;
  uint16_t* yh;
  uint16_t* yl;
  int B, T, x_i16;
  float max_gain, out_clip;
  const float* v_max;
};

// One consumer run: 8 samples of x from offset o, raw (two float4 of f32,
// or 8 int16 in the first).
struct Run {
  uint4 v[2];
};

__device__ __forceinline__ Run load_run(const Apply& a, long long o) {
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

__device__ __forceinline__ float pcm(int16_t n) {
  return __fmul_rn(static_cast<float>(n), 1.0f / 32768.0f);
}

__device__ __forceinline__ float run_x(const Apply& a, const Run& r, int q) {
  if (a.x_i16) {
    const uint32_t w = (&r.v[0].x)[q / 2];
    return pcm(static_cast<int16_t>(q % 2 ? w >> 16 : w & 0xFFFFu));
  }
  return __uint_as_float((&r.v[q / 4].x)[q % 4]);
}

__device__ __forceinline__ float x_at(const void* x, int x_i16, long long o) {
  return x_i16 ? pcm(static_cast<const int16_t*>(x)[o])
               : static_cast<const float*>(x)[o];
}

// y = clip(x * clip(g, 0.1, max_gain)) of one run, stored as f32 or as the
// bf16 pair, 16 bytes at a time; `g` the run's 8 gains (16-byte aligned in
// shared memory).
__device__ __forceinline__ void apply_run(const Apply& a, const Run& r,
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

// The same for samples o .. o+len-1 one at a time (a block length that is
// not whole runs, or unaligned x or y).
__device__ __forceinline__ void apply_scalar(const Apply& a, const float* g,
                                             float max_gain, long long o,
                                             int len) {
  for (int q = 0; q < len; ++q) {
    const float v = fminf(
        fmaxf(__fmul_rn(x_at(a.x, a.x_i16, o + q), clip_gain(g[q], max_gain)),
              -a.out_clip),
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

// The apply warps' whole walk (thread ct of 32 * kConsumerWarps): per
// chunk, runs (r, j) = (it / kRuns, it % kRuns) of the block's streams from
// b0; x of chunk c + 1 is loaded before chunk c's gains are waited for,
// since x does not depend on g.  `gs` [2][32][kGStride] holds the raw gains.
__device__ __forceinline__ void apply_role(const Apply& a, const float* gs,
                                           int b0, int nb, int nch, int ct) {
  const bool vec =
      a.T % kRun == 0 &&
      reinterpret_cast<uintptr_t>(a.x) % 16 == 0 &&
      (a.y != nullptr ? reinterpret_cast<uintptr_t>(a.y) % 16 == 0
                      : (reinterpret_cast<uintptr_t>(a.yh) |
                         reinterpret_cast<uintptr_t>(a.yl)) % 16 == 0);
  Run cur[kPer], nxt[kPer];
  auto load_chunk = [&](int c, Run* dst) {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int it = ct + u * 32 * kConsumerWarps;
      const int r = it / kRuns, j = it % kRuns;
      if (r < nb && c * kTC + j * kRun < a.T)
        dst[u] = load_run(a, static_cast<long long>(b0 + r) * a.T + c * kTC + j * kRun);
    }
  };
  if (vec) load_chunk(0, cur);
  for (int c = 0; c < nch; ++c) {
    if (vec && c + 1 < nch) load_chunk(c + 1, nxt);
    bar_sync<kPairThreads>(kBarFull + (c & 1));
    const float* gb = gs + (c & 1) * kStreams * kGStride;
    const int n = min(kTC, a.T - c * kTC);
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int it = ct + u * 32 * kConsumerWarps;
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
    if (c + 2 < nch) bar_arrive<kPairThreads>(kBarEmpty + (c & 1));
#pragma unroll
    for (int u = 0; u < kPer; ++u) cur[u] = nxt[u];
  }
}

}  // namespace afp_agc
