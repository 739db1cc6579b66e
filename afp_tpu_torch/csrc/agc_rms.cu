// K5: moving RMS -> desired AGC gain, in one pass over the raw block.
//
// Replaces `afp_tpu/ops/pallas/agc_rms.py:rms_desired_pallas` (`_rms_call`,
// `_kernel`, `_kernel_two_level`, `_store_d`, `_flush_means`):
//
//   d[b, t] = clip(target / (sqrt(boxcar_W(x^2)[b, t]) + 1e-10), 0, max_gain)
//
// with numpy's 'same' zero padding (lp = W/2 samples before, rp = W-1-lp
// after).  Numerics follow the TPU kernel: x^2 is split into its bf16 halves
// (split.cuh) and the halves, not x^2 itself, are summed; the sum of the two
// halves of one sample is exact in fp32, and every window sum adds only
// non-negative terms, so any summation order stays in the same class
// (relative error ~ log2(W) * 2^-24).  Window sums are direct sums, never a
// running difference (a cumulative difference cancels catastrophically on
// quiet samples, `ops/agc.py:57-60`).
//   * two-level form (W a multiple of 128): window sums of weight 1, then
//     * (1/W) in fp32 (`rms_desired_kernel`, below);
//   * direct form (any other W): the weight is the boxcar band's entry 1/w,
//     split into bf16 (wh, wl); s = wh * sum(hi + lo) + wl * sum(hi), the
//     second product only when 1/w is not exact in bf16 (`exact` == 0)
//     (`rms_desired_kernel_direct`).
//
// Output layouts: [B, T]; time-major [T, B] (what K6 reads, one coalesced row
// across streams per step); or the time-major chunk means [T/mc, B] of the
// bf16 split of d, sum(hi)/mc + sum(lo)/mc, each half summed in time order
// (`agc_rms.py:50-90`).
//
// target and max_gain are scalars or, for per-stream AGC policies
// (`engine/batch.py:with_per_stream_agc`), [B] vectors on the device, read
// once per row; either vector promotes both (`agc_rms.py:377-390`).
//
// x is f32 or, under `ingest='pcm16'`, the raw int16 PCM block or ring slot,
// converted n * 2^-15 as it is loaded (`agc_rms.py:111-113, 352-372`).  The
// convert is exact, so an int16 x gives the bits of an f32 x of n/32768 and
// moves half the input bytes.
//
// What bounds it on H100 at the C8 shape (batch 4096, block 2048, W = 512):
// 32 MiB in and 32 MiB out, ~20 us at 3.35 TB/s; then the epilogue's
// correctly rounded sqrt and division per output (~40 instructions).  The
// first design (a 256-output tile staged with its 767-sample halo, sums by
// doubling over shared memory with an integer division per element and
// level, 57 KB of shared memory a block) took 0.30 ms: the integer units, not
// the bytes, set its time.  This one is bound by the latency of its loads
// and shuffle scans: with zeros for loads it runs in 60% of its time, and it
// gains from every warp an SM holds (`chip_agc_ablate.py`).
//
// Two-level design: the padded row is cut into chunks of 128 samples (chunk
// k holds padded positions 128k .. 128k+127; padded position p is sample
// p - lp).  The window of output t = 128c + r is
//
//   s = (S_c[r] + (T_{c+1} + ... + T_{c+m-1})) + P_{c+m}[r],   m = W / 128
//
// with S_c[r] the sum of chunk c from position r on, T_k chunk k's total and
// P_k[r] the sum of chunk k's positions below r.  A warp takes a chunk as 32
// lanes of 4 consecutive samples (one 16-byte load of f32 x, 8 bytes of
// int16): in-lane sums, then a Kogge-Stone shuffle scan across the lanes
// give S or P, with no division, no block barrier and no subtraction.  The
// order is written out as plain float32 ops in
// `ops/cuda/agc_rms.py:rms_desired_model`, which the kernel equals bit for
// bit (no atomics, so the order is fixed; the tiles do not enter it).  A
// block owns 32 streams x 512 outputs, and four blocks (64 registers a
// thread) share an SM, so the C8 grid of 512 blocks is one wave; the halo
// chunks are read again from L2.  Each of a block's 8 warps owns 4 fixed
// streams and walks the output chunks, the 4 streams' loads in flight
// together.  The chunk totals of a row live in shared memory (the P scan of
// chunk c+m leaves T_{c+m}; a prologue scans chunks c0+1 .. c0+m-1), so no
// state grows with W but that small array.  The time-major layouts go
// through a double-buffered [32 streams][128] tile, XOR-swizzled by stream
// so that both the warps' 16-byte writes along time and the column reads
// across streams are free of bank conflicts; the [T, B] store then writes
// 128-byte runs, one barrier per output chunk.
#include <cuda_runtime.h>

#include <cstdint>

#include "split.cuh"

namespace {

constexpr int kLane = 128;       // the chunk: 32 lanes x 4 samples
constexpr int kRows = 32;        // streams per block (two-level)
constexpr int kWarpRows = 4;     // streams per warp (two-level)
constexpr int kTimeTile = 512;   // outputs per block along time (two-level)
constexpr int kThreads = 256;
constexpr int kTile = 256;  // outputs per tile along time (direct)

constexpr int kLayoutBT = 0;     // d [B, T]
constexpr int kLayoutTB = 1;     // d [T, B]
constexpr int kLayoutMeans = 2;  // chunk means [T / mean_chunk, B]

struct RmsArgs {
  const void* x;      // [B, T] f32, or int16 PCM with x_i16
  const float* band;  // boxcar band [W-1+128, 128]: entry (W-1, 0) is 1/w
  float* out;
  int B, T, W, lp;
  int exact, layout, mean_chunk, x_i16;
  float target, max_gain, inv_w;
  const float* v_target;  // [B] per-stream target and max gain, or null
  const float* v_max;
};

__device__ __forceinline__ float load_x(const RmsArgs& a, long long k) {
  return a.x_i16 ? __fmul_rn(static_cast<float>(
                                 static_cast<const int16_t*>(a.x)[k]),
                             1.0f / 32768.0f)
                 : static_cast<const float*>(a.x)[k];
}

// hi + lo of the bf16 split of v^2: exact, the halves' bits do not overlap
__device__ __forceinline__ float split_sq(float v) {
  const float2 s = afp::split_bf16(__fmul_rn(v, v));
  return __fadd_rn(s.x, s.y);
}

__device__ __forceinline__ float desired(float s, float target,
                                         float max_gain) {
  const float rms = __fsqrt_rn(fmaxf(s, 0.f));
  return fminf(fmaxf(__fdiv_rn(target, __fadd_rn(rms, 1e-10f)), 0.f),
               max_gain);
}

// ------------------------------------------------------------ two-level

// The split squares of `lane`'s 4 positions of chunk k of row b (zeros
// outside the row and for b >= B).  `vec`: lp % 4 == 0 and x aligned, so
// the 4 samples are one 16-byte (f32) or 8-byte (int16) load, wholly inside
// or outside [0, T).
__device__ __forceinline__ float4 chunk_sq(const RmsArgs& a, int b, int k,
                                           int lane, bool vec) {
  const int tx = k * kLane + 4 * lane - a.lp;
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  if (b < a.B) {
    const long long o = static_cast<long long>(b) * a.T + tx;
    if (vec) {
      if (tx >= 0 && tx < a.T) {
        if (a.x_i16) {
          const short4 s = *reinterpret_cast<const short4*>(
              static_cast<const int16_t*>(a.x) + o);
          const short e[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
          for (int q = 0; q < 4; ++q)
            v[q] = __fmul_rn(static_cast<float>(e[q]), 1.0f / 32768.0f);
        } else {
          const float4 f =
              *reinterpret_cast<const float4*>(static_cast<const float*>(a.x) + o);
          v[0] = f.x;
          v[1] = f.y;
          v[2] = f.z;
          v[3] = f.w;
        }
      }
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (tx + q >= 0 && tx + q < a.T) v[q] = load_x(a, o + q);
    }
  }
  return make_float4(split_sq(v[0]), split_sq(v[1]), split_sq(v[2]),
                     split_sq(v[3]));
}

// Exclusive prefix sums of the chunk at the lane's 4 positions, and the
// chunk's total (the inclusive sum at lane 31): in-lane sums, then a
// Kogge-Stone scan of the lane sums.
__device__ __forceinline__ float prefix_scan(float4 v, int lane, float p[4]) {
  const float a0 = v.x, a1 = __fadd_rn(a0, v.y), a2 = __fadd_rn(a1, v.z),
              a3 = __fadd_rn(a2, v.w);
  float x = a3;
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const float u = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x = __fadd_rn(u, x);
  }
  float e = __shfl_up_sync(0xffffffffu, x, 1);
  if (lane == 0) e = 0.f;
  p[0] = e;
  p[1] = __fadd_rn(e, a0);
  p[2] = __fadd_rn(e, a1);
  p[3] = __fadd_rn(e, a2);
  return __shfl_sync(0xffffffffu, x, 31);
}

// Inclusive suffix sums of the chunk at the lane's 4 positions.
__device__ __forceinline__ void suffix_scan(float4 v, int lane, float s[4]) {
  const float b3 = v.w, b2 = __fadd_rn(v.z, b3), b1 = __fadd_rn(v.y, b2),
              b0 = __fadd_rn(v.x, b1);
  float y = b0;
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const float u = __shfl_down_sync(0xffffffffu, y, off);
    if (lane + off < 32) y = __fadd_rn(y, u);
  }
  float f = __shfl_down_sync(0xffffffffu, y, 1);
  if (lane == 31) f = 0.f;
  s[0] = __fadd_rn(f, b0);
  s[1] = __fadd_rn(f, b1);
  s[2] = __fadd_rn(f, b2);
  s[3] = __fadd_rn(f, b3);
}

__global__ void __launch_bounds__(kThreads, 4) rms_desired_kernel(RmsArgs a) {
  extern __shared__ float smem[];
  const int m = a.W / kLane;
  const int c0 = blockIdx.y * (kTimeTile / kLane);
  const int noc = min(kTimeTile / kLane, a.T / kLane - c0);  // output chunks
  const int ntot = kTimeTile / kLane + m;
  float* dt = smem;                     // [2][kRows][kLane], swizzled
  float* tot = dt + 2 * kRows * kLane;  // [kRows][ntot] chunk totals

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b0 = blockIdx.x * kRows;
  const bool vec = a.lp % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(a.x) % (a.x_i16 ? 8 : 16) == 0;
  const bool tmaj = a.layout != kLayoutBT;

  int b[kWarpRows];
  float target[kWarpRows], max_gain[kWarpRows];
#pragma unroll
  for (int i = 0; i < kWarpRows; ++i) {
    b[i] = b0 + warp * kWarpRows + i;
    target[i] = a.target;
    max_gain[i] = a.max_gain;
    if (a.v_target != nullptr && b[i] < a.B) {
      target[i] = a.v_target[b[i]];
      max_gain[i] = a.v_max[b[i]];
    }
  }
  float* wtot = tot + warp * kWarpRows * ntot;  // this warp's rows

  // the totals T_{c0+1} .. T_{c0+m-1} that the first output chunk needs
  for (int k = c0 + 1; k < c0 + m; ++k) {
    float4 v[kWarpRows];
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i) v[i] = chunk_sq(a, b[i], k, lane, vec);
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i) {
      float p[4];
      const float t = prefix_scan(v[i], lane, p);
      if (lane == 0) wtot[i * ntot + k - c0] = t;
    }
  }

  for (int c = c0; c < c0 + noc; ++c) {
    float4 vs[kWarpRows], vp[kWarpRows];
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i) {
      vs[i] = chunk_sq(a, b[i], c, lane, vec);
      vp[i] = chunk_sq(a, b[i], c + m, lane, vec);
    }
    float d[kWarpRows][4];
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i) {
      float s[4], p[4];
      suffix_scan(vs[i], lane, s);
      const float t = prefix_scan(vp[i], lane, p);
      __syncwarp();
      float mid = 0.f;  // T_{c+1} + ... + T_{c+m-1}, in order
      for (int j = c + 1; j < c + m; ++j) mid = __fadd_rn(mid, wtot[i * ntot + j - c0]);
      if (lane == 0) wtot[i * ntot + c + m - c0] = t;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        d[i][q] = desired(__fmul_rn(__fadd_rn(__fadd_rn(s[q], mid), p[q]), a.inv_w),
                          target[i], max_gain[i]);
    }
    if (!tmaj) {
#pragma unroll
      for (int i = 0; i < kWarpRows; ++i)
        if (b[i] < a.B)
          *reinterpret_cast<float4*>(a.out + static_cast<long long>(b[i]) * a.T +
                                     c * kLane + 4 * lane) =
              make_float4(d[i][0], d[i][1], d[i][2], d[i][3]);
      continue;
    }
    // row r's time t sits at dt[r][t ^ r]: r = 4 warp + i, so the lane's
    // 4-group lands at group lane ^ warp, its entries permuted by i
    float* buf = dt + (c & 1) * kRows * kLane;
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i) {
      float e[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) e[q ^ i] = d[i][q];
      *reinterpret_cast<float4*>(buf + (warp * kWarpRows + i) * kLane +
                                 4 * (lane ^ warp)) =
          make_float4(e[0], e[1], e[2], e[3]);
    }
    __syncthreads();
    const int bl = b0 + lane;
    if (a.layout == kLayoutTB) {
      if (bl < a.B)
        for (int t = warp; t < kLane; t += kThreads / 32)
          a.out[static_cast<long long>(c * kLane + t) * a.B + bl] =
              buf[lane * kLane + (t ^ lane)];
    } else {
      // the chunk means of d's bf16 halves, each summed in time order;
      // 1/mc is exact, so sum * (1/mc) is the sum of the exact products
      const int mc = a.mean_chunk;
      const float inv = 1.0f / static_cast<float>(mc);
      if (bl < a.B)
        for (int g = warp; g < kLane / mc; g += kThreads / 32) {
          float sh = 0.f, sl = 0.f;
          for (int q = 0; q < mc; ++q) {
            const float2 s = afp::split_bf16(buf[lane * kLane + ((g * mc + q) ^ lane)]);
            sh = __fadd_rn(sh, s.x);
            sl = __fadd_rn(sl, s.y);
          }
          a.out[static_cast<long long>(c * kLane / mc + g) * a.B + bl] =
              __fadd_rn(__fmul_rn(sh, inv), __fmul_rn(sl, inv));
        }
    }
  }
}

size_t smem_two_level(int W) {
  return sizeof(float) * (2 * kRows * kLane + kRows * (kTimeTile / kLane + W / kLane));
}

// ------------------------------------------------------------ direct

// A block of 256 threads owns `rows` batch rows x 256 outputs.  It stages the
// row windows (256 + W - 1 split samples each) in shared memory and builds
// the power-of-two window sums by doubling, p_2k[u] = p_k[u] + p_k[u + k]
// (one add per position per level, ping-pong buffers), adding the levels of
// W's set bits at their offsets, low to high.  Off the C8 path.
__global__ void __launch_bounds__(kThreads)
    rms_desired_kernel_direct(RmsArgs a, int rows) {
  extern __shared__ float smem[];
  const int L = kTile + a.W - 1;  // padded window length of one row
  const int RL = rows * L;
  const bool need_hi = !a.exact;
  float* cur = smem;         // [rows][L] sums of hi + lo at the current level
  float* nxt = cur + RL;     // [rows][L]
  float* acc = nxt + RL;     // [rows][kTile] window sums of hi + lo
  float* hcur = acc + rows * kTile;  // need_hi: the same for hi alone
  float* hnxt = hcur + RL;
  float* hacc = hnxt + RL;

  const int b0 = blockIdx.x * rows;
  const int t0 = blockIdx.y * kTile;
  const int tid = threadIdx.x;

  // padded position p of row r is sample t0 + p - lp of the block
  for (int i = tid; i < RL; i += kThreads) {
    const int r = i / L;
    const int p = i - r * L;
    const int b = b0 + r;
    const int tx = t0 + p - a.lp;
    float v = 0.f, hv = 0.f;
    if (b < a.B && tx >= 0 && tx < a.T) {
      const float xv = load_x(a, static_cast<long long>(b) * a.T + tx);
      const float2 s = afp::split_bf16(__fmul_rn(xv, xv));
      v = __fadd_rn(s.x, s.y);  // exact: the halves' bits do not overlap
      hv = s.x;
    }
    cur[i] = v;
    if (need_hi) hcur[i] = hv;
  }
  for (int i = tid; i < rows * kTile; i += kThreads) {
    acc[i] = 0.f;
    if (need_hi) hacc[i] = 0.f;
  }
  __syncthreads();

  // W = sum of its set bits 2^k, taken low to high; the level-k sum of the
  // bit enters at the running offset `off`
  int off = 0;
  for (int k = 0; (1 << k) <= a.W; ++k) {
    const int w = 1 << k;
    if (a.W & w) {
      for (int i = tid; i < rows * kTile; i += kThreads) {
        const int r = i / kTile;
        const int t = i - r * kTile;
        acc[i] = __fadd_rn(acc[i], cur[r * L + t + off]);
        if (need_hi) hacc[i] = __fadd_rn(hacc[i], hcur[r * L + t + off]);
      }
      off += w;
    }
    if (2 * w <= a.W) {
      const int n = L - 2 * w + 1;
      for (int i = tid; i < rows * n; i += kThreads) {
        const int r = i / n;
        const int u = i - r * n;
        nxt[r * L + u] = __fadd_rn(cur[r * L + u], cur[r * L + u + w]);
        if (need_hi)
          hnxt[r * L + u] = __fadd_rn(hcur[r * L + u], hcur[r * L + u + w]);
      }
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
    t = hcur;
    hcur = hnxt;
    hnxt = t;
  }
  __syncthreads();

  const float2 wsplit = afp::split_bf16(a.band[(a.W - 1) * kLane]);
  // epilogue: s -> rms -> d.  Time-major layouts walk the rows fastest so a
  // warp stores `rows`-wide runs of one output row.
  const bool tmaj = a.layout != kLayoutBT;
  for (int i = tid; i < rows * kTile; i += kThreads) {
    const int r = tmaj ? i % rows : i / kTile;
    const int t = tmaj ? i / rows : i % kTile;
    const int j = r * kTile + t;
    float s = __fmul_rn(acc[j], wsplit.x);
    if (!a.exact) s = __fadd_rn(s, __fmul_rn(hacc[j], wsplit.y));
    const int b = b0 + r;
    float target = a.target, max_gain = a.max_gain;
    if (a.v_target != nullptr && b < a.B) {
      target = a.v_target[b];
      max_gain = a.v_max[b];
    }
    const float d = desired(s, target, max_gain);
    const int tt = t0 + t;
    if (a.layout == kLayoutMeans) {
      acc[j] = d;  // each entry is read and rewritten by its own thread
    } else if (b < a.B && tt < a.T) {
      const long long o = a.layout == kLayoutTB
                              ? static_cast<long long>(tt) * a.B + b
                              : static_cast<long long>(b) * a.T + tt;
      a.out[o] = d;
    }
  }
  if (a.layout != kLayoutMeans) return;
  __syncthreads();
  // chunk means of the bf16 split of d: 1/mc is exact, so sum * (1/mc)
  // equals the sum of the exact products hi * (1/mc)
  const int mc = a.mean_chunk;
  const int nc = kTile / mc;
  const float inv = 1.0f / static_cast<float>(mc);
  for (int i = tid; i < rows * nc; i += kThreads) {
    const int r = i % rows;
    const int c = i / rows;
    const int b = b0 + r;
    const int tt = t0 + c * mc;
    if (b >= a.B || tt >= a.T) continue;
    float sh = 0.f, sl = 0.f;
    for (int q = 0; q < mc; ++q) {
      const float2 s = afp::split_bf16(acc[r * kTile + c * mc + q]);
      sh = __fadd_rn(sh, s.x);
      sl = __fadd_rn(sl, s.y);
    }
    a.out[static_cast<long long>(tt / mc) * a.B + b] =
        __fadd_rn(__fmul_rn(sh, inv), __fmul_rn(sl, inv));
  }
}

size_t smem_direct(int rows, int W, bool need_hi) {
  const size_t L = kTile + W - 1;
  const size_t per = 2 * L + kTile;  // ping-pong windows + accumulator
  return sizeof(float) * rows * per * (need_hi ? 2 : 1);
}

cudaError_t launch(const void* kernel, dim3 grid, size_t smem, void** args,
                   void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernel(kernel, grid, dim3(kThreads), args, smem,
                         static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// K5.  x [B, T], f32 or (x_i16) int16 PCM (a ring slot is passed as its own
// [B, T] view) -> out in `layout`.  The band supplies the direct form's
// weight; `inv_w` the two-level form's 1/W.  v_target/v_max: [B] per-stream
// values (both or neither), else the scalars.
extern "C" int afp_rms_desired(const void* x, const void* band, void* out,
                               int B, int T, int W, int lp, int two_level,
                               int exact, int layout, int mean_chunk,
                               int x_i16, float target, float max_gain,
                               float inv_w, const void* v_target,
                               const void* v_max, void* stream) {
  if (B <= 0 || T <= 0 || W <= 0 || lp < 0 || lp > W - 1 ||
      layout < kLayoutBT || layout > kLayoutMeans ||
      (v_target == nullptr) != (v_max == nullptr) ||
      (two_level && (W % kLane || T % kLane)) ||
      (layout == kLayoutMeans &&
       (mean_chunk <= 0 || kLane % mean_chunk || T % mean_chunk)))
    return static_cast<int>(cudaErrorInvalidValue);
  RmsArgs a;
  a.x = x;
  a.band = static_cast<const float*>(band);
  a.out = static_cast<float*>(out);
  a.B = B;
  a.T = T;
  a.W = W;
  a.lp = lp;
  a.exact = exact;
  a.layout = layout;
  a.mean_chunk = mean_chunk;
  a.x_i16 = x_i16;
  a.target = target;
  a.max_gain = max_gain;
  a.inv_w = inv_w;
  a.v_target = static_cast<const float*>(v_target);
  a.v_max = static_cast<const float*>(v_max);
  cudaError_t err;
  if (two_level) {
    const size_t smem = smem_two_level(W);
    if (smem > 227u * 1024u) return static_cast<int>(cudaErrorInvalidValue);
    void* args[] = {&a};
    err = launch((const void*)rms_desired_kernel,
                 dim3((B + kRows - 1) / kRows,
                      (T / kLane + kTimeTile / kLane - 1) / (kTimeTile / kLane)),
                 smem, args, stream);
  } else {
    const bool need_hi = !exact;
    // widest row tile (<= 8 rows) whose windows fit the shared memory
    int rows = 8;
    while (rows > 1 && smem_direct(rows, W, need_hi) > 200u * 1024u) rows /= 2;
    const size_t smem = smem_direct(rows, W, need_hi);
    if (smem > 227u * 1024u) return static_cast<int>(cudaErrorInvalidValue);
    void* args[] = {&a, &rows};
    err = launch((const void*)rms_desired_kernel_direct,
                 dim3((B + rows - 1) / rows, (T + kTile - 1) / kTile), smem, args,
                 stream);
  }
  return static_cast<int>(err);
}
