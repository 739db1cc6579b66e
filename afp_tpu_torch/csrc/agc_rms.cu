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
// (relative error ~ log2(W) * 2^-24).
//   * two-level form (W a multiple of 128): 128-wide window sums of weight 1,
//     then the m = W/128 shifted sums added in order, then * (1/W) in fp32;
//   * direct form (any other W): the weight is the boxcar band's entry 1/w,
//     split into bf16 (wh, wl); s = wh * sum(hi + lo) + wl * sum(hi), the
//     second product only when 1/w is not exact in bf16 (`exact` == 0).
// Window sums are direct sums, never a running difference (a cumulative
// difference cancels catastrophically on quiet samples, `ops/agc.py:57-60`).
//
// Output layouts: [B, T]; time-major [T, B] (what K6 reads, one coalesced row
// across streams per step); or the time-major chunk means [T/mc, B] of the
// bf16 split of d, sum(hi)/mc + sum(lo)/mc (`agc_rms.py:50-90`).
//
// target and max_gain are scalars or, for per-stream AGC policies
// (`engine/batch.py:with_per_stream_agc`), [B] vectors on the device, read per
// row in the epilogue; either vector promotes both (`agc_rms.py:377-390`).
//
// x is f32 or, under `ingest='pcm16'`, the raw int16 PCM block or ring slot,
// converted n * 2^-15 as it is staged (`agc_rms.py:111-113, 352-372`).  The
// convert is exact, so an int16 x gives the bits of an f32 x of n/32768 and
// moves half the input bytes.
//
// What bounds it on H100 at the C8 shape (batch 4096, block 2048, W = 512):
// 32 MiB in and 32 MiB out (~20 us at 3.35 TB/s); a direct window sum would
// cost W adds per output (4.3 G adds).  Design: a block of 256 threads owns
// `rows` batch rows x 256 outputs.  It stages the row windows (256 + W - 1
// split samples each) in shared memory and builds the power-of-two window
// sums by doubling, p_2k[u] = p_k[u] + p_k[u + k] (one add per position per
// level, ping-pong buffers), so a 128-wide sum costs 7 adds per position.
// The direct form adds the levels of W's set bits at their offsets.
#include <cuda_runtime.h>

#include <cstdint>

#include "split.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 256;  // outputs per tile along time
constexpr int kLane = 128;

constexpr int kLayoutBT = 0;     // d [B, T]
constexpr int kLayoutTB = 1;     // d [T, B]
constexpr int kLayoutMeans = 2;  // chunk means [T / mean_chunk, B]

struct RmsArgs {
  const void* x;      // [B, T] f32, or int16 PCM with x_i16
  const float* band;  // boxcar band [W-1+128, 128]: entry (W-1, 0) is 1/w
  float* out;
  int B, T, W, lp;
  int two_level, exact, layout, mean_chunk, x_i16;
  float target, max_gain, inv_w;
  const float* v_target;  // [B] per-stream target and max gain, or null
  const float* v_max;
};

__global__ void __launch_bounds__(kThreads)
    rms_desired_kernel(RmsArgs a, int rows) {
  extern __shared__ float smem[];
  const int L = kTile + a.W - 1;  // padded window length of one row
  const int RL = rows * L;
  const bool need_hi = !a.two_level && !a.exact;
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
      const long long k = static_cast<long long>(b) * a.T + tx;
      const float xv =
          a.x_i16 ? __fmul_rn(static_cast<float>(
                                  static_cast<const int16_t*>(a.x)[k]),
                              1.0f / 32768.0f)
                  : static_cast<const float*>(a.x)[k];
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

  if (a.two_level) {
    // doubling to the 128-wide sums: after the level of shift k, cur[u]
    // holds the sum of positions u .. u + 2k - 1
    for (int k = 1; k < kLane; k *= 2) {
      const int n = L - 2 * k + 1;
      for (int i = tid; i < rows * n; i += kThreads) {
        const int r = i / n;
        const int u = i - r * n;
        nxt[r * L + u] = __fadd_rn(cur[r * L + u], cur[r * L + u + k]);
      }
      __syncthreads();
      float* t = cur;
      cur = nxt;
      nxt = t;
    }
    const int m = a.W / kLane;
    for (int i = tid; i < rows * kTile; i += kThreads) {
      const int r = i / kTile;
      const int t = i - r * kTile;
      float s = cur[r * L + t];
      for (int j = 1; j < m; ++j) s = __fadd_rn(s, cur[r * L + t + j * kLane]);
      acc[i] = s;
    }
  } else {
    // direct: W = sum of its set bits 2^k, taken low to high; the level-k
    // sum of the bit enters at the running offset `off`
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
  }
  __syncthreads();

  float wh = 0.f, wl = 0.f;
  if (!a.two_level) {
    const float2 wsplit = afp::split_bf16(a.band[(a.W - 1) * kLane]);
    wh = wsplit.x;
    wl = wsplit.y;
  }
  // epilogue: s -> rms -> d.  Time-major layouts walk the rows fastest so a
  // warp stores `rows`-wide runs of one output row.
  const bool tmaj = a.layout != kLayoutBT;
  for (int i = tid; i < rows * kTile; i += kThreads) {
    const int r = tmaj ? i % rows : i / kTile;
    const int t = tmaj ? i / rows : i % kTile;
    const int j = r * kTile + t;
    float s;
    if (a.two_level) {
      s = __fmul_rn(acc[j], a.inv_w);
    } else {
      s = __fmul_rn(acc[j], wh);
      if (!a.exact) s = __fadd_rn(s, __fmul_rn(hacc[j], wl));
    }
    const int b = b0 + r;
    float target = a.target, max_gain = a.max_gain;
    if (a.v_target != nullptr && b < a.B) {
      target = a.v_target[b];
      max_gain = a.v_max[b];
    }
    const float rms = __fsqrt_rn(fmaxf(s, 0.f));
    const float d = fminf(
        fmaxf(__fdiv_rn(target, __fadd_rn(rms, 1e-10f)), 0.f), max_gain);
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

size_t smem_bytes(int rows, int W, bool need_hi) {
  const size_t L = kTile + W - 1;
  const size_t per = 2 * L + kTile;  // ping-pong windows + accumulator
  return sizeof(float) * rows * per * (need_hi ? 2 : 1);
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
      (two_level && W % kLane) ||
      (layout == kLayoutMeans &&
       (mean_chunk <= 0 || kTile % mean_chunk || T % mean_chunk)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool need_hi = !two_level && !exact;
  // widest row tile (<= 8 rows) whose windows fit the shared memory
  int rows = 8;
  while (rows > 1 && smem_bytes(rows, W, need_hi) > 200u * 1024u) rows /= 2;
  const size_t smem = smem_bytes(rows, W, need_hi);
  if (smem > 227u * 1024u) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      rms_desired_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  RmsArgs a;
  a.x = x;
  a.band = static_cast<const float*>(band);
  a.out = static_cast<float*>(out);
  a.B = B;
  a.T = T;
  a.W = W;
  a.lp = lp;
  a.two_level = two_level;
  a.exact = exact;
  a.layout = layout;
  a.mean_chunk = mean_chunk;
  a.x_i16 = x_i16;
  a.target = target;
  a.max_gain = max_gain;
  a.inv_w = inv_w;
  a.v_target = static_cast<const float*>(v_target);
  a.v_max = static_cast<const float*>(v_max);
  const dim3 grid((B + rows - 1) / rows, (T + kTile - 1) / kTile);
  rms_desired_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      a, rows);
  return static_cast<int>(cudaGetLastError());
}
