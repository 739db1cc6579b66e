// K1, K3, K4, K7, K8: the fused single-rate FIR of the filter chain, in
// bf16x3.
//
// Replaces five TPU kernels of `afp_tpu/ops/pallas/fir_td.py`, which share
// one conv body here and differ only in where a block's input window comes
// from (the loader, `load_split`):
//   K1  fir_td_mxu               (_fir_kernel_b3 + _finish_tile): windows of a
//       staged x_ext [B, n-1+T];
//   K3  fir_td_mxu_ring_f32      (_fir_kernel_b3t_f32): slot idx of an f32
//       input ring [S, B, T] behind the carried tail [B, k_pad]; writes output
//       slot idx in place and emits the next tail;
//   K4  fir_td_mxu_ring_mega_f32 (_fir_kernel_b3mega_f32): n_steps K3 steps,
//       slots (start+i) mod S, in one launch.  The TPU walked the steps in
//       order to carry the tail in VMEM; here the input ring is read-only for
//       the whole dispatch, so step i's history is simply the end of the
//       earlier slots (or the carried tail), and every (row tile, time tile,
//       step) block is independent;
//   K8  fir_td_mxu_pair          (_fir_td_pair_call, body _fir_kernel_b3t):
//       the block and the carried tail arrive already split, as bf16 (hi, lo)
//       pairs [B, T] and [B, k_pad] (the AGC apply kernel K6 stores y that
//       way), so the loader reads the halves and skips the split;
//   K7  fir_td_mxu_pair_to_ring  (_fir_td_pair_to_ring_call): K8's loader with
//       K3's slot store, writing out_ring[idx] in place, plus the next pair
//       tail (`pair_tail_kernel`).  K7 and K8 run the same body on the same
//       windows, so K7's slot equals K8's output bit for bit.
//
// Numerics: y[b,t] = sum_k (xh*hh + xh*hl + xl*hh), where xh/xl and hh/hl are
// the bf16 hi/lo halves of the input and the taps made with split_bf16's
// integer round-to-nearest-even mask.  Each product of two bf16 values is
// exact in fp32, so this is the TPU's bf16x3 class; only the order of the
// fp32 sums differs.  The taps are read directly, not through a band matrix
// (band[i, j] = h[n-1+j-i] is the same sum).  Epilogue: clip, then Philox
// dither (philox.cuh), then the store.
//
// What bounds it on H100 at the headline shape (batch 4096, block 4096,
// 379 taps): traffic is 128 MiB per block (~40 us at 3.35 TB/s), while the
// FMA form does 3 * 379 FMAs per output, 19 G FMAs per block (~0.57 ms at
// the ~33.5 T FMA/s of the fp32 CUDA cores).  So it is compute-bound on the
// CUDA cores.  Design: a block of 128 threads owns a tile of 4 batch rows x
// 512 outputs; it stages the split window and taps in shared memory, and each
// thread accumulates 4 rows x 4 consecutive outputs in registers, sliding a
// 4-sample register window so each tap costs one shared load per row.  The
// window is stored in four phase-interleaved sub-arrays (position p at
// [p % 4][p / 4]) so those loads are free of bank conflicts.  The later
// route is the TPU's own: bf16 mma.sync/wgmma on the Toeplitz band with fp32
// accumulators.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"
#include "split.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kCols = 4 * kThreads;  // outputs per tile along time
constexpr int kRows = 4;             // batch rows per tile
constexpr int kModeExt = 0;          // K1: staged x_ext
constexpr int kModeRing = 1;         // K3: one ring step
constexpr int kModeMega = 2;         // K4: n_steps ring steps
constexpr int kModePair = 3;         // K8/K7: bf16 pair block + pair tail

struct Src {
  const float* x;     // K1: x_ext [B, hist+T]; K3/K4: ring [S, B, T]
  const float* tail;  // K3/K4: carried tail [B, hist]
  // K7/K8: the block's bf16 halves [B, T] and the tail's [B, hist], raw bits
  const uint16_t* xh;
  const uint16_t* xl;
  const uint16_t* th;
  const uint16_t* tl;
  int B, T;
  int hist;  // history columns before output 0: n-1 (K1) or k_pad (K3/K4/K7/K8)
  int S, start;
};

// Sample e of step `step`'s extended signal, e in [0, hist+T); 0 outside.
// K3/K4 read the stream tail ++ slot(start) ++ slot(start+1) ++ ...: step s
// starts at stream position s*T.
template <int MODE>
__device__ __forceinline__ float load_ext(const Src& s, int b, int step,
                                          int e) {
  if (e < 0 || e >= s.hist + s.T) return 0.f;
  if (MODE == kModeExt)
    return s.x[static_cast<long long>(b) * (s.hist + s.T) + e];
  const int p = step * s.T + e;
  if (p < s.hist) return s.tail[static_cast<long long>(b) * s.hist + p];
  const int q = p - s.hist;
  const int m = q / s.T;
  const int slot = (s.start + m) % s.S;
  return s.x[(static_cast<long long>(slot) * s.B + b) * s.T + (q - m * s.T)];
}

// The split (hi, lo) of sample e: K7/K8 read the stored halves, the other
// loaders split the f32 sample.
template <int MODE>
__device__ __forceinline__ float2 load_split(const Src& s, int b, int step,
                                             int e) {
  if constexpr (MODE == kModePair) {
    if (e < 0 || e >= s.hist + s.T) return make_float2(0.f, 0.f);
    const bool in_tail = e < s.hist;
    const long long i = in_tail ? static_cast<long long>(b) * s.hist + e
                                : static_cast<long long>(b) * s.T + (e - s.hist);
    return make_float2(afp::bf16_bits_to_float((in_tail ? s.th : s.xh)[i]),
                       afp::bf16_bits_to_float((in_tail ? s.tl : s.xl)[i]));
  } else {
    return afp::split_bf16(load_ext<MODE>(s, b, step, e));
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
    fir_b3_kernel(Src src, const float* __restrict__ h, int n_taps, int np,
                  float* __restrict__ out, afp::Epilogue epi, int n_steps) {
  extern __shared__ float2 smem[];
  const int W = kCols + np - 1;  // window length
  const int W4 = (W + 3) / 4;    // length of each phase sub-array
  float2* taps = smem;           // [np], zero beyond n_taps
  float2* win = smem + np;       // [kRows][4][W4]

  const int b0 = blockIdx.x * kRows;
  const int t0 = blockIdx.y * kCols;
  const int step = blockIdx.z;
  const int j = threadIdx.x;

  for (int k = j; k < np; k += kThreads)
    taps[k] = k < n_taps ? afp::split_bf16(h[k]) : make_float2(0.f, 0.f);
  // window position p holds extended-signal sample e0 + p
  const int e0 = t0 + src.hist - (np - 1);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int b = b0 + r;
    float2* wr = win + r * 4 * W4;
    for (int p = j; p < W; p += kThreads)
      wr[(p & 3) * W4 + (p >> 2)] = b < src.B
                                        ? load_split<MODE>(src, b, step, e0 + p)
                                        : make_float2(0.f, 0.f);
  }
  __syncthreads();

  // Thread j owns outputs t0 + 4j + c (c = 0..3).  Tap k of output column c
  // reads window position 4j + c + np-1-k.  w[r][(c - k) & 3] holds that
  // sample; each new k brings in one sample (column 0's) and drops column
  // 3's, so the register window slides with one shared load per row.
  float acc[kRows][4];
  float2 w[kRows][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float2* wr = win + r * 4 * W4;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int p = 4 * j + np - 1 + c;
      w[r][c] = wr[(p & 3) * W4 + (p >> 2)];
      acc[r][c] = 0.f;
    }
  }
  for (int k0 = 0; k0 < np; k0 += 4) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = k0 + u;
      if (k > 0) {
        const int p = 4 * j + np - 1 - k;
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          w[r][(4 - u) & 3] = win[r * 4 * W4 + (p & 3) * W4 + (p >> 2)];
      }
      const float2 tk = taps[k];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float2 v = w[r][(c - u) & 3];
          float a = acc[r][c];
          a = fmaf(v.x, tk.x, a);
          a = fmaf(v.x, tk.y, a);
          a = fmaf(v.y, tk.x, a);
          acc[r][c] = a;
        }
      }
    }
  }

  const int t = t0 + 4 * j;  // T % 4 == 0: the four columns are in or out
  if (t >= src.T) return;
  int slot = 0;
  if (MODE != kModeExt) {
    // with n_steps > S a slot is written by several steps; the last one wins,
    // as in the reference's sequential walk
    if (step + src.S < n_steps) return;
    slot = (src.start + step) % src.S;
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int b = b0 + r;
    if (b >= src.B) break;
    const long long flat = static_cast<long long>(b) * src.T + t;
    afp::U4 bits = {{0u, 0u, 0u, 0u}};
    if (epi.dither)
      bits = afp::noise_bits4(static_cast<uint64_t>(flat >> 2), epi.seed,
                              epi.counter + static_cast<uint32_t>(step));
    float4 y;
    y.x = afp::finish(acc[r][0], epi, bits.w[0]);
    y.y = afp::finish(acc[r][1], epi, bits.w[1]);
    y.z = afp::finish(acc[r][2], epi, bits.w[2]);
    y.w = afp::finish(acc[r][3], epi, bits.w[3]);
    const long long o =
        MODE == kModeExt ? flat
                         : static_cast<long long>(slot) * src.B * src.T + flat;
    *reinterpret_cast<float4*>(out + o) = y;
  }
}

// Next tail after n_steps ring steps: the last hist samples of the stream,
// i.e. step n_steps's history.
__global__ void ring_tail_kernel(Src src, int n_steps, float* __restrict__ tail_out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= static_cast<long long>(src.B) * src.hist) return;
  const int b = static_cast<int>(i / src.hist);
  const int e = static_cast<int>(i - static_cast<long long>(b) * src.hist);
  tail_out[i] = load_ext<kModeRing>(src, b, n_steps, e);
}

// K7/K8's next pair tail: the last hist samples of concat(tail, block), so
// columns before T come from the carried tail when hist > T.
__global__ void pair_tail_kernel(Src src, uint16_t* __restrict__ th_out,
                                 uint16_t* __restrict__ tl_out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= static_cast<long long>(src.B) * src.hist) return;
  const int b = static_cast<int>(i / src.hist);
  const int p = src.T + static_cast<int>(i - static_cast<long long>(b) * src.hist);
  if (p < src.hist) {
    const long long k = static_cast<long long>(b) * src.hist + p;
    th_out[i] = src.th[k];
    tl_out[i] = src.tl[k];
  } else {
    const long long k = static_cast<long long>(b) * src.T + (p - src.hist);
    th_out[i] = src.xh[k];
    tl_out[i] = src.xl[k];
  }
}

afp::Epilogue make_epilogue(int has_clip, float clip, int dither,
                            unsigned int seed, unsigned int counter,
                            float lsb) {
  afp::Epilogue e;
  e.has_clip = has_clip;
  e.clip = clip;
  e.dither = dither;
  e.seed = seed;
  e.counter = counter;
  e.lsb = lsb;
  return e;
}

template <int MODE>
int launch_conv(const Src& s, const float* h, int n_taps, float* out,
                const afp::Epilogue& epi, int n_steps, cudaStream_t stream) {
  if (s.B <= 0 || s.T <= 0 || s.T % 4 || n_taps <= 0 || n_steps <= 0 ||
      n_steps > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int np = (n_taps + 3) / 4 * 4;
  const int W = kCols + np - 1;
  const size_t smem =
      sizeof(float2) * (static_cast<size_t>(np) + 4u * kRows * ((W + 3) / 4));
  cudaError_t err = cudaFuncSetAttribute(
      fir_b3_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s.B + kRows - 1) / kRows, (s.T + kCols - 1) / kCols,
                  n_steps);
  fir_b3_kernel<MODE><<<grid, kThreads, smem, stream>>>(s, h, n_taps, np, out,
                                                       epi, n_steps);
  return static_cast<int>(cudaGetLastError());
}

int launch_ring(int mode, const float* ring, const float* tail, const float* h,
                float* out_ring, float* tail_out, int S, int B, int T,
                int k_pad, int n_taps, int start, int n_steps,
                const afp::Epilogue& epi, cudaStream_t stream) {
  // stream positions are int: (n_steps + 1) * T + k_pad must fit
  if (S <= 0 || k_pad < n_taps - 1 || k_pad <= 0 || start < 0 ||
      static_cast<long long>(n_steps + 1) * T + k_pad > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  Src s{};
  s.x = ring;
  s.tail = tail;
  s.B = B;
  s.T = T;
  s.hist = k_pad;
  s.S = S;
  s.start = start % S;
  const int rc = mode == kModeRing
                     ? launch_conv<kModeRing>(s, h, n_taps, out_ring, epi,
                                              n_steps, stream)
                     : launch_conv<kModeMega>(s, h, n_taps, out_ring, epi,
                                              n_steps, stream);
  if (rc) return rc;
  const long long n = static_cast<long long>(B) * k_pad;
  const int threads = 256;
  ring_tail_kernel<<<static_cast<unsigned int>((n + threads - 1) / threads),
                     threads, 0, stream>>>(s, n_steps, tail_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1.  x_ext [B, n_taps-1+T] -> out [B, T].
extern "C" int afp_fir_td(const void* x_ext, const void* h, void* out, int B,
                          int T, int n_taps, int has_clip, float clip,
                          int dither, unsigned int seed, unsigned int counter,
                          float lsb, void* stream) {
  Src s{};
  s.x = static_cast<const float*>(x_ext);
  s.tail = nullptr;
  s.B = B;
  s.T = T;
  s.hist = n_taps - 1;
  s.S = 1;
  s.start = 0;
  return launch_conv<kModeExt>(
      s, static_cast<const float*>(h), n_taps, static_cast<float*>(out),
      make_epilogue(has_clip, clip, dither, seed, counter, lsb), 1,
      static_cast<cudaStream_t>(stream));
}

// K3.  One step: ring slot idx behind tail [B, k_pad] -> out_ring slot idx
// (in place) and tail_out [B, k_pad].
extern "C" int afp_fir_td_ring(const void* ring, const void* tail,
                               const void* h, void* out_ring, void* tail_out,
                               int S, int B, int T, int k_pad, int n_taps,
                               int idx, int has_clip, float clip, int dither,
                               unsigned int seed, unsigned int counter,
                               float lsb, void* stream) {
  return launch_ring(kModeRing, static_cast<const float*>(ring),
                     static_cast<const float*>(tail),
                     static_cast<const float*>(h),
                     static_cast<float*>(out_ring),
                     static_cast<float*>(tail_out), S, B, T, k_pad, n_taps,
                     idx, 1,
                     make_epilogue(has_clip, clip, dither, seed, counter, lsb),
                     static_cast<cudaStream_t>(stream));
}

// K4.  n_steps steps over slots (start+i) mod S; step i dithers under block
// counter counter+i.
extern "C" int afp_fir_td_ring_mega(const void* ring, const void* tail,
                                    const void* h, void* out_ring,
                                    void* tail_out, int S, int B, int T,
                                    int k_pad, int n_taps, int start,
                                    int n_steps, int has_clip, float clip,
                                    int dither, unsigned int seed,
                                    unsigned int counter, float lsb,
                                    void* stream) {
  return launch_ring(kModeMega, static_cast<const float*>(ring),
                     static_cast<const float*>(tail),
                     static_cast<const float*>(h),
                     static_cast<float*>(out_ring),
                     static_cast<float*>(tail_out), S, B, T, k_pad, n_taps,
                     start, n_steps,
                     make_epilogue(has_clip, clip, dither, seed, counter, lsb),
                     static_cast<cudaStream_t>(stream));
}

// K8 and K7.  The bf16 pair of the block [B, T] behind the pair tail
// [B, k_pad] -> slot idx of out [S, B, T] (K8: S = 1, idx = 0), and the next
// pair tail [B, k_pad].
extern "C" int afp_fir_td_pair(const void* xh, const void* xl, const void* th,
                               const void* tl, const void* h, void* out,
                               void* th_out, void* tl_out, int S, int B, int T,
                               int k_pad, int n_taps, int idx, int has_clip,
                               float clip, int dither, unsigned int seed,
                               unsigned int counter, float lsb, void* stream) {
  if (S <= 0 || idx < 0 || k_pad <= 0 || k_pad < n_taps - 1 ||
      static_cast<long long>(T) + k_pad > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  Src s{};
  s.xh = static_cast<const uint16_t*>(xh);
  s.xl = static_cast<const uint16_t*>(xl);
  s.th = static_cast<const uint16_t*>(th);
  s.tl = static_cast<const uint16_t*>(tl);
  s.B = B;
  s.T = T;
  s.hist = k_pad;
  s.S = S;
  s.start = idx % S;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = launch_conv<kModePair>(
      s, static_cast<const float*>(h), n_taps, static_cast<float*>(out),
      make_epilogue(has_clip, clip, dither, seed, counter, lsb), 1, st);
  if (rc) return rc;
  const long long n = static_cast<long long>(B) * k_pad;
  const int threads = 256;
  pair_tail_kernel<<<static_cast<unsigned int>((n + threads - 1) / threads),
                     threads, 0, st>>>(s, static_cast<uint16_t*>(th_out),
                                       static_cast<uint16_t*>(tl_out));
  return static_cast<int>(cudaGetLastError());
}
