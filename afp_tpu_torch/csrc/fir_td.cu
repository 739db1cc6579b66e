// K1, K3, K4, K7, K8, K10, K11, K12, K13, K15: the fused single-rate FIR of
// the filter chain, in bf16x3 (or, for K15's HIGHEST, in plain fp32).
//
// Replaces twelve TPU kernels of `afp_tpu/ops/pallas/fir_td.py`, which share
// one conv body here and differ only in where a block's input window comes
// from (the loader, `load_split`), where its taps come from, and in the
// store:
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
//       step) block is independent.  K3 is this form with n_steps = 1;
//   K12 fir_td_mxu_ring_pcm16 (fir_td.py:1270) and fir_td_mxu_ring_mega_pcm16
//       (fir_td.py:1638): K3/K4 over a raw int16 PCM ring and int16 tail; the
//       loader converts n * 2^-15 (exact) and splits (exact for 16-bit data,
//       `_load_f32`), so K12 on n equals K3/K4 on n/32768 bit for bit, and
//       the next tail is the raw int16 history;
//   K13 fir_td_mxu_ring (fir_td.py:946) and fir_td_mxu_ring_mega
//       (fir_td.py:1445, _fir_kernel_b3mega): K3/K4 over bf16 (hi, lo) pair
//       rings and a pair tail; the loader reads the stored halves;
//   K8  fir_td_mxu_pair          (_fir_td_pair_call, body _fir_kernel_b3t):
//       the block and the carried tail arrive already split, as bf16 (hi, lo)
//       pairs [B, T] and [B, k_pad] (the AGC apply kernel K6 stores y that
//       way), so the loader reads the halves and skips the split;
//   K7  fir_td_mxu_pair_to_ring  (_fir_td_pair_to_ring_call): K8's loader with
//       K3's slot store, writing out_ring[idx] in place, plus the next pair
//       tail.  K7 and K8 run the same body on the same windows, so K7's slot
//       equals K8's output bit for bit, and K13 on a slot equals K7 on that
//       slot's views.
//   K10 fir_td_mxu_banked        (fir_td.py:556, _fir_td_banked_call): K1 with
//       per-stream filter banks.  The taps are a bank [D, n_taps] and a
//       per-tile design assignment assign[B / bt]; the rows of a block (kRows
//       = 4) lie in one assignment tile (bt % 4 == 0, or bt == B), so the
//       block selects its design with one read, h + assign[b0 / bt] * n_taps.
//       Selection is addressing: the same body, the same instantiation, so a
//       banked row equals the shared-taps form on its design bit for bit.
//       An entry outside [0, D) reads no taps and writes its rows as NaN
//       (-32768 in the int16 store): checked in the kernel, with no host
//       synchronize.  The ring forms (K3, K4, K12) take the same bank option.
//   K11 fir_td_mxu_per_stream    (fir_td.py:1784, _fir_kernel_ps_b3): the
//       per-stream EQ mix y[b] = sum_k g[b, k] * (x[b] conv h_k) over K band
//       kernels.  Its own kernel (fir_ps_kernel), on the tensor cores as the
//       TPU runs it on the MXU: per band, the product of the staged window
//       with the band's Toeplitz tiles (band_mma.cuh: mma.sync m16n8k16,
//       bf16 halves, fp32 accumulate), then y += g * z_k in fp32 (the taps
//       are not mixed first, which would round differently).  The store is
//       the body's (clip, dither, int16), so the fused epilogue equals
//       K11 -> clip -> K2 -> quantize_pcm16 bit for bit.
//   K15 the precision variants of _fir_td_call (fir_td.py:370): HIGHEST
//       (_fir_kernel, fir_td.py:148; in K11 _fir_kernel_ps, :1701), the
//       causal/valid conv in fp32 class.  In K1's body it is the HIGHEST
//       template option: the window stages plain f32 samples (half the
//       shared memory of the split pairs), the taps stay unsplit, and the
//       accumulation does one fmaf per tap instead of three.  In K11 it is
//       the TPU's own 6-pass product on the tensor cores: x and the taps
//       split exactly into three bf16 halves, six products (band_mma.cuh).
//       The store is the same.  B3F (_fir_kernel_b3f, :236) and
//       B3C (_fir_kernel_b3c, :316) are B3's function with the split done in
//       VMEM, or over time-chunk pairs: this body already reads one f32 x and
//       splits it in the loader (read_split), so both are the bf16x3 body.
//
// Numerics: y[b,t] = sum_k (xh*hh + xh*hl + xl*hh), where xh/xl and hh/hl are
// the bf16 hi/lo halves of the input and the taps made with split_bf16's
// integer round-to-nearest-even mask.  Each product of two bf16 values is
// exact in fp32, so this is the TPU's bf16x3 class; only the order of the
// fp32 sums differs.  The taps are read directly, not through a band matrix
// (band[i, j] = h[n-1+j-i] is the same sum).  Epilogue: clip, then Philox
// dither (philox.cuh), then the store: f32, or with `emit_i16` the int16 PCM
// quantizer int16(clip(rint(y * 32768), -32768, 32767)) (`_finish_tile`,
// round half to even, clamped in float before the exact convert).
//
// What bounds it on H100 at the headline shape (batch 4096, block 4096,
// 379 taps; HIGHEST does a third of the FMAs, 6.4 G per block, against the
// same bytes): traffic is 128 MiB per block in f32 (~40 us at 3.35 TB/s; the
// int16 forms move half the input or output bytes), while the FMA form does
// 3 * 379 FMAs per output, 19 G FMAs per block (~0.57 ms at the ~33.5 T FMA/s
// of the fp32 CUDA cores).  So it is compute-bound on the CUDA cores, and
// the int16 loads and stores change its time little.  Design: a block of 128
// threads owns a tile of 4 batch rows x 512 outputs; it stages the split
// window and taps in shared memory, and each thread accumulates 4 rows x 4
// consecutive outputs in registers, sliding a 4-sample register window so
// each tap costs one shared load per row.  The window is stored in four
// phase-interleaved sub-arrays (position p at [p % 4][p / 4]) so those loads
// are free of bank conflicts.  The later route for this body is K11's:
// band_mma.cuh's tensor-core tiles.
//
// K11 at the C8 per-stream point (9 bands x 209 taps, batch 4096, block
// 2048) moves 71 MB (~21 us at 3.35 TB/s) against 4.7e10 useful bf16 MACs
// in bf16x3 (0.096 ms at the 989 TFLOP/s bf16 peak; 0.19 ms for HIGHEST's
// six products), so it is bound by the tensor cores, and in practice by
// the shared-memory reads that feed mma.sync (about 170 bytes per mma per
// warp: the A fragment of a window position serves four column tiles, the
// B tile one 8-byte load per lane).  Design (fir_ps_kernel): a block owns
// 32 rows x 256 outputs in bf16x3 (4 warps) or 512 in HIGHEST (8 warps),
// each warp 32 rows x 64 outputs (2 x 8 mma tiles) whose z and y stay in
// registers; the k-steps skip the band's all-zero
// tiles, so the padding waste is 16 * ceil((n+7)/16) / n (224 / 209 here).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "band_mma.cuh"
#include "philox.cuh"
#include "split.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kCols = 4 * kThreads;  // outputs per tile along time
constexpr int kRows = 4;             // batch rows per tile
constexpr int kModeExt = 0;          // K1: staged x_ext
constexpr int kModeRing = 1;         // K3/K4, K12, K13: n_steps ring steps
constexpr int kModePair = 2;         // K8/K7: bf16 pair block + pair tail

// element type of a ring and its tail
constexpr int kInF32 = 0;   // K1, K3/K4: f32
constexpr int kInI16 = 1;   // K12: int16 PCM, n / 32768
constexpr int kInPair = 2;  // K13, K7/K8: bf16 (hi, lo) halves, raw bits

struct Src {
  // K1: x_ext [B, hist+T]; ring forms: the ring [S, B, T] (f32, int16 or the
  // hi halves); K7/K8: the block's hi halves [B, T]
  const void* x;
  const void* xl;  // pair forms: the lo halves of x
  const void* t;   // ring and pair forms: the carried tail [B, hist]
  const void* tl;  // pair forms: the tail's lo halves
  int B, T;
  int hist;  // history columns before output 0: n-1 (K1) or k_pad (others)
  int S, start;
  const int* assign;  // banked forms: design of each batch tile, else null
  int bt;             // rows per assignment tile
  int D;              // designs in the bank
};

// Ring forms: where sample e of step `step`'s extended signal lives.  The
// stream is tail ++ slot(start) ++ slot(start+1) ++ ...; step s starts at
// stream position s*T.  Returns true for the carried tail (index *i into
// it), false for a ring slot (index *i into the ring).
__device__ __forceinline__ bool ring_pos(const Src& s, int b, int step, int e,
                                         long long* i) {
  const int p = step * s.T + e;
  if (p < s.hist) {
    *i = static_cast<long long>(b) * s.hist + p;
    return true;
  }
  const int q = p - s.hist;
  const int m = q / s.T;
  const int slot = (s.start + m) % s.S;
  *i = (static_cast<long long>(slot) * s.B + b) * s.T + (q - m * s.T);
  return false;
}

// The split (hi, lo) of element i of an array of type IN.  The int16 convert
// n * 2^-15 is exact, and so is the split of the result.
template <int IN>
__device__ __forceinline__ float2 read_split(const void* hi, const void* lo,
                                             long long i) {
  if constexpr (IN == kInF32) {
    return afp::split_bf16(static_cast<const float*>(hi)[i]);
  } else if constexpr (IN == kInI16) {
    return afp::split_bf16(__fmul_rn(
        static_cast<float>(static_cast<const int16_t*>(hi)[i]),
        1.0f / 32768.0f));
  } else {
    return make_float2(
        afp::bf16_bits_to_float(static_cast<const uint16_t*>(hi)[i]),
        afp::bf16_bits_to_float(static_cast<const uint16_t*>(lo)[i]));
  }
}

// The split of sample e, e in [0, hist+T), of step `step`'s extended
// signal; 0 outside.
template <int MODE, int IN>
__device__ __forceinline__ float2 load_split(const Src& s, int b, int step,
                                             int e) {
  if (e < 0 || e >= s.hist + s.T) return make_float2(0.f, 0.f);
  if constexpr (MODE == kModeExt) {
    return read_split<kInF32>(
        s.x, nullptr, static_cast<long long>(b) * (s.hist + s.T) + e);
  } else if constexpr (MODE == kModePair) {
    const bool in_tail = e < s.hist;
    const long long i = in_tail ? static_cast<long long>(b) * s.hist + e
                                : static_cast<long long>(b) * s.T + (e - s.hist);
    return read_split<kInPair>(in_tail ? s.t : s.x, in_tail ? s.tl : s.xl, i);
  } else {
    long long i;
    const bool in_tail = ring_pos(s, b, step, e, &i);
    return read_split<IN>(in_tail ? s.t : s.x, in_tail ? s.tl : s.xl, i);
  }
}

// The element of the staged window and of the taps: the bf16 (hi, lo) split
// pair (float2) for bf16x3, the plain f32 value (float) for HIGHEST.
__device__ __forceinline__ void to_elem(float v, float2* e) {
  *e = afp::split_bf16(v);
}
__device__ __forceinline__ void to_elem(float v, float* e) { *e = v; }

// Sample e of step `step`'s extended signal as a window element; 0 outside.
// HIGHEST reads the staged x_ext (K1, K11) only.
template <int MODE, int IN, typename E>
__device__ __forceinline__ E load_elem(const Src& s, int b, int step, int e) {
  if constexpr (std::is_same_v<E, float>) {
    static_assert(MODE == kModeExt && IN == kInF32,
                  "HIGHEST reads a staged f32 x_ext");
    if (e < 0 || e >= s.hist + s.T) return 0.f;
    return static_cast<const float*>(
        s.x)[static_cast<long long>(b) * (s.hist + s.T) + e];
  } else {
    return load_split<MODE, IN>(s, b, step, e);
  }
}

// Length of each phase sub-array of a W-wide window.  The conv loads (all
// lanes one phase, consecutive positions) hit consecutive banks for either
// element.  The staging stores of lanes p .. p+31 land at (p & 3) * W4 +
// (p >> 2): for 4-byte elements a W4 of 8 mod 32 spreads the four phases of
// a warp over the 32 banks; float2 stores go out per half-warp and keep the
// unpadded length (its 64-register body is unchanged).
template <typename E>
__host__ __device__ constexpr int phase_len(int W) {
  return std::is_same_v<E, float> ? ((W + 3) / 4 + 23) / 32 * 32 + 8
                                  : (W + 3) / 4;
}

// Stage rows b0 .. b0+kRows-1 of the window, positions [0, W) holding
// extended-signal samples e0 + p, phase-interleaved: position p of row r at
// win[r][p % 4][p / 4] (rows beyond B are zero).
template <int MODE, int IN, typename E>
__device__ __forceinline__ void stage_window(const Src& src, int b0, int step,
                                             int e0, int W, int W4, E* win) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int b = b0 + r;
    E* wr = win + r * 4 * W4;
    for (int p = threadIdx.x; p < W; p += kThreads)
      wr[(p & 3) * W4 + (p >> 2)] =
          b < src.B ? load_elem<MODE, IN, E>(src, b, step, e0 + p) : E{};
  }
}

// One tap's product(s) into an accumulator: bf16x3 adds hi*hi, hi*lo and
// lo*hi (each exact in fp32) in that order; HIGHEST one fp32 fmaf.
__device__ __forceinline__ float mac(float a, float2 v, float2 t) {
  a = fmaf(v.x, t.x, a);
  a = fmaf(v.x, t.y, a);
  return fmaf(v.y, t.x, a);
}
__device__ __forceinline__ float mac(float a, float v, float t) {
  return fmaf(v, t, a);
}

// The conv of thread j's 4 rows x 4 outputs against the taps [np] (zero
// beyond n_taps), from the staged window.  Thread j owns outputs
// t0 + 4j + c (c = 0..3).  Tap k of output column c reads window position
// 4j + c + np-1-k.  w[r][(c - k) & 3] holds that sample; each new k brings
// in one sample (column 0's) and drops column 3's, so the register window
// slides with one shared load per row.
template <typename E>
__device__ __forceinline__ void conv_acc(const E* __restrict__ win, int W4,
                                         const E* __restrict__ taps, int np,
                                         int j, float (&acc)[kRows][4]) {
  E w[kRows][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const E* wr = win + r * 4 * W4;
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
      const E tk = taps[k];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[r][c] = mac(acc[r][c], w[r][(c - u) & 3], tk);
      }
    }
  }
}

// The int16 PCM quantizer: rint (half to even), clamp in float, then an
// exact convert of the integral value.
__device__ __forceinline__ int16_t pcm16(float y) {
  const float v =
      fminf(fmaxf(rintf(__fmul_rn(y, 32768.0f)), -32768.0f), 32767.0f);
  return static_cast<int16_t>(__float2int_rn(v));
}

// The store of rows b0 .. b0+kRows-1, outputs t .. t+3 (t % 4 == 0, t < T),
// into output slot `slot`: clip, the dither of block counter counter+step
// over the flat index b*T + t, then f32 or the int16 quantizer.  With `bad`
// the rows are NaN instead (the int16 quantizer makes that -32768).
__device__ __forceinline__ void store_rows(const Src& src, int b0, int t,
                                           int slot, int step,
                                           const float (&acc)[kRows][4],
                                           const afp::Epilogue& epi,
                                           int emit_i16, void* out,
                                           bool bad = false) {
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
    if (bad) {
      const float nan = __int_as_float(0x7fc00000);
      y = make_float4(nan, nan, nan, nan);
    }
    const long long o = static_cast<long long>(slot) * src.B * src.T + flat;
    if (emit_i16) {
      // four int16 samples, one 8-byte store (o is a multiple of 4)
      short4 q;
      q.x = pcm16(y.x);
      q.y = pcm16(y.y);
      q.z = pcm16(y.z);
      q.w = pcm16(y.w);
      *reinterpret_cast<short4*>(static_cast<int16_t*>(out) + o) = q;
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(out) + o) = y;
    }
  }
}

// The conv body: E = float2 is bf16x3 (K1, K3/K4, K7/K8, K10, K12, K13), E =
// float is K15's HIGHEST (K1 only).
template <int MODE, int IN, typename E>
__global__ void __launch_bounds__(kThreads)
    fir_b3_kernel(Src src, const float* __restrict__ h, int n_taps, int np,
                  void* __restrict__ out, afp::Epilogue epi, int n_steps,
                  int emit_i16) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* smem = reinterpret_cast<E*>(smem_raw);
  const int W = kCols + np - 1;     // window length
  const int W4 = phase_len<E>(W);   // length of each phase sub-array
  E* taps = smem;                   // [np], zero beyond n_taps
  E* win = smem + np;               // [kRows][4][W4]

  const int b0 = blockIdx.x * kRows;
  const int t0 = blockIdx.y * kCols;
  const int step = blockIdx.z;
  const int j = threadIdx.x;

  // banked forms: this block's rows share one design of the bank; one
  // outside [0, D) reads design 0 and marks the rows bad
  int d = 0;
  bool bad = false;
  if (src.assign != nullptr) {
    d = src.assign[b0 / src.bt];
    bad = d < 0 || d >= src.D;
    if (bad) d = 0;
  }
  const float* hb = h + static_cast<long long>(d) * n_taps;
  for (int k = j; k < np; k += kThreads) {
    E tk{};
    if (k < n_taps) to_elem(hb[k], &tk);
    taps[k] = tk;
  }
  // window position p holds extended-signal sample e0 + p
  stage_window<MODE, IN, E>(src, b0, step, t0 + src.hist - (np - 1), W, W4,
                            win);
  __syncthreads();

  float acc[kRows][4];
  conv_acc(win, W4, taps, np, j, acc);

  const int t = t0 + 4 * j;  // T % 4 == 0: the four columns are in or out
  if (t >= src.T) return;
  int slot = 0;
  if (MODE == kModeRing) {
    // with n_steps > S a slot is written by several steps; the last one wins,
    // as in the reference's sequential walk
    if (step + src.S < n_steps) return;
    slot = (src.start + step) % src.S;
  } else if (MODE == kModePair) {
    slot = src.start;  // K7's output slot (K8: 0)
  }
  store_rows(src, b0, t, slot, step, acc, epi, emit_i16, out, bad);
}

// K11: y[b] = sum_k g[b, k] * (x[b] conv bands[k]), k in order, on the
// tensor cores (band_mma.cuh): bf16x3 (P = 2 halves) or K15's HIGHEST (P =
// 3, the six-product fp32 emulation).  A block of WARPS warps owns kPsRows
// batch rows x ps_cols(WARPS) outputs; each warp kPsMT x 16 rows x kPsNQ x
// 8 outputs.  The window of the block (cols - 8 + 16 S positions) is
// staged once, split into P bf16 arrays; the band tiles stream through a
// double buffer with cp.async (band k+1 loads while band k runs, so the
// band count is not bounded by shared memory); after each band the fp32
// fragment z_k is mixed y = y + g[b, k] * z_k (round to nearest, band
// order, as the plain version).  The mixed tile is staged through shared
// memory into the body's store (clip, dither over flat >> 2, f32 or int16).
// WARPS is 4 for bf16x3 (203 registers: two blocks of 4 warps share an SM;
// a bound of 168 registers for three spills and ran slower) and 8 for the
// six-product form (225 registers and a three-half window: one block per
// SM, so as wide a block as fits).  The window and the band tiles fit the
// shared memory up to 1033 taps in bf16x3 and 457 in HIGHEST.
constexpr int kPsMT = 2;             // m16 row tiles per warp
constexpr int kPsNQ = 8;             // n8 column tiles per warp
constexpr int kPsRows = 16 * kPsMT;  // batch rows per block

__host__ __device__ constexpr int ps_cols(int warps) { return 8 * kPsNQ * warps; }

struct PsGeom {
  int S;      // k-steps per 8-output column tile, ceil((n + 7) / 16)
  int W;      // window positions of a block
  int wp;     // row stride of a window half (bf16), = 8 mod 64
  size_t win_bytes, band_bytes, smem;
};

__host__ __device__ inline PsGeom ps_geom(int n_taps, int P, int warps) {
  PsGeom g;
  g.S = (n_taps + 7 + 15) / 16;
  g.W = ps_cols(warps) - 8 + 16 * g.S;
  g.wp = (g.W - 8 + 63) / 64 * 64 + 8;
  g.win_bytes = static_cast<size_t>(P) * kPsRows * g.wp * sizeof(uint16_t);
  const size_t ys = sizeof(float) * kPsRows * (ps_cols(warps) + 8);
  g.band_bytes = static_cast<size_t>(g.S) * P * 32 * 8;
  g.smem = (g.win_bytes > ys ? g.win_bytes : ys) + 2 * g.band_bytes;
  return g;
}

template <int P, int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
    fir_ps_kernel(Src src, const unsigned char* __restrict__ tiles,
                  const float* __restrict__ gains, int n_bands, int n_taps,
                  void* __restrict__ out, afp::Epilogue epi, int emit_i16) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kPsThreads = 32 * WARPS;
  constexpr int kPsCols = ps_cols(WARPS);
  constexpr int kPsYStride = kPsCols + 8;  // staged f32 tile row stride
  const PsGeom geo = ps_geom(n_taps, P, WARPS);
  uint16_t* win = reinterpret_cast<uint16_t*>(smem_raw);  // [P][rows][wp]
  float* ys = reinterpret_cast<float*>(smem_raw);  // the epilogue's tile
  unsigned char* bufs = smem_raw + (geo.smem - 2 * geo.band_bytes);

  const int b0 = blockIdx.x * kPsRows;
  const int t0 = blockIdx.y * kPsCols;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long text = static_cast<long long>(src.hist) + src.T;

  auto load_band = [&](int k) {
    const unsigned char* from = tiles + k * geo.band_bytes;
    unsigned char* to = bufs + (k & 1) * geo.band_bytes;
    for (int i = tid; i < static_cast<int>(geo.band_bytes / 16); i += kPsThreads)
      afp::cp_async16(to + 16 * i, from + 16 * i);
    afp::cp_async_commit();
  };
  load_band(0);

  // window position p of row r holds x_ext[b0 + r, t0 + p] (0 outside);
  // each thread issues all its rows' loads of a position before it splits
  // and stores any, so the loads overlap instead of queueing on latency
  const float* __restrict__ xg = static_cast<const float*>(src.x);
  for (int p = tid; p < geo.W; p += kPsThreads) {
    const long long e = static_cast<long long>(t0) + p;
#pragma unroll
    for (int r0 = 0; r0 < kPsRows; r0 += 16) {
      float v[16];
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const int b = b0 + r0 + r;
        v[r] = b < src.B && e < text ? __ldg(xg + b * text + e) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        uint16_t h[P];
        afp::split_halves<P>(v[r], h);
#pragma unroll
        for (int q = 0; q < P; ++q)
          win[(static_cast<size_t>(q) * kPsRows + r0 + r) * geo.wp + p] = h[q];
      }
    }
  }

  // this lane's fragment rows: mt * 16 + lane / 4 (+ 8)
  float y[kPsMT][kPsNQ][4];
#pragma unroll
  for (int mt = 0; mt < kPsMT; ++mt)
#pragma unroll
    for (int q = 0; q < kPsNQ; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i) y[mt][q][i] = 0.f;
  const int cbase = warp * 8 * kPsNQ;
#pragma unroll 1
  for (int k = 0; k < n_bands; ++k) {
    if (k + 1 < n_bands) {
      load_band(k + 1);
      afp::cp_async_wait<1>();
    } else {
      afp::cp_async_wait<0>();
    }
    __syncthreads();  // band k's tiles (and, at k = 0, the window) are in
    float gk[kPsMT][2];
#pragma unroll
    for (int mt = 0; mt < kPsMT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int b = b0 + mt * 16 + (lane >> 2) + 8 * h;
        gk[mt][h] = b < src.B
            ? gains[static_cast<long long>(b) * n_bands + k] : 0.f;
      }
    float z[kPsMT][kPsNQ][4];
#pragma unroll
    for (int mt = 0; mt < kPsMT; ++mt)
#pragma unroll
      for (int q = 0; q < kPsNQ; ++q)
#pragma unroll
        for (int i = 0; i < 4; ++i) z[mt][q][i] = 0.f;
    afp::band_conv<P, kPsMT, kPsNQ>(win, kPsRows, geo.wp, cbase,
                                     bufs + (k & 1) * geo.band_bytes, geo.S,
                                     z);
#pragma unroll
    for (int mt = 0; mt < kPsMT; ++mt)
#pragma unroll
      for (int q = 0; q < kPsNQ; ++q)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          y[mt][q][i] =
              __fadd_rn(y[mt][q][i], __fmul_rn(gk[mt][i >> 1], z[mt][q][i]));
    __syncthreads();  // every warp is done with buffer k & 1 (refilled next)
  }

  // stage the mixed tile (over the window) and store it 4 rows x 4 outputs
  // at a time through the body's store
#pragma unroll
  for (int mt = 0; mt < kPsMT; ++mt)
#pragma unroll
    for (int q = 0; q < kPsNQ; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mt * 16 + (lane >> 2) + 8 * h;
        const int c = cbase + 8 * q + 2 * (lane & 3);
        *reinterpret_cast<float2*>(ys + r * kPsYStride + c) =
            make_float2(y[mt][q][2 * h], y[mt][q][2 * h + 1]);
      }
  __syncthreads();
  constexpr int kChunks = kPsRows / kRows * (kPsCols / 4);
  for (int i = tid; i < kChunks; i += kPsThreads) {
    const int c = (i % (kPsCols / 4)) * 4;
    const int r = (i / (kPsCols / 4)) * kRows;
    if (t0 + c >= src.T) continue;
    float acc[kRows][4];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const float4 v =
          *reinterpret_cast<const float4*>(ys + (r + rr) * kPsYStride + c);
      acc[rr][0] = v.x;
      acc[rr][1] = v.y;
      acc[rr][2] = v.z;
      acc[rr][3] = v.w;
    }
    store_rows(src, b0 + r, t0 + c, 0, 0, acc, epi, emit_i16, out);
  }
}

// Next tail after n_steps ring steps: the last hist samples of the stream,
// i.e. step n_steps's history, in the ring's own element type (raw int16 for
// K12, both halves for K13 and K7/K8).
template <int IN>
__global__ void ring_tail_kernel(Src src, int n_steps, void* __restrict__ out,
                                 void* __restrict__ out_lo) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= static_cast<long long>(src.B) * src.hist) return;
  const int b = static_cast<int>(i / src.hist);
  const int e = static_cast<int>(i - static_cast<long long>(b) * src.hist);
  long long k;
  const bool in_tail = ring_pos(src, b, n_steps, e, &k);
  const void* from = in_tail ? src.t : src.x;
  if constexpr (IN == kInF32) {
    static_cast<float*>(out)[i] = static_cast<const float*>(from)[k];
  } else if constexpr (IN == kInI16) {
    static_cast<int16_t*>(out)[i] = static_cast<const int16_t*>(from)[k];
  } else {
    static_cast<uint16_t*>(out)[i] = static_cast<const uint16_t*>(from)[k];
    static_cast<uint16_t*>(out_lo)[i] =
        static_cast<const uint16_t*>(in_tail ? src.tl : src.xl)[k];
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

template <int MODE, int IN, typename E = float2>
int launch_conv(const Src& s, const float* h, int n_taps, void* out,
                const afp::Epilogue& epi, int n_steps, int emit_i16,
                cudaStream_t stream) {
  if (s.B <= 0 || s.T <= 0 || s.T % 4 || n_taps <= 0 || n_steps <= 0 ||
      n_steps > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int np = (n_taps + 3) / 4 * 4;
  const int W = kCols + np - 1;
  const size_t smem =
      sizeof(E) * (static_cast<size_t>(np) + 4u * kRows * phase_len<E>(W));
  cudaError_t err = cudaFuncSetAttribute(
      fir_b3_kernel<MODE, IN, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s.B + kRows - 1) / kRows, (s.T + kCols - 1) / kCols,
                  n_steps);
  fir_b3_kernel<MODE, IN, E><<<grid, kThreads, smem, stream>>>(
      s, h, n_taps, np, out, epi, n_steps, emit_i16);
  return static_cast<int>(cudaGetLastError());
}

template <int P>
int launch_ps(const Src& s, const void* tiles, const float* gains,
              int n_taps, int n_bands, void* out, const afp::Epilogue& epi,
              int emit_i16, cudaStream_t stream) {
  constexpr int WARPS = P == 2 ? 4 : 8;
  const PsGeom geo = ps_geom(n_taps, P, WARPS);
  if (geo.smem > 227u * 1024u) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      fir_ps_kernel<P, WARPS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(geo.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s.B + kPsRows - 1) / kPsRows,
                  (s.T + ps_cols(WARPS) - 1) / ps_cols(WARPS));
  fir_ps_kernel<P, WARPS><<<grid, 32 * WARPS, geo.smem, stream>>>(
      s, static_cast<const unsigned char*>(tiles), gains, n_bands, n_taps, out,
      epi, emit_i16);
  return static_cast<int>(cudaGetLastError());
}

template <int IN>
int launch_tail(const Src& s, int n_steps, void* out, void* out_lo,
                cudaStream_t stream) {
  const long long n = static_cast<long long>(s.B) * s.hist;
  const int threads = 256;
  ring_tail_kernel<IN><<<static_cast<unsigned int>((n + threads - 1) / threads),
                         threads, 0, stream>>>(s, n_steps, out, out_lo);
  return static_cast<int>(cudaGetLastError());
}

template <int IN>
int launch_ring(const Src& s, const float* h, int n_taps, void* out_ring,
                void* tail_out, void* tail_out_lo, int n_steps,
                const afp::Epilogue& epi, int emit_i16, cudaStream_t stream) {
  const int rc = launch_conv<kModeRing, IN>(s, h, n_taps, out_ring, epi,
                                            n_steps, emit_i16, stream);
  if (rc) return rc;
  return launch_tail<IN>(s, n_steps, tail_out, tail_out_lo, stream);
}

// The bank option of K1/K3/K4/K12 (K10 and the banked rings): `assign` is
// the per-tile design index [B / bt] into the bank h [D, n_taps], or null
// for shared taps.  False when the tiles would split a block's rows or the
// bank is empty.
bool set_bank(Src* s, const void* assign, int bt, int D) {
  s->assign = static_cast<const int*>(assign);
  s->bt = bt;
  s->D = D;
  return assign == nullptr || (D > 0 && bt > 0 && s->B % bt == 0 &&
                               (bt % kRows == 0 || bt == s->B));
}

}  // namespace

// K1, K10 and K15.  x_ext [B, n_taps-1+T] -> out [B, T], f32 or (emit_i16)
// int16; with `assign` (K10) h is the bank [D, n_taps] and row b takes
// design assign[b / bt]; `highest` (K15, shared taps only) runs the body in
// fp32, one product per tap.
extern "C" int afp_fir_td(const void* x_ext, const void* h, void* out, int B,
                          int T, int n_taps, const void* assign, int bt, int D,
                          int highest, int has_clip, float clip, int dither,
                          unsigned int seed, unsigned int counter, float lsb,
                          int emit_i16, void* stream) {
  Src s{};
  s.x = x_ext;
  s.B = B;
  s.T = T;
  s.hist = n_taps - 1;
  s.S = 1;
  s.start = 0;
  if (!set_bank(&s, assign, bt, D) || (highest && assign != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const afp::Epilogue epi =
      make_epilogue(has_clip, clip, dither, seed, counter, lsb);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (highest)
    return launch_conv<kModeExt, kInF32, float>(
        s, static_cast<const float*>(h), n_taps, out, epi, 1, emit_i16, st);
  return launch_conv<kModeExt, kInF32>(s, static_cast<const float*>(h),
                                       n_taps, out, epi, 1, emit_i16, st);
}

// K3/K4 (in_kind 0: f32), K12 (1: int16 PCM), K13 (2: bf16 pair; the lo
// halves in ring_lo, tail_lo, tail_out_lo).  n_steps steps over ring slots
// (start+i) mod S behind the carried tail [B, k_pad]; step i writes
// out_ring slot (start+i) mod S in place (f32, or int16 with emit_i16) and
// dithers under block counter counter+i; tail_out [B, k_pad] gets the tail
// after the last step, in the ring's element type.  `assign`/`bt`/`D`: the
// bank option, as for K10 (f32 and int16 rings).
extern "C" int afp_fir_td_ring(const void* ring, const void* ring_lo,
                               const void* tail, const void* tail_lo,
                               const void* h, void* out_ring, void* tail_out,
                               void* tail_out_lo, int in_kind, int S, int B,
                               int T, int k_pad, int n_taps, int start,
                               int n_steps, const void* assign, int bt,
                               int D, int has_clip, float clip,
                               int dither, unsigned int seed,
                               unsigned int counter, float lsb, int emit_i16,
                               void* stream) {
  // stream positions are int: (n_steps + 1) * T + k_pad must fit
  if (S <= 0 || k_pad < n_taps - 1 || k_pad <= 0 || start < 0 ||
      in_kind < kInF32 || in_kind > kInPair ||
      static_cast<long long>(n_steps + 1) * T + k_pad > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  Src s{};
  s.x = ring;
  s.xl = ring_lo;
  s.t = tail;
  s.tl = tail_lo;
  s.B = B;
  s.T = T;
  s.hist = k_pad;
  s.S = S;
  s.start = start % S;
  if (!set_bank(&s, assign, bt, D))
    return static_cast<int>(cudaErrorInvalidValue);
  const afp::Epilogue epi =
      make_epilogue(has_clip, clip, dither, seed, counter, lsb);
  const float* hf = static_cast<const float*>(h);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (in_kind) {
    case kInF32:
      return launch_ring<kInF32>(s, hf, n_taps, out_ring, tail_out, nullptr,
                                 n_steps, epi, emit_i16, st);
    case kInI16:
      return launch_ring<kInI16>(s, hf, n_taps, out_ring, tail_out, nullptr,
                                 n_steps, epi, emit_i16, st);
    default:
      return launch_ring<kInPair>(s, hf, n_taps, out_ring, tail_out,
                                  tail_out_lo, n_steps, epi, emit_i16, st);
  }
}

// K8 and K7.  The bf16 pair of the block [B, T] behind the pair tail
// [B, k_pad] -> slot idx of out [S, B, T] (K8: S = 1, idx = 0), f32 or
// (emit_i16) int16, and the next pair tail [B, k_pad].
extern "C" int afp_fir_td_pair(const void* xh, const void* xl, const void* th,
                               const void* tl, const void* h, void* out,
                               void* th_out, void* tl_out, int S, int B, int T,
                               int k_pad, int n_taps, int idx, int has_clip,
                               float clip, int dither, unsigned int seed,
                               unsigned int counter, float lsb, int emit_i16,
                               void* stream) {
  if (S <= 0 || idx < 0 || k_pad <= 0 || k_pad < n_taps - 1 ||
      static_cast<long long>(T) + k_pad > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  Src s{};
  s.x = xh;
  s.xl = xl;
  s.t = th;
  s.tl = tl;
  s.B = B;
  s.T = T;
  s.hist = k_pad;
  s.S = S;
  s.start = idx % S;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = launch_conv<kModePair, kInPair>(
      s, static_cast<const float*>(h), n_taps, out,
      make_epilogue(has_clip, clip, dither, seed, counter, lsb), 1, emit_i16,
      st);
  if (rc) return rc;
  // the block is a one-slot ring for the tail: the last k_pad samples of
  // concat(tail, block)
  s.S = 1;
  s.start = 0;
  return launch_tail<kInPair>(s, 1, th_out, tl_out, st);
}

// K11 (and K15's HIGHEST K11 with `highest`).  x_ext [B, n_taps-1+T], the
// band tiles of the n_bands band kernels (`ops/cuda/fir_td.py:band_tiles`:
// [n_bands][S][P][32 lanes][4] bf16, P = 2 or, for HIGHEST, 3) and the
// per-stream gains [B, n_bands] -> out [B, T] = sum_k gains[:, k] * (x conv
// bands[k]), with the body's store (clip, dither, f32 or int16).
extern "C" int afp_fir_td_ps(const void* x_ext, const void* tiles,
                             const void* gains, void* out, int B, int T,
                             int n_taps, int n_bands, int highest,
                             int has_clip, float clip, int dither,
                             unsigned int seed, unsigned int counter,
                             float lsb, int emit_i16, void* stream) {
  if (B <= 0 || T <= 0 || T % 4 || n_taps <= 0 || n_bands <= 0 ||
      reinterpret_cast<uintptr_t>(tiles) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  Src s{};
  s.x = x_ext;
  s.B = B;
  s.T = T;
  s.hist = n_taps - 1;
  s.S = 1;
  const afp::Epilogue epi =
      make_epilogue(has_clip, clip, dither, seed, counter, lsb);
  const float* gf = static_cast<const float*>(gains);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (highest)
    return launch_ps<3>(s, tiles, gf, n_taps, n_bands, out, epi, emit_i16, st);
  return launch_ps<2>(s, tiles, gf, n_taps, n_bands, out, epi, emit_i16, st);
}
