// K1, K3, K4, K7, K8, K10, K11, K12, K13, K15: the fused single-rate FIR of
// the filter chain on the H100's tensor cores, in bf16x3 (or, for K15's
// HIGHEST, the six products of the exact three-way bf16 split).
//
// Replaces twelve TPU kernels of `afp_tpu/ops/pallas/fir_td.py`, which share
// one conv body here (fir_conv_kernel) and differ only in where a block's
// input window comes from (the loader, `stage_window`), where its taps come
// from, and in the store:
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
//       per-tile design assignment assign[B / bt] (bt a multiple of 8, or the
//       whole batch).  A block's 16 rows are two 8-row groups, each in one
//       assignment tile; the block runs its window once per distinct design
//       among its groups (taps h + d * n_taps: selection is addressing) and
//       each row keeps the sums of its own design's pass, so a banked row
//       equals the shared-taps form on its design bit for bit.  An entry
//       outside [0, D) reads no taps and writes its rows as NaN (-32768 in
//       the int16 store): checked in the kernel, with no host synchronize.
//       The ring forms (K3, K4, K12) take the same bank option.
//   K11 fir_td_mxu_per_stream    (fir_td.py:1784, _fir_kernel_ps_b3): the
//       per-stream EQ mix y[b] = sum_k g[b, k] * (x[b] conv h_k) over K band
//       kernels (fir_ps_kernel): per band, the same tensor-core product
//       against the band's tiles, built in shared memory from the band
//       kernels as the body builds its own, into a double buffer (band k+1
//       while band k runs), then y += g * z in fp32 (the taps are not mixed
//       first, which would round differently).  Its pair forms take K8's
//       loader (afp_fir_td_ps_pair): the staged pair form reads the AGC
//       apply kernel's (hi, lo) block behind the carried pair tail, and the
//       pair-to-ring form is the same with K7's slot store into out_ring
//       slot idx; both emit the next pair tail as K7/K8 do (ring_tail_kernel),
//       so the ring form's slot equals the staged form's output bit for bit.
//   K15 the precision variants of _fir_td_call (fir_td.py:370): HIGHEST
//       (_fir_kernel, fir_td.py:148; in K11 _fir_kernel_ps, :1701), the
//       causal/valid conv in fp32 class: the TPU's own 6-pass product, x and
//       the taps split exactly into three bf16 halves, six products per tap
//       (the P = 3 instantiation of both kernels; staged f32 x_ext only).
//       B3F (_fir_kernel_b3f, :236) and B3C (_fir_kernel_b3c, :316) are B3's
//       function with the split done in VMEM, or over time-chunk pairs: this
//       body reads one f32 x and splits it in its loader, so both are the
//       bf16x3 body.
//
// Numerics: y[b,t] = sum_k (xh*hh + xh*hl + xl*hh), where xh/xl and hh/hl are
// the bf16 hi/lo halves of the input and the taps made with split_bf16's
// integer round-to-nearest-even mask.  Each product of two bf16 values is
// exact in fp32, so this is the TPU's bf16x3 class; only the order of the
// fp32 sums differs.  The products run as mma.sync m16n8k16 (band_mma.cuh):
// a 16-row x 16-position slice of the staged window against one 16 x 8
// Toeplitz tile of the taps.  The tensor core adds inside an mma with
// truncation, so the k-steps are summed in chunks of kAccSteps: each chunk
// in a fresh fragment, the chunk sums added in fp32 round-to-nearest in step
// order.  An output's sum order then depends only on its column in the
// 8-wide tile: never on its row, the batch, the form or the geometry, so
// ring == staged, mega == chained steps, pcm16 == f32 fed n/32768, pair ==
// f32 split, K7 == K8, a banked row == the shared form on its design, a row
// alone == the row in a batch and fold == scan, all bit for bit, and K1 ==
// K11 run with one band at gain 1.0.  Epilogue: clip, then Philox dither
// (philox.cuh), then the store: f32, or with `emit_i16` the int16 PCM
// quantizer int16(clip(rint(y * 32768), -32768, 32767)) (`_finish_tile`,
// round half to even, clamped in float before the exact convert).
//
// What bounds it on H100 at the headline shape (batch 4096, block 4096,
// 379 taps): traffic is ~140 MB per block in f32 (42 us at 3.35 TB/s),
// and the tensor cores do (4096/16) * (4096/8) * 25 k-steps * 3 = 9.8 M mma
// m16n8k16 (41 us at the 989 TFLOP/s bf16 peak; HIGHEST's six products
// 83 us), so it sits at the ridge.  In practice about half its time is a
// block's staging (the window, its halo included, split through the SM)
// and store (the tile through shared memory), the other half mma.sync fed
// from shared memory (171 bytes per mma per warp in bf16x3).  Design
// (fir_conv_kernel): a block of 8 warps owns 16 rows x 512 outputs, each
// warp 16 rows x 64 outputs (8 mma tiles), at most 128 registers a thread,
// so two blocks share an SM and one can stage or store while the other
// multiplies.  The window (cols - 8 + 16 S positions) is staged once per
// block, split into P bf16 arrays, in runs (the tail and each ring slot it
// touches), so no element divides by T.  The S Toeplitz tiles are built in
// shared memory from the taps pointer in the mma B-fragment order (entry
// for entry `ops/cuda/fir_td.py:band_tiles`), so no tiles tensor or memo
// exists and a bank is addressing.  Long filters walk the k-steps in
// window chunks of C steps (a multiple of kAccSteps) that fit 227 KB: the
// chunk's window segment and tiles are restaged and the sums go on in the
// same order.  The geometry (conv_geom) is mirrored by
// `ops/cuda/fir_td.py:conv_geometry` and reported by afp_conv_geometry.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "band_mma.cuh"
#include "philox.cuh"

namespace {

// The geometry (chosen by the sweep of `chip_conv_sweep.py`, PERF.md §6)
constexpr int kAccSteps = 16;     // k-steps summed in one fragment
constexpr int kBodyWarps = 8;     // the body: warps of a block, 64 outputs each
constexpr int kBodyMT = 1;        // m16 row tiles per warp: the body
constexpr int kBodyMinBlocks = 2;  // blocks an SM holds (caps registers at 128)
constexpr int kPsMT = 2;          // and K11
constexpr int kPsLoads = 16;      // K11: tile entries a thread loads ahead
constexpr int kRows = 4;          // batch rows of one store_rows call
constexpr int kNQ = 8;            // n8 column tiles per warp
constexpr size_t kMaxSmem = 227u * 1024u;
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

__host__ __device__ constexpr int conv_cols(int warps) { return 8 * kNQ * warps; }

// The geometry of the body, mirrored by `ops/cuda/fir_td.py:conv_geometry`:
// S k-steps of 16 window positions per 8-output column tile; the window
// chunk of C steps (all S when they fit, else the largest multiple of
// kAccSteps that does) and its W = cols - 8 + 16 C positions in rows of wp
// bf16 (8 mod 64, for ldmatrix); the shared memory: the window's P halves
// of 16 mt rows (or, after the product, the f32 output tile over them),
// then `bufs` buffers of the chunk's tiles ([C][P][32 lanes] x 8 bytes).
struct ConvGeom {
  int S, C, W, wp;
  size_t region, tile_bytes, smem;
};

__host__ __device__ inline void conv_layout(ConvGeom* g, int C, int P,
                                            int warps, int mt, int bufs) {
  g->C = C;
  g->W = conv_cols(warps) - 8 + 16 * C;
  g->wp = (g->W - 8 + 63) / 64 * 64 + 8;
  const size_t win = static_cast<size_t>(P) * 16 * mt * g->wp * 2;
  const size_t ys = sizeof(float) * 16 * mt * (conv_cols(warps) + 8);
  g->region = win > ys ? win : ys;
  g->tile_bytes = static_cast<size_t>(C) * P * 256;
  g->smem = g->region + bufs * g->tile_bytes;
}

// The body's geometry; C = 0 when nothing fits (the launch refuses).
__host__ __device__ inline ConvGeom conv_geom(int n_taps, int P) {
  ConvGeom g;
  g.S = (n_taps + 7 + 15) / 16;
  conv_layout(&g, g.S, P, kBodyWarps, kBodyMT, 1);
  for (int C = g.S / kAccSteps * kAccSteps; g.smem > kMaxSmem && C > 0;
       C -= kAccSteps)
    conv_layout(&g, C, P, kBodyWarps, kBodyMT, 1);
  if (g.smem > kMaxSmem) g.C = 0;
  return g;
}

// K11's geometry: the whole window at once (C = S) and two tile buffers;
// it fits 227 KB up to 1033 taps in bf16x3 (4 warps) and 457 in HIGHEST
// (8 warps), and the launch refuses beyond.
__host__ __device__ inline ConvGeom ps_geom(int n_taps, int P, int warps) {
  ConvGeom g;
  g.S = (n_taps + 7 + 15) / 16;
  conv_layout(&g, g.S, P, warps, kPsMT, 2);
  return g;
}

// Stage window positions [p_lo, p_hi) of rows b0 .. b0+ROWS-1 from one
// array: position p of row b reads element base + b * stride + (p - p_lo),
// converted and split into P bf16 halves at win[q][r][p] (rows beyond B are
// zero).  Each thread issues 16 rows' loads of a position before it splits
// and stores any, so the loads overlap instead of queueing on latency.
template <int IN, int P, int NT, int ROWS>
__device__ __forceinline__ void stage_run(uint16_t* __restrict__ win, int wp,
                                          const void* hi, const void* lo,
                                          long long base, int stride, int b0,
                                          int B, int p_lo, int p_hi) {
  for (int p = p_lo + static_cast<int>(threadIdx.x); p < p_hi; p += NT) {
    const long long o = base + (p - p_lo);
#pragma unroll
    for (int r0 = 0; r0 < ROWS; r0 += 16) {
      uint32_t v[16];  // f32 bits, or the pair's (hi << 16) | lo
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const int b = b0 + r0 + r;
        const long long i = static_cast<long long>(b) * stride + o;
        if (b >= B) {
          v[r] = 0u;
        } else if constexpr (IN == kInF32) {
          v[r] = __float_as_uint(__ldg(static_cast<const float*>(hi) + i));
        } else if constexpr (IN == kInI16) {
          v[r] = __float_as_uint(__fmul_rn(
              static_cast<float>(__ldg(static_cast<const short*>(hi) + i)),
              1.0f / 32768.0f));
        } else {
          v[r] = (static_cast<uint32_t>(
                      __ldg(static_cast<const unsigned short*>(hi) + i)) << 16) |
                 __ldg(static_cast<const unsigned short*>(lo) + i);
        }
      }
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        uint16_t h[P];
        if constexpr (IN == kInPair) {
          static_assert(P == 2, "the pair forms are bf16x3");
          h[0] = static_cast<uint16_t>(v[r] >> 16);
          h[1] = static_cast<uint16_t>(v[r] & 0xFFFFu);
        } else {
          afp::split_halves<P>(__uint_as_float(v[r]), h);
        }
#pragma unroll
        for (int q = 0; q < P; ++q)
          win[(static_cast<size_t>(q) * ROWS + r0 + r) * wp + p] = h[q];
      }
    }
  }
}

// Stage the window of rows b0 .. b0+ROWS-1: position p in [0, W) holds
// sample e_start + p of step `step`'s extended signal (zero at or past
// hist + T).  K1 reads one run of x_ext; the ring and pair forms walk the
// stream tail ++ slot(start) ++ slot(start+1) ++ ... in runs, one per array
// the window touches, so the slot of a run is found once (one division per
// run, not per element).  The pair block is a one-slot ring.
template <int MODE, int IN, int P, int NT, int ROWS>
__device__ __forceinline__ void stage_window(const Src& s, int b0, int step,
                                             int e_start, int W, int wp,
                                             uint16_t* __restrict__ win) {
  // stream positions fit an int (the entry points check (n_steps + 1) * T
  // + hist), so no 64-bit division runs here
  const int avail = s.hist + s.T - e_start;
  const int p_end = avail <= 0 ? 0 : (avail < W ? avail : W);
  if constexpr (MODE == kModeExt) {
    stage_run<IN, P, NT, ROWS>(win, wp, s.x, nullptr, e_start, s.hist + s.T,
                               b0, s.B, 0, p_end);
  } else {
    const int S_in = MODE == kModePair ? 1 : s.S;
    const int start_in = MODE == kModePair ? 0 : s.start;
    const int sp0 = step * s.T + e_start;
    int p = 0;
    while (p < p_end) {
      const int q = sp0 + p;  // stream position of window position p
      if (q < s.hist) {
        const int len = s.hist - q < p_end - p ? s.hist - q : p_end - p;
        stage_run<IN, P, NT, ROWS>(win, wp, s.t, s.tl, q, s.hist, b0, s.B, p,
                                   p + len);
        p += len;
      } else {
        const int j = (q - s.hist) / s.T;
        const int r = q - s.hist - j * s.T;
        const int slot = (start_in + j) % S_in;
        const int len = s.T - r < p_end - p ? s.T - r : p_end - p;
        stage_run<IN, P, NT, ROWS>(win, wp, s.x, s.xl,
                                   static_cast<long long>(slot) * s.B * s.T + r,
                                   s.T, b0, s.B, p, p + len);
        p += len;
      }
    }
  }
  for (int p = p_end + static_cast<int>(threadIdx.x); p < W; p += NT)
#pragma unroll
    for (int r = 0; r < P * ROWS; ++r) win[static_cast<size_t>(r) * wp + p] = 0;
}

// The Toeplitz tiles of steps s0 .. s0+steps-1 of the taps h [n] in shared
// memory, in the mma B-fragment order of `ops/cuda/fir_td.py:band_tiles`,
// entry for entry: tile s, lane l (g = l / 4, t = l % 4) holds B[i][g] for i
// = 2t, 2t+1, 2t+8, 2t+9, B[i][j] = h[n-1 - 16 s + j - i] (zero outside the
// taps), each split into P bf16 halves: [steps][P][32 lanes][4].  A thread
// takes entries i0 + u NT, L at a time: load_taps issues their loads,
// store_taps splits and stores them, so a caller can run other work while
// the loads are in flight.
template <int NT, int L>
__device__ __forceinline__ void load_taps(const float* __restrict__ h, int n,
                                          int s0, int steps, int i0,
                                          float (&v)[L]) {
#pragma unroll
  for (int u = 0; u < L; ++u) {
    const int i = i0 + u * NT;
    const int sl = i >> 7, lane = (i >> 2) & 31, e = i & 3;
    const int row = 2 * (lane & 3) + (e & 1) + 8 * (e >> 1);
    const int k = n - 1 - 16 * (s0 + sl) + (lane >> 2) - row;
    v[u] = i < steps * 128 && k >= 0 && k < n ? __ldg(h + k) : 0.f;
  }
}

template <int P, int NT, int L>
__device__ __forceinline__ void store_taps(int steps, int i0,
                                           const float (&v)[L],
                                           uint16_t* __restrict__ tiles) {
#pragma unroll
  for (int u = 0; u < L; ++u) {
    const int i = i0 + u * NT;
    if (i >= steps * 128) break;
    const int sl = i >> 7, lane = (i >> 2) & 31, e = i & 3;
    uint16_t hv[P];
    afp::split_halves<P>(v[u], hv);
#pragma unroll
    for (int q = 0; q < P; ++q) tiles[((sl * P + q) * 32 + lane) * 4 + e] = hv[q];
  }
}

// The tiles' entries from `first` on (a thread's first entry is
// threadIdx.x; K11 may have stored some already).
template <int P, int NT>
__device__ __forceinline__ void build_tiles(const float* __restrict__ h, int n,
                                            int s0, int steps,
                                            uint16_t* __restrict__ tiles,
                                            int first) {
  constexpr int L = 4;
  for (int i0 = first; i0 < steps * 128; i0 += L * NT) {
    float v[L];
    load_taps<NT, L>(h, n, s0, steps, i0, v);
    store_taps<P, NT, L>(steps, i0, v, tiles);
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
                                           int slot, uint32_t step,
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
                              epi.counter + step);
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

// The product of one window chunk against its tiles (local steps [0, C)),
// in accumulation chunks of kAccSteps steps: each summed in a fresh
// fragment, then handed to `add(z)` (K1: z_total += z; K11: y += g * z).
template <int P, int MT, typename Add>
__device__ __forceinline__ void conv_chunks(const uint16_t* win, int wp,
                                            int cbase,
                                            const unsigned char* tiles, int C,
                                            Add add) {
#pragma unroll 1
  for (int a0 = 0; a0 < C; a0 += kAccSteps) {
    float z[MT][kNQ][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int q = 0; q < kNQ; ++q)
#pragma unroll
        for (int i = 0; i < 4; ++i) z[mt][q][i] = 0.f;
    afp::band_conv<P, MT, kNQ>(win, 16 * MT, wp, cbase + 16 * a0,
                                tiles + static_cast<size_t>(a0) * P * 256,
                                C - a0 < kAccSteps ? C - a0 : kAccSteps, z);
    add(z);
  }
}

// Stage a warp's fragment tile y over the block's shared memory (row
// stride cols + 8) and store it 4 rows x 4 outputs at a time through
// store_rows; `bad` has a bit per 8-row group whose rows are NaN.
template <int NT, int COLS, int MT>
__device__ __forceinline__ void store_tile(const Src& src, float* ys, int b0,
                                           int t0, int slot, int step,
                                           const float (&y)[MT][kNQ][4],
                                           unsigned bad,
                                           const afp::Epilogue& epi,
                                           int emit_i16, void* out) {
  constexpr int kYStride = COLS + 8;
  const int lane = threadIdx.x & 31;
  const int cbase = (threadIdx.x >> 5) * 8 * kNQ;
  __syncthreads();  // every warp is done with the window the tile overlays
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int q = 0; q < kNQ; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mt * 16 + (lane >> 2) + 8 * h;
        const int c = cbase + 8 * q + 2 * (lane & 3);
        *reinterpret_cast<float2*>(ys + r * kYStride + c) =
            make_float2(y[mt][q][2 * h], y[mt][q][2 * h + 1]);
      }
  __syncthreads();
  constexpr int kChunks = 16 * MT / kRows * (COLS / 4);
  // the step's block counter, past the chunk's on the device when given
  const uint32_t key_step =
      static_cast<uint32_t>(step) +
      (epi.counter_dev != nullptr ? *epi.counter_dev : 0u);
  for (int i = threadIdx.x; i < kChunks; i += NT) {
    const int c = (i % (COLS / 4)) * 4;
    const int r = (i / (COLS / 4)) * kRows;
    if (t0 + c >= src.T) continue;
    float acc[kRows][4];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const float4 v =
          *reinterpret_cast<const float4*>(ys + (r + rr) * kYStride + c);
      acc[rr][0] = v.x;
      acc[rr][1] = v.y;
      acc[rr][2] = v.z;
      acc[rr][3] = v.w;
    }
    store_rows(src, b0 + r, t0 + c, slot, key_step, acc, epi, emit_i16, out,
               (bad >> (r / 8)) & 1u);
  }
}

// The conv body on the tensor cores: P = 2 is bf16x3 (K1, K3/K4, K7/K8,
// K10, K12, K13), P = 3 K15's HIGHEST (K1 only).  Block (row tile, time
// tile, ring step); see the header for the design.
template <int MODE, int IN, int P>
__global__ void __launch_bounds__(32 * kBodyWarps, kBodyMinBlocks)
    fir_conv_kernel(Src src, const float* __restrict__ h, int n_taps,
                    void* __restrict__ out, afp::Epilogue epi, int n_steps,
                    int emit_i16) {
  constexpr int NT = 32 * kBodyWarps;
  constexpr int COLS = conv_cols(kBodyWarps);
  constexpr int MT = kBodyMT;
  constexpr int ROWS = 16 * MT;
  constexpr int GROUPS = ROWS / 8;  // 8-row design groups
  const int step = blockIdx.z;
  // with n_steps > S a slot is written by several steps; the last one wins,
  // as in the reference's sequential walk
  if (MODE == kModeRing && step + src.S < n_steps) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const ConvGeom geo = conv_geom(n_taps, P);
  uint16_t* win = reinterpret_cast<uint16_t*>(smem_raw);  // [P][rows][wp]
  unsigned char* tiles = smem_raw + geo.region;
  const int b0 = blockIdx.x * ROWS;
  const int t0 = blockIdx.y * COLS;
  const int cbase = (threadIdx.x >> 5) * 8 * kNQ;

  // the design of each 8-row group: `live` groups have rows and taps, `bad`
  // ones an assignment outside [0, D) (NaN rows, no taps read)
  int design[GROUPS];
  unsigned live = 0, bad = 0;
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    const int b = b0 + 8 * g;
    design[g] = 0;
    if (b >= src.B) continue;
    if (src.assign != nullptr) {
      design[g] = src.assign[b / src.bt];
      if (design[g] < 0 || design[g] >= src.D) {
        bad |= 1u << g;
        continue;
      }
    }
    live |= 1u << g;
  }

  float zt[MT][kNQ][4];  // this lane's sums: rows mt*16 + lane/4 (+8)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int q = 0; q < kNQ; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i) zt[mt][q][i] = 0.f;

  // window position p of chunk c0 holds extended sample e0 + 16 c0 + p
  const int e0 = t0 + src.hist - (n_taps - 1);
  for (int c0 = 0; live != 0 && c0 < geo.S; c0 += geo.C) {
    const int C = geo.S - c0 < geo.C ? geo.S - c0 : geo.C;
    if (c0 > 0) __syncthreads();  // every warp is done with the last chunk
    stage_window<MODE, IN, P, NT, ROWS>(src, b0, step, e0 + 16 * c0,
                                        COLS - 8 + 16 * C, geo.wp, win);
    // one pass per distinct design among the live groups, in group order
    for (unsigned todo = live, pass = 0; todo != 0; ++pass) {
      int d = -1;  // the design of the first group still to run
      unsigned mask = 0;
#pragma unroll
      for (int g = 0; g < GROUPS; ++g) {
        if (((todo >> g) & 1u) && d < 0) d = design[g];
        if (((todo >> g) & 1u) && design[g] == d) mask |= 1u << g;
      }
      todo &= ~mask;
      if (pass > 0) __syncthreads();  // every warp is done with the tiles
      build_tiles<P, NT>(h + static_cast<long long>(d) * n_taps, n_taps, c0,
                         C, reinterpret_cast<uint16_t*>(tiles), threadIdx.x);
      __syncthreads();
      // each row keeps only its own design's sums
      bool take[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) take[mt][hh] = (mask >> (2 * mt + hh)) & 1u;
      conv_chunks<P, MT>(win, geo.wp, cbase, tiles, C,
                         [&](const float (&z)[MT][kNQ][4]) {
#pragma unroll
                           for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                             for (int q = 0; q < kNQ; ++q)
#pragma unroll
                               for (int i = 0; i < 4; ++i)
                                 if (take[mt][i >> 1])
                                   zt[mt][q][i] = __fadd_rn(zt[mt][q][i], z[mt][q][i]);
                         });
    }
  }

  int slot = 0;
  if (MODE == kModeRing) slot = (src.start + step) % src.S;
  else if (MODE == kModePair) slot = src.start;  // K7's output slot (K8: 0)
  store_tile<NT, COLS, MT>(src, reinterpret_cast<float*>(smem_raw), b0, t0,
                           slot, step, zt, bad, epi, emit_i16, out);
}

// K11: y[b] = sum_k g[b, k] * (x[b] conv bands[k]), k in order, on the
// tensor cores: bf16x3 (P = 2 halves) or K15's HIGHEST (P = 3, the
// six-product fp32 emulation).  A block of WARPS warps owns 16 * kPsMT
// batch rows x conv_cols(WARPS) outputs; each warp kPsMT x 16 rows x kNQ x 8
// outputs.  The window of the block (cols - 8 + 16 S positions) is staged
// once, split into P bf16 arrays; the band tiles are built in shared memory
// from the band kernels (build_tiles, as the body builds its own) into a
// double buffer, so the band count is not bounded by shared memory: the
// loads of band k+1's first kPsLoads entries a thread (its first 4 WARPS
// k-steps) are issued before band k's product and stored after it, so
// their latency hides behind the product, and the rest load after it;
// each accumulation chunk's fp32 fragment z is mixed y = y + g[b, k] * z
// (round to nearest, in the body's chunk order, so one band at gain 1.0
// equals K1).  The mixed tile is staged through
// shared memory into the body's store (clip, dither over flat >> 2, f32 or
// int16).  WARPS is 4 for bf16x3 (about 200 registers: two blocks of 4
// warps share an SM; a bound of 168 registers for three spills and ran
// slower) and 8 for the six-product form (about 230 registers and a
// three-half window: one block per SM, so as wide a block as fits).
// MODE/IN pick the loader as in the body: kModeExt/kInF32 reads a staged
// x_ext; kModePair/kInPair reads the bf16 pair block behind the pair tail
// (bf16x3 only) and stores into slot src.start of `out` (K7's store).
template <int MODE, int IN, int P, int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
    fir_ps_kernel(Src src, const float* __restrict__ bands,
                  const float* __restrict__ gains, int n_bands, int n_taps,
                  void* __restrict__ out, afp::Epilogue epi, int emit_i16) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int NT = 32 * WARPS;
  constexpr int COLS = conv_cols(WARPS);
  const ConvGeom geo = ps_geom(n_taps, P, WARPS);
  uint16_t* win = reinterpret_cast<uint16_t*>(smem_raw);  // [P][rows][wp]
  // band k's tiles: buffer k & 1 after the window region
  auto buf = [&](int k) {
    return smem_raw + geo.region + (k & 1) * geo.tile_bytes;
  };

  constexpr int ROWS = 16 * kPsMT;
  const int b0 = blockIdx.x * ROWS;
  const int t0 = blockIdx.y * COLS;
  const int tid = threadIdx.x;
  const int lane = tid & 31;

  build_tiles<P, NT>(bands, n_taps, 0, geo.S, reinterpret_cast<uint16_t*>(buf(0)),
                     tid);
  // window position p of row r holds extended sample t0 + hist - (n-1) + p
  // of row b0 + r (x_ext[b0 + r, t0 + p] for K1's loader; 0 outside)
  stage_window<MODE, IN, P, NT, ROWS>(src, b0, 0, t0 + src.hist - (n_taps - 1),
                                      geo.W, geo.wp, win);

  // this lane's fragment rows: mt * 16 + lane / 4 (+ 8)
  float y[kPsMT][kNQ][4];
#pragma unroll
  for (int mt = 0; mt < kPsMT; ++mt)
#pragma unroll
    for (int q = 0; q < kNQ; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i) y[mt][q][i] = 0.f;
  const int cbase = (tid >> 5) * 8 * kNQ;
#pragma unroll 1
  for (int k = 0; k < n_bands; ++k) {
    // band k's tiles (and, at k = 0, the window) are in, and every warp is
    // done with band k-1's buffer, which band k+1's tiles fill next
    __syncthreads();
    const float* next = bands + static_cast<long long>(k + 1) * n_taps;
    float pre[kPsLoads];
    if (k + 1 < n_bands) load_taps<NT, kPsLoads>(next, n_taps, 0, geo.S, tid, pre);
    float gk[kPsMT][2];
#pragma unroll
    for (int mt = 0; mt < kPsMT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int b = b0 + mt * 16 + (lane >> 2) + 8 * h;
        gk[mt][h] = b < src.B
            ? gains[static_cast<long long>(b) * n_bands + k] : 0.f;
      }
    conv_chunks<P, kPsMT>(win, geo.wp, cbase, buf(k),
                          geo.S, [&](const float (&z)[kPsMT][kNQ][4]) {
#pragma unroll
                     for (int mt = 0; mt < kPsMT; ++mt)
#pragma unroll
                       for (int q = 0; q < kNQ; ++q)
#pragma unroll
                         for (int i = 0; i < 4; ++i)
                           y[mt][q][i] = __fadd_rn(
                               y[mt][q][i], __fmul_rn(gk[mt][i >> 1], z[mt][q][i]));
                   });
    if (k + 1 < n_bands) {
      uint16_t* tiles = reinterpret_cast<uint16_t*>(buf(k + 1));
      store_taps<P, NT, kPsLoads>(geo.S, tid, pre, tiles);
      build_tiles<P, NT>(next, n_taps, 0, geo.S, tiles, tid + kPsLoads * NT);
    }
  }
  store_tile<NT, COLS, kPsMT>(src, reinterpret_cast<float*>(smem_raw), b0, t0,
                              MODE == kModePair ? src.start : 0, 0, y, 0u, epi,
                              emit_i16, out);
}

// Next tail after n_steps ring steps: the last hist samples of the stream,
// i.e. step n_steps's history, in the ring's own element type (raw int16 for
// K12, both halves for K13 and K7/K8).  With `counter_dev` one thread adds
// `counter_add` to the device's block counter, after the conv read it.
template <int IN>
__global__ void ring_tail_kernel(Src src, int n_steps, void* __restrict__ out,
                                 void* __restrict__ out_lo,
                                 uint32_t* __restrict__ counter_dev,
                                 uint32_t counter_add) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (counter_dev != nullptr && i == 0) *counter_dev += counter_add;
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
                            float lsb, const void* counter_dev = nullptr) {
  afp::Epilogue e;
  e.has_clip = has_clip;
  e.clip = clip;
  e.dither = dither;
  e.seed = seed;
  e.counter = counter;
  e.lsb = lsb;
  e.counter_dev = static_cast<const uint32_t*>(counter_dev);
  return e;
}

template <int MODE, int IN, int P = 2>
int launch_conv(const Src& s, const float* h, int n_taps, void* out,
                const afp::Epilogue& epi, int n_steps, int emit_i16,
                cudaStream_t stream) {
  if (s.B <= 0 || s.T <= 0 || s.T % 4 || n_taps <= 0 || n_steps <= 0 ||
      n_steps > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const ConvGeom geo = conv_geom(n_taps, P);
  if (geo.C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      fir_conv_kernel<MODE, IN, P>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(geo.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kCols = conv_cols(kBodyWarps);
  const dim3 grid((s.B + 16 * kBodyMT - 1) / (16 * kBodyMT),
                  (s.T + kCols - 1) / kCols, n_steps);
  fir_conv_kernel<MODE, IN, P><<<grid, 32 * kBodyWarps, geo.smem, stream>>>(
      s, h, n_taps, out, epi, n_steps, emit_i16);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE, int IN, int P>
int launch_ps(const Src& s, const float* bands, const float* gains,
              int n_taps, int n_bands, void* out, const afp::Epilogue& epi,
              int emit_i16, cudaStream_t stream) {
  constexpr int WARPS = P == 2 ? 4 : 8;
  const ConvGeom geo = ps_geom(n_taps, P, WARPS);
  if (geo.smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      fir_ps_kernel<MODE, IN, P, WARPS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(geo.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s.B + 16 * kPsMT - 1) / (16 * kPsMT),
                  (s.T + conv_cols(WARPS) - 1) / conv_cols(WARPS));
  fir_ps_kernel<MODE, IN, P, WARPS><<<grid, 32 * WARPS, geo.smem, stream>>>(
      s, bands, gains, n_bands, n_taps, out, epi, emit_i16);
  return static_cast<int>(cudaGetLastError());
}

template <int IN>
int launch_tail(const Src& s, int n_steps, void* out, void* out_lo,
                cudaStream_t stream, void* counter_dev = nullptr,
                unsigned int counter_add = 0) {
  const long long n = static_cast<long long>(s.B) * s.hist;
  const int threads = 256;
  ring_tail_kernel<IN><<<static_cast<unsigned int>((n + threads - 1) / threads),
                         threads, 0, stream>>>(
      s, n_steps, out, out_lo, static_cast<uint32_t*>(counter_dev),
      counter_add);
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
// for shared taps.  False when a tile would split an 8-row design group or
// the bank is empty.
bool set_bank(Src* s, const void* assign, int bt, int D) {
  s->assign = static_cast<const int*>(assign);
  s->bt = bt;
  s->D = D;
  return assign == nullptr ||
         (D > 0 && bt > 0 && s->B % bt == 0 && (bt % 8 == 0 || bt == s->B));
}

}  // namespace

// K1, K10 and K15.  x_ext [B, n_taps-1+T] -> out [B, T], f32 or (emit_i16)
// int16; with `assign` (K10) h is the bank [D, n_taps] and row b takes
// design assign[b / bt]; `highest` (K15, shared taps only) runs the six
// products of the three-way split.
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
    return launch_conv<kModeExt, kInF32, 3>(
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
  // stream positions are int in the tail kernel: (n_steps + 1) * T + k_pad
  // must fit
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
// (emit_i16) int16, and the next pair tail [B, k_pad].  With `counter_dev`
// (a uint32 on the device) the dither's block counter is *counter_dev +
// counter, and the tail kernel then adds `counter_add` to it.
extern "C" int afp_fir_td_pair(const void* xh, const void* xl, const void* th,
                               const void* tl, const void* h, void* out,
                               void* th_out, void* tl_out, int S, int B, int T,
                               int k_pad, int n_taps, int idx, int has_clip,
                               float clip, int dither, unsigned int seed,
                               unsigned int counter, float lsb, int emit_i16,
                               void* counter_dev, unsigned int counter_add,
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
      make_epilogue(has_clip, clip, dither, seed, counter, lsb, counter_dev),
      1, emit_i16, st);
  if (rc) return rc;
  // the block is a one-slot ring for the tail: the last k_pad samples of
  // concat(tail, block)
  s.S = 1;
  s.start = 0;
  return launch_tail<kInPair>(s, 1, th_out, tl_out, st, counter_dev,
                              counter_add);
}

// K11 (and K15's HIGHEST K11 with `highest`).  x_ext [B, n_taps-1+T], the
// n_bands band kernels [n_bands, n_taps] f32 and the per-stream gains
// [B, n_bands] -> out [B, T] = sum_k gains[:, k] * (x conv bands[k]), with
// the body's store (clip, dither, f32 or int16).
extern "C" int afp_fir_td_ps(const void* x_ext, const void* bands,
                             const void* gains, void* out, int B, int T,
                             int n_taps, int n_bands, int highest,
                             int has_clip, float clip, int dither,
                             unsigned int seed, unsigned int counter,
                             float lsb, int emit_i16, void* stream) {
  if (B <= 0 || T <= 0 || T % 4 || n_taps <= 0 || n_bands <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Src s{};
  s.x = x_ext;
  s.B = B;
  s.T = T;
  s.hist = n_taps - 1;
  s.S = 1;
  const afp::Epilogue epi =
      make_epilogue(has_clip, clip, dither, seed, counter, lsb);
  const float* bf = static_cast<const float*>(bands);
  const float* gf = static_cast<const float*>(gains);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (highest)
    return launch_ps<kModeExt, kInF32, 3>(s, bf, gf, n_taps, n_bands, out, epi,
                                          emit_i16, st);
  return launch_ps<kModeExt, kInF32, 2>(s, bf, gf, n_taps, n_bands, out, epi,
                                        emit_i16, st);
}

// K11's pair forms (bf16x3).  The bf16 pair of the block [B, T] behind the
// pair tail [B, k_pad], the band kernels [n_bands, n_taps] and the
// per-stream gains [B, n_bands] -> slot idx of out [S, B, T] (the staged
// form: S = 1, idx = 0), f32 or (emit_i16) int16, and the next pair tail
// [B, k_pad]: K8's loader and K7's slot store around K11's mix.
// `counter_dev`/`counter_add`: as for afp_fir_td_pair.
extern "C" int afp_fir_td_ps_pair(const void* xh, const void* xl,
                                  const void* th, const void* tl,
                                  const void* bands, const void* gains,
                                  void* out, void* th_out, void* tl_out, int S,
                                  int B, int T, int k_pad, int n_taps,
                                  int n_bands, int idx, int has_clip,
                                  float clip, int dither, unsigned int seed,
                                  unsigned int counter, float lsb,
                                  int emit_i16, void* counter_dev,
                                  unsigned int counter_add, void* stream) {
  if (S <= 0 || idx < 0 || B <= 0 || T <= 0 || T % 4 || n_taps <= 0 ||
      n_bands <= 0 || k_pad <= 0 || k_pad < n_taps - 1 ||
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
  const int rc = launch_ps<kModePair, kInPair, 2>(
      s, static_cast<const float*>(bands), static_cast<const float*>(gains),
      n_taps, n_bands, out,
      make_epilogue(has_clip, clip, dither, seed, counter, lsb, counter_dev),
      emit_i16, st);
  if (rc) return rc;
  // the next tail: the last k_pad samples of concat(tail, block)
  s.S = 1;
  s.start = 0;
  return launch_tail<kInPair>(s, 1, th_out, tl_out, st, counter_dev,
                              counter_add);
}

// The body's geometry at n_taps (`highest`: P = 3), as the launch takes it:
// out[0..8] = S, C, W, wp, smem, rows, cols of a block, k-steps summed in
// one fragment, blocks an SM holds (C = 0: nothing fits).  For
// `ops/cuda/fir_td.py:conv_geometry` to check its mirror against.
extern "C" int afp_conv_geometry(int n_taps, int highest, long long* out) {
  if (n_taps <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const ConvGeom g = conv_geom(n_taps, highest ? 3 : 2);
  const long long v[9] = {g.S, g.C, g.W, g.wp, static_cast<long long>(g.smem),
                          16 * kBodyMT, conv_cols(kBodyWarps), kAccSteps,
                          kBodyMinBlocks};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return 0;
}
