// K1: forward of the fused EBEN residual stack, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel vibravox_tpu/ops/fused_residual.py::_fwd_kernel
// (launched by _pallas_forward, entry residual_stack).  It computes three
// chained ResidualUnits on NCW activations (B, C, T):
//
//     x <- x + leaky_slope(Wp . dilconv_{k=3, d}(reflect_pad_d(x)))   d = 1, 3, 9
//
// with each unit reflect-padding its OWN input at t = 0 and t = T-1, exactly
// as the plain convolution chain does.  There is no edge stitching from a
// plain path: the edges are computed here.
//
// Both types run one kernel, residual_stack_mma_kernel<T, C, V>.  One block
// per (batch element, time tile), so batch seams never mix.  The block loads
// its tile plus a 13-sample halo per side (1 + 3 + 9) into shared memory
// once, runs the three units there and stores the tile once: device memory
// sees one read of x, one write of y, and the weights (from L2).  Each unit
// is two small matrix products over the shrinking window:
//     h1 (C x R) = sum_k Wd[:, :, k] . x[:, j + (k-1) d]       R = TILE + 2 h
//     x[:, j]   += leaky(Wp . h1[:, j])                       (in place)
// where h is the halo still needed by the later units (12, 9, 0).  After a
// unit, the window positions outside [0, T) are refilled by reflecting the
// unit's output, so the next unit sees its own reflect padding.
//
// The products run on the tensor cores with f32 sums.  M is the window's
// time rows, N the output channels, K the input channels; the dilated conv
// is three K passes, one per tap, each shifting A's rows by (k-1) d.
//   - bfloat16: mma.sync m16n8k16 on bf16 operands.  float32: mma.sync
//     m16n8k8 in 3xTF32 (common.cuh): each operand split into TF32 hi and
//     lo, lo.hi + hi.lo + hi.hi summed, which holds the f32 bar of 2e-5 of
//     scale where one TF32 pass does not (tests/test_torch_residual_tf32.py).
//     Each step's three products go to a fresh sum that is then added to
//     the accumulator in f32: summed straight into it, the tensor cores'
//     truncation to the accumulator's exponent made K1 f32's output differ
//     from the plain chain's enough to move the pad_short phase's STFT-loss
//     gradients (near-silent frames) by 5.7% of their norm, against 0.24%
//     with the fresh sums (chip_smoke.py, H100, PR 17), for 4-14% more time.
//   - Planes are time-major, [row][C + E] with E = 16 bytes of T (8 bf16,
//     4 f32): row j is time t0 - 13 + j with its C channels contiguous.
//     The row stride is 80 / 144 / 272 bytes in bf16 and 144 / 272 / 528
//     in f32 (all 16 mod 128), so the 8 rows of an ldmatrix phase fall in
//     8 distinct 16-byte bank groups, and a dilation shift moves whole
//     rows, so every row address stays 16-byte aligned.  Global memory stays
//     NCW: the load and the store transpose through registers.
//   - A fragments come from xs (x) or hs (h1) by ldmatrix.x4; B fragments
//     from the staged weights [tap][o][i + E] by ldmatrix.x4.  On 32-bit
//     data ldmatrix hands out exactly TF32's A and B registers, so both
//     types walk the same byte addresses; a step is 32 bytes of K.  A
//     helper launch first lays the six weights out as [unit][tap 0-2, 3 =
//     Wp][o][i] in a scratch buffer, so each chunk of KC input channels
//     streams in with 16-byte cp.async, double-buffered: chunk n + 1 copies
//     while chunk n multiplies, one barrier per chunk.
//   - Rounding points: in bf16 h1 rounded to bf16; leaky, rounded to bf16,
//     added to xs in place and rounded to bf16 (the TPU kernel's).  In f32
//     h1 and the unit outputs stay f32, as in the plain chain; only the
//     summation order and the split's ~2^-21 differ.
//   - The 8 warps split each unit's (16-row m-tile, 8-channel n-tile)
//     pairs, MW x NW a warp, in every unit.  bf16 has one TILE per C, set so
//     that the recomputed halo (rounded up to whole m-tiles) is 8-18% of the
//     owned work, with the blocks that shared memory allows (3 / 2 / 2 at
//     C = 32 / 64 / 128).  f32 planes take twice the bytes, so its plans
//     are smaller; and since a batch-1 eval forward at C = 128 (T = 1248)
//     gives too few tiles to fill 132 SMs, f32 has a second, smaller tile
//     (V = 1), taken where the first would give fewer blocks than the card
//     has SMs.  The f32 plans (MmaPlan) are the fastest of those
//     scripts/torch_k1_plans.py timed at the serving, training and eval
//     shapes (H100 80GB HBM3 at 700 W, PR 17): at C = 128 one block of 96
//     rows an SM beat two of 40 at the training shape, and 78 blocks of 16
//     rows beat 39 of 32 at the eval shape.  The second tiles (72 / 40 /
//     16) fill at least half the SMs at the batch-1 eval shapes and leave
//     a ragged last tile on chip_smoke.py's whole test utterance.
// tests/test_torch_residual_fwd_mma.py emulates the bf16 walk in float64,
// tests/test_torch_residual_tf32.py the f32 one with its TF32 split.
//
// Bound on this card: 24 C^2 T B FLOP against 2 C T B elements moved (x in,
// y out).  bf16: 6C FLOP/byte against the bf16 tensor-core ridge of 295, so
// bytes bound it at C = 32 and operations at C = 64 and 128.  f32: three
// TF32 products each, 72 C^2 T B at 495 TFLOP/s (24 C^2 T B at 165 TFLOP/s
// f32-accurate), 3C FLOP/byte against a ridge of 49: operations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHalo = 13;  // 1 + 3 + 9: receptive radius of the three units

// elements of T in 16 bytes: the pad of every plane and weight row, one
// ldmatrix row, one cp.async piece, and half the K of one mma step (bf16
// m16n8k16, f32 m16n8k8)
template <typename T>
__host__ __device__ constexpr int vec() { return 16 / static_cast<int>(sizeof(T)); }

// two adjacent channels of a time-major row, as f32 and from f32 rounded to
// the storage type
__device__ __forceinline__ float2 load_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const bf162*>(p));
}
__device__ __forceinline__ float2 load_pair(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ void store_pair(bf16* p, float v0, float v1) {
  *reinterpret_cast<bf162*>(p) = __floats2bfloat162_rn(v0, v1);
}
__device__ __forceinline__ void store_pair(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

// plan variants per type: f32 has a second, smaller tile
template <typename T>
__host__ __device__ constexpr int variants() { return std::is_same<T, float>::value ? 2 : 1; }

// Per operand type, channel count and variant: TILE, KC (input channels per
// staged weight chunk), a warp's MW m16 tiles (time rows) by NW n8 tiles
// (output channels), and the blocks per SM __launch_bounds__ promises (at
// most what shared memory allows; a thread may then take 65536 / (256 x
// blocks) registers).
template <typename T, int C, int V>
struct MmaPlan;
template <>
struct MmaPlan<bf16, 32, 0> {
  static constexpr int kTile = 232, kKc = 32, kMw = 2, kNw = 4, kBlocks = 3;
};
template <>
struct MmaPlan<bf16, 64, 0> {
  static constexpr int kTile = 232, kKc = 32, kMw = 2, kNw = 8, kBlocks = 2;
};
template <>
struct MmaPlan<bf16, 128, 0> {
  static constexpr int kTile = 104, kKc = 16, kMw = 2, kNw = 8, kBlocks = 2;
};
template <>
struct MmaPlan<float, 32, 0> {
  static constexpr int kTile = 232, kKc = 32, kMw = 2, kNw = 4, kBlocks = 2;
};
template <>
struct MmaPlan<float, 32, 1> {
  static constexpr int kTile = 72, kKc = 16, kMw = 1, kNw = 4, kBlocks = 3;
};
template <>
struct MmaPlan<float, 64, 0> {
  static constexpr int kTile = 104, kKc = 16, kMw = 2, kNw = 4, kBlocks = 2;
};
template <>
struct MmaPlan<float, 64, 1> {
  static constexpr int kTile = 40, kKc = 16, kMw = 1, kNw = 4, kBlocks = 2;
};
template <>
struct MmaPlan<float, 128, 0> {
  static constexpr int kTile = 96, kKc = 8, kMw = 2, kNw = 8, kBlocks = 1;
};
template <>
struct MmaPlan<float, 128, 1> {
  static constexpr int kTile = 16, kKc = 8, kMw = 3, kNw = 2, kBlocks = 2;
};

// unit u's dilation, and the halo the later units still need after it
__host__ __device__ constexpr int dil_of(int u) { return u == 0 ? 1 : u == 1 ? 3 : 9; }
__host__ __device__ constexpr int halo_of(int u) { return u == 0 ? 12 : u == 1 ? 9 : 0; }

// m16 tiles of unit u's window
__host__ __device__ constexpr int m_tiles(int tile, int u) { return (tile + 2 * halo_of(u) + 15) / 16; }

// plane rows: every row a unit's m-tiles read, the last tile's padding rows
// included (j_lo + 16 n_mt + d over the units)
__host__ __device__ constexpr int mma_rows(int tile) {
  int rows = tile + 2 * kHalo;
  for (int u = 0; u < 3; ++u) {
    const int r = kHalo - halo_of(u) + 16 * m_tiles(tile, u) + dil_of(u);
    rows = r > rows ? r : rows;
  }
  return rows;
}

template <typename T, int C, int V>
__host__ __device__ constexpr size_t mma_smem_bytes() {
  using P = MmaPlan<T, C, V>;
  return (2 * static_cast<size_t>(mma_rows(P::kTile)) * (C + vec<T>()) +
          2 * 3 * C * (P::kKc + vec<T>())) * sizeof(T);
}

// blocks of this many bytes of shared memory each that fit one SM (228 KB,
// 1 KB of it reserved per block)
__host__ __device__ constexpr int blocks_per_sm(size_t smem_bytes) {
  return static_cast<int>(233472 / (smem_bytes + 1024));
}

// the blocks per SM a plan's __launch_bounds__ promises
template <typename T, int C, int V>
__host__ __device__ constexpr int promised_blocks() {
  return blocks_per_sm(mma_smem_bytes<T, C, V>()) < MmaPlan<T, C, V>::kBlocks
             ? blocks_per_sm(mma_smem_bytes<T, C, V>())
             : MmaPlan<T, C, V>::kBlocks;
}

// Lays the six weights out as wt[unit][tap][o][i], taps 0-2 from wd and
// tap 3 from wp, so that a chunk of input channels is contiguous per row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
relayout_weights_kernel(const T* __restrict__ wd0, const T* __restrict__ wp0,
                        const T* __restrict__ wd1, const T* __restrict__ wp1,
                        const T* __restrict__ wd2, const T* __restrict__ wp2,
                        T* __restrict__ wt, int c) {
  const int cc = c * c;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= 12 * cc) return;
  const int u = e / (4 * cc);
  const int r = e - u * 4 * cc;
  const int tap = r / cc;
  const int oi = r - tap * cc;  // o * c + i
  const T* wd = u == 0 ? wd0 : u == 1 ? wd1 : wd2;
  const T* wp = u == 0 ? wp0 : u == 1 ? wp1 : wp2;
  wt[e] = tap < 3 ? wd[oi * 3 + tap] : wp[oi];
}

// Chunk n of a tile's weight stream into buf ([tap][o][KC + E]): per unit,
// the dilated conv's C / KC chunks of KC input channels (taps 0-2), then the
// pointwise conv's (tap 3, into the tap-0 slot).  One cp.async group.
template <typename T, int C, int KC>
__device__ __forceinline__ void issue_chunk(const T* __restrict__ wt, T* buf, int n) {
  constexpr int E = vec<T>();
  constexpr int kCpc = C / KC;
  constexpr int kPieces = KC / E;  // 16-byte pieces of a row
  const int u = n / (2 * kCpc);
  const int r = n - u * 2 * kCpc;
  const bool point = r >= kCpc;
  const int i0 = (point ? r - kCpc : r) * KC;
  const T* src = wt + static_cast<size_t>(u * 4 + (point ? 3 : 0)) * C * C + i0;
  const int pieces = (point ? 1 : 3) * C * kPieces;
  for (int e = threadIdx.x; e < pieces; e += kThreads) {
    const int row = e / kPieces;  // tap * C + o
    const int p = e - row * kPieces;
    cp_async16(buf + row * (KC + E) + p * E, src + static_cast<size_t>(row) * C + p * E);
  }
  cp_async_commit();
}

// acc[i][nt] += A . B over one step of 32 bytes of K (16 bf16, 8 f32) for
// the warp's MW x NW tiles.  A row m of m-tile mt is plane row a_row0 + 16
// mt + m, columns a_col .. a_col + 2E - 1; B column n of n-tile nt is weight
// row n0 + 8 nt + n of w, columns b_col .. b_col + 2E - 1.  m-tiles from
// n_mt on are skipped (the same for the whole warp).  f32 splits each
// fragment once into TF32 hi and lo and runs three products a tile pair.
template <typename T, int C, int KC, int MW, int NW>
__device__ __forceinline__ void product_step(float (&acc)[MW][NW][4], const T* plane,
                                             int a_row0, int a_col, const T* w, int n0,
                                             int b_col, int mt0, int n_mt) {
  constexpr int E = vec<T>();
  constexpr int S = C + E;
  const int lane = threadIdx.x & 31;
  // ldmatrix.x4 row addresses: A's four 8 x 16-byte matrices are (rows 0-7
  // | 8-15) x (k 0..E-1 | E..2E-1) as a0..a3; B's are n-tile pairs x (k 0..E-1
  // | E..2E-1)
  const int a_r = (lane & 7) + ((lane >> 3) & 1) * 8, a_c = (lane >> 4) * E;
  const int b_r = (lane & 7) + (lane >> 4) * 8, b_c = ((lane >> 3) & 1) * E;
  uint32_t b[NW / 2][4];
#pragma unroll
  for (int p = 0; p < NW / 2; ++p)
    ldmatrix_x4(b[p], w + (n0 + 16 * p + b_r) * (KC + E) + b_col + b_c);
  if constexpr (std::is_same<T, float>::value) {
    uint32_t bh[NW / 2][4], bl[NW / 2][4];
#pragma unroll
    for (int p = 0; p < NW / 2; ++p) split_tf32(b[p], bh[p], bl[p]);
#pragma unroll
    for (int i = 0; i < MW; ++i) {
      const int mt = mt0 + i;
      if (mt < n_mt) {
        uint32_t a[4], ah[4], al[4];
        ldmatrix_x4(a, plane + (a_row0 + 16 * mt + a_r) * S + a_col + a_c);
        split_tf32(a, ah, al);
#pragma unroll
        for (int nt = 0; nt < NW; ++nt) {
          const int p = nt / 2, r = 2 * (nt & 1);
          const uint32_t h[2] = {bh[p][r], bh[p][r + 1]}, l[2] = {bl[p][r], bl[p][r + 1]};
          // a fresh sum a step, added to acc in f32 (see the header)
          float d[4] = {0.f, 0.f, 0.f, 0.f};
          mma_3xtf32(d, ah, al, h, l);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][nt][e] += d[e];
        }
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < MW; ++i) {
      const int mt = mt0 + i;
      if (mt < n_mt) {
        uint32_t a[4];
        ldmatrix_x4(a, plane + (a_row0 + 16 * mt + a_r) * S + a_col + a_c);
#pragma unroll
        for (int nt = 0; nt < NW; ++nt) {
          const uint32_t bb[2] = {b[nt / 2][2 * (nt & 1)], b[nt / 2][2 * (nt & 1) + 1]};
          mma_bf16(acc[i][nt], a, bb);
        }
      }
    }
  }
}

template <typename T, int C, int V>
__global__ void __launch_bounds__(kThreads, (promised_blocks<T, C, V>()))
residual_stack_mma_kernel(const T* __restrict__ x, T* __restrict__ y,
                          const T* __restrict__ wt, int t_len, float slope) {
  using P = MmaPlan<T, C, V>;
  constexpr int TILE = P::kTile, KC = P::kKc, MW = P::kMw, NW = P::kNw;
  constexpr int E = vec<T>();
  constexpr int S = C + E;              // plane row stride
  constexpr int W = TILE + 2 * kHalo;   // rows loaded: row j is time t0 - kHalo + j
  constexpr int kRows = mma_rows(TILE);
  constexpr int kWb = 3 * C * (KC + E);  // one weight buffer
  constexpr int kCpc = C / KC;           // chunks per conv
  constexpr int kChunks = 3 * 2 * kCpc;
  constexpr int kNGroups = C / (8 * NW);  // warps side by side along N
  constexpr int kMWarps = kWarps / kNGroups;
  static_assert(C % KC == 0 && KC % (2 * E) == 0 && NW % 2 == 0, "the tiles must divide C");
  static_assert(kWarps % kNGroups == 0, "the warps must share the n-tiles evenly");
  static_assert(m_tiles(TILE, 0) <= kMWarps * MW, "the warps must cover the widest window");

  extern __shared__ float4 smem4[];
  T* xs = reinterpret_cast<T*>(smem4);  // [kRows][S] unit input, updated in place
  T* hs = xs + kRows * S;               // [kRows][S] h1
  T* wbuf = hs + kRows * S;             // [2][3][C][KC + E] staged weights

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = blockIdx.x * TILE;
  const int g0 = t0 - kHalo;
  const size_t plane = static_cast<size_t>(C) * t_len;
  const T* xb = x + blockIdx.y * plane;
  T* yb = y + blockIdx.y * plane;
  const int n0 = (warp / kMWarps) * NW * 8;  // the warp's first output channel
  const int mt0 = (warp % kMWarps) * MW;     // the warp's first m-tile

  issue_chunk<T, C, KC>(wt, wbuf, 0);
  // unit-0 input with its reflect padding, transposed to time-major (a
  // channel pair a thread); rows further out than the padding only feed
  // outputs that are refilled or never stored
  for (int e = tid; e < (C / 2) * W; e += kThreads) {
    const int cp = e / W;
    const int j = e - cp * W;
    const int g = min(max(reflect(g0 + j, t_len), 0), t_len - 1);
    const size_t at = static_cast<size_t>(2 * cp) * t_len + g;
    store_pair(xs + j * S + 2 * cp, to_f32(xb[at]), to_f32(xb[at + t_len]));
  }

  // the pipeline: chunk n has landed for every thread, chunk n - 1 is
  // consumed, chunk n + 1 is on its way
  int n = 0;
  const auto acquire = [&]() {
    cp_async_wait_committed();
    __syncthreads();
    if (n + 1 < kChunks) issue_chunk<T, C, KC>(wt, wbuf + ((n + 1) & 1) * kWb, n + 1);
    return wbuf + (n & 1) * kWb;
  };

  float acc[MW][NW][4];
  const int g = lane >> 2, q = lane & 3;

#pragma unroll 1
  for (int u = 0; u < 3; ++u) {
    const int d = dil_of(u);
    const int h = halo_of(u);
    const int j_lo = kHalo - h;
    const int R = TILE + 2 * h;
    const int n_mt = m_tiles(TILE, u);

    // ---- h1 = dilated conv (k = 3, dilation d) over the window ----
#pragma unroll
    for (int i = 0; i < MW; ++i)
#pragma unroll
      for (int nt = 0; nt < NW; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][nt][e] = 0.f;
    for (int kc = 0; kc < kCpc; ++kc, ++n) {
      const T* wb = acquire();
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int ks = 0; ks < KC; ks += 2 * E)
          product_step<T, C, KC, MW, NW>(acc, xs, j_lo + (k - 1) * d, kc * KC + ks,
                                         wb + k * C * (KC + E), n0, ks, mt0, n_mt);
    }
#pragma unroll
    for (int i = 0; i < MW; ++i) {
      if (mt0 + i >= n_mt) continue;
      const int j = j_lo + 16 * (mt0 + i) + g;
#pragma unroll
      for (int nt = 0; nt < NW; ++nt) {
        const int o = n0 + 8 * nt + 2 * q;
        store_pair(hs + j * S + o, acc[i][nt][0], acc[i][nt][1]);
        store_pair(hs + (j + 8) * S + o, acc[i][nt][2], acc[i][nt][3]);
      }
    }

    // ---- x += leaky(Wp . h1) ----
#pragma unroll
    for (int i = 0; i < MW; ++i)
#pragma unroll
      for (int nt = 0; nt < NW; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][nt][e] = 0.f;
    for (int kc = 0; kc < kCpc; ++kc, ++n) {
      const T* wb = acquire();
#pragma unroll
      for (int ks = 0; ks < KC; ks += 2 * E)
        product_step<T, C, KC, MW, NW>(acc, hs, j_lo, kc * KC + ks, wb, n0, ks, mt0, n_mt);
    }
    // only this lane reads or writes its (row, channel pair) cells of xs here
#pragma unroll
    for (int i = 0; i < MW; ++i) {
      if (mt0 + i >= n_mt) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = j_lo + 16 * (mt0 + i) + g + 8 * half;
        if (j >= j_lo + R) continue;
#pragma unroll
        for (int nt = 0; nt < NW; ++nt) {
          T* cell = xs + j * S + n0 + 8 * nt + 2 * q;
          const float2 old = load_pair(cell);
          const float v0 = acc[i][nt][2 * half], v1 = acc[i][nt][2 * half + 1];
          const float a0 = round_to<T>(v0 >= 0.f ? v0 : slope * v0);
          const float a1 = round_to<T>(v1 >= 0.f ? v1 : slope * v1);
          store_pair(cell, old.x + a0, old.y + a1);
        }
      }
    }

    // ---- reflect-pad the unit's output for the next unit, by rows ----
    // Sources are clamped into the in-range part of this window; the rows
    // the next unit really reads (within d of the edge) reflect exactly.
    // The next acquire's barrier orders these copies before their readers.
    if (u < 2 && (t0 - h < 0 || t0 + TILE + h > t_len)) {
      __syncthreads();
      const int lo = max(0, t0 - h);
      const int hi = min(t_len - 1, t0 + TILE + h - 1);
      constexpr int kVec = C / E;  // 16-byte pieces of a row
      for (int e = tid; e < R * kVec; e += kThreads) {
        const int j = j_lo + e / kVec;
        const int v = e % kVec;
        const int gt = g0 + j;
        if (gt >= 0 && gt < t_len) continue;
        const int s = min(max(reflect(gt, t_len), lo), hi);
        reinterpret_cast<uint4*>(xs + j * S)[v] = reinterpret_cast<const uint4*>(xs + (s - g0) * S)[v];
      }
    }
  }
  __syncthreads();

  for (int e = tid; e < (C / 2) * TILE; e += kThreads) {
    const int cp = e / TILE;
    const int j = e - cp * TILE;
    const int gt = t0 + j;
    if (gt < t_len) {
      const float2 v = load_pair(xs + (kHalo + j) * S + 2 * cp);
      const size_t at = static_cast<size_t>(2 * cp) * t_len + gt;
      yb[at] = from_f32<T>(v.x);
      yb[at + t_len] = from_f32<T>(v.y);
    }
  }
}

// The plan variant for a shape: f32 takes its second, smaller tile where
// the first would give fewer blocks than the card has SMs.
template <typename T, int C>
cudaError_t pick_variant(int batch, int t_len, int* v) {
  *v = 0;
  if constexpr (variants<T>() > 1) {
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    constexpr int TILE = MmaPlan<T, C, 0>::kTile;
    if (static_cast<long long>(batch) * ((t_len + TILE - 1) / TILE) < sms) *v = 1;
  }
  return cudaSuccess;
}

template <typename T, int C, int V>
cudaError_t launch_stack(const void* x, void* y, const void* wt, int batch, int t_len, float slope,
                         cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<T, C, V>();
  auto kern = residual_stack_mma_kernel<T, C, V>;
  // the attribute is per function and device; setting it on every call keeps
  // the launcher stateless for one cheap host call per launch
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  constexpr int TILE = MmaPlan<T, C, V>::kTile;
  const dim3 grid((t_len + TILE - 1) / TILE, batch);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x), static_cast<T*>(y),
                                         static_cast<const T*>(wt), t_len, slope);
  return cudaGetLastError();
}

template <typename T, int C>
cudaError_t launch_mma(const void* x, void* y, const void* const* w, void* wt, int batch,
                       int t_len, float slope, cudaStream_t stream) {
  int v = 0;
  cudaError_t err = pick_variant<T, C>(batch, t_len, &v);
  if (err != cudaSuccess) return err;
  const int n = 12 * C * C;
  relayout_weights_kernel<T><<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      static_cast<const T*>(w[0]), static_cast<const T*>(w[1]), static_cast<const T*>(w[2]),
      static_cast<const T*>(w[3]), static_cast<const T*>(w[4]), static_cast<const T*>(w[5]),
      static_cast<T*>(wt), C);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if constexpr (variants<T>() > 1) {
    if (v == 1) return launch_stack<T, C, 1>(x, y, wt, batch, t_len, slope, stream);
  }
  return launch_stack<T, C, 0>(x, y, wt, batch, t_len, slope, stream);
}

// out: TILE, grid x, grid y, blocks per SM (occupancy), dynamic shared
// memory bytes, registers per thread, local (spill) bytes per thread
template <typename T, int C, int V>
cudaError_t describe(int batch, int t_len, int* out) {
  constexpr size_t smem = mma_smem_bytes<T, C, V>();
  constexpr int tile = MmaPlan<T, C, V>::kTile;
  auto kern = residual_stack_mma_kernel<T, C, V>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return err;
  const int vals[7] = {tile, (t_len + tile - 1) / tile, batch, per_sm, static_cast<int>(smem),
                       attr.numRegs, static_cast<int>(attr.localSizeBytes)};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return cudaSuccess;
}

template <typename T, int C>
cudaError_t config_of(int batch, int t_len, int* out) {
  int v = 0;
  cudaError_t err = pick_variant<T, C>(batch, t_len, &v);
  if (err != cudaSuccess) return err;
  if constexpr (variants<T>() > 1) {
    if (v == 1) return describe<T, C, 1>(batch, t_len, out);
  }
  return describe<T, C, 0>(batch, t_len, out);
}

template <int C>
cudaError_t run(int dtype, const void* x, void* y, const void* const* w, void* wt, int batch,
                int t_len, float slope, cudaStream_t stream) {
  if (dtype == 0) return launch_mma<float, C>(x, y, w, wt, batch, t_len, slope, stream);
  if (dtype == 1) return launch_mma<bf16, C>(x, y, w, wt, batch, t_len, slope, stream);
  return cudaErrorInvalidValue;
}

template <int C>
cudaError_t config(int dtype, int batch, int t_len, int* out) {
  if (dtype == 0) return config_of<float, C>(batch, t_len, out);
  if (dtype == 1) return config_of<bf16, C>(batch, t_len, out);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x, y: (batch, channels, t_len) contiguous; wd*: (channels, channels, 3) and
// wp*: (channels, channels, 1) contiguous, all of one type: dtype 0 = float32,
// 1 = bfloat16.  wt: scratch of 12 channels^2 elements of that type.
// Launches on `stream`; returns the cudaError_t of the launches.
int vx_residual_stack(const void* x, void* y, const void* wd0, const void* wp0,
                      const void* wd1, const void* wp1, const void* wd2, const void* wp2,
                      void* wt, int batch, int channels, int t_len, int dtype, float slope,
                      int device, void* stream) {
  if (batch < 1 || batch > 65535 || t_len < 10) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const void* const w[6] = {wd0, wp0, wd1, wp1, wd2, wp2};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (channels) {
    case 32: return run<32>(dtype, x, y, w, wt, batch, t_len, slope, s);
    case 64: return run<64>(dtype, x, y, w, wt, batch, t_len, slope, s);
    case 128: return run<128>(dtype, x, y, w, wt, batch, t_len, slope, s);
    default: return cudaErrorInvalidValue;
  }
}

// The launch configuration of the main kernel for a shape, into out[7]:
// TILE, grid x, grid y, blocks per SM, dynamic shared memory bytes,
// registers per thread, local (spill) bytes per thread.
int vx_residual_stack_config(int batch, int channels, int t_len, int dtype, int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  switch (channels) {
    case 32: return config<32>(dtype, batch, t_len, out);
    case 64: return config<64>(dtype, batch, t_len, out);
    case 128: return config<128>(dtype, batch, t_len, out);
    default: return cudaErrorInvalidValue;
  }
}

const char* vx_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
