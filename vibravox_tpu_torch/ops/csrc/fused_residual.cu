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
// Both types share the tiling.  One block per (batch element, time tile), so
// batch seams never mix.  The block loads its tile plus a 13-sample halo per
// side (1 + 3 + 9) into shared memory once, runs the three units there and
// stores the tile once: device memory sees one read of x, one write of y,
// and the weights (from L2).  Each unit is two small matrix products over
// the shrinking window:
//     h1 (C x R) = sum_k Wd[:, :, k] . x[:, j + (k-1) d]       R = TILE + 2 h
//     x[:, j]   += leaky(Wp . h1[:, j])                       (in place)
// where h is the halo still needed by the later units (12, 9, 0).  After a
// unit, the window positions outside [0, T) are refilled by reflecting the
// unit's output, so the next unit sees its own reflect padding.
//
// float32 (residual_stack_kernel): f32 FMAs on the CUDA cores, since its
// results must match the plain path to 2e-5 of scale, which TF32 or bf16
// tensor cores cannot.  Planes [C][W] in f32; weights staged in chunks of
// kIc input channels, transposed so that a thread reads its kOcb output
// channels as two float4; every thread owns one kOcb x kPb micro-tile.
//
// bfloat16 (residual_stack_mma_kernel): the products on the tensor cores,
// mma.sync m16n8k16 with bf16 operands and f32 sums.  M is the window's
// time rows, N the output channels, K the input channels; the dilated conv
// is three K passes, one per tap, each shifting A's rows by (k-1) d.
//   - Planes are time-major bf16, [row][C + 8]: row j is time t0 - 13 + j
//     with its C channels contiguous.  The 8-element pad makes the row
//     stride 80 / 144 / 272 bytes, so the 8 rows of an ldmatrix phase fall
//     in 8 distinct 16-byte bank groups, and a dilation shift moves whole
//     rows, so every row address stays 16-byte aligned.  Global memory stays
//     NCW: the load and the store transpose through registers.
//   - A fragments come from xs (x) or hs (h1) by ldmatrix.x4; B fragments
//     from the staged weights [tap][o][i + 8] by ldmatrix.x4.  A helper
//     launch first lays the six weights out as [unit][tap 0-2, 3 = Wp][o][i]
//     in a scratch buffer, so each chunk of KC input channels streams in
//     with 16-byte cp.async, double-buffered: chunk n + 1 copies while
//     chunk n multiplies, one barrier per chunk.
//   - Every operand is a bf16 value and the C fragment's pairs (one time
//     row, two adjacent output channels) leave as single bf16x2 stores:
//     h1 rounded to bf16; leaky, rounded to bf16, added to xs in place and
//     rounded to bf16.  These are the TPU kernel's rounding points; only
//     the f32 summation order differs from an FMA loop.
//   - The 8 warps split each unit's (16-row m-tile, 8-channel n-tile)
//     pairs, MW x NW a warp, in every unit.  TILE is set per C so that the
//     recomputed halo (rounded up to whole m-tiles) is 8-18% of the owned
//     work, and __launch_bounds__ keeps the blocks that shared memory
//     allows (3 / 2 / 2 at C = 32 / 64 / 128).
// tests/test_torch_residual_fwd_mma.py emulates this walk in float64.
//
// Bound on this card: 24 C^2 T B FLOP against 2 C T B elements moved (x in,
// y out).  f32: 3C FLOP/byte against the f32 ridge of 67 TFLOP/s over
// 3.35 TB/s = 20, so arithmetic bounds it.  bf16: 6C FLOP/byte against the
// bf16 tensor-core ridge of 295, so bytes bound it at C = 32 and
// operations at C = 64 and 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kHalo = 13;  // 1 + 3 + 9: receptive radius of the three units
constexpr int kOcb = 8;    // output channels per thread
constexpr int kPb = 4;     // time positions per thread
constexpr int kIc = 16;    // input channels per staged weight chunk
constexpr int kWsPad = 4;  // keeps float4 alignment, spreads staging stores over banks

template <int C, int TILE>
constexpr size_t smem_floats() {
  return 2 * C * (TILE + 2 * kHalo) + kIc * 3 * (C + kWsPad);
}

template <int C, int TILE>
__global__ void __launch_bounds__(kThreads)
residual_stack_kernel(const float* __restrict__ x, float* __restrict__ y,
                      const float* __restrict__ wd0, const float* __restrict__ wp0,
                      const float* __restrict__ wd1, const float* __restrict__ wp1,
                      const float* __restrict__ wd2, const float* __restrict__ wp2,
                      int t_len, float slope) {
  constexpr int W = TILE + 2 * kHalo;  // window columns; column j is time t0 - kHalo + j
  constexpr int kWs = C + kWsPad;      // row stride of the staged weights
  constexpr int kGroups = C / kOcb;
  static_assert(C % kOcb == 0 && C % kIc == 0, "channel count must divide the tiles");
  static_assert(kGroups * ((TILE + 2 * 12 + kPb - 1) / kPb) <= kThreads,
                "every micro-tile of the widest window needs its own thread");

  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [C][W] unit input, updated in place
  float* hs = xs + C * W;                       // [C][W] dilated-conv output h1
  float* ws = hs + C * W;                       // [kIc * 3][kWs] staged weights, o fastest

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * TILE;
  const int g0 = t0 - kHalo;
  const size_t plane = static_cast<size_t>(C) * t_len;
  const float* xb = x + blockIdx.y * plane;
  float* yb = y + blockIdx.y * plane;

  // unit-0 input with its reflect padding; columns further out than the
  // padding only feed outputs that are refilled or never stored
  for (int e = tid; e < C * W; e += kThreads) {
    const int c = e / W;
    const int j = e - c * W;
    const int g = min(max(reflect(g0 + j, t_len), 0), t_len - 1);
    xs[e] = xb[static_cast<size_t>(c) * t_len + g];
  }

  const float* const wds[3] = {wd0, wd1, wd2};
  const float* const wps[3] = {wp0, wp1, wp2};
  const int dils[3] = {1, 3, 9};
  const int halos[3] = {12, 9, 0};  // halo the later units still need

#pragma unroll 1
  for (int u = 0; u < 3; ++u) {
    const int d = dils[u];
    const int h = halos[u];
    const int j_lo = kHalo - h;
    const int R = TILE + 2 * h;
    const int npg = (R + kPb - 1) / kPb;
    const bool active = tid < kGroups * npg;
    const int og = tid / npg;
    const int pg = tid - og * npg;
    const int o0 = og * kOcb;
    int col[kPb];
    bool valid[kPb];
#pragma unroll
    for (int q = 0; q < kPb; ++q) {
      const int p = pg + q * npg;
      valid[q] = active && p < R;
      col[q] = j_lo + min(p, R - 1);
    }

    float acc[kOcb][kPb];
#pragma unroll
    for (int a = 0; a < kOcb; ++a)
#pragma unroll
      for (int q = 0; q < kPb; ++q) acc[a][q] = 0.f;

    // ---- h1 = dilated conv (k = 3, dilation d) over the window ----
    const float* wd = wds[u];
    for (int i0 = 0; i0 < C; i0 += kIc) {
      __syncthreads();  // xs ready; previous chunk consumed
      for (int e = tid; e < C * kIc * 3; e += kThreads) {
        const int o = e / (kIc * 3);
        const int r = e - o * (kIc * 3);  // r = ii * 3 + k
        ws[r * kWs + o] = wd[static_cast<size_t>(o) * C * 3 + i0 * 3 + r];
      }
      __syncthreads();
      if (active) {
#pragma unroll 2
        for (int ii = 0; ii < kIc; ++ii) {
          const float* xr = xs + (i0 + ii) * W;
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const int sh = (k - 1) * d;
            float xv[kPb];
#pragma unroll
            for (int q = 0; q < kPb; ++q) xv[q] = xr[col[q] + sh];
            const float4* wr = reinterpret_cast<const float4*>(ws + (ii * 3 + k) * kWs + o0);
            const float4 wa = wr[0];
            const float4 wb = wr[1];
            const float wv[kOcb] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
            for (int a = 0; a < kOcb; ++a)
#pragma unroll
              for (int q = 0; q < kPb; ++q) acc[a][q] = fmaf(wv[a], xv[q], acc[a][q]);
          }
        }
      }
    }
#pragma unroll
    for (int a = 0; a < kOcb; ++a)
#pragma unroll
      for (int q = 0; q < kPb; ++q) {
        if (valid[q]) hs[(o0 + a) * W + col[q]] = acc[a][q];
        acc[a][q] = 0.f;
      }

    // ---- x += leaky(Wp . h1) ----
    const float* wp = wps[u];
    for (int i0 = 0; i0 < C; i0 += kIc) {
      __syncthreads();  // hs complete; previous chunk consumed
      for (int e = tid; e < C * kIc; e += kThreads) {
        const int o = e / kIc;
        const int ii = e - o * kIc;
        ws[ii * kWs + o] = wp[static_cast<size_t>(o) * C + i0 + ii];
      }
      __syncthreads();
      if (active) {
#pragma unroll 4
        for (int ii = 0; ii < kIc; ++ii) {
          const float* hr = hs + (i0 + ii) * W;
          float hv[kPb];
#pragma unroll
          for (int q = 0; q < kPb; ++q) hv[q] = hr[col[q]];
          const float4* wr = reinterpret_cast<const float4*>(ws + ii * kWs + o0);
          const float4 wa = wr[0];
          const float4 wb = wr[1];
          const float wv[kOcb] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int a = 0; a < kOcb; ++a)
#pragma unroll
            for (int q = 0; q < kPb; ++q) acc[a][q] = fmaf(wv[a], hv[q], acc[a][q]);
        }
      }
    }
    // only this thread reads or writes its (channel, column) cells of xs here
#pragma unroll
    for (int a = 0; a < kOcb; ++a)
#pragma unroll
      for (int q = 0; q < kPb; ++q) {
        if (!valid[q]) continue;
        float* cell = xs + (o0 + a) * W + col[q];
        const float v = acc[a][q];
        const float act = v >= 0.f ? v : slope * v;
        *cell = *cell + act;
      }
    __syncthreads();

    // ---- reflect-pad the unit's output for the next unit ----
    // Sources are clamped into the in-range part of this window; the cells the
    // next unit really reads (within d of the edge) reflect exactly.
    if (u < 2 && (t0 - h < 0 || t0 + TILE + h > t_len)) {
      const int lo = max(0, t0 - h);
      const int hi = min(t_len - 1, t0 + TILE + h - 1);
      for (int e = tid; e < C * R; e += kThreads) {
        const int c = e / R;
        const int j = j_lo + (e - c * R);
        const int g = g0 + j;
        if (g >= 0 && g < t_len) continue;
        const int s = min(max(reflect(g, t_len), lo), hi);
        xs[c * W + j] = xs[c * W + (s - g0)];
      }
    }
  }
  __syncthreads();

  for (int e = tid; e < C * TILE; e += kThreads) {
    const int c = e / TILE;
    const int j = e - c * TILE;
    const int g = t0 + j;
    if (g < t_len) yb[static_cast<size_t>(c) * t_len + g] = xs[c * W + kHalo + j];
  }
}

template <int C, int TILE>
cudaError_t launch(const void* x, void* y, const void* const* w, int batch, int t_len,
                   float slope, cudaStream_t stream) {
  const size_t smem = smem_floats<C, TILE>() * sizeof(float);
  auto kern = residual_stack_kernel<C, TILE>;
  // the attribute is per function and device; setting it on every call keeps
  // the launcher stateless for one cheap host call per launch
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((t_len + TILE - 1) / TILE, batch);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<float*>(y), static_cast<const float*>(w[0]),
      static_cast<const float*>(w[1]), static_cast<const float*>(w[2]), static_cast<const float*>(w[3]),
      static_cast<const float*>(w[4]), static_cast<const float*>(w[5]), t_len, slope);
  return cudaGetLastError();
}

// ---- bf16: the tensor-core kernel ------------------------------------------

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

constexpr int kWarps = kThreads / 32;
constexpr int kApad = 8;  // bf16 pad of every plane and weight row: 16 bytes

// Per channel count: TILE, KC (input channels per staged weight chunk), and
// a warp's MW m16 tiles (time rows) by NW n8 tiles (output channels).
template <int C>
struct MmaPlan;
template <>
struct MmaPlan<32> {
  static constexpr int kTile = 232, kKc = 32, kMw = 2, kNw = 4;
};
template <>
struct MmaPlan<64> {
  static constexpr int kTile = 232, kKc = 32, kMw = 2, kNw = 8;
};
template <>
struct MmaPlan<128> {
  static constexpr int kTile = 104, kKc = 16, kMw = 2, kNw = 8;
};

// unit u's dilation, and the halo the later units still need after it
__host__ __device__ constexpr int dil_of(int u) { return u == 0 ? 1 : u == 1 ? 3 : 9; }
__host__ __device__ constexpr int halo_of(int u) { return u == 0 ? 12 : u == 1 ? 9 : 0; }

// m16 tiles of unit u's window
__host__ __device__ constexpr int m_tiles(int tile, int u) { return (tile + 2 * halo_of(u) + 15) / 16; }

// plane rows: every row a unit's m-tiles read, the last tile's padding rows
// included (j_lo + 16 n_mt + d over the units)
template <int C>
__host__ __device__ constexpr int mma_rows() {
  int rows = MmaPlan<C>::kTile + 2 * kHalo;
  for (int u = 0; u < 3; ++u) {
    const int r = kHalo - halo_of(u) + 16 * m_tiles(MmaPlan<C>::kTile, u) + dil_of(u);
    rows = r > rows ? r : rows;
  }
  return rows;
}

template <int C>
__host__ __device__ constexpr size_t mma_smem_bytes() {
  return (2 * static_cast<size_t>(mma_rows<C>()) * (C + kApad) +
          2 * 3 * C * (MmaPlan<C>::kKc + kApad)) * sizeof(bf16);
}

// blocks of this many bytes of shared memory each that fit one SM (228 KB,
// 1 KB of it reserved per block)
__host__ __device__ constexpr int blocks_per_sm(size_t smem_bytes) {
  return static_cast<int>(233472 / (smem_bytes + 1024));
}

// Lays the six weights out as wt[unit][tap][o][i], taps 0-2 from wd and
// tap 3 from wp, so that a chunk of input channels is contiguous per row.
__global__ void __launch_bounds__(kThreads)
relayout_weights_kernel(const bf16* __restrict__ wd0, const bf16* __restrict__ wp0,
                        const bf16* __restrict__ wd1, const bf16* __restrict__ wp1,
                        const bf16* __restrict__ wd2, const bf16* __restrict__ wp2,
                        bf16* __restrict__ wt, int c) {
  const int cc = c * c;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= 12 * cc) return;
  const int u = e / (4 * cc);
  const int r = e - u * 4 * cc;
  const int tap = r / cc;
  const int oi = r - tap * cc;  // o * c + i
  const bf16* wd = u == 0 ? wd0 : u == 1 ? wd1 : wd2;
  const bf16* wp = u == 0 ? wp0 : u == 1 ? wp1 : wp2;
  wt[e] = tap < 3 ? wd[oi * 3 + tap] : wp[oi];
}

// Chunk n of a tile's weight stream into buf ([tap][o][KC + 8]): per unit,
// the dilated conv's C / KC chunks of KC input channels (taps 0-2), then the
// pointwise conv's (tap 3, into the tap-0 slot).  One cp.async group.
template <int C, int KC>
__device__ __forceinline__ void issue_chunk(const bf16* __restrict__ wt, bf16* buf, int n) {
  constexpr int kCpc = C / KC;
  constexpr int kPieces = KC / 8;  // 16-byte pieces of a row
  const int u = n / (2 * kCpc);
  const int r = n - u * 2 * kCpc;
  const bool point = r >= kCpc;
  const int i0 = (point ? r - kCpc : r) * KC;
  const bf16* src = wt + static_cast<size_t>(u * 4 + (point ? 3 : 0)) * C * C + i0;
  const int pieces = (point ? 1 : 3) * C * kPieces;
  for (int e = threadIdx.x; e < pieces; e += kThreads) {
    const int row = e / kPieces;  // tap * C + o
    const int p = e - row * kPieces;
    cp_async16(buf + row * (KC + kApad) + p * 8, src + static_cast<size_t>(row) * C + p * 8);
  }
  cp_async_commit();
}

// acc[i][nt] += A . B over one k16 step for the warp's MW x NW tiles.
// A row m of m-tile mt is plane row a_row0 + 16 mt + m, columns a_col ..
// a_col + 15; B column n of n-tile nt is weight row n0 + 8 nt + n of w,
// columns b_col .. b_col + 15.  m-tiles from n_mt on are skipped (the same
// for the whole warp).
template <int C, int KC, int MW, int NW>
__device__ __forceinline__ void product_step(float (&acc)[MW][NW][4], const bf16* plane,
                                             int a_row0, int a_col, const bf16* w, int n0,
                                             int b_col, int mt0, int n_mt) {
  constexpr int S = C + kApad;
  const int lane = threadIdx.x & 31;
  // ldmatrix.x4 row addresses: A's four 8 x 8 matrices are (rows 0-7 | 8-15)
  // x (k 0-7 | 8-15) as a0..a3; B's are n-tile pairs x (k 0-7 | 8-15)
  const int a_r = (lane & 7) + ((lane >> 3) & 1) * 8, a_c = (lane >> 4) * 8;
  const int b_r = (lane & 7) + (lane >> 4) * 8, b_c = ((lane >> 3) & 1) * 8;
  uint32_t b[NW / 2][4];
#pragma unroll
  for (int p = 0; p < NW / 2; ++p)
    ldmatrix_x4(b[p], w + (n0 + 16 * p + b_r) * (KC + kApad) + b_col + b_c);
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

template <int C>
__global__ void __launch_bounds__(kThreads, blocks_per_sm(mma_smem_bytes<C>()))
residual_stack_mma_kernel(const bf16* __restrict__ x, bf16* __restrict__ y,
                          const bf16* __restrict__ wt, int t_len, float slope) {
  using P = MmaPlan<C>;
  constexpr int TILE = P::kTile, KC = P::kKc, MW = P::kMw, NW = P::kNw;
  constexpr int S = C + kApad;          // plane row stride
  constexpr int W = TILE + 2 * kHalo;   // rows loaded: row j is time t0 - kHalo + j
  constexpr int kRows = mma_rows<C>();
  constexpr int kWb = 3 * C * (KC + kApad);  // one weight buffer
  constexpr int kCpc = C / KC;               // chunks per conv
  constexpr int kChunks = 3 * 2 * kCpc;
  constexpr int kNGroups = C / (8 * NW);     // warps side by side along N
  constexpr int kMWarps = kWarps / kNGroups;
  static_assert(C % KC == 0 && KC % 16 == 0 && NW % 2 == 0, "the tiles must divide C");
  static_assert(kWarps % kNGroups == 0, "the warps must share the n-tiles evenly");
  static_assert(m_tiles(TILE, 0) <= kMWarps * MW, "the warps must cover the widest window");

  extern __shared__ float4 smem4[];
  bf16* xs = reinterpret_cast<bf16*>(smem4);  // [kRows][S] unit input, updated in place
  bf16* hs = xs + kRows * S;                  // [kRows][S] h1
  bf16* wbuf = hs + kRows * S;                // [2][3][C][KC + 8] staged weights

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = blockIdx.x * TILE;
  const int g0 = t0 - kHalo;
  const size_t plane = static_cast<size_t>(C) * t_len;
  const bf16* xb = x + blockIdx.y * plane;
  bf16* yb = y + blockIdx.y * plane;
  const int n0 = (warp / kMWarps) * NW * 8;  // the warp's first output channel
  const int mt0 = (warp % kMWarps) * MW;     // the warp's first m-tile

  issue_chunk<C, KC>(wt, wbuf, 0);
  // unit-0 input with its reflect padding, transposed to time-major; rows
  // further out than the padding only feed outputs that are refilled or
  // never stored
  for (int e = tid; e < (C / 2) * W; e += kThreads) {
    const int cp = e / W;
    const int j = e - cp * W;
    const int g = min(max(reflect(g0 + j, t_len), 0), t_len - 1);
    const size_t at = static_cast<size_t>(2 * cp) * t_len + g;
    bf162 v;
    v.x = xb[at];
    v.y = xb[at + t_len];
    *reinterpret_cast<bf162*>(xs + j * S + 2 * cp) = v;
  }

  // the pipeline: chunk n has landed for every thread, chunk n - 1 is
  // consumed, chunk n + 1 is on its way
  int n = 0;
  const auto acquire = [&]() {
    cp_async_wait_committed();
    __syncthreads();
    if (n + 1 < kChunks) issue_chunk<C, KC>(wt, wbuf + ((n + 1) & 1) * kWb, n + 1);
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
      const bf16* wb = acquire();
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int ks = 0; ks < KC; ks += 16)
          product_step<C, KC, MW, NW>(acc, xs, j_lo + (k - 1) * d, kc * KC + ks,
                                      wb + k * C * (KC + kApad), n0, ks, mt0, n_mt);
    }
#pragma unroll
    for (int i = 0; i < MW; ++i) {
      if (mt0 + i >= n_mt) continue;
      const int j = j_lo + 16 * (mt0 + i) + g;
#pragma unroll
      for (int nt = 0; nt < NW; ++nt) {
        const int o = n0 + 8 * nt + 2 * q;
        *reinterpret_cast<bf162*>(hs + j * S + o) = __floats2bfloat162_rn(acc[i][nt][0], acc[i][nt][1]);
        *reinterpret_cast<bf162*>(hs + (j + 8) * S + o) =
            __floats2bfloat162_rn(acc[i][nt][2], acc[i][nt][3]);
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
      const bf16* wb = acquire();
#pragma unroll
      for (int ks = 0; ks < KC; ks += 16)
        product_step<C, KC, MW, NW>(acc, hs, j_lo, kc * KC + ks, wb, n0, ks, mt0, n_mt);
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
          bf162* cell = reinterpret_cast<bf162*>(xs + j * S + n0 + 8 * nt + 2 * q);
          const float2 old = __bfloat1622float2(*cell);
          const float v0 = acc[i][nt][2 * half], v1 = acc[i][nt][2 * half + 1];
          const float a0 = round_to<bf16>(v0 >= 0.f ? v0 : slope * v0);
          const float a1 = round_to<bf16>(v1 >= 0.f ? v1 : slope * v1);
          *cell = __floats2bfloat162_rn(old.x + a0, old.y + a1);
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
      constexpr int kVec = C / 8;  // 16-byte pieces of a row
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
      const bf162 v = *reinterpret_cast<const bf162*>(xs + (kHalo + j) * S + 2 * cp);
      const size_t at = static_cast<size_t>(2 * cp) * t_len + gt;
      yb[at] = v.x;
      yb[at + t_len] = v.y;
    }
  }
}

template <int C>
cudaError_t launch_mma(const void* x, void* y, const void* const* w, void* wt, int batch,
                       int t_len, float slope, cudaStream_t stream) {
  const int n = 12 * C * C;
  relayout_weights_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      static_cast<const bf16*>(w[0]), static_cast<const bf16*>(w[1]),
      static_cast<const bf16*>(w[2]), static_cast<const bf16*>(w[3]),
      static_cast<const bf16*>(w[4]), static_cast<const bf16*>(w[5]), static_cast<bf16*>(wt), C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr size_t smem = mma_smem_bytes<C>();
  auto kern = residual_stack_mma_kernel<C>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  constexpr int TILE = MmaPlan<C>::kTile;
  const dim3 grid((t_len + TILE - 1) / TILE, batch);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const bf16*>(x), static_cast<bf16*>(y),
                                         static_cast<const bf16*>(wt), t_len, slope);
  return cudaGetLastError();
}

// out: TILE, grid x, grid y, blocks per SM (occupancy), dynamic shared
// memory bytes, registers per thread, local (spill) bytes per thread
template <typename Kern>
cudaError_t describe(Kern kern, int tile, size_t smem, int batch, int t_len, int* out) {
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

// float32 TILE per channel count: the largest tile whose widest window
// still gives every micro-tile its own thread (see the static_assert above)
template <int C>
constexpr int f32_tile() { return C == 32 ? 128 : C == 64 ? 64 : 32; }

template <int C>
cudaError_t run(int dtype, const void* x, void* y, const void* const* w, void* wt, int batch,
                int t_len, float slope, cudaStream_t stream) {
  if (dtype == 0) return launch<C, f32_tile<C>()>(x, y, w, batch, t_len, slope, stream);
  if (dtype == 1) return launch_mma<C>(x, y, w, wt, batch, t_len, slope, stream);
  return cudaErrorInvalidValue;
}

template <int C>
cudaError_t config(int dtype, int batch, int t_len, int* out) {
  if (dtype == 0) {
    constexpr int TILE = f32_tile<C>();
    return describe(residual_stack_kernel<C, TILE>, TILE,
                    smem_floats<C, TILE>() * sizeof(float), batch, t_len, out);
  }
  if (dtype == 1)
    return describe(residual_stack_mma_kernel<C>, MmaPlan<C>::kTile, mma_smem_bytes<C>(), batch,
                    t_len, out);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x, y: (batch, channels, t_len) contiguous; wd*: (channels, channels, 3) and
// wp*: (channels, channels, 1) contiguous, all of one type: dtype 0 = float32,
// 1 = bfloat16.  wt: scratch of 12 channels^2 elements of that type (bf16
// only; float32 ignores it).  Launches on `stream`; returns the cudaError_t
// of the launches.
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
