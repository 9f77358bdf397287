// K2: backward of the fused EBEN residual stack, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel vibravox_tpu/ops/fused_residual.py::_bwd_kernel
// (launched by _pallas_backward, wired by the _fused_interior custom_vjp).  The
// forward (K1, fused_residual.cu) is, per unit u with dilation d = 1, 3, 9,
//
//     h1 = Wd * reflect_pad_d(x_u)          (k = 3, dilation d)
//     h2 = Wp . h1
//     x_{u+1} = x_u + leaky(h2)
//
// and this file computes, given g = dL/dx_3, dx_0 and the six weight gradients.
// Per unit, in reverse order, with G the cotangent of the unit's output:
//
//     dh2 = G * leaky'(h2)
//     dWp[o, i]    = sum_t dh2[o, t] h1[i, t]
//     dh1[i, t]    = sum_o Wp[o, i] dh2[o, t]
//     dWd[o, i, k] = sum_t dh1[o, t] x_u[i, refl(t + (k-1) d)]
//     dx_u[i, s]   = G[i, s] + sum_{o,k} Wd[o, i, k] sum_{t: refl(t+(k-1)d) = s} dh1[o, t]
//
// The reflect pad is transposed exactly: a tap that read the mirror of s sends
// its cotangent back to s.  For s in [1, d] that is the k = 0 tap of t = d - s,
// for s in [T-1-d, T-2] the k = 2 tap of t = 2(T-1) - s - d; every other
// position is reached by t = s - (k-1) d inside [0, T) only.
//
// Design.  The TPU kernel recomputed x1, x2 in a 32-row halo and ran the three
// units in one VMEM tile.  At C = 128 the six (C, T) planes that needs do not
// fit a block's 227 KB, so here every unit is its own pass over device memory:
//   1. unit_forward twice: x1, x2 recomputed from x (K1's arithmetic and bf16
//      rounding), stored in x's type;
//   2. unit_backward for u = 2, 1, 0: a block loads its tile of x_u with a
//      2d-sample halo (reflect-padded) and of G with a d-sample halo, and in
//      shared memory recomputes h1 and h2, forms dh2 and dh1, adds its owned
//      rows' dW products to a block-private float32 partial, and writes dx_u
//      for its owned rows (float32 between units, x's type at the end);
//   3. reduce_partials after each unit: dW = the sum of the partials in block
//      order.  No float atomics anywhere, so dW is bit-equal from run to run
//      on one card.
// The unit_backward grid is persistent: as many blocks as fit the card at
// once, each looping over tiles (batch row, time tile) in a fixed order, so
// the partials are (blocks x 4 C^2) floats, 4-35 MB at C = 32-128.
// Weights are staged through shared memory in chunks of kIc reduction
// channels as in K1; every product accumulates in f32 with FMAs.
//
// Bound on this card: about 72 C^2 T B FLOP per stack (recompute of x1, x2 and
// h1, h2: 24; dx: 24; dW: 24) against about 4 (B C T) x 4 bytes moved at the
// least, so it is bound by arithmetic at the f32 rate of 67 TFLOP/s (f32
// results must hold 1e-4 of scale, which TF32 or bf16 tensor cores cannot).
// bf16 rounds h1, dh2 and dh1 to bf16 before their products, as the TPU
// kernel's bf16 path did; G and the dW sums stay f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxD = 9;   // largest dilation: the halos are sized for it
constexpr int kOcb = 8;    // output channels per thread in the channel products
constexpr int kPb = 4;     // time positions per thread in the channel products
constexpr int kIc = 16;    // reduction channels per staged weight chunk
constexpr int kWsPad = 4;  // keeps float4 alignment, spreads staging stores over banks

// reflect, clamped into range beyond an overhang of t_len (such cells only
// feed outputs that are never used)
__device__ __forceinline__ int reflect_clamped(int g, int t_len) {
  return min(max(reflect(g, t_len), 0), t_len - 1);
}

template <int C>
constexpr int weight_stage_floats() { return kIc * 3 * (C + kWsPad); }

// Y[o, p] = sum_r W[r, o] . operand(r, p) for p in [0, n_pos), o in [0, C).
// Without kTransposed the reduction runs over the weight's input channel
// (w laid out (o, i, k)); with it, over the weight's output channel, so the
// product applies W^T.  KT is the tap count (3 dilated, 1 pointwise).
// operand(ch, k, p) gives the activation; epilogue(o, p, value) consumes the
// result.  Every thread of the block must call it (it synchronises).
template <typename T, int C, int KT, bool kTransposed, typename Operand, typename Epilogue>
__device__ __forceinline__ void channel_product(const T* __restrict__ w, float* ws, int n_pos,
                                                Operand operand, Epilogue epilogue) {
  constexpr int kWs = C + kWsPad;
  constexpr int kGroups = C / kOcb;
  static_assert(C % kOcb == 0 && C % kIc == 0, "channel count must divide the tiles");
  const int tid = threadIdx.x;
  const int npg = (n_pos + kPb - 1) / kPb;
  const int items = kGroups * npg;
  for (int base = 0; base < items; base += kThreads) {
    const int item = base + tid;
    const bool active = item < items;
    const int og = active ? item / npg : 0;
    const int pg = active ? item - og * npg : 0;
    const int o0 = og * kOcb;
    int pos[kPb];
    bool valid[kPb];
#pragma unroll
    for (int q = 0; q < kPb; ++q) {
      const int p = pg + q * npg;
      valid[q] = active && p < n_pos;
      pos[q] = min(p, n_pos - 1);
    }
    float acc[kOcb][kPb];
#pragma unroll
    for (int a = 0; a < kOcb; ++a)
#pragma unroll
      for (int q = 0; q < kPb; ++q) acc[a][q] = 0.f;

    for (int r0 = 0; r0 < C; r0 += kIc) {
      __syncthreads();  // operands ready; previous chunk consumed
      for (int e = tid; e < C * kIc * KT; e += kThreads) {
        if (!kTransposed) {
          const int o = e / (kIc * KT);
          const int r = e - o * (kIc * KT);  // r = ii * KT + k
          ws[r * kWs + o] = to_f32(w[static_cast<size_t>(o) * C * KT + r0 * KT + r]);
        } else {
          const int r = e / C;  // r = oo * KT + k
          const int i = e - r * C;
          const int oo = r / KT;
          const int k = r - oo * KT;
          ws[r * kWs + i] =
              to_f32(w[static_cast<size_t>(r0 + oo) * C * KT + static_cast<size_t>(i) * KT + k]);
        }
      }
      __syncthreads();
      if (active) {
#pragma unroll 2
        for (int ii = 0; ii < kIc; ++ii) {
#pragma unroll
          for (int k = 0; k < KT; ++k) {
            float xv[kPb];
#pragma unroll
            for (int q = 0; q < kPb; ++q) xv[q] = operand(r0 + ii, k, pos[q]);
            const float4* wr = reinterpret_cast<const float4*>(ws + (ii * KT + k) * kWs + o0);
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
      for (int q = 0; q < kPb; ++q)
        if (valid[q]) epilogue(o0 + a, pos[q], acc[a][q]);
  }
}

// out[(o, i, k)] (+)= sum_{j in [j_lo, j_lo + n)} A[o][j] . B[i][j + k * step]
// for the owned positions of a tile; out is this block's float32 partial,
// laid out as the torch weight: (o * C + i) * KT + k.  No synchronisation:
// A and B are complete and not written meanwhile.
template <int C, int KT>
__device__ __forceinline__ void gram_product(const float* A, int lda, const float* B, int ldb,
                                             int j_lo, int n, int step, float* out, bool first) {
  constexpr int M = C >= 64 ? 8 : 4;  // micro-tile edge
  constexpr int kBlocks = C / M;
  constexpr int items = KT * kBlocks * kBlocks;
  for (int item = threadIdx.x; item < items; item += kThreads) {
    const int k = item / (kBlocks * kBlocks);
    const int rem = item - k * kBlocks * kBlocks;
    const int ob = rem / kBlocks;
    const int ib = rem - ob * kBlocks;
    float acc[M][M];
#pragma unroll
    for (int a = 0; a < M; ++a)
#pragma unroll
      for (int c = 0; c < M; ++c) acc[a][c] = 0.f;
    const float* ap = A + ob * M * lda + j_lo;
    const float* bp = B + ib * M * ldb + j_lo + k * step;
    for (int j = 0; j < n; ++j) {
      float av[M], bv[M];
#pragma unroll
      for (int a = 0; a < M; ++a) av[a] = ap[a * lda + j];
#pragma unroll
      for (int c = 0; c < M; ++c) bv[c] = bp[c * ldb + j];
#pragma unroll
      for (int a = 0; a < M; ++a)
#pragma unroll
        for (int c = 0; c < M; ++c) acc[a][c] = fmaf(av[a], bv[c], acc[a][c]);
    }
#pragma unroll
    for (int a = 0; a < M; ++a)
#pragma unroll
      for (int c = 0; c < M; ++c) {
        float* cell = out + (static_cast<size_t>(ob * M + a) * C + ib * M + c) * KT + k;
        *cell = first ? acc[a][c] : *cell + acc[a][c];
      }
  }
}

// ---- one ResidualUnit forward (the recompute of x1 and x2) ----------------

template <int C, int TILE>
constexpr size_t fwd_smem_floats() {
  return static_cast<size_t>(C) * (TILE + 2 * kMaxD) + C * TILE + weight_stage_floats<C>();
}

template <typename T, int C, int TILE>
__global__ void __launch_bounds__(kThreads)
unit_forward_kernel(const T* __restrict__ x, T* __restrict__ y, const T* __restrict__ wd,
                    const T* __restrict__ wp, int t_len, int d, float slope) {
  constexpr int WX = TILE + 2 * kMaxD;  // column j is time t0 - d + j
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [C][WX]
  float* hs = xs + C * WX;                      // [C][TILE]
  float* ws = hs + C * TILE;

  const int t0 = blockIdx.x * TILE;
  const int n_pos = min(TILE, t_len - t0);
  const int wx = n_pos + 2 * d;
  const size_t plane = static_cast<size_t>(C) * t_len;
  const T* xb = x + blockIdx.y * plane;
  T* yb = y + blockIdx.y * plane;

  for (int e = threadIdx.x; e < C * wx; e += kThreads) {
    const int c = e / wx;
    const int j = e - c * wx;
    xs[c * WX + j] = to_f32(xb[static_cast<size_t>(c) * t_len + reflect_clamped(t0 - d + j, t_len)]);
  }
  channel_product<T, C, 3, false>(
      wd, ws, n_pos, [&](int ch, int k, int p) { return xs[ch * WX + p + k * d]; },
      [&](int o, int p, float v) { hs[o * TILE + p] = round_to<T>(v); });
  channel_product<T, C, 1, false>(
      wp, ws, n_pos, [&](int ch, int, int p) { return hs[ch * TILE + p]; },
      [&](int o, int p, float v) {
        const float act = v >= 0.f ? v : slope * v;
        yb[static_cast<size_t>(o) * t_len + t0 + p] =
            from_f32<T>(xs[o * WX + p + d] + round_to<T>(act));
      });
}

// ---- one ResidualUnit backward --------------------------------------------

template <int C, int TILE>
constexpr size_t bwd_smem_floats() {
  return static_cast<size_t>(C) * (TILE + 4 * kMaxD) + 2 * C * (TILE + 2 * kMaxD) +
         weight_stage_floats<C>();
}

template <typename T, typename OutT, int C, int TILE>
__global__ void __launch_bounds__(kThreads)
unit_backward_kernel(const T* __restrict__ x, const float* __restrict__ g,
                     OutT* __restrict__ dx, const T* __restrict__ wd,
                     const T* __restrict__ wp, float* __restrict__ partial, int t_len, int d,
                     float slope, int tiles_per_row, int n_tiles) {
  constexpr int WX = TILE + 4 * kMaxD;  // x_u: column j is time t0 - 2d + j
  constexpr int WG = TILE + 2 * kMaxD;  // G, dh2, h1, dh1: column j is time t0 - d + j
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [C][WX] unit input, reflect-padded
  float* ds = xs + C * WX;                      // [C][WG] G, then dh2 in place
  float* hs = ds + C * WG;                      // [C][WG] h1, then dh1
  float* ws = hs + C * WG;
  float* part = partial + static_cast<size_t>(blockIdx.x) * 4 * C * C;  // [dWd 3C^2][dWp C^2]
  const size_t plane = static_cast<size_t>(C) * t_len;

  bool first = true;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile / tiles_per_row;
    const int t0 = (tile - b * tiles_per_row) * TILE;
    const int n_own = min(TILE, t_len - t0);
    const int wg = n_own + 2 * d;
    const int wx = n_own + 4 * d;
    const T* xb = x + b * plane;
    const float* gb = g + b * plane;

    __syncthreads();  // the previous tile is consumed
    for (int e = threadIdx.x; e < C * wx; e += kThreads) {
      const int c = e / wx;
      const int j = e - c * wx;
      xs[c * WX + j] =
          to_f32(xb[static_cast<size_t>(c) * t_len + reflect_clamped(t0 - 2 * d + j, t_len)]);
    }
    for (int e = threadIdx.x; e < C * wg; e += kThreads) {
      const int c = e / wg;
      const int j = e - c * wg;
      const int t = t0 - d + j;
      ds[c * WG + j] = (t >= 0 && t < t_len) ? gb[static_cast<size_t>(c) * t_len + t] : 0.f;
    }

    // h1 over the G window; zero outside [0, T), where nothing is an output
    channel_product<T, C, 3, false>(
        wd, ws, wg, [&](int ch, int k, int p) { return xs[ch * WX + p + k * d]; },
        [&](int o, int p, float v) {
          const int t = t0 - d + p;
          hs[o * WG + p] = (t >= 0 && t < t_len) ? round_to<T>(v) : 0.f;
        });
    // h2 = Wp . h1, then dh2 = G * leaky'(h2) in place (G is 0 outside [0, T))
    channel_product<T, C, 1, false>(
        wp, ws, wg, [&](int ch, int, int p) { return hs[ch * WG + p]; },
        [&](int o, int p, float v) {
          float* cell = ds + o * WG + p;
          *cell = round_to<T>(*cell * (v >= 0.f ? 1.f : slope));
        });
    __syncthreads();
    // dWp over the owned rows (window columns d .. d + n_own)
    gram_product<C, 1>(ds, WG, hs, WG, d, n_own, 0, part + 3 * C * C, first);
    // dh1 = Wp^T . dh2 over the window (0 outside [0, T), since dh2 is)
    channel_product<T, C, 1, true>(
        wp, ws, wg, [&](int ch, int, int p) { return ds[ch * WG + p]; },
        [&](int i, int p, float v) { hs[i * WG + p] = round_to<T>(v); });
    __syncthreads();
    // dWd[o, i, k] = sum_owned dh1[o, t] x_u[i, t + (k-1) d]; in xs columns
    // the tap-k input of WG column j is j + k d
    gram_product<C, 3>(hs, WG, xs, WX, d, n_own, d, part, first);
    // dx_u for the owned rows: G + Wd^T applied to the tap-gathered dh1, with
    // the reflect pad's transpose folded into the k = 0 and k = 2 taps
    const int left_hi = d;                 // s in [1, d]: k = 0 tap of t = d - s
    const int right_lo = t_len - 1 - d;    // s in [T-1-d, T-2]: k = 2 tap of 2(T-1) - s - d
    OutT* dxb = dx + b * plane;
    channel_product<T, C, 3, true>(
        wd, ws, n_own,
        [&](int ch, int k, int p) {
          const float* row = hs + ch * WG;
          const int s = t0 + p;
          float v = row[p + d - (k - 1) * d];
          if (k == 0 && s >= 1 && s <= left_hi) v += row[(d - s) - (t0 - d)];
          if (k == 2 && s >= right_lo && s <= t_len - 2) v += row[(2 * (t_len - 1) - s - d) - (t0 - d)];
          return v;
        },
        [&](int i, int p, float v) {
          const size_t at = static_cast<size_t>(i) * t_len + t0 + p;
          dxb[at] = from_f32<OutT>(gb[at] + v);
        });
    first = false;
  }
}

// out[e] = sum over blocks of partial[block][e], in block order
__global__ void __launch_bounds__(kThreads)
reduce_partials_kernel(const float* __restrict__ partial, float* __restrict__ out, int n_blocks,
                       int n) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b) s += partial[static_cast<size_t>(b) * n + e];
  out[e] = s;
}

template <typename T, typename OutT, int C, int TILE>
cudaError_t backward_grid(int device, int n_tiles, int* blocks) {
  const size_t smem = bwd_smem_floats<C, TILE>() * sizeof(float);
  auto kern = unit_backward_kernel<T, OutT, C, TILE>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = min(n_tiles, per_sm * sms);
  return cudaSuccess;
}

struct Args {
  const void* x;
  const float* g;
  void* dx;
  const void* w[6];  // wd0, wp0, wd1, wp1, wd2, wp2
  float* dw;         // per unit [dWd (C, C, 3) | dWp (C, C)], units 0, 1, 2
  void* x1;
  void* x2;
  float* g_a;
  float* g_b;
  float* partial;
  int n_blocks;
  int batch, t_len;
  float slope;
  cudaStream_t stream;
};

template <typename T, int C, int TILE>
cudaError_t run(const Args& a) {
  const int tiles_per_row = (a.t_len + TILE - 1) / TILE;
  const int n_tiles = tiles_per_row * a.batch;
  const int dils[3] = {1, 3, 9};
  cudaError_t err;

  // 1. recompute the unit inputs x1, x2
  {
    const size_t smem = fwd_smem_floats<C, TILE>() * sizeof(float);
    auto kern = unit_forward_kernel<T, C, TILE>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid(tiles_per_row, a.batch);
    const void* ins[2] = {a.x, a.x1};
    void* outs[2] = {a.x1, a.x2};
    for (int u = 0; u < 2; ++u) {
      kern<<<grid, kThreads, smem, a.stream>>>(
          static_cast<const T*>(ins[u]), static_cast<T*>(outs[u]),
          static_cast<const T*>(a.w[2 * u]), static_cast<const T*>(a.w[2 * u + 1]), a.t_len,
          dils[u], a.slope);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
  }

  // 2. units 2, 1, 0 backward, each followed by its dW reduction
  const void* xin[3] = {a.x, a.x1, a.x2};
  const float* gin[3] = {a.g_b, a.g_a, a.g};
  float* gout[3] = {nullptr, a.g_b, a.g_a};  // unit 0 writes dx in x's type
  const int n = 4 * C * C;
  for (int u = 2; u >= 0; --u) {
    const size_t smem = bwd_smem_floats<C, TILE>() * sizeof(float);
    const T* wd = static_cast<const T*>(a.w[2 * u]);
    const T* wp = static_cast<const T*>(a.w[2 * u + 1]);
    if (u > 0) {
      auto kern = unit_backward_kernel<T, float, C, TILE>;
      err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return err;
      kern<<<a.n_blocks, kThreads, smem, a.stream>>>(
          static_cast<const T*>(xin[u]), gin[u], gout[u], wd, wp, a.partial, a.t_len, dils[u],
          a.slope, tiles_per_row, n_tiles);
    } else {
      auto kern = unit_backward_kernel<T, T, C, TILE>;
      err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return err;
      kern<<<a.n_blocks, kThreads, smem, a.stream>>>(
          static_cast<const T*>(xin[u]), gin[u], static_cast<T*>(a.dx), wd, wp, a.partial,
          a.t_len, dils[u], a.slope, tiles_per_row, n_tiles);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    reduce_partials_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, a.stream>>>(
        a.partial, a.dw + static_cast<size_t>(u) * n, a.n_blocks, n);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// TILE per channel count: the widest window (TILE + 18 columns at d = 9) keeps
// the channel products at about one pass of 256 threads, and the shared
// memory at 102-133 KB
template <typename T>
cudaError_t grid_for(int channels, int device, int n_rows, int t_len, int* blocks) {
  switch (channels) {
    case 32: return backward_grid<T, float, 32, 224>(device, n_rows * ((t_len + 223) / 224), blocks);
    case 64: return backward_grid<T, float, 64, 96>(device, n_rows * ((t_len + 95) / 96), blocks);
    case 128: return backward_grid<T, float, 128, 46>(device, n_rows * ((t_len + 45) / 46), blocks);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(int channels, const Args& a) {
  switch (channels) {
    case 32: return run<T, 32, 224>(a);
    case 64: return run<T, 64, 96>(a);
    case 128: return run<T, 128, 46>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Number of blocks of the backward grid, hence of dW partials, for this
// shape on this device: the caller allocates partial as blocks x 4 C^2 floats.
int vx_residual_stack_backward_blocks(int batch, int channels, int t_len, int dtype, int device,
                                      int* blocks) {
  if (batch < 1 || t_len < 10) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (dtype == 0) return grid_for<float>(channels, device, batch, t_len, blocks);
  if (dtype == 1) return grid_for<__nv_bfloat16>(channels, device, batch, t_len, blocks);
  return cudaErrorInvalidValue;
}

// x, dx, x1, x2: (batch, channels, t_len) of one type (dtype 0 = float32,
// 1 = bfloat16); g, g_a, g_b: (batch, channels, t_len) float32; w*: the six
// effective weights in x's type, wd (C, C, 3) and wp (C, C, 1); dw: float32
// 3 x [dWd (C, C, 3) | dWp (C, C)] for units 0, 1, 2; partial: blocks x 4 C^2
// float32 with blocks from vx_residual_stack_backward_blocks.  x1, x2, g_a,
// g_b and partial are scratch.  Launches on `stream`; returns a cudaError_t.
int vx_residual_stack_backward(const void* x, const void* g, void* dx, const void* wd0,
                               const void* wp0, const void* wd1, const void* wp1,
                               const void* wd2, const void* wp2, void* dw, void* x1, void* x2,
                               void* g_a, void* g_b, void* partial, int blocks, int batch,
                               int channels, int t_len, int dtype, float slope, int device,
                               void* stream) {
  if (batch < 1 || t_len < 10 || blocks < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Args a{x, static_cast<const float*>(g), dx, {wd0, wp0, wd1, wp1, wd2, wp2},
         static_cast<float*>(dw), x1, x2, static_cast<float*>(g_a), static_cast<float*>(g_b),
         static_cast<float*>(partial), blocks, batch, t_len, slope,
         static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch<float>(channels, a);
  if (dtype == 1) return dispatch<__nv_bfloat16>(channels, a);
  return cudaErrorInvalidValue;
}

const char* vx_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
