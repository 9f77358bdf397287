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
// Passes.  The TPU kernel recomputed x1, x2 in a 32-row halo and ran the three
// units in one VMEM tile.  At C = 128 the planes that needs do not fit a
// block's 227 KB, so every unit is its own pass over device memory:
//   1. unit_forward twice: x1, x2 recomputed from x (K1's arithmetic and bf16
//      rounding), stored in x's type;
//   2. unit_backward for u = 2, 1, 0: a block recomputes h1 and h2 over its
//      tile and a d-row halo from x_u with a 2d-row halo (reflect-padded),
//      forms dh2 and dh1, adds its owned rows' dW products to a block-private
//      float32 partial, and writes dx_u for its owned rows (float32 between
//      units, x's type at the end);
//   3. reduce_partials after each unit: dW = the sum of the partials in block
//      order.  No float atomics anywhere, so dW is bit-equal from run to run
//      on one card.
// The unit_backward grid is persistent: as many blocks as fit the card at
// once, each looping over tiles (batch row, time tile) in a fixed order, so
// the partials are (blocks x 4 C^2) floats.
//
// float32 (unit_forward_kernel, unit_backward_kernel): f32 FMAs on C x T
// planes, weights staged in chunks of kIc channels, each convolution summed
// in the order cuDNN's IEEE float32 convolutions sum it (input channel, then
// tap; K1's FMA loop in that order matched them to the bit, PR 16), so the
// recomputed h2 agree with the plain chain's in sign.  Its bar (dx 1e-4, dW
// 2e-4 of scale against autograd of the plain stack) needs that, not only
// float32 accuracy: dh2 = G * leaky'(h2) jumps by 0.99 G
// where h2 changes sign, and at the training shapes some h2 lie within
// float32 rounding of zero, so another rounding of h2 flips their signs.
// The plain backward with its input channels summed in another order is
// 1e-2 of scale off itself there (scripts/torch_k2_f32_signs.py); a 3xTF32
// tensor-core K2, accurate to float32 against float64, missed the bar the
// same way (PERF.md, PR 17).
//
// bfloat16 (unit_forward_mma_kernel, unit_backward_mma_kernel): every product
// on the tensor cores, mma.sync m16n8k16 with bf16 operands and f32 sums, laid
// out as K1's residual_stack_mma_kernel.  PR 6's bf16 path ran the same
// mma.sync, but gathered every fragment one float at a time from float32
// C x T planes and re-packed it to bf16 (4-way and 8-way bank conflicts at
// C = 128), staged the weights with two barriers a chunk and nothing in
// flight, and its 133 KB of planes at C = 128 left one block of 8 warps per
// SM on a 46-column tile whose d = 9 window was 64 columns.  It took 1.16 /
// 2.35 / 3.70 ms a call at C = 32 / 64 / 128 (PR 6), slower than autograd of
// the plain stack at C = 64 and 128.  Here:
//   - Planes are time-major bf16, [row][C + 8]: x_u (row j is time
//     t0 - 2d + j, reflect-padded), h1 and then dh1, and dh2 (row j is time
//     t0 - d + j).  The 80 / 144 / 272-byte row stride puts the 8 rows of
//     every ldmatrix phase in 8 distinct 16-byte bank groups, and a tap's
//     shift moves whole rows.  NCW x is transposed into xs through registers,
//     eight channels a thread, one 16-byte store.
//   - Channel products (h1, h2, dh1 = Wp^T dh2, dx = Wd^T . tap-shifted dh1):
//     M is time rows, N output channels, K reduction channels.  A comes from
//     a plane by ldmatrix.x4, shifted a whole row block per tap; B by
//     ldmatrix.x4 from weights staged [n][k + 8].  layout_unit_weights_kernel
//     lays each unit's weights out once a call as eight [n][k] slots: Wd's
//     taps and Wp, then both transposed.  A tile's weight chunks (one tap, KC
//     reduction channels) stream in with 16-byte cp.async through a ring of
//     2 or 3 buffers, one barrier a chunk, and the stream runs on across the
//     block's tiles.
//   - Gram products (dWp = dh2 h1^T, dWd[., ., k] = dh1 . x_u shifted by
//     (k-1) d) reduce over the owned time rows, so both fragments come from
//     the time-major planes by ldmatrix.trans.  Each warp owns a block of
//     (C/32 x C/32) output tiles of each tap; the block's partial is laid
//     out [tap][o][i] (tap 3 = dWp) so a fragment pair is one 8-byte store,
//     and reduce_partials permutes it back to (o, i, k).
//   - G stays float32 in global memory, read in the two epilogues that need
//     it (dh2 over the window, dx at the owned rows): each lane group reads
//     8 consecutive times of a channel, one whole 32-byte sector, and a
//     float32 window plane would take 98 KB of shared memory at C = 128
//     (192 rows), more than the block has left.  Each G element is read
//     twice a tile, the halo from L2.
//   - The reflect-pad fold terms of dx (at most 2d rows at each end of a
//     row) are f32 FMAs over Wd from global memory and dh1 from the plane,
//     added to the mma sum in the epilogue.
//   - Rounding points as the TPU kernel's bf16 path: h1, dh2 and dh1 rounded
//     to bf16 (dh2 = G * leaky'(h2) in f32, then rounded); x1, x2 as K1
//     rounds them.  G and the dW sums stay f32.
//   - Tiles (MmaPlan), chosen per C from K2's ms a call and per pass at
//     the training shapes (B 32; scripts/torch_k2_plans.py on an H100 80GB
//     HBM3 at 700 W, PR 15, two runs each): owned rows TILE = 224 / 256 /
//     160 at C = 32 / 64 / 128, in whole m16 tiles; the window (TILE + 2d
//     rows) rounds up to whole m16 tiles, the x plane is 2d rows more.  At
//     C = 32, two blocks of 8 warps per SM (68 KB at d = 9): 0.452-0.456
//     ms, against 0.533 for one block.  At C = 64 and 128 one block on a
//     larger tile beat two on a smaller one (C = 64, 256 rows in 145 KB:
//     0.671-0.674 ms against 128 rows 0.692-0.696; C = 128, 160 rows in
//     192 KB with three chunk buffers: 0.655-0.657 against 64 rows
//     0.938-0.939, 128 rows 0.784-0.788), and 16 warps a block (128
//     registers a thread) beat 8 (up to 255): C = 64 0.609 against 0.667,
//     C = 128 0.606-0.607 against 0.654-0.656.  The recomputed halo at
//     d = 9 is then 6 / 5 / 8% of the owned rows' work, and at C = 128 the
//     partial's read-modify-write (4 C^2 floats each way a tile) comes 8
//     times a batch row instead of 20.
// tests/test_torch_residual_mma.py emulates this walk in float64.
//
// Bound on this card: 72 C^2 T B FLOP per stack (the recompute of x1, x2
// and h1, h2: 24; dx: 24; dW: 24) against x and g read and dx written once,
// so arithmetic bounds it: at 989 TFLOP/s for bf16 and 67 TFLOP/s for the
// f32 FMAs (165 TFLOP/s for f32-accurate products in 3xTF32, the bound
// chip_smoke.py reports).
// The per-tile partial read-modify-write (4 C^2 floats each way) is the
// traffic that grows with C: 512 KB a tile at C = 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // the f32 kernels' and the helper launches' blocks
constexpr int kMaxD = 9;   // largest dilation: the f32 halos are sized for it
constexpr int kOcb = 8;    // output channels per thread in the f32 channel products
constexpr int kPb = 4;     // time positions per thread in the f32 channel products
constexpr int kIc = 16;    // reduction channels per staged f32 weight chunk
constexpr int kWsPad = 4;  // keeps float4 alignment, spreads staging stores over banks

// reflect, clamped into range beyond an overhang of t_len (such cells only
// feed outputs that are never used)
__device__ __forceinline__ int reflect_clamped(int g, int t_len) {
  return min(max(reflect(g, t_len), 0), t_len - 1);
}

// blocks of bytes of shared memory each that fit one SM (228 KB, 1 KB of it
// reserved per block)
__host__ __device__ constexpr int blocks_per_sm(size_t smem_bytes) {
  return static_cast<int>(233472 / (smem_bytes + 1024));
}

// ============================================================================
// float32: FMAs
// ============================================================================

constexpr int weight_stage_floats(int c) { return kIc * 3 * (c + kWsPad); }

// channel_product's default: no position takes a fold term
struct NoFold {
  __device__ __forceinline__ bool operator()(int) const { return false; }
  __device__ __forceinline__ float operator()(int, int, int) const { return 0.f; }
};

// the chunk r0 .. r0 + kIc of reduction channels of w into
// ws[(ii * KT + k) * kWs + output channel]
template <int C, int KT, bool kTransposed>
__device__ __forceinline__ void stage_weights(const float* __restrict__ w, float* ws, int r0) {
  constexpr int kWs = C + kWsPad;
  constexpr int kElems = C * kIc * KT;
  for (int e = threadIdx.x; e < kElems; e += kThreads) {
    size_t src;
    int dst;
    if (!kTransposed) {
      const int o = e / (kIc * KT);
      const int r = e - o * (kIc * KT);  // r = ii * KT + k
      src = static_cast<size_t>(o) * C * KT + r0 * KT + r;
      dst = r * kWs + o;
    } else {
      const int r = e / C;  // r = oo * KT + k
      const int i = e - r * C;
      const int oo = r / KT;
      const int k = r - oo * KT;
      src = static_cast<size_t>(r0 + oo) * C * KT + static_cast<size_t>(i) * KT + k;
      dst = r * kWs + i;
    }
    ws[dst] = w[src];
  }
}

// Y[o, p] = sum_r W[r, o] . operand(r, p) for p in [0, n_pos), o in [0, C).
// Without kTransposed the reduction runs over the weight's input channel
// (w laid out (o, i, k)); with it, over the weight's output channel, so the
// product applies W^T.  KT is the tap count (3 dilated, 1 pointwise); n_pos
// is at most TILE + 2 kMaxD.  operand(ch, k, p) gives the activation;
// epilogue(o, p, value) consumes the result.  Where touches(p), position p
// also takes fold(ch, k, p) in its operand (the reflect pad's transpose).
// FMAs on kOcb x kPb micro-tiles.  Every thread of the block must call it
// (it synchronises).
template <int C, int KT, bool kTransposed, typename Operand, typename Epilogue,
          typename Touches = NoFold, typename Fold = NoFold>
__device__ __forceinline__ void channel_product(const float* __restrict__ w, float* ws, int n_pos,
                                                Operand operand, Epilogue epilogue,
                                                Touches touches = Touches(), Fold fold = Fold()) {
  constexpr int kWs = C + kWsPad;
  static_assert(C % kOcb == 0 && C % kIc == 0, "channel count must divide the tiles");
  constexpr int kGroups = C / kOcb;
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
      stage_weights<C, KT, kTransposed>(w, ws, r0);
      __syncthreads();
      if (active) {
#pragma unroll 2
        for (int ii = 0; ii < kIc; ++ii) {
#pragma unroll
          for (int k = 0; k < KT; ++k) {
            float xv[kPb];
#pragma unroll
            for (int q = 0; q < kPb; ++q) {
              xv[q] = operand(r0 + ii, k, pos[q]);
              if (touches(pos[q])) xv[q] += fold(r0 + ii, k, pos[q]);
            }
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
// A and B are complete and not written meanwhile.  Each cell of out is
// written by one thread, once, so the partial's order is fixed.  FMAs on
// M x M micro-tiles.
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

// float32 TILE per channel count: the widest window (TILE + 18 columns at
// d = 9) keeps the channel products at about one pass of 256 threads
template <int C>
constexpr int f32_tile() { return C == 32 ? 224 : C == 64 ? 96 : 46; }

// ---- one ResidualUnit forward (the recompute of x1 and x2) ----------------

template <int C, int TILE>
constexpr size_t fwd_smem_floats() {
  return static_cast<size_t>(C) * (TILE + 2 * kMaxD) + C * TILE + weight_stage_floats(C);
}

template <int C, int TILE>
__global__ void __launch_bounds__(kThreads)
unit_forward_kernel(const float* __restrict__ x, float* __restrict__ y, const float* __restrict__ wd,
                    const float* __restrict__ wp, int t_len, int d, float slope) {
  constexpr int WX = TILE + 2 * kMaxD;  // column j is time t0 - d + j
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [C][WX]
  float* hs = xs + C * WX;                      // [C][TILE]
  float* ws = hs + C * TILE;

  const int t0 = blockIdx.x * TILE;
  const int n_pos = min(TILE, t_len - t0);
  const int wx = n_pos + 2 * d;
  const size_t plane = static_cast<size_t>(C) * t_len;
  const float* xb = x + blockIdx.y * plane;
  float* yb = y + blockIdx.y * plane;

  for (int e = threadIdx.x; e < C * wx; e += kThreads) {
    const int c = e / wx;
    const int j = e - c * wx;
    xs[c * WX + j] = xb[static_cast<size_t>(c) * t_len + reflect_clamped(t0 - d + j, t_len)];
  }
  channel_product<C, 3, false>(
      wd, ws, n_pos, [&](int ch, int k, int p) { return xs[ch * WX + p + k * d]; },
      [&](int o, int p, float v) { hs[o * TILE + p] = v; });
  channel_product<C, 1, false>(
      wp, ws, n_pos, [&](int ch, int, int p) { return hs[ch * TILE + p]; },
      [&](int o, int p, float v) {
        const float act = v >= 0.f ? v : slope * v;
        yb[static_cast<size_t>(o) * t_len + t0 + p] = xs[o * WX + p + d] + act;
      });
}

// ---- one ResidualUnit backward --------------------------------------------

template <int C, int TILE>
constexpr size_t bwd_smem_floats() {
  return static_cast<size_t>(C) * (TILE + 4 * kMaxD) + 2 * C * (TILE + 2 * kMaxD) +
         weight_stage_floats(C);
}

template <int C, int TILE>
__global__ void __launch_bounds__(kThreads, (blocks_per_sm(bwd_smem_floats<C, TILE>() * sizeof(float))))
unit_backward_kernel(const float* __restrict__ x, const float* __restrict__ g,
                     float* __restrict__ dx, const float* __restrict__ wd,
                     const float* __restrict__ wp, float* __restrict__ partial, int t_len, int d,
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
    const float* xb = x + b * plane;
    const float* gb = g + b * plane;

    __syncthreads();  // the previous tile is consumed
    for (int e = threadIdx.x; e < C * wx; e += kThreads) {
      const int c = e / wx;
      const int j = e - c * wx;
      xs[c * WX + j] = xb[static_cast<size_t>(c) * t_len + reflect_clamped(t0 - 2 * d + j, t_len)];
    }
    for (int e = threadIdx.x; e < C * wg; e += kThreads) {
      const int c = e / wg;
      const int j = e - c * wg;
      const int t = t0 - d + j;
      ds[c * WG + j] = (t >= 0 && t < t_len) ? gb[static_cast<size_t>(c) * t_len + t] : 0.f;
    }

    // h1 over the G window; zero outside [0, T), where nothing is an output
    channel_product<C, 3, false>(
        wd, ws, wg, [&](int ch, int k, int p) { return xs[ch * WX + p + k * d]; },
        [&](int o, int p, float v) {
          const int t = t0 - d + p;
          hs[o * WG + p] = (t >= 0 && t < t_len) ? v : 0.f;
        });
    // h2 = Wp . h1, then dh2 = G * leaky'(h2) in place (G is 0 outside [0, T))
    channel_product<C, 1, false>(
        wp, ws, wg, [&](int ch, int, int p) { return hs[ch * WG + p]; },
        [&](int o, int p, float v) {
          float* cell = ds + o * WG + p;
          *cell = *cell * (v >= 0.f ? 1.f : slope);
        });
    __syncthreads();
    // dWp over the owned rows (window columns d .. d + n_own)
    gram_product<C, 1>(ds, WG, hs, WG, d, n_own, 0, part + 3 * C * C, first);
    // dh1 = Wp^T . dh2 over the window (0 outside [0, T), since dh2 is)
    channel_product<C, 1, true>(
        wp, ws, wg, [&](int ch, int, int p) { return ds[ch * WG + p]; },
        [&](int i, int p, float v) { hs[i * WG + p] = v; });
    __syncthreads();
    // dWd[o, i, k] = sum_owned dh1[o, t] x_u[i, t + (k-1) d]; in xs columns
    // the tap-k input of WG column j is j + k d
    gram_product<C, 3>(hs, WG, xs, WX, d, n_own, d, part, first);
    // dx_u for the owned rows: G + Wd^T applied to the tap-gathered dh1, with
    // the reflect pad's transpose as fold terms of the k = 0 and k = 2 taps
    const int left_hi = d;                 // s in [1, d]: k = 0 tap of t = d - s
    const int right_lo = t_len - 1 - d;    // s in [T-1-d, T-2]: k = 2 tap of 2(T-1) - s - d
    float* dxb = dx + b * plane;
    channel_product<C, 3, true>(
        wd, ws, n_own, [&](int ch, int k, int p) { return hs[ch * WG + p + d - (k - 1) * d]; },
        [&](int i, int p, float v) {
          const size_t at = static_cast<size_t>(i) * t_len + t0 + p;
          dxb[at] = gb[at] + v;
        },
        [&](int p) {
          const int s = t0 + p;
          return (s >= 1 && s <= left_hi) || (s >= right_lo && s <= t_len - 2);
        },
        [&](int ch, int k, int p) {
          const float* row = hs + ch * WG;
          const int s = t0 + p;
          if (k == 0 && s >= 1 && s <= left_hi) return row[(d - s) - (t0 - d)];
          if (k == 2 && s >= right_lo && s <= t_len - 2) return row[(2 * (t_len - 1) - s - d) - (t0 - d)];
          return 0.f;
        });
    first = false;
  }
}

// ============================================================================
// bfloat16: the tensor-core kernels
// ============================================================================

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

constexpr int kApad = 8;  // bf16 pad of every plane and weight row: 16 bytes

// Per channel count: TILE (owned time rows of a block, whole m16 tiles), KC
// (reduction channels per weight chunk), the weight chunks' ring of buffers
// (chunks in flight + 1), the warps of a block (8 or 16) and the blocks per
// SM __launch_bounds__ promises (at most what shared memory allows; a
// thread may take 65536 / (32 x warps x blocks) registers, at most 255).
template <int C>
struct MmaPlan;
template <>
struct MmaPlan<32> {
  static constexpr int kTile = 224, kKc = 32, kStages = 2, kWarps = 8, kBlocks = 2;
};
template <>
struct MmaPlan<64> {
  static constexpr int kTile = 256, kKc = 64, kStages = 2, kWarps = 16, kBlocks = 1;
};
template <>
struct MmaPlan<128> {
  static constexpr int kTile = 160, kKc = 32, kStages = 3, kWarps = 16, kBlocks = 1;
};

// threads of a block of the bf16 unit kernels
template <int C>
__host__ __device__ constexpr int mma_threads() { return 32 * MmaPlan<C>::kWarps; }

// A block's planes at dilation D.  Backward: window rows (h1, dh2, dh1) are
// time t0 - D + j over whole m-tiles covering TILE + 2D rows; x rows are time
// t0 - 2D + j, 2D more.  Forward: x rows are time t0 - D + j, TILE + 2D of
// them, and h1 has TILE rows.
template <int C, int D>
struct Geometry {
  static constexpr int kTile = MmaPlan<C>::kTile;
  static constexpr int kS = C + kApad;                     // plane row stride
  static constexpr int kOwnMt = kTile / 16;                // m-tiles of the owned rows
  static constexpr int kWinMt = (kTile + 2 * D + 15) / 16;  // m-tiles of the window
  static constexpr int kWinRows = 16 * kWinMt;
  static constexpr int kXRows = kWinRows + 2 * D;
  static constexpr int kWb = C * (MmaPlan<C>::kKc + kApad);  // one weight buffer
  static constexpr size_t kRing = static_cast<size_t>(MmaPlan<C>::kStages) * kWb * sizeof(bf16);
  static constexpr size_t kBwdSmem = (static_cast<size_t>(kXRows) + 2 * kWinRows) * kS * sizeof(bf16) + kRing;
  static constexpr size_t kFwdSmem = (static_cast<size_t>(kTile + 2 * D) + kTile) * kS * sizeof(bf16) + kRing;
  static_assert(kTile % 16 == 0, "the owned rows are whole m16 tiles");
};

// the blocks per SM a kernel's __launch_bounds__ promises: the plan's, or
// fewer where shared memory allows fewer
template <int C>
__host__ __device__ constexpr int promised_blocks(size_t smem_bytes) {
  return blocks_per_sm(smem_bytes) < MmaPlan<C>::kBlocks ? blocks_per_sm(smem_bytes) : MmaPlan<C>::kBlocks;
}

// The weight slots of a unit, each [n][k] (C x C): Wd's taps 0-2 and Wp as
// [o][i], then Wd's taps and Wp transposed, [i][o].
constexpr int kSlotWd = 0, kSlotWp = 3, kSlotWdT = 4, kSlotWpT = 7, kSlots = 8;

// wt[unit][slot][n][k] from the six torch-layout weights
__global__ void __launch_bounds__(kThreads)
layout_unit_weights_kernel(const bf16* __restrict__ wd0, const bf16* __restrict__ wp0,
                           const bf16* __restrict__ wd1, const bf16* __restrict__ wp1,
                           const bf16* __restrict__ wd2, const bf16* __restrict__ wp2,
                           bf16* __restrict__ wt, int c) {
  const int cc = c * c;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= 3 * kSlots * cc) return;
  const int u = e / (kSlots * cc);
  const int r = e - u * kSlots * cc;
  const int slot = r / cc;
  const int n = (r - slot * cc) / c;
  const int k = r - slot * cc - n * c;
  const bool transposed = slot >= kSlotWdT;
  const int tap = transposed ? slot - kSlotWdT : slot;  // 3 = Wp
  const int o = transposed ? k : n, i = transposed ? n : k;
  const bf16* wd = u == 0 ? wd0 : u == 1 ? wd1 : wd2;
  const bf16* wp = u == 0 ? wp0 : u == 1 ? wp1 : wp2;
  wt[e] = tap < 3 ? wd[(o * c + i) * 3 + tap] : wp[o * c + i];
}

// A tile's weight chunks in the order its products take them: per product,
// for each KC block of reduction channels, each tap.  The products are h1
// (Wd), h2 (Wp), then in the backward dh1 (Wp^T) and dx (Wd^T).  A block
// takes chunk m of its sequence over its tiles (chunk m % kChunks of a
// tile) from buffer m % kStages of its ring; acquire() waits for chunk m,
// then refills the buffer every warp has just finished with chunk
// m + kStages - 1, so kStages - 1 chunks are in flight while one is used,
// with one barrier a chunk.
template <int C, bool kBackward>
struct WeightStream {
  static constexpr int kKc = MmaPlan<C>::kKc;
  static constexpr int kStages = MmaPlan<C>::kStages;
  static constexpr int kCpc = C / kKc;  // chunks per tap
  static constexpr int kChunks = (kBackward ? 8 : 4) * kCpc;
  static_assert(kStages >= 2, "the ring needs a buffer to fill while one is used");

  // chunk n of a tile: its slot and its first reduction channel
  static __device__ __forceinline__ void chunk(int n, int* slot, int* k0) {
    if (n < 3 * kCpc) {  // h1: Wd
      *slot = kSlotWd + n % 3;
      *k0 = (n / 3) * kKc;
    } else if (n < 4 * kCpc) {  // h2: Wp
      *slot = kSlotWp;
      *k0 = (n - 3 * kCpc) * kKc;
    } else if (n < 5 * kCpc) {  // dh1: Wp^T
      *slot = kSlotWpT;
      *k0 = (n - 4 * kCpc) * kKc;
    } else {  // dx: Wd^T
      *slot = kSlotWdT + (n - 5 * kCpc) % 3;
      *k0 = ((n - 5 * kCpc) / 3) * kKc;
    }
  }

  // the block's chunk m of the unit's weights wt ([slot][n][k]) into its
  // ring buffer ([n][KC + 8] each) if m < m_end; one cp.async group either
  // way, so that a wait counts chunks
  static __device__ __forceinline__ void issue(const bf16* __restrict__ wt, bf16* ring, int m, int m_end) {
    constexpr int kPieces = kKc / 8;  // 16-byte pieces of a row
    if (m < m_end) {
      int slot, k0;
      chunk(m % kChunks, &slot, &k0);
      const bf16* src = wt + static_cast<size_t>(slot) * C * C + k0;
      bf16* buf = ring + (m % kStages) * C * (kKc + kApad);
      for (int e = threadIdx.x; e < C * kPieces; e += mma_threads<C>()) {
        const int row = e / kPieces;
        const int p = e - row * kPieces;
        cp_async16(buf + row * (kKc + kApad) + p * 8, src + static_cast<size_t>(row) * C + p * 8);
      }
    }
    cp_async_commit();
  }

  // the first kStages - 1 chunks, before the block's first acquire
  static __device__ __forceinline__ void start(const bf16* __restrict__ wt, bf16* ring, int m_end) {
#pragma unroll
    for (int m = 0; m < kStages - 1; ++m) issue(wt, ring, m, m_end);
  }

  // chunk m, once it has landed for every thread (and every warp is done
  // with chunk m - 1, whose buffer takes chunk m + kStages - 1)
  static __device__ __forceinline__ const bf16* acquire(const bf16* __restrict__ wt, bf16* ring, int m,
                                                       int m_end) {
    cp_async_wait_pending<kStages - 2>();
    __syncthreads();
    issue(wt, ring, m + kStages - 1, m_end);
    return ring + (m % kStages) * C * (kKc + kApad);
  }
};

// How the warps share a channel product of NMT m-tiles: kWn warps side by
// side along N (two n8 tiles each, one ldmatrix.x4 of B a k16 step), kWm
// along M; a warp takes m-tiles wm, wm + kWm, ... below NMT.
template <int C, int NMT>
struct WarpTiles {
  static constexpr int kNw = 2;
  static constexpr int kWn = C / (8 * kNw);
  static constexpr int kWm = MmaPlan<C>::kWarps / kWn;
  static constexpr int kMw = (NMT + kWm - 1) / kWm;
  static constexpr bool kExact = NMT % kWm == 0;  // every warp's m-tiles exist
  static_assert(MmaPlan<C>::kWarps % kWn == 0, "the warps must share the n-tiles evenly");
};

// acc = A . B over one channel product: M is NMT m-tiles of plane rows,
// tap k's A rows start at a_row0 + k * tap_step, K is the C reduction
// channels (the plane's columns), N the C output channels (rows of the
// staged chunks).  acquire() gives each chunk once it has landed.
template <int C, int NMT, int KT, int MW, int NW, typename Acquire>
__device__ __forceinline__ void channel_product(float (&acc)[MW][NW][4], const bf16* plane,
                                                int a_row0, int tap_step, Acquire& acquire) {
  using W = WarpTiles<C, NMT>;
  static_assert(MW == W::kMw && NW == W::kNw, "the accumulators must match the warp's tiles");
  constexpr int KC = MmaPlan<C>::kKc, S = C + kApad, WS = KC + kApad;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / W::kWn, n0 = (warp % W::kWn) * NW * 8;
  // ldmatrix.x4 row addresses: A's four 8 x 8 matrices are (rows 0-7 | 8-15)
  // x (k 0-7 | 8-15) as a0..a3; B's are n-tile pairs x (k 0-7 | 8-15)
  const int a_r = (lane & 7) + ((lane >> 3) & 1) * 8, a_c = (lane >> 4) * 8;
  const int b_r = (lane & 7) + (lane >> 4) * 8, b_c = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int i = 0; i < MW; ++i)
#pragma unroll
    for (int nt = 0; nt < NW; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][nt][e] = 0.f;
#pragma unroll 1
  for (int k0 = 0; k0 < C; k0 += KC) {
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      const bf16* w = acquire();
      const int row0 = a_row0 + k * tap_step;
#pragma unroll
      for (int ks = 0; ks < KC; ks += 16) {
        // every fragment of the step first, then the products, with no
        // branch between them where the warps cover the m-tiles exactly; a
        // warp past the last m-tile loads that one again and drops it
        uint32_t b[NW / 2][4], a[MW][4];
#pragma unroll
        for (int p = 0; p < NW / 2; ++p) ldmatrix_x4(b[p], w + (n0 + 16 * p + b_r) * WS + ks + b_c);
#pragma unroll
        for (int i = 0; i < MW; ++i) {
          const int mt = min(wm + W::kWm * i, NMT - 1);
          ldmatrix_x4(a[i], plane + (row0 + 16 * mt + a_r) * S + k0 + ks + a_c);
        }
#pragma unroll
        for (int i = 0; i < MW; ++i) {
          if (W::kExact || wm + W::kWm * i < NMT) {  // the same for the whole warp
#pragma unroll
            for (int nt = 0; nt < NW; ++nt) {
              const uint32_t bb[2] = {b[nt / 2][2 * (nt & 1)], b[nt / 2][2 * (nt & 1) + 1]};
              mma_bf16(acc[i][nt], a[i], bb);
            }
          }
        }
      }
    }
  }
}

// f(row, channel, v0, v1) for each pair of a warp's accumulators: rows of
// the product's m-tiles, channels channel and channel + 1
template <int C, int NMT, int MW, int NW, typename F>
__device__ __forceinline__ void for_each_pair(const float (&acc)[MW][NW][4], F f) {
  using W = WarpTiles<C, NMT>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / W::kWn, n0 = (warp % W::kWn) * NW * 8;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < MW; ++i) {
    const int mt = wm + W::kWm * i;
    if (!W::kExact && mt >= NMT) continue;
#pragma unroll
    for (int nt = 0; nt < NW; ++nt) {
      f(16 * mt + g, n0 + 8 * nt + 2 * q, acc[i][nt][0], acc[i][nt][1]);
      f(16 * mt + g + 8, n0 + 8 * nt + 2 * q, acc[i][nt][2], acc[i][nt][3]);
    }
  }
}

// The gram products: the (warps / 4) x 4 warps each own a block of MG
// m-tiles (o) by NG = C/32 n-tiles (i) of a C x C output, o0 = 16 MG x
// (warp / 4), i0 = C/4 x (warp % 4).
template <int C>
struct GramTiles {
  static constexpr int kMg = C / 16 / (MmaPlan<C>::kWarps / 4), kNg = C / 32;
  static_assert(kMg >= 1 && 16 * kMg * (MmaPlan<C>::kWarps / 4) == C, "the warps must share the m-tiles evenly");
};

// acc[o, i] = sum over KSTEPS k16 steps of A[row][o] B[row][i], A's rows
// from a_row0 and B's from b_row0 in the time-major planes a and b, both by
// ldmatrix.trans (the reduction runs over rows)
template <int C, int KSTEPS>
__device__ __forceinline__ void gram(float (&acc)[GramTiles<C>::kMg][GramTiles<C>::kNg][4],
                                     const bf16* a, int a_row0, const bf16* b, int b_row0) {
  constexpr int MG = GramTiles<C>::kMg, NG = GramTiles<C>::kNg, S = C + kApad;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int o0 = (warp >> 2) * 16 * MG, i0 = (warp & 3) * (C / 4);
  // ldmatrix.trans row addresses (a row is a time): A's matrices are
  // (o 0-7 | 8-15) x (t 0-7 | 8-15) as a0..a3; B's (t 0-7 | 8-15) x n-tile
  // pairs, so registers b0, b1 of the first n-tile, then of the second
  const int a_r = (lane & 7) + (lane >> 4) * 8, a_c = ((lane >> 3) & 1) * 8;
  const int b_r = (lane & 7) + ((lane >> 3) & 1) * 8, b_c = (lane >> 4) * 8;
#pragma unroll
  for (int m = 0; m < MG; ++m)
#pragma unroll
    for (int n = 0; n < NG; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
#pragma unroll 2
  for (int ks = 0; ks < KSTEPS; ++ks) {
    uint32_t fa[MG][4];
#pragma unroll
    for (int m = 0; m < MG; ++m)
      ldmatrix_x4_trans(fa[m], a + (a_row0 + 16 * ks + a_r) * S + o0 + 16 * m + a_c);
    if constexpr (NG == 1) {
      uint32_t fb[2];
      ldmatrix_x2_trans(fb, b + (b_row0 + 16 * ks + b_r) * S + i0);
#pragma unroll
      for (int m = 0; m < MG; ++m) mma_bf16(acc[m][0], fa[m], fb);
    } else {
      uint32_t fb[NG / 2][4];
#pragma unroll
      for (int p = 0; p < NG / 2; ++p)
        ldmatrix_x4_trans(fb[p], b + (b_row0 + 16 * ks + b_r) * S + i0 + 16 * p + b_c);
#pragma unroll
      for (int p = 0; p < NG / 2; ++p) {
        const uint32_t lo[2] = {fb[p][0], fb[p][1]}, hi[2] = {fb[p][2], fb[p][3]};
#pragma unroll
        for (int m = 0; m < MG; ++m) {
          mma_bf16(acc[m][2 * p], fa[m], lo);
          mma_bf16(acc[m][2 * p + 1], fa[m], hi);
        }
      }
    }
  }
}

// the warp's gram block into out ([o][i], C x C) of the block's partial:
// written on the block's first tile, added to after; every cell by one lane,
// once a tile, so the partial's order is fixed.  A block's cells are all
// read before any is written.
template <int C>
__device__ __forceinline__ void store_gram(float (&acc)[GramTiles<C>::kMg][GramTiles<C>::kNg][4],
                                           float* out, bool first) {
  constexpr int MG = GramTiles<C>::kMg, NG = GramTiles<C>::kNg;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int o0 = (warp >> 2) * 16 * MG, i0 = (warp & 3) * (C / 4);
  const int g = lane >> 2, q = lane & 3;
  const auto cell = [&](int m, int n, int h) {
    return reinterpret_cast<float2*>(out + (o0 + 16 * m + g + 8 * h) * C + i0 + 8 * n + 2 * q);
  };
  if (!first) {
#pragma unroll
    for (int m = 0; m < MG; ++m)
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 v = *cell(m, n, h);
          acc[m][n][2 * h] = v.x + acc[m][n][2 * h];
          acc[m][n][2 * h + 1] = v.y + acc[m][n][2 * h + 1];
        }
  }
#pragma unroll
  for (int m = 0; m < MG; ++m)
#pragma unroll
    for (int n = 0; n < NG; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) *cell(m, n, h) = make_float2(acc[m][n][2 * h], acc[m][n][2 * h + 1]);
}

// rows [0, rows) of a time-major plane from NCW x (one batch row), row j
// being time t_first + j reflect-clamped: eight channels a thread, one
// 16-byte store
template <int C>
__device__ __forceinline__ void load_plane(const bf16* __restrict__ xb, bf16* plane, int rows,
                                           int t_first, int t_len) {
  constexpr int S = C + kApad;
#pragma unroll 2
  for (int e = threadIdx.x; e < (C / 8) * rows; e += mma_threads<C>()) {
    const int c8 = e / rows;
    const int j = e - c8 * rows;
    const bf16* src = xb + static_cast<size_t>(8 * c8) * t_len + reflect_clamped(t_first + j, t_len);
    uint4 v;
    bf16* vh = reinterpret_cast<bf16*>(&v);
#pragma unroll
    for (int c = 0; c < 8; ++c) vh[c] = src[static_cast<size_t>(c) * t_len];
    *reinterpret_cast<uint4*>(plane + j * S + 8 * c8) = v;
  }
}

// ---- one ResidualUnit forward (the recompute of x1 and x2) ----------------

template <int C, int D>
__global__ void __launch_bounds__(mma_threads<C>(), promised_blocks<C>(Geometry<C, D>::kFwdSmem))
unit_forward_mma_kernel(const bf16* __restrict__ x, bf16* __restrict__ y, const bf16* __restrict__ wt,
                        int t_len, float slope) {
  using Gm = Geometry<C, D>;
  using Stream = WeightStream<C, false>;
  constexpr int TILE = Gm::kTile, S = Gm::kS, NMT = Gm::kOwnMt;
  constexpr int kXRows = TILE + 2 * D;  // row j is time t0 - D + j
  extern __shared__ float4 smem4[];
  bf16* xs = reinterpret_cast<bf16*>(smem4);  // [kXRows][S] unit input, then its output in place
  bf16* hs = xs + kXRows * S;                 // [TILE][S] h1
  bf16* ring = hs + TILE * S;                 // [kStages][C][KC + 8] staged weights

  const int t0 = blockIdx.x * TILE;
  const size_t plane = static_cast<size_t>(C) * t_len;
  const bf16* xb = x + blockIdx.y * plane;
  bf16* yb = y + blockIdx.y * plane;

  Stream::start(wt, ring, Stream::kChunks);
  load_plane<C>(xb, xs, kXRows, t0 - D, t_len);
  int m = 0;
  const auto acquire = [&]() { return Stream::acquire(wt, ring, m++, Stream::kChunks); };

  float acc[WarpTiles<C, NMT>::kMw][WarpTiles<C, NMT>::kNw][4];
  // h1 = dilated conv over the owned rows: tap k reads x rows p + k D
  channel_product<C, NMT, 3>(acc, xs, 0, D, acquire);
  for_each_pair<C, NMT>(acc, [&](int p, int o, float v0, float v1) {
    *reinterpret_cast<bf162*>(hs + p * S + o) = __floats2bfloat162_rn(v0, v1);
  });
  // x + leaky(Wp . h1), in place over x's owned rows (only this lane reads
  // or writes these cells here)
  channel_product<C, NMT, 1>(acc, hs, 0, 0, acquire);
  for_each_pair<C, NMT>(acc, [&](int p, int o, float v0, float v1) {
    bf162* cell = reinterpret_cast<bf162*>(xs + (p + D) * S + o);
    const float2 old = __bfloat1622float2(*cell);
    const float a0 = round_to<bf16>(v0 >= 0.f ? v0 : slope * v0);
    const float a1 = round_to<bf16>(v1 >= 0.f ? v1 : slope * v1);
    *cell = __floats2bfloat162_rn(old.x + a0, old.y + a1);
  });
  __syncthreads();
  for (int e = threadIdx.x; e < (C / 8) * TILE; e += mma_threads<C>()) {
    const int c8 = e / TILE;
    const int p = e - c8 * TILE;
    if (t0 + p >= t_len) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(xs + (p + D) * S + 8 * c8);
    const bf16* vh = reinterpret_cast<const bf16*>(&v);
    bf16* dst = yb + static_cast<size_t>(8 * c8) * t_len + t0 + p;
#pragma unroll
    for (int c = 0; c < 8; ++c) dst[static_cast<size_t>(c) * t_len] = vh[c];
  }
}

// ---- one ResidualUnit backward --------------------------------------------

template <int C, int D, typename OutT>
__global__ void __launch_bounds__(mma_threads<C>(), promised_blocks<C>(Geometry<C, D>::kBwdSmem))
unit_backward_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ g,
                         OutT* __restrict__ dx, const bf16* __restrict__ wt,
                         const bf16* __restrict__ wd, float* __restrict__ partial, int t_len,
                         float slope, int tiles_per_row, int n_tiles) {
  using Gm = Geometry<C, D>;
  using Stream = WeightStream<C, true>;
  constexpr int TILE = Gm::kTile, S = Gm::kS, WMT = Gm::kWinMt, OMT = Gm::kOwnMt;
  extern __shared__ float4 smem4[];
  bf16* xs = reinterpret_cast<bf16*>(smem4);  // [kXRows][S] x_u, reflect-padded
  bf16* hs = xs + Gm::kXRows * S;             // [kWinRows][S] h1, then dh1
  bf16* ds = hs + Gm::kWinRows * S;           // [kWinRows][S] dh2
  bf16* ring = ds + Gm::kWinRows * S;         // [kStages][C][KC + 8] staged weights
  float* part = partial + static_cast<size_t>(blockIdx.x) * 4 * C * C;  // [dWd tap 0-2 | dWp][o][i]
  const size_t plane = static_cast<size_t>(C) * t_len;

  // the weight stream runs on across the block's tiles
  const int m_end = (n_tiles - static_cast<int>(blockIdx.x) + static_cast<int>(gridDim.x) - 1) /
                    static_cast<int>(gridDim.x) * Stream::kChunks;
  Stream::start(wt, ring, m_end);
  int m = 0;
  const auto acquire = [&]() { return Stream::acquire(wt, ring, m++, m_end); };

  float wacc[WarpTiles<C, WMT>::kMw][WarpTiles<C, WMT>::kNw][4];
  float oacc[WarpTiles<C, OMT>::kMw][WarpTiles<C, OMT>::kNw][4];
  float gacc[GramTiles<C>::kMg][GramTiles<C>::kNg][4];
  bool first = true;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile / tiles_per_row;
    const int t0 = (tile - b * tiles_per_row) * TILE;
    const float* gb = g + b * plane;
    OutT* dxb = dx + b * plane;
    // the last tile's readers of xs finished before the dx product's first
    // barrier, so the load needs none of its own
    load_plane<C>(x + b * plane, xs, Gm::kXRows, t0 - 2 * D, t_len);

    // h1 over the window: window row j, tap k reads x row j + k D.  Rows
    // outside [0, T) hold finite values that meet only dh2 = 0.
    channel_product<C, WMT, 3>(wacc, xs, 0, D, acquire);
    for_each_pair<C, WMT>(wacc, [&](int j, int o, float v0, float v1) {
      *reinterpret_cast<bf162*>(hs + j * S + o) = __floats2bfloat162_rn(v0, v1);
    });
    // h2 = Wp . h1, then dh2 = G * leaky'(h2), G = 0 outside [0, T)
    channel_product<C, WMT, 1>(wacc, hs, 0, 0, acquire);
    for_each_pair<C, WMT>(wacc, [&](int j, int o, float v0, float v1) {
      const int t = t0 - D + j;
      float g0 = 0.f, g1 = 0.f;
      if (t >= 0 && t < t_len) {
        g0 = gb[static_cast<size_t>(o) * t_len + t];
        g1 = gb[static_cast<size_t>(o + 1) * t_len + t];
      }
      *reinterpret_cast<bf162*>(ds + j * S + o) =
          __floats2bfloat162_rn(g0 * (v0 >= 0.f ? 1.f : slope), g1 * (v1 >= 0.f ? 1.f : slope));
    });
    __syncthreads();
    // dWp over the owned rows (window rows D .. D + TILE; dh2 is 0 past T)
    gram<C, OMT>(gacc, ds, D, hs, D);
    store_gram<C>(gacc, part + 3 * C * C, first);
    // dh1 = Wp^T . dh2 over the window, into hs once every warp is past the
    // gram (the product's first barrier)
    channel_product<C, WMT, 1>(wacc, ds, 0, 0, acquire);
    for_each_pair<C, WMT>(wacc, [&](int j, int i, float v0, float v1) {
      *reinterpret_cast<bf162*>(hs + j * S + i) = __floats2bfloat162_rn(v0, v1);
    });
    __syncthreads();
    // dWd[o, i, k] = sum_owned dh1[o, t] x_u[i, t + (k-1) D]: owned row p is
    // window row D + p and x row p + (k+1) D
#pragma unroll 1
    for (int k = 0; k < 3; ++k) {
      gram<C, OMT>(gacc, hs, D, xs, (k + 1) * D);
      store_gram<C>(gacc, part + k * C * C, first);
    }
    // dx_u at the owned rows: G + Wd^T applied to dh1 with tap k shifted to
    // window row p + (2-k) D, plus the reflect pad's transpose: s in [1, D]
    // takes the k = 0 tap of time D - s, s in [T-1-D, T-2] the k = 2 tap of
    // time 2(T-1) - s - D (window row = time - t0 + D)
    channel_product<C, OMT, 3>(oacc, hs, 2 * D, -D, acquire);
    const bool edge = t0 <= D || t0 + TILE >= t_len - 1 - D;
    for_each_pair<C, OMT>(oacc, [&](int p, int i, float v0, float v1) {
      const int s = t0 + p;
      if (s >= t_len) return;
      if (edge) {
        float f0 = 0.f, f1 = 0.f;
#pragma unroll 1
        for (int k = 0; k < 3; k += 2) {
          const bool in = k == 0 ? (s >= 1 && s <= D) : (s >= t_len - 1 - D && s <= t_len - 2);
          if (!in) continue;
          const bf16* h = hs + (k == 0 ? 2 * D - s - t0 : 2 * (t_len - 1) - s - t0) * S;
          for (int o = 0; o < C; ++o) {
            const float hv = __bfloat162float(h[o]);
            f0 = fmaf(__bfloat162float(wd[(o * C + i) * 3 + k]), hv, f0);
            f1 = fmaf(__bfloat162float(wd[(o * C + i + 1) * 3 + k]), hv, f1);
          }
        }
        v0 += f0;
        v1 += f1;
      }
      const size_t at = static_cast<size_t>(i) * t_len + s;
      dxb[at] = from_f32<OutT>(gb[at] + v0);
      dxb[at + t_len] = from_f32<OutT>(gb[at + t_len] + v1);
    });
    first = false;
  }
}

// out[e] = sum over blocks of partial[block][e], in block order.  The bf16
// partial is laid out [tap 0-2 | dWp][o][i] and is permuted here to
// [dWd (o, i, k) | dWp (o, i)]; the f32 one already is.
template <bool kTapMajor>
__global__ void __launch_bounds__(kThreads)
reduce_partials_kernel(const float* __restrict__ partial, float* __restrict__ out, int n_blocks, int c) {
  const int cc = c * c;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= 4 * cc) return;
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b) s += partial[static_cast<size_t>(b) * 4 * cc + e];
  if (kTapMajor) {
    const int slot = e / cc;
    const int oi = e - slot * cc;
    out[slot < 3 ? oi * 3 + slot : 3 * cc + oi] = s;
  } else {
    out[e] = s;
  }
}

// ============================================================================
// launches
// ============================================================================

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
  void* wt;  // bf16: 3 x kSlots x C^2 laid-out weights
  int n_blocks;
  int batch, t_len;
  float slope;
  cudaStream_t stream;
};

template <typename Kern>
cudaError_t set_smem(Kern kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
}

template <int C>
cudaError_t run_f32(const Args& a) {
  constexpr int TILE = f32_tile<C>();
  const int tiles_per_row = (a.t_len + TILE - 1) / TILE;
  const int n_tiles = tiles_per_row * a.batch;
  const int dils[3] = {1, 3, 9};
  cudaError_t err;

  // 1. recompute the unit inputs x1, x2
  {
    const size_t smem = fwd_smem_floats<C, TILE>() * sizeof(float);
    auto kern = unit_forward_kernel<C, TILE>;
    if ((err = set_smem(kern, smem)) != cudaSuccess) return err;
    const dim3 grid(tiles_per_row, a.batch);
    const void* ins[2] = {a.x, a.x1};
    void* outs[2] = {a.x1, a.x2};
    for (int u = 0; u < 2; ++u) {
      kern<<<grid, kThreads, smem, a.stream>>>(
          static_cast<const float*>(ins[u]), static_cast<float*>(outs[u]),
          static_cast<const float*>(a.w[2 * u]), static_cast<const float*>(a.w[2 * u + 1]), a.t_len,
          dils[u], a.slope);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
  }

  // 2. units 2, 1, 0 backward, each followed by its dW reduction
  const void* xin[3] = {a.x, a.x1, a.x2};
  const float* gin[3] = {a.g_b, a.g_a, a.g};
  float* gout[3] = {static_cast<float*>(a.dx), a.g_b, a.g_a};
  const int n = 4 * C * C;
  const size_t smem = bwd_smem_floats<C, TILE>() * sizeof(float);
  auto kern = unit_backward_kernel<C, TILE>;
  if ((err = set_smem(kern, smem)) != cudaSuccess) return err;
  for (int u = 2; u >= 0; --u) {
    kern<<<a.n_blocks, kThreads, smem, a.stream>>>(
        static_cast<const float*>(xin[u]), gin[u], gout[u], static_cast<const float*>(a.w[2 * u]),
        static_cast<const float*>(a.w[2 * u + 1]), a.partial, a.t_len, dils[u], a.slope,
        tiles_per_row, n_tiles);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    reduce_partials_kernel<false><<<(n + kThreads - 1) / kThreads, kThreads, 0, a.stream>>>(
        a.partial, a.dw + static_cast<size_t>(u) * n, a.n_blocks, C);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int C, int D>
cudaError_t launch_forward(const Args& a, const void* x, void* y, int u) {
  constexpr size_t smem = Geometry<C, D>::kFwdSmem;
  constexpr int TILE = MmaPlan<C>::kTile;
  auto kern = unit_forward_mma_kernel<C, D>;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.t_len + TILE - 1) / TILE, a.batch);
  kern<<<grid, mma_threads<C>(), smem, a.stream>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(y),
      static_cast<const bf16*>(a.wt) + static_cast<size_t>(u) * kSlots * C * C, a.t_len, a.slope);
  return cudaGetLastError();
}

template <int C, int D, typename OutT>
cudaError_t launch_backward(const Args& a, const void* x, const float* g, void* dx, int u) {
  constexpr size_t smem = Geometry<C, D>::kBwdSmem;
  constexpr int TILE = MmaPlan<C>::kTile;
  const int tiles_per_row = (a.t_len + TILE - 1) / TILE;
  auto kern = unit_backward_mma_kernel<C, D, OutT>;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<a.n_blocks, mma_threads<C>(), smem, a.stream>>>(
      static_cast<const bf16*>(x), g, static_cast<OutT*>(dx),
      static_cast<const bf16*>(a.wt) + static_cast<size_t>(u) * kSlots * C * C,
      static_cast<const bf16*>(a.w[2 * u]), a.partial, a.t_len, a.slope, tiles_per_row,
      tiles_per_row * a.batch);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int n = 4 * C * C;
  reduce_partials_kernel<true><<<(n + kThreads - 1) / kThreads, kThreads, 0, a.stream>>>(
      a.partial, a.dw + static_cast<size_t>(u) * n, a.n_blocks, C);
  return cudaGetLastError();
}

template <int C>
cudaError_t run_mma(const Args& a) {
  const int n = 3 * kSlots * C * C;
  layout_unit_weights_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, a.stream>>>(
      static_cast<const bf16*>(a.w[0]), static_cast<const bf16*>(a.w[1]),
      static_cast<const bf16*>(a.w[2]), static_cast<const bf16*>(a.w[3]),
      static_cast<const bf16*>(a.w[4]), static_cast<const bf16*>(a.w[5]), static_cast<bf16*>(a.wt), C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // 1. recompute the unit inputs x1, x2; 2. units 2, 1, 0 backward (G in
  // g, g_a, g_b; dx in x's type at the end), each with its dW reduction
  if ((err = launch_forward<C, 1>(a, a.x, a.x1, 0)) != cudaSuccess) return err;
  if ((err = launch_forward<C, 3>(a, a.x1, a.x2, 1)) != cudaSuccess) return err;
  if ((err = launch_backward<C, 9, float>(a, a.x2, a.g, a.g_a, 2)) != cudaSuccess) return err;
  if ((err = launch_backward<C, 3, float>(a, a.x1, a.g_a, a.g_b, 1)) != cudaSuccess) return err;
  return launch_backward<C, 1, bf16>(a, a.x, a.g_b, a.dx, 0);
}

// kern's launch configuration at `threads` threads and `smem` bytes a
// block: out[0..3] = blocks per SM, dynamic shared memory bytes, registers
// and local (spill) bytes per thread; *resident = the blocks that fit the
// card at once
template <typename Kern>
cudaError_t describe(Kern kern, int threads, size_t smem, int device, int* out, int* resident) {
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  cudaFuncAttributes attr;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess ||
      (err = cudaFuncGetAttributes(&attr, kern)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int vals[4] = {per_sm, static_cast<int>(smem), attr.numRegs, static_cast<int>(attr.localSizeBytes)};
  for (int i = 0; i < 4; ++i) out[i] = vals[i];
  *resident = per_sm * sms;
  return cudaSuccess;
}

// The backward kernels' launch configuration: out[0] TILE, out[1] grid
// blocks (the fewest that every unit's kernel keeps resident at once),
// out[2] tiles, then for the units at d = 9, 3, 1 describe's four values.
template <int C>
cudaError_t config(int dtype, int device, int batch, int t_len, int* out) {
  cudaError_t err;
  int blocks[3];
  if (dtype == 0) {
    constexpr int TILE = f32_tile<C>();
    constexpr size_t smem = bwd_smem_floats<C, TILE>() * sizeof(float);
    out[0] = TILE;
    for (int u = 0; u < 3; ++u)
      if ((err = describe(unit_backward_kernel<C, TILE>, kThreads, smem, device, out + 3 + 4 * u, blocks + u)) !=
          cudaSuccess)
        return err;
  } else if (dtype == 1) {
    constexpr int kT = mma_threads<C>();
    out[0] = MmaPlan<C>::kTile;
    if ((err = describe(unit_backward_mma_kernel<C, 9, float>, kT, Geometry<C, 9>::kBwdSmem, device, out + 3,
                        blocks)) != cudaSuccess ||
        (err = describe(unit_backward_mma_kernel<C, 3, float>, kT, Geometry<C, 3>::kBwdSmem, device, out + 7,
                        blocks + 1)) != cudaSuccess ||
        (err = describe(unit_backward_mma_kernel<C, 1, bf16>, kT, Geometry<C, 1>::kBwdSmem, device, out + 11,
                        blocks + 2)) != cudaSuccess)
      return err;
  } else {
    return cudaErrorInvalidValue;
  }
  out[2] = batch * ((t_len + out[0] - 1) / out[0]);
  out[1] = min(out[2], min(blocks[0], min(blocks[1], blocks[2])));
  return cudaSuccess;
}

cudaError_t config_for(int channels, int dtype, int device, int batch, int t_len, int* out) {
  switch (channels) {
    case 32: return config<32>(dtype, device, batch, t_len, out);
    case 64: return config<64>(dtype, device, batch, t_len, out);
    case 128: return config<128>(dtype, device, batch, t_len, out);
    default: return cudaErrorInvalidValue;
  }
}

template <int C>
cudaError_t run(int dtype, const Args& a) {
  if (dtype == 0) return run_f32<C>(a);
  if (dtype == 1) return run_mma<C>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The backward's launch configuration for a shape on this device, into
// out[15] (see config above).  out[1], the grid, is the number of dW
// partials: the caller allocates partial as out[1] x 4 C^2 floats.
int vx_residual_stack_backward_config(int batch, int channels, int t_len, int dtype, int device,
                                      int* out) {
  if (batch < 1 || t_len < 10) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return config_for(channels, dtype, device, batch, t_len, out);
}

// x, dx, x1, x2: (batch, channels, t_len) of one type (dtype 0 = float32,
// 1 = bfloat16); g, g_a, g_b: (batch, channels, t_len) float32; w*: the six
// effective weights in x's type, wd (C, C, 3) and wp (C, C, 1); dw: float32
// 3 x [dWd (C, C, 3) | dWp (C, C)] for units 0, 1, 2; partial: blocks x 4 C^2
// float32 with blocks from vx_residual_stack_backward_config; wt: 24 C^2
// elements of x's type (bf16 only; float32 ignores it).  x1, x2, g_a, g_b,
// partial and wt are scratch.  Launches on `stream`; returns a cudaError_t.
int vx_residual_stack_backward(const void* x, const void* g, void* dx, const void* wd0,
                               const void* wp0, const void* wd1, const void* wp1,
                               const void* wd2, const void* wp2, void* dw, void* x1, void* x2,
                               void* g_a, void* g_b, void* partial, void* wt, int blocks, int batch,
                               int channels, int t_len, int dtype, float slope, int device,
                               void* stream) {
  if (batch < 1 || t_len < 10 || blocks < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Args a{x, static_cast<const float*>(g), dx, {wd0, wp0, wd1, wp1, wd2, wp2},
               static_cast<float*>(dw), x1, x2, static_cast<float*>(g_a), static_cast<float*>(g_b),
               static_cast<float*>(partial), wt, blocks, batch, t_len, slope,
               static_cast<cudaStream_t>(stream)};
  switch (channels) {
    case 32: return run<32>(dtype, a);
    case 64: return run<64>(dtype, a);
    case 128: return run<128>(dtype, a);
    default: return cudaErrorInvalidValue;
  }
}

const char* vx_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
