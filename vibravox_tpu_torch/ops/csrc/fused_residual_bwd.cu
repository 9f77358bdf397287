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
// float32 (unit_forward_fma_kernel, unit_backward_tf32_kernel): two kinds
// of work.  K2's float32 bar (dx 1e-4, dW 2e-4 of scale against autograd of
// the plain stack in IEEE float32) needs the recomputed h2 to agree in sign
// with the plain chain's: dh2 = G * leaky'(h2) jumps by 0.99 G where h2
// changes sign, and at the training shapes some h2 lie within float32
// rounding of zero, so another rounding of h2 flips their signs (the plain
// backward with its input channels summed in another order is 1e-2 of
// scale off itself, scripts/torch_k2_f32_signs.py; a K2 with its recompute
// in 3xTF32 missed the bar so, PERF.md).  Only the masks need that
// rounding: what follows them is linear in dh2 and dh1.
//   - The recompute (x1, x2; each unit's h1 and h2 over the tile's window)
//     runs on FMAs and sums each output over input channel, then tap, one
//     fmaf a term from 0: the order of cuDNN's IEEE float32 convolutions
//     (K1's earlier FMA kernel, summing so, matched cuDNN to the bit).
//     fma_product gives each thread C / 8 output channels of NP
//     32-column groups (lane l takes column l of each), so a warp's
//     operands of X are one conflict-free wavefront at any tap shift and
//     its weights one broadcast float4 each; the weights stream in by
//     cp.async, KI reduction rows a chunk, through the ring that also
//     feeds the products.  Each accumulator still sees its terms in the
//     plain order, and x + leaky(h2) rounds as the plain chain's (no
//     contraction), so each h2 rounds as the plain chain's and its leaky'
//     mask takes that sign.
//   - The gradient products (dWp = dh2 h1^T, dh1 = Wp^T dh2, dWd[., ., k] =
//     dh1 x_u^T shifted by (k-1) D, dx = Wd^T dh1 shifted by tap) run on
//     mma.sync m16n8k8 in 3xTF32 (common.cuh: each operand split into TF32
//     hi and lo, lo.hi + hi.lo + hi.hi into a fresh sum a k8 step, added to
//     the accumulator in f32, as K1's), each product issued for all of a
//     warp's tile pairs before the next (tf32_pairs: ptxas otherwise left
//     dependent mmas a few instructions apart).  The channel products (dh1,
//     dx) take M from the weights (rows are their output channels, A by
//     ldmatrix.x4 from chunks [C][KC + 4]) and N from time; the grams
//     (dWp, dWd) take M and N from channels and reduce over the owned
//     time rows.
//   - Planes are channel-major float32: x_u with a 2D halo (reflect-
//     padded), dh2, and h1 then dh1 over the window.  Channel ch's row
//     starts at ch S + 4 (bit 2 of ch), S = 8 mod 16, so that the grams'
//     fragments (8 channels x 4 times) and the channel products' (4
//     channels x 8 times) are both conflict-free scalar loads at any time
//     offset, the taps' shifts included.  G stays in global memory, read
//     by the dh2 and dx epilogues, time along the lanes.
//   - dW: each block's float32 partial [tap 0-2 | dWp][o][i], written by
//     one lane a cell a tile, summed by reduce_partials in block order, as
//     in bf16.  The reflect pad's fold terms of dx ride in dx's product: on
//     an edge tile, tap 0's B at s in [1, D] is dh1 at s's own column plus
//     dh1 at the mirrored one (tap 2's likewise at the right edge), added
//     in f32 before the split, so the pad's transpose stays exact and costs
//     an edge tile a load and an add a B value (no lane loops over the
//     channels while its block waits); dx = G + the product.
//   - Plans (F32Plan<C>): owned rows TILE, the forward's FWD_TILE, the
//     chunks' KI and KC, MT (how the warps split the channel products),
//     blocks per SM.
// tests/test_torch_residual_bwd_tf32.py emulates this walk in float64,
// the recompute's order and the products' TF32 split included.
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
// so arithmetic bounds it: at 989 TFLOP/s for bf16, and for float32 at
// 165 TFLOP/s, f32-accurate products in 3xTF32 (chip_smoke.py's bound).
// The float32 design's own bound is higher: its recompute is 40 C^2 T B
// FLOP (x1 and x2 once, and h1, h2 again in each unit's backward) on FMAs
// at 67 TFLOP/s, beside its 48 C^2 T B FLOP of products in 3xTF32.
// The per-tile partial read-modify-write (4 C^2 floats each way) is the
// traffic that grows with C: 512 KB a tile at C = 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // the f32 kernels' and the helper launches' blocks

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
// float32: the recompute on FMAs, the gradient products on 3xTF32 tensor cores
// ============================================================================

// Per channel count: TILE (owned time rows of a backward block, whole k8
// steps), FWD_TILE (time rows of a forward block, whole 32-row columns),
// KI (reduction rows of a recompute weight chunk), KC (reduction columns
// of a product weight chunk), MT (m16 tiles a warp of the channel products
// takes) and the blocks per SM the backward's __launch_bounds__ promises
// (at most what shared memory allows; the forward promises two where they
// fit).
template <int C>
struct F32Plan;
template <>
struct F32Plan<32> {
  static constexpr int kTile = 192, kFwdTile = 256, kKi = 16, kKc = 32, kMt = 2, kBlocks = 2;
};
template <>
struct F32Plan<64> {
  static constexpr int kTile = 88, kFwdTile = 128, kKi = 8, kKc = 16, kMt = 2, kBlocks = 2;
};
template <>
struct F32Plan<128> {
  static constexpr int kTile = 88, kFwdTile = 64, kKi = 8, kKc = 16, kMt = 4, kBlocks = 1;
};

constexpr int kWarps = kThreads / 32;
constexpr int kF32Stages = 2;  // the float32 weight ring: one chunk in flight while one is used

// A float32 plane is channel-major: channel ch's columns (times) start at
// ch S + 4 (bit 2 of ch), with S = 8 mod 16 and room for the 4.  Eight
// channels from a multiple of 8 then start in banks {0, 8, 16, 24} and
// {4, 12, 20, 28} (+ a constant), so both fragment shapes the products
// load are conflict-free at any column offset: 8 channels x 4 consecutive
// columns (lanes g, q: the grams, whose K is time) and 4 channels x 8
// consecutive columns (lanes q, g: the channel products, whose K is the
// channel); a warp's 32 consecutive columns of one channel (the
// recompute) are too.
__host__ __device__ constexpr int plane_stride(int cols) { return (cols + 4 + 7) / 16 * 16 + 8; }
__device__ __forceinline__ int plane_row(int ch, int stride) { return ch * stride + (ch & 4); }

// floats of one buffer of the weight ring: a recompute chunk [tap][KI][C]
// or a product chunk [C][KC + 4]
template <int C>
__host__ __device__ constexpr int f32_buffer_floats() {
  return 3 * F32Plan<C>::kKi * C > C * (F32Plan<C>::kKc + 4) ? 3 * F32Plan<C>::kKi * C
                                                               : C * (F32Plan<C>::kKc + 4);
}

// A block's planes at dilation D.  Backward: x_u columns are time t0 - 2D
// + j (TILE + 4D of them), window columns (h1 then dh1, dh2) time t0 - D +
// j over whole n8 tiles covering TILE + 2D.  Forward: x columns are time
// t0 - D + j (FWD_TILE + 2D of them), h1 columns time t0 + j.
template <int C, int D>
struct F32Geometry {
  using P = F32Plan<C>;
  static constexpr int kTile = P::kTile;
  static constexpr int kWin = kTile + 2 * D;
  static constexpr int kWinNt = (kWin + 7) / 8;
  static constexpr int kSx = plane_stride(kTile + 4 * D);
  static constexpr int kSw = plane_stride(8 * kWinNt);
  static constexpr size_t kRing = static_cast<size_t>(kF32Stages) * f32_buffer_floats<C>() * sizeof(float);
  static constexpr size_t kBwdSmem = static_cast<size_t>(C) * (kSx + 2 * kSw) * sizeof(float) + kRing;
  static constexpr int kFwdSx = plane_stride(P::kFwdTile + 2 * D);
  static constexpr int kFwdSh = plane_stride(P::kFwdTile);
  static constexpr size_t kFwdSmem = static_cast<size_t>(C) * (kFwdSx + kFwdSh) * sizeof(float) + kRing;
  static_assert(kTile % 8 == 0, "the owned rows are whole k8 steps and n8 tiles");
  static_assert(P::kFwdTile % 32 == 0, "the forward tile is whole 32-row columns");
};

// the blocks per SM a float32 kernel's __launch_bounds__ promises: at most
// `most`, and at most what shared memory allows
__host__ __device__ constexpr int f32_blocks(size_t smem_bytes, int most) {
  return blocks_per_sm(smem_bytes) < most ? blocks_per_sm(smem_bytes) : most;
}

// The float32 weights of each unit as four [r][o] slots, r the reduction
// channel of the recompute and the row of the products' A: slot k < 3 =
// Wd[o, r, k], slot 3 = Wp[o, r].  wt[unit][slot][r][o] from the six
// torch-layout weights.
__global__ void __launch_bounds__(kThreads)
layout_unit_weights_f32_kernel(const float* __restrict__ wd0, const float* __restrict__ wp0,
                               const float* __restrict__ wd1, const float* __restrict__ wp1,
                               const float* __restrict__ wd2, const float* __restrict__ wp2,
                               float* __restrict__ wt, int c) {
  const int cc = c * c;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= 12 * cc) return;
  const int u = e / (4 * cc);
  const int rem = e - u * 4 * cc;
  const int slot = rem / cc;
  const int r = (rem - slot * cc) / c;
  const int o = rem - slot * cc - r * c;
  const float* wd = u == 0 ? wd0 : u == 1 ? wd1 : wd2;
  const float* wp = u == 0 ? wp0 : u == 1 ? wp1 : wp2;
  wt[e] = slot < 3 ? wd[(o * c + r) * 3 + slot] : wp[o * c + r];
}

// A tile's weight chunks in the order its products take them: the
// recompute's h1 (slots 0-2, KI rows a chunk, as [tap][KI][C]) and h2 (slot
// 3, [KI][C]); in the backward then dh1's A (slot 3, KC columns a chunk, as
// [C][KC + 4]) and dx's (for each KC block of columns, taps 0-2).  A block
// takes chunk m of its sequence over its tiles from buffer m % kStages of
// its ring, with kStages - 1 chunks in flight and one barrier a chunk, as
// the bf16 WeightStream.
template <int C, bool kBackward>
struct F32Stream {
  using P = F32Plan<C>;
  static constexpr int kKi = P::kKi, kKc = P::kKc, kStages = kF32Stages;
  static constexpr int kRowChunks = C / kKi, kColChunks = C / kKc;
  static constexpr int kChunks = 2 * kRowChunks + (kBackward ? 4 * kColChunks : 0);
  static constexpr int kBuf = f32_buffer_floats<C>();
  static_assert(kStages >= 2, "the ring needs a buffer to fill while one is used");
  static_assert(C % kKi == 0 && C % kKc == 0 && kKc % 8 == 0, "the chunks must divide C");

  static __device__ __forceinline__ void issue(const float* __restrict__ wt, float* ring, int m, int m_end) {
    if (m < m_end) {
      const int n = m % kChunks;
      float* buf = ring + (m % kStages) * kBuf;
      if (n < 2 * kRowChunks) {
        const bool point = n >= kRowChunks;
        const int r0 = (point ? n - kRowChunks : n) * kKi;
        constexpr int kPieces = kKi * C / 4;  // 16-byte pieces of one slot's KI rows
        for (int e = threadIdx.x; e < (point ? 1 : 3) * kPieces; e += kThreads) {
          const int k = e / kPieces;
          const int p = e - k * kPieces;
          cp_async16(buf + k * kKi * C + 4 * p, wt + (static_cast<size_t>(point ? 3 : k) * C + r0) * C + 4 * p);
        }
      } else {
        int blk = n - 2 * kRowChunks, slot = 3;
        if (blk >= kColChunks) {
          blk -= kColChunks;
          slot = blk % 3;
          blk /= 3;
        }
        constexpr int kPieces = kKc / 4;  // 16-byte pieces of a row
        for (int e = threadIdx.x; e < C * kPieces; e += kThreads) {
          const int row = e / kPieces;
          const int p = e - row * kPieces;
          cp_async16(buf + row * (kKc + 4) + 4 * p,
                     wt + (static_cast<size_t>(slot) * C + row) * C + blk * kKc + 4 * p);
        }
      }
    }
    cp_async_commit();
  }

  static __device__ __forceinline__ void start(const float* __restrict__ wt, float* ring, int m_end) {
#pragma unroll
    for (int m = 0; m < kStages - 1; ++m) issue(wt, ring, m, m_end);
  }

  static __device__ __forceinline__ const float* acquire(const float* __restrict__ wt, float* ring, int m,
                                                        int m_end) {
    cp_async_wait_pending<kStages - 2>();
    __syncthreads();
    issue(wt, ring, m + kStages - 1, m_end);
    return ring + (m % kStages) * kBuf;
  }
};

// One recompute product on FMAs over columns [0, n_pos) of the output:
//     Y[o][p] = sum_r sum_{k < KT} W_k[r][o] X[r][p + k STEP]
// each Y one chain of fmaf from 0 over r ascending, then k: the order in
// which the plain convolutions sum (cuDNN's IEEE float32; K1's earlier FMA
// kernel, summing so, matched cuDNN to the bit), so the recomputed h2 take
// the plain chain's signs.  Warp w owns the C / 8 output channels from
// w C / 8 and NP 32-column groups; lane l takes column l of each, so an
// operand of X is 32 consecutive floats of a plane row for the warp (one
// wavefront at any offset) and a weight one broadcast.  Columns past
// n_pos read column n_pos - 1 and are not stored.  Every thread of the
// block must call it (acquire synchronises).
template <int C, int KT, int STEP, int NP, typename Acquire, typename Epilogue>
__device__ __forceinline__ void fma_product(const float* X, int sx, int n_pos, Acquire& acquire,
                                            Epilogue epilogue) {
  constexpr int KI = F32Plan<C>::kKi, MO = C / kWarps;
  static_assert(MO % 4 == 0, "a warp's output channels are whole float4s");
  const int lane = threadIdx.x & 31;
  const int o0 = (threadIdx.x >> 5) * MO;
  int col[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) col[j] = min(32 * j + lane, n_pos - 1);
  float acc[MO][NP];
#pragma unroll
  for (int m = 0; m < MO; ++m)
#pragma unroll
    for (int j = 0; j < NP; ++j) acc[m][j] = 0.f;
#pragma unroll 1
  for (int r0 = 0; r0 < C; r0 += KI) {
    const float* w = acquire();  // [KT][KI][C]
#pragma unroll
    for (int ii = 0; ii < KI; ++ii) {
      const float* xr = X + plane_row(r0 + ii, sx);
#pragma unroll
      for (int k = 0; k < KT; ++k) {
        float xv[NP], wv[MO];
#pragma unroll
        for (int j = 0; j < NP; ++j) xv[j] = xr[col[j] + k * STEP];
#pragma unroll
        for (int m4 = 0; m4 < MO / 4; ++m4) {
          const float4 v = *reinterpret_cast<const float4*>(w + (k * KI + ii) * C + o0 + 4 * m4);
          wv[4 * m4] = v.x;
          wv[4 * m4 + 1] = v.y;
          wv[4 * m4 + 2] = v.z;
          wv[4 * m4 + 3] = v.w;
        }
#pragma unroll
        for (int m = 0; m < MO; ++m)
#pragma unroll
          for (int j = 0; j < NP; ++j) acc[m][j] = fmaf(wv[m], xv[j], acc[m][j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const int p = 32 * j + lane;
    if (p < n_pos) {
#pragma unroll
      for (int m = 0; m < MO; ++m) epilogue(o0 + m, p, acc[m][j]);
    }
  }
}

// How the warps share a channel product of NNT n8 tiles: kWm warps along M
// (kMt m16 tiles each, blocked), kWn along N; a warp takes n-tiles wn, wn +
// kWn, ... below NNT.
template <int C, int NNT>
struct F32Tiles {
  static constexpr int kMt = F32Plan<C>::kMt;
  static constexpr int kWm = C / 16 / kMt;
  static constexpr int kWn = kWarps / kWm;
  static constexpr int kNt = (NNT + kWn - 1) / kWn;
  static constexpr bool kExact = NNT % kWn == 0;  // every warp's n-tiles exist
  static_assert(16 * kMt * kWm == C && kWarps % kWm == 0, "the warps must share the m-tiles evenly");
};

// d[i] = A_i . B_i on 3xTF32 for P independent tile pairs of k8 steps,
// each into a fresh sum: lo.hi, then hi.lo, then hi.hi, each product
// issued for every pair before the next, so that an mma waits on one of
// its own sum only P mmas later (ptxas keeps dependent mmas of one pair a
// few instructions apart otherwise).  The callers add d to their
// accumulators in f32.
template <int P>
__device__ __forceinline__ void tf32_pairs(float (&d)[P][4], const uint32_t (&ah)[P][4], const uint32_t (&al)[P][4],
                                           const uint32_t (&bh)[P][2], const uint32_t (&bl)[P][2]) {
#pragma unroll
  for (int i = 0; i < P; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[i][e] = 0.f;
#pragma unroll
  for (int i = 0; i < P; ++i) mma_tf32(d[i], al[i], bh[i]);
#pragma unroll
  for (int i = 0; i < P; ++i) mma_tf32(d[i], ah[i], bl[i]);
#pragma unroll
  for (int i = 0; i < P; ++i) mma_tf32(d[i], ah[i], bh[i]);
}

// acc = A . B on 3xTF32 over a channel product: M the C rows of the
// streamed weight chunks ([row][KC + 4]: the product's output channels), N
// NNT n8 tiles of plane columns, K the C reduction channels (plane rows) of
// each of KT taps, tap k's columns from col0 + k tap_step.  A from the
// chunk by ldmatrix.x4 (on 32-bit data it hands out TF32's A registers); B
// from the plane, a float a register: b0 = (row q, column g), b1 = (row q
// + 4, column g).  Each k8 step's three products go to a fresh sum that is
// added to the accumulator in f32, as K1's; each product is issued for
// every tile of the warp before the next (tf32_pairs), so that an mma
// waits on one of its own sum only MT x NT mmas later.  mirror(k, n), for
// output column n of tap k, gives a second plane column whose value is
// added to B's before the split, or -1 (dx's reflect fold terms).
template <int C, int KT, int NNT, typename Acquire, typename Mirror>
__device__ __forceinline__ void tc_channel_product(float (&acc)[F32Tiles<C, NNT>::kMt][F32Tiles<C, NNT>::kNt][4],
                                                   const float* plane, int sp, int col0, int tap_step,
                                                   Acquire& acquire, Mirror mirror) {
  using W = F32Tiles<C, NNT>;
  constexpr int KC = F32Plan<C>::kKc, MT = W::kMt, NT = W::kNt, WS = KC + 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int m0 = (warp / W::kWn) * MT * 16, wn = warp % W::kWn;
  // ldmatrix.x4 row addresses: A's four 8 x 4 matrices are (rows 0-7 |
  // 8-15) x (k 0-3 | 4-7) as a0..a3
  const int a_r = (lane & 7) + ((lane >> 3) & 1) * 8, a_c = (lane >> 4) * 4;
#pragma unroll
  for (int a = 0; a < MT; ++a)
#pragma unroll
    for (int b = 0; b < NT; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][b][e] = 0.f;
#pragma unroll 1
  for (int k0 = 0; k0 < C; k0 += KC) {
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      const float* w = acquire();
      const int c0 = col0 + k * tap_step + g;
#pragma unroll
      for (int ks = 0; ks < KC; ks += 8) {
        uint32_t ah[MT][4], al[MT][4];
#pragma unroll
        for (int a = 0; a < MT; ++a) {
          uint32_t v[4];
          ldmatrix_x4(v, w + (m0 + 16 * a + a_r) * WS + ks + a_c);
          split_tf32(v, ah[a], al[a]);
        }
        const float* r0 = plane + plane_row(k0 + ks + q, sp) + c0;
        const float* r1 = plane + plane_row(k0 + ks + q + 4, sp) + c0;
        uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
        for (int b = 0; b < NT; ++b) {
          const int nt = min(wn + W::kWn * b, NNT - 1);  // a tile past NNT loads the last one and drops it
          float v0 = r0[8 * nt], v1 = r1[8 * nt];
          const int mc = mirror(k, 8 * nt + g);
          if (mc >= 0) {
            v0 += plane[plane_row(k0 + ks + q, sp) + mc];
            v1 += plane[plane_row(k0 + ks + q + 4, sp) + mc];
          }
          const uint32_t v[2] = {__float_as_uint(v0), __float_as_uint(v1)};
          split_tf32(v, bh[b], bl[b]);
        }
        // the MT x NT pairs (m-tile a, n-tile b) in one set of passes
        uint32_t pah[MT * NT][4], pal[MT * NT][4], pbh[MT * NT][2], pbl[MT * NT][2];
#pragma unroll
        for (int a = 0; a < MT; ++a)
#pragma unroll
          for (int b = 0; b < NT; ++b) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              pah[a * NT + b][e] = ah[a][e];
              pal[a * NT + b][e] = al[a][e];
            }
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              pbh[a * NT + b][e] = bh[b][e];
              pbl[a * NT + b][e] = bl[b][e];
            }
          }
        float d[MT * NT][4];
        tf32_pairs<MT * NT>(d, pah, pal, pbh, pbl);
#pragma unroll
        for (int a = 0; a < MT; ++a)
#pragma unroll
          for (int b = 0; b < NT; ++b)
            if (W::kExact || wn + W::kWn * b < NNT)  // the same for the whole warp
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[a][b][e] += d[a * NT + b][e];
      }
    }
  }
}

// f(row, column, v0, v1) for each pair of a warp's channel-product
// accumulators: (row, column) and (row, column + 1)
template <int C, int NNT, typename F>
__device__ __forceinline__ void for_each_tc_pair(const float (&acc)[F32Tiles<C, NNT>::kMt][F32Tiles<C, NNT>::kNt][4],
                                                 F f) {
  using W = F32Tiles<C, NNT>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int m0 = (warp / W::kWn) * W::kMt * 16, wn = warp % W::kWn;
#pragma unroll
  for (int a = 0; a < W::kMt; ++a)
#pragma unroll
    for (int b = 0; b < W::kNt; ++b) {
      const int nt = wn + W::kWn * b;
      if (!W::kExact && nt >= NNT) continue;
      f(m0 + 16 * a + g, 8 * nt + 2 * q, acc[a][b][0], acc[a][b][1]);
      f(m0 + 16 * a + g + 8, 8 * nt + 2 * q, acc[a][b][2], acc[a][b][3]);
    }
}

// The gram products' warps: 2 (o) x 4 (i), each a block of kMg m16 tiles
// by kNg n8 tiles of the C x C output, o0 = 16 kMg (warp / 4), i0 = 8 kNg
// (warp % 4); kKu k-steps go through one set of 3xTF32 passes.
template <int C>
struct F32Gram {
  static constexpr int kMg = C / 32, kNg = C / 32;
  static constexpr int kKu = 128 / C;  // k-steps a set of passes: 4 / 8 / 16 pairs at C = 32 / 64 / 128
  static_assert(kWarps == 8, "the grams' warps are 2 x 4");
};

// acc[o][i] = sum over KSTEPS k8 steps of A[o][col_a + t] B[i][col_b + t]
// (planes a and b; the reduction runs over time), on 3xTF32: a0 = (row g,
// column q), a1 = (g + 8, q), a2 = (g, q + 4), a3 = (g + 8, q + 4); b0 =
// (row g, column q), b1 = (g, q + 4).  kKu k-steps go through tf32_pairs
// together, as kKu x MG x NG tile pairs, so that a warp has at least 4
// independent sums in flight; their fresh sums are added in k-step order.
template <int C, int KSTEPS>
__device__ __forceinline__ void tc_gram(float (&acc)[F32Gram<C>::kMg][F32Gram<C>::kNg][4], const float* a,
                                        int sa, int col_a, const float* b, int sb, int col_b) {
  constexpr int MG = F32Gram<C>::kMg, NG = F32Gram<C>::kNg, KU = F32Gram<C>::kKu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int o0 = (warp >> 2) * 16 * MG, i0 = (warp & 3) * 8 * NG;
  const float* ar[MG][2];
  const float* br[NG];
#pragma unroll
  for (int m = 0; m < MG; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) ar[m][h] = a + plane_row(o0 + 16 * m + g + 8 * h, sa) + col_a + q;
#pragma unroll
  for (int n = 0; n < NG; ++n) br[n] = b + plane_row(i0 + 8 * n + g, sb) + col_b + q;
#pragma unroll
  for (int m = 0; m < MG; ++m)
#pragma unroll
    for (int n = 0; n < NG; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
#pragma unroll 1
  for (int ks0 = 0; ks0 < KSTEPS; ks0 += KU) {
    // the KU x MG x NG pairs (step u, m-tile m, n-tile n) in one set of passes
    constexpr int P = KU * MG * NG;
    uint32_t ah[P][4], al[P][4], bh[P][2], bl[P][2];
#pragma unroll
    for (int u = 0; u < KU; ++u) {
      const int t = 8 * min(ks0 + u, KSTEPS - 1);  // a step past KSTEPS loads the last one and drops it
      uint32_t fbh[NG][2], fbl[NG][2];
#pragma unroll
      for (int n = 0; n < NG; ++n) {
        const uint32_t v[2] = {__float_as_uint(br[n][t]), __float_as_uint(br[n][t + 4])};
        split_tf32(v, fbh[n], fbl[n]);
      }
#pragma unroll
      for (int m = 0; m < MG; ++m) {
        const uint32_t v[4] = {__float_as_uint(ar[m][0][t]), __float_as_uint(ar[m][1][t]),
                               __float_as_uint(ar[m][0][t + 4]), __float_as_uint(ar[m][1][t + 4])};
        uint32_t fah[4], fal[4];
        split_tf32(v, fah, fal);
#pragma unroll
        for (int n = 0; n < NG; ++n) {
          const int i = (u * MG + m) * NG + n;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ah[i][e] = fah[e];
            al[i][e] = fal[e];
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            bh[i][e] = fbh[n][e];
            bl[i][e] = fbl[n][e];
          }
        }
      }
    }
    float d[P][4];
    tf32_pairs<P>(d, ah, al, bh, bl);
#pragma unroll
    for (int u = 0; u < KU; ++u)
      if (ks0 + u < KSTEPS)
#pragma unroll
        for (int m = 0; m < MG; ++m)
#pragma unroll
          for (int n = 0; n < NG; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[m][n][e] += d[(u * MG + m) * NG + n][e];
  }
}

// the warp's gram block into out ([o][i], C x C) of the block's partial:
// written on the block's first tile, added to after; every cell by one
// lane, once a tile, so the partial's order is fixed
template <int C>
__device__ __forceinline__ void store_gram_f32(float (&acc)[F32Gram<C>::kMg][F32Gram<C>::kNg][4], float* out,
                                               bool first) {
  constexpr int MG = F32Gram<C>::kMg, NG = F32Gram<C>::kNg;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int o0 = (warp >> 2) * 16 * MG, i0 = (warp & 3) * 8 * NG;
#pragma unroll
  for (int m = 0; m < MG; ++m)
#pragma unroll
    for (int n = 0; n < NG; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float2* cell = reinterpret_cast<float2*>(out + (o0 + 16 * m + g + 8 * h) * C + i0 + 8 * n + 2 * q);
        float2 v = make_float2(acc[m][n][2 * h], acc[m][n][2 * h + 1]);
        if (!first) {
          const float2 old = *cell;
          v = make_float2(old.x + v.x, old.y + v.y);
        }
        *cell = v;
      }
}

// columns [0, COLS) of channel-major plane rows from NCW x (one batch
// row), column j being time t_first + j reflect-clamped: eight loads in
// flight a thread before their stores
template <int C, int COLS>
__device__ __forceinline__ void load_f32_plane(const float* __restrict__ xb, float* plane, int stride, int t_first,
                                               int t_len) {
  constexpr int kBatch = 8, kN = C * COLS;
#pragma unroll 1
  for (int e0 = threadIdx.x; e0 < kN; e0 += kBatch * kThreads) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kThreads;
      const int c = e / COLS;
      if (e < kN) v[u] = xb[static_cast<size_t>(c) * t_len + reflect_clamped(t_first + e - c * COLS, t_len)];
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kThreads;
      const int c = e / COLS;
      if (e < kN) plane[plane_row(c, stride) + e - c * COLS] = v[u];
    }
  }
}

// ---- one ResidualUnit forward (the recompute of x1 and x2) ----------------

template <int C, int D>
__global__ void __launch_bounds__(kThreads, f32_blocks(F32Geometry<C, D>::kFwdSmem, 2))
unit_forward_fma_kernel(const float* __restrict__ x, float* __restrict__ y, const float* __restrict__ wt,
                        int t_len, float slope) {
  using Gm = F32Geometry<C, D>;
  using Stream = F32Stream<C, false>;
  constexpr int TILE = F32Plan<C>::kFwdTile, SX = Gm::kFwdSx, SH = Gm::kFwdSh, NP = TILE / 32;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [C][SX] unit input: column j is time t0 - D + j
  float* hs = xs + C * SX;                      // [C][SH] h1: column p is time t0 + p
  float* ring = hs + C * SH;

  const int t0 = blockIdx.x * TILE;
  const size_t plane = static_cast<size_t>(C) * t_len;
  const float* xb = x + blockIdx.y * plane;
  float* yb = y + blockIdx.y * plane;

  Stream::start(wt, ring, Stream::kChunks);
  load_f32_plane<C, TILE + 2 * D>(xb, xs, SX, t0 - D, t_len);
  int m = 0;
  const auto acquire = [&]() { return Stream::acquire(wt, ring, m++, Stream::kChunks); };

  // h1: tap k of column p reads x column p + k D
  fma_product<C, 3, D, NP>(xs, SX, TILE, acquire, [&](int o, int p, float v) { hs[plane_row(o, SH) + p] = v; });
  // x + leaky(Wp . h1), each rounding as the plain chain's
  fma_product<C, 1, 0, NP>(hs, SH, TILE, acquire, [&](int o, int p, float v) {
    if (t0 + p < t_len)
      yb[static_cast<size_t>(o) * t_len + t0 + p] =
          __fadd_rn(xs[plane_row(o, SX) + p + D], v >= 0.f ? v : __fmul_rn(slope, v));
  });
}

// ---- one ResidualUnit backward --------------------------------------------

// kProducts = false stops each tile after its recompute (h1, h2 and dh2
// over the window), writing no dW and no dx but one cell a tile: a timing
// aid (vx_residual_stack_backward's dtype 2), on no path.
template <int C, int D, bool kProducts>
__global__ void __launch_bounds__(kThreads, f32_blocks(F32Geometry<C, D>::kBwdSmem, F32Plan<C>::kBlocks))
unit_backward_tf32_kernel(const float* __restrict__ x, const float* __restrict__ g, float* __restrict__ dx,
                          const float* __restrict__ wt, float* __restrict__ partial, int t_len, float slope,
                          int tiles_per_row, int n_tiles) {
  using Gm = F32Geometry<C, D>;
  using Stream = F32Stream<C, kProducts>;
  constexpr int TILE = Gm::kTile, WIN = Gm::kWin, SX = Gm::kSx, SW = Gm::kSw;
  constexpr int NP = (WIN + 31) / 32;  // the recompute's columns a lane
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [C][SX] x_u: column j is time t0 - 2D + j, reflect-padded
  float* ds = xs + C * SX;                      // [C][SW] dh2: column j is time t0 - D + j
  float* hs = ds + C * SW;                      // [C][SW] h1, then dh1, as dh2
  float* ring = hs + C * SW;                    // [kStages][buffer] staged weights
  float* part = partial + static_cast<size_t>(blockIdx.x) * 4 * C * C;  // [dWd tap 0-2 | dWp][o][i]
  const size_t plane = static_cast<size_t>(C) * t_len;

  // the weight stream runs on across the block's tiles
  const int m_end = (n_tiles - static_cast<int>(blockIdx.x) + static_cast<int>(gridDim.x) - 1) /
                    static_cast<int>(gridDim.x) * Stream::kChunks;
  Stream::start(wt, ring, m_end);
  int m = 0;
  const auto acquire = [&]() { return Stream::acquire(wt, ring, m++, m_end); };

  bool first = true;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile / tiles_per_row;
    const int t0 = (tile - b * tiles_per_row) * TILE;
    const float* gb = g + b * plane;
    float* dxb = dx + b * plane;
    // the last tile's readers of xs finished before its dx product's first
    // barrier, so the load needs none of its own
    load_f32_plane<C, TILE + 4 * D>(x + b * plane, xs, SX, t0 - 2 * D, t_len);

    // h1 over the window: column j, tap k reads x column j + k D; 0
    // outside [0, T), where it meets only dh2 = 0
    fma_product<C, 3, D, NP>(xs, SX, WIN, acquire, [&](int o, int p, float v) {
      const int t = t0 - D + p;
      hs[plane_row(o, SW) + p] = (t >= 0 && t < t_len) ? v : 0.f;
    });
    // h2 = Wp . h1, then dh2 = G * leaky'(h2), G = 0 outside [0, T)
    fma_product<C, 1, 0, NP>(hs, SW, WIN, acquire, [&](int o, int p, float v) {
      const int t = t0 - D + p;
      const float gv = (t >= 0 && t < t_len) ? gb[static_cast<size_t>(o) * t_len + t] : 0.f;
      ds[plane_row(o, SW) + p] = gv * (v >= 0.f ? 1.f : slope);
    });
    if constexpr (!kProducts) {
      // one read of dh2 at a column the compiler cannot know keeps every
      // dh2 store, and the h2 pass with it
      if (threadIdx.x == 0) dxb[t0] = ds[plane_row(t0 % C, SW) + D];
      continue;
    }
    __syncthreads();
    // dWp over the owned rows (window columns D .. D + TILE; dh2 is 0 past T)
    {
      float acc[F32Gram<C>::kMg][F32Gram<C>::kNg][4];
      tc_gram<C, TILE / 8>(acc, ds, SW, D, hs, SW, D);
      store_gram_f32<C>(acc, part + 3 * C * C, first);
    }
    // dh1 = Wp^T . dh2 over the window's n8 tiles, into hs once every warp
    // is past the gram (the product's first barrier); the columns past the
    // window meet nothing
    {
      float acc[F32Tiles<C, Gm::kWinNt>::kMt][F32Tiles<C, Gm::kWinNt>::kNt][4];
      tc_channel_product<C, 1, Gm::kWinNt>(acc, ds, SW, 0, 0, acquire, [](int, int) { return -1; });
      for_each_tc_pair<C, Gm::kWinNt>(acc, [&](int i, int j, float v0, float v1) {
        *reinterpret_cast<float2*>(hs + plane_row(i, SW) + j) = make_float2(v0, v1);
      });
    }
    __syncthreads();
    // dWd[o, i, k] = sum_owned dh1[o, t] x_u[i, t + (k-1) D]: owned row p is
    // window column D + p and x column p + (k+1) D
#pragma unroll 1
    for (int k = 0; k < 3; ++k) {
      float acc[F32Gram<C>::kMg][F32Gram<C>::kNg][4];
      tc_gram<C, TILE / 8>(acc, hs, SW, D, xs, SX, (k + 1) * D);
      store_gram_f32<C>(acc, part + k * C * C, first);
    }
    // dx_u at the owned rows: G + Wd^T applied to dh1 with tap k at window
    // column p + (2-k) D, plus the reflect pad's transpose, folded into B:
    // s in [1, D] takes the k = 0 tap of time D - s too, s in [T-1-D, T-2]
    // the k = 2 tap of time 2(T-1) - s - D (window column = time - t0 + D)
    {
      float acc[F32Tiles<C, TILE / 8>::kMt][F32Tiles<C, TILE / 8>::kNt][4];
      const bool edge = t0 <= D || t0 + TILE >= t_len - 1 - D;
      tc_channel_product<C, 3, TILE / 8>(acc, hs, SW, 2 * D, -D, acquire, [&](int k, int p) {
        const int s = t0 + p;
        if (!edge) return -1;
        if (k == 0 && s >= 1 && s <= D) return 2 * D - s - t0;
        if (k == 2 && s >= t_len - 1 - D && s <= t_len - 2) return 2 * (t_len - 1) - s - t0;
        return -1;
      });
      for_each_tc_pair<C, TILE / 8>(acc, [&](int i, int p, float v0, float v1) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int s = t0 + p + h;
          if (s >= t_len) continue;
          const size_t at = static_cast<size_t>(i) * t_len + s;
          dxb[at] = gb[at] + (h ? v1 : v0);
        }
      });
    }
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

// out[e] = sum over blocks of partial[block][e], in block order.  Each
// block's partial is laid out [tap 0-2 | dWp][o][i] and is permuted here to
// [dWd (o, i, k) | dWp (o, i)].
__global__ void __launch_bounds__(kThreads)
reduce_partials_kernel(const float* __restrict__ partial, float* __restrict__ out, int n_blocks, int c) {
  const int cc = c * c;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= 4 * cc) return;
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b) s += partial[static_cast<size_t>(b) * 4 * cc + e];
  const int slot = e / cc;
  const int oi = e - slot * cc;
  out[slot < 3 ? oi * 3 + slot : 3 * cc + oi] = s;
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
  void* wt;  // laid-out weights: bf16 3 x kSlots x C^2, float32 3 x 4 x C^2
  int n_blocks;
  int batch, t_len;
  float slope;
  cudaStream_t stream;
};

template <typename Kern>
cudaError_t set_smem(Kern kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
}

// the dW reduction of one unit's backward
cudaError_t launch_reduce(const Args& a, int u, int c) {
  const int n = 4 * c * c;
  reduce_partials_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, a.stream>>>(
      a.partial, a.dw + static_cast<size_t>(u) * n, a.n_blocks, c);
  return cudaGetLastError();
}

template <int C, int D>
cudaError_t launch_forward_f32(const Args& a, const void* x, void* y, int u) {
  constexpr size_t smem = F32Geometry<C, D>::kFwdSmem;
  constexpr int TILE = F32Plan<C>::kFwdTile;
  auto kern = unit_forward_fma_kernel<C, D>;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.t_len + TILE - 1) / TILE, a.batch);
  kern<<<grid, kThreads, smem, a.stream>>>(static_cast<const float*>(x), static_cast<float*>(y),
                                           static_cast<const float*>(a.wt) + static_cast<size_t>(u) * 4 * C * C,
                                           a.t_len, a.slope);
  return cudaGetLastError();
}

template <int C, int D, bool kProducts>
cudaError_t launch_backward_f32(const Args& a, const void* x, const float* g, void* dx, int u) {
  constexpr size_t smem = F32Geometry<C, D>::kBwdSmem;
  constexpr int TILE = F32Plan<C>::kTile;
  const int tiles_per_row = (a.t_len + TILE - 1) / TILE;
  auto kern = unit_backward_tf32_kernel<C, D, kProducts>;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<a.n_blocks, kThreads, smem, a.stream>>>(
      static_cast<const float*>(x), g, static_cast<float*>(dx),
      static_cast<const float*>(a.wt) + static_cast<size_t>(u) * 4 * C * C, a.partial, a.t_len, a.slope,
      tiles_per_row, tiles_per_row * a.batch);
  if ((err = cudaGetLastError()) != cudaSuccess || !kProducts) return err;
  return launch_reduce(a, u, C);
}

template <int C, bool kProducts>
cudaError_t run_f32(const Args& a) {
  const int n = 12 * C * C;
  layout_unit_weights_f32_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, a.stream>>>(
      static_cast<const float*>(a.w[0]), static_cast<const float*>(a.w[1]),
      static_cast<const float*>(a.w[2]), static_cast<const float*>(a.w[3]),
      static_cast<const float*>(a.w[4]), static_cast<const float*>(a.w[5]), static_cast<float*>(a.wt), C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // 1. recompute the unit inputs x1, x2; 2. units 2, 1, 0 backward (G in
  // g, g_a, g_b), each with its dW reduction
  if ((err = launch_forward_f32<C, 1>(a, a.x, a.x1, 0)) != cudaSuccess) return err;
  if ((err = launch_forward_f32<C, 3>(a, a.x1, a.x2, 1)) != cudaSuccess) return err;
  if ((err = launch_backward_f32<C, 9, kProducts>(a, a.x2, a.g, a.g_a, 2)) != cudaSuccess) return err;
  if ((err = launch_backward_f32<C, 3, kProducts>(a, a.x1, a.g_a, a.g_b, 1)) != cudaSuccess) return err;
  return launch_backward_f32<C, 1, kProducts>(a, a.x, a.g_b, a.dx, 0);
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
  return launch_reduce(a, u, C);
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
    out[0] = F32Plan<C>::kTile;
    if ((err = describe(unit_backward_tf32_kernel<C, 9, true>, kThreads, F32Geometry<C, 9>::kBwdSmem, device, out + 3,
                        blocks)) != cudaSuccess ||
        (err = describe(unit_backward_tf32_kernel<C, 3, true>, kThreads, F32Geometry<C, 3>::kBwdSmem, device, out + 7,
                        blocks + 1)) != cudaSuccess ||
        (err = describe(unit_backward_tf32_kernel<C, 1, true>, kThreads, F32Geometry<C, 1>::kBwdSmem, device, out + 11,
                        blocks + 2)) != cudaSuccess)
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
  if (dtype == 0) return run_f32<C, true>(a);
  if (dtype == 1) return run_mma<C>(a);
  if (dtype == 2) return run_f32<C, false>(a);
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
// 1 = bfloat16; 2 = float32 with each unit's backward stopped after its
// recompute, which writes no dx and no dW: a timing aid); g, g_a, g_b: (batch, channels, t_len) float32; w*: the six
// effective weights in x's type, wd (C, C, 3) and wp (C, C, 1); dw: float32
// 3 x [dWd (C, C, 3) | dWp (C, C)] for units 0, 1, 2; partial: blocks x 4 C^2
// float32 with blocks from vx_residual_stack_backward_config; wt: 24 C^2
// elements of x's type in bf16, 12 C^2 in float32.  x1, x2, g_a, g_b,
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
