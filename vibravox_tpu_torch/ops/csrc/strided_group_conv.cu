// The MelGAN discriminator's grouped stride-4 convolutions (kernel 41,
// stride 4, zero padding 20, 4 groups) in bfloat16 on Hopper's tensor cores:
// forward (fprop), data gradient (dgrad) and weight gradient (wgrad).
//
// This replaces no TPU kernel: the JAX package leaves these convolutions to
// XLA (vibravox_tpu/models/melgan_discriminator.py).  It was added because
// cuDNN's bf16 path runs them at a few per cent of the card's peak (about 34
// TFLOP/s for the forward of conv_3 and conv_4 at batch 32) and they are the
// largest block of the EBEN train step's convolution time.
//
// The polyphase form.  With tap k = 4 j + r (j < 11, r < 4, the weight
// zero-padded to 44 taps), y[o, t] = sum_{i, r, j} w[o, i, 4 j + r] x[i, 4 (t
// + j - 5) + r]: a stride-1, 11-tap correlation over the input's four time
// phases.  Each (batch row, group) is then a dense implicit GEMM whose
// operand tiles are windows of the NCW rows, read in place; no im2col
// buffer, no NCHW <-> NHWC copy.  All three run mma.sync m16n8k16 (bf16
// operands, float32 sums) with the weight operand from ldmatrix and the
// activation operand from 32-bit shared-memory loads of bf16 pairs:
//
// * fprop: M = C_out / 4 (o), N = T_out (t), K = 44 C_in / 4 (i, tap).  The
//   B operand B[(i, k)][t] = x_i[4 t + k - 20]: a pair of taps (k, k + 1),
//   k even, is one aligned word of the window x_i[4 t0 - 20 ...], since 4 t
//   is even.  44 taps a channel is even, so a pair never straddles channels.
//   The bias is added in the epilogue.
// * dgrad: M = 4 C_in / 4 (input channel i, phase rho), N = ceil(T_in / 4)
//   (u), K = 12 C_out / 4 (o, j', the 11 phase taps flipped and one zero):
//   dx[i, 4 u + rho] = sum_{o, j'} w[o, i, 4 (10 - j') + rho] dy_o[u - 5 +
//   j'], a stride-1 correlation of dy with the flipped taps, written phase by
//   phase into dx through a shared-memory stage.  A tap pair (j', j' + 1)
//   reads dy at two neighbouring samples whose first may be odd, so each
//   chunk's dy window is repacked once into words (d[p], d[p + 1]).
// * wgrad: M = C_out / 4 (o), N = 44 C_in / 4 (i, tap), K = batch x T_out
//   (b, t), split over (b, t) chunks into float32 partials that a second pass
//   sums in a fixed order: deterministic, no float atomics.  A pair along K
//   is (x_i[4 t + k - 20], x_i[4 t + k - 16]), so the x window is repacked
//   into words (x[p], x[p + 4]).
//
// What bounds each shape on the H100 (batch 32, T = 39904; 989 TFLOP/s bf16,
// 3.35 TB/s): conv_1 (16 -> 64, 6.7 GFLOP, 82 MB in and out) is bound by
// bytes; conv_2 (64 -> 256, 26.8 GFLOP, 82 MB) sits near the ridge; conv_3
// and conv_4 (256 -> 1024 and 1024 -> 1024, 107 GFLOP each) by operations.
// The design's answers: the activation windows are loaded once a block (the
// Hankel structure reuses each sample 11 times from shared memory) with
// cp.async, double-buffered against the products; the weight chunks stream
// through shared memory, reused across the block's time tile (160 at conv_4,
// whose rows are 156 long), so the weight traffic from L2 stays under the
// tensor cores' rate; conv_1's plan is a thin, wide tile (16 x 256) with many
// blocks in flight for the memory system.  Weights are cast and relaid (once
// a call) from the float32 masters by small kernels of this file.
//
// Kernel names carry "conv" and "fprop", "dgrad" or "wgrad", so that a
// profiler's trace counts them as convolution forward or backward.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTaps = 41;
constexpr int kTapsPad = 44;   // 11 taps a phase x 4 phases
constexpr int kPad = 20;
constexpr int kDgradTaps = 12;  // the 11 phase taps, flipped, and a zero: pairs never straddle channels
constexpr int kFpropChannels = 4;  // input channels a K chunk of fprop: 176 = 11 steps of 16
constexpr int kDgradChannels = 16;  // output channels a K chunk of dgrad: 192 = 12 steps of 16

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// the least n >= v with n % m == r
__host__ __device__ constexpr int round_to_residue(int v, int m, int r) {
  return v + ((r - v) % m + m) % m;
}

// 2 V bytes from global to shared memory by cp.async (V = 2 or 4 elements;
// 8 elements take cp_async16)
template <int V>
__device__ __forceinline__ void cp_async_small(void* smem, const void* gmem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  if constexpr (V == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(addr), "l"(gmem) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(addr), "l"(gmem) : "memory");
  }
}

// load_rows by cp.async of V elements each (V divides kLen, t_len, start and
// dst_stride, so a copy lies wholly inside or outside the row and is aligned)
template <int kThreads, int kLen, int V>
__device__ __forceinline__ void load_rows_by(bf16* dst, int dst_stride, const bf16* src, int rows, int start,
                                             int t_len) {
  constexpr int kVecs = kLen / V;
  for (int e = threadIdx.x; e < rows * kVecs; e += kThreads) {
    const int r = e / kVecs, v = e - r * kVecs;
    const int s = start + V * v;
    bf16* d = dst + r * dst_stride + V * v;
    if (s >= 0 && s < t_len) {
      const bf16* g = src + static_cast<long long>(r) * t_len + s;
      if constexpr (V == 8) {
        cp_async16(d, g);
      } else {
        cp_async_small<V>(d, g);
      }
    } else if constexpr (V == 8) {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    } else if constexpr (V == 4) {
      *reinterpret_cast<uint2*>(d) = make_uint2(0u, 0u);
    } else {
      *reinterpret_cast<uint32_t*>(d) = 0u;
    }
  }
}

// Elements [start, start + kLen) of `rows` global rows of t_len elements
// (row r at src + r * t_len) into shared rows of dst_stride elements; zeros
// outside [0, t_len).  By the widest cp.async (16, 8 or 4 bytes) whose
// element count divides kLen, t_len, start and dst_stride; element by
// element where t_len or start is odd.  dst is 16-byte aligned.
template <int kThreads, int kLen>
__device__ __forceinline__ void load_rows(bf16* dst, int dst_stride, const bf16* src, int rows, int start,
                                          int t_len) {
  const int a = t_len | start | dst_stride;
  if constexpr (kLen % 8 == 0) {
    if ((a & 7) == 0) return load_rows_by<kThreads, kLen, 8>(dst, dst_stride, src, rows, start, t_len);
  }
  if constexpr (kLen % 4 == 0) {
    if ((a & 3) == 0) return load_rows_by<kThreads, kLen, 4>(dst, dst_stride, src, rows, start, t_len);
  }
  if ((a & 1) == 0) return load_rows_by<kThreads, kLen, 2>(dst, dst_stride, src, rows, start, t_len);
  for (int e = threadIdx.x; e < rows * kLen; e += kThreads) {
    const int r = e / kLen, p = e - r * kLen;
    const int s = start + p;
    dst[r * dst_stride + p] =
        (s >= 0 && s < t_len) ? src[static_cast<long long>(r) * t_len + s] : __float2bfloat16(0.f);
  }
}

// kRows rows of kCols elements (kCols % 8 == 0) at src + r * src_stride,
// 16-byte aligned, into shared rows of kStride elements by 16-byte cp.async
template <int kThreads, int kRows, int kCols, int kStride>
__device__ __forceinline__ void load_tile16(bf16* dst, const bf16* src, int src_stride) {
  constexpr int kVecs = kCols / 8;
  for (int e = threadIdx.x; e < kRows * kVecs; e += kThreads) {
    const int r = e / kVecs, v = e - r * kVecs;
    cp_async16(dst + r * kStride + 8 * v, src + static_cast<long long>(r) * src_stride + 8 * v);
  }
}

__device__ __forceinline__ uint32_t pack_pair(unsigned short lo, unsigned short hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// A fragments of the 16 x 16 tile at row m0, column k0 of a row-major shared
// tile of kStride elements (kStride % 16 == 8: rows land on distinct banks)
template <int kStride>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int m0, int k0, int lane) {
  ldmatrix_x4(a, tile + (m0 + (lane & 15)) * kStride + k0 + ((lane >> 4) << 3));
}

// ---------------------------------------------------------------------------
// Weight layouts, from the float32 masters w (C_out, C_in / 4, 41), once a call.

// fprop: wf[o][i * 44 + k] (rows over all groups), zero for k >= 41
__global__ void strided_group_conv_fprop_weights_kernel(const float* __restrict__ w, bf16* __restrict__ wf,
                                                        int c_out, int cig) {
  const long long n = static_cast<long long>(c_out) * cig * kTapsPad;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < n;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int k = static_cast<int>(e % kTapsPad);
    const long long oi = e / kTapsPad;  // o * cig + i
    wf[e] = __float2bfloat16(k < kTaps ? w[oi * kTaps + k] : 0.f);
  }
}

// dgrad: wd[g][i * 4 + rho][o * 12 + j'] = w[g cog + o][i][4 (10 - j') + rho],
// zero for j' = 11 and for taps past 40
__global__ void strided_group_conv_dgrad_weights_kernel(const float* __restrict__ w, bf16* __restrict__ wd,
                                                        int cig, int cog) {
  const int cols = kDgradTaps * cog;
  const long long n = 4LL * 4 * cig * cols;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < n;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int col = static_cast<int>(e % cols);
    const long long row = e / cols;  // g * 4 cig + i * 4 + rho
    const int g = static_cast<int>(row / (4 * cig));
    const int m = static_cast<int>(row % (4 * cig));
    const int i = m >> 2, rho = m & 3;
    const int o = col / kDgradTaps, jf = col % kDgradTaps;
    const int tap = 4 * (10 - jf) + rho;
    float v = 0.f;
    if (jf <= 10 && tap < kTaps) v = w[(static_cast<long long>(g * cog + o) * cig + i) * kTaps + tap];
    wd[e] = __float2bfloat16(v);
  }
}

// ---------------------------------------------------------------------------
// fprop

template <int BM, int BN, int WM, int WN>
struct FpropPlan {
  static constexpr int kBM = BM, kBN = BN, kWM = WM, kWN = WN;
  static constexpr int kWarpsN = BN / WN;
  static constexpr int kThreads = 32 * (BM / WM) * kWarpsN;
  static constexpr int kMT = WM / 16, kNT = WN / 8;
  static constexpr int kK = kFpropChannels * kTapsPad;  // 176
  static constexpr int kAStride = kK + 8;
  static constexpr int kXLen = 4 * BN + 2 * kPad;  // the window of one channel
  // words a channel row: the two rows a tap pair (40, 42 | 0, 2) straddles
  // then fall on disjoint banks
  static constexpr int kXWords = round_to_residue(kXLen / 2, 32, 4);
  static constexpr int kStage = BM * kAStride + kFpropChannels * 2 * kXWords;  // elements
  static constexpr size_t kSmem = 2 * kStage * sizeof(bf16);
  static_assert(BM % WM == 0 && BN % WN == 0 && WM % 16 == 0 && WN % 8 == 0, "tile");
};

template <class P>
__global__ void __launch_bounds__(P::kThreads)
    strided_group_conv_fprop_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wf,
                                    const float* __restrict__ bias, bf16* __restrict__ y, int cig, int cog,
                                    int t_in, int t_out) {
  constexpr int BM = P::kBM, BN = P::kBN, WM = P::kWM, WN = P::kWN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int t0 = blockIdx.x * BN, o0 = blockIdx.y * BM;
  const int b = blockIdx.z >> 2, g = blockIdx.z & 3;
  const bf16* xg = x + (static_cast<long long>(b) * 4 * cig + g * cig) * t_in;
  const int k_row = cig * kTapsPad;
  const bf16* wg = wf + static_cast<long long>(g * cog + o0) * k_row;
  const int chunks = cig / kFpropChannels;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp / P::kWarpsN) * WM, wn = (warp % P::kWarpsN) * WN;
  const int gq = lane >> 2, q = lane & 3;

  auto stage_chunk = [&](int c) {
    bf16* a = smem + (c & 1) * P::kStage;
    load_tile16<P::kThreads, BM, P::kK, P::kAStride>(a, wg + c * P::kK, k_row);
    load_rows<P::kThreads, P::kXLen>(a + BM * P::kAStride, 2 * P::kXWords,
                                     xg + static_cast<long long>(c) * kFpropChannels * t_in, kFpropChannels,
                                     4 * t0 - kPad, t_in);
    cp_async_commit();
  };

  float acc[P::kMT][P::kNT][4];
#pragma unroll
  for (int mt = 0; mt < P::kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < P::kNT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;

  stage_chunk(0);
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait_committed();
    __syncthreads();
    if (c + 1 < chunks) stage_chunk(c + 1);
    const bf16* a = smem + (c & 1) * P::kStage;
    const uint32_t* xw = reinterpret_cast<const uint32_t*>(a + BM * P::kAStride);
#pragma unroll
    for (int ks = 0; ks < P::kK / 16; ++ks) {
      uint32_t af[P::kMT][4];
#pragma unroll
      for (int mt = 0; mt < P::kMT; ++mt) load_a<P::kAStride>(af[mt], a, wm + mt * 16, ks * 16, lane);
      // B[(i, k)][n] = window_i[4 n + k]: word i * kXWords + 2 n + k / 2
      const int kk0 = ks * 16 + 2 * q, kk1 = kk0 + 8;
      const int w0 = (kk0 / kTapsPad) * P::kXWords + (kk0 % kTapsPad) / 2;
      const int w1 = (kk1 / kTapsPad) * P::kXWords + (kk1 % kTapsPad) / 2;
#pragma unroll
      for (int nt = 0; nt < P::kNT; ++nt) {
        const int n2 = 2 * (wn + nt * 8 + gq);
        const uint32_t bf[2] = {xw[w0 + n2], xw[w1 + n2]};
#pragma unroll
        for (int mt = 0; mt < P::kMT; ++mt) mma_bf16(acc[mt][nt], af[mt], bf);
      }
    }
  }

  const bool pairs = (t_out & 1) == 0;
#pragma unroll
  for (int mt = 0; mt < P::kMT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = g * cog + o0 + wm + mt * 16 + gq + 8 * h;
      const float bv = bias != nullptr ? bias[o] : 0.f;
      bf16* row = y + (static_cast<long long>(b) * 4 * cog + o) * t_out;
#pragma unroll
      for (int nt = 0; nt < P::kNT; ++nt) {
        const int t = t0 + wn + nt * 8 + 2 * q;
        const float v0 = acc[mt][nt][2 * h] + bv, v1 = acc[mt][nt][2 * h + 1] + bv;
        if (pairs && t + 1 < t_out) {
          *reinterpret_cast<__nv_bfloat162*>(row + t) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (t < t_out) row[t] = __float2bfloat16(v0);
          if (t + 1 < t_out) row[t + 1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dgrad

template <int BM, int BN, int WM, int WN>
struct DgradPlan {
  static constexpr int kBM = BM, kBN = BN, kWM = WM, kWN = WN;
  static constexpr int kWarpsN = BN / WN;
  static constexpr int kThreads = 32 * (BM / WM) * kWarpsN;
  static constexpr int kMT = WM / 16, kNT = WN / 8;
  static constexpr int kK = kDgradChannels * kDgradTaps;  // 192
  static constexpr int kAStride = kK + 8;
  static constexpr int kPLen = BN + kDgradTaps;  // packed words a channel: d[p], d[p + 1]
  static constexpr int kRawLen = BN + kDgradTaps + 4;  // dy[u0 - 8 ...], a start that is a multiple of 8
  // words a packed row: the two rows a tap pair (8, 10 | 0, 2) straddles
  // fall on disjoint banks
  static constexpr int kPWords = round_to_residue(kPLen, 32, 20);
  static constexpr int kStage = BM * kAStride + kDgradChannels * kRawLen;  // elements
  static constexpr int kPacked = kDgradChannels * kPWords;                 // words
  static constexpr int kOutStride = 4 * BN + 4;                            // the dx stage's rows
  static constexpr size_t kMain = 2 * kStage * sizeof(bf16) + kPacked * sizeof(uint32_t);
  static constexpr size_t kOut = (BM / 4) * kOutStride * sizeof(bf16);
  static constexpr size_t kSmem = kMain > kOut ? kMain : kOut;
  static_assert(BM % WM == 0 && BN % WN == 0 && WM % 16 == 0 && WN % 8 == 0 && BM % 16 == 0, "tile");
  static_assert((BM * kAStride) % 8 == 0 && kRawLen % 2 == 0 && kStage % 8 == 0, "alignment");
};

template <class P>
__global__ void __launch_bounds__(P::kThreads)
    strided_group_conv_dgrad_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ wd,
                                    bf16* __restrict__ dx, int cig, int cog, int t_in, int t_out) {
  constexpr int BM = P::kBM, BN = P::kBN, WM = P::kWM, WN = P::kWN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  uint32_t* packed = reinterpret_cast<uint32_t*>(smem + 2 * P::kStage);
  const int u0 = blockIdx.x * BN, m0 = blockIdx.y * BM;  // m: (i, rho) within the group
  const int b = blockIdx.z >> 2, g = blockIdx.z & 3;
  const bf16* dyg = dy + (static_cast<long long>(b) * 4 * cog + g * cog) * t_out;
  const int k_row = kDgradTaps * cog;
  const bf16* wg = wd + static_cast<long long>(g * 4 * cig + m0) * k_row;
  const int chunks = cog / kDgradChannels;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp / P::kWarpsN) * WM, wn = (warp % P::kWarpsN) * WN;
  const int gq = lane >> 2, q = lane & 3;

  auto stage_chunk = [&](int c) {
    bf16* a = smem + (c & 1) * P::kStage;
    load_tile16<P::kThreads, BM, P::kK, P::kAStride>(a, wg + c * P::kK, k_row);
    load_rows<P::kThreads, P::kRawLen>(a + BM * P::kAStride, P::kRawLen,
                                       dyg + static_cast<long long>(c) * kDgradChannels * t_out,
                                       kDgradChannels, u0 - 8, t_out);
    cp_async_commit();
  };

  float acc[P::kMT][P::kNT][4];
#pragma unroll
  for (int mt = 0; mt < P::kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < P::kNT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;

  stage_chunk(0);
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait_committed();
    __syncthreads();
    if (c + 1 < chunks) stage_chunk(c + 1);
    const bf16* a = smem + (c & 1) * P::kStage;
    // packed[o][p] = (d[p], d[p + 1]) with d[p] = dy_o[u0 - 5 + p] = raw[p + 3]
    const unsigned short* raw = reinterpret_cast<const unsigned short*>(a + BM * P::kAStride);
    for (int e = threadIdx.x; e < kDgradChannels * P::kPLen; e += P::kThreads) {
      const int o = e / P::kPLen, p = e - o * P::kPLen;
      packed[o * P::kPWords + p] = pack_pair(raw[o * P::kRawLen + p + 3], raw[o * P::kRawLen + p + 4]);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < P::kK / 16; ++ks) {
      uint32_t af[P::kMT][4];
#pragma unroll
      for (int mt = 0; mt < P::kMT; ++mt) load_a<P::kAStride>(af[mt], a, wm + mt * 16, ks * 16, lane);
      // B[(o, j')][n] = d_o[n + j']: word o * kPWords + j' + n
      const int kk0 = ks * 16 + 2 * q, kk1 = kk0 + 8;
      const int w0 = (kk0 / kDgradTaps) * P::kPWords + kk0 % kDgradTaps;
      const int w1 = (kk1 / kDgradTaps) * P::kPWords + kk1 % kDgradTaps;
#pragma unroll
      for (int nt = 0; nt < P::kNT; ++nt) {
        const int n = wn + nt * 8 + gq;
        const uint32_t bf[2] = {packed[w0 + n], packed[w1 + n]};
#pragma unroll
        for (int mt = 0; mt < P::kMT; ++mt) mma_bf16(acc[mt][nt], af[mt], bf);
      }
    }
  }

  // stage the tile as dx rows: row m = 4 i + rho, column n -> stage[i][4 n + rho]
  __syncthreads();
  bf16* stage = smem;
#pragma unroll
  for (int mt = 0; mt < P::kMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = wm + mt * 16 + gq + 8 * h;
      bf16* srow = stage + (m >> 2) * P::kOutStride + (m & 3);
#pragma unroll
      for (int nt = 0; nt < P::kNT; ++nt) {
        const int n = wn + nt * 8 + 2 * q;
        srow[4 * n] = __float2bfloat16(acc[mt][nt][2 * h]);
        srow[4 * n + 4] = __float2bfloat16(acc[mt][nt][2 * h + 1]);
      }
    }
  __syncthreads();
  constexpr int kRows = BM / 4, kCols = 4 * BN;
  const int s0 = 4 * u0;
  bf16* dxg = dx + (static_cast<long long>(b) * 4 * cig + g * cig + m0 / 4) * t_in;
  if ((t_in & 1) == 0) {
    for (int e = threadIdx.x; e < kRows * kCols / 2; e += P::kThreads) {
      const int r = e / (kCols / 2), w = e - r * (kCols / 2);
      const int s = s0 + 2 * w;
      if (s < t_in)
        *reinterpret_cast<uint32_t*>(dxg + static_cast<long long>(r) * t_in + s) =
            *reinterpret_cast<const uint32_t*>(stage + r * P::kOutStride + 2 * w);
    }
  } else {
    for (int e = threadIdx.x; e < kRows * kCols; e += P::kThreads) {
      const int r = e / kCols, p = e - r * kCols;
      if (s0 + p < t_in) dxg[static_cast<long long>(r) * t_in + s0 + p] = stage[r * P::kOutStride + p];
    }
  }
}

// ---------------------------------------------------------------------------
// wgrad

template <int BM, int BNC, int KT, int WM, int WN>
struct WgradPlan {
  static constexpr int kBM = BM, kBNC = BNC, kKT = KT, kWM = WM, kWN = WN;
  static constexpr int kN = BNC * kTapsPad;
  static constexpr int kWarpsN = kN / WN;
  static constexpr int kThreads = 32 * (BM / WM) * kWarpsN;
  static constexpr int kMT = WM / 16, kNT = WN / 8;
  static constexpr int kAStride = KT + 8;
  static constexpr int kXLen = 4 * KT + kTapsPad;  // x_i[4 t0 - 20 ...]
  static constexpr int kQLen = 4 * KT + kTapsPad - 4;  // packed words (x[p], x[p + 4])
  // words a packed row: an n-tile that straddles two channels reads
  // disjoint banks
  static constexpr int kQWords = round_to_residue(kQLen, 8, 4);
  static constexpr int kStage = BM * kAStride + BNC * kXLen;  // elements
  static constexpr size_t kSmem = 2 * kStage * sizeof(bf16) + BNC * kQWords * sizeof(uint32_t);
  static_assert(BM % WM == 0 && kN % WN == 0 && WM % 16 == 0 && WN % 8 == 0 && KT % 16 == 0, "tile");
  static_assert((BM * kAStride) % 8 == 0 && kStage % 8 == 0, "alignment");
};

template <class P>
__global__ void __launch_bounds__(P::kThreads)
    strided_group_conv_wgrad_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                                    float* __restrict__ partial, int cig, int cog, int t_in, int t_out,
                                    int chunks_per_row, int chunks, int splits) {
  constexpr int BM = P::kBM, BNC = P::kBNC, KT = P::kKT, WM = P::kWM, WN = P::kWN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  uint32_t* packed = reinterpret_cast<uint32_t*>(smem + 2 * P::kStage);
  const int i0 = blockIdx.x * BNC, o0 = blockIdx.y * BM;
  const int g = blockIdx.z & 3, split = blockIdx.z >> 2;
  const int c_begin = static_cast<int>(static_cast<long long>(split) * chunks / splits);
  const int c_end = static_cast<int>(static_cast<long long>(split + 1) * chunks / splits);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp / P::kWarpsN) * WM, wn = (warp % P::kWarpsN) * WN;
  const int gq = lane >> 2, q = lane & 3;

  auto stage_chunk = [&](int c) {
    const int b = c / chunks_per_row, t0 = (c - b * chunks_per_row) * KT;
    bf16* a = smem + (c & 1) * P::kStage;
    load_rows<P::kThreads, KT>(a, P::kAStride,
                               dy + (static_cast<long long>(b) * 4 * cog + g * cog + o0) * t_out, BM, t0,
                               t_out);
    load_rows<P::kThreads, P::kXLen>(a + BM * P::kAStride, P::kXLen,
                                     x + (static_cast<long long>(b) * 4 * cig + g * cig + i0) * t_in, BNC,
                                     4 * t0 - kPad, t_in);
    cp_async_commit();
  };

  // B[kt][(i, k)] = (x_i[4 kt + k], x_i[4 kt + 4 + k]) of the chunk's window:
  // word i * kQWords + 4 kt + k, one offset a lane and n-tile
  int boff[P::kNT];
#pragma unroll
  for (int nt = 0; nt < P::kNT; ++nt) {
    const int nn = wn + nt * 8 + gq;
    boff[nt] = (nn / kTapsPad) * P::kQWords + nn % kTapsPad + 8 * q;
  }

  float acc[P::kMT][P::kNT][4];
#pragma unroll
  for (int mt = 0; mt < P::kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < P::kNT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;

  if (c_begin < c_end) stage_chunk(c_begin);
  for (int c = c_begin; c < c_end; ++c) {
    cp_async_wait_committed();
    __syncthreads();
    if (c + 1 < c_end) stage_chunk(c + 1);
    const bf16* a = smem + (c & 1) * P::kStage;
    const unsigned short* raw = reinterpret_cast<const unsigned short*>(a + BM * P::kAStride);
    for (int e = threadIdx.x; e < BNC * P::kQLen; e += P::kThreads) {
      const int i = e / P::kQLen, p = e - i * P::kQLen;
      packed[i * P::kQWords + p] = pack_pair(raw[i * P::kXLen + p], raw[i * P::kXLen + p + 4]);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < KT / 16; ++ks) {
      uint32_t af[P::kMT][4];
#pragma unroll
      for (int mt = 0; mt < P::kMT; ++mt) load_a<P::kAStride>(af[mt], a, wm + mt * 16, ks * 16, lane);
#pragma unroll
      for (int nt = 0; nt < P::kNT; ++nt) {
        const uint32_t* pb = packed + boff[nt] + 64 * ks;  // kt = 16 ks + 2 q (+ 8)
        const uint32_t bf[2] = {pb[0], pb[32]};
#pragma unroll
        for (int mt = 0; mt < P::kMT; ++mt) mma_bf16(acc[mt][nt], af[mt], bf);
      }
    }
  }

  const int n_row = cig * kTapsPad;
  float* dst = partial + (static_cast<long long>(split) * 4 * cog + g * cog + o0) * n_row + i0 * kTapsPad;
#pragma unroll
  for (int mt = 0; mt < P::kMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* row = dst + static_cast<long long>(wm + mt * 16 + gq + 8 * h) * n_row;
#pragma unroll
      for (int nt = 0; nt < P::kNT; ++nt)
        *reinterpret_cast<float2*>(row + wn + nt * 8 + 2 * q) =
            make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
    }
}

// dw[o][i][k] = the partials' sum over the splits in their order, k < 41
__global__ void strided_group_conv_wgrad_sum_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                                                    int splits, int c_out, int cig) {
  const long long n = static_cast<long long>(c_out) * cig * kTaps;
  const long long split_stride = static_cast<long long>(c_out) * cig * kTapsPad;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < n;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long oi = e / kTaps;
    const long long src = oi * kTapsPad + e % kTaps;
    float s = 0.f;
    for (int sp = 0; sp < splits; ++sp) s += partial[sp * split_stride + src];
    dw[e] = s;
  }
}

// ---------------------------------------------------------------------------
// Plans by input channels a group (cig); each asks C_out / 4 to be a
// multiple of its kCog.

template <int CIG>
struct Plans;
template <>
struct Plans<4> {  // conv_1: 16 -> 64, bound by bytes
  using Fprop = FpropPlan<16, 256, 16, 64>;
  using Dgrad = DgradPlan<16, 256, 16, 64>;
  using Wgrad = WgradPlan<16, 4, 64, 16, 88>;
  static constexpr int kCog = 16;
};
template <>
struct Plans<16> {  // conv_2: 64 -> 256
  using Fprop = FpropPlan<64, 128, 32, 64>;
  using Dgrad = DgradPlan<64, 128, 32, 64>;
  using Wgrad = WgradPlan<64, 4, 128, 32, 88>;
  static constexpr int kCog = 64;
};
template <>
struct Plans<64> {  // conv_3: 256 -> 1024
  using Fprop = FpropPlan<128, 128, 64, 32>;
  using Dgrad = DgradPlan<64, 128, 32, 64>;
  using Wgrad = WgradPlan<128, 4, 128, 32, 88>;
  static constexpr int kCog = 128;
};
template <>
struct Plans<256> {  // conv_4: 1024 -> 1024, rows of 156
  using Fprop = FpropPlan<128, 160, 64, 40>;
  using Dgrad = DgradPlan<64, 160, 32, 80>;
  using Wgrad = WgradPlan<128, 4, 160, 32, 88>;
  static constexpr int kCog = 128;
};

constexpr int kWgradBlocks = 512;  // the split's aim: blocks of the wgrad pass

template <typename Kernel>
cudaError_t allow_smem(Kernel kern, size_t smem) {
  // the attribute is per function and device; setting it on every call keeps
  // the launcher stateless for one cheap host call per launch
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
}

int layout_blocks(long long n) { return static_cast<int>(n < 256LL * 1024 ? cdiv(static_cast<int>(n), 256) : 1024); }

template <int CIG>
cudaError_t fprop(const void* x, const void* w, const void* bias, void* y, void* wt, int batch, int cog,
                  int t_in, cudaStream_t stream) {
  using P = typename Plans<CIG>::Fprop;
  const int c_out = 4 * cog, t_out = cdiv(t_in, 4);
  const long long n = static_cast<long long>(c_out) * CIG * kTapsPad;
  strided_group_conv_fprop_weights_kernel<<<layout_blocks(n), 256, 0, stream>>>(
      static_cast<const float*>(w), static_cast<bf16*>(wt), c_out, CIG);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto kern = strided_group_conv_fprop_kernel<P>;
  if ((err = allow_smem(kern, P::kSmem)) != cudaSuccess) return err;
  const dim3 grid(cdiv(t_out, P::kBN), cog / P::kBM, 4 * batch);
  kern<<<grid, P::kThreads, P::kSmem, stream>>>(static_cast<const bf16*>(x), static_cast<const bf16*>(wt),
                                               static_cast<const float*>(bias), static_cast<bf16*>(y), CIG, cog,
                                               t_in, t_out);
  return cudaGetLastError();
}

template <int CIG>
cudaError_t dgrad(const void* dy, const void* w, void* dx, void* wt, int batch, int cog, int t_in,
                  cudaStream_t stream) {
  using P = typename Plans<CIG>::Dgrad;
  const int t_out = cdiv(t_in, 4);
  const long long n = 4LL * 4 * CIG * kDgradTaps * cog;
  strided_group_conv_dgrad_weights_kernel<<<layout_blocks(n), 256, 0, stream>>>(
      static_cast<const float*>(w), static_cast<bf16*>(wt), CIG, cog);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto kern = strided_group_conv_dgrad_kernel<P>;
  if ((err = allow_smem(kern, P::kSmem)) != cudaSuccess) return err;
  const dim3 grid(cdiv(t_out, P::kBN), 4 * CIG / P::kBM, 4 * batch);
  kern<<<grid, P::kThreads, P::kSmem, stream>>>(static_cast<const bf16*>(dy), static_cast<const bf16*>(wt),
                                               static_cast<bf16*>(dx), CIG, cog, t_in, t_out);
  return cudaGetLastError();
}

template <int CIG>
int wgrad_chunks_per_row(int t_in) {
  return cdiv(cdiv(t_in, 4), Plans<CIG>::Wgrad::kKT);
}

template <int CIG>
int wgrad_splits(int batch, int cog, int t_in) {
  using P = typename Plans<CIG>::Wgrad;
  const int base = (CIG / P::kBNC) * (cog / P::kBM) * 4;
  const int chunks = batch * wgrad_chunks_per_row<CIG>(t_in);
  const int want = cdiv(kWgradBlocks, base);
  return want < chunks ? want : chunks;
}

template <int CIG>
cudaError_t wgrad(const void* x, const void* dy, void* dw, void* partial, int splits, int batch, int cog,
                  int t_in, cudaStream_t stream) {
  using P = typename Plans<CIG>::Wgrad;
  const int t_out = cdiv(t_in, 4);
  const int per_row = wgrad_chunks_per_row<CIG>(t_in);
  if (splits != wgrad_splits<CIG>(batch, cog, t_in)) return cudaErrorInvalidValue;
  auto kern = strided_group_conv_wgrad_kernel<P>;
  cudaError_t err = allow_smem(kern, P::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(CIG / P::kBNC, cog / P::kBM, 4 * splits);
  kern<<<grid, P::kThreads, P::kSmem, stream>>>(static_cast<const bf16*>(x), static_cast<const bf16*>(dy),
                                               static_cast<float*>(partial), CIG, cog, t_in, t_out, per_row,
                                               batch * per_row, splits);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long n = 4LL * cog * CIG * kTaps;
  strided_group_conv_wgrad_sum_kernel<<<layout_blocks(n), 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(dw), splits, 4 * cog, CIG);
  return cudaGetLastError();
}

bool takes(int cig, int cog) {
  switch (cig) {
    case 4: return cog % Plans<4>::kCog == 0;
    case 16: return cog % Plans<16>::kCog == 0;
    case 64: return cog % Plans<64>::kCog == 0;
    case 256: return cog % Plans<256>::kCog == 0;
    default: return false;
  }
}

bool valid(int batch, int cig, int cog, int t_in) {
  return batch >= 1 && batch <= 16383 && t_in >= 1 && cog >= 1 && takes(cig, cog);
}

}  // namespace

extern "C" {

// x: (batch, 4 cig, t_in) bf16; w: (4 cog, cig, 41) float32; bias: (4 cog,)
// float32 or null; y: (batch, 4 cog, ceil(t_in / 4)) bf16; wt: scratch of
// 4 cog * cig * 44 bf16.  All contiguous.  Launches on `stream`; returns
// the cudaError_t of the launches.
int vx_sgconv_fprop(const void* x, const void* w, const void* bias, void* y, void* wt, int batch, int cig,
                    int cog, int t_in, int device, void* stream) {
  if (!valid(batch, cig, cog, t_in)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cig) {
    case 4: return fprop<4>(x, w, bias, y, wt, batch, cog, t_in, s);
    case 16: return fprop<16>(x, w, bias, y, wt, batch, cog, t_in, s);
    case 64: return fprop<64>(x, w, bias, y, wt, batch, cog, t_in, s);
    default: return fprop<256>(x, w, bias, y, wt, batch, cog, t_in, s);
  }
}

// dy: (batch, 4 cog, ceil(t_in / 4)) bf16; w as above; dx: (batch, 4 cig,
// t_in) bf16; wt: scratch of 4 * 4 cig * 12 cog bf16.
int vx_sgconv_dgrad(const void* dy, const void* w, void* dx, void* wt, int batch, int cig, int cog, int t_in,
                    int device, void* stream) {
  if (!valid(batch, cig, cog, t_in)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cig) {
    case 4: return dgrad<4>(dy, w, dx, wt, batch, cog, t_in, s);
    case 16: return dgrad<16>(dy, w, dx, wt, batch, cog, t_in, s);
    case 64: return dgrad<64>(dy, w, dx, wt, batch, cog, t_in, s);
    default: return dgrad<256>(dy, w, dx, wt, batch, cog, t_in, s);
  }
}

// The number of (batch, time) splits of the wgrad pass for a shape, or -1
// for a shape the kernels do not take.  `partial` needs splits * 4 cog * cig
// * 44 float32.
int vx_sgconv_wgrad_splits(int batch, int cig, int cog, int t_in) {
  if (!valid(batch, cig, cog, t_in)) return -1;
  switch (cig) {
    case 4: return wgrad_splits<4>(batch, cog, t_in);
    case 16: return wgrad_splits<16>(batch, cog, t_in);
    case 64: return wgrad_splits<64>(batch, cog, t_in);
    default: return wgrad_splits<256>(batch, cog, t_in);
  }
}

// x, dy as above; dw: (4 cog, cig, 41) float32.
int vx_sgconv_wgrad(const void* x, const void* dy, void* dw, void* partial, int splits, int batch, int cig,
                    int cog, int t_in, int device, void* stream) {
  if (!valid(batch, cig, cog, t_in)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cig) {
    case 4: return wgrad<4>(x, dy, dw, partial, splits, batch, cog, t_in, s);
    case 16: return wgrad<16>(x, dy, dw, partial, splits, batch, cog, t_in, s);
    case 64: return wgrad<64>(x, dy, dw, partial, splits, batch, cog, t_in, s);
    default: return wgrad<256>(x, dy, dw, partial, splits, batch, cog, t_in, s);
  }
}

const char* vx_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
