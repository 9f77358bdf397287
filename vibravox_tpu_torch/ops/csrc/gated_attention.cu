// WavLM's gated relative-position attention in IEEE float32, forward and
// backward, with the bias formed per tile:
//
//   out[b, h, i] = sum_j softmax_j(s_ij) v[b, h, j],
//   s_ij = scale q_i . k_j + g[b, h, i] D[h, j - i + T - 1]
//
// for q, k, v (B, H, T, 64), the gate g (B, H, T) and D (H, 2T - 1), the
// 2T - 1 diagonals of WavLM's Toeplitz position table P[h, i, j] =
// E[bucket(j - i), h].  The backward returns dq, dk, dv, dg[b, h, i] =
// sum_j dS_ij D[h, j - i + T - 1] and dD[h, r + T - 1] = sum_{b, i}
// dS[b, h, i, i + r] g[b, h, i], dS the scores' gradient.
//
// This replaces no TPU kernel: the JAX package has no WavLM.  It was added
// because handing the gated bias to a library attention makes it a B H T^2
// float32 tensor a layer (512 MB at B 8, H 16, T 999) that is written,
// copied, saved, read back and differentiated, and the library's float32
// attention (the memory-efficient kernels on FMAs) runs at ~25 TFLOP/s.
// Here the bias never leaves registers: a tile reads the gate of its rows
// and the window of D's diagonals that it meets.
//
// What bounds it on the H100: its work is 7 products of 2 B H T^2 64 FLOP a
// layer (2 forward, 5 backward), which at IEEE float32 runs on the FMAs
// (67 TFLOP/s), far above the ridge for bytes.  So every product is a tile
// product from shared memory into a register tile a thread, by float4 loads
// laid out so that each is conflict-free: 8 x 8 where the product allows
// (16 loads for 256 FMAs), 4 x 8 elsewhere (12 for 128).  Measured on the
// H100 at WavLM-Large's shape: such products alone run at ~44-47 TFLOP/s (8
// x 8) and ~38 (4 x 8) in one block of 256 threads an SM, 4 x 4 at ~28;
// each product of the backward at ~42; the kernels as a whole, with the
// softmax, the partials and the barriers, at ~34 (forward) and ~31
// (backward).  So each kernel is one block of 256 threads an SM, with the
// large tiles its shared memory (up to 227 KB) then holds; two blocks of 128
// threads an SM, or the exponential by ex2.approx, read no faster.
//
// * forward (gated_attention_forward_kernel): a block per (256 queries, b,
//   h) walks the key tiles of 64 with an online softmax (flash attention),
//   K and V double-buffered by cp.async; S = Q K^T and O += P V on 8 x 8
//   tiles; it writes out and the rows' logsumexp.
// * backward: gated_attention_backward_delta_kernel forms delta_i = dO_i .
//   O_i; gated_attention_backward_kernel, a block per (128 keys, b, h),
//   walks the query tiles of 128, recomputes S and P from the logsumexp
//   (8 x 8), adds P^T dO to dV, forms dP (8 x 8) and dS, adds dS^T Q to dK
//   (4 x 8, dK and dV kept in registers), and writes per key tile, in
//   float32, the tile's dS K (4 x 8), its rows' share of dg and the
//   finished diagonal sums of dS g (each diagonal of a query tile meets two
//   key-relative windows; a thread carries one window's half to the next
//   tile); gated_attention_dq_sum_kernel and gated_attention_dd_sum_kernel
//   add those partials in a fixed order.  No atomics: two runs are
//   bit-equal.
//
// Every product sums in a fixed order with fmaf, the softmax in float32
// with expf / logf, no TF32.  Kernel names carry "attention", so that a
// profiler's trace counts them as attention.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kDim = 64;       // head width
constexpr int kLd = 68;        // shared row stride of a row of 64 floats: float4 rows conflict-free
constexpr int kThreads = 256;  // 8 warps; lane 8 rg + cg (rg < 4, cg < 8)
constexpr int kRowThreads = 256;  // the row-wise passes: 16 lanes a row

// forward: 256 queries a block, 64 keys a step
constexpr int kFwdRows = 256;
constexpr int kFwdKeys = 64;
constexpr int kFwdLdP = 72;  // P's rows: 8 rg + cg distinct banks for the stores
constexpr int kFwdWin = kFwdRows + kFwdKeys;  // 319 diagonals and a zero
constexpr int kFwdSmemFloats = kFwdRows * kLd + kFwdRows * kFwdLdP + 4 * kFwdKeys * kLd + 2 * kFwdWin + kFwdRows;
// backward: 128 keys a block, 128 queries a step
constexpr int kBwdTile = 128;
constexpr int kBwdLdS = 136;  // P / dS rows
constexpr int kBwdWin = 2 * kBwdTile;  // 255 diagonals and a zero
constexpr int kBwdSmemFloats = 4 * kBwdTile * kLd + kBwdTile * kBwdLdS + kBwdWin + 3 * kBwdTile;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

struct Strides {  // elements between batch rows, heads and time steps; the last dim is contiguous
  long long b, h, t;
};

__device__ __forceinline__ long long row_offset(const Strides& s, int b, int h) {
  return b * s.b + h * s.h;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(addr), "l"(gmem) : "memory");
}

// rows [row0, row0 + rows) of one (b, h) of a (B, H, T, 64) tensor into
// shared rows of kLd floats; rows past t_len are zeros
template <int rows>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long st, int row0, int t_len) {
  for (int e = threadIdx.x; e < rows * (kDim / 4); e += kThreads) {
    const int r = e >> 4, c = 4 * (e & 15);
    float* d = dst + r * kLd + c;
    if (row0 + r < t_len) {
      cp_async16(d, src + (row0 + r) * st + c);
    } else {
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// the window of D that a tile of `rows` queries from i0 and `cols` keys
// from j0 meets: w[c] = D[j0 - i0 + c - (rows - 1) + T - 1] for c < rows +
// cols - 1, zero outside D and at the last entry; element (il, jl) reads
// w[jl - il + rows - 1]
template <int rows, int cols>
__device__ __forceinline__ void load_window(float* dst, const float* diag_h, int i0, int j0, int t_len) {
  for (int c = threadIdx.x; c < rows + cols; c += kThreads) {
    const int x = j0 - i0 + c - (rows - 1) + t_len - 1;
    if (c < rows + cols - 1 && x >= 0 && x <= 2 * t_len - 2) {
      cp_async4(dst + c, diag_h + x);
    } else {
      dst[c] = 0.f;
    }
  }
}

// a vector of a tile's rows (gate, logsumexp, delta), zero past t_len
template <int rows>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int row0, int t_len) {
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    if (row0 + r < t_len) {
      cp_async4(dst + r, src + row0 + r);
    } else {
      dst[r] = 0.f;
    }
  }
}

// The tile products, from shared tiles into a thread's register tile.  A
// thread's rows are ar + 4 r, with the lanes of one rg on one row, so that a
// float4 load of a row operand reads 4 consecutive rows (distinct 16-byte
// bank groups at strides of 68, 72 or 136 floats) and one of a column
// operand 8 consecutive rows, or 128 contiguous bytes: one wavefront each.
//
// acc[r][c] += sum_d A[ar + 4 r][d] B[bc + 8 c][d], d < 64   (R x 8; bc = cg + column base)
template <int R>
__device__ __forceinline__ void mm_nt(float (&acc)[R][8], const float* A, int lda, const float* B, int ar,
                                      int bc) {
#pragma unroll 2
  for (int d = 0; d < kDim; d += 4) {
    float4 b[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) b[c] = *reinterpret_cast<const float4*>(B + (bc + 8 * c) * kLd + d);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(A + (ar + 4 * r) * lda + d);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        acc[r][c] = fmaf(a.x, b[c].x, acc[r][c]);
        acc[r][c] = fmaf(a.y, b[c].y, acc[r][c]);
        acc[r][c] = fmaf(a.z, b[c].z, acc[r][c]);
        acc[r][c] = fmaf(a.w, b[c].w, acc[r][c]);
      }
    }
  }
}

__device__ __forceinline__ void fma4(float (&acc)[8], int half, float a, const float4& b) {
  acc[4 * half] = fmaf(a, b.x, acc[4 * half]);
  acc[4 * half + 1] = fmaf(a, b.y, acc[4 * half + 1]);
  acc[4 * half + 2] = fmaf(a, b.z, acc[4 * half + 2]);
  acc[4 * half + 3] = fmaf(a, b.w, acc[4 * half + 3]);
}

// acc[r][c] += sum_j A[ar + 4 r][j] B[j][4 cg + 32 (c / 4) + c % 4], j < n   (R x 8)
template <int R, int n>
__device__ __forceinline__ void mm_nn(float (&acc)[R][8], const float* A, int lda, const float* B, int ar,
                                      int cg) {
#pragma unroll 2
  for (int j = 0; j < n; j += 4) {
    float4 b[4][2];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      b[jj][0] = *reinterpret_cast<const float4*>(B + (j + jj) * kLd + 4 * cg);
      b[jj][1] = *reinterpret_cast<const float4*>(B + (j + jj) * kLd + 32 + 4 * cg);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 a4 = *reinterpret_cast<const float4*>(A + (ar + 4 * r) * lda + j);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        fma4(acc[r], 0, a[jj], b[jj][0]);
        fma4(acc[r], 1, a[jj], b[jj][1]);
      }
    }
  }
}

// acc[r][c] += sum_i A[i][kr + r] B[i][4 cg + 32 (c / 4) + c % 4], i < n   (4 x 8)
template <int n>
__device__ __forceinline__ void mm_tn(float (&acc)[4][8], const float* A, int lda, const float* B, int kr, int cg) {
#pragma unroll 4
  for (int i = 0; i < n; ++i) {
    const float4 a4 = *reinterpret_cast<const float4*>(A + i * lda + kr);
    const float4 b0 = *reinterpret_cast<const float4*>(B + i * kLd + 4 * cg);
    const float4 b1 = *reinterpret_cast<const float4*>(B + i * kLd + 32 + 4 * cg);
    const float a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      fma4(acc[r], 0, a[r], b0);
      fma4(acc[r], 1, a[r], b1);
    }
  }
}

template <int R>
__device__ __forceinline__ void zero(float (&acc)[R][8]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
  }
}

// a row of a register tile's head columns (4 cg + 32 (c / 4) + c % 4) as two float4, times f
__device__ __forceinline__ void store_row(float* dst, const float (&v)[8], int cg, float f) {
  *reinterpret_cast<float4*>(dst + 4 * cg) = make_float4(v[0] * f, v[1] * f, v[2] * f, v[3] * f);
  *reinterpret_cast<float4*>(dst + 32 + 4 * cg) = make_float4(v[4] * f, v[5] * f, v[6] * f, v[7] * f);
}

// the score of a tile's element: scale q . k + g D (w, the window entry),
// the bias's product rounded before the sum, as a materialised bias is
__device__ __forceinline__ float score(float qk, float scale, float g, float w) {
  return __fadd_rn(__fmul_rn(qk, scale), __fmul_rn(g, w));
}

// a sum over the `lanes` lanes (8 or 16, aligned) that hold one row, in a fixed order
template <int lanes>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = lanes / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// out and the rows' logsumexp for the 256 queries blockIdx.x of (b, h) =
// blockIdx.y.  Warp w takes query rows 32 w .. 32 w + 31 (a thread: ar + 4 r,
// ar = 32 w + rg, r < 8) and all 64 keys of a step (cg + 8 c) or head
// columns (4 cg + 32 (c / 4) + c % 4).
__global__ void __launch_bounds__(kThreads, 1)
gated_attention_forward_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                               const float* __restrict__ gate, const float* __restrict__ diag,
                               float* __restrict__ out, float* __restrict__ lse, Strides sq, Strides sk,
                               Strides sv, Strides so, int heads, int t_len, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ps = qs + kFwdRows * kLd;
  float* kv = ps + kFwdRows * kFwdLdP;  // stage s: K at kv + 2 s kFwdKeys kLd, V after it
  float* win = kv + 4 * kFwdKeys * kLd;  // stage s at win + s kFwdWin
  float* gs = win + 2 * kFwdWin;

  const int tid = threadIdx.x, cg = tid & 7, ar = 32 * (tid >> 5) + ((tid >> 3) & 3);
  const int bh = blockIdx.y, b = bh / heads, h = bh - b * heads;
  const int i0 = blockIdx.x * kFwdRows, steps = cdiv(t_len, kFwdKeys);
  const float* qb = q + row_offset(sq, b, h);
  const float* kb = k + row_offset(sk, b, h);
  const float* vb = v + row_offset(sv, b, h);
  const float* diag_h = diag + static_cast<long long>(h) * (2 * t_len - 1);

  load_tile<kFwdRows>(qs, qb, sq.t, i0, t_len);
  load_rows<kFwdRows>(gs, gate + static_cast<long long>(bh) * t_len, i0, t_len);
  load_tile<kFwdKeys>(kv, kb, sk.t, 0, t_len);
  load_tile<kFwdKeys>(kv + kFwdKeys * kLd, vb, sv.t, 0, t_len);
  load_window<kFwdRows, kFwdKeys>(win, diag_h, i0, 0, t_len);
  cp_async_commit();

  // o sums the finished steps (scaled by the running max); each step's P V
  // is summed apart first, so no sum runs over more than 64 keys
  float o[8][8], m[8], l[8];
  zero(o);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }

  for (int jt = 0; jt < steps; ++jt) {
    const int stage = jt & 1, j0 = jt * kFwdKeys;
    cp_async_wait_committed();
    __syncthreads();  // this step's stage is in; every thread is past the last step
    if (jt + 1 < steps) {
      float* next = kv + 2 * (stage ^ 1) * kFwdKeys * kLd;
      load_tile<kFwdKeys>(next, kb, sk.t, j0 + kFwdKeys, t_len);
      load_tile<kFwdKeys>(next + kFwdKeys * kLd, vb, sv.t, j0 + kFwdKeys, t_len);
      load_window<kFwdRows, kFwdKeys>(win + (stage ^ 1) * kFwdWin, diag_h, i0, j0 + kFwdKeys, t_len);
      cp_async_commit();
    }
    const float* ks = kv + 2 * stage * kFwdKeys * kLd;
    const float* vs = ks + kFwdKeys * kLd;
    const float* w = win + stage * kFwdWin;

    float s[8][8];
    zero(s);
    mm_nt(s, qs, kLd, ks, ar, cg);
    float alpha[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int il = ar + 4 * r;
      const float g = gs[il];
      float mx = m[r];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int jl = cg + 8 * c;
        s[r][c] = j0 + jl < t_len ? score(s[r][c], scale, g, w[jl - il + kFwdRows - 1]) : -INFINITY;
        mx = fmaxf(mx, s[r][c]);
      }
      mx = row_max(mx);  // finite: key j0 is in every step
      alpha[r] = expf(m[r] - mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        s[r][c] = expf(s[r][c] - mx);
        sum += s[r][c];
        ps[il * kFwdLdP + cg + 8 * c] = s[r][c];
      }
      l[r] = l[r] * alpha[r] + row_sum<8>(sum);
      m[r] = mx;
    }
    __syncthreads();  // P is in
    zero(s);
    mm_nn<8, kFwdKeys>(s, ps, kFwdLdP, vs, ar, cg);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
#pragma unroll
      for (int c = 0; c < 8; ++c) o[r][c] = fmaf(o[r][c], alpha[r], s[r][c]);
    }
  }

  float* ob = out + row_offset(so, b, h);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = i0 + ar + 4 * r;
    if (i < t_len) {
#pragma unroll
      for (int c = 0; c < 8; ++c) o[r][c] /= l[r];
      store_row(ob + i * so.t, o[r], cg, 1.f);
      if (cg == 0) lse[static_cast<long long>(bh) * t_len + i] = m[r] + logf(l[r]);
    }
  }
}

// delta[b, h, i] = dO_i . O_i, 16 lanes a row
__global__ void __launch_bounds__(kRowThreads)
gated_attention_backward_delta_kernel(const float* __restrict__ out, const float* __restrict__ dout,
                                      float* __restrict__ delta, Strides so, Strides sdo, int heads, int t_len,
                                      long long rows) {
  const long long row = (static_cast<long long>(blockIdx.x) * kRowThreads + threadIdx.x) >> 4;
  const int c = 4 * (threadIdx.x & 15);
  float acc = 0.f;
  if (row < rows) {
    const int i = static_cast<int>(row % t_len);
    const int bh = static_cast<int>(row / t_len), b = bh / heads, h = bh - b * heads;
    const float4 o4 = *reinterpret_cast<const float4*>(out + row_offset(so, b, h) + i * so.t + c);
    const float4 d4 = *reinterpret_cast<const float4*>(dout + row_offset(sdo, b, h) + i * sdo.t + c);
    acc = fmaf(o4.x, d4.x, acc);
    acc = fmaf(o4.y, d4.y, acc);
    acc = fmaf(o4.z, d4.z, acc);
    acc = fmaf(o4.w, d4.w, acc);
  }
  acc = row_sum<16>(acc);
  if (row < rows && c == 0) delta[row] = acc;
}

// For the 128 keys blockIdx.x of (b, h) = blockIdx.y: dK and dV, and per key
// tile jt the partials dq_part[jt][bh][i][:] (this tile's dS K scale),
// dg_part[2 jt + half][bh][i] (sum over the half's 64 keys of dS D) and
// dd_part[bh][jt][x] (sum over i of dS g along the diagonal r = x + j0 -
// 128 tiles + 1).  The S, dP tiles (128 queries x 128 keys): warp w takes
// query rows ar + 4 r (ar = 32 (w % 4) + rg, r < 8) and keys kb + cg + 8 c
// (kb = 64 (w / 4)); dK, dV: key rows kr + r (kr = 16 w + 4 rg, r < 4);
// dS K: query rows qr + 4 r (qr = 16 w + rg, r < 4); head columns 4 cg +
// 32 (c / 4) + c % 4.
__global__ void __launch_bounds__(kThreads, 1)
gated_attention_backward_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, const float* __restrict__ gate,
                                const float* __restrict__ diag, const float* __restrict__ dout,
                                const float* __restrict__ lse, const float* __restrict__ delta,
                                float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ dq_part,
                                float* __restrict__ dg_part, float* __restrict__ dd_part, Strides sq, Strides sk,
                                Strides sv, Strides sdo, Strides sdk, Strides sdv, int heads, int t_len,
                                float scale) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + kBwdTile * kLd;
  float* qs = vs + kBwdTile * kLd;
  float* dos = qs + kBwdTile * kLd;
  float* ss = dos + kBwdTile * kLd;  // P, then dS
  float* win = ss + kBwdTile * kBwdLdS;
  float* gs = win + kBwdWin;
  float* ls = gs + kBwdTile;
  float* es = ls + kBwdTile;  // delta

  const int tid = threadIdx.x, warp = tid >> 5, rg = (tid >> 3) & 3, cg = tid & 7;
  const int ar = 32 * (warp & 3) + rg, kb = 64 * (warp >> 2), kr = 16 * warp + 4 * rg, qr = 16 * warp + rg;
  const int bh = blockIdx.y, b = bh / heads, h = bh - b * heads, bhs = gridDim.y;
  const int jt = blockIdx.x, j0 = jt * kBwdTile, tiles = cdiv(t_len, kBwdTile);
  const float* qb = q + row_offset(sq, b, h);
  const float* dob = dout + row_offset(sdo, b, h);
  const float* diag_h = diag + static_cast<long long>(h) * (2 * t_len - 1);
  const long long rows_bh = static_cast<long long>(bh) * t_len;
  const int width = kBwdTile * tiles + kBwdTile;  // of a (bh, jt) row of dd_part
  float* dd_row = dd_part + (static_cast<long long>(bh) * tiles + jt) * width;
  float* dg_row = dg_part + (static_cast<long long>(2 * jt + (warp >> 2)) * bhs + bh) * t_len;

  load_tile<kBwdTile>(ks, k + row_offset(sk, b, h), sk.t, j0, t_len);
  load_tile<kBwdTile>(vs, v + row_offset(sv, b, h), sv.t, j0, t_len);
  cp_async_commit();

  float dk_acc[4][8], dv_acc[4][8];
  zero(dk_acc);
  zero(dv_acc);
  float carry = 0.f;  // thread t < 128: the diagonal j - i = t - 128 of the last tile, to finish

  for (int it = 0; it < tiles; ++it) {
    const int i0 = it * kBwdTile;
    __syncthreads();  // every thread is past the last tile
    load_tile<kBwdTile>(qs, qb, sq.t, i0, t_len);
    load_tile<kBwdTile>(dos, dob, sdo.t, i0, t_len);
    load_window<kBwdTile, kBwdTile>(win, diag_h, i0, j0, t_len);
    load_rows<kBwdTile>(gs, gate + rows_bh, i0, t_len);
    load_rows<kBwdTile>(ls, lse + rows_bh, i0, t_len);
    load_rows<kBwdTile>(es, delta + rows_bh, i0, t_len);
    cp_async_commit();
    cp_async_wait_committed();
    __syncthreads();

    // P, into ss
    float s[8][8];
    zero(s);
    mm_nt(s, qs, kLd, ks, ar, kb + cg);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int il = ar + 4 * r;
      const bool row_in = i0 + il < t_len;
      const float g = gs[il], lse_i = ls[il];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int jl = kb + cg + 8 * c;
        const bool in = row_in && j0 + jl < t_len;
        s[r][c] = in ? expf(score(s[r][c], scale, g, win[jl - il + kBwdTile - 1]) - lse_i) : 0.f;
        ss[il * kBwdLdS + jl] = s[r][c];
      }
    }
    __syncthreads();  // P is in
    mm_tn<kBwdTile>(dv_acc, ss, kBwdLdS, dos, kr, cg);

    // dS = P (dP - delta), each thread's own P read back
    zero(s);
    mm_nt(s, dos, kLd, vs, ar, kb + cg);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int il = ar + 4 * r;
      const float delta_i = es[il];
#pragma unroll
      for (int c = 0; c < 8; ++c) s[r][c] = ss[il * kBwdLdS + kb + cg + 8 * c] * (s[r][c] - delta_i);
    }
    __syncthreads();  // every thread is past P
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int il = ar + 4 * r;
      float dg = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int jl = kb + cg + 8 * c;
        dg = fmaf(s[r][c], win[jl - il + kBwdTile - 1], dg);
        ss[il * kBwdLdS + jl] = s[r][c];
      }
      dg = row_sum<8>(dg);
      if (cg == 0 && i0 + il < t_len) dg_row[i0 + il] = dg;
    }
    __syncthreads();  // dS is in

    if (tid < kBwdTile) {
      // the diagonal j - i = tid of this tile, finished with the carried
      // j - i = tid - 128 of the last one: r = j0 - i0 + tid
      const int t = tid;
      float up = 0.f;
      for (int il = 0; il + t < kBwdTile; ++il) up = fmaf(ss[il * kBwdLdS + il + t], gs[il], up);
      dd_row[kBwdTile * (tiles - it) - 1 + t] = up + carry;
      float lo = 0.f;
      for (int il = kBwdTile - t; il < kBwdTile; ++il) lo = fmaf(ss[il * kBwdLdS + il - kBwdTile + t], gs[il], lo);
      carry = lo;  // r = j0 - i0 - 128 + t, finished by the next tile's up
    }

    mm_tn<kBwdTile>(dk_acc, ss, kBwdLdS, qs, kr, cg);
    float dq[4][8];
    zero(dq);  // dS K, this tile's share of dq
    mm_nn<4, kBwdTile>(dq, ss, kBwdLdS, ks, qr, cg);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + qr + 4 * r;
      if (i < t_len) store_row(dq_part + ((static_cast<long long>(jt) * bhs + bh) * t_len + i) * kDim, dq[r], cg, scale);
    }
  }
  if (tid >= 1 && tid < kBwdTile) dd_row[tid - 1] = carry;  // the last tile's lower diagonals

  float* dkb = dk + row_offset(sdk, b, h);
  float* dvb = dv + row_offset(sdv, b, h);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = j0 + kr + r;
    if (j < t_len) {
      store_row(dkb + j * sdk.t, dk_acc[r], cg, scale);
      store_row(dvb + j * sdv.t, dv_acc[r], cg, 1.f);
    }
  }
}

// dq[b, h, i] = sum over key tiles of dq_part, dg[b, h, i] of dg_part (two
// halves a tile), in order; 16 lanes a row
__global__ void __launch_bounds__(kRowThreads)
gated_attention_dq_sum_kernel(const float* __restrict__ dq_part, const float* __restrict__ dg_part,
                              float* __restrict__ dq, float* __restrict__ dg, Strides sdq, int heads, int t_len,
                              int tiles, long long rows) {
  const long long row = (static_cast<long long>(blockIdx.x) * kRowThreads + threadIdx.x) >> 4;
  const int c = 4 * (threadIdx.x & 15);
  if (row >= rows) return;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float g = 0.f;
  for (int jt = 0; jt < tiles; ++jt) {
    const float4 p = *reinterpret_cast<const float4*>(dq_part + (jt * rows + row) * kDim + c);
    acc.x += p.x;
    acc.y += p.y;
    acc.z += p.z;
    acc.w += p.w;
    if (c == 0) g += dg_part[2 * jt * rows + row] + dg_part[(2 * jt + 1) * rows + row];
  }
  const int i = static_cast<int>(row % t_len);
  const int bh = static_cast<int>(row / t_len), b = bh / heads, h = bh - b * heads;
  *reinterpret_cast<float4*>(dq + row_offset(sdq, b, h) + i * sdq.t + c) = acc;
  if (c == 0) dg[row] = g;
}

// dD[h, x] = sum over b, then key tiles, of dd_part at the diagonal r = x -
// T + 1; a key tile whose window misses r adds nothing
__global__ void __launch_bounds__(kRowThreads)
gated_attention_dd_sum_kernel(const float* __restrict__ dd_part, float* __restrict__ dd, int batch, int heads,
                              int t_len, int tiles) {
  const int span = 2 * t_len - 1;
  const int e = blockIdx.x * kRowThreads + threadIdx.x;
  if (e >= heads * span) return;
  const int h = e / span, r = e - h * span - (t_len - 1);
  const int width = kBwdTile * tiles + kBwdTile;
  float acc = 0.f;
  for (int b = 0; b < batch; ++b) {
    const float* row = dd_part + static_cast<long long>(b * heads + h) * tiles * width;
    for (int jt = 0; jt < tiles; ++jt) {
      const int x = r - jt * kBwdTile + kBwdTile * tiles - 1;
      if (x >= 0 && x < width - 1) acc += row[jt * width + x];
    }
  }
  dd[e] = acc;
}

Strides strides_at(const long long* s, int n) { return Strides{s[3 * n], s[3 * n + 1], s[3 * n + 2]}; }

cudaError_t allow_smem(const void* kernel, int floats) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, floats * 4);
}

bool valid(int batch, int heads, int t_len) {
  return batch >= 1 && heads >= 1 && t_len >= 1 && batch * heads <= 65535 && t_len <= (1 << 20);
}

}  // namespace

extern "C" {

// q, k, v, out: (batch, heads, t_len, 64) float32 at the element strides
// (batch, head, time) of strides[0..2], [3..5], [6..8], [9..11], the last
// dim contiguous, rows 16-byte aligned; gate, lse: (batch, heads, t_len)
// and diag: (heads, 2 t_len - 1), contiguous float32.  Launches on
// `stream`; returns the cudaError_t of the launch.
int vx_gated_attention_forward(const void* q, const void* k, const void* v, const void* gate, const void* diag,
                               void* out, void* lse, const long long* strides, int batch, int heads, int t_len,
                               float scale, int device, void* stream) {
  if (!valid(batch, heads, t_len)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = allow_smem(reinterpret_cast<const void*>(gated_attention_forward_kernel), kFwdSmemFloats);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(t_len, kFwdRows), batch * heads);
  gated_attention_forward_kernel<<<grid, kThreads, kFwdSmemFloats * 4, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(gate), static_cast<const float*>(diag), static_cast<float*>(out),
      static_cast<float*>(lse), strides_at(strides, 0), strides_at(strides, 1), strides_at(strides, 2),
      strides_at(strides, 3), heads, t_len, scale);
  return cudaGetLastError();
}

// The number of float32 elements of each scratch buffer of the backward:
// which = 0 delta, 1 dq_part, 2 dg_part, 3 dd_part; -1 for a shape the
// kernels do not take.
long long vx_gated_attention_scratch(int which, int batch, int heads, int t_len) {
  if (!valid(batch, heads, t_len)) return -1;
  const long long rows = static_cast<long long>(batch) * heads * t_len, tiles = cdiv(t_len, kBwdTile);
  switch (which) {
    case 0: return rows;
    case 1: return tiles * rows * kDim;
    case 2: return 2 * tiles * rows;
    case 3: return static_cast<long long>(batch) * heads * tiles * (kBwdTile * tiles + kBwdTile);
    default: return -1;
  }
}

// q, k, v, out, dout, dq, dk, dv at strides[0..23] (eight triples, in that
// order) as above; lse as the forward wrote it; dgate: (batch, heads,
// t_len), ddiag: (heads, 2 t_len - 1), contiguous; delta, dq_part, dg_part,
// dd_part: scratch of vx_gated_attention_scratch's sizes.
int vx_gated_attention_backward(const void* q, const void* k, const void* v, const void* gate, const void* diag,
                                const void* out, const void* dout, const void* lse, void* dq, void* dk, void* dv,
                                void* dgate, void* ddiag, void* delta, void* dq_part, void* dg_part,
                                void* dd_part, const long long* strides, int batch, int heads, int t_len,
                                float scale, int device, void* stream) {
  if (!valid(batch, heads, t_len)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = allow_smem(reinterpret_cast<const void*>(gated_attention_backward_kernel), kBwdSmemFloats);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(batch) * heads * t_len;
  const int tiles = cdiv(t_len, kBwdTile);
  const unsigned row_blocks = static_cast<unsigned>((rows + kRowThreads / 16 - 1) / (kRowThreads / 16));
  gated_attention_backward_delta_kernel<<<row_blocks, kRowThreads, 0, s>>>(
      static_cast<const float*>(out), static_cast<const float*>(dout), static_cast<float*>(delta),
      strides_at(strides, 3), strides_at(strides, 4), heads, t_len, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gated_attention_backward_kernel<<<dim3(tiles, batch * heads), kThreads, kBwdSmemFloats * 4, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(gate), static_cast<const float*>(diag), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<float*>(dk),
      static_cast<float*>(dv), static_cast<float*>(dq_part), static_cast<float*>(dg_part),
      static_cast<float*>(dd_part), strides_at(strides, 0), strides_at(strides, 1), strides_at(strides, 2),
      strides_at(strides, 4), strides_at(strides, 6), strides_at(strides, 7), heads, t_len, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gated_attention_dq_sum_kernel<<<row_blocks, kRowThreads, 0, s>>>(
      static_cast<const float*>(dq_part), static_cast<const float*>(dg_part), static_cast<float*>(dq),
      static_cast<float*>(dgate), strides_at(strides, 5), heads, t_len, tiles, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gated_attention_dd_sum_kernel<<<cdiv(heads * (2 * t_len - 1), kRowThreads), kRowThreads, 0, s>>>(
      static_cast<const float*>(dd_part), static_cast<float*>(ddiag), batch, heads, t_len, tiles);
  return cudaGetLastError();
}

const char* vx_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
