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
// Design.  One block per (batch element, time tile), so batch seams never mix.
// The block loads its tile plus a 13-sample halo per side (1 + 3 + 9) into
// shared memory once, runs the three units there and stores the tile once:
// device memory sees one read of x, one write of y, and the weights (from L2).
// Each unit is two small matrix products over the shrinking window:
//     h1 (C x R) = sum_k Wd[:, :, k] . x[:, j + (k-1) d]       R = TILE + 2 h
//     x[:, j]   += leaky(Wp . h1[:, j])                       (in place)
// where h is the halo still needed by the later units (12, 9, 0).  After a
// unit, the window positions outside [0, T) are refilled by reflecting the
// unit's output, so the next unit sees its own reflect padding.
// Weights are staged through shared memory in chunks of kIc input channels,
// transposed so that a thread reads its kOcb output channels as two float4.
// Every thread owns one kOcb x kPb micro-tile of the output window with f32
// accumulators; positions are interleaved across threads so that the
// activation reads of a warp hit consecutive shared-memory banks.
//
// Bound on this card: 24 C^2 T B FLOP against 8 C T B bytes (f32 in + out),
// 3C FLOP/byte (96 at C = 32) against the f32 ridge of 67 TFLOP/s over
// 3.35 TB/s = 20 FLOP/byte, so the kernel is bound by arithmetic.
// This version runs f32 FMAs on the CUDA cores (f32 results must match the
// plain path to 2e-5 of scale, which TF32 or bf16 tensor cores cannot), so its
// ceiling is the 67 TFLOP/s f32 rate; the halo recomputation adds 24/TILE of
// unit-0 work.  bf16 input is read and written as bf16 and accumulated in f32,
// rounding h1 and each unit's output to bf16 as the TPU kernel did.

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

template <typename T, int C, int TILE>
__global__ void __launch_bounds__(kThreads)
residual_stack_kernel(const T* __restrict__ x, T* __restrict__ y,
                      const T* __restrict__ wd0, const T* __restrict__ wp0,
                      const T* __restrict__ wd1, const T* __restrict__ wp1,
                      const T* __restrict__ wd2, const T* __restrict__ wp2,
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
  const T* xb = x + blockIdx.y * plane;
  T* yb = y + blockIdx.y * plane;

  // unit-0 input with its reflect padding; columns further out than the
  // padding only feed outputs that are refilled or never stored
  for (int e = tid; e < C * W; e += kThreads) {
    const int c = e / W;
    const int j = e - c * W;
    const int g = min(max(reflect(g0 + j, t_len), 0), t_len - 1);
    xs[e] = to_f32(xb[static_cast<size_t>(c) * t_len + g]);
  }

  const T* const wds[3] = {wd0, wd1, wd2};
  const T* const wps[3] = {wp0, wp1, wp2};
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
    const T* wd = wds[u];
    for (int i0 = 0; i0 < C; i0 += kIc) {
      __syncthreads();  // xs ready; previous chunk consumed
      for (int e = tid; e < C * kIc * 3; e += kThreads) {
        const int o = e / (kIc * 3);
        const int r = e - o * (kIc * 3);  // r = ii * 3 + k
        ws[r * kWs + o] = to_f32(wd[static_cast<size_t>(o) * C * 3 + i0 * 3 + r]);
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
        if (valid[q]) hs[(o0 + a) * W + col[q]] = round_to<T>(acc[a][q]);
        acc[a][q] = 0.f;
      }

    // ---- x += leaky(Wp . h1) ----
    const T* wp = wps[u];
    for (int i0 = 0; i0 < C; i0 += kIc) {
      __syncthreads();  // hs complete; previous chunk consumed
      for (int e = tid; e < C * kIc; e += kThreads) {
        const int o = e / kIc;
        const int ii = e - o * kIc;
        ws[ii * kWs + o] = to_f32(wp[static_cast<size_t>(o) * C + i0 + ii]);
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
        *cell = round_to<T>(*cell + round_to<T>(act));
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
    if (g < t_len) yb[static_cast<size_t>(c) * t_len + g] = from_f32<T>(xs[c * W + kHalo + j]);
  }
}

template <typename T, int C, int TILE>
cudaError_t launch(const void* x, void* y, const void* const* w, int batch, int t_len,
                   float slope, cudaStream_t stream) {
  const size_t smem = smem_floats<C, TILE>() * sizeof(float);
  auto kern = residual_stack_kernel<T, C, TILE>;
  // the attribute is per function and device; setting it on every call keeps
  // the launcher stateless for one cheap host call per launch
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((t_len + TILE - 1) / TILE, batch);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<const T*>(w[0]),
      static_cast<const T*>(w[1]), static_cast<const T*>(w[2]), static_cast<const T*>(w[3]),
      static_cast<const T*>(w[4]), static_cast<const T*>(w[5]), t_len, slope);
  return cudaGetLastError();
}

// TILE per channel count: the largest tile whose widest window still gives
// every micro-tile its own thread (see the static_assert above)
template <typename T>
cudaError_t dispatch(int channels, const void* x, void* y, const void* const* w, int batch,
                     int t_len, float slope, cudaStream_t stream) {
  switch (channels) {
    case 32: return launch<T, 32, 128>(x, y, w, batch, t_len, slope, stream);
    case 64: return launch<T, 64, 64>(x, y, w, batch, t_len, slope, stream);
    case 128: return launch<T, 128, 32>(x, y, w, batch, t_len, slope, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x, y: (batch, channels, t_len) contiguous; wd*: (channels, channels, 3) and
// wp*: (channels, channels, 1) contiguous, all of one type: dtype 0 = float32,
// 1 = bfloat16.  Launches on `stream`; returns the cudaError_t of the launch.
int vx_residual_stack(const void* x, void* y, const void* wd0, const void* wp0,
                      const void* wd1, const void* wp1, const void* wd2, const void* wp2,
                      int batch, int channels, int t_len, int dtype, float slope, int device,
                      void* stream) {
  if (batch < 1 || batch > 65535 || t_len < 10) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const void* const w[6] = {wd0, wp0, wd1, wp1, wd2, wp2};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(channels, x, y, w, batch, t_len, slope, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(channels, x, y, w, batch, t_len, slope, s);
  return cudaErrorInvalidValue;
}

const char* vx_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
