// K3 and K4: magnitude of the framed, windowed DFT, forward and backward,
// hand-written for Hopper (sm_90a).
//
// K3 replaces the Pallas TPU kernel vibravox_tpu/ops/pallas_stft.py::_fwd_kernel
// (launched by _pallas_forward), K4 its _bwd_kernel (launched by
// _pallas_backward).  Both take the signal already reflect-padded by fft/2 on
// each side, xp (B, Tp), as torch.stft(center=True) frames it: frame f starts
// at f * hop, and its Hann window (win taps, centred in fft) starts at pad_l =
// (fft - win) / 2.  With the window folded into the DFT rows,
//
//     wc[n, k] = hann[n] cos(-2 pi (pad_l + n) k / fft),  ws[n, k] = the same with sin,
//     re[f, k] = sum_{n < win} xp[f hop + pad_l + n] wc[n, k],   im likewise with ws,
//     K3:  mag[f, k] = sqrt(max(re^2 + im^2, eps)),
//     K4:  dxp[p] = sum_{f, n: f hop + pad_l + n = p} sum_k gom[f, k] (re wc[n, k] + im ws[n, k]),
//
// where gom = g / mag (0 where the power was clamped) is formed by the caller,
// which also folds dxp back through the reflect pad.  Only the win rows where
// the window is not zero enter the sums (the TPU kernel multiplied by the
// zero rows too).
//
// Design.  Frames are never written to device memory, which is the point of
// the TPU kernels.  K3: one block per (batch row, 64 frames, 64 bins) stages
// the signal span of its frames in shared memory once and streams the rows
// of wc, ws through shared memory 16 at a time; each thread accumulates a
// 4-frame x 4-bin tile of re and im with f32 FMAs.  K4: one block per (batch
// row, 58 hop-rows of output); it owns its output samples, so blocks never
// write the same sample and nothing is reduced across blocks.  For each
// 64-bin tile it recomputes re and im of the (at most 64) frames that touch
// its samples, scales them by gom in shared memory, and forms the frame
// gradients 32 window rows at a time, each added straight into the block's
// output samples in shared memory: with 32 <= hop, the 32 rows of one chunk
// send every frame to distinct samples, so no two threads add to one sample.
// The TPU's sequential bin axis with a resident output block becomes this
// loop over bin tiles inside the block.
//
// Bound on this card: K3 does 4 B F win K FLOP on 4 B (Tp + F K) bytes, K4
// about twice the FLOP; at the loss's shapes that is hundreds of FLOP per
// byte, bound by arithmetic at the f32 rate of 67 TFLOP/s.  A DFT done as a
// direct sum costs O(win) per bin where an FFT costs O(log fft), so an FFT
// library call does far less work for the same function.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTF = 64;   // frames per block (K3) and most frames a K4 block touches
constexpr int kTK = 64;   // bins per tile
constexpr int kNC = 16;   // window rows per staged chunk (re/im)
constexpr int kND = 32;   // window rows per frame-gradient chunk (K4); needs hop >= kND
constexpr int kTR = 58;   // hop-rows of output per K4 block: frames touching them <= kTF

// re, im (4 frames x 4 bins) of local frames fl0..fl0+3 and tile bins
// kl0..kl0+3, from the signal span xs (frame fl starts at xs[fl * hop]).
// Every thread of the block calls it (it synchronises).
__device__ __forceinline__ void re_im_tile(const float* xs, int hop, int win,
                                           const float* __restrict__ wc,
                                           const float* __restrict__ wsn, int n_bins, int k0,
                                           float* stc, float* sts, int fl0, int kl0,
                                           float (&re)[4][4], float (&im)[4][4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int c = 0; c < 4; ++c) re[q][c] = im[q][c] = 0.f;
  for (int n0 = 0; n0 < win; n0 += kNC) {
    __syncthreads();  // the previous chunk is consumed
    for (int e = threadIdx.x; e < kNC * kTK; e += kThreads) {
      const int r = e / kTK;
      const int n = n0 + r;
      const int k = k0 + (e - r * kTK);
      const bool ok = n < win && k < n_bins;
      stc[e] = ok ? wc[static_cast<size_t>(n) * n_bins + k] : 0.f;
      sts[e] = ok ? wsn[static_cast<size_t>(n) * n_bins + k] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < kNC; ++r) {
      float xv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) xv[q] = xs[(fl0 + q) * hop + n0 + r];
      const float4 c4 = *reinterpret_cast<const float4*>(stc + r * kTK + kl0);
      const float4 s4 = *reinterpret_cast<const float4*>(sts + r * kTK + kl0);
      const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
      const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          re[q][c] = fmaf(xv[q], cv[c], re[q][c]);
          im[q][c] = fmaf(xv[q], sv[c], im[q][c]);
        }
    }
  }
}

__device__ __forceinline__ void load_span(float* xs, const float* xb, int start, int len,
                                          int t_pad) {
  for (int j = threadIdx.x; j < len; j += kThreads) {
    const int p = start + j;
    xs[j] = (p >= 0 && p < t_pad) ? xb[p] : 0.f;
  }
}

__host__ __device__ constexpr int span_floats(int hop, int win) {
  return (kTF - 1) * hop + win + kNC;  // the zero tail covers a chunk past win
}

__global__ void __launch_bounds__(kThreads)
framed_dft_magnitude_kernel(const float* __restrict__ xp, const float* __restrict__ wc,
                            const float* __restrict__ wsn, float* __restrict__ mag, int t_pad,
                            int n_frames, int hop, int pad_l, int win, int n_bins, float eps) {
  extern __shared__ float4 smem4[];
  float* stc = reinterpret_cast<float*>(smem4);  // [kNC][kTK]
  float* sts = stc + kNC * kTK;                  // [kNC][kTK]
  float* xs = sts + kNC * kTK;                   // signal span of the block's frames
  const int k0 = blockIdx.x * kTK;
  const int f0 = blockIdx.y * kTF;
  const int b = blockIdx.z;
  load_span(xs, xp + static_cast<size_t>(b) * t_pad, f0 * hop + pad_l, span_floats(hop, win),
            t_pad);
  const int fl0 = (threadIdx.x / 16) * 4;
  const int kl0 = (threadIdx.x % 16) * 4;
  float re[4][4], im[4][4];
  re_im_tile(xs, hop, win, wc, wsn, n_bins, k0, stc, sts, fl0, kl0, re, im);
  float* out = mag + static_cast<size_t>(b) * n_frames * n_bins;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int f = f0 + fl0 + q;
    if (f >= n_frames) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int k = k0 + kl0 + c;
      if (k < n_bins)
        out[static_cast<size_t>(f) * n_bins + k] =
            sqrtf(fmaxf(re[q][c] * re[q][c] + im[q][c] * im[q][c], eps));
    }
  }
}

__host__ __device__ constexpr int bwd_smem_floats(int hop, int win) {
  return 2 * kTK * kND             // staged weight rows (either layout)
         + 2 * kTK * kTF           // gom * re, gom * im: [bin][frame]
         + kTR * hop               // the block's output samples
         + span_floats(hop, win);  // signal span of the touching frames
}

__device__ __forceinline__ int floor_div(int a, int b) { return a >= 0 ? a / b : -((-a + b - 1) / b); }

__global__ void __launch_bounds__(kThreads)
framed_dft_backward_kernel(const float* __restrict__ xp, const float* __restrict__ gom,
                           const float* __restrict__ wc, const float* __restrict__ wsn,
                           float* __restrict__ dxp, int t_pad, int n_frames, int hop, int pad_l,
                           int win, int n_bins) {
  extern __shared__ float4 smem4[];
  float* stage = reinterpret_cast<float*>(smem4);  // 2 x kTK x kND
  float* gr = stage + 2 * kTK * kND;                // [kTK][kTF]
  float* gi = gr + kTK * kTF;                       // [kTK][kTF]
  float* acc_s = gi + kTK * kTF;                    // [kTR * hop] output samples
  float* xs = acc_s + kTR * hop;                    // signal span

  const int L = kTR * hop;
  const int p0 = blockIdx.x * L;
  const int b = blockIdx.y;
  // frames whose window [f hop + pad_l, f hop + pad_l + win) meets [p0, p0 + L)
  const int f_lo = max(0, -floor_div(-(p0 - pad_l - win + 1), hop));
  const int f_hi = min(n_frames - 1, floor_div(p0 + L - 1 - pad_l, hop));
  const int nf = f_hi - f_lo + 1;  // <= kTF, checked by the host

  load_span(xs, xp + static_cast<size_t>(b) * t_pad, f_lo * hop + pad_l, span_floats(hop, win),
            t_pad);
  for (int j = threadIdx.x; j < L; j += kThreads) acc_s[j] = 0.f;
  const float* gom_b = gom + static_cast<size_t>(b) * n_frames * n_bins;

  const int fl0 = (threadIdx.x / 16) * 4;  // this thread's 4 frames (re/im and gradients)
  const int kl0 = (threadIdx.x % 16) * 4;  // its 4 bins (re/im)
  const int nl0 = (threadIdx.x % 16) * 2;  // its 2 window rows (gradients)
  for (int k0 = 0; k0 < n_bins; k0 += kTK) {
    if (nf > 0) {
      float re[4][4], im[4][4];
      re_im_tile(xs, hop, win, wc, wsn, n_bins, k0, stage, stage + kNC * kTK, fl0, kl0, re, im);
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int fl = fl0 + q;
          const int k = k0 + kl0 + c;
          const float s = (fl < nf && k < n_bins)
                              ? gom_b[static_cast<size_t>(f_lo + fl) * n_bins + k] : 0.f;
          gr[(kl0 + c) * kTF + fl] = s * re[q][c];
          gi[(kl0 + c) * kTF + fl] = s * im[q][c];
        }
    }
    // frame gradients dframes[f, n] = sum_k gr[k, f] wc[n, k] + gi[k, f] ws[n, k],
    // added into the samples f hop + pad_l + n
    for (int n0 = 0; n0 < win; n0 += kND) {
      __syncthreads();  // gr, gi complete; previous chunk consumed
      float* wct = stage;             // [kTK][kND]
      float* wst = stage + kTK * kND;  // [kTK][kND]
      for (int e = threadIdx.x; e < kTK * kND; e += kThreads) {
        const int r = e / kTK;  // window row within the chunk
        const int c = e - r * kTK;
        const int n = n0 + r;
        const int k = k0 + c;
        const bool ok = n < win && k < n_bins;
        wct[c * kND + r] = ok ? wc[static_cast<size_t>(n) * n_bins + k] : 0.f;
        wst[c * kND + r] = ok ? wsn[static_cast<size_t>(n) * n_bins + k] : 0.f;
      }
      __syncthreads();
      float d[4][2];
#pragma unroll
      for (int q = 0; q < 4; ++q) d[q][0] = d[q][1] = 0.f;
#pragma unroll 4
      for (int c = 0; c < kTK; ++c) {
        const float4 a = *reinterpret_cast<const float4*>(gr + c * kTF + fl0);
        const float4 a2 = *reinterpret_cast<const float4*>(gi + c * kTF + fl0);
        const float2 w = *reinterpret_cast<const float2*>(wct + c * kND + nl0);
        const float2 w2 = *reinterpret_cast<const float2*>(wst + c * kND + nl0);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {a2.x, a2.y, a2.z, a2.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          d[q][0] = fmaf(av[q], w.x, fmaf(bv[q], w2.x, d[q][0]));
          d[q][1] = fmaf(av[q], w.y, fmaf(bv[q], w2.y, d[q][1]));
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int fl = fl0 + q;
          const int n = n0 + nl0 + r;
          const int p = (f_lo + fl) * hop + pad_l + n - p0;
          if (fl < nf && n < win && p >= 0 && p < L) acc_s[p] += d[q][r];
        }
    }
    __syncthreads();  // the last chunk's adds are done before gr, gi are rewritten
  }
  float* out = dxp + static_cast<size_t>(b) * t_pad;
  for (int j = threadIdx.x; j < L; j += kThreads)
    if (p0 + j < t_pad) out[p0 + j] = acc_s[j];
}

cudaError_t set_smem(const void* kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" {

// xp: (batch, t_pad) float32, the signal reflect-padded by fft/2 per side;
// wc, ws: (win, n_bins) float32 window-folded DFT rows; mag: (batch, n_frames,
// n_bins) float32.  Launches K3 on `stream`; returns a cudaError_t.
int vx_framed_dft_magnitude(const void* xp, const void* wc, const void* ws, void* mag, int batch,
                            int t_pad, int n_frames, int hop, int pad_l, int win, int n_bins,
                            float eps, int device, void* stream) {
  if (batch < 1 || batch > 65535 || hop < 1 || win < 1 || n_bins < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t smem = (2 * kNC * kTK + span_floats(hop, win)) * sizeof(float);
  if ((err = set_smem(reinterpret_cast<const void*>(framed_dft_magnitude_kernel), smem)) != cudaSuccess)
    return err;
  const dim3 grid((n_bins + kTK - 1) / kTK, (n_frames + kTF - 1) / kTF, batch);
  framed_dft_magnitude_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xp), static_cast<const float*>(wc), static_cast<const float*>(ws),
      static_cast<float*>(mag), t_pad, n_frames, hop, pad_l, win, n_bins, eps);
  return cudaGetLastError();
}

// xp as above; gom: (batch, n_frames, n_bins) float32, the cotangent of the
// magnitude divided by it (0 where clamped); dxp: (batch, t_pad) float32, the
// gradient with respect to xp.  Launches K4 on `stream`; returns a cudaError_t.
int vx_framed_dft_backward(const void* xp, const void* gom, const void* wc, const void* ws,
                           void* dxp, int batch, int t_pad, int n_frames, int hop, int pad_l,
                           int win, int n_bins, int device, void* stream) {
  if (batch < 1 || batch > 65535 || hop < kND || win < 1 || n_bins < 1) return cudaErrorInvalidValue;
  if ((kTR * hop + win - 2) / hop + 1 > kTF) return cudaErrorInvalidValue;  // frames per block
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t smem = bwd_smem_floats(hop, win) * sizeof(float);
  if ((err = set_smem(reinterpret_cast<const void*>(framed_dft_backward_kernel), smem)) != cudaSuccess)
    return err;
  const dim3 grid((t_pad + kTR * hop - 1) / (kTR * hop), batch);
  framed_dft_backward_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xp), static_cast<const float*>(gom), static_cast<const float*>(wc),
      static_cast<const float*>(ws), static_cast<float*>(dxp), t_pad, n_frames, hop, pad_l, win,
      n_bins);
  return cudaGetLastError();
}

const char* vx_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
