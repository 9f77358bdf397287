// K3 and K4: magnitude of the framed, windowed DFT, forward and backward,
// hand-written for Hopper (sm_90a) as shared-memory FFTs.
//
// K3 replaces the Pallas TPU kernel vibravox_tpu/ops/pallas_stft.py::_fwd_kernel
// (launched by _pallas_forward), K4 its _bwd_kernel (launched by
// _pallas_backward).  Both take the unpadded signal x (B, T) and frame it as
// torch.stft(center=True) does: frame f covers the samples f hop + n, n < fft,
// of x reflect-padded by pad = fft / 2 on each side, and its periodic Hann
// window (win taps, zero-padded to fft) starts at pad_l = (fft - win) / 2:
//
//     X_f[k] = sum_n w[n] xp[f hop + n] exp(-2 pi i n k / fft),   k <= fft / 2,
//     K3:  mag[f, k] = sqrt(max(|X_f[k]|^2, eps)),
//     K4:  dx = the transpose of the reflect pad applied to
//          dxp[f hop + n] += w[n] Re sum_{k <= fft/2} G_f[k] exp(2 pi i n k / fft),
//          G_f[k] = gom[f, k] X_f[k],  gom = g / mag (0 where mag <= sqrt(eps)).
//
// Bound on this card.  An FFT needs about 2.5 fft log2(fft) FLOP per real
// frame, under 1 GFLOP per signal at the loss's three resolutions, so both
// kernels are bound by bytes: K3 reads x once and writes the magnitudes
// once (31 / 27 / 27 MB per call at B = 32, T = 39904 and fft 512 / 1024 /
// 2048, about 9 / 8 / 8 us at 3.35 TB/s); K4 reads x, g and mag and writes
// dx, about twice that.
//
// Design.  Nothing but x, g, mag and the outputs touches device memory: no
// frames, no spectra, no padded copy, no window-folded DFT rows.
// - A block of max(256, fft / 8) threads transforms P = threads * 8 / fft
//   frame pairs at once, each thread holding 8 points of a pair per stage.
//   Frames 2p and 2p + 1 are the real and imaginary part of one complex
//   fft-point FFT Z, separated after it as X_a[k] = (Z[k] + conj Z[-k]) / 2
//   and X_b[k] = (Z[k] - conj Z[-k]) / 2i.
// - The frames are copied from x into shared memory with cp.async, the
//   reflect pad done by the mirrored source index; each tap of a frame is
//   its own copy, so any hop fits (overlapping frames read x again, mostly
//   from L1 and L2).  The window multiplies the points as the
//   first FFT stage reads them; the taps outside it are zero.
// - The FFT is a Stockham autosort FFT in shared memory, float32: one radix-2
//   or radix-4 stage when log2(fft) is not a multiple of 3, then radix-8
//   stages, the butterflies in registers, twiddles from an fft-entry float32
//   table computed in float64 on the host.
// - K3: one block per (batch row, chunk of 2P consecutive frames); the
//   magnitudes of a chunk are one contiguous run of the output, written
//   coalesced.
// - K4: the same grid.  A block recomputes its chunk's spectra as K3 does,
//   forms gom and G in registers, and gets both frames' gradients of a pair
//   from one inverse FFT of V = Y_a + i Y_b, Y[k] = G[k] (k = 0, fft / 2) or
//   G[k] / 2, Hermitian-extended, done as conj(FFT(conj V)).  It then sums
//   its frames' windowed gradients over its span of padded positions,
//   (2P - 1) hop + win of them, into its own row of a scratch buffer; each
//   thread owns its positions and adds the frames in order.  A second,
//   elementwise kernel gives dx[t] the sum, in chunk order, of the rows
//   covering t's padded position and its reflect mirrors: the transpose of
//   the reflect pad.  No two threads write one value and no float atomics
//   are used, so dx is bit-equal from run to run; the scratch rows are
//   1.5-3x the size of x at the loss's resolutions.  Owning frames, not
//   output samples, recomputes no frame twice and gives K4 K3's grid.

#include <cuda_runtime.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kPoints = 8;  // FFT points a thread holds per stage

__host__ __device__ constexpr int threads_for(int n) { return n / kPoints > 256 ? n / kPoints : 256; }
__host__ __device__ constexpr int pairs_for(int n) { return threads_for(n) * kPoints / n; }
__host__ __device__ constexpr int ilog2(int n) { return n <= 1 ? 0 : 1 + ilog2(n / 2); }

__device__ __forceinline__ float2 operator+(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 operator-(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 times_minus_i(float2 a) { return make_float2(a.y, -a.x); }

// in-register forward DFT of R points (sign -1)
template <int R>
__device__ __forceinline__ void dft(float2 (&a)[R]);

template <>
__device__ __forceinline__ void dft<2>(float2 (&a)[2]) {
  const float2 t = a[0];
  a[0] = t + a[1];
  a[1] = t - a[1];
}

template <>
__device__ __forceinline__ void dft<4>(float2 (&a)[4]) {
  const float2 t0 = a[0] + a[2], t1 = a[0] - a[2], t2 = a[1] + a[3];
  const float2 t3 = times_minus_i(a[1] - a[3]);
  a[0] = t0 + t2;
  a[2] = t0 - t2;
  a[1] = t1 + t3;
  a[3] = t1 - t3;
}

template <>
__device__ __forceinline__ void dft<8>(float2 (&a)[8]) {
  float2 e[4] = {a[0], a[2], a[4], a[6]};
  float2 o[4] = {a[1], a[3], a[5], a[7]};
  dft<4>(e);
  dft<4>(o);
  constexpr float c = 0.70710678118654752f;  // o[k] *= exp(-2 pi i k / 8)
  o[1] = make_float2(c * (o[1].x + o[1].y), c * (o[1].y - o[1].x));
  o[2] = times_minus_i(o[2]);
  o[3] = make_float2(c * (o[3].y - o[3].x), -c * (o[3].x + o[3].y));
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    a[k] = e[k] + o[k];
    a[k + 4] = e[k] - o[k];
  }
}

// One Stockham stage of radix R over the N points z of one transform, after
// stages whose radices multiply to NS: butterfly j reads z[j + r N / R],
// twiddles the r-th point by exp(-2 pi i r k / (NS R)) with k = j mod NS,
// and writes its R outputs to z[(j - k) R + k + s NS].  u is the thread's
// index among the N / 8 threads of the transform; every thread of the block
// calls it (it synchronises).  `window`, if given, multiplies the points as
// they are read.
template <int N, int R, int NS>
__device__ __forceinline__ void fft_stage(float2* z, int u, const float2* __restrict__ tw,
                                          const float* __restrict__ window) {
  constexpr int kThreadsPer = N / kPoints;
  constexpr int kM = kPoints / R;  // butterflies per thread
  float2 a[kM][R];
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    const int j = u + m * kThreadsPer;
    const int k = j & (NS - 1);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int idx = j + r * (N / R);
      float2 v = z[idx];
      if (window != nullptr) {
        const float w = __ldg(window + idx);
        v = make_float2(v.x * w, v.y * w);
      }
      if (NS > 1 && r > 0) v = cmul(v, __ldg(tw + r * k * (N / (NS * R))));
      a[m][r] = v;
    }
    dft<R>(a[m]);
  }
  __syncthreads();  // every point of the stage is read before any is written
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    const int j = u + m * kThreadsPer;
    const int k = j & (NS - 1);
#pragma unroll
    for (int r = 0; r < R; ++r) z[(j - k) * R + k + r * NS] = a[m][r];
  }
  __syncthreads();
}

template <int N, int NS>
__device__ __forceinline__ void radix8_stages(float2* z, int u, const float2* __restrict__ tw) {
  if constexpr (NS < N) {
    fft_stage<N, 8, NS>(z, u, tw, nullptr);
    radix8_stages<N, NS * 8>(z, u, tw);
  }
}

// forward FFT of the N points z, in place, output in natural order
template <int N>
__device__ __forceinline__ void fft(float2* z, int u, const float2* __restrict__ tw,
                                    const float* __restrict__ window) {
  constexpr int kFirst = ilog2(N) % 3 == 1 ? 2 : ilog2(N) % 3 == 2 ? 4 : 8;
  fft_stage<N, kFirst, 1>(z, u, tw, window);
  radix8_stages<N, kFirst>(z, u, tw);
}

__device__ __forceinline__ void cp_async_f32(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Frames fc + 2p (real part) and fc + 2p + 1 (imaginary part) of the
// reflect-padded row xb into the P transforms z[p N .. p N + N): the window's
// taps by cp.async through the mirrored index, zero elsewhere and for frames
// past the last.  Every thread of the block calls it (it synchronises).
template <int N>
__device__ __forceinline__ void load_frames(float2* z, const float* __restrict__ xb, int t_len,
                                            int n_frames, int hop, int pad_l, int win, int fc) {
  constexpr int kPairs = pairs_for(N);
  float* zf = reinterpret_cast<float*>(z);
  for (int e = threadIdx.x; e < 2 * kPairs * N; e += threads_for(N)) {
    const int n = e & (N - 1);
    const int fl = e / N;
    float* dst = zf + 2 * ((fl >> 1) * N + n) + (fl & 1);
    const int f = fc + fl;
    if (f < n_frames && n >= pad_l && n < pad_l + win)
      cp_async_f32(dst, xb + reflect(f * hop + n - N / 2, t_len));
    else
      *dst = 0.f;
  }
  cp_async_wait_all();
  __syncthreads();
}

template <int N>
__global__ void __launch_bounds__(threads_for(N))
framed_dft_magnitude_kernel(const float* __restrict__ x, const float2* __restrict__ tw,
                            const float* __restrict__ window, float* __restrict__ mag, int t_len,
                            int n_frames, int hop, int pad_l, int win, float eps) {
  constexpr int kPairs = pairs_for(N), kBins = N / 2 + 1, kThreadsPer = N / kPoints;
  __shared__ float2 z[kPairs * N];
  const int b = blockIdx.y;
  const int fc = blockIdx.x * 2 * kPairs;
  load_frames<N>(z, x + static_cast<size_t>(b) * t_len, t_len, n_frames, hop, pad_l, win, fc);
  fft<N>(z + (threadIdx.x / kThreadsPer) * N, threadIdx.x % kThreadsPer, tw, window);
  // the chunk's magnitudes are one contiguous run of the output
  const int nf = min(2 * kPairs, n_frames - fc);
  float* out = mag + (static_cast<size_t>(b) * n_frames + fc) * kBins;
  for (int e = threadIdx.x; e < nf * kBins; e += threads_for(N)) {
    const int fl = e / kBins;
    const int k = e - fl * kBins;
    const float2* zp = z + (fl >> 1) * N;
    const float2 a = zp[k], c = zp[(N - k) & (N - 1)];
    // twice X_a = Z[k] + conj Z[-k] (even frame), twice X_b = (Z[k] - conj Z[-k]) / i
    const float re = (fl & 1) ? a.y + c.y : a.x + c.x;
    const float im = (fl & 1) ? c.x - a.x : a.y - c.y;
    out[e] = sqrtf(fmaxf(0.25f * (re * re + im * im), eps));
  }
}

__device__ __forceinline__ int floor_div(int a, int b) { return a >= 0 ? a / b : -((-a + b - 1) / b); }

// sum over the frames f in [fc, f_end) whose window covers the padded
// position q of w[n] dframe_f[n], n = q - f hop, in frame order; the
// gradient of frame fc + 2p + l sits in lane l of z[p N + n] (the imaginary
// lane negated: the inverse FFT is conj(FFT(conj V)))
template <int N>
__device__ __forceinline__ float gather(const float2* z, const float* __restrict__ window, int q,
                                        int fc, int f_end, int hop, int pad_l, int win) {
  const int f0 = max(fc, -floor_div(-(q - pad_l - win + 1), hop));
  const int f1 = min(f_end - 1, floor_div(q - pad_l, hop));
  float s = 0.f;
  for (int f = f0; f <= f1; ++f) {
    const int n = q - f * hop;
    const int fl = f - fc;
    const float2 v = z[(fl >> 1) * N + n];
    s = fmaf(__ldg(window + n), (fl & 1) ? -v.y : v.x, s);
  }
  return s;
}

// h gom / 2 of frame f at bin k: gom = g / mag, 0 where mag <= thr or past the last frame
__device__ __forceinline__ float half_gom(const float* __restrict__ g, const float* __restrict__ mag,
                                          size_t row, int f, int n_frames, int n_bins, int k,
                                          float h, float thr) {
  if (f >= n_frames) return 0.f;
  const size_t i = (row + f) * n_bins + k;
  const float m = __ldg(mag + i);
  return m > thr ? h * 0.5f * (__ldg(g + i) / m) : 0.f;
}

template <int N>
__global__ void __launch_bounds__(threads_for(N))
framed_dft_backward_kernel(const float* __restrict__ x, const float* __restrict__ g,
                           const float* __restrict__ mag, const float2* __restrict__ tw,
                           const float* __restrict__ window, float* __restrict__ partial,
                           int t_len, int n_frames, int hop, int pad_l, int win, int span,
                           float thr) {
  constexpr int kPairs = pairs_for(N), kBins = N / 2 + 1, kThreadsPer = N / kPoints;
  __shared__ float2 z[kPairs * N];
  const int b = blockIdx.y;
  const int fc = blockIdx.x * 2 * kPairs;
  const size_t row = static_cast<size_t>(b) * n_frames;
  load_frames<N>(z, x + static_cast<size_t>(b) * t_len, t_len, n_frames, hop, pad_l, win, fc);
  float2* zt = z + (threadIdx.x / kThreadsPer) * N;
  const int u = threadIdx.x % kThreadsPer;
  fft<N>(zt, u, tw, window);
  // G = gom X of both frames of a pair, packed as the conjugate of the
  // Hermitian-extended V = Y_a + i Y_b; the thread of bin k owns z[k] and z[-k]
  for (int e = threadIdx.x; e < kPairs * kBins; e += threads_for(N)) {
    const int p = e / kBins;
    const int k = e - p * kBins;
    const int kc = (N - k) & (N - 1);
    float2* zp = z + p * N;
    const float2 a = zp[k], c = zp[kc];
    const float h = (k == 0 || k == N / 2) ? 1.f : 0.5f;
    const float ga = half_gom(g, mag, row, fc + 2 * p, n_frames, kBins, k, h, thr);
    const float gb = half_gom(g, mag, row, fc + 2 * p + 1, n_frames, kBins, k, h, thr);
    // Y_a = h gom_a X_a, X_a = (Z[k] + conj Z[-k]) / 2; Y_b likewise, X_b = (Z[k] - conj Z[-k]) / 2i
    const float2 ya = make_float2(ga * (a.x + c.x), ga * (a.y - c.y));
    const float2 yb = make_float2(gb * (a.y + c.y), gb * (c.x - a.x));
    zp[k] = make_float2(ya.x - yb.y, -(ya.y + yb.x));             // conj(Y_a + i Y_b)
    if (kc != k) zp[kc] = make_float2(ya.x + yb.y, ya.y - yb.x);  // conj(conj Y_a + i conj Y_b)
  }
  __syncthreads();
  fft<N>(zt, u, tw, nullptr);
  // the chunk's windowed frame gradients, summed over its span of padded
  // positions fc hop + pad_l + j, j < span
  const int f_end = min(fc + 2 * kPairs, n_frames);
  const int p0 = fc * hop + pad_l;
  float* out = partial + (static_cast<size_t>(b) * gridDim.x + blockIdx.x) * span;
  for (int j = threadIdx.x; j < span; j += threads_for(N))
    out[j] = gather<N>(z, window, p0 + j, fc, f_end, hop, pad_l, win);
}

// sum, in chunk order, of the partials of the chunks whose span covers the
// padded position q (chunk c spans c chunk_hop + pad_l + [0, span))
__device__ __forceinline__ float chunk_sum(const float* __restrict__ pb, int q, int n_chunks,
                                           int chunk_hop, int span, int pad_l) {
  const int r = q - pad_l;
  const int c0 = max(0, -floor_div(-(r - span + 1), chunk_hop));
  const int c1 = min(n_chunks - 1, floor_div(r, chunk_hop));
  float s = 0.f;
  for (int c = c0; c <= c1; ++c) s += __ldg(pb + static_cast<size_t>(c) * span + (r - c * chunk_hop));
  return s;
}

// K4's second pass: dx[t] = the partial sums at t's padded position t + pad
// and, the transpose of the reflect pad, at its mirror positions pad - t (t
// in [1, pad]) and pad + 2 (T - 1) - t (t in [T - 1 - pad, T - 2])
__global__ void __launch_bounds__(256)
framed_dft_backward_sum_kernel(const float* __restrict__ partial, float* __restrict__ dx, int t_len,
                               int n_chunks, int chunk_hop, int span, int pad, int pad_l) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= t_len) return;
  const float* pb = partial + static_cast<size_t>(blockIdx.y) * n_chunks * span;
  float s = chunk_sum(pb, t + pad, n_chunks, chunk_hop, span, pad_l);
  if (t >= 1 && t <= pad) s += chunk_sum(pb, pad - t, n_chunks, chunk_hop, span, pad_l);
  if (t >= t_len - 1 - pad && t <= t_len - 2)
    s += chunk_sum(pb, pad + 2 * (t_len - 1) - t, n_chunks, chunk_hop, span, pad_l);
  dx[static_cast<size_t>(blockIdx.y) * t_len + t] = s;
}

// calls f(std::integral_constant<int, fft>) for the fft sizes the kernels are built for
template <typename F>
cudaError_t dispatch_fft(int fft, F&& f) {
  switch (fft) {
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 256: return f(std::integral_constant<int, 256>{});
    case 512: return f(std::integral_constant<int, 512>{});
    case 1024: return f(std::integral_constant<int, 1024>{});
    case 2048: return f(std::integral_constant<int, 2048>{});
    case 4096: return f(std::integral_constant<int, 4096>{});
    default: return cudaErrorInvalidValue;
  }
}

bool valid_geometry(int batch, int t_len, int n_frames, int fft, int hop, int pad_l, int win) {
  return batch >= 1 && batch <= 65535 && hop >= 1 && win >= 1 && win <= fft &&
         pad_l == (fft - win) / 2 && t_len > fft / 2 && n_frames == 1 + t_len / hop;
}

}  // namespace

extern "C" {

// x: (batch, t_len) float32; twiddles: (fft, 2) float32 exp(-2 pi i m / fft);
// window: (fft,) float32, the Hann window of win taps at pad_l, zero
// elsewhere; mag: (batch, n_frames, fft / 2 + 1) float32.  fft is a power of
// two in [64, 4096].  Launches K3 on `stream`; returns a cudaError_t.
int vx_framed_dft_magnitude(const void* x, const void* twiddles, const void* window, void* mag,
                            int batch, int t_len, int n_frames, int fft, int hop, int pad_l,
                            int win, float eps, int device, void* stream) {
  if (!valid_geometry(batch, t_len, n_frames, fft, hop, pad_l, win)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return dispatch_fft(fft, [&](auto n) {
    constexpr int N = decltype(n)::value;
    const dim3 grid((n_frames + 2 * pairs_for(N) - 1) / (2 * pairs_for(N)), batch);
    framed_dft_magnitude_kernel<N><<<grid, threads_for(N), 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float2*>(twiddles),
        static_cast<const float*>(window), static_cast<float*>(mag), t_len, n_frames, hop, pad_l,
        win, eps);
    return cudaGetLastError();
  });
}

// x, twiddles, window as above; g, mag: (batch, n_frames, fft / 2 + 1)
// float32, the cotangent of the magnitude and the magnitude; partial:
// scratch of partial_floats = batch * n_chunks * span float32, n_chunks =
// ceil(n_frames / 2P), span = (2P - 1) hop + win, P = max(256, fft / 8) * 8
// / fft frame pairs per chunk; dx: (batch, t_len) float32.  thr is
// sqrt(eps), the magnitude at or below which the gradient is 0.  Launches
// K4's two passes on `stream`; returns a cudaError_t.
int vx_framed_dft_backward(const void* x, const void* g, const void* mag, const void* twiddles,
                           const void* window, void* partial, void* dx, int batch, int t_len,
                           int n_frames, int fft, int hop, int pad_l, int win, long long partial_floats,
                           float thr, int device, void* stream) {
  if (!valid_geometry(batch, t_len, n_frames, fft, hop, pad_l, win)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return dispatch_fft(fft, [&](auto n) {
    constexpr int N = decltype(n)::value;
    constexpr int kChunk = 2 * pairs_for(N);
    const int n_chunks = (n_frames + kChunk - 1) / kChunk;
    const int span = (kChunk - 1) * hop + win;
    if (partial_floats != static_cast<long long>(batch) * n_chunks * span) return cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    framed_dft_backward_kernel<N><<<dim3(n_chunks, batch), threads_for(N), 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g), static_cast<const float*>(mag),
        static_cast<const float2*>(twiddles), static_cast<const float*>(window),
        static_cast<float*>(partial), t_len, n_frames, hop, pad_l, win, span, thr);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    framed_dft_backward_sum_kernel<<<dim3((t_len + 255) / 256, batch), 256, 0, s>>>(
        static_cast<const float*>(partial), static_cast<float*>(dx), t_len, n_chunks, kChunk * hop,
        span, N / 2, pad_l);
    return cudaGetLastError();
  });
}

const char* vx_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
