// Host-side data-pipeline kernels (C++), the port's own copy of the JAX
// package's vibravox_tpu/native/audio_pipeline.cpp.
//
// The reference's input pipeline runs inside torch DataLoader workers
// (vibravox/lightning_datamodules/bwe.py:232-293): per-sample crop/pad in
// python, then torch.stack, two full copies of every batch plus a python
// loop per sample.  Here each utterance is written ONCE, directly into its
// final row of the batch buffer, fanned out over a small thread pool.  The
// numpy twin in vibravox_tpu_torch/native/pipeline.py is the parity oracle
// of the tests (byte equality); the collate itself always runs this code.
//
// vx_resample_poly applies a polyphase Kaiser-sinc bank designed in python
// (vibravox_tpu_torch/ops/resample.py::design_kernel) to one waveform on
// the host.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Run fn(i) for i in [0, n) across up to max_threads workers.
template <typename F>
void parallel_for(int64_t n, int max_threads, F fn) {
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  if (hw <= 0) hw = 1;
  int workers = std::min<int64_t>(n, std::min(max_threads, hw));
  if (workers <= 1) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(workers);
  for (int w = 0; w < workers; ++w) {
    pool.emplace_back([=] {
      for (int64_t i = w; i < n; i += workers) fn(i);
    });
  }
  for (auto& t : pool) t.join();
}

// One utterance -> one fixed-length row: crop from `offset` when longer,
// symmetric zero-pad when shorter (vibravox/utils.py:50-81 semantics; the
// offset is drawn host-side in python, so the numpy twin consumes the same
// RNG stream).
void fix_length_row(const float* src, int64_t len, int64_t offset,
                    float* dst, int64_t target) {
  if (len >= target) {
    std::memcpy(dst, src + offset, sizeof(float) * target);
  } else {
    const int64_t left = (target - len) / 2;
    std::memset(dst, 0, sizeof(float) * left);
    std::memcpy(dst + left, src, sizeof(float) * len);
    std::memset(dst + left + len, 0, sizeof(float) * (target - len - left));
  }
}

}  // namespace

extern "C" {

// Collate a batch of coupled (body, air) utterances into two (batch, target)
// row-major buffers.  `airs` may be null (no-reference loaders).  Both
// signals of a pair share one length and one crop offset, preserving
// cross-sensor time alignment.
void vx_collate_pair(const float* const* bodies, const float* const* airs,
                     const int64_t* lengths, const int64_t* offsets,
                     float* out_body, float* out_air, int64_t batch,
                     int64_t target, int max_threads) {
  parallel_for(batch, max_threads, [=](int64_t i) {
    fix_length_row(bodies[i], lengths[i], offsets[i], out_body + i * target,
                   target);
    if (airs != nullptr) {
      fix_length_row(airs[i], lengths[i], offsets[i], out_air + i * target,
                     target);
    }
  });
}

// Polyphase FIR resample of `in` (length in_len) with a precomputed kernel
// bank `kernels` of shape (phases, width_total) row-major.  Output sample
// t = win*phases + p is the dot of phase p's taps with the input window
// starting at win*orig_freq - left_pad (zero outside the signal) — the same
// arithmetic as the strided-conv path (ops/resample.py, KaiserResampler).
// f64 accumulation keeps it within float tolerance of that path.
void vx_resample_poly(const float* in, int64_t in_len, const float* kernels,
                      int64_t phases, int64_t width_total, int64_t orig_freq,
                      int64_t left_pad, float* out, int64_t out_len,
                      int max_threads) {
  const int64_t n_wins = (out_len + phases - 1) / phases;
  parallel_for(n_wins, max_threads, [=](int64_t win) {
    const int64_t in_start = win * orig_freq - left_pad;
    const int64_t w_lo = std::max<int64_t>(0, -in_start);
    const int64_t w_hi = std::min<int64_t>(width_total, in_len - in_start);
    for (int64_t p = 0; p < phases; ++p) {
      const int64_t t = win * phases + p;
      if (t >= out_len) break;
      const float* taps = kernels + p * width_total;
      double acc = 0.0;
      for (int64_t w = w_lo; w < w_hi; ++w) {
        acc += static_cast<double>(taps[w]) *
               static_cast<double>(in[in_start + w]);
      }
      out[t] = static_cast<float>(acc);
    }
  });
}

}  // extern "C"
