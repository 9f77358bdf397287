"""Log-mel front end of the speaker embedders (PyTorch).

Counterpart of ``vibravox_tpu/ops/mel.py``: ``mel_filterbank`` is the JAX
package's numpy function, copied (HTK mel scale by default, Slaney on
request), and ``log_mel_spectrogram`` is log(|STFT|^2 @ fb + eps) with
``torch.stft`` framing.  The magnitude goes through
``ops/pallas_stft.py::framed_dft_magnitude``: on a CUDA tensor the
hand-written kernel K3 (the counterpart of the Pallas ``_fwd_kernel``,
which computes this function; the JAX front end runs it in XLA), on a CPU
tensor its plain version.  The power is clamped at 1e-8 before the square
root, as ``vibravox_tpu/ops/stft.py::stft_magnitude`` does, and the front
end stays float32 whatever the embedder's trunk computes in.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vibravox_tpu_torch.ops.pallas_stft import framed_dft_magnitude

__all__ = ["mel_filterbank", "log_mel_spectrogram"]


def _hz_to_mel(f: np.ndarray, htk: bool = True) -> np.ndarray:
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    # slaney
    f = np.atleast_1d(f)
    mel = f / (200.0 / 3)
    log_region = f >= 1000.0
    mel[log_region] = 15.0 + np.log(f[log_region] / 1000.0) / (np.log(6.4) / 27.0)
    return mel


def _mel_to_hz(m: np.ndarray, htk: bool = True) -> np.ndarray:
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    m = np.atleast_1d(m)
    f = m * (200.0 / 3)
    log_region = m >= 15.0
    f[log_region] = 1000.0 * np.exp((np.log(6.4) / 27.0) * (m[log_region] - 15.0))
    return f


@functools.lru_cache(maxsize=None)
def mel_filterbank(
    sample_rate: int,
    n_fft: int,
    n_mels: int = 80,
    f_min: float = 20.0,
    f_max: float | None = None,
    htk: bool = True,
) -> np.ndarray:
    """(n_fft//2+1, n_mels) triangular filterbank matrix."""
    f_max = f_max or sample_rate / 2
    mel_pts = np.linspace(
        _hz_to_mel(np.array([f_min]), htk)[0], _hz_to_mel(np.array([f_max]), htk)[0],
        n_mels + 2,
    )
    hz_pts = _mel_to_hz(mel_pts, htk)
    bins = np.linspace(0, sample_rate / 2, n_fft // 2 + 1)
    fb = np.zeros((len(bins), n_mels), dtype=np.float32)
    for m in range(n_mels):
        lo, center, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (bins - lo) / max(center - lo, 1e-9)
        down = (hi - bins) / max(hi - center, 1e-9)
        fb[:, m] = np.clip(np.minimum(up, down), 0, None)
    return fb


def log_mel_spectrogram(
    audio: torch.Tensor,
    sample_rate: int = 16000,
    n_fft: int = 512,
    hop: int = 160,
    win_length: int = 400,
    n_mels: int = 80,
    eps: float = 1e-6,
) -> torch.Tensor:
    """(B, T) waveform -> (B, frames, n_mels) log-mel features, float32.
    A CUDA tensor launches K3 once; a CPU tensor runs its plain version."""
    mag = framed_dft_magnitude(audio.float(), n_fft, hop, win_length)
    fb = _device_filterbank(sample_rate, n_fft, n_mels, mag.device)
    return torch.log(mag.square() @ fb + eps)


@functools.lru_cache(maxsize=None)
def _device_filterbank(sample_rate: int, n_fft: int, n_mels: int, device: torch.device) -> torch.Tensor:
    """``mel_filterbank`` as a float32 tensor, kept on ``device``."""
    return torch.from_numpy(mel_filterbank(sample_rate, n_fft, n_mels)).to(device)
