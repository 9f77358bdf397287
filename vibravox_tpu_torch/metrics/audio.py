"""Intrusive audio quality metrics: SI-SDR (torch) and STOI (host numpy).

Counterpart of ``vibravox_tpu/metrics/audio.py``, the torchmetrics audio
metrics the reference wires into its SE eval (``base_se.py:40-47``):
:func:`si_sdr` runs on the tensors' device; :func:`stoi` is the JAX
package's numpy implementation of Taal et al. 2011, copied (silent-frame
removal gives data-dependent shapes, so it stays on the host), with its
16 kHz -> 10 kHz resampling through ``ops/resample.py``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vibravox_tpu_torch.ops.resample import resample

__all__ = ["si_sdr", "stoi"]


def si_sdr(preds: torch.Tensor, target: torch.Tensor, zero_mean: bool = False) -> torch.Tensor:
    """Scale-invariant SDR in dB, mean over leading axes (torchmetrics semantics)."""
    eps = torch.finfo(preds.dtype).eps
    if zero_mean:
        preds = preds - preds.mean(dim=-1, keepdim=True)
        target = target - target.mean(dim=-1, keepdim=True)
    alpha = ((preds * target).sum(dim=-1, keepdim=True) + eps) / (
        (target**2).sum(dim=-1, keepdim=True) + eps
    )
    projection = alpha * target
    noise = preds - projection
    ratio = ((projection**2).sum(dim=-1) + eps) / ((noise**2).sum(dim=-1) + eps)
    return torch.mean(10.0 * torch.log10(ratio))


# --------------------------------------------------------------------------- #
# STOI (Taal, Hendriks, Heusdens, Jensen 2011)
# --------------------------------------------------------------------------- #

_FS = 10000
_N_FRAME = 256
_NFFT = 512
_NUM_BANDS = 15
_MIN_FREQ = 150
_N = 30  # analysis segment length in frames (384 ms)
_BETA = -15.0
_DYN_RANGE = 40.0


@functools.lru_cache(maxsize=1)
def _third_octave_bands() -> np.ndarray:
    """(J, NFFT//2+1) one-third-octave band matrix at 10 kHz."""
    f = np.linspace(0, _FS, _NFFT + 1)[: _NFFT // 2 + 1]
    cf = _MIN_FREQ * np.power(2.0, np.arange(_NUM_BANDS) / 3.0)
    lo = cf * 2 ** (-1 / 6)
    hi = cf * 2 ** (1 / 6)
    obm = np.zeros((_NUM_BANDS, len(f)))
    for i in range(_NUM_BANDS):
        lo_idx = np.argmin((f - lo[i]) ** 2)
        hi_idx = np.argmin((f - hi[i]) ** 2)
        obm[i, lo_idx:hi_idx] = 1.0
    return obm


def _frames(x: np.ndarray, win: np.ndarray, hop: int) -> np.ndarray:
    n = (len(x) - _N_FRAME) // hop + 1
    idx = np.arange(n)[:, None] * hop + np.arange(_N_FRAME)[None, :]
    return x[idx] * win


def _remove_silent_frames(x: np.ndarray, y: np.ndarray):
    hop = _N_FRAME // 2
    win = np.hanning(_N_FRAME + 2)[1:-1]
    xf = _frames(x, win, hop)
    energies = 20 * np.log10(np.linalg.norm(xf, axis=1) + np.finfo(np.float64).eps)
    mask = energies - np.max(energies) + _DYN_RANGE > 0
    if not mask.any():
        return None, None
    yf = _frames(y, win, hop)
    xf, yf = xf[mask], yf[mask]
    # overlap-add reconstruction
    n = len(xf)
    out_len = _N_FRAME + (n - 1) * hop
    xr = np.zeros(out_len)
    yr = np.zeros(out_len)
    for i in range(n):
        xr[i * hop : i * hop + _N_FRAME] += xf[i]
        yr[i * hop : i * hop + _N_FRAME] += yf[i]
    return xr, yr


def _stft_mag(x: np.ndarray) -> np.ndarray:
    hop = _N_FRAME // 2
    win = np.hanning(_N_FRAME + 2)[1:-1]
    frames = _frames(x, win, hop)
    return np.abs(np.fft.rfft(frames, n=_NFFT, axis=-1))


def _resample_to_10k(x: np.ndarray, fs: int) -> np.ndarray:
    if fs == _FS:
        return x
    return resample(torch.from_numpy(x.astype(np.float32))[None, :], fs, _FS)[0].numpy()


def stoi(clean: np.ndarray, denoised: np.ndarray, fs: int = 16000, extended: bool = False) -> float:
    """Short-Time Objective Intelligibility of ``denoised`` w.r.t. ``clean``.

    1-D inputs at ``fs``; returns a scalar in roughly [0, 1].
    """
    clean = np.asarray(clean, dtype=np.float64).reshape(-1)
    denoised = np.asarray(denoised, dtype=np.float64).reshape(-1)
    clean = _resample_to_10k(clean, fs).astype(np.float64)
    denoised = _resample_to_10k(denoised, fs).astype(np.float64)

    clean, denoised = _remove_silent_frames(clean, denoised)
    if clean is None:
        return 1e-5

    x_spec = _stft_mag(clean)  # (frames, F)
    y_spec = _stft_mag(denoised)
    if x_spec.shape[0] < _N:
        return 1e-5
    obm = _third_octave_bands()
    x_bands = np.sqrt((x_spec**2) @ obm.T)  # (frames, J)
    y_bands = np.sqrt((y_spec**2) @ obm.T)

    eps = np.finfo(np.float64).eps
    d_sum = 0.0
    n_seg = x_bands.shape[0] - _N + 1
    for m in range(n_seg):
        X = x_bands[m : m + _N].T  # (J, N)
        Y = y_bands[m : m + _N].T
        if extended:
            Xn = (X - X.mean(axis=1, keepdims=True)) / (X.std(axis=1, keepdims=True) + eps)
            Yn = (Y - Y.mean(axis=1, keepdims=True)) / (Y.std(axis=1, keepdims=True) + eps)
            Xn = Xn / (np.linalg.norm(Xn, axis=0, keepdims=True) + eps)
            Yn = Yn / (np.linalg.norm(Yn, axis=0, keepdims=True) + eps)
            d_sum += np.sum(Xn * Yn) / _NUM_BANDS
        else:
            alpha = np.linalg.norm(X, axis=1, keepdims=True) / (
                np.linalg.norm(Y, axis=1, keepdims=True) + eps
            )
            Y_scaled = Y * alpha
            clip_val = 10 ** (-_BETA / 20)
            Y_prime = np.minimum(Y_scaled, X * (1 + clip_val))
            xm = X - X.mean(axis=1, keepdims=True)
            ym = Y_prime - Y_prime.mean(axis=1, keepdims=True)
            corr = np.sum(xm * ym, axis=1) / (
                np.linalg.norm(xm, axis=1) * np.linalg.norm(ym, axis=1) + eps
            )
            d_sum += np.mean(corr)
    return float(d_sum / n_seg)
