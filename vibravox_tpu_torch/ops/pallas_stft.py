"""Framed-DFT magnitude, forward and backward: K3 and K4 on Hopper.

Counterpart of ``vibravox_tpu/ops/pallas_stft.py``.  ``framed_dft_magnitude``
is |STFT| with ``torch.stft`` framing (center, reflect pad fft/2, periodic
Hann window zero-padded to fft) and the power clamped at eps before the
square root, on float32 ``(B, T)`` signals, returning ``(B, n_frames,
fft // 2 + 1)``.  It dispatches on the tensor's device:

* a CPU tensor runs ``plain_framed_dft_magnitude`` (``torch.stft``), and
  autograd differentiates it;
* a CUDA tensor runs a ``torch.autograd.Function`` whose forward is the
  hand-written kernel ``csrc/framed_dft.cu::framed_dft_magnitude_kernel``
  (K3, counterpart of the Pallas ``_fwd_kernel``) and whose backward is
  ``framed_dft_backward_kernel`` (K4, counterpart of ``_bwd_kernel``), or
  raises.  Neither falls back to the plain version.

Glue around the kernels stays in torch, as in the JAX package: the reflect
pad of the input, gom = g / |X| (0 where the clamp was active), and the
transpose of the reflect pad after K4.  The window-folded DFT rows are built
once per resolution on the host (``_dft_matrices``) and cached on the device.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vibravox_tpu_torch.ops import _build

__all__ = [
    "hann_window",
    "framed_dft_magnitude",
    "framed_dft_backward",
    "plain_framed_dft_magnitude",
    "plain_framed_dft_backward",
]

_MIN_HOP = 32  # K4 adds one chunk of 32 window rows per frame without collisions

_rows: Dict[Tuple[int, int, torch.device], Tuple[torch.Tensor, torch.Tensor]] = {}


def hann_window(win_length: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Periodic Hann window (``torch.hann_window``'s default)."""
    n = torch.arange(win_length, dtype=dtype, device=device)
    return 0.5 - 0.5 * torch.cos(2.0 * torch.pi * n / win_length)


@functools.lru_cache(maxsize=None)
def _dft_matrices(fft_size: int, win_length: int):
    """Real/imag rDFT rows with the periodic Hann window folded in, float32
    ``(win, fft // 2 + 1)`` each: the rows pad_l .. pad_l + win of the
    fft-long window-folded matrices, the only rows where the centred window
    is not zero (pad_l = (fft - win) // 2)."""
    n = np.arange(win_length)
    win = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
    t = ((fft_size - win_length) // 2 + n)[:, None]
    k = np.arange(fft_size // 2 + 1)[None, :]
    angle = -2.0 * np.pi * t * k / fft_size
    return ((np.cos(angle) * win[:, None]).astype(np.float32),
            (np.sin(angle) * win[:, None]).astype(np.float32))


def plain_framed_dft_magnitude(
    x: torch.Tensor, fft_size: int, hop: int, win_length: int, eps: float = 1e-8
) -> torch.Tensor:
    """Plain PyTorch version of K3: ``torch.stft`` then sqrt(max(power, eps))."""
    spec = torch.stft(
        x, fft_size, hop_length=hop, win_length=win_length,
        window=hann_window(win_length, x.dtype, x.device), center=True, pad_mode="reflect",
        normalized=False, onesided=True, return_complex=True,
    )
    power = spec.real**2 + spec.imag**2
    return torch.sqrt(torch.clamp(power, min=eps)).transpose(1, 2)


def plain_framed_dft_backward(
    x: torch.Tensor, g: torch.Tensor, fft_size: int, hop: int, win_length: int, eps: float = 1e-8
) -> torch.Tensor:
    """Plain PyTorch version of K4: autograd of the plain magnitude for the
    cotangent ``g`` of the magnitude."""
    with torch.enable_grad():
        xr = x.detach().requires_grad_(True)
        mag = plain_framed_dft_magnitude(xr, fft_size, hop, win_length, eps)
        (dx,) = torch.autograd.grad(mag, xr, g)
    return dx


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _build.load("framed_dft")
    lib.vx_framed_dft_magnitude.restype = ctypes.c_int
    lib.vx_framed_dft_magnitude.argtypes = (
        [ctypes.c_void_p] * 4  # xp, wc, ws, mag
        + [ctypes.c_int] * 7  # batch, t_pad, n_frames, hop, pad_l, win, n_bins
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]  # eps, device, stream
    )
    lib.vx_framed_dft_backward.restype = ctypes.c_int
    lib.vx_framed_dft_backward.argtypes = (
        [ctypes.c_void_p] * 5  # xp, gom, wc, ws, dxp
        + [ctypes.c_int] * 7  # batch, t_pad, n_frames, hop, pad_l, win, n_bins
        + [ctypes.c_int, ctypes.c_void_p]  # device, stream
    )
    lib.vx_error_string.restype = ctypes.c_char_p
    lib.vx_error_string.argtypes = [ctypes.c_int]
    return lib


def _window_rows(fft_size: int, win_length: int, device: torch.device):
    """``_dft_matrices`` cached on the device."""
    key = (fft_size, win_length, device)
    if key not in _rows:
        _rows[key] = tuple(torch.from_numpy(m).to(device) for m in _dft_matrices(fft_size, win_length))
    return _rows[key]


def _check_cuda(x: torch.Tensor, fft_size: int, hop: int, win_length: int) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"the framed-DFT kernels take float32, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"expected (B, T), got shape {tuple(x.shape)}")
    if not 1 <= x.shape[0] <= 65535:
        raise ValueError(f"batch must be in [1, 65535], got {x.shape[0]}")
    if x.shape[1] <= fft_size // 2:
        raise ValueError(f"reflect padding by {fft_size // 2} needs T > {fft_size // 2}, got {x.shape[1]}")
    if not (0 < win_length <= fft_size and fft_size % 2 == 0):
        raise ValueError(f"need an even fft and 0 < win <= fft, got fft={fft_size}, win={win_length}")
    if hop < _MIN_HOP:
        raise ValueError(f"the framed-DFT backward kernel needs hop >= {_MIN_HOP}, got {hop}")


def _geometry(x: torch.Tensor, fft_size: int, hop: int, win_length: int):
    """(reflect-padded xp, t_pad, n_frames, pad_l, n_bins)."""
    xp = F.pad(x[:, None, :], (fft_size // 2, fft_size // 2), mode="reflect")[:, 0, :].contiguous()
    return xp, xp.shape[1], 1 + x.shape[1] // hop, (fft_size - win_length) // 2, fft_size // 2 + 1


def _launch_magnitude(x, fft_size, hop, win_length, eps) -> torch.Tensor:
    xp, t_pad, n_frames, pad_l, n_bins = _geometry(x, fft_size, hop, win_length)
    wc, ws = _window_rows(fft_size, win_length, x.device)
    mag = torch.empty(x.shape[0], n_frames, n_bins, device=x.device, dtype=torch.float32)
    lib = _library()
    err = lib.vx_framed_dft_magnitude(
        xp.data_ptr(), wc.data_ptr(), ws.data_ptr(), mag.data_ptr(), x.shape[0], t_pad,
        n_frames, hop, pad_l, win_length, n_bins, float(eps), x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"framed-DFT magnitude launch failed: {lib.vx_error_string(err).decode()}")
    framed_dft_magnitude.launches += 1
    return mag


class _FramedDFTMagnitude(torch.autograd.Function):
    """K3 forward, K4 backward."""

    @staticmethod
    def forward(ctx, x, fft_size, hop, win_length, eps):
        mag = _launch_magnitude(x, fft_size, hop, win_length, eps)
        ctx.geometry = (fft_size, hop, win_length, eps)
        ctx.save_for_backward(x, mag)
        return mag

    @staticmethod
    def backward(ctx, g):
        x, mag = ctx.saved_tensors
        return (framed_dft_backward(x, mag, g, *ctx.geometry), None, None, None, None)


def framed_dft_magnitude(
    x: torch.Tensor, fft_size: int, hop: int, win_length: int, eps: float = 1e-8
) -> torch.Tensor:
    """|STFT| of float32 ``(B, T)`` -> ``(B, n_frames, fft // 2 + 1)``.  CPU
    tensors take the plain version; CUDA tensors launch K3 (one added to
    ``framed_dft_magnitude.launches``), and their gradient is K4."""
    if x.device.type == "cpu":
        return plain_framed_dft_magnitude(x, fft_size, hop, win_length, eps)
    if x.device.type != "cuda":
        raise ValueError(f"framed_dft_magnitude runs on cpu or cuda, got {x.device}")
    _check_cuda(x, fft_size, hop, win_length)
    return _FramedDFTMagnitude.apply(x.contiguous(), int(fft_size), int(hop), int(win_length), float(eps))


framed_dft_magnitude.launches = 0


def framed_dft_backward(
    x: torch.Tensor, mag: torch.Tensor, g: torch.Tensor,
    fft_size: int, hop: int, win_length: int, eps: float = 1e-8,
) -> torch.Tensor:
    """Gradient of ``framed_dft_magnitude`` at ``x`` (whose magnitude is
    ``mag``) for the cotangent ``g``.  CPU tensors take the plain version;
    CUDA tensors launch K4 and add one to ``framed_dft_backward.launches``."""
    if x.device.type == "cpu":
        return plain_framed_dft_backward(x, g, fft_size, hop, win_length, eps)
    if x.device.type != "cuda":
        raise ValueError(f"framed_dft_backward runs on cpu or cuda, got {x.device}")
    _check_cuda(x, fft_size, hop, win_length)
    xp, t_pad, n_frames, pad_l, n_bins = _geometry(x, fft_size, hop, win_length)
    if tuple(mag.shape) != (x.shape[0], n_frames, n_bins) or tuple(g.shape) != tuple(mag.shape):
        raise ValueError(f"mag {tuple(mag.shape)} and g {tuple(g.shape)} must be {(x.shape[0], n_frames, n_bins)}")
    # d|X|/d re = re / |X|, 0 where the power clamp was active
    gom = torch.where(mag > math.sqrt(eps), g.float() / mag, 0.0).contiguous()
    wc, ws = _window_rows(fft_size, win_length, x.device)
    dxp = torch.empty_like(xp)
    lib = _library()
    err = lib.vx_framed_dft_backward(
        xp.data_ptr(), gom.data_ptr(), wc.data_ptr(), ws.data_ptr(), dxp.data_ptr(),
        x.shape[0], t_pad, n_frames, hop, pad_l, win_length, n_bins, x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"framed-DFT backward launch failed: {lib.vx_error_string(err).decode()}")
    framed_dft_backward.launches += 1
    # transpose of the reflect pad: fold the edge gradients back inside
    pad, t = fft_size // 2, x.shape[1]
    dx = dxp[:, pad : pad + t].clone()
    dx[:, 1 : pad + 1] += dxp[:, :pad].flip(1)
    dx[:, t - pad - 1 : t - 1] += dxp[:, pad + t :].flip(1)
    return dx


framed_dft_backward.launches = 0
