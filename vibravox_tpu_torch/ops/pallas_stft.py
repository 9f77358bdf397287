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

Both kernels are shared-memory FFTs and take the unpadded signal: the
reflect pad, gom = g / |X| (0 where the clamp was active) and the transpose
of the reflect pad happen inside them (K4 is two launches: the frames'
gradients into a scratch buffer, then their ordered sum into dx).  Their
only tables are the fft-point twiddles and the fft-long window
(``_kernel_tables``), built once per resolution on the host in float64 and
cached on the device.  The CUDA path takes a power-of-two fft from 64 to
4096 (the JAX function takes any even fft) and any hop.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Tuple

import numpy as np
import torch

from vibravox_tpu_torch.ops import _build

__all__ = [
    "hann_window",
    "framed_dft_magnitude",
    "framed_dft_backward",
    "plain_framed_dft_magnitude",
    "plain_framed_dft_backward",
]

MIN_FFT, MAX_FFT = 64, 4096  # the fft sizes the kernels are built for (powers of two)

_tables: Dict[Tuple[int, int, torch.device], Tuple[torch.Tensor, torch.Tensor]] = {}


def hann_window(win_length: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Periodic Hann window (``torch.hann_window``'s default)."""
    n = torch.arange(win_length, dtype=dtype, device=device)
    return 0.5 - 0.5 * torch.cos(2.0 * torch.pi * n / win_length)


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


@functools.lru_cache(maxsize=None)
def _kernel_tables(fft_size: int, win_length: int):
    """The kernels' tables, float32, computed in float64: the twiddles
    exp(-2 pi i m / fft) for m < fft as (fft, 2) (re, im) rows, and the
    periodic Hann window of win_length taps centred in fft samples (zero
    outside pad_l .. pad_l + win, pad_l = (fft - win) // 2)."""
    m = np.arange(fft_size)
    angle = -2.0 * np.pi * m / fft_size
    twiddles = np.stack([np.cos(angle), np.sin(angle)], axis=1).astype(np.float32)
    window = np.zeros(fft_size)
    pad_l = (fft_size - win_length) // 2
    window[pad_l : pad_l + win_length] = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(win_length) / win_length)
    return twiddles, window.astype(np.float32)


def _device_tables(fft_size: int, win_length: int, device: torch.device):
    """``_kernel_tables`` cached on the device."""
    key = (fft_size, win_length, device)
    if key not in _tables:
        _tables[key] = tuple(torch.from_numpy(t).to(device) for t in _kernel_tables(fft_size, win_length))
    return _tables[key]


def _pairs_per_chunk(fft_size: int) -> int:
    """Frame pairs one block transforms at once: a block has max(256,
    fft / 8) threads, each holding 8 points of a pair's fft-point FFT."""
    return max(256, fft_size // 8) * 8 // fft_size


def _chunking(fft_size: int, hop: int, win_length: int, n_frames: int) -> Tuple[int, int]:
    """(chunks per row, span): a K3/K4 block transforms one chunk of 2P
    consecutive frames, and K4's block adds its frames' gradients over the
    span of (2P - 1) hop + win padded positions they cover."""
    chunk = 2 * _pairs_per_chunk(fft_size)
    return -(-n_frames // chunk), (chunk - 1) * hop + win_length


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _build.load("framed_dft")
    lib.vx_framed_dft_magnitude.restype = ctypes.c_int
    lib.vx_framed_dft_magnitude.argtypes = (
        [ctypes.c_void_p] * 4  # x, twiddles, window, mag
        + [ctypes.c_int] * 7  # batch, t, n_frames, fft, hop, pad_l, win
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]  # eps, device, stream
    )
    lib.vx_framed_dft_backward.restype = ctypes.c_int
    lib.vx_framed_dft_backward.argtypes = (
        [ctypes.c_void_p] * 7  # x, g, mag, twiddles, window, partial, dx
        + [ctypes.c_int] * 7  # batch, t, n_frames, fft, hop, pad_l, win
        + [ctypes.c_longlong, ctypes.c_float]  # partial's size, sqrt(eps)
        + [ctypes.c_int, ctypes.c_void_p]  # device, stream
    )
    lib.vx_error_string.restype = ctypes.c_char_p
    lib.vx_error_string.argtypes = [ctypes.c_int]
    return lib


def _check_cuda(x: torch.Tensor, fft_size: int, hop: int, win_length: int) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"the framed-DFT kernels take float32, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"expected (B, T), got shape {tuple(x.shape)}")
    if not 1 <= x.shape[0] <= 65535:
        raise ValueError(f"batch must be in [1, 65535], got {x.shape[0]}")
    if not (MIN_FFT <= fft_size <= MAX_FFT and fft_size & (fft_size - 1) == 0):
        raise ValueError(f"the framed-DFT kernels take a power-of-two fft in [{MIN_FFT}, {MAX_FFT}], got {fft_size}")
    if not 0 < win_length <= fft_size:
        raise ValueError(f"need 0 < win <= fft, got fft={fft_size}, win={win_length}")
    if hop < 1:
        raise ValueError(f"need hop >= 1, got {hop}")
    if x.shape[1] <= fft_size // 2:
        raise ValueError(f"reflect padding by {fft_size // 2} needs T > {fft_size // 2}, got {x.shape[1]}")


def _launch_magnitude(x, fft_size, hop, win_length, eps) -> torch.Tensor:
    batch, t = x.shape
    n_frames = 1 + t // hop
    twiddles, window = _device_tables(fft_size, win_length, x.device)
    mag = torch.empty(batch, n_frames, fft_size // 2 + 1, device=x.device, dtype=torch.float32)
    lib = _library()
    err = lib.vx_framed_dft_magnitude(
        x.data_ptr(), twiddles.data_ptr(), window.data_ptr(), mag.data_ptr(), batch, t, n_frames,
        fft_size, hop, (fft_size - win_length) // 2, win_length, float(eps), x.device.index or 0,
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
    batch, t = x.shape
    n_frames = 1 + t // hop
    want = (batch, n_frames, fft_size // 2 + 1)
    if tuple(mag.shape) != want or tuple(g.shape) != want:
        raise ValueError(f"mag {tuple(mag.shape)} and g {tuple(g.shape)} must be {want}")
    x, mag, g = (v.to(torch.float32).contiguous() for v in (x, mag, g))
    twiddles, window = _device_tables(fft_size, win_length, x.device)
    n_chunks, span = _chunking(fft_size, hop, win_length, n_frames)
    partial = torch.empty(batch * n_chunks * span, device=x.device, dtype=torch.float32)
    dx = torch.empty_like(x)
    lib = _library()
    err = lib.vx_framed_dft_backward(
        x.data_ptr(), g.data_ptr(), mag.data_ptr(), twiddles.data_ptr(), window.data_ptr(),
        partial.data_ptr(), dx.data_ptr(), batch, t, n_frames, fft_size, hop,
        (fft_size - win_length) // 2, win_length, partial.numel(), math.sqrt(eps),
        x.device.index or 0, torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"framed-DFT backward launch failed: {lib.vx_error_string(err).decode()}")
    framed_dft_backward.launches += 1
    return dx


framed_dft_backward.launches = 0
