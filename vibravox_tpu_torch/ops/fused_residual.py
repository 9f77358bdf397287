"""Fused EBEN residual stack (three dilated ResidualUnits): K1 on Hopper.

A ResidualUnit is ``x + leaky(pointwise(dilated_k3(x)))`` with reflect
"same" padding; the encoder and decoder blocks chain three of them
(dilations 1, 3, 9).  ``residual_stack`` dispatches on the tensor's device:

* a CPU tensor runs ``plain_residual_stack``, six convolutions as in the
  JAX package's ``_plain_stack``;
* a CUDA tensor runs the hand-written kernel ``csrc/fused_residual.cu``
  (counterpart of the Pallas ``_fwd_kernel``), which computes the reflect
  edges itself, or raises.  It never falls back to the plain version.

Tensors are NCW ``(B, C, T)``; kernels are the *effective* (already
weight-normalised) torch-layout weights, per unit ``(wd (C, C, 3),
wp (C, C, 1))``, of the activations' dtype.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from vibravox_tpu_torch.ops import _build
from vibravox_tpu_torch.ops.conv import conv1d

__all__ = ["residual_stack", "plain_residual_stack"]

Kernels = Tuple[Tuple[torch.Tensor, torch.Tensor], ...]

_DILATIONS = (1, 3, 9)
_CHANNELS = (32, 64, 128)  # the instantiations compiled into the kernel
_MIN_T = 10  # reflect padding by 9 needs more than 9 samples
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def plain_residual_stack(
    x: torch.Tensor, kernels: Kernels, dilations: Sequence[int] = _DILATIONS, slope: float = 0.01
) -> torch.Tensor:
    """Plain PyTorch version: per unit, a reflect-padded dilated conv, a
    pointwise conv, leaky ReLU and the residual add."""
    for (wd, wp), d in zip(kernels, dilations):
        h = conv1d(x, wd, padding="same", dilation=int(d), pad_mode="reflect")
        h = conv1d(h, wp)
        x = x + F.leaky_relu(h, slope)
    return x


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _build.load("fused_residual")
    lib.vx_residual_stack.restype = ctypes.c_int
    lib.vx_residual_stack.argtypes = (
        [ctypes.c_void_p] * 8  # x, y, wd0, wp0, wd1, wp1, wd2, wp2
        + [ctypes.c_int] * 4  # batch, channels, t_len, dtype
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]  # slope, device, stream
    )
    lib.vx_error_string.restype = ctypes.c_char_p
    lib.vx_error_string.argtypes = [ctypes.c_int]
    return lib


def _check_cuda_inputs(x: torch.Tensor, flat, dilations) -> None:
    if tuple(int(d) for d in dilations) != _DILATIONS:
        raise ValueError(f"the CUDA kernel computes dilations {_DILATIONS}, got {tuple(dilations)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"the CUDA kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"expected NCW (B, C, T), got shape {tuple(x.shape)}")
    b, c, t = x.shape
    if c not in _CHANNELS:
        raise ValueError(f"the CUDA kernel is built for C in {_CHANNELS}, got C={c}")
    if t < _MIN_T:
        raise ValueError(f"reflect padding by 9 needs T >= {_MIN_T}, got T={t}")
    if b < 1 or b > 65535:
        raise ValueError(f"batch must be in [1, 65535], got {b}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if len(flat) != 6:
        raise ValueError("expected three (wd, wp) pairs")
    for i, w in enumerate(flat):
        want = (c, c, 3) if i % 2 == 0 else (c, c, 1)
        if tuple(w.shape) != want:
            raise ValueError(f"kernel {i} has shape {tuple(w.shape)}, expected {want}")
        if w.dtype != x.dtype or w.device != x.device:
            raise ValueError(f"kernel {i} is {w.dtype} on {w.device}, x is {x.dtype} on {x.device}")
        if not w.is_contiguous():
            raise ValueError(f"kernel {i} must be contiguous")


def residual_stack(
    x: torch.Tensor, kernels: Kernels, dilations: Sequence[int] = _DILATIONS, slope: float = 0.01
) -> torch.Tensor:
    """Three chained ResidualUnits on NCW ``(B, C, T)`` activations.

    CPU tensors take ``plain_residual_stack``; CUDA tensors launch the fused
    kernel and add one to ``residual_stack.launches``."""
    if x.device.type == "cpu":
        return plain_residual_stack(x, kernels, dilations, slope)
    if x.device.type != "cuda":
        raise ValueError(f"residual_stack runs on cpu or cuda, got {x.device}")
    flat = [w for pair in kernels for w in pair]
    if torch.is_grad_enabled() and (x.requires_grad or any(w.requires_grad for w in flat)):
        raise NotImplementedError(
            "the fused residual stack has no backward on CUDA yet (K2, the Pallas "
            "_bwd_kernel, comes with the training port); run under torch.no_grad() "
            "or torch.inference_mode()"
        )
    _check_cuda_inputs(x, flat, dilations)
    b, c, t = x.shape
    y = torch.empty_like(x)
    lib = _library()
    err = lib.vx_residual_stack(
        x.data_ptr(), y.data_ptr(), *[w.data_ptr() for w in flat],
        b, c, t, _DTYPES[x.dtype], float(slope), x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused residual stack launch failed: {lib.vx_error_string(err).decode()}")
    residual_stack.launches += 1
    return y


residual_stack.launches = 0
