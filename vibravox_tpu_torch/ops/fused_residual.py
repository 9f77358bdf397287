"""Fused EBEN residual stack (three dilated ResidualUnits): K1 and K2 on Hopper.

A ResidualUnit is ``x + leaky(pointwise(dilated_k3(x)))`` with reflect
"same" padding; the encoder and decoder blocks chain three of them
(dilations 1, 3, 9).  ``residual_stack`` dispatches on the tensor's device:

* a CPU tensor runs ``plain_residual_stack``, six convolutions as in the
  JAX package's ``_plain_stack``, and autograd differentiates them;
* a CUDA tensor runs a ``torch.autograd.Function`` whose forward is the
  hand-written kernel ``csrc/fused_residual.cu`` (K1, counterpart of the
  Pallas ``_fwd_kernel``) and whose backward is ``csrc/fused_residual_bwd.cu``
  (K2, counterpart of ``_bwd_kernel``), or raises.  Neither falls back to
  the plain version.  K1 runs its products on the tensor cores: bf16
  operands for bfloat16, and for float32 three TF32 products of a hi/lo
  split of each operand (3xTF32), which holds float32's accuracy.  K2 runs
  bfloat16 on the tensor cores.  In float32 it recomputes the forward
  (x1, x2 and each unit's h1, h2) on FMAs in the plain convolutions'
  summation order, so that leaky'(h2) takes the plain chain's sign, which
  its float32 bar needs, and runs the gradient products (dWp, dh1, dWd,
  dx) on the tensor cores in 3xTF32 (see ``csrc/fused_residual_bwd.cu``).

``residual_stack_backward`` is K2's wrapper and ``plain_residual_stack_backward``
its plain version (autograd of the plain stack).  K2 returns dx in x's dtype
and dW summed in float32, cast to the weights' dtype, as the JAX
``_fused_bwd`` does.

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

__all__ = [
    "residual_stack",
    "residual_stack_config",
    "plain_residual_stack",
    "residual_stack_backward",
    "residual_stack_backward_config",
    "residual_stack_backward_recompute",
    "plain_residual_stack_backward",
]

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


def plain_residual_stack_backward(
    x: torch.Tensor, kernels: Kernels, g: torch.Tensor,
    dilations: Sequence[int] = _DILATIONS, slope: float = 0.01,
) -> Tuple[torch.Tensor, Kernels]:
    """Plain PyTorch version of K2: autograd of ``plain_residual_stack``.
    Returns ``(dx, ((dwd, dwp), ...))`` in the inputs' dtypes."""
    flat = [w.detach().requires_grad_(True) for pair in kernels for w in pair]
    with torch.enable_grad():
        xr = x.detach().requires_grad_(True)
        pairs = tuple((flat[2 * u], flat[2 * u + 1]) for u in range(len(flat) // 2))
        y = plain_residual_stack(xr, pairs, dilations, slope)
        dx, *dws = torch.autograd.grad(y, [xr, *flat], g)
    return dx, tuple((dws[2 * u], dws[2 * u + 1]) for u in range(len(dws) // 2))


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _build.load("fused_residual")
    lib.vx_residual_stack.restype = ctypes.c_int
    lib.vx_residual_stack.argtypes = (
        [ctypes.c_void_p] * 9  # x, y, wd0, wp0, wd1, wp1, wd2, wp2, wt
        + [ctypes.c_int] * 4  # batch, channels, t_len, dtype
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]  # slope, device, stream
    )
    lib.vx_residual_stack_config.restype = ctypes.c_int
    lib.vx_residual_stack_config.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
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


@functools.lru_cache(maxsize=1)
def _backward_library() -> ctypes.CDLL:
    lib = _build.load("fused_residual_bwd")
    lib.vx_residual_stack_backward_config.restype = ctypes.c_int
    lib.vx_residual_stack_backward_config.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.vx_residual_stack_backward.restype = ctypes.c_int
    lib.vx_residual_stack_backward.argtypes = (
        # x, g, dx, wd0, wp0, wd1, wp1, wd2, wp2, dw, x1, x2, g_a, g_b, partial, wt
        [ctypes.c_void_p] * 16
        + [ctypes.c_int] * 5  # blocks, batch, channels, t_len, dtype
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]  # slope, device, stream
    )
    lib.vx_error_string.restype = ctypes.c_char_p
    lib.vx_error_string.argtypes = [ctypes.c_int]
    return lib


@functools.lru_cache(maxsize=64)
def _backward_config(b: int, c: int, t: int, dtype: int, device: int) -> tuple:
    lib = _backward_library()
    out = (ctypes.c_int * 15)()
    err = lib.vx_residual_stack_backward_config(b, c, t, dtype, device, out)
    if err != 0:
        raise RuntimeError(f"fused residual backward set-up failed: {lib.vx_error_string(err).decode()}")
    return tuple(out)


def residual_stack_backward_config(b: int, c: int, t: int, dtype: torch.dtype, device: int = 0) -> dict:
    """K2's launch configuration for a shape on a CUDA device: the time tile,
    the persistent grid of its ``unit_backward`` passes (and so the number of
    dW partials), the tiles, and for the unit at each dilation the blocks per
    SM that occupancy allows, the dynamic shared memory, and the registers
    and local (spill) bytes per thread."""
    out = _backward_config(b, c, t, _DTYPES[dtype], device)
    keys = ("blocks_per_sm", "smem_bytes", "registers", "local_bytes")
    units = {f"d{d}": dict(zip(keys, out[3 + 4 * u : 7 + 4 * u])) for u, d in enumerate((9, 3, 1))}
    return {"tile": out[0], "grid": out[1], "tiles": out[2], "unit_backward": units}


def residual_stack_config(b: int, c: int, t: int, dtype: torch.dtype, device: int = 0) -> dict:
    """K1's launch configuration for a shape on a CUDA device: the time
    tile, the grid, the blocks per SM that occupancy allows, the dynamic
    shared memory, and the registers and local (spill) bytes per thread."""
    lib = _library()
    out = (ctypes.c_int * 7)()
    err = lib.vx_residual_stack_config(b, c, t, _DTYPES[dtype], device, out)
    if err != 0:
        raise RuntimeError(f"fused residual stack config failed: {lib.vx_error_string(err).decode()}")
    keys = ("tile", "grid_x", "grid_y", "blocks_per_sm", "smem_bytes", "registers", "local_bytes")
    return dict(zip(keys, out))


def _launch_forward(x: torch.Tensor, flat, slope: float) -> torch.Tensor:
    b, c, t = x.shape
    y = torch.empty_like(x)
    # scratch: the six weights laid out per (unit, tap) for the kernel's
    # 16-byte copies
    wt = torch.empty(12 * c * c, device=x.device, dtype=x.dtype)
    lib = _library()
    err = lib.vx_residual_stack(
        x.data_ptr(), y.data_ptr(), *[w.data_ptr() for w in flat], wt.data_ptr(),
        b, c, t, _DTYPES[x.dtype], float(slope), x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused residual stack launch failed: {lib.vx_error_string(err).decode()}")
    residual_stack.launches += 1
    return y


class _FusedResidualStack(torch.autograd.Function):
    """K1 forward, K2 backward."""

    @staticmethod
    def forward(ctx, x, slope, *flat):
        ctx.slope = slope
        ctx.save_for_backward(x, *flat)
        return _launch_forward(x, flat, slope)

    @staticmethod
    def backward(ctx, g):
        x, *flat = ctx.saved_tensors
        pairs = tuple((flat[2 * u], flat[2 * u + 1]) for u in range(3))
        dx, dws = residual_stack_backward(x, pairs, g, _DILATIONS, ctx.slope)
        return (dx, None, *[w for pair in dws for w in pair])


def residual_stack(
    x: torch.Tensor, kernels: Kernels, dilations: Sequence[int] = _DILATIONS, slope: float = 0.01
) -> torch.Tensor:
    """Three chained ResidualUnits on NCW ``(B, C, T)`` activations.

    CPU tensors take ``plain_residual_stack``; CUDA tensors launch the fused
    kernel K1 and add one to ``residual_stack.launches``; their gradient is
    K2 (``residual_stack_backward``)."""
    if x.device.type == "cpu":
        return plain_residual_stack(x, kernels, dilations, slope)
    if x.device.type != "cuda":
        raise ValueError(f"residual_stack runs on cpu or cuda, got {x.device}")
    flat = [w for pair in kernels for w in pair]
    _check_cuda_inputs(x, flat, dilations)
    return _FusedResidualStack.apply(x, float(slope), *flat)


residual_stack.launches = 0


def _launch_backward(x: torch.Tensor, flat, g: torch.Tensor, slope: float, code: int):
    """K2's launches for CUDA tensors (``code``: the library's dtype code);
    returns dx and the float32 dW, (3, 4 C^2)."""
    b, c, t = x.shape
    dev = x.device.index or 0
    blocks = _backward_config(b, c, t, _DTYPES[x.dtype], dev)[1]  # the grid: one dW partial a block
    g32 = g.detach().to(torch.float32).contiguous()
    dx = torch.empty_like(x)
    dw = torch.empty(3, 4 * c * c, device=x.device, dtype=torch.float32)
    x1, x2 = torch.empty_like(x), torch.empty_like(x)
    g_a, g_b = torch.empty_like(g32), torch.empty_like(g32)
    partial = torch.empty(blocks, 4 * c * c, device=x.device, dtype=torch.float32)
    # scratch: each unit's weights laid out for the kernels' 16-byte copies,
    # in eight [n][k] slots in bf16 and four [r][o] slots in float32
    wt = torch.empty((24 if x.dtype == torch.bfloat16 else 12) * c * c, device=x.device, dtype=x.dtype)
    lib = _backward_library()
    err = lib.vx_residual_stack_backward(
        x.data_ptr(), g32.data_ptr(), dx.data_ptr(), *[w.data_ptr() for w in flat],
        dw.data_ptr(), x1.data_ptr(), x2.data_ptr(), g_a.data_ptr(), g_b.data_ptr(),
        partial.data_ptr(), wt.data_ptr(), blocks, b, c, t, code, float(slope), dev,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused residual backward launch failed: {lib.vx_error_string(err).decode()}")
    return dx, dw


def _check_backward_inputs(x: torch.Tensor, kernels: Kernels, g: torch.Tensor, dilations) -> list:
    flat = [w for pair in kernels for w in pair]
    _check_cuda_inputs(x, flat, dilations)
    if tuple(g.shape) != tuple(x.shape) or g.device != x.device:
        raise ValueError(f"g is {tuple(g.shape)} on {g.device}, x is {tuple(x.shape)} on {x.device}")
    return flat


def residual_stack_backward(
    x: torch.Tensor, kernels: Kernels, g: torch.Tensor,
    dilations: Sequence[int] = _DILATIONS, slope: float = 0.01,
) -> Tuple[torch.Tensor, Kernels]:
    """Gradient of ``residual_stack`` at ``x`` for the output cotangent ``g``:
    ``(dx, ((dwd, dwp), ...))``.  CPU tensors take the plain version; CUDA
    tensors launch K2 and add one to ``residual_stack_backward.launches``."""
    if x.device.type == "cpu":
        return plain_residual_stack_backward(x, kernels, g, dilations, slope)
    if x.device.type != "cuda":
        raise ValueError(f"residual_stack_backward runs on cpu or cuda, got {x.device}")
    flat = _check_backward_inputs(x, kernels, g, dilations)
    dx, dw = _launch_backward(x, flat, g, slope, _DTYPES[x.dtype])
    residual_stack_backward.launches += 1
    c = x.shape[1]
    dws = tuple(
        (dw[u, : 3 * c * c].view(c, c, 3).to(flat[2 * u].dtype),
         dw[u, 3 * c * c :].view(c, c, 1).to(flat[2 * u + 1].dtype))
        for u in range(3)
    )
    return dx, dws


def residual_stack_backward_recompute(
    x: torch.Tensor, kernels: Kernels, g: torch.Tensor, slope: float = 0.01,
) -> None:
    """A timing aid for K2 in float32, on no path: the launches of
    ``residual_stack_backward`` with each unit's backward pass stopped after
    its recompute (h1, h2 and dh2 over the tile's window), so that its
    products' time is the whole pass's less this one's.  Computes no dx and
    no dW; CUDA float32 tensors only; not counted in
    ``residual_stack_backward.launches``."""
    if x.device.type != "cuda" or x.dtype != torch.float32:
        raise ValueError(f"the recompute alone runs on CUDA float32 tensors, got {x.dtype} on {x.device}")
    _launch_backward(x, _check_backward_inputs(x, kernels, g, _DILATIONS), g, slope, 2)


residual_stack_backward.launches = 0
