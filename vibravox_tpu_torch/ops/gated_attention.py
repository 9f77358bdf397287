"""WavLM's gated relative-position attention on Hopper, forward and backward.

softmax(q k^T / sqrt(d) + g D_T) v for q, k, v (B, H, T, d), the gate g
(B, H, T) and D (H, 2T - 1), where D_T[h, i, j] = D[h, j - i + T - 1]: the bias
``gate * P`` of ``models/wavlm.py`` without the (B, H, T, T) tensor, since
WavLM's position table P is Toeplitz and D is its diagonals
(``toeplitz_diagonals``).  ``gated_attention`` runs a
``torch.autograd.Function`` over the hand-written kernels of
``csrc/gated_attention.cu`` on CUDA float32 tensors with d = 64: the
forward keeps the rows' logsumexp, the backward returns dq, dk, dv, dg and
dD, the two bias gradients summed in the kernels.  It never falls back to
a library attention; a tensor it does not take raises.
``plain_gated_attention`` is the same function in plain PyTorch (the bias
made from D by indexing, an explicit softmax), which autograd
differentiates: the twin the kernels are tested against.

``takes`` is the dispatch rule ``models/wavlm.py`` applies: a CUDA float32
call with heads of 64.  Everything else (the CPU, bfloat16, other widths)
stays on ``F.scaled_dot_product_attention`` with the materialised bias.
Everything is IEEE float32 and summed in a fixed order: two runs are
bit-equal.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from vibravox_tpu_torch.ops import _build

__all__ = ["takes", "toeplitz_diagonals", "gated_attention", "plain_gated_attention"]

HEAD_DIM = 64
SCALE = HEAD_DIM ** -0.5  # SDPA's default scale, exact in float32


def takes(device_type: str, dtype: torch.dtype, head_dim: int) -> bool:
    """Whether a call runs on the kernel: CUDA, float32, heads of 64."""
    return device_type == "cuda" and dtype == torch.float32 and head_dim == HEAD_DIM


def toeplitz_diagonals(position: torch.Tensor) -> torch.Tensor:
    """The (H, 2T - 1) diagonals of a Toeplitz (H, T, T) table P, D[h, j - i +
    T - 1] = P[h, i, j]: P's first column reversed, then its first row after
    the corner; views of P, so a gradient of D reaches P."""
    return torch.cat((position[:, :, 0].flip(-1), position[:, 0, 1:]), dim=-1)


def _bias(gate: torch.Tensor, diag: torch.Tensor) -> torch.Tensor:
    """g[b, h, i] D[h, j - i + T - 1], (B, H, T, T)."""
    t = gate.shape[-1]
    pos = torch.arange(t, device=diag.device)
    return gate[..., None] * diag[:, pos[None, :] - pos[:, None] + t - 1]


def plain_gated_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, gate: torch.Tensor,
                          diag: torch.Tensor) -> torch.Tensor:
    """The function in plain PyTorch: softmax(q k^T / sqrt(d) + g D_T) v."""
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1]) + _bias(gate, diag)
    return torch.matmul(torch.softmax(scores, dim=-1), v)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _build.load("gated_attention")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.vx_gated_attention_forward.restype = i32
    # q, k, v, gate, diag, out, lse, strides; batch, heads, t; scale; device, stream
    lib.vx_gated_attention_forward.argtypes = [ptr] * 8 + [i32] * 3 + [f32, i32, ptr]
    lib.vx_gated_attention_scratch.restype = ctypes.c_longlong
    lib.vx_gated_attention_scratch.argtypes = [i32] * 4
    lib.vx_gated_attention_backward.restype = i32
    # q, k, v, gate, diag, out, dout, lse, dq, dk, dv, dgate, ddiag, 4 scratch, strides; ...
    lib.vx_gated_attention_backward.argtypes = [ptr] * 18 + [i32] * 3 + [f32, i32, ptr]
    lib.vx_error_string.restype = ctypes.c_char_p
    lib.vx_error_string.argtypes = [i32]
    return lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"gated attention {what} failed: {_library().vx_error_string(err).decode()}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _rows(t: torch.Tensor) -> torch.Tensor:
    """t, or a contiguous copy where the kernels cannot read it: the last dim
    contiguous, every other stride and the start 16-byte aligned."""
    if t.stride(-1) != 1 or any(s % 4 for s in t.stride()[:-1]) or t.data_ptr() % 16:
        return t.contiguous()
    return t


def _strides(*ts: torch.Tensor):
    """The (batch, head, time) element strides of each tensor, as the C array
    the library reads."""
    flat = [s for t in ts for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _like_heads(q: torch.Tensor) -> torch.Tensor:
    """An empty (B, H, T, d) float32 tensor laid out (B, T, H, d), the layout
    of the heads of a (B, T, H d) projection, so that merging the heads
    again copies nothing."""
    b, h, t, d = q.shape
    return torch.empty(b, t, h, d, device=q.device, dtype=torch.float32).transpose(1, 2)


def _check(q, k, v, gate, diag) -> None:
    if q.device.type != "cuda" or q.dtype != torch.float32:
        raise TypeError(f"the CUDA kernel takes float32 CUDA input, got {q.dtype} on {q.device}")
    if q.dim() != 4 or q.shape[-1] != HEAD_DIM:
        raise ValueError(f"the CUDA kernel takes (B, H, T, {HEAD_DIM}) q, k, v, got {tuple(q.shape)}")
    b, h, t, _ = q.shape
    for name, x, shape in (("k", k, q.shape), ("v", v, q.shape), ("gate", gate, (b, h, t)),
                           ("diag", diag, (h, 2 * t - 1))):
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(x.shape)}")
        if x.dtype != torch.float32 or x.device != q.device:
            raise TypeError(f"{name} must be float32 on {q.device}, got {x.dtype} on {x.device}")
    if not 1 <= b * h <= 65535:
        raise ValueError(f"batch x heads must be in [1, 65535], got {b * h}")


def _forward(q, k, v, gate, diag) -> Tuple[torch.Tensor, torch.Tensor]:
    b, h, t, _ = q.shape
    out = _like_heads(q)
    lse = torch.empty(b, h, t, device=q.device, dtype=torch.float32)
    strides = _strides(q, k, v, out)
    err = _library().vx_gated_attention_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), gate.data_ptr(), diag.data_ptr(), out.data_ptr(),
        lse.data_ptr(), ctypes.addressof(strides), b, h, t, SCALE, q.device.index or 0, _stream(q))
    _raise_on(err, "forward")
    return out, lse


def _backward(q, k, v, gate, diag, out, dout, lse):
    b, h, t, _ = q.shape
    lib = _library()
    dq, dk, dv = _like_heads(q), _like_heads(q), _like_heads(q)
    dgate = torch.empty(b, h, t, device=q.device, dtype=torch.float32)
    ddiag = torch.empty(h, 2 * t - 1, device=q.device, dtype=torch.float32)
    scratch = [torch.empty(lib.vx_gated_attention_scratch(which, b, h, t), device=q.device, dtype=torch.float32)
               for which in range(4)]
    strides = _strides(q, k, v, out, dout, dq, dk, dv)
    err = lib.vx_gated_attention_backward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), gate.data_ptr(), diag.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dgate.data_ptr(),
        ddiag.data_ptr(), *(s.data_ptr() for s in scratch), ctypes.addressof(strides), b, h, t, SCALE,
        q.device.index or 0, _stream(q))
    _raise_on(err, "backward")
    return dq, dk, dv, dgate, ddiag


class _GatedAttention(torch.autograd.Function):
    """The forward kernel; the backward kernels, whose dg and dD are returned
    only where the gate and D need them."""

    @staticmethod
    def forward(ctx, q, k, v, gate, diag):
        out, lse = _forward(q, k, v, gate, diag)
        ctx.save_for_backward(q, k, v, gate, diag, out, lse)
        gated_attention.launches += 1
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, gate, diag, out, lse = ctx.saved_tensors
        dq, dk, dv, dgate, ddiag = _backward(q, k, v, gate, diag, out, _rows(dout), lse)
        gated_attention.launches += 1
        keep = ctx.needs_input_grad
        return (dq if keep[0] else None, dk if keep[1] else None, dv if keep[2] else None,
                dgate if keep[3] else None, ddiag if keep[4] else None)


def gated_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, gate: torch.Tensor,
                    diag: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d) + g D_T) v, (B, H, T, d), for q, k, v (B, H, T,
    d), the gate (B, H, T) and the diagonals D (H, 2T - 1).

    The tensors must be CUDA float32 with d = 64 (``takes``); anything
    else raises.  A call launches the forward kernels and adds one to
    ``gated_attention.launches``, as its backward does.  The output is laid
    out (B, T, H, d) and returned as its (B, H, T, d) view."""
    _check(q, k, v, gate, diag)
    q, k, v = _rows(q), _rows(k), _rows(v)
    return _GatedAttention.apply(q, k, v, gate.contiguous(), diag.contiguous())


gated_attention.launches = 0
