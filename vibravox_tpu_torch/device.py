"""Device resolution and float32 precision policy for the port's entry points.

The port runs on the GPU: an entry point given no device uses ``cuda`` and
raises when there is none.  The CPU is used only when asked for
(``device="cpu"``), as the tests do.

float32 means IEEE float32: cuDNN would run float32 convolutions and RNNs in
TF32 by default, so the generator and the SQUIM predictors run under
``strict_float32()``, which also keeps CUDA's float32 matmuls out of TF32
whatever the caller set.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Union

import torch

__all__ = ["resolve_device", "strict_float32"]

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    if dev.type in ("cuda", "cpu"):
        return dev
    raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")


@contextlib.contextmanager
def strict_float32() -> Iterator[None]:
    """cuDNN convolutions and RNNs and CUDA matmuls in IEEE float32 (no
    TF32) inside the block; the caller's settings are restored after.  The
    settings are process-wide, so concurrent callers in other threads see
    them too.  Usable as a decorator."""
    conv, rnn, matmul = torch.backends.cudnn.conv, torch.backends.cudnn.rnn, torch.backends.cuda.matmul
    previous = conv.fp32_precision, rnn.fp32_precision, matmul.fp32_precision
    conv.fp32_precision = rnn.fp32_precision = matmul.fp32_precision = "ieee"
    try:
        yield
    finally:
        conv.fp32_precision, rnn.fp32_precision, matmul.fp32_precision = previous
