"""PyTorch/CUDA port of vibravox_tpu for NVIDIA Hopper GPUs.

Layout mirrors the JAX package (``ops/``, ``models/``, ``serving.py``).
Tensors are NCW inside the models; public entry points keep the JAX
package's ``(B, T, 1)`` audio layout.  Entry points run on ``cuda`` unless
given ``device="cpu"``.  This package never imports JAX or ``vibravox_tpu``.
"""

from vibravox_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
