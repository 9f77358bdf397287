"""Elementary reconstruction losses (config-instantiable), counterpart of
``vibravox_tpu/losses/simple.py``."""

from __future__ import annotations

import torch

__all__ = ["L1Loss", "l1_loss"]


def l1_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(x.float() - y.float()))


class L1Loss:
    """Mean absolute error (``torch.nn.L1Loss``), reduced in float32."""

    def __call__(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return l1_loss(x, y)
