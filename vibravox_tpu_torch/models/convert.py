"""Flax EBEN generator params -> this package's state dict.

The JAX package keeps conv kernels channels-last (WIO ``(k, in, out)``) and
weight-norm gains as ``(c,)`` vectors.  The port's modules use the reference
torch layout, so loading JAX weights is a relayout:

* plain conv ``kernel`` (k, in, out)      -> ``weight`` (out, in, k)
* weight-norm ``kernel_v`` (k, in, out)   -> ``parametrizations.weight.original1`` (out, in, k)
* weight-norm ``kernel_g`` (c,)           -> ``parametrizations.weight.original0`` (c, 1, 1)
* transposed-conv ``kernel_v`` is already (in, out, k) and is kept as it is
* the PQMF buffers are designed, not stored in the params.

The params are given as numpy arrays (``jax.device_get`` of the tree).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from vibravox_tpu_torch.ops.pqmf import design_pqmf_bank

__all__ = ["eben_generator_params_from_jax"]


def eben_generator_params_from_jax(
    params: Mapping[str, Any], m: int = 4, n: int = 32
) -> Dict[str, torch.Tensor]:
    """Flax ``EBENGenerator`` params (with or without the outer ``"params"``
    key) -> state dict for ``vibravox_tpu_torch.models.EBENGenerator``."""
    p = params["params"] if "params" in params else params
    sd: Dict[str, np.ndarray] = {}

    analysis, synthesis = design_pqmf_bank(m, n, 9.0)
    sd["pqmf.analysis_weights"] = analysis[:, None, :].astype(np.float32)
    sd["pqmf.synthesis_weights"] = synthesis[:, None, :].astype(np.float32)

    def put_conv(name: str, node: Mapping[str, Any]) -> None:
        sd[f"{name}.weight"] = np.transpose(np.asarray(node["kernel"]), (2, 1, 0))

    def put_wn(name: str, node: Mapping[str, Any], transposed: bool = False) -> None:
        v = np.asarray(node["kernel_v"])
        sd[f"{name}.parametrizations.weight.original0"] = np.asarray(node["kernel_g"]).reshape(-1, 1, 1)
        sd[f"{name}.parametrizations.weight.original1"] = v if transposed else np.transpose(v, (2, 1, 0))

    put_conv("first_conv", p["first_conv"])
    put_conv("last_conv", p["last_conv"])
    put_wn("latent_conv.1", p["latent_conv_0"])
    put_wn("latent_conv.3", p["latent_conv_1"])
    for i in range(3):
        put_wn(f"encoder_blocks.{i}.conv", p[f"enc_{i}"]["conv"])
        put_wn(f"decoder_blocks.{i}.conv_trans", p[f"dec_{i}"]["conv_trans"], transposed=True)
        for blk, key in ((f"encoder_blocks.{i}", f"enc_{i}"), (f"decoder_blocks.{i}", f"dec_{i}")):
            for j in range(3):
                node = p[key][f"residual_{j}"]
                put_wn(f"{blk}.residuals.{j}.dilated_conv", node["dilated_conv"])
                put_wn(f"{blk}.residuals.{j}.pointwise_conv", node["pointwise_conv"])
    return {k: torch.tensor(v) for k, v in sd.items()}
