"""Flax EBEN params -> this package's state dicts.

The JAX package keeps conv kernels channels-last (WIO ``(k, in, out)``) and
weight-norm gains as ``(c,)`` vectors.  The port's modules use the reference
torch layout, so loading JAX weights is a relayout:

* plain conv ``kernel`` (k, in, out)      -> ``weight`` (out, in, k)
* weight-norm ``kernel_v`` (k, in, out)   -> ``parametrizations.weight.original1`` (out, in, k)
* weight-norm ``kernel_g`` (c,)           -> ``parametrizations.weight.original0`` (c, 1, 1)
* transposed-conv ``kernel_v`` is already (in, out, k) and is kept as it is
* the PQMF buffers are designed, not stored in the params.

wav2vec2 (``wav2vec2_state_dict_from_jax``): Dense ``kernel`` (in, out) ->
``weight`` (out, in), LayerNorm / GroupNorm ``scale`` -> ``weight``, and the
positional conv's ``conv_v`` (k, in / groups, out) / ``conv_g`` (k,) ->
``original1`` (out, in / groups, k) / ``original0`` (1, 1, k), under HF's
``Wav2Vec2ForCTC`` names.

The params are given as numpy arrays (``jax.device_get`` of the tree).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from vibravox_tpu_torch.ops.pqmf import design_pqmf_bank

__all__ = [
    "eben_generator_params_from_jax",
    "eben_discriminator_params_from_jax",
    "eben_train_state_from_jax",
    "wav2vec2_state_dict_from_jax",
]


def _put_wn(sd: Dict[str, np.ndarray], name: str, node: Mapping[str, Any], transposed: bool = False) -> None:
    """A weight-norm conv node -> ``original0`` (gains), ``original1``
    (direction, relaid from WIO unless the conv is transposed) and the bias
    when it has one."""
    v = np.asarray(node["kernel_v"])
    sd[f"{name}.parametrizations.weight.original0"] = np.asarray(node["kernel_g"]).reshape(-1, 1, 1)
    sd[f"{name}.parametrizations.weight.original1"] = v if transposed else np.transpose(v, (2, 1, 0))
    if "bias" in node:
        sd[f"{name}.bias"] = np.asarray(node["bias"])


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

    put_conv("first_conv", p["first_conv"])
    put_conv("last_conv", p["last_conv"])
    _put_wn(sd, "latent_conv.1", p["latent_conv_0"])
    _put_wn(sd, "latent_conv.3", p["latent_conv_1"])
    for i in range(3):
        _put_wn(sd, f"encoder_blocks.{i}.conv", p[f"enc_{i}"]["conv"])
        _put_wn(sd, f"decoder_blocks.{i}.conv_trans", p[f"dec_{i}"]["conv_trans"], transposed=True)
        for blk, key in ((f"encoder_blocks.{i}", f"enc_{i}"), (f"decoder_blocks.{i}", f"dec_{i}")):
            for j in range(3):
                node = p[key][f"residual_{j}"]
                _put_wn(sd, f"{blk}.residuals.{j}.dilated_conv", node["dilated_conv"])
                _put_wn(sd, f"{blk}.residuals.{j}.pointwise_conv", node["pointwise_conv"])
    return {k: torch.tensor(v) for k, v in sd.items()}


def eben_discriminator_params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``DiscriminatorEBENMultiScales`` params (with or without the outer
    ``"params"`` key) -> state dict for
    ``vibravox_tpu_torch.models.eben_discriminator.DiscriminatorEBENMultiScales``.

    The inverse of the JAX package's ``eben_discriminator_params_from_torch``:
    stage 0 of each discriminator is ``Sequential(pad, conv, leaky)`` (conv at
    index 1), the middle stages ``Sequential(conv, leaky)`` (index 0), and the
    certainty conv stands alone."""
    p = params["params"] if "params" in params else params
    sd: Dict[str, np.ndarray] = {}
    for idx, dilation in enumerate((1, 2, 3)):
        node = p[f"pqmf_disc_{dilation}"]
        prefix = f"pqmf_discriminators.{idx}.discriminator"
        _put_wn(sd, f"{prefix}.0.1", node["conv_0"])
        for i in range(1, 7):
            _put_wn(sd, f"{prefix}.{i}.0", node[f"conv_{i}"])
        _put_wn(sd, f"{prefix}.7", node["conv_7"])
    node = p["melgan"]
    _put_wn(sd, "melgan_discriminator.discriminator.0.1", node["conv_0"])
    for i in range(1, 6):
        _put_wn(sd, f"melgan_discriminator.discriminator.{i}.0", node[f"conv_{i}"])
    _put_wn(sd, "melgan_discriminator.discriminator.6", node["conv_6"])
    return {k: torch.tensor(v) for k, v in sd.items()}


def eben_train_state_from_jax(state: Any, m: int = 4, n: int = 32) -> Dict[str, Any]:
    """A JAX ``EBENTrainState`` (leaves as numpy arrays, ``jax.device_get``)
    -> ``{"generator": state dict, "discriminator": state dict, "step": int,
    "atomic_norms_ema": float32 tensor}``, which ``EBENTask.load_state``
    takes.  The optimizer states are not carried over: the port's Adams
    start from zero moments, as a fresh JAX state does."""
    return {
        "generator": eben_generator_params_from_jax(state.gen_params, m=m, n=n),
        "discriminator": eben_discriminator_params_from_jax(state.disc_params),
        "step": int(np.asarray(state.step)),
        "atomic_norms_ema": torch.tensor(np.asarray(state.atomic_norms_ema, dtype=np.float32)),
    }


def wav2vec2_state_dict_from_jax(params: Mapping[str, Any], config) -> Dict[str, torch.Tensor]:
    """Flax ``Wav2Vec2ForCTCModule`` params (with or without the outer
    ``"params"`` key) -> state dict of
    ``vibravox_tpu_torch.models.wav2vec2.Wav2Vec2ForCTC`` of the same
    ``config``; the port's copy of ``wav2vec2_params_to_torch``."""
    p = params["params"] if "params" in params else params
    sd: Dict[str, np.ndarray] = {}

    def put_lin(prefix: str, node: Mapping[str, Any]) -> None:
        sd[f"{prefix}.weight"] = np.asarray(node["kernel"]).T
        sd[f"{prefix}.bias"] = np.asarray(node["bias"])

    def put_ln(prefix: str, node: Mapping[str, Any]) -> None:
        sd[f"{prefix}.weight"] = np.asarray(node["scale"])
        sd[f"{prefix}.bias"] = np.asarray(node["bias"])

    fe = p["feature_encoder"]
    for i in range(len(config.conv_dim)):
        base = f"wav2vec2.feature_extractor.conv_layers.{i}"
        sd[f"{base}.conv.weight"] = np.transpose(np.asarray(fe[f"conv_{i}"]["kernel"]), (2, 1, 0))
        if config.conv_bias:
            sd[f"{base}.conv.bias"] = np.asarray(fe[f"conv_{i}"]["bias"])
        if config.feat_extract_norm == "layer":
            put_ln(f"{base}.layer_norm", fe[f"layer_norm_{i}"])
    if config.feat_extract_norm == "group":
        put_ln("wav2vec2.feature_extractor.conv_layers.0.layer_norm", fe["group_norm"])

    put_ln("wav2vec2.feature_projection.layer_norm", p["feat_proj_layer_norm"])
    put_lin("wav2vec2.feature_projection.projection", p["feat_projection"])
    if "masked_spec_embed" in p:
        sd["wav2vec2.masked_spec_embed"] = np.asarray(p["masked_spec_embed"])

    pce = p["pos_conv_embed"]
    base = "wav2vec2.encoder.pos_conv_embed.conv"
    sd[f"{base}.parametrizations.weight.original0"] = np.asarray(pce["conv_g"]).reshape(1, 1, -1)
    sd[f"{base}.parametrizations.weight.original1"] = np.transpose(np.asarray(pce["conv_v"]), (2, 1, 0))
    sd[f"{base}.bias"] = np.asarray(pce["conv_bias"])
    put_ln("wav2vec2.encoder.layer_norm", p["encoder_layer_norm"])

    for i in range(config.num_hidden_layers):
        b, layer = f"wav2vec2.encoder.layers.{i}", p[f"layer_{i}"]
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            put_lin(f"{b}.attention.{name}", layer[name])
        put_ln(f"{b}.layer_norm", layer["layer_norm"])
        put_lin(f"{b}.feed_forward.intermediate_dense", layer["intermediate_dense"])
        put_lin(f"{b}.feed_forward.output_dense", layer["output_dense"])
        put_ln(f"{b}.final_layer_norm", layer["final_layer_norm"])
    put_lin("lm_head", p["lm_head"])
    return {k: torch.tensor(np.ascontiguousarray(v)) for k, v in sd.items()}
