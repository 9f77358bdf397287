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

Speaker embedders (``ecapa2_state_dict_from_jax``,
``ecapa_tdnn_state_dict_from_jax``): the variables ``{"params",
"batch_stats"}``; conv ``kernel`` (kh, kw, in, out) -> ``weight`` (out,
in, kh, kw) and (k, in, out) -> (out, in, k), Dense ``kernel`` (in, out)
-> ``weight`` (out, in), BatchNorm ``scale`` / ``bias`` and the stats
``mean`` / ``var`` -> ``weight`` / ``bias`` / ``running_mean`` /
``running_var`` (``num_batches_tracked`` 0).  Every leaf is consumed, and
one left over raises.

SQUIM (``squim_objective_state_dict_from_jax``,
``squim_subjective_state_dict_from_jax``): torchaudio's key schema, the
inverse of the JAX package's ``squim_*_params_from_torch``.  Each flax
``OptimizedLSTMCell`` direction (per-gate ``i{i,f,g,o}`` input kernels,
``h{i,f,g,o}`` hidden kernels and biases) -> ``weight_ih_l0`` /
``weight_hh_l0`` (gate rows i, f, g, o), its one bias per gate -> ``bias_ih_l0``
and zeros -> ``bias_hh_l0`` (torch adds the two); the 1x1 conv's Dense
kernel (N, d) -> ``weight`` (d, N, 1, 1), PReLU's scalar slope -> (1,).

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
    "melgan_multiscales_params_from_jax",
    "eben_train_state_from_jax",
    "wav2vec2_state_dict_from_jax",
    "ecapa2_state_dict_from_jax",
    "ecapa_tdnn_state_dict_from_jax",
    "squim_objective_state_dict_from_jax",
    "squim_subjective_state_dict_from_jax",
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
    _put_melgan(sd, "melgan_discriminator.discriminator", p["melgan"])
    return {k: torch.tensor(v) for k, v in sd.items()}


def _put_melgan(sd: Dict[str, np.ndarray], prefix: str, node: Mapping[str, Any]) -> None:
    """One flax ``DiscriminatorMelGAN``: conv_0 sits at index 1 of its
    ``Sequential(pad, conv, leaky)``, conv_1 ... conv_5 at index 0, and the
    certainty conv (conv_6) stands alone."""
    _put_wn(sd, f"{prefix}.0.1", node["conv_0"])
    for i in range(1, 6):
        _put_wn(sd, f"{prefix}.{i}.0", node[f"conv_{i}"])
    _put_wn(sd, f"{prefix}.6", node["conv_6"])


def melgan_multiscales_params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``MelganMultiScalesDiscriminator`` params (with or without the
    outer ``"params"`` key): ``disc_{s}.conv_{i}`` -> state dict keys
    ``discriminators.{s}.discriminator.…`` of
    ``vibravox_tpu_torch.models.melgan_discriminator.MelganMultiScalesDiscriminator``."""
    p = params["params"] if "params" in params else params
    sd: Dict[str, np.ndarray] = {}
    scales = sorted(int(k.split("_")[1]) for k in p if k.startswith("disc_"))
    if scales != list(range(len(scales))):
        raise ValueError(f"discriminator scales {scales} are not 0 .. {len(scales) - 1}")
    for s in scales:
        _put_melgan(sd, f"discriminators.{s}.discriminator", p[f"disc_{s}"])
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


class _Leaves:
    """The leaves of a JAX variables tree by path, handed out once each."""

    def __init__(self, variables: Mapping[str, Any]):
        self.leaves: Dict[tuple, np.ndarray] = {}

        def walk(node, path):
            if isinstance(node, Mapping):
                for k, v in node.items():
                    walk(v, path + (k,))
            else:
                self.leaves[path] = np.asarray(node)

        walk(variables, ())
        self.sd: Dict[str, np.ndarray] = {}

    def pop(self, *path: str) -> np.ndarray:
        return self.leaves.pop(path)

    def has(self, *path: str) -> bool:
        return path in self.leaves

    def conv(self, src: tuple, dst: str) -> None:
        """A 1-D or 2-D conv: channels-last kernel -> (out, in, *taps)."""
        kernel = self.pop("params", *src, "kernel")
        self.sd[f"{dst}.weight"] = np.transpose(kernel, (kernel.ndim - 1, kernel.ndim - 2, *range(kernel.ndim - 2)))
        self.sd[f"{dst}.bias"] = self.pop("params", *src, "bias")

    def dense(self, src: tuple, dst: str) -> None:
        self.sd[f"{dst}.weight"] = self.pop("params", *src, "kernel").T
        self.sd[f"{dst}.bias"] = self.pop("params", *src, "bias")

    def batch_norm(self, src: tuple, dst: str) -> None:
        self.sd[f"{dst}.weight"] = self.pop("params", *src, "scale")
        self.sd[f"{dst}.bias"] = self.pop("params", *src, "bias")
        self.sd[f"{dst}.running_mean"] = self.pop("batch_stats", *src, "mean")
        self.sd[f"{dst}.running_var"] = self.pop("batch_stats", *src, "var")
        self.sd[f"{dst}.num_batches_tracked"] = np.zeros((), np.int64)

    def state_dict(self, what: str) -> Dict[str, torch.Tensor]:
        if self.leaves:
            raise ValueError(f"unconsumed JAX {what} leaves: {sorted('/'.join(k) for k in self.leaves)[:30]}")
        return {k: torch.from_numpy(v.copy()) for k, v in self.sd.items()}


def ecapa2_state_dict_from_jax(variables: Mapping[str, Any], config) -> Dict[str, torch.Tensor]:
    """JAX ``ECAPA2`` variables (``{"params", "batch_stats"}``, numpy
    leaves) -> state dict of ``vibravox_tpu_torch.models.ecapa2.ECAPA2`` of
    the same ``config``, in the key layout of the JAX package's
    ``ecapa2_params_from_torchscript``, whose inverse this is."""
    t = _Leaves(variables)
    t.conv(("stem",), "stem")
    t.batch_norm(("stem_bn",), "stem_bn")
    for si, (_, n_blocks, _) in enumerate(config.lfe_stages):
        for bi in range(n_blocks):
            src, dst = f"stage{si}_block{bi}", f"stage{si}.block{bi}"
            for name in ("conv1", "conv2"):
                t.conv((src, name), f"{dst}.{name}")
            for name in ("bn1", "bn2"):
                t.batch_norm((src, name), f"{dst}.{name}")
            t.dense((src, "fwse", "fc1"), f"{dst}.fwse.fc1")
            t.dense((src, "fwse", "fc2"), f"{dst}.fwse.fc2")
            if t.has("params", src, "shortcut", "kernel"):
                t.conv((src, "shortcut"), f"{dst}.shortcut")
    t.conv(("gfe_proj",), "gfe_proj")
    t.batch_norm(("gfe_bn",), "gfe_bn")
    for name in ("conv_in", "conv_out"):
        t.conv(("gfe_block", name), f"gfe_block.{name}")
    for name in ("bn_in", "bn_out"):
        t.batch_norm(("gfe_block", name), f"gfe_block.{name}")
    for name in ("se_fc1", "se_fc2"):
        t.dense(("gfe_block", name), f"gfe_block.{name}")
    for i in range(1, config.res2_scale):
        t.conv(("gfe_block", f"res2_conv_{i}"), f"gfe_block.res2_convs.{i}")
    t.conv(("pooling", "att_conv1"), "pooling.att_conv1")
    t.conv(("pooling", "att_conv2"), "pooling.att_conv2")
    t.batch_norm(("pool_bn",), "pool_bn")
    t.dense(("embedding",), "embedding")
    return t.state_dict("ECAPA2")


def ecapa_tdnn_state_dict_from_jax(variables: Mapping[str, Any], scale: int = 8) -> Dict[str, torch.Tensor]:
    """JAX ``ECAPATDNN`` variables -> state dict of
    ``vibravox_tpu_torch.models.ecapa_tdnn.ECAPATDNN`` with the same
    ``scale``; the module names are the flax names."""
    t = _Leaves(variables)
    t.conv(("conv_stem",), "conv_stem")
    t.batch_norm(("bn_stem",), "bn_stem")
    for block in ("block_1", "block_2", "block_3"):
        convs = ["conv_in", "conv_out"] + [f"conv_{i}" for i in range(1, scale)]
        for name in convs:
            t.conv((block, name), f"{block}.{name}")
            t.batch_norm((block, name.replace("conv", "bn")), f"{block}.{name.replace('conv', 'bn')}")
        t.dense((block, "se", "fc1"), f"{block}.se.fc1")
        t.dense((block, "se", "fc2"), f"{block}.se.fc2")
    t.conv(("mfa_conv",), "mfa_conv")
    t.conv(("pooling", "attn_1"), "pooling.attn_1")
    t.conv(("pooling", "attn_2"), "pooling.attn_2")
    t.batch_norm(("bn_pool",), "bn_pool")
    t.dense(("embedding",), "embedding")
    return t.state_dict("ECAPA-TDNN")


def _squim_lstm(t: _Leaves, src: tuple, dst: str) -> None:
    """A ``SingleRNN``: both flax LSTM directions, then the projection."""
    for cell, suffix in (("cell_fwd", ""), ("cell_bwd", "_reverse")):
        gates = "ifgo"
        w_ih = [t.pop("params", *src, cell, f"i{g}", "kernel").T for g in gates]
        w_hh = [t.pop("params", *src, cell, f"h{g}", "kernel").T for g in gates]
        bias = [t.pop("params", *src, cell, f"h{g}", "bias") for g in gates]
        t.sd[f"{dst}.rnn.weight_ih_l0{suffix}"] = np.concatenate(w_ih)
        t.sd[f"{dst}.rnn.weight_hh_l0{suffix}"] = np.concatenate(w_hh)
        t.sd[f"{dst}.rnn.bias_ih_l0{suffix}"] = np.concatenate(bias)
        t.sd[f"{dst}.rnn.bias_hh_l0{suffix}"] = np.zeros_like(t.sd[f"{dst}.rnn.bias_ih_l0{suffix}"])
    t.dense((*src, "proj"), f"{dst}.proj")


def _norm(t: _Leaves, src: tuple, dst: str) -> None:
    t.sd[f"{dst}.weight"] = t.pop("params", *src, "scale")
    t.sd[f"{dst}.bias"] = t.pop("params", *src, "bias")


def squim_objective_state_dict_from_jax(params: Mapping[str, Any], config) -> Dict[str, torch.Tensor]:
    """Flax ``SquimObjective`` params (with or without the outer ``"params"``
    key) -> state dict of ``vibravox_tpu_torch.models.squim.SquimObjective``
    of the same ``config``, in torchaudio's keys."""
    t = _Leaves({"params": params["params"] if "params" in params else params})
    t.sd["encoder.conv1d.weight"] = np.transpose(t.pop("params", "encoder", "kernel"), (2, 1, 0))
    for i in range(config.num_blocks):
        for kind in ("row", "col"):
            _squim_lstm(t, ("dprnn", f"{kind}_rnn_{i}"), f"dprnn.{kind}_rnn.{i}")
            _norm(t, ("dprnn", f"{kind}_norm_{i}"), f"dprnn.{kind}_norm.{i}")
    t.sd["dprnn.conv.0.weight"] = t.pop("params", "dprnn", "conv", "kernel").T[:, :, None, None]
    t.sd["dprnn.conv.0.bias"] = t.pop("params", "dprnn", "conv", "bias")
    t.sd["dprnn.conv.1.weight"] = t.pop("params", "dprnn", "prelu", "negative_slope").reshape(1)
    for bi, (name, _) in enumerate(config.branches):
        src, dst = f"branch_{name}", f"branches.{bi}"
        t.sd[f"{dst}.0.self_attn.in_proj_weight"] = t.pop("params", src, "transformer", "in_proj", "kernel").T
        t.sd[f"{dst}.0.self_attn.in_proj_bias"] = t.pop("params", src, "transformer", "in_proj", "bias")
        t.dense((src, "transformer", "out_proj"), f"{dst}.0.self_attn.out_proj")
        for layer in ("linear1", "linear2"):
            t.dense((src, "transformer", layer), f"{dst}.0.{layer}")
        for layer in ("norm1", "norm2"):
            _norm(t, (src, "transformer", layer), f"{dst}.0.{layer}")
        t.sd[f"{dst}.1.alpha"] = t.pop("params", src, "pool", "alpha")
        t.dense((src, "linear1"), f"{dst}.2.0")
        t.sd[f"{dst}.2.1.weight"] = t.pop("params", src, "prelu", "negative_slope").reshape(1)
        t.dense((src, "linear2"), f"{dst}.2.2")
    return t.state_dict("SquimObjective")


def squim_subjective_state_dict_from_jax(params: Mapping[str, Any], config) -> Dict[str, torch.Tensor]:
    """Flax ``SquimSubjective`` params -> state dict of
    ``vibravox_tpu_torch.models.squim.SquimSubjective`` of the same
    ``config`` (the port's own keys: HF names under ``ssl_model.``).  The
    backbone goes through ``wav2vec2_state_dict_from_jax``; its CTC head,
    which JAX's features path never creates, is zeros, and an unused
    ``masked_spec_embed`` is dropped."""
    p = params["params"] if "params" in params else params
    ssl = {k: v for k, v in p["ssl"].items() if k != "masked_spec_embed"}
    hidden, vocab = config.ssl.hidden_size, config.ssl.vocab_size
    ssl.setdefault("lm_head", {"kernel": np.zeros((hidden, vocab), np.float32), "bias": np.zeros((vocab,), np.float32)})
    sd = {f"ssl_model.{k}": v for k, v in wav2vec2_state_dict_from_jax(ssl, config.ssl).items()}
    t = _Leaves({"params": {k: v for k, v in p.items() if k != "ssl"}})
    t.dense(("projector",), "projector")
    t.dense(("att_pool", "linear1"), "predictor.att_pool_layer.linear1")
    t.dense(("att_pool", "linear2"), "predictor.att_pool_layer.linear2")
    t.dense(("mos_head",), "predictor.mos_layer")
    sd.update(t.state_dict("SquimSubjective head"))
    return sd
