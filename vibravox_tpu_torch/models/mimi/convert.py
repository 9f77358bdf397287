"""Mimi weights from the JAX package and from HF ``MimiModel`` checkpoints.

* ``mimi_state_dict_from_jax(params, config)``: the JAX ``MimiModule``
  params (numpy leaves, with or without the outer ``"params"``) -> this
  package's state dict.  The port's module names are the JAX package's, so
  the relayout is per leaf: conv ``kernel`` (k, in, out) -> ``weight``
  (out, in, k); a transposed conv's (``up_{i}``, ``upsample``) is
  already the torch layout; dense ``kernel`` (in, out) -> ``weight`` (out,
  in); LayerNorm ``scale`` -> ``weight``; codebooks and layer scales as
  they are.
* ``mimi_state_dict_from_hf(state_dict, config)`` and
  ``mimi_config_from_hf(config_dict)``: the port's copy of
  ``vibravox_tpu/models/mimi/convert.py``, for the published ``kyutai/mimi``
  codec in the HF ``MimiModel`` layout (``transformers``' ``modeling_mimi.py``),
  read as numpy from a local state dict and ``config.json`` (this package
  does not import ``transformers``).  Conv and dense weights are already
  the torch layout; the EMA codebooks (``embed_sum`` / ``cluster_usage``)
  become embeddings, and the RVQ's 1x1 conv projections dense weights.
  ``mimi_state_dict_to_hf`` and ``mimi_config_to_hf`` are their inverses,
  which write the published layout without ``transformers``.

Both refuse a key they do not consume, a key the model lacks, and a shape
the model does not have, so a drifted skeleton cannot load silently.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Mapping, Tuple

import numpy as np
import torch

from vibravox_tpu_torch.models.mimi.mimi import MimiConfig, MimiModule

__all__ = ["mimi_state_dict_from_jax", "mimi_state_dict_from_hf", "mimi_config_from_hf", "mimi_state_dict_to_hf",
           "mimi_config_to_hf"]


def _checked(sd: Dict[str, np.ndarray], config: MimiConfig, source: str) -> Dict[str, torch.Tensor]:
    """``sd`` as tensors, after checking its keys and shapes against the
    model of ``config`` (built on the meta device: no memory)."""
    with torch.device("meta"):
        want = {k: tuple(v.shape) for k, v in MimiModule(config).state_dict().items()}
    leftover, missing = sorted(set(sd) - set(want)), sorted(set(want) - set(sd))
    if leftover or missing:
        raise ValueError(f"{source}: unconsumed keys {leftover[:20]}, missing keys {missing[:20]}")
    bad = {k: (v.shape, want[k]) for k, v in sd.items() if tuple(v.shape) != want[k]}
    if bad:
        raise ValueError(f"{source}: shapes differ from the model's (got, want): {bad}")
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def mimi_state_dict_from_jax(params: Mapping[str, Any], config: MimiConfig) -> Dict[str, torch.Tensor]:
    """JAX ``MimiModule`` params -> state dict for ``MimiModule(config)``."""
    p = params["params"] if "params" in params else params
    sd: Dict[str, np.ndarray] = {}
    for path, leaf in _flatten(p):
        *module, name = path
        value = np.asarray(leaf)
        if name == "kernel":
            name = "weight"
            transposed = module[-1] == "upsample" or module[-1].startswith("up_")
            if value.ndim == 2:
                value = value.T
            elif not transposed:
                value = np.transpose(value, (2, 1, 0))
        elif name == "scale":
            name = "weight"
        sd[".".join((*module, name))] = value
    return _checked(sd, config, "JAX Mimi params")


# --------------------------------------------------------------------------- #
# HF MimiModel
# --------------------------------------------------------------------------- #


def mimi_config_from_hf(cfg: Mapping[str, Any]) -> MimiConfig:
    """An HF Mimi ``config.json`` (a dict) -> ``MimiConfig``.  Refuses what
    the model does not implement (the released checkpoint has none of it):
    grouped-query attention, a head dim other than hidden / heads, a
    LayerNorm eps other than 1e-5, and an RVQ hidden dimension other than
    the codebook's.  Other kernel sizes or residual depths fail the state
    dict's shape and key checks."""
    heads, hidden = cfg["num_attention_heads"], cfg["hidden_size"]
    if cfg.get("num_key_value_heads", heads) != heads:
        raise ValueError("the Mimi transformer is multi-head attention only (no GQA)")
    if (cfg.get("head_dim") or hidden // heads) * heads != hidden:
        raise ValueError("the Mimi transformer needs head_dim * heads == hidden_size")
    if cfg.get("norm_eps", 1e-5) != 1e-5:
        raise ValueError("the Mimi transformer's LayerNorms have eps 1e-5")
    if cfg.get("vector_quantization_hidden_dimension", cfg["codebook_dim"]) != cfg["codebook_dim"]:
        raise ValueError("the RVQ needs vector_quantization_hidden_dimension == codebook_dim")
    return MimiConfig(
        sample_rate=cfg["sampling_rate"], dimension=hidden, n_filters=cfg["num_filters"],
        ratios=tuple(cfg["upsampling_ratios"]), transformer_layers=cfg["num_hidden_layers"],
        transformer_heads=heads, transformer_ff=cfg["intermediate_size"], sliding_window=cfg["sliding_window"],
        rvq_dimension=cfg["codebook_dim"], rvq_n_q=cfg["num_quantizers"], rvq_codebook_size=cfg["codebook_size"],
        downsample=cfg["compress"],
    )


def _hf_pairs(config: MimiConfig) -> List[Tuple[str, str]]:
    """(ours, HF's) for every tensor that maps one to one: the convs, the
    transformers' linears, LayerNorms and layer scales."""
    pairs: List[Tuple[str, str]] = []

    def take(ours: str, theirs: str, bias: bool = True) -> None:
        pairs.append((f"{ours}.weight", f"{theirs}.weight"))
        if bias:
            pairs.append((f"{ours}.bias", f"{theirs}.bias"))

    n = len(config.ratios)
    # MimiEncoder's layers: 0 the stem, then per ratio [residual, ELU,
    # down] at 1 + 3i and 3 + 3i, then ELU and the last conv at 3n + 2;
    # MimiDecoder's: 0 the stem, then per ratio [ELU, up, residual] at
    # 2 + 3i and 3 + 3i, then ELU and the last conv at 3n + 2
    for side in ("encoder", "decoder"):
        take(f"{side}.conv_in", f"{side}.layers.0.conv")
        for i in range(n):
            res = f"{side}.layers.{(1 if side == 'encoder' else 3) + 3 * i}.block"
            take(f"{side}.block_{i}_res_0.conv_0", f"{res}.1.conv")
            take(f"{side}.block_{i}_res_0.conv_1", f"{res}.3.conv")
            if side == "encoder":
                take(f"encoder.down_{i}", f"encoder.layers.{3 + 3 * i}.conv")
            else:
                take(f"decoder.up_{i}", f"decoder.layers.{2 + 3 * i}.conv")
        take(f"{side}.conv_out", f"{side}.layers.{3 * n + 2}.conv")
    for prefix in ("encoder_transformer", "decoder_transformer"):
        for i in range(config.transformer_layers):
            ours, theirs = f"{prefix}.layer_{i}", f"{prefix}.layers.{i}"
            for a, b in (("q_proj", "self_attn.q_proj"), ("k_proj", "self_attn.k_proj"),
                         ("v_proj", "self_attn.v_proj"), ("out_proj", "self_attn.o_proj"),
                         ("linear1", "mlp.fc1"), ("linear2", "mlp.fc2")):
                take(f"{ours}.{a}", f"{theirs}.{b}", bias=False)
            take(f"{ours}.norm1", f"{theirs}.input_layernorm")
            take(f"{ours}.norm2", f"{theirs}.post_attention_layernorm")
            pairs.append((f"{ours}.layer_scale_1", f"{theirs}.self_attn_layer_scale.scale"))
            pairs.append((f"{ours}.layer_scale_2", f"{theirs}.mlp_layer_scale.scale"))
    take("downsample", "downsample.conv", bias=False)
    take("upsample", "upsample.conv", bias=False)
    return pairs


def _hf_quantizers(config: MimiConfig) -> Tuple[Tuple[str, str, int], ...]:
    """(ours, HF's, number of codebooks) for the two RVQs."""
    return (("semantic", "semantic_residual_vector_quantizer", 1),
            ("acoustic", "acoustic_residual_vector_quantizer", config.rvq_n_q - 1))


def mimi_state_dict_from_hf(state_dict: Mapping[str, Any], config: MimiConfig) -> Dict[str, torch.Tensor]:
    """HF ``MimiModel.state_dict()`` (numpy or CPU tensors) -> state dict
    for ``MimiModule(config)``.  A codebook is ``embed_sum`` over
    ``cluster_usage`` clamped to HF's epsilon, 1e-5."""
    hf = {k: np.asarray(v) for k, v in state_dict.items()}
    sd: Dict[str, np.ndarray] = {ours: hf.pop(theirs) for ours, theirs in _hf_pairs(config)}
    for ours, theirs, n_q in _hf_quantizers(config):
        books = []
        for i in range(n_q):
            book = f"quantizer.{theirs}.layers.{i}.codebook"
            hf.pop(f"{book}.initialized", None)
            usage = hf.pop(f"{book}.cluster_usage")
            books.append(hf.pop(f"{book}.embed_sum") / np.maximum(usage, 1e-5)[:, None])
        sd[f"quantizer.{ours}.codebooks"] = np.stack(books)
        for proj in ("input_proj", "output_proj"):
            sd[f"quantizer.{ours}.{proj}.weight"] = hf.pop(f"quantizer.{theirs}.{proj}.weight")[:, :, 0]
    if hf:
        raise ValueError(f"HF Mimi state dict: unconsumed keys {sorted(hf)[:20]}")
    return _checked(sd, config, "HF Mimi state dict")


def mimi_state_dict_to_hf(state_dict: Mapping[str, torch.Tensor], config: MimiConfig) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`mimi_state_dict_from_hf`: a ``MimiModule``
    state dict in HF ``MimiModel``'s keys, on the CPU.  Each codebook is
    written as HF's EMA buffers: ``cluster_usage`` a power of two per code
    (0.5, 1, 2, 4 in turn), ``embed_sum`` the codebook times it, so the
    division ``mimi_state_dict_from_hf`` makes gives the codebook back
    exactly; ``initialized`` is 1."""
    ours = dict(_checked({k: v.detach().cpu().numpy() for k, v in state_dict.items()}, config,
                         "Mimi state dict"))
    hf = {theirs: ours.pop(mine) for mine, theirs in _hf_pairs(config)}
    usage = 2.0 ** (torch.arange(config.rvq_codebook_size) % 4 - 1).float()
    for mine, theirs, n_q in _hf_quantizers(config):
        books = ours.pop(f"quantizer.{mine}.codebooks")
        for i in range(n_q):
            book = f"quantizer.{theirs}.layers.{i}.codebook"
            hf[f"{book}.initialized"] = torch.ones(1)
            hf[f"{book}.cluster_usage"] = usage.clone()
            hf[f"{book}.embed_sum"] = books[i] * usage[:, None]
        for proj in ("input_proj", "output_proj"):
            hf[f"quantizer.{theirs}.{proj}.weight"] = ours.pop(f"quantizer.{mine}.{proj}.weight")[:, :, None]
    if ours:
        raise ValueError(f"Mimi state dict: keys without an HF name {sorted(ours)[:20]}")
    return hf


def mimi_config_to_hf(config: MimiConfig) -> Dict[str, Any]:
    """The HF ``config.json`` (a dict) of ``config``: the inverse of
    :func:`mimi_config_from_hf`, with the fields this model fixes (kernel
    sizes, one residual layer per ratio, causal convs, one semantic
    codebook, a depthwise upsample) written as the model has them."""
    return {
        "model_type": "mimi", "architectures": ["MimiModel"], "sampling_rate": config.sample_rate,
        "audio_channels": 1, "hidden_size": config.dimension, "num_filters": config.n_filters,
        "num_residual_layers": 1, "upsampling_ratios": list(config.ratios), "kernel_size": 7,
        "last_kernel_size": 3, "residual_kernel_size": 3, "dilation_growth_rate": 2, "use_causal_conv": True,
        "compress": config.downsample, "codebook_size": config.rvq_codebook_size,
        "codebook_dim": config.rvq_dimension, "vector_quantization_hidden_dimension": config.rvq_dimension,
        "num_quantizers": config.rvq_n_q, "num_semantic_quantizers": 1, "upsample_groups": config.dimension,
        "num_hidden_layers": config.transformer_layers, "num_attention_heads": config.transformer_heads,
        "num_key_value_heads": config.transformer_heads, "head_dim": config.dimension // config.transformer_heads,
        "intermediate_size": config.transformer_ff, "sliding_window": config.sliding_window, "norm_eps": 1e-5,
    }
