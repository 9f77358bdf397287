"""wav2vec2-CTC for speech-to-phoneme (PyTorch).

Counterpart of ``vibravox_tpu/models/wav2vec2.py``, the reference's
``Wav2Vec2ForCTC`` (post-norm "base" variant, as
``facebook/wav2vec2-base-fr-voxpopuli-v2``):

* conv feature encoder: seven NCW ``conv1d``s (512 channels, ~320x
  downsampling), ``GroupNorm(512, 512)`` after conv 0
  (``feat_extract_norm="group"``) or a LayerNorm per conv (``"layer"``),
  exact GELU;
* feature projection: LayerNorm -> Linear -> dropout;
* SpecAugment time and feature masks in training;
* positional embedding: a grouped conv (k = 128, 16 groups, padding k // 2,
  the last frame dropped for an even k) with ``weight_norm(dim=2)``, GELU;
* post-norm transformer layers with ``F.scaled_dot_product_attention`` (no
  mask, and no attention dropout: the JAX model applies none), hidden and
  activation dropout, one layerdrop gate per layer per step, shared over
  the batch;
* the CTC head, float32 logits.

Under tensor parallelism (``parallel/tp.py``) an attention block holds
``num_heads / M`` heads and a feed-forward block ``intermediate_size / M``
units, with Megatron's two all-reduces a block; the random draws are made
over the global batch and the full widths, each rank keeping its part, so
the W-rank step draws what the one-rank step draws.

Module and parameter names are HF's ``Wav2Vec2ForCTC`` state-dict names,
so a real checkpoint loads with ``strict=True``.  Every random draw of a
train forward (dropout masks, span starts, layerdrop gates) comes from the
``generator`` it is given, in a fixed order.  ``compute_dtype="bfloat16"``
casts where the JAX model does: the inputs and weights of every Linear and
conv are bf16, LayerNorm and GroupNorm give float32, so the residual stream
is float32.

The front end (``encode_features``), the blocks and the checkpoint loader
(``ctc_from_pretrained``) are shared with the port's WavLM
(``models/wavlm.py``).

``wav2vec2_for_ctc_from_config`` makes a model with random weights, drawn
from the distributions of the JAX initialisers; ``wav2vec2_for_ctc_from_pretrained``
reads a local HF-layout directory (``config.json``, ``pytorch_model.bin``)
without ``transformers`` and never downloads.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils.parametrizations import weight_norm

from vibravox_tpu_torch.device import DeviceLike, resolve_device
from vibravox_tpu_torch.models import safetensors_io
from vibravox_tpu_torch.models.layers import variance_scaling_
from vibravox_tpu_torch.parallel.mesh import global_rand, global_rows
from vibravox_tpu_torch.parallel.tp import ModelShard

__all__ = [
    "Wav2Vec2Config",
    "Wav2Vec2ForCTC",
    "TINY_W2V2_CONFIG",
    "span_starts",
    "span_mask",
    "encode_features",
    "FeatureEncoder",
    "FeatureProjection",
    "PositionalConvEmbedding",
    "Attention",
    "FeedForward",
    "ctc_from_pretrained",
    "wav2vec2_for_ctc_from_config",
    "wav2vec2_for_ctc_from_pretrained",
]


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    vocab_size: int = 38
    pad_token_id: int = 35
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    feat_extract_norm: str = "group"  # "group" (base) | "layer"
    do_stable_layer_norm: bool = False
    layer_norm_eps: float = 1e-5
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1  # carried, not applied (nor in the JAX model)
    activation_dropout: float = 0.1
    feat_proj_dropout: float = 0.1
    final_dropout: float = 0.0
    layerdrop: float = 0.0
    apply_spec_augment: bool = True
    mask_time_prob: float = 0.05
    mask_time_length: int = 10
    mask_time_min_masks: int = 2
    mask_feature_prob: float = 0.0
    mask_feature_length: int = 10
    mask_feature_min_masks: int = 0
    # "bfloat16" casts the Linear and conv inputs and weights; the
    # parameters stay float32
    compute_dtype: Optional[str] = None

    def __post_init__(self):
        if self.feat_extract_norm not in ("group", "layer"):
            raise ValueError(f"feat_extract_norm must be 'group' or 'layer', got {self.feat_extract_norm!r}")
        if self.do_stable_layer_norm:
            raise NotImplementedError("the pre-norm (stable layer norm) variant is not ported: "
                                      "the JAX model implements the post-norm base variant only")
        for name in ("conv_dim", "conv_kernel", "conv_stride"):
            object.__setattr__(self, name, tuple(getattr(self, name)))

    def feat_extract_output_length(self, input_length: int) -> int:
        for k, s in zip(self.conv_kernel, self.conv_stride):
            input_length = (input_length - k) // s + 1
        return input_length


TINY_W2V2_CONFIG: Dict[str, Any] = dict(
    hidden_size=32,
    num_hidden_layers=2,
    num_attention_heads=2,
    intermediate_size=64,
    # the base model's full 320x downsampling stack, narrow channels
    conv_dim=(32, 32, 32, 32, 32, 32, 32),
    conv_kernel=(10, 3, 3, 3, 3, 2, 2),
    conv_stride=(5, 2, 2, 2, 2, 2, 2),
    num_conv_pos_embeddings=16,
    num_conv_pos_embedding_groups=2,
)


# --------------------------------------------------------------------------- #
# Random draws and casts
# --------------------------------------------------------------------------- #


def _dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator],
             split: Optional[ModelShard] = None) -> torch.Tensor:
    """flax ``Dropout``: keep with probability 1 - p, scale by 1 / (1 - p);
    nothing without a generator (eval).  The mask is drawn over the global
    batch (``parallel.mesh.global_rand``) and, for a last dimension TP
    split (``split``), over its full width."""
    if generator is None or p <= 0:
        return x
    keep = global_rand(x.shape, generator, x.device, split) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


def span_starts(generator: torch.Generator, batch: int, length: int, prob: float, span: int,
                min_masks: int, device) -> Optional[torch.Tensor]:
    """SpecAugment's span starts, (batch, num_spans) in [0, length - span):
    ``max(min_masks, int(prob * length / span))`` spans a row, as the JAX
    ``_compute_span_mask`` draws them; None when no span fits.  Drawn over
    the global batch, this rank's rows kept (``parallel.mesh.global_rows``)."""
    num_spans = max(min_masks, int(prob * length / span))
    if num_spans == 0 or span >= length:
        return None
    rows, start = global_rows(batch)
    starts = torch.randint(0, length - span, (rows, num_spans), generator=generator, device=device)
    return starts[start:start + batch]


def span_mask(starts: torch.Tensor, length: int, span: int) -> torch.Tensor:
    """(batch, length) bool: the union of the spans [start, start + span)."""
    pos = torch.arange(length, device=starts.device)
    hit = (pos >= starts[..., None]) & (pos < starts[..., None] + span)
    return hit.any(dim=1)


def _linear(x: torch.Tensor, layer: nn.Linear, dtype: Optional[torch.dtype],
            tp: Optional[ModelShard] = None) -> torch.Tensor:
    """``layer(x)`` with inputs and weights in ``dtype``; with ``tp``, a
    row-parallel product: the partial sums all-reduced over ``model``,
    then the bias."""
    if tp is None:
        if dtype is None:
            return layer(x)
        return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))
    w = layer.weight if dtype is None else layer.weight.to(dtype)
    out = tp.exit(F.linear(x if dtype is None else x.to(dtype), w))
    return out + (layer.bias if dtype is None else layer.bias.to(dtype))


def _layer_norm(x: torch.Tensor, layer: nn.LayerNorm) -> torch.Tensor:
    """float32 out, statistics in float32 whatever the input's type."""
    return F.layer_norm(x.float(), layer.normalized_shape, layer.weight, layer.bias, layer.eps)


# --------------------------------------------------------------------------- #
# Modules (HF names)
# --------------------------------------------------------------------------- #


class _ConvLayer(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int, stride: int, bias: bool, norm: Optional[str],
                 eps: float):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, kernel, stride=stride, bias=bias)
        if norm == "group":
            self.layer_norm = nn.GroupNorm(cout, cout, eps=eps)
        elif norm == "layer":
            self.layer_norm = nn.LayerNorm(cout, eps=eps)
        self.norm = norm

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
        w, b = self.conv.weight, self.conv.bias
        if dtype is not None:
            x, w = x.to(dtype), w.to(dtype)
            b = b.to(dtype) if b is not None else None
        h = F.conv1d(x, w, b, stride=self.conv.stride)
        if self.norm == "group":
            gn = self.layer_norm
            h = F.group_norm(h.float(), gn.num_groups, gn.weight, gn.bias, gn.eps)
        elif self.norm == "layer":
            h = _layer_norm(h.transpose(1, 2), self.layer_norm).transpose(1, 2)
        return F.gelu(h)


class FeatureEncoder(nn.Module):
    """Waveform (B, 1, T) -> (B, conv_dim[-1], T') features."""

    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        layers = []
        cin = 1
        for i, (dim, k, s) in enumerate(zip(config.conv_dim, config.conv_kernel, config.conv_stride)):
            norm = "layer" if config.feat_extract_norm == "layer" else ("group" if i == 0 else None)
            layers.append(_ConvLayer(cin, dim, k, s, config.conv_bias, norm, config.layer_norm_eps))
            cin = dim
        self.conv_layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
        for layer in self.conv_layers:
            x = layer(x, dtype)
        return x


class FeatureProjection(nn.Module):
    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        self.layer_norm = nn.LayerNorm(config.conv_dim[-1], eps=config.layer_norm_eps)
        self.projection = nn.Linear(config.conv_dim[-1], config.hidden_size)


class PositionalConvEmbedding(nn.Module):
    """Grouped conv, padding k // 2 on both sides, weight-normed over
    (out, in / groups) per tap (``dim=2``: g has shape (1, 1, k))."""

    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        k = config.num_conv_pos_embeddings
        self.conv = nn.Conv1d(config.hidden_size, config.hidden_size, k, padding=k // 2,
                              groups=config.num_conv_pos_embedding_groups)
        weight_norm(self.conv, name="weight", dim=2)
        self.drop_last = k % 2 == 0

    def forward(self, h: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
        """(B, T, H) -> (B, T, H) float32 (its bias is added in float32)."""
        conv = self.conv
        x, w = h.transpose(1, 2), conv.weight
        if dtype is not None:
            x, w = x.to(dtype), w.to(dtype)
        out = F.conv1d(x, w, None, padding=conv.padding, groups=conv.groups).float()
        out = out + conv.bias[:, None]
        if self.drop_last:
            out = out[:, :, :-1]
        return F.gelu(out).transpose(1, 2)


class Attention(nn.Module):
    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        h = config.hidden_size
        self.num_heads, self.head_dim = config.num_attention_heads, h // config.num_attention_heads
        self.q_proj, self.k_proj = nn.Linear(h, h), nn.Linear(h, h)
        self.v_proj, self.out_proj = nn.Linear(h, h), nn.Linear(h, h)
        self.tp_attention: Optional[ModelShard] = None  # set by parallel.tp.shard_transformer_

    def forward(self, h: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
        """Under TP the projections hold this rank's ``num_heads / M`` heads."""
        b, t, _ = h.shape
        tp = self.tp_attention
        if tp is not None:
            h = tp.enter(h)

        def heads(x):
            return x.view(b, t, -1, self.head_dim).transpose(1, 2)

        q, k, v = (heads(_linear(h, p, dtype)) for p in (self.q_proj, self.k_proj, self.v_proj))
        attn = F.scaled_dot_product_attention(q, k, v)
        return _linear(attn.transpose(1, 2).reshape(b, t, -1), self.out_proj, dtype, tp)


class FeedForward(nn.Module):
    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        self.intermediate_dense = nn.Linear(config.hidden_size, config.intermediate_size)
        self.output_dense = nn.Linear(config.intermediate_size, config.hidden_size)
        self.tp_ffn: Optional[ModelShard] = None  # set by parallel.tp.shard_transformer_


class EncoderLayer(nn.Module):
    """Post-norm: LN(h + drop(attn(h))), then LN(h + drop(ff(h)))."""

    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        self.attention = Attention(config)
        self.layer_norm = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps)
        self.feed_forward = FeedForward(config)
        self.final_layer_norm = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps)

    def forward(self, h: torch.Tensor, cfg: Wav2Vec2Config, dtype: Optional[torch.dtype],
                generator: Optional[torch.Generator]) -> torch.Tensor:
        """``cfg``: the model's config, for the dropout rates."""
        attn = _dropout(self.attention(h, dtype), cfg.hidden_dropout, generator)
        h = _layer_norm(h + attn, self.layer_norm)
        ffn = self.feed_forward
        tp = ffn.tp_ffn
        ff = F.gelu(_linear(tp.enter(h) if tp is not None else h, ffn.intermediate_dense, dtype))
        ff = _dropout(ff, cfg.activation_dropout, generator, tp)
        ff = _dropout(_linear(ff, ffn.output_dense, dtype, tp), cfg.hidden_dropout, generator)
        return _layer_norm(h + ff, self.final_layer_norm)


class Encoder(nn.Module):
    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        self.pos_conv_embed = PositionalConvEmbedding(config)
        self.layer_norm = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps)
        self.layers = nn.ModuleList(EncoderLayer(config) for _ in range(config.num_hidden_layers))


class Wav2Vec2Model(nn.Module):
    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        self.feature_extractor = FeatureEncoder(config)
        self.feature_projection = FeatureProjection(config)
        if config.apply_spec_augment:
            self.masked_spec_embed = nn.Parameter(torch.empty(config.hidden_size))
        self.encoder = Encoder(config)


def encode_features(model: nn.Module, cfg, input_values: torch.Tensor, dtype: Optional[torch.dtype],
                    gen: Optional[torch.Generator], freeze_feature_encoder: bool) -> torch.Tensor:
    """The front end that wav2vec2 and WavLM share: waveform (B, T) ->
    (B, T', hidden), through ``model``'s conv feature encoder (without
    gradients when frozen), its feature projection and dropout, and with a
    ``gen`` (training) SpecAugment's time spans (``masked_spec_embed``)
    and feature spans, drawn in that order."""
    x = input_values[:, None, :]
    with torch.set_grad_enabled(torch.is_grad_enabled() and not freeze_feature_encoder):
        feats = model.feature_extractor(x, dtype)
    feats = feats.transpose(1, 2)  # (B, T', C)

    proj = model.feature_projection
    h = _linear(_layer_norm(feats, proj.layer_norm), proj.projection, dtype)
    h = _dropout(h, cfg.feat_proj_dropout, gen)

    if gen is not None and cfg.apply_spec_augment:
        b, t, d = h.shape
        if cfg.mask_time_prob > 0:
            starts = span_starts(gen, b, t, cfg.mask_time_prob, cfg.mask_time_length,
                                 cfg.mask_time_min_masks, h.device)
            if starts is not None:
                mask = span_mask(starts, t, cfg.mask_time_length)
                h = torch.where(mask[:, :, None], model.masked_spec_embed, h)
        if cfg.mask_feature_prob > 0:
            starts = span_starts(gen, b, d, cfg.mask_feature_prob, cfg.mask_feature_length,
                                 cfg.mask_feature_min_masks, h.device)
            if starts is not None:
                mask = span_mask(starts, d, cfg.mask_feature_length)
                h = torch.where(mask[:, None, :], 0.0, h)
    return h


class Wav2Vec2ForCTC(nn.Module):
    """Waveform (B, T) -> float32 logits (B, T', vocab_size)."""

    base_model_prefix = "wav2vec2"  # HF's: the encoder's attribute and state-dict prefix

    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        self.config = config
        self.wav2vec2 = Wav2Vec2Model(config)
        self.lm_head = nn.Linear(config.hidden_size, config.vocab_size)

    def forward(self, input_values: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None, freeze_feature_encoder: bool = False,
                return_features: bool = False) -> torch.Tensor:
        """``train``: dropout, SpecAugment and layerdrop, drawn from
        ``generator`` (a fresh one seeded 0 on the input's device if None);
        ``freeze_feature_encoder``: the conv stack runs without gradients;
        ``return_features``: the last layer's hidden states (B, T', hidden)
        instead of the logits."""
        cfg, model = self.config, self.wav2vec2
        dtype = getattr(torch, cfg.compute_dtype) if cfg.compute_dtype else None
        gen = None
        if train:
            gen = generator if generator is not None else torch.Generator(input_values.device).manual_seed(0)
        h = encode_features(model, cfg, input_values, dtype, gen, freeze_feature_encoder)

        enc = model.encoder
        h = h + enc.pos_conv_embed(h, dtype)
        h = _dropout(_layer_norm(h, enc.layer_norm), cfg.hidden_dropout, gen)
        keep = None
        if train and cfg.layerdrop > 0:
            keep = torch.rand(len(enc.layers), generator=gen, device=h.device) >= cfg.layerdrop
        for i, layer in enumerate(enc.layers):
            out = layer(h, cfg, dtype, gen)
            h = torch.where(keep[i], out, h) if keep is not None else out

        if return_features:
            return h
        h = _dropout(h, cfg.final_dropout, gen)
        return _linear(h, self.lm_head, dtype).float()


# --------------------------------------------------------------------------- #
# Initialisation and factories
# --------------------------------------------------------------------------- #


@torch.no_grad()
def _init_jax_like(model: nn.Module, seed: int) -> torch.Generator:
    """The JAX initialisers' distributions: Linear and conv weights
    lecun_normal over their fan-in, biases 0; norms 1 and 0; the positional
    conv's direction he_normal over k * hidden / groups and its gain the
    direction's norm per tap; ``masked_spec_embed`` uniform in [0, 1).
    ``model``: a CTC model whose encoder is its ``base_model_prefix``
    attribute.  Returns the generator, for a caller's further draws."""
    gen = torch.Generator().manual_seed(int(seed))
    base = getattr(model, model.base_model_prefix)
    for module in model.modules():
        if isinstance(module, nn.Linear):
            variance_scaling_(module.weight, 1.0, module.in_features, gen)
            nn.init.zeros_(module.bias)
        elif isinstance(module, (nn.LayerNorm, nn.GroupNorm)):
            nn.init.ones_(module.weight)
            nn.init.zeros_(module.bias)
    for layer in base.feature_extractor.conv_layers:
        conv = layer.conv
        variance_scaling_(conv.weight, 1.0, conv.in_channels * conv.kernel_size[0], gen)
        if conv.bias is not None:
            nn.init.zeros_(conv.bias)
    pos = base.encoder.pos_conv_embed.conv
    v = pos.parametrizations.weight.original1
    variance_scaling_(v, 2.0, v.shape[1] * v.shape[2], gen)
    pos.parametrizations.weight.original0.copy_(torch.linalg.vector_norm(v, dim=(0, 1), keepdim=True))
    nn.init.zeros_(pos.bias)
    if model.config.apply_spec_augment:
        nn.init.uniform_(base.masked_spec_embed, 0.0, 1.0, generator=gen)
    return gen


def wav2vec2_for_ctc_from_config(
    pad_token_id: int = 35,
    vocab_size: int = 38,
    preset: Optional[str] = None,
    seed: int = 0,
    device: DeviceLike = None,
    **config_overrides,
) -> Wav2Vec2ForCTC:
    """A model with random weights (``preset="tiny"``: ``TINY_W2V2_CONFIG``),
    drawn on the CPU from ``seed`` and moved to ``device`` (``None`` for the
    GPU, which raises without one, or ``"cpu"``)."""
    dev = resolve_device(device)
    kwargs: Dict[str, Any] = dict(TINY_W2V2_CONFIG) if preset == "tiny" else {}
    if preset not in (None, "tiny"):
        raise ValueError(f"unknown preset {preset!r}")
    kwargs.update(config_overrides)
    model = Wav2Vec2ForCTC(Wav2Vec2Config(pad_token_id=pad_token_id, vocab_size=vocab_size, **kwargs))
    _init_jax_like(model, seed)
    return model.to(dev)


_PRETRAINING_PREFIXES = ("quantizer.", "project_q.", "project_hid.")
_WEIGHT_FILES = ("pytorch_model.bin", "model.safetensors")


def _checkpoint_state_dict(sd: Dict[str, torch.Tensor]) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """A checkpoint's keys in this model's names, and the pretraining keys
    dropped; the old weight-norm names ``weight_g`` / ``weight_v`` become
    the parametrization's ``original0`` / ``original1``."""
    out, dropped = {}, []
    for k, v in sd.items():
        if k.startswith(_PRETRAINING_PREFIXES):
            dropped.append(k)
            continue
        k = k.replace("pos_conv_embed.conv.weight_g", "pos_conv_embed.conv.parametrizations.weight.original0")
        k = k.replace("pos_conv_embed.conv.weight_v", "pos_conv_embed.conv.parametrizations.weight.original1")
        out[k] = v
    return out, sorted(dropped)


def wav2vec2_for_ctc_from_pretrained(
    pretrained_model_name_or_path: str,
    pad_token_id: int = 35,
    vocab_size: int = 38,
    seed: int = 0,
    device: DeviceLike = None,
    **config_overrides,
) -> Wav2Vec2ForCTC:
    """A local directory in HF's layout: ``config.json`` (the fields of
    ``Wav2Vec2Config`` that it has; ``pad_token_id``, ``vocab_size`` and
    ``config_overrides`` apply over it) and ``pytorch_model.bin`` or, when
    there is none, ``model.safetensors``.  The
    weights load with ``strict=True`` (a missing or unexpected key raises);
    a pretraining checkpoint's ``quantizer.*``, ``project_q.*`` and
    ``project_hid.*`` are dropped and listed in ``model.load_report``; ``lm_head`` is made fresh when absent
    (normal, std 0.02, bias 0, from ``seed``), as HF does, and so is
    ``masked_spec_embed`` (uniform).  A name that is not a local directory
    raises: the port never downloads."""
    return ctc_from_pretrained(Wav2Vec2ForCTC, Wav2Vec2Config, pretrained_model_name_or_path, pad_token_id,
                               vocab_size, seed, device, config_overrides)


def ctc_from_pretrained(model_cls, config_cls, pretrained_model_name_or_path: str, pad_token_id: int,
                        vocab_size: int, seed: int, device: DeviceLike, config_overrides: Dict[str, Any]):
    """``wav2vec2_for_ctc_from_pretrained`` for any CTC model of HF's layout
    whose encoder is its ``base_model_prefix`` attribute (``wav2vec2``,
    ``wavlm``).  A base model's checkpoint, saved without that prefix (HF's
    ``WavLMModel``), has it put in front of each key."""
    prefix = model_cls.base_model_prefix
    directory = Path(pretrained_model_name_or_path)
    if not directory.is_dir():
        raise FileNotFoundError(
            f"{pretrained_model_name_or_path!r} is not a local directory: the port loads a pretrained "
            f"{prefix} from a directory holding config.json and pytorch_model.bin and never downloads")
    weights = next((directory / n for n in _WEIGHT_FILES if (directory / n).is_file()), None)
    if not (directory / "config.json").is_file() or weights is None:
        raise FileNotFoundError(f"{directory} lacks config.json or a weight file ({', '.join(_WEIGHT_FILES)})")
    dev = resolve_device(device)
    hf = json.loads((directory / "config.json").read_text())
    fields = {f.name for f in dataclasses.fields(config_cls)}
    unknown = sorted(set(config_overrides) - fields)
    if unknown:
        raise TypeError(f"unknown {prefix} config overrides {unknown}")
    kwargs = {k: v for k, v in hf.items() if k in fields and k != "compute_dtype"}
    kwargs.update(pad_token_id=pad_token_id, vocab_size=vocab_size, **config_overrides)
    model = model_cls(config_cls(**kwargs))

    raw = (safetensors_io.load_file(weights) if weights.suffix == ".safetensors"
           else torch.load(weights, map_location="cpu", weights_only=True))
    sd, dropped = _checkpoint_state_dict(raw)
    sd = {k if k.startswith((f"{prefix}.", "lm_head.")) else f"{prefix}.{k}": v for k, v in sd.items()}
    own = model.state_dict()
    gen = torch.Generator().manual_seed(int(seed))
    initialised = []
    embed = f"{prefix}.masked_spec_embed"
    with torch.no_grad():
        if "lm_head.weight" not in sd:
            sd["lm_head.weight"] = torch.empty_like(own["lm_head.weight"]).normal_(0.0, 0.02, generator=gen)
            sd["lm_head.bias"] = torch.zeros_like(own["lm_head.bias"])
            initialised += ["lm_head.weight", "lm_head.bias"]
        if embed not in own:  # spec augment off: the embedding is not used
            sd.pop(embed, None)
        elif embed not in sd:
            sd[embed] = torch.empty_like(own[embed]).uniform_(generator=gen)
            initialised.append(embed)
    model.load_state_dict(sd, strict=True)
    model.load_report = {"dropped": dropped, "initialised": initialised}
    if dropped or initialised:
        print(f"[{prefix}] {directory}: dropped {len(dropped)} pretraining keys, initialised {initialised}",
              flush=True)
    return model.to(dev)


def save_pretrained(model: Wav2Vec2ForCTC, directory: str, with_lm_head: bool = True,
                    safetensors: bool = False) -> None:
    """Writes ``config.json`` (HF's field names) and ``pytorch_model.bin``
    (``model.safetensors`` with ``safetensors``), the layout
    ``wav2vec2_for_ctc_from_pretrained`` reads."""
    path = Path(directory)
    path.mkdir(parents=True, exist_ok=True)
    cfg = {k: (list(v) if isinstance(v, tuple) else v) for k, v in dataclasses.asdict(model.config).items()
           if k != "compute_dtype"}
    cfg["architectures"] = ["Wav2Vec2ForCTC" if with_lm_head else "Wav2Vec2ForPreTraining"]
    (path / "config.json").write_text(json.dumps(cfg, indent=1))
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()
          if with_lm_head or not k.startswith("lm_head.")}
    name = "model.safetensors" if safetensors else "pytorch_model.bin"
    tmp = path / f".{name}.tmp"
    if safetensors:
        safetensors_io.save_file(sd, tmp)
    else:
        torch.save(sd, tmp)
    os.replace(tmp, path / name)
