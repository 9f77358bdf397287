"""WavLM-CTC for speech-to-phoneme (PyTorch).

WavLM (Chen et al., "WavLM: Large-Scale Self-Supervised Pre-Training for
Full Stack Speech Processing", IEEE JSTSP 2022), the pre-norm ("stable
layer norm") variant that ``microsoft/wavlm-large`` publishes, with HF's
``WavLMForCTC`` state-dict names, so a real checkpoint loads with
``strict=True``.  The JAX package has no counterpart; the plain reference
is ``portbench/reference/wavlm.py``.

* The front end is wav2vec2's (``models/wav2vec2.py``: the conv feature
  encoder with a LayerNorm per conv, ``feat_extract_norm="layer"``; the
  feature projection; SpecAugment; the grouped positional conv), then
  h = drop(h + posconv(h)), with no LayerNorm before the layers.
* Each of the pre-norm layers: x = LN(h); h = h + drop(attn(x)); h = h +
  drop(W2 drop(gelu(W1 LN_f(h)))).  After the layers the encoder's
  LayerNorm, then the CTC head (float32 logits).
* The attention adds a gated relative-position bias to its scores:
  softmax(q k^T / sqrt(d) + gate * P) v.  P (H, T, T), P[h, i, j] =
  E[bucket(j - i), h], comes from layer 0's ``rel_attn_embed`` (320
  buckets: 80 exact distances a side, then logarithmic up to
  ``max_bucket_distance``, clamped past it); every later layer reuses
  layer 0's ungated P.  Each layer's gate, (B, H, T, 1), comes from x (not
  from q): x in heads of 64 through ``gru_rel_pos_linear`` (64 -> 8),
  summed in pairs of 4 to (a, b) = sigmoid(.), gate = a (b c_h - 1) + 2
  with ``gru_rel_pos_const`` c.  Two routes, chosen by what the call shows
  (``ops/gated_attention.py::takes``): a CUDA float32 call with heads of 64
  runs the hand-written kernel ``gated_attention`` on the gate and P's
  2T - 1 diagonals (P is Toeplitz; layer 0 takes them from P's first column
  and row, so the gradient reaches ``rel_attn_embed`` through P, and every
  later layer reuses them), forming the bias per tile, forward and
  backward (``fused_wavlm_attention``); every other call (the CPU,
  ``compute_dtype="bfloat16"``, other head widths) gives the gated bias,
  (B, H, T, T), to ``F.scaled_dot_product_attention`` as its float
  ``attn_mask``, which carries its gradient (``wavlm_attention``).
* LayerDrop: one gate a layer, drawn for every layer; layer 0, which makes
  P, is never dropped (HF: ``i > 0``).  As in the port's wav2vec2, a
  dropped layer is computed and its output not taken, so the step reads no
  gate on the host.

Departures from HF's model: attention dropout is carried in the config and
not applied (as in the port's wav2vec2 and the JAX model); there is no
key-padding mask, since the STP batches carry no lengths (nor does the
port's wav2vec2 path), so padded frames are attended to.

Every random draw of a train forward comes from the ``generator`` it is
given, in a fixed order: the feature projection's dropout, SpecAugment's
time then feature spans, the dropout after the positional conv, the
LayerDrop gates, then per layer the attention output's, the feed-forward's
inner and output dropouts.  ``compute_dtype="bfloat16"`` casts the inputs
and weights of every Linear and conv as the port's wav2vec2 does; the
gated bias is given to SDPA in the dtype of q.

Under tensor parallelism over ``model`` the model is refused
(``parallel/tp.py``): the split would have to cut the gate's constant, the
bucket table and P to a rank's heads as well, which is not implemented.

The profiler spans ``wavlm.relpos`` (layer 0's bucket table and lookup,
and on the kernel's route P's diagonals) and ``wavlm.gate`` (each layer's
gate, and on the library's route the gated bias) open inside the STP
task's ``stp.forward``.  ``wavlm_attention.calls`` counts the attention's
calls on both routes, ``wavlm_attention.fused_calls`` those on the
kernel, and ``wavlm_attention.bias_elements`` the B H T T elements of
gated bias made for the library's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vibravox_tpu_torch.core.profiler import span
from vibravox_tpu_torch.device import DeviceLike, resolve_device
from vibravox_tpu_torch.models.wav2vec2 import (
    Attention,
    FeatureEncoder,
    FeatureProjection,
    FeedForward,
    PositionalConvEmbedding,
    _dropout,
    _init_jax_like,
    _layer_norm,
    _linear,
    ctc_from_pretrained,
    encode_features,
)
from vibravox_tpu_torch.ops import gated_attention as fused

__all__ = [
    "WavLMConfig",
    "WavLMForCTC",
    "TINY_WAVLM_CONFIG",
    "relative_position_bucket",
    "fused_wavlm_attention",
    "wavlm_attention",
    "wavlm_for_ctc_from_config",
    "wavlm_for_ctc_from_pretrained",
]


@dataclasses.dataclass(frozen=True)
class WavLMConfig:
    """HF's ``WavLMConfig`` keys that the model reads, at
    ``microsoft/wavlm-large``'s values, the port's CTC vocabulary, and the
    port's ``compute_dtype``."""

    vocab_size: int = 38
    pad_token_id: int = 35
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    conv_dim: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    feat_extract_norm: str = "layer"
    do_stable_layer_norm: bool = True
    num_buckets: int = 320
    max_bucket_distance: int = 800
    layer_norm_eps: float = 1e-5
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1  # carried, not applied
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
    compute_dtype: Optional[str] = None

    def __post_init__(self):
        if self.feat_extract_norm not in ("group", "layer"):
            raise ValueError(f"feat_extract_norm must be 'group' or 'layer', got {self.feat_extract_norm!r}")
        if not self.do_stable_layer_norm:
            raise NotImplementedError("only WavLM's pre-norm (stable layer norm) variant is ported")
        for name in ("conv_dim", "conv_kernel", "conv_stride"):
            object.__setattr__(self, name, tuple(getattr(self, name)))


TINY_WAVLM_CONFIG: Dict[str, Any] = dict(
    hidden_size=32,
    num_hidden_layers=3,
    num_attention_heads=2,
    intermediate_size=64,
    conv_dim=(32, 32, 32, 32, 32, 32, 32),
    num_conv_pos_embeddings=16,
    num_conv_pos_embedding_groups=2,
    # a short reach, so that a second of audio (49 frames) passes the clamp
    num_buckets=32,
    max_bucket_distance=20,
)
_PRESETS = {"tiny": TINY_WAVLM_CONFIG, "large": {}}


# --------------------------------------------------------------------------- #
# The gated relative-position bias and the attention
# --------------------------------------------------------------------------- #


def relative_position_bucket(relative: torch.Tensor, num_buckets: int, max_distance: int) -> torch.Tensor:
    """HF's ``_relative_positions_bucket``: for r = j - i, ``num_buckets / 2``
    buckets a side (r > 0 on the upper half); |r| below ``num_buckets / 4``
    exactly, farther ones logarithmically up to ``max_distance``, clamped
    to the side's last bucket past it."""
    half = num_buckets // 2
    exact = half // 2
    side = (relative > 0).long() * half
    r = relative.abs()
    far = exact + (torch.log(r.float() / exact) / math.log(max_distance / exact) * (half - exact)).long()
    far = torch.clamp(far, max=half - 1)
    return side + torch.where(r < exact, r, far)


def relative_position_table(embed: nn.Embedding, t: int, num_buckets: int, max_distance: int) -> torch.Tensor:
    """P (H, T, T) float32: P[h, i, j] = E[bucket(j - i), h]."""
    pos = torch.arange(t, device=embed.weight.device)
    bucket = relative_position_bucket(pos[None, :] - pos[:, None], num_buckets, max_distance)
    return F.embedding(bucket, embed.weight).permute(2, 0, 1).contiguous()


def relative_position_gate(x: torch.Tensor, linear: nn.Linear, const: torch.Tensor,
                           dtype: Optional[torch.dtype]) -> torch.Tensor:
    """The gate (B, H, T, 1) float32 from x (B, T, H * 64): x in heads,
    ``linear`` (64 -> 8), summed in 2 groups of 4, a, b = sigmoid,
    gate = a (b c - 1) + 2."""
    b, t, _ = x.shape
    heads = const.shape[1]
    proj = _linear(x.view(b, t, heads, -1), linear, dtype).float().view(b, t, heads, 2, 4).sum(-1)
    gate_a, gate_b = torch.sigmoid(proj.transpose(1, 2)).chunk(2, dim=-1)
    return gate_a * (gate_b * const - 1.0) + 2.0


def wavlm_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d) + bias) v for q, k, v (B, H, T, d) and the
    float ``bias`` (B, H, T, T), through SDPA, which differentiates the
    bias too.  Counts its calls (``wavlm_attention.calls``) and the bias
    elements it was given (``wavlm_attention.bias_elements``)."""
    wavlm_attention.calls += 1
    wavlm_attention.bias_elements += bias.numel()
    return F.scaled_dot_product_attention(q, k, v, attn_mask=bias)


wavlm_attention.calls = 0
wavlm_attention.fused_calls = 0
wavlm_attention.bias_elements = 0


def fused_wavlm_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, gate: torch.Tensor,
                          diagonals: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d) + gate * P) v for q, k, v (B, H, T, d), the
    gate (B, H, T, 1) and P's diagonals (H, 2T - 1), on the hand-written
    kernel (``ops/gated_attention.py``), which forms the bias per tile and
    differentiates the gate and the diagonals.  Counts its calls in
    ``wavlm_attention.calls`` and ``wavlm_attention.fused_calls``."""
    wavlm_attention.calls += 1
    wavlm_attention.fused_calls += 1
    b, h, t, _ = q.shape
    return fused.gated_attention(q, k, v, gate.reshape(b, h, t), diagonals)


class WavLMAttention(Attention):
    """wav2vec2's projections, plus the gate's ``gru_rel_pos_const`` and
    ``gru_rel_pos_linear``, and in layer 0 the bucket embedding
    ``rel_attn_embed``."""

    def __init__(self, config: WavLMConfig, has_relative_position_bias: bool):
        super().__init__(config)
        self.num_buckets, self.max_distance = config.num_buckets, config.max_bucket_distance
        self.gru_rel_pos_const = nn.Parameter(torch.ones(1, self.num_heads, 1, 1))
        self.gru_rel_pos_linear = nn.Linear(self.head_dim, 8)
        if has_relative_position_bias:
            self.rel_attn_embed = nn.Embedding(self.num_buckets, self.num_heads)

    def forward(self, x: torch.Tensor, position: Optional[torch.Tensor], dtype: Optional[torch.dtype]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B, T, hidden), the layer's normed input; ``position``: what
        layer 0 made of P (P itself, or on the kernel's route its
        diagonals), or None in layer 0, which makes it.  Returns (out,
        position)."""
        b, t, _ = x.shape

        def heads(y):
            return y.view(b, t, -1, self.head_dim).transpose(1, 2)

        q, k, v = (heads(_linear(x, p, dtype)) for p in (self.q_proj, self.k_proj, self.v_proj))
        kernel = fused.takes(q.device.type, q.dtype, self.head_dim)
        if position is None:
            with span("wavlm.relpos"):
                position = relative_position_table(self.rel_attn_embed, t, self.num_buckets, self.max_distance)
                if kernel:
                    position = fused.toeplitz_diagonals(position)
        with span("wavlm.gate"):
            gate = relative_position_gate(x, self.gru_rel_pos_linear, self.gru_rel_pos_const, dtype)
            if not kernel:
                bias = (gate * position).to(q.dtype)
        attn = fused_wavlm_attention(q, k, v, gate, position) if kernel else wavlm_attention(q, k, v, bias)
        return _linear(attn.transpose(1, 2).reshape(b, t, -1), self.out_proj, dtype), position


class WavLMEncoderLayer(nn.Module):
    """HF's ``WavLMEncoderLayerStableLayerNorm``: pre-norm attention and
    feed-forward, each added to the residual stream."""

    def __init__(self, config: WavLMConfig, has_relative_position_bias: bool):
        super().__init__()
        self.attention = WavLMAttention(config, has_relative_position_bias)
        self.layer_norm = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps)
        self.feed_forward = FeedForward(config)
        self.final_layer_norm = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps)

    def forward(self, h: torch.Tensor, position: Optional[torch.Tensor], cfg: WavLMConfig,
                dtype: Optional[torch.dtype], generator: Optional[torch.Generator]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        attn, position = self.attention(_layer_norm(h, self.layer_norm), position, dtype)
        h = h + _dropout(attn, cfg.hidden_dropout, generator)
        ffn = self.feed_forward
        ff = F.gelu(_linear(_layer_norm(h, self.final_layer_norm), ffn.intermediate_dense, dtype))
        ff = _dropout(ff, cfg.activation_dropout, generator)
        return h + _dropout(_linear(ff, ffn.output_dense, dtype), cfg.hidden_dropout, generator), position


class WavLMEncoder(nn.Module):
    def __init__(self, config: WavLMConfig):
        super().__init__()
        self.pos_conv_embed = PositionalConvEmbedding(config)
        self.layer_norm = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps)
        self.layers = nn.ModuleList(WavLMEncoderLayer(config, has_relative_position_bias=i == 0)
                                    for i in range(config.num_hidden_layers))


class WavLMModel(nn.Module):
    def __init__(self, config: WavLMConfig):
        super().__init__()
        self.feature_extractor = FeatureEncoder(config)
        self.feature_projection = FeatureProjection(config)
        if config.apply_spec_augment:
            self.masked_spec_embed = nn.Parameter(torch.empty(config.hidden_size))
        self.encoder = WavLMEncoder(config)


class WavLMForCTC(nn.Module):
    """Waveform (B, T) -> float32 logits (B, T', vocab_size); the call
    surface of ``Wav2Vec2ForCTC``."""

    base_model_prefix = "wavlm"

    def __init__(self, config: WavLMConfig):
        super().__init__()
        self.config = config
        self.wavlm = WavLMModel(config)
        self.lm_head = nn.Linear(config.hidden_size, config.vocab_size)

    def forward(self, input_values: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None, freeze_feature_encoder: bool = False,
                return_features: bool = False) -> torch.Tensor:
        """``train``: dropout, SpecAugment and LayerDrop, drawn from
        ``generator`` (a fresh one seeded 0 on the input's device if None);
        ``freeze_feature_encoder``: the conv stack runs without gradients;
        ``return_features``: the encoder's normed output (B, T', hidden)
        instead of the logits."""
        cfg, model = self.config, self.wavlm
        dtype = getattr(torch, cfg.compute_dtype) if cfg.compute_dtype else None
        gen = None
        if train:
            gen = generator if generator is not None else torch.Generator(input_values.device).manual_seed(0)
        h = encode_features(model, cfg, input_values, dtype, gen, freeze_feature_encoder)

        enc = model.encoder
        h = _dropout(h + enc.pos_conv_embed(h, dtype), cfg.hidden_dropout, gen)
        keep = None
        if train and cfg.layerdrop > 0:
            keep = torch.rand(len(enc.layers), generator=gen, device=h.device) >= cfg.layerdrop
        position = None
        for i, layer in enumerate(enc.layers):
            out, position = layer(h, position, cfg, dtype, gen)
            h = torch.where(keep[i], out, h) if keep is not None and i > 0 else out
        h = _layer_norm(h, enc.layer_norm)

        if return_features:
            return h
        h = _dropout(h, cfg.final_dropout, gen)
        return _linear(h, self.lm_head, dtype).float()


# --------------------------------------------------------------------------- #
# Factories
# --------------------------------------------------------------------------- #


def wavlm_for_ctc_from_config(
    pad_token_id: int = 35,
    vocab_size: int = 38,
    preset: str = "large",
    seed: int = 0,
    device: DeviceLike = None,
    **config_overrides,
) -> WavLMForCTC:
    """A model with random weights (``preset``: ``"large"``, the published
    widths, or ``"tiny"``, ``TINY_WAVLM_CONFIG``), drawn on the CPU from
    ``seed`` as the port's wav2vec2 draws its own, then ``rel_attn_embed``
    normal (PyTorch's ``Embedding`` default, which HF keeps) and
    ``gru_rel_pos_const`` ones; moved to ``device`` (``None`` for the GPU,
    which raises without one, or ``"cpu"``)."""
    if preset not in _PRESETS:
        raise ValueError(f"unknown preset {preset!r}; there are {sorted(_PRESETS)}")
    dev = resolve_device(device)
    kwargs: Dict[str, Any] = dict(_PRESETS[preset])
    kwargs.update(config_overrides)
    model = WavLMForCTC(WavLMConfig(pad_token_id=pad_token_id, vocab_size=vocab_size, **kwargs))
    gen = _init_jax_like(model, seed)
    with torch.no_grad():
        model.wavlm.encoder.layers[0].attention.rel_attn_embed.weight.normal_(generator=gen)
    return model.to(dev)


def wavlm_for_ctc_from_pretrained(
    pretrained_model_name_or_path: str,
    pad_token_id: int = 35,
    vocab_size: int = 38,
    seed: int = 0,
    device: DeviceLike = None,
    **config_overrides,
) -> WavLMForCTC:
    """A local directory in HF's layout (``config.json``, and
    ``pytorch_model.bin`` or ``model.safetensors``), read as
    ``wav2vec2_for_ctc_from_pretrained`` reads one: ``strict=True`` names
    (``wavlm.*``, or a ``WavLMModel``'s unprefixed keys), the old
    weight-norm names, ``lm_head`` and ``masked_spec_embed`` made fresh when
    absent.  A name that is not a local directory raises: the port never
    downloads."""
    return ctc_from_pretrained(WavLMForCTC, WavLMConfig, pretrained_model_name_or_path, pad_token_id,
                               vocab_size, seed, device, config_overrides)
