"""Plain reference of WavLM-Large for CTC and of its fine-tuning step.

WavLM (Chen et al., IEEE JSTSP 2022, arXiv 2110.13900), the pre-norm
("stable layer norm") model that microsoft/wavlm-large publishes, with the
layer equations of HF's ``modeling_wavlm.py``, as the Vibravox
speech-to-phoneme recipe would fine-tune it: a frozen 7-layer conv feature
encoder (a LayerNorm after each conv, exact GELU), LayerNorm and a
projection, SpecAugment, the weight-normalised grouped positional conv
added to its input, then dropout; pre-norm layers whose attention adds a
gated relative-position bias to its scores; the encoder's LayerNorm; the
CTC head, the CTC loss ("mean") and one Adam step (``reference.wav2vec2``,
``reference.common``).

The attention, for layer l with normed input x (B, T, D), heads of d:

    P[h, i, j]  = E[bucket(j - i), h]      E: layer 0's (num_buckets, H) table
    bucket(r)   = (num_buckets / 2) [r > 0]
                  + |r|                                   if |r| < e
                  + min(n - 1, e + floor(log(|r| / e) / log(m / e) (n - e)))   otherwise
                  with n = num_buckets / 2, e = n / 2, m = max_bucket_distance
    (a, b)      = sigmoid(sum over groups of 4 of (x in heads of d) W_g + b_g)
    gate        = a (b c_l - 1) + 2                        (B, H, T, 1)
    attention   = softmax(q k^T / sqrt(d) + gate P) v

written out as matrix products and an explicit softmax.  Layer 0 makes P;
every layer gates it with its own gate.  LayerDrop never drops layer 0.

The random draws of a train step come, in the program's order, from one
generator seeded from (seed, step) (``reference.wav2vec2.step_generator``):
the projection's dropout, the time and feature spans, the dropout after the
positional conv, one LayerDrop gate a layer, then per layer the attention
output's dropout and the feed-forward's two.  Attention dropout is not
applied, and no key-padding mask is used, as in the program.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.common import Params, Precision, conv1d, linear, weight_norm
from portbench.reference.wav2vec2 import W2V2Config, W2V2Reference, ctc_mean_loss, dropout, layer_norm, span_mask

PREFIX = "wavlm"


@dataclasses.dataclass(frozen=True)
class WavLMRefConfig(W2V2Config):
    num_buckets: int
    max_bucket_distance: int


def bucket(relative: torch.Tensor, num_buckets: int, max_distance: int) -> torch.Tensor:
    """The bucket of each relative position r = j - i, by the formula above."""
    n = num_buckets // 2
    e = n // 2
    r = relative.abs()
    ratio = torch.clamp(r, min=e).float() / e
    far = torch.floor(torch.log(ratio) / math.log(max_distance / e) * (n - e)).long() + e
    return n * (relative > 0).long() + torch.where(r < e, r, torch.clamp(far, max=n - 1))


def position_table(embed: torch.Tensor, t: int, num_buckets: int, max_distance: int) -> torch.Tensor:
    """P (H, T, T) from the (num_buckets, H) table."""
    pos = torch.arange(t, device=embed.device)
    return embed[bucket(pos[None, :] - pos[:, None], num_buckets, max_distance)].permute(2, 0, 1)


def gate(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, c: torch.Tensor, heads: int,
         prec: Precision) -> torch.Tensor:
    """(B, H, T, 1): x (B, T, D) in heads, through the 8-wide projection,
    summed in two groups of four, a and b their sigmoids."""
    bsz, t, d = x.shape
    xh = x.reshape(bsz, t, heads, d // heads).permute(0, 2, 1, 3)
    g = linear(xh, w, b, prec).float().reshape(bsz, heads, t, 2, 4).sum(-1)
    a, bb = torch.sigmoid(g[..., :1]), torch.sigmoid(g[..., 1:])
    return a * (bb * c - 1.0) + 2.0


def forward(p: Params, cfg: WavLMRefConfig, audio: torch.Tensor, prec: Precision,
            gen: Optional[torch.Generator]) -> torch.Tensor:
    """audio (B, T) -> float32 logits (B, T', vocab); dropout, SpecAugment
    and LayerDrop drawn from ``gen`` (None: evaluation)."""
    eps = cfg.layer_norm_eps
    with torch.no_grad():  # the frozen feature encoder
        x = audio[:, None, :]
        for i, stride in enumerate(cfg.conv_stride):
            c = f"{PREFIX}.feature_extractor.conv_layers.{i}"
            x = conv1d(x, p[f"{c}.conv.weight"], prec, stride=stride)
            x = F.gelu(layer_norm(x.transpose(1, 2), p, f"{c}.layer_norm", eps).transpose(1, 2))
    feats = x.transpose(1, 2)
    h = linear(layer_norm(feats, p, f"{PREFIX}.feature_projection.layer_norm", eps),
               p[f"{PREFIX}.feature_projection.projection.weight"],
               p[f"{PREFIX}.feature_projection.projection.bias"], prec)
    h = dropout(h, cfg.feat_proj_dropout, gen)
    b, t, d = h.shape
    if gen is not None:
        if cfg.mask_time_prob > 0:
            mask = span_mask(gen, b, t, cfg.mask_time_prob, cfg.mask_time_length, cfg.mask_time_min_masks, h.device)
            if mask is not None:
                h = torch.where(mask[:, :, None], p[f"{PREFIX}.masked_spec_embed"], h)
        if cfg.mask_feature_prob > 0:
            mask = span_mask(gen, b, d, cfg.mask_feature_prob, cfg.mask_feature_length,
                             cfg.mask_feature_min_masks, h.device)
            if mask is not None:
                h = torch.where(mask[:, None, :], 0.0, h)
    pos = f"{PREFIX}.encoder.pos_conv_embed.conv"
    k = cfg.num_conv_pos_embeddings
    w = weight_norm(p, pos, (0, 1))
    e = conv1d(h.transpose(1, 2), w, prec, padding=(k // 2, k // 2), groups=cfg.num_conv_pos_embedding_groups)
    e = e.float() + p[f"{pos}.bias"][:, None]
    if k % 2 == 0:
        e = e[:, :, :-1]
    h = dropout(h + F.gelu(e).transpose(1, 2), cfg.hidden_dropout, gen)
    keep = None
    if gen is not None and cfg.layerdrop > 0:
        keep = torch.rand(cfg.num_hidden_layers, generator=gen, device=h.device) >= cfg.layerdrop
    heads = cfg.num_attention_heads
    hd = d // heads
    table = None
    for i in range(cfg.num_hidden_layers):
        L = f"{PREFIX}.encoder.layers.{i}"

        def proj(x, name):
            return linear(x, p[f"{L}.{name}.weight"], p[f"{L}.{name}.bias"], prec)

        x = layer_norm(h, p, f"{L}.layer_norm", eps)
        if table is None:
            table = position_table(p[f"{L}.attention.rel_attn_embed.weight"], t, cfg.num_buckets,
                                   cfg.max_bucket_distance)
        g = gate(x, p[f"{L}.attention.gru_rel_pos_linear.weight"], p[f"{L}.attention.gru_rel_pos_linear.bias"],
                 p[f"{L}.attention.gru_rel_pos_const"], heads, prec)
        q, kk, v = (proj(x, f"attention.{n}_proj").view(b, t, heads, hd).transpose(1, 2) for n in "qkv")
        scores = torch.matmul(prec.operand(q), prec.operand(kk).transpose(-1, -2)) / math.sqrt(hd) + g * table
        attn = torch.matmul(prec.operand(torch.softmax(scores, dim=-1)), prec.operand(v))
        attn = proj(attn.transpose(1, 2).reshape(b, t, -1), "attention.out_proj")
        h1 = h + dropout(attn, cfg.hidden_dropout, gen)
        ff = F.gelu(proj(layer_norm(h1, p, f"{L}.final_layer_norm", eps), "feed_forward.intermediate_dense"))
        ff = dropout(ff, cfg.activation_dropout, gen)
        out = h1 + dropout(proj(ff, "feed_forward.output_dense"), cfg.hidden_dropout, gen)
        h = torch.where(keep[i], out, h) if keep is not None and i > 0 else out
    h = dropout(layer_norm(h, p, f"{PREFIX}.encoder.layer_norm", eps), cfg.final_dropout, gen)
    return linear(h, p["lm_head.weight"], p["lm_head.bias"], prec).float()


@dataclasses.dataclass
class WavLMReference(W2V2Reference):
    """The fine-tuning step over plain parameters named as HF's WavLMForCTC."""

    frozen_prefix: str = f"{PREFIX}.feature_extractor."

    def gradients(self, audio: torch.Tensor, labels: torch.Tensor, gen: Optional[torch.Generator]):
        trainable = [n for n in self.params if not n.startswith(self.frozen_prefix)]
        for n in trainable:
            self.params[n].requires_grad_(True)
        logits = forward(self.params, self.cfg, audio, self.prec, gen)
        loss = ctc_mean_loss(logits, labels, self.cfg.pad_token_id)
        grads = torch.autograd.grad(loss, [self.params[n] for n in trainable], allow_unused=True)
        return loss, {n: g for n, g in zip(trainable, grads) if g is not None}


def param_shapes(cfg: WavLMRefConfig) -> Dict[str, Tuple[int, ...]]:
    """The model's parameters by HF's WavLMForCTC names (no conv bias)."""
    h, f, heads = cfg.hidden_size, cfg.intermediate_size, cfg.num_attention_heads
    s: Dict[str, Tuple[int, ...]] = {}
    cin = 1
    for i, (dim, k) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel)):
        c = f"{PREFIX}.feature_extractor.conv_layers.{i}"
        s[f"{c}.conv.weight"] = (dim, cin, k)
        s[f"{c}.layer_norm.weight"] = (dim,)
        s[f"{c}.layer_norm.bias"] = (dim,)
        cin = dim
    s[f"{PREFIX}.feature_projection.layer_norm.weight"] = (cin,)
    s[f"{PREFIX}.feature_projection.layer_norm.bias"] = (cin,)
    s[f"{PREFIX}.feature_projection.projection.weight"] = (h, cin)
    s[f"{PREFIX}.feature_projection.projection.bias"] = (h,)
    s[f"{PREFIX}.masked_spec_embed"] = (h,)
    pos = f"{PREFIX}.encoder.pos_conv_embed.conv"
    k = cfg.num_conv_pos_embeddings
    s[f"{pos}.bias"] = (h,)
    s[f"{pos}.parametrizations.weight.original0"] = (1, 1, k)
    s[f"{pos}.parametrizations.weight.original1"] = (h, h // cfg.num_conv_pos_embedding_groups, k)
    s[f"{PREFIX}.encoder.layer_norm.weight"] = (h,)
    s[f"{PREFIX}.encoder.layer_norm.bias"] = (h,)
    for i in range(cfg.num_hidden_layers):
        L = f"{PREFIX}.encoder.layers.{i}"
        s[f"{L}.attention.gru_rel_pos_const"] = (1, heads, 1, 1)
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            s[f"{L}.attention.{n}.weight"] = (h, h)
            s[f"{L}.attention.{n}.bias"] = (h,)
        s[f"{L}.attention.gru_rel_pos_linear.weight"] = (8, h // heads)
        s[f"{L}.attention.gru_rel_pos_linear.bias"] = (8,)
        if i == 0:
            s[f"{L}.attention.rel_attn_embed.weight"] = (cfg.num_buckets, heads)
        for n in ("layer_norm", "final_layer_norm"):
            s[f"{L}.{n}.weight"] = (h,)
            s[f"{L}.{n}.bias"] = (h,)
        s[f"{L}.feed_forward.intermediate_dense.weight"] = (f, h)
        s[f"{L}.feed_forward.intermediate_dense.bias"] = (f,)
        s[f"{L}.feed_forward.output_dense.weight"] = (h, f)
        s[f"{L}.feed_forward.output_dense.bias"] = (h,)
    s["lm_head.weight"] = (cfg.vocab_size, h)
    s["lm_head.bias"] = (cfg.vocab_size,)
    return s
