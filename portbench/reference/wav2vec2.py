"""Plain reference of wav2vec2-base for CTC and of its fine-tuning step.

wav2vec2 (Baevski et al., 2020), the post-norm "base" model
(facebook/wav2vec2-base-fr-voxpopuli-v2) as the Vibravox speech-to-phoneme
recipe fine-tunes it: a frozen 7-layer conv feature encoder (GroupNorm
after the first conv, exact GELU), LayerNorm and a projection, SpecAugment
(time and feature spans), a weight-normalised grouped positional conv, post-
norm transformer layers with hidden and activation dropout and LayerDrop,
the CTC head, the CTC loss ("mean": each sequence over its target length,
then the batch mean) and one Adam step.

The random draws of a train step come, in a fixed order, from one
``torch.Generator`` on the device seeded from (seed, step) by
``numpy.random.SeedSequence``, the recipe's convention; the reference makes
the same draws in the same order, so it drops and masks what the program
drops and masks.  The CTC loss is the forward (alpha) recursion written out
in log space.  Attention is the explicit softmax(QK^T / sqrt(d)) V.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.common import Adam, Params, Precision, conv1d, leaf_norms, linear, weight_norm


@dataclasses.dataclass(frozen=True)
class W2V2Config:
    vocab_size: int
    pad_token_id: int
    hidden_size: int
    num_hidden_layers: int
    num_attention_heads: int
    intermediate_size: int
    conv_dim: Tuple[int, ...]
    conv_kernel: Tuple[int, ...]
    conv_stride: Tuple[int, ...]
    num_conv_pos_embeddings: int
    num_conv_pos_embedding_groups: int
    layer_norm_eps: float
    hidden_dropout: float
    activation_dropout: float
    feat_proj_dropout: float
    final_dropout: float
    layerdrop: float
    mask_time_prob: float
    mask_time_length: int
    mask_time_min_masks: int
    mask_feature_prob: float
    mask_feature_length: int
    mask_feature_min_masks: int

    @classmethod
    def of(cls, values: Dict) -> "W2V2Config":
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: (tuple(v) if isinstance(v, list) else v) for k, v in values.items() if k in names}
        return cls(**kw)

    def frames(self, samples: int) -> int:
        for k, s in zip(self.conv_kernel, self.conv_stride):
            samples = (samples - k) // s + 1
        return samples


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The step's generator: the first 64-bit word of SeedSequence((seed,
    step)), halved into torch's seed range."""
    key = int(np.random.SeedSequence((int(seed), int(step))).generate_state(1, np.uint64)[0] >> np.uint64(1))
    return torch.Generator(device).manual_seed(key)


def dropout(x: torch.Tensor, p: float, gen: Optional[torch.Generator]) -> torch.Tensor:
    """Keep where a uniform draw >= p, scaled by 1 / (1 - p)."""
    if gen is None or p <= 0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


def span_mask(gen: torch.Generator, batch: int, length: int, prob: float, span: int, min_spans: int,
              device) -> Optional[torch.Tensor]:
    """(batch, length) bool, the union of max(min_spans, int(prob * length /
    span)) spans a row, starts uniform in [0, length - span)."""
    n = max(min_spans, int(prob * length / span))
    if n == 0 or span >= length:
        return None
    starts = torch.randint(0, length - span, (batch, n), generator=gen, device=device)
    pos = torch.arange(length, device=device)
    return ((pos >= starts[..., None]) & (pos < starts[..., None] + span)).any(dim=1)


def layer_norm(x: torch.Tensor, p: Params, prefix: str, eps: float) -> torch.Tensor:
    return F.layer_norm(x.float(), x.shape[-1:], p[f"{prefix}.weight"], p[f"{prefix}.bias"], eps)


def forward(p: Params, cfg: W2V2Config, audio: torch.Tensor, prec: Precision,
            gen: Optional[torch.Generator]) -> torch.Tensor:
    """audio (B, T) -> float32 logits (B, T', vocab); dropout, SpecAugment
    and LayerDrop drawn from ``gen`` (None: evaluation)."""
    with torch.no_grad():  # the frozen feature encoder
        x = audio[:, None, :]
        for i, stride in enumerate(cfg.conv_stride):
            x = conv1d(x, p[f"wav2vec2.feature_extractor.conv_layers.{i}.conv.weight"], prec, stride=stride)
            if i == 0:
                g = "wav2vec2.feature_extractor.conv_layers.0.layer_norm"
                x = F.group_norm(x.float(), x.shape[1], p[f"{g}.weight"], p[f"{g}.bias"], cfg.layer_norm_eps)
            x = F.gelu(x)
    feats = x.transpose(1, 2)
    h = linear(layer_norm(feats, p, "wav2vec2.feature_projection.layer_norm", cfg.layer_norm_eps),
               p["wav2vec2.feature_projection.projection.weight"],
               p["wav2vec2.feature_projection.projection.bias"], prec)
    h = dropout(h, cfg.feat_proj_dropout, gen)
    b, t, d = h.shape
    if gen is not None:
        if cfg.mask_time_prob > 0:
            mask = span_mask(gen, b, t, cfg.mask_time_prob, cfg.mask_time_length, cfg.mask_time_min_masks, h.device)
            if mask is not None:
                h = torch.where(mask[:, :, None], p["wav2vec2.masked_spec_embed"], h)
        if cfg.mask_feature_prob > 0:
            mask = span_mask(gen, b, d, cfg.mask_feature_prob, cfg.mask_feature_length,
                             cfg.mask_feature_min_masks, h.device)
            if mask is not None:
                h = torch.where(mask[:, None, :], 0.0, h)
    pos = "wav2vec2.encoder.pos_conv_embed.conv"
    k = cfg.num_conv_pos_embeddings
    w = weight_norm(p, pos, (0, 1))  # the gain per tap
    e = conv1d(h.transpose(1, 2), w, prec, padding=(k // 2, k // 2), groups=cfg.num_conv_pos_embedding_groups)
    e = e.float() + p[f"{pos}.bias"][:, None]
    if k % 2 == 0:
        e = e[:, :, :-1]
    h = h + F.gelu(e).transpose(1, 2)
    h = dropout(layer_norm(h, p, "wav2vec2.encoder.layer_norm", cfg.layer_norm_eps), cfg.hidden_dropout, gen)
    keep = None
    if gen is not None and cfg.layerdrop > 0:
        keep = torch.rand(cfg.num_hidden_layers, generator=gen, device=h.device) >= cfg.layerdrop
    heads = cfg.num_attention_heads
    hd = cfg.hidden_size // heads
    for i in range(cfg.num_hidden_layers):
        L = f"wav2vec2.encoder.layers.{i}"

        def proj(x, name):
            return linear(x, p[f"{L}.{name}.weight"], p[f"{L}.{name}.bias"], prec)

        q, kk, v = (proj(h, f"attention.{n}_proj").view(b, t, heads, hd).transpose(1, 2) for n in "qkv")
        scores = torch.matmul(prec.operand(q), prec.operand(kk).transpose(-1, -2)) / math.sqrt(hd)
        attn = torch.matmul(prec.operand(torch.softmax(scores, dim=-1)), prec.operand(v))
        attn = proj(attn.transpose(1, 2).reshape(b, t, -1), "attention.out_proj")
        h1 = layer_norm(h + dropout(attn, cfg.hidden_dropout, gen), p, f"{L}.layer_norm", cfg.layer_norm_eps)
        ff = dropout(F.gelu(proj(h1, "feed_forward.intermediate_dense")), cfg.activation_dropout, gen)
        ff = dropout(proj(ff, "feed_forward.output_dense"), cfg.hidden_dropout, gen)
        out = layer_norm(h1 + ff, p, f"{L}.final_layer_norm", cfg.layer_norm_eps)
        h = torch.where(keep[i], out, h) if keep is not None else out
    h = dropout(h, cfg.final_dropout, gen)
    return linear(h, p["lm_head.weight"], p["lm_head.bias"], prec).float()


def ctc_nll(log_probs: torch.Tensor, labels: torch.Tensor, lengths: torch.Tensor, blank: int) -> torch.Tensor:
    """Per-sequence CTC negative log-likelihood by the forward recursion.
    ``log_probs`` (B, T, K) over all T frames; ``labels`` (B, N) with
    ``lengths`` (B,) valid ids each.  States: blank, l1, blank, l2, ... (2N + 1)."""
    b, t_len, _ = log_probs.shape
    n = labels.shape[1]
    s = 2 * n + 1
    ext = torch.full((b, s), blank, dtype=torch.long, device=labels.device)
    ext[:, 1::2] = labels.clamp(min=0)
    emit = torch.gather(log_probs, 2, ext[:, None, :].expand(b, t_len, s))  # (B, T, S)
    neg = torch.tensor(-1e30, dtype=log_probs.dtype, device=log_probs.device)
    # a skip from s - 2 is allowed into a label that differs from the one two states back
    skip = torch.zeros((b, s), dtype=torch.bool, device=labels.device)
    skip[:, 3::2] = ext[:, 3::2] != ext[:, 1:-2:2]
    state = torch.arange(s, device=labels.device)
    alpha = torch.where(state < 2, emit[:, 0], neg)
    for t in range(1, t_len):
        one = torch.cat([neg.expand(b, 1), alpha[:, :-1]], dim=1)
        two = torch.where(skip, torch.cat([neg.expand(b, 2), alpha[:, :-2]], dim=1), neg)
        alpha = torch.logsumexp(torch.stack([alpha, one, two]), dim=0) + emit[:, t]
    last = 2 * lengths  # the final blank, and the final label before it
    at_blank = alpha.gather(1, last[:, None])[:, 0]
    at_label = torch.where(lengths > 0, alpha.gather(1, (last - 1).clamp(min=0)[:, None])[:, 0], neg)
    return -torch.logaddexp(at_blank, at_label)


def ctc_mean_loss(logits: torch.Tensor, labels: torch.Tensor, blank: int) -> torch.Tensor:
    """The recipe's 'mean' CTC: each sequence's NLL over its target length
    (at least 1), averaged; labels are -100 where padded."""
    lengths = (labels != -100).sum(-1)
    nll = ctc_nll(torch.log_softmax(logits.float(), dim=-1), labels, lengths, blank)
    return (nll / lengths.clamp(min=1).float()).mean()


@dataclasses.dataclass
class W2V2Reference:
    """The fine-tuning step over plain parameters named as the HF checkpoint."""

    cfg: W2V2Config
    params: Params
    prec: Precision
    lr: float
    betas: Tuple[float, float]
    seed: int
    frozen_prefix: str = "wav2vec2.feature_extractor."
    step: int = 0

    def __post_init__(self):
        self.opt = Adam(self.lr, self.betas)
        self.first_grads: Dict[str, float] = {}

    def gradients(self, audio: torch.Tensor, labels: torch.Tensor, gen: Optional[torch.Generator]):
        """(loss, grads of the trainable parameters): the frozen encoder
        forward, the rest forward and backward."""
        trainable = [n for n in self.params if not n.startswith(self.frozen_prefix)]
        for n in trainable:
            self.params[n].requires_grad_(True)
        logits = forward(self.params, self.cfg, audio, self.prec, gen)
        loss = ctc_mean_loss(logits, labels, self.cfg.pad_token_id)
        grads = torch.autograd.grad(loss, [self.params[n] for n in trainable], allow_unused=True)
        return loss, {n: g for n, g in zip(trainable, grads) if g is not None}

    def train_step(self, audio: torch.Tensor, labels: torch.Tensor) -> Dict[str, float]:
        loss, grads = self.gradients(audio, labels, step_generator(self.seed, self.step, audio.device))
        self.opt.update(self.params, grads)
        if self.step == 0:
            self.first_grads = leaf_norms(grads)
        self.step += 1
        return {"ctc_loss": float(loss.detach())}



def param_shapes(cfg: W2V2Config) -> Dict[str, Tuple[int, ...]]:
    """The fine-tuned model's parameters by the HF checkpoint's names."""
    h, f = cfg.hidden_size, cfg.intermediate_size
    s: Dict[str, Tuple[int, ...]] = {}
    cin = 1
    for i, (dim, k) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel)):
        s[f"wav2vec2.feature_extractor.conv_layers.{i}.conv.weight"] = (dim, cin, k)
        cin = dim
    s["wav2vec2.feature_extractor.conv_layers.0.layer_norm.weight"] = (cfg.conv_dim[0],)
    s["wav2vec2.feature_extractor.conv_layers.0.layer_norm.bias"] = (cfg.conv_dim[0],)
    s["wav2vec2.feature_projection.layer_norm.weight"] = (cin,)
    s["wav2vec2.feature_projection.layer_norm.bias"] = (cin,)
    s["wav2vec2.feature_projection.projection.weight"] = (h, cin)
    s["wav2vec2.feature_projection.projection.bias"] = (h,)
    s["wav2vec2.masked_spec_embed"] = (h,)
    pos = "wav2vec2.encoder.pos_conv_embed.conv"
    k = cfg.num_conv_pos_embeddings
    s[f"{pos}.bias"] = (h,)
    s[f"{pos}.parametrizations.weight.original0"] = (1, 1, k)
    s[f"{pos}.parametrizations.weight.original1"] = (h, h // cfg.num_conv_pos_embedding_groups, k)
    s["wav2vec2.encoder.layer_norm.weight"] = (h,)
    s["wav2vec2.encoder.layer_norm.bias"] = (h,)
    for i in range(cfg.num_hidden_layers):
        L = f"wav2vec2.encoder.layers.{i}"
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            s[f"{L}.attention.{n}.weight"] = (h, h)
            s[f"{L}.attention.{n}.bias"] = (h,)
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
