"""SQUIM quality predictors, objective and subjective (PyTorch).

Counterpart of ``vibravox_tpu/models/squim.py``, the networks behind the
reference's reference-free metrics (torchaudio's ``SQUIM_OBJECTIVE`` for
``torchsquim_stoi``, ``SQUIM_SUBJECTIVE`` for ``noresqa_mos``):

* ``SquimObjective``: waveform -> (stoi, pesq, si-sdr).  The input is scaled
  to an RMS of 1/20, a learned filterbank (``Conv1d(1, 256, 64, stride
  32)``, no bias, ReLU) feeds a dual-path RNN (bidirectional LSTMs within
  and across 50 %-overlapped chunks, ``GroupNorm(1)`` residuals, a 1x1 conv
  and PReLU, overlap-add), then three branches of a post-norm transformer
  layer, ``AutoPool`` and an MLP, with a range sigmoid on STOI [0, 1] and
  PESQ [1, 4.5].
* ``SquimSubjective`` (NORESQA-MOS): the MOS of an estimate judged against a
  non-matching reference.  A wav2vec2-base backbone (the port's
  ``Wav2Vec2ForCTC`` with ``return_features=True``) encodes both, the
  features ``[reference, estimate]`` go through a projector, attention
  pooling and the MOS head.

The layouts are the JAX model's: (B, T, N) through the dual path, so
``_chunk`` and ``_merge`` compare with JAX's directly.  Parameter names are
torchaudio's state-dict keys, the schema JAX's
``squim_objective_params_from_torch`` consumes: the objective loads such a
file with ``load_state_dict(strict=True)``; the subjective's ``ssl_model.*``
keys are torchaudio's wav2vec2 names, which
``SquimSubjective.load_torchaudio_state_dict`` renames to the port's HF
names (``torchaudio_state_dict`` is the inverse).

By design, as the JAX model (the oracle): the transformer's LayerNorms use
eps 1e-6 (flax's default) where torch's ``TransformerEncoderLayer`` uses
1e-5.  The forwards run under ``strict_float32`` (IEEE float32 convolutions,
LSTMs and matmuls on the card).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vibravox_tpu_torch.device import DeviceLike, resolve_device, strict_float32
from vibravox_tpu_torch.models.wav2vec2 import (
    Wav2Vec2Config,
    Wav2Vec2ForCTC,
    _checkpoint_state_dict,
    _init_jax_like,
)

__all__ = [
    "SquimObjectiveConfig",
    "SquimSubjectiveConfig",
    "SquimObjective",
    "SquimSubjective",
    "squim_objective_base",
    "squim_subjective_base",
]


# --------------------------------------------------------------------------- #
# shared pieces
# --------------------------------------------------------------------------- #


class AutoPool(nn.Module):
    """Softmax pooling over time with a learned temperature: (B, T, C) -> (B, C)."""

    def __init__(self):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight = torch.softmax(x * self.alpha, dim=1)
        return torch.sum(x * weight, dim=1)


class _SelfAttention(nn.Module):
    """``nn.MultiheadAttention``'s parameter names: a packed q/k/v
    projection and ``out_proj``."""

    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        self.nhead = nhead
        self.in_proj_weight = nn.Parameter(nn.init.xavier_uniform_(torch.empty(3 * d_model, d_model)))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, e = x.shape

        def heads(z):
            return z.view(b, t, self.nhead, e // self.nhead).transpose(1, 2)

        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1)
        attn = F.scaled_dot_product_attention(heads(q), heads(k), heads(v))
        return self.out_proj(attn.transpose(1, 2).reshape(b, t, e))


class TransformerLayer(nn.Module):
    """``nn.TransformerEncoderLayer`` (post-norm, ReLU, no dropout) with its
    parameter names, and the JAX model's LayerNorm eps of 1e-6."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int):
        super().__init__()
        self.self_attn = _SelfAttention(d_model, nhead)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-6)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x + self.self_attn(x))
        return self.norm2(x + self.linear2(F.relu(self.linear1(x))))


# --------------------------------------------------------------------------- #
# objective model (waveform -> [stoi, pesq, si-sdr])
# --------------------------------------------------------------------------- #


class SingleRNN(nn.Module):
    """Bidirectional single-layer LSTM and a projection back to the input
    width: (B, T, N) -> (B, T, N); the forward direction comes first."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.rnn = nn.LSTM(input_size, hidden_size, batch_first=True, bidirectional=True)
        self.proj = nn.Linear(2 * hidden_size, input_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(self.rnn(x)[0])


def _chunk(x: torch.Tensor, chunk: int) -> Tuple[torch.Tensor, int]:
    """(B, T, N) -> 50 %-overlapped chunks (B, S, chunk, N) and the tail gap:
    pad the tail so the chunks tile, pad ``chunk // 2`` on both ends, then
    interleave the two half-offset chunkings."""
    b, t, n = x.shape
    stride = chunk // 2
    gap = (chunk - (stride + t % chunk) % chunk) % chunk
    x = F.pad(x, (0, 0, stride, stride + gap))
    c1 = x[:, :-stride].reshape(b, -1, chunk, n)
    c2 = x[:, stride:].reshape(b, -1, chunk, n)
    return torch.stack([c1, c2], dim=2).reshape(b, -1, chunk, n), gap


def _merge(x: torch.Tensor, gap: int, chunk: int) -> torch.Tensor:
    """Overlap-add of :func:`_chunk`'s chunks: (B, S, chunk, N) -> (B, T, N)."""
    b, s, _, n = x.shape
    stride = chunk // 2
    x = x.reshape(b, s // 2, 2 * chunk, n)
    out = x[:, :, :chunk].reshape(b, -1, n)[:, stride:] + x[:, :, chunk:].reshape(b, -1, n)[:, :-stride]
    return out[:, :out.shape[1] - gap]


def _group_norm(x: torch.Tensor, norm: nn.GroupNorm) -> torch.Tensor:
    """``GroupNorm(1)`` of (B, S, K, N) chunks over (S, K, N) per sample,
    scaled per channel N."""
    return F.group_norm(x.permute(0, 3, 1, 2), 1, norm.weight, norm.bias, norm.eps).permute(0, 2, 3, 1)


class DPRNN(nn.Module):
    """Dual-path RNN: per block an intra-chunk (row) and an inter-chunk
    (column) bi-LSTM, each added back through ``GroupNorm(1, eps=1e-8)``;
    then a 1x1 conv to ``d_model``, PReLU and overlap-add.
    (B, T, N) -> (B, T, d_model)."""

    def __init__(self, feat_dim: int, hidden_dim: int, num_blocks: int, d_model: int, chunk_size: int):
        super().__init__()
        self.chunk_size = chunk_size
        self.row_rnn = nn.ModuleList(SingleRNN(feat_dim, hidden_dim) for _ in range(num_blocks))
        self.col_rnn = nn.ModuleList(SingleRNN(feat_dim, hidden_dim) for _ in range(num_blocks))
        self.row_norm = nn.ModuleList(nn.GroupNorm(1, feat_dim, eps=1e-8) for _ in range(num_blocks))
        self.col_norm = nn.ModuleList(nn.GroupNorm(1, feat_dim, eps=1e-8) for _ in range(num_blocks))
        self.conv = nn.Sequential(nn.Conv2d(feat_dim, d_model, 1), nn.PReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out, gap = _chunk(x, self.chunk_size)
        b, s, k, n = out.shape
        for row_rnn, row_norm, col_rnn, col_norm in zip(self.row_rnn, self.row_norm, self.col_rnn, self.col_norm):
            row = row_rnn(out.reshape(b * s, k, n)).reshape(b, s, k, n)
            out = out + _group_norm(row, row_norm)
            col = col_rnn(out.transpose(1, 2).reshape(b * k, s, n)).reshape(b, k, s, n).transpose(1, 2)
            out = out + _group_norm(col, col_norm)
        conv, prelu = self.conv
        out = F.prelu(F.linear(out, conv.weight[:, :, 0, 0], conv.bias), prelu.weight)
        return _merge(out, gap, self.chunk_size)


class _Encoder(nn.Module):
    def __init__(self, feat_dim: int, win_len: int):
        super().__init__()
        self.conv1d = nn.Conv1d(1, feat_dim, win_len, stride=win_len // 2, bias=False)


@dataclasses.dataclass(frozen=True)
class SquimObjectiveConfig:
    feat_dim: int = 256
    win_len: int = 64
    d_model: int = 256
    nhead: int = 4
    hidden_dim: int = 256
    num_blocks: int = 2
    chunk_size: int = 71
    # (metric name, output range or None) per branch, in the pipeline's order
    branches: Tuple[Tuple[str, Optional[Tuple[float, float]]], ...] = (
        ("stoi", (0.0, 1.0)),
        ("pesq", (1.0, 4.5)),
        ("sisdr", None),
    )


class SquimObjective(nn.Module):
    """Waveform (B, T) -> tuple of (B,) scores in the branches' order
    (stoi, pesq, si-sdr)."""

    def __init__(self, config: SquimObjectiveConfig = SquimObjectiveConfig()):
        super().__init__()
        cfg = self.config = config
        self.encoder = _Encoder(cfg.feat_dim, cfg.win_len)
        self.dprnn = DPRNN(cfg.feat_dim, cfg.hidden_dim, cfg.num_blocks, cfg.d_model, cfg.chunk_size)
        self.branches = nn.ModuleList(
            nn.Sequential(
                TransformerLayer(cfg.d_model, cfg.nhead, 4 * cfg.d_model),
                AutoPool(),
                nn.Sequential(nn.Linear(cfg.d_model, cfg.d_model), nn.PReLU(), nn.Linear(cfg.d_model, 1)),
            )
            for _ in cfg.branches
        )

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        if x.ndim != 2:
            raise ValueError(f"expected a (batch, time) waveform, got {tuple(x.shape)}")
        with strict_float32():
            x = x / (torch.sqrt(torch.mean(x ** 2, dim=1, keepdim=True)) * 20.0)
            h = F.relu(self.encoder.conv1d(x[:, None, :]))  # (B, N, T')
            h = self.dprnn(h.transpose(1, 2))
            scores = []
            for branch, (_, val_range) in zip(self.branches, self.config.branches):
                score = branch(h)[:, 0]
                if val_range is not None:
                    lo, hi = val_range
                    score = torch.sigmoid(score) * (hi - lo) + lo
                scores.append(score)
        return tuple(scores)


# --------------------------------------------------------------------------- #
# subjective model (estimate + non-matching reference -> MOS)
# --------------------------------------------------------------------------- #


class _AttPool(nn.Module):
    """Attention pooling and a projection: (B, T, C) -> (B, att_dim)."""

    def __init__(self, in_dim: int, att_dim: int):
        super().__init__()
        self.linear1 = nn.Linear(in_dim, 1)
        self.linear2 = nn.Linear(in_dim, att_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        att = torch.softmax(self.linear1(x).transpose(1, 2), dim=2)  # (B, 1, T)
        return self.linear2(torch.matmul(att, x)[:, 0])


class _Predictor(nn.Module):
    def __init__(self, proj_dim: int, att_dim: int):
        super().__init__()
        self.att_pool_layer = _AttPool(proj_dim, att_dim)
        self.mos_layer = nn.Linear(att_dim, 1)


@dataclasses.dataclass(frozen=True)
class SquimSubjectiveConfig:
    proj_dim: int = 512
    att_dim: int = 512
    ssl: Wav2Vec2Config = Wav2Vec2Config(vocab_size=1, apply_spec_augment=False, layerdrop=0.0)


_SSL = "ssl_model."
# torchaudio's wav2vec2 prefixes -> the port's (HF's) names
_TORCHAUDIO_PREFIXES = (
    ("feature_extractor.", "wav2vec2.feature_extractor."),
    ("encoder.feature_projection.", "wav2vec2.feature_projection."),
    ("encoder.transformer.", "wav2vec2.encoder."),
)


def _torchaudio_w2v2_to_hf(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A ``torchaudio.models.Wav2Vec2Model`` state dict in HF's
    ``Wav2Vec2ForCTC`` names (the JAX package's ``_torchaudio_w2v2_to_hf``);
    an unknown key raises."""
    out = {}
    for k, v in sd.items():
        for src, dst in _TORCHAUDIO_PREFIXES:
            if k.startswith(src):
                out[dst + k[len(src):]] = v
                break
        else:
            raise ValueError(f"unrecognised torchaudio wav2vec2 key: {k}")
    return out


class SquimSubjective(nn.Module):
    """NORESQA-MOS: (B, T) estimate and (B, Tr) non-matching reference ->
    (B,) MOS.  The backbone has a one-row CTC head, which the forward never
    reads; torchaudio's files have none, so it loads as zeros."""

    def __init__(self, config: SquimSubjectiveConfig = SquimSubjectiveConfig()):
        super().__init__()
        self.config = config
        self.ssl_model = Wav2Vec2ForCTC(config.ssl)
        self.projector = nn.Linear(2 * config.ssl.hidden_size, config.proj_dim)
        self.predictor = _Predictor(config.proj_dim, config.att_dim)

    @staticmethod
    def _align(estimate: torch.Tensor, reference: torch.Tensor) -> torch.Tensor:
        """The reference tiled, then cropped, to the estimate's length."""
        t = estimate.shape[1]
        return reference.repeat(1, -(-t // reference.shape[1]))[:, :t]

    def forward(self, estimate: torch.Tensor, reference: torch.Tensor) -> torch.Tensor:
        reference = self._align(estimate, reference)
        b = estimate.shape[0]
        with strict_float32():
            # one backbone pass over both signals: every op of it is per row
            feats = self.ssl_model(torch.cat([reference, estimate]), return_features=True)
            h = self.projector(torch.cat([feats[:b], feats[b:]], dim=-1))
            return self.predictor.mos_layer(self.predictor.att_pool_layer(h))[:, 0]

    def torchaudio_state_dict(self) -> Dict[str, torch.Tensor]:
        """The state dict in torchaudio's ``SquimSubjective`` keys (no CTC head)."""
        out = {}
        for k, v in self.state_dict().items():
            if k.startswith(_SSL + "lm_head."):
                continue
            if k.startswith(_SSL):
                name = k[len(_SSL):]
                for src, dst in _TORCHAUDIO_PREFIXES:
                    if name.startswith(dst):
                        k = _SSL + src + name[len(dst):]
                        break
            out[k] = v
        return out

    def load_torchaudio_state_dict(self, sd: Dict[str, torch.Tensor]) -> None:
        """Loads a torchaudio ``SquimSubjective`` state dict, strictly: the
        ``ssl_model.*`` keys through :func:`_torchaudio_w2v2_to_hf` (old
        ``weight_g`` / ``weight_v`` names taken), the CTC head as zeros."""
        ssl = _torchaudio_w2v2_to_hf({k[len(_SSL):]: v for k, v in sd.items() if k.startswith(_SSL)})
        ssl, dropped = _checkpoint_state_dict(ssl)
        if dropped:
            raise ValueError(f"unexpected wav2vec2 keys in a SQUIM subjective state dict: {dropped}")
        cfg = self.config.ssl
        ssl.setdefault("lm_head.weight", torch.zeros(cfg.vocab_size, cfg.hidden_size))
        ssl.setdefault("lm_head.bias", torch.zeros(cfg.vocab_size))
        full = {k: v for k, v in sd.items() if not k.startswith(_SSL)}
        full.update({_SSL + k: v for k, v in ssl.items()})
        self.load_state_dict(full, strict=True)


# --------------------------------------------------------------------------- #
# random weights and factories
# --------------------------------------------------------------------------- #


@torch.no_grad()
def _init_torch_like(model: nn.Module, gen: torch.Generator) -> None:
    """torch's default initialisers' distributions, drawn from ``gen``:
    Linear and conv weights and biases uniform in +-1/sqrt(fan_in), LSTM
    weights and biases in +-1/sqrt(hidden), the packed attention projection
    Xavier-uniform with zero biases, norms 1 and 0, PReLU slopes 0.25,
    AutoPool's alpha 1."""
    def uniform(t, bound):
        nn.init.uniform_(t, -bound, bound, generator=gen)

    for module in model.modules():
        if isinstance(module, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            bound = 1.0 / math.sqrt(module.weight[0].numel())
            uniform(module.weight, bound)
            if module.bias is not None:
                uniform(module.bias, bound)
        elif isinstance(module, nn.LSTM):
            for p in module.parameters():
                uniform(p, 1.0 / math.sqrt(module.hidden_size))
        elif isinstance(module, _SelfAttention):
            e = module.in_proj_weight.shape[1]
            uniform(module.in_proj_weight, math.sqrt(6.0 / (4 * e)))
            nn.init.zeros_(module.in_proj_bias)
        elif isinstance(module, (nn.LayerNorm, nn.GroupNorm)):
            nn.init.ones_(module.weight)
            nn.init.zeros_(module.bias)
        elif isinstance(module, nn.PReLU):
            nn.init.constant_(module.weight, 0.25)
    for module in model.modules():  # after the Linear pass, which reaches out_proj
        if isinstance(module, _SelfAttention):
            nn.init.zeros_(module.out_proj.bias)


def squim_objective_base(seed: int = 0, device: DeviceLike = None) -> SquimObjective:
    """The ``SQUIM_OBJECTIVE`` architecture (feat 256, win 64, d_model 256,
    4 heads, hidden 256, 2 blocks, chunk 71; 7.39 M parameters) with random
    weights drawn on the CPU from ``seed``, moved to ``device`` (``None``
    for the GPU, which raises without one, or ``"cpu"``)."""
    dev = resolve_device(device)
    model = SquimObjective()
    _init_torch_like(model, torch.Generator().manual_seed(int(seed)))
    return model.to(dev).eval()


def squim_subjective_base(seed: int = 0, device: DeviceLike = None) -> SquimSubjective:
    """The ``SQUIM_SUBJECTIVE`` architecture (wav2vec2-base backbone,
    projector 1536 -> 512, attention pooling, MOS head) with random weights
    from ``seed``: the backbone from the JAX initialisers' distributions
    (``models/wav2vec2.py``), the head from torch's defaults."""
    dev = resolve_device(device)
    model = SquimSubjective()
    _init_jax_like(model.ssl_model, seed)
    heads = nn.ModuleList([model.projector, model.predictor])
    _init_torch_like(heads, torch.Generator().manual_seed(int(seed) + 1))
    return model.to(dev).eval()
