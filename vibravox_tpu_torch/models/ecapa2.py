"""ECAPA2 speaker embedder (PyTorch), NCHW as ``(B, C, T, F)``.

Counterpart of ``vibravox_tpu/models/ecapa2.py``: the log-mel front end
(``ops/mel.py``, K3 on the GPU) with per-utterance mean normalisation; a
2-D local feature extractor (a 3x3 stem, then residual stages of two 3x3
convs with BatchNorm, ReLU and frequency-wise squeeze-excitation, striding
only the frequency axis); the frequency x channel flatten into 1-D
channels, a pointwise projection and a dilated SE-Res2Net block; attentive
statistics pooling; BatchNorm and a linear map to the embedding.

The module names are the key layout of the JAX package's converter
``ecapa2_params_from_torchscript`` (``stem``, ``stage{s}.block{b}.{conv1,
bn1,conv2,bn2,fwse.fc1,fwse.fc2,shortcut}``, ``gfe_block.res2_convs.{i}``,
``pooling.att_conv{1,2}``, ``pool_bn``, ``embedding``), so a torch
checkpoint in that layout loads with ``load_state_dict(strict=True)``.

As in the JAX model:

* BatchNorm always normalises with the running statistics, whatever
  ``train()`` says (``use_running_average=True`` throughout);
* the flatten is frequency-major: channel ``f * C + c`` of the GFE input
  is channel ``c`` of frequency ``f``;
* ``compute_dtype="bfloat16"`` casts where flax casts: each conv and dense
  layer takes its input, weight and bias in bf16, BatchNorm normalises in
  float32 and returns bf16, and the pooling statistics, ``pool_bn`` and
  ``embedding`` stay float32; the parameters stay float32.  The float32
  path runs its convolutions in IEEE float32 (``strict_float32``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vibravox_tpu_torch.device import DeviceLike, resolve_device, strict_float32
from vibravox_tpu_torch.ops.mel import log_mel_spectrogram

__all__ = ["ECAPA2", "ECAPA2Config", "PRESETS", "ecapa2_from_config", "FwSEBlock", "LFEBlock",
           "SERes2NetBlock", "AttentiveStatsPooling"]


def _cast(t: Optional[torch.Tensor], dtype: Optional[torch.dtype]) -> Optional[torch.Tensor]:
    return t if t is None or dtype is None else t.to(dtype)


def conv(layer: nn.Module, x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """A ``nn.Conv1d`` / ``nn.Conv2d`` with input, weight and bias in
    ``dtype`` (flax ``nn.Conv(dtype=...)``); ``None`` keeps float32."""
    return layer._conv_forward(_cast(x, dtype), _cast(layer.weight, dtype), _cast(layer.bias, dtype))


def dense(layer: nn.Linear, x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    return F.linear(_cast(x, dtype), _cast(layer.weight, dtype), _cast(layer.bias, dtype))


def batch_norm(layer: nn.modules.batchnorm._BatchNorm, x: torch.Tensor,
               dtype: Optional[torch.dtype]) -> torch.Tensor:
    """Normalisation by the running statistics over channel axis 1, in
    float32 for a bf16 input, returned in ``dtype`` (float32 if ``None``)."""
    return F.batch_norm(_cast(x, dtype or torch.float32), layer.running_mean, layer.running_var,
                        layer.weight, layer.bias, training=False, eps=layer.eps)


class FwSEBlock(nn.Module):
    """Frequency-wise squeeze-excitation: squeeze over (channels, time),
    excite each frequency bin."""

    def __init__(self, freq: int, bottleneck: int = 128):
        super().__init__()
        self.fc1 = nn.Linear(freq, bottleneck)
        self.fc2 = nn.Linear(bottleneck, freq)

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:  # (B, C, T, F)
        z = x.mean(dim=(1, 2))
        s = torch.sigmoid(dense(self.fc2, torch.relu(dense(self.fc1, z, dtype)), dtype))
        return x * s[:, None, None, :]


class LFEBlock(nn.Module):
    """conv3x3 -> BN -> ReLU -> conv3x3 -> BN -> fwSE, plus a pointwise
    shortcut where the shape changes; stride (1, freq_stride)."""

    def __init__(self, cin: int, cout: int, freq_stride: int, freq_out: int):
        super().__init__()
        stride = (1, freq_stride)
        self.conv1 = nn.Conv2d(cin, cout, 3, stride=stride, padding=1)
        self.bn1 = nn.BatchNorm2d(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.bn2 = nn.BatchNorm2d(cout)
        self.fwse = FwSEBlock(freq_out)
        if cin != cout or freq_stride != 1:
            self.shortcut = nn.Conv2d(cin, cout, 1, stride=stride)

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        h = torch.relu(batch_norm(self.bn1, conv(self.conv1, x, dtype), dtype))
        h = self.fwse(batch_norm(self.bn2, conv(self.conv2, h, dtype), dtype), dtype)
        if hasattr(self, "shortcut"):
            x = conv(self.shortcut, x, dtype)
        return torch.relu(h + x)


class SERes2NetBlock(nn.Module):
    """1-D SE-Res2Net block with dilation (the GFE's temporal model), on
    ``(B, C, T)``; ``res2_convs`` holds the convs of splits 1..scale-1."""

    def __init__(self, channels: int, kernel_size: int = 3, dilation: int = 2, scale: int = 8,
                 se_bottleneck: int = 128):
        super().__init__()
        self.scale = scale
        width = channels // scale
        self.conv_in = nn.Conv1d(channels, channels, 1)
        self.bn_in = nn.BatchNorm1d(channels)
        # SAME padding: (kernel_size - 1) * dilation in all, half each side
        self.res2_convs = nn.ModuleDict({
            str(i): nn.Conv1d(width, width, kernel_size, dilation=dilation,
                              padding=(kernel_size - 1) * dilation // 2)
            for i in range(1, scale)
        })
        self.conv_out = nn.Conv1d(channels, channels, 1)
        self.bn_out = nn.BatchNorm1d(channels)
        self.se_fc1 = nn.Linear(channels, se_bottleneck)
        self.se_fc2 = nn.Linear(se_bottleneck, channels)

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        h = torch.relu(batch_norm(self.bn_in, conv(self.conv_in, x, dtype), dtype))
        width = h.shape[1] // self.scale
        outs = [h[:, :width]]
        prev = None
        for i in range(1, self.scale):
            chunk = h[:, i * width:(i + 1) * width]
            prev = torch.relu(conv(self.res2_convs[str(i)], chunk if prev is None else chunk + prev, dtype))
            outs.append(prev)
        h = conv(self.conv_out, torch.cat(outs, dim=1), dtype)
        h = torch.relu(batch_norm(self.bn_out, h, dtype))
        s = torch.relu(dense(self.se_fc1, h.mean(dim=2), dtype))
        s = torch.sigmoid(dense(self.se_fc2, s, dtype))
        return x + h * s[:, :, None]


class AttentiveStatsPooling(nn.Module):
    """Channel-dependent attentive mean and std with global context,
    ``(B, C, T) -> (B, 2C)``; the softmax and the weighted statistics in
    float32."""

    def __init__(self, channels: int, bottleneck: int = 128):
        super().__init__()
        self.att_conv1 = nn.Conv1d(3 * channels, bottleneck, 1)
        self.att_conv2 = nn.Conv1d(bottleneck, channels, 1)

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        mean = x.mean(dim=2, keepdim=True)
        std = torch.sqrt(torch.clamp(x.var(dim=2, keepdim=True, correction=0), min=1e-8))
        ctx = torch.cat([x, mean.expand_as(x), std.expand_as(x)], dim=1)
        a = conv(self.att_conv2, torch.tanh(conv(self.att_conv1, ctx, dtype)), dtype)
        a = torch.softmax(a.float(), dim=2)
        x = x.float()
        mu = (a * x).sum(dim=2)
        sg = torch.sqrt(torch.clamp((a * x * x).sum(dim=2) - mu**2, min=1e-8))
        return torch.cat([mu, sg], dim=1)


@dataclasses.dataclass(frozen=True)
class ECAPA2Config:
    sample_rate: int = 16000
    n_mels: int = 80
    stem_channels: int = 64
    # (channels, n_blocks, freq_stride of the first block) per LFE stage;
    # frequency 80 -> 40 -> 20 -> 10 -> 5 with time resolution preserved
    lfe_stages: Tuple[Tuple[int, int, int], ...] = (
        (64, 3, 2), (96, 4, 2), (128, 4, 2), (128, 4, 2),
    )
    gfe_channels: int = 1024
    gfe_dilation: int = 2
    res2_scale: int = 8
    embed_dim: int = 192
    # "bfloat16": the conv and dense trunk in bf16 (parameters, the pooling
    # statistics and the embedding head stay float32)
    compute_dtype: str = "float32"


# the published geometry ("full") and the JAX package's tiny preset, the
# geometry of its converter twin
PRESETS = {
    "full": lambda: ECAPA2Config(),
    "tiny": lambda: ECAPA2Config(
        stem_channels=8,
        lfe_stages=((8, 1, 2), (12, 1, 2)),
        gfe_channels=16,
        res2_scale=4,
        embed_dim=16,
    ),
}


def ecapa2_from_config(preset: str = "full", device: DeviceLike = None, **overrides) -> "ECAPA2":
    """Config-system factory: a preset with field overrides."""
    cfg = PRESETS[preset]()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return ECAPA2(config=cfg, device=device)


def _strided(freq: int, stride: int) -> int:
    """Frequency bins after a 3-tap conv with padding 1 and this stride."""
    return (freq - 1) // stride + 1


class ECAPA2(nn.Module):
    """(B, T) 16 kHz waveform -> (B, embed_dim) float32 speaker embedding.
    ``device``: ``None`` for the GPU (raises without one), or ``"cpu"``;
    the parameters are made on the CPU from torch's default generator and
    moved there."""

    def __init__(self, config: ECAPA2Config = ECAPA2Config(), device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.config = cfg = config
        self.stem = nn.Conv2d(1, cfg.stem_channels, 3, padding=1)
        self.stem_bn = nn.BatchNorm2d(cfg.stem_channels)
        freq, cin = cfg.n_mels, cfg.stem_channels
        for si, (ch, n_blocks, stride) in enumerate(cfg.lfe_stages):
            stage = nn.Module()
            for bi in range(n_blocks):
                s = stride if bi == 0 else 1
                freq = _strided(freq, s)
                stage.add_module(f"block{bi}", LFEBlock(cin, ch, s, freq))
                cin = ch
            self.add_module(f"stage{si}", stage)
        self.gfe_proj = nn.Conv1d(freq * cin, cfg.gfe_channels, 1)
        self.gfe_bn = nn.BatchNorm1d(cfg.gfe_channels)
        self.gfe_block = SERes2NetBlock(cfg.gfe_channels, dilation=cfg.gfe_dilation, scale=cfg.res2_scale)
        self.pooling = AttentiveStatsPooling(cfg.gfe_channels)
        self.pool_bn = nn.BatchNorm1d(2 * cfg.gfe_channels)
        self.embedding = nn.Linear(2 * cfg.gfe_channels, cfg.embed_dim)
        self.to(device)

    def compute_dtype(self) -> Optional[torch.dtype]:
        return None if self.config.compute_dtype == "float32" else getattr(torch, self.config.compute_dtype)

    def features(self, audio: torch.Tensor) -> torch.Tensor:
        """Mean-normalised log-mel features ``(B, frames, n_mels)``, float32."""
        feats = log_mel_spectrogram(audio, sample_rate=self.config.sample_rate, n_mels=self.config.n_mels)
        return feats - feats.mean(dim=1, keepdim=True)

    @strict_float32()
    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype()
        x = self.features(audio)[:, None]  # (B, 1, T, F)
        x = torch.relu(batch_norm(self.stem_bn, conv(self.stem, x, dtype), dtype))
        for si, (_, n_blocks, _) in enumerate(self.config.lfe_stages):
            stage = getattr(self, f"stage{si}")
            for bi in range(n_blocks):
                x = getattr(stage, f"block{bi}")(x, dtype)
        b, c, t, f = x.shape
        # frequency-major flatten, as the JAX model's (B, T, F * C) reshape
        h = x.permute(0, 3, 1, 2).reshape(b, f * c, t)
        h = torch.relu(batch_norm(self.gfe_bn, conv(self.gfe_proj, h, dtype), dtype))
        h = self.gfe_block(h, dtype)
        pooled = batch_norm(self.pool_bn, self.pooling(h, dtype), None)
        return self.embedding(pooled)
