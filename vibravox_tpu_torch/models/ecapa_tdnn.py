"""ECAPA-TDNN speaker embedder (PyTorch), NCW as ``(B, C, T)``.

Counterpart of ``vibravox_tpu/models/ecapa_tdnn.py::ECAPATDNN``, the
config-selectable stand-in for ECAPA2 (``embedder._target_=...ECAPATDNN``):
the same log-mel front end (``ops/mel.py``, K3 on the GPU) with
per-utterance mean normalisation, a 5-tap stem, three dilated SE-Res2Net
TDNN blocks (conv -> ReLU -> BatchNorm, as the JAX model orders them),
multi-layer feature aggregation into 1536 channels, attentive statistics
pooling (``var + 1e-7`` under the root, the weighted variance clipped at
1e-7), BatchNorm and a linear map to the embedding.  Module names are the
flax names (``conv_stem``, ``block_1.conv_{i}``, ``pooling.attn_1``, ...);
``models/convert.py::ecapa_tdnn_state_dict_from_jax`` relays JAX weights.
BatchNorm always uses the running statistics, and the convolutions run in
IEEE float32 (``strict_float32``).
"""

from __future__ import annotations

import torch
from torch import nn

from vibravox_tpu_torch.device import DeviceLike, resolve_device, strict_float32
from vibravox_tpu_torch.models.ecapa2 import batch_norm
from vibravox_tpu_torch.ops.mel import log_mel_spectrogram

__all__ = ["ECAPATDNN"]

MFA_CHANNELS = 1536


class SEBlock(nn.Module):
    """Squeeze-excitation over the channel axis."""

    def __init__(self, channels: int, bottleneck: int = 128):
        super().__init__()
        self.fc1 = nn.Linear(channels, bottleneck)
        self.fc2 = nn.Linear(bottleneck, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = torch.sigmoid(self.fc2(torch.relu(self.fc1(x.mean(dim=2)))))
        return x * s[:, :, None]


class Res2NetTDNNBlock(nn.Module):
    """1x1 conv -> scale-split dilated convs -> 1x1 conv -> SE, residual."""

    def __init__(self, channels: int, kernel_size: int, dilation: int, scale: int = 8):
        super().__init__()
        self.scale = scale
        width = channels // scale
        self.conv_in = nn.Conv1d(channels, channels, 1)
        self.bn_in = nn.BatchNorm1d(channels)
        pad = (kernel_size - 1) * dilation // 2
        for i in range(1, scale):
            self.add_module(f"conv_{i}", nn.Conv1d(width, width, kernel_size, dilation=dilation, padding=pad))
            self.add_module(f"bn_{i}", nn.BatchNorm1d(width))
        self.conv_out = nn.Conv1d(channels, channels, 1)
        self.bn_out = nn.BatchNorm1d(channels)
        self.se = SEBlock(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = batch_norm(self.bn_in, torch.relu(self.conv_in(x)), None)
        width = h.shape[1] // self.scale
        outs = [h[:, :width]]
        prev = None
        for i in range(1, self.scale):
            chunk = h[:, i * width:(i + 1) * width]
            y = torch.relu(getattr(self, f"conv_{i}")(chunk if prev is None else chunk + prev))
            prev = batch_norm(getattr(self, f"bn_{i}"), y, None)
            outs.append(prev)
        h = batch_norm(self.bn_out, torch.relu(self.conv_out(torch.cat(outs, dim=1))), None)
        return self.se(h) + x


class AttentiveStatsPooling(nn.Module):
    """Channel-dependent attentive statistics pooling, ``(B, C, T) -> (B, 2C)``."""

    def __init__(self, channels: int, bottleneck: int = 128):
        super().__init__()
        self.attn_1 = nn.Conv1d(3 * channels, bottleneck, 1)
        self.attn_2 = nn.Conv1d(bottleneck, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=2, keepdim=True)
        std = torch.sqrt(x.var(dim=2, keepdim=True, correction=0) + 1e-7)
        ctx = torch.cat([x, mean.expand_as(x), std.expand_as(x)], dim=1)
        attn = torch.softmax(self.attn_2(torch.tanh(self.attn_1(ctx))), dim=2)
        mu = (attn * x).sum(dim=2)
        sigma = torch.sqrt(torch.clamp((attn * x**2).sum(dim=2) - mu**2, min=1e-7))
        return torch.cat([mu, sigma], dim=1)


class ECAPATDNN(nn.Module):
    """(B, T) 16 kHz waveform -> (B, embed_dim) float32 embedding.
    ``device``: ``None`` for the GPU (raises without one), or ``"cpu"``;
    the parameters are made on the CPU from torch's default generator and
    moved there."""

    def __init__(self, channels: int = 512, embed_dim: int = 192, n_mels: int = 80, sample_rate: int = 16000,
                 scale: int = 8, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.n_mels, self.sample_rate = n_mels, sample_rate
        self.conv_stem = nn.Conv1d(n_mels, channels, 5, padding=2)
        self.bn_stem = nn.BatchNorm1d(channels)
        self.block_1 = Res2NetTDNNBlock(channels, 3, 2, scale)
        self.block_2 = Res2NetTDNNBlock(channels, 3, 3, scale)
        self.block_3 = Res2NetTDNNBlock(channels, 3, 4, scale)
        self.mfa_conv = nn.Conv1d(3 * channels, MFA_CHANNELS, 1)
        self.pooling = AttentiveStatsPooling(MFA_CHANNELS)
        self.bn_pool = nn.BatchNorm1d(2 * MFA_CHANNELS)
        self.embedding = nn.Linear(2 * MFA_CHANNELS, embed_dim)
        self.to(device)

    def features(self, audio: torch.Tensor) -> torch.Tensor:
        """Mean-normalised log-mel features ``(B, frames, n_mels)``."""
        feats = log_mel_spectrogram(audio, sample_rate=self.sample_rate, n_mels=self.n_mels)
        return feats - feats.mean(dim=1, keepdim=True)

    @strict_float32()
    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        h = self.features(audio).transpose(1, 2)  # (B, n_mels, frames)
        h = batch_norm(self.bn_stem, torch.relu(self.conv_stem(h)), None)
        h1 = self.block_1(h)
        h2 = self.block_2(h1)
        h3 = self.block_3(h2)
        mfa = torch.relu(self.mfa_conv(torch.cat([h1, h2, h3], dim=1)))
        pooled = batch_norm(self.bn_pool, self.pooling(mfa), None)
        return self.embedding(pooled)
