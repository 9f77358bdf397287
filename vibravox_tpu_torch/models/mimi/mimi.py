"""Mimi neural codec: SEANet, bottleneck transformers and a split RVQ (PyTorch).

Counterpart of ``vibravox_tpu/models/mimi/mimi.py``, the codec the
reference loads from ``moshi`` (``regressive_mimi.py:24-30``): 24 kHz
audio, a SEANet hop of 8 * 6 * 5 * 4 = 960 samples then a x2 downsample
conv, so 1920 samples a frame (12.5 Hz), 512-d latents, and a split
residual VQ of 32 quantizers over 2048 x 256 codebooks.

Public methods keep the JAX package's layouts: audio ``(B, T, 1)``, latents
``(B, T', D)``, codes ``(n_q, B, T')``; inside, the SEANet runs NCW.

* ``encode_to_latent`` — the unquantized latents (the regressive-Mimi
  training signal), float32 whatever ``compute_dtype``;
* ``encode`` — RVQ codes; ``quantize_latent`` — the quantized latents;
* ``decode_latent`` — quantize, then decode; ``decode`` — codes to audio;
  ``forward`` — the round trip ``decode_latent(encode_to_latent(audio))``.

``compute_dtype="bfloat16"`` (``regressive_mimi.yaml``) runs the convs and
the transformers' projections in bf16; the parameters, LayerNorms, layer
scales, the RVQ and the decoder's last conv stay float32.  Every method
runs under ``strict_float32``, so float32 convs and products are IEEE.

``Mimi`` is the model a config makes: ``MimiConfig()`` (or the ``tiny``
preset) with overrides, random weights drawn from a seeded
``torch.Generator`` with the distributions of flax's initialisers
(``init_jax_like``), on ``device`` (the GPU unless ``"cpu"``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from vibravox_tpu_torch.device import DeviceLike, resolve_device, strict_float32
from vibravox_tpu_torch.models.layers import variance_scaling_
from vibravox_tpu_torch.models.mimi.rvq import ResidualVectorQuantizer, SplitResidualVectorQuantizer
from vibravox_tpu_torch.models.mimi.seanet import CausalConv, CausalConvTranspose, SEANetDecoder, SEANetEncoder
from vibravox_tpu_torch.models.mimi.transformer import MimiTransformer

__all__ = ["MimiConfig", "MimiModule", "Mimi", "tiny_config", "init_jax_like", "ENCODER_SIDE"]

# the submodules that feed ``encode_to_latent``
ENCODER_SIDE = ("encoder", "encoder_transformer", "downsample")


@dataclasses.dataclass(frozen=True)
class MimiConfig:
    sample_rate: int = 24000
    dimension: int = 512
    n_filters: int = 64
    ratios: Tuple[int, ...] = (8, 6, 5, 4)
    transformer_layers: int = 8
    transformer_heads: int = 8
    transformer_ff: int = 2048
    sliding_window: int = 250
    rvq_dimension: int = 256
    rvq_n_q: int = 32
    rvq_codebook_size: int = 2048
    downsample: int = 2  # the encoder side's extra stride (25 Hz -> 12.5 Hz)
    compute_dtype: Optional[str] = None

    def __post_init__(self):
        object.__setattr__(self, "ratios", tuple(self.ratios))

    @property
    def hop_length(self) -> int:
        hop = self.downsample
        for r in self.ratios:
            hop *= r
        return hop  # 1920 at the defaults


def tiny_config() -> MimiConfig:
    """The JAX package's ``tiny`` preset (``mimi.py:61-66``): hop 16."""
    return MimiConfig(dimension=32, n_filters=4, ratios=(4, 2), transformer_layers=1, transformer_heads=2,
                      transformer_ff=64, rvq_dimension=16, rvq_n_q=4, rvq_codebook_size=64, downsample=2)


class MimiModule(nn.Module):
    def __init__(self, config: MimiConfig = MimiConfig()):
        super().__init__()
        self.config = config
        d = config.dimension

        def transformer():
            return MimiTransformer(d_model=d, num_layers=config.transformer_layers,
                                   num_heads=config.transformer_heads, dim_feedforward=config.transformer_ff,
                                   sliding_window=config.sliding_window)

        self.encoder = SEANetEncoder(dimension=d, n_filters=config.n_filters, ratios=config.ratios)
        self.encoder_transformer = transformer()
        # HF MimiModel: a bias-free downsample conv with edge padding, and a
        # bias-free depthwise transposed upsample conv
        self.downsample = CausalConv(d, d, 2 * config.downsample, stride=config.downsample, bias=False,
                                     pad_mode="replicate")
        self.upsample = CausalConvTranspose(d, d, 2 * config.downsample, stride=config.downsample, groups=d,
                                            bias=False)
        self.decoder_transformer = transformer()
        self.decoder = SEANetDecoder(dimension=d, n_filters=config.n_filters, ratios=config.ratios)
        self.quantizer = SplitResidualVectorQuantizer(dimension=config.rvq_dimension, input_dimension=d,
                                                      output_dimension=d, n_q=config.rvq_n_q,
                                                      codebook_size=config.rvq_codebook_size)

    @property
    def compute_dtype(self) -> Optional[torch.dtype]:
        return getattr(torch, self.config.compute_dtype) if self.config.compute_dtype else None

    @strict_float32()
    def encode_to_latent(self, audio: torch.Tensor, encoder_side: Optional[nn.Module] = None) -> torch.Tensor:
        """audio (B, T, 1) -> unquantized latents (B, T / hop, D), float32.
        ``encoder_side``: a module holding other ``encoder``,
        ``encoder_transformer`` and ``downsample`` weights to use (the
        regressive task's frozen copy); by default the model's own."""
        side = self if encoder_side is None else encoder_side
        dtype = self.compute_dtype
        h = side.encoder(audio.transpose(1, 2), dtype)
        h = side.encoder_transformer(h.transpose(1, 2), dtype)
        return side.downsample(h.transpose(1, 2), dtype).transpose(1, 2).float()

    @strict_float32()
    def encode(self, audio: torch.Tensor) -> torch.Tensor:
        """audio (B, T, 1) -> RVQ codes (n_q, B, T / hop)."""
        return self.quantizer(self.encode_to_latent(audio))[1]

    @strict_float32()
    def quantize_latent(self, latent: torch.Tensor) -> torch.Tensor:
        return self.quantizer(latent)[0]

    def _decode_quantized(self, quantized: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype
        h = self.upsample(quantized.transpose(1, 2), dtype)
        h = self.decoder_transformer(h.transpose(1, 2), dtype)
        return self.decoder(h.transpose(1, 2), dtype).transpose(1, 2)

    @strict_float32()
    def decode_latent(self, latent: torch.Tensor) -> torch.Tensor:
        """latents (B, T', D) -> quantized -> waveform (B, T' * hop, 1), float32."""
        return self._decode_quantized(self.quantizer(latent)[0])

    @strict_float32()
    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """RVQ codes (n_q, B, T') -> waveform (B, T' * hop, 1), float32."""
        return self._decode_quantized(self.quantizer.decode(codes))

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        """The round trip audio -> latents -> quantized -> audio."""
        return self.decode_latent(self.encode_to_latent(audio))


@torch.no_grad()
def init_jax_like(model: nn.Module, seed: int) -> None:
    """flax's initialisers' distributions: conv, transposed-conv and dense
    kernels truncated ``lecun_normal`` over flax's fan-in (every axis of
    the JAX kernel but the last: ``k * in`` for a conv,
    ``in * out / groups`` for a transposed conv, ``in`` for a dense layer),
    codebooks ``normal(1.0)``; biases (0), LayerNorms (1, 0) and layer
    scales (0.01) keep their construction values."""
    gen = torch.Generator().manual_seed(int(seed))
    for module in model.modules():
        if isinstance(module, CausalConv):
            variance_scaling_(module.weight, 1.0, module.weight.shape[1] * module.weight.shape[2], gen)
        elif isinstance(module, CausalConvTranspose):
            variance_scaling_(module.weight, 1.0, module.weight.shape[0] * module.weight.shape[1], gen)
        elif isinstance(module, nn.Linear):
            variance_scaling_(module.weight, 1.0, module.in_features, gen)
        elif isinstance(module, ResidualVectorQuantizer):
            module.codebooks.normal_(0.0, 1.0, generator=gen)


class Mimi(MimiModule):
    """The codec with random weights from ``seed``.  ``config``: a
    ``MimiConfig``; else ``preset`` (``None`` for the published
    ``MimiConfig()``, or ``"tiny"``) with ``overrides`` (``compute_dtype``,
    any ``MimiConfig`` field) on top.  ``device``: ``None`` for the GPU
    (raises without one), or ``"cpu"``."""

    def __init__(self, config: Optional[MimiConfig] = None, preset: Optional[str] = None, seed: int = 0,
                 device: DeviceLike = None, **overrides):
        device = resolve_device(device)
        if config is None:
            if preset not in (None, "tiny"):
                raise ValueError(f"unknown Mimi preset {preset!r}; use None or 'tiny'")
            config = dataclasses.replace(tiny_config() if preset == "tiny" else MimiConfig(), **overrides)
        super().__init__(config)
        init_jax_like(self, seed)
        self.to(device)

    @property
    def frame_size(self) -> int:
        return self.config.hop_length

    def valid_length(self, length: int) -> int:
        """``length`` rounded up to a whole number of frames."""
        return -(-length // self.frame_size) * self.frame_size
