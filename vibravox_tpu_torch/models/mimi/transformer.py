"""The causal bottleneck transformers of the Mimi codec (PyTorch).

Counterpart of ``vibravox_tpu/models/mimi/transformer.py``: pre-norm layers
with rotary embeddings and layer scales, on ``(B, T, D)``.

* RoPE in the rotate-half convention (HF Mimi), not interleaved pairs; the
  angle table is float32, from the float64 inverse frequencies rounded to
  float32, then cast to q's dtype.
* Attention is causal with a sliding window: key j is visible to query i
  when ``0 <= i - j < sliding_window``.  The JAX model calls XLA's
  ``dot_product_attention``; here ``F.scaled_dot_product_attention`` with
  the same band as a boolean mask.
* With ``dtype`` (bf16), the q / k / v / out and feed-forward projections
  take bf16 inputs and weights; the residual stream, both LayerNorms and
  the layer scales stay float32.  GELU is exact.
* Under tensor parallelism (``parallel/tp.py``) a layer holds
  ``num_heads / M`` heads and ``dim_feedforward / M`` units, with
  Megatron's all-reduce after ``out_proj`` and after ``linear2``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vibravox_tpu_torch.models.mimi.seanet import cast
from vibravox_tpu_torch.parallel.tp import ModelShard

__all__ = ["rope", "attention_mask", "TransformerLayer", "MimiTransformer"]


def rope(q: torch.Tensor, k: torch.Tensor):
    """Rotary embeddings of (B, T, H, D) q and k, rotate-half, base 10000."""
    t, d = q.shape[1], q.shape[-1]
    inv_freq = torch.from_numpy(1.0 / (10000.0 ** (np.arange(0, d, 2) / d))).to(q.device, torch.float32)
    freqs = torch.arange(t, device=q.device, dtype=torch.float32)[:, None] * inv_freq[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)[None, :, None, :]
    cos, sin = emb.cos().to(q.dtype), emb.sin().to(q.dtype)

    def rot(x):
        x1, x2 = x[..., : d // 2], x[..., d // 2:]
        return x * cos + torch.cat([-x2, x1], dim=-1) * sin

    return rot(q), rot(k)


def attention_mask(t: int, sliding_window: Optional[int], device) -> torch.Tensor:
    """(T, T) boolean, True where query i may see key j: causal, and within
    ``sliding_window`` frames unless it is None."""
    ones = torch.ones(t, t, dtype=torch.bool, device=device)
    allowed = ones.tril()  # j <= i
    if sliding_window is not None:
        allowed &= ones.triu(1 - sliding_window)  # j > i - sliding_window
    return allowed


class TransformerLayer(nn.Module):
    """Mimi's layer: LayerNorms of eps 1e-5, layer scales initialised to 0.01."""

    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int, sliding_window: Optional[int] = 250):
        super().__init__()
        self.num_heads, self.sliding_window = num_heads, sliding_window
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.q_proj = nn.Linear(d_model, d_model, bias=False)
        self.k_proj = nn.Linear(d_model, d_model, bias=False)
        self.v_proj = nn.Linear(d_model, d_model, bias=False)
        self.out_proj = nn.Linear(d_model, d_model, bias=False)
        self.layer_scale_1 = nn.Parameter(torch.full((d_model,), 0.01))
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = nn.Linear(d_model, dim_feedforward, bias=False)
        self.linear2 = nn.Linear(dim_feedforward, d_model, bias=False)
        self.layer_scale_2 = nn.Parameter(torch.full((d_model,), 0.01))
        # set by parallel.tp.shard_transformer_: this rank's heads / units
        self.tp_attention: Optional[ModelShard] = None
        self.tp_ffn: Optional[ModelShard] = None

    @staticmethod
    def _dense(layer: nn.Linear, x: torch.Tensor, dtype: Optional[torch.dtype],
               tp: Optional[ModelShard] = None) -> torch.Tensor:
        """With ``tp``, a row-parallel product: partial sums all-reduced."""
        out = F.linear(cast(x, dtype), cast(layer.weight, dtype))
        return out if tp is None else tp.exit(out)

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        x = x.float()
        b, t, d = x.shape
        head_dim = d // self.num_heads
        h = self.norm1(x)
        tp = self.tp_attention
        if tp is not None:
            h = tp.enter(h)
        q, k, v = (self._dense(p, h, dtype).view(b, t, -1, head_dim)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        q, k = rope(q, k)
        mask = attention_mask(t, self.sliding_window, x.device)
        attn = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                              attn_mask=mask)
        attn = self._dense(self.out_proj, attn.transpose(1, 2).reshape(b, t, -1), dtype, tp)
        x = x + self.layer_scale_1 * attn.float()
        tp = self.tp_ffn
        h = self.norm2(x)
        ff = self._dense(self.linear1, tp.enter(h) if tp is not None else h, dtype)
        ff = self._dense(self.linear2, F.gelu(ff), dtype, tp)
        return x + self.layer_scale_2 * ff.float()


class MimiTransformer(nn.Module):
    """``num_layers`` layers named ``layer_{i}``; (B, T, D) in, float32 out."""

    def __init__(self, d_model: int = 512, num_layers: int = 8, num_heads: int = 8, dim_feedforward: int = 2048,
                 sliding_window: Optional[int] = 250):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer_{i}", TransformerLayer(d_model, num_heads, dim_feedforward, sliding_window))

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, dtype)
        return x
