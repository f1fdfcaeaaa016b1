"""Cross-modal attention fusion: the counterpart of AttentionFusion in
`multimodal_rare_disease_tpu/models/fusion.py` (the default
`fusion_type='attention'`, pooled mode: each modality is a length-1
sequence, as in the reference). Concatenation and gated fusion, and
`attend_over_tokens`, are not ported yet.

flax's `nn.LayerNorm` uses eps 1e-6 (torch's default is 1e-5).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch import nn

from multimodal_rare_disease_tpu_torch.models.layers import Linear

_FLAX_LN_EPS = 1e-6


class CrossModalAttention(nn.Module):
    """Multi-head attention of a query embedding over key/value states.
    query [B, Dq]; kv [B, S, Dk] or [B, Dk] → (out [B, hidden],
    weights [B, heads, 1, S])."""

    def __init__(self, query_dim: int, kv_dim: int, hidden_dim: int,
                 num_heads: int, device):
        super().__init__()
        if hidden_dim % num_heads:
            raise ValueError("hidden_dim must divide by num_heads")
        self.num_heads = num_heads
        self.head_dim = hidden_dim // num_heads
        self.query_proj = Linear(query_dim, hidden_dim, device=device)
        self.key_proj = Linear(kv_dim, hidden_dim, device=device)
        self.value_proj = Linear(kv_dim, hidden_dim, device=device)
        self.output_proj = Linear(hidden_dim, hidden_dim, device=device)

    def forward(self, query: torch.Tensor, kv: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if kv.ndim == 2:
            kv = kv[:, None, :]
        b, s = kv.shape[:2]
        h, d = self.num_heads, self.head_dim
        q = self.query_proj(query).view(b, h, d)
        k = self.key_proj(kv).view(b, s, h, d)
        v = self.value_proj(kv).view(b, s, h, d)
        scores = torch.einsum("bhd,bshd->bhs", q, k) / math.sqrt(d)
        weights = torch.softmax(scores.float(), dim=-1).to(q.dtype)
        ctx = torch.einsum("bhs,bshd->bhd", weights, v)
        return self.output_proj(ctx.reshape(b, h * d)), weights[:, :, None, :]


class AttentionFusion(nn.Module):
    def __init__(self, image_dim: int, text_dim: int, hidden_dim: int,
                 num_heads: int, device, use_residual: bool = True):
        super().__init__()
        self.use_residual = use_residual
        self.image_proj = Linear(image_dim, hidden_dim, device=device)
        self.text_proj = Linear(text_dim, hidden_dim, device=device)
        self.image_to_text_attention = CrossModalAttention(
            hidden_dim, hidden_dim, hidden_dim, num_heads, device)
        self.text_to_image_attention = CrossModalAttention(
            hidden_dim, hidden_dim, hidden_dim, num_heads, device)
        self.layer_norm_image = nn.LayerNorm(hidden_dim, eps=_FLAX_LN_EPS,
                                             device=device)
        self.layer_norm_text = nn.LayerNorm(hidden_dim, eps=_FLAX_LN_EPS,
                                            device=device)
        self.fusion1 = Linear(2 * hidden_dim, hidden_dim, device=device)
        self.fusion2 = Linear(hidden_dim, hidden_dim, device=device)

    def forward(self, image_embedding: torch.Tensor,
                text_embedding: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        image_proj = self.image_proj(image_embedding)
        text_proj = self.text_proj(text_embedding)
        image_att, i2t_w = self.image_to_text_attention(image_proj, text_proj)
        text_att, t2i_w = self.text_to_image_attention(text_proj, image_proj)
        if self.use_residual:
            image_att = image_proj + image_att
            text_att = text_proj + text_att
        combined = torch.cat([self.layer_norm_image(image_att),
                              self.layer_norm_text(text_att)], dim=-1)
        fused = self.fusion2(torch.relu(self.fusion1(combined)))
        return fused, {"image_to_text_attention": i2t_w,
                       "text_to_image_attention": t2i_w}


def create_fusion_module(cfg, image_dim: int, text_dim: int, device
                         ) -> AttentionFusion:
    """cfg: the JAX package's FusionConfig."""
    if cfg.fusion_type != "attention":
        raise NotImplementedError(
            f"fusion_type {cfg.fusion_type!r} is not ported to the torch "
            f"package (attention only)")
    return AttentionFusion(image_dim, text_dim, cfg.hidden_dim,
                           cfg.num_attention_heads, device,
                           use_residual=cfg.use_residual)
