"""Multimodal fusion: the counterpart of
`multimodal_rare_disease_tpu/models/fusion.py`.

- ConcatenationFusion: concat(image, text) → fuse1 → relu → fuse2;
- AttentionFusion (the default): both embeddings projected to the
  hidden width, bidirectional multi-head cross-modal attention, residual
  + LayerNorm, concat + MLP. In the pooled mode each modality is a
  length-1 sequence, so every weight is exactly 1, as in the reference;
  with `attend_over_tokens` the image attends over the BERT tokens
  (`text_token_proj`, padded tokens masked to -1e9);
- GatedFusion: a sigmoid gate mixes the projected modalities.

Each returns (fused, info): the attention fusion's two per-head weight
maps [B, heads, 1, S] (before dropout), the gate, or nothing. In train
mode dropout acts at the JAX sites: the attention weights, and after the
relu of each MLP. flax's `nn.LayerNorm` uses
eps 1e-6 (torch's default is 1e-5).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from multimodal_rare_disease_tpu_torch.models.layers import Dropout, Linear

_FLAX_LN_EPS = 1e-6


class CrossModalAttention(nn.Module):
    """Multi-head attention of a query embedding over key/value states.
    query [B, Dq]; kv [B, S, Dk] or [B, Dk]; kv_mask [B, S] (0 = masked)
    → (out [B, hidden], weights [B, heads, 1, S])."""

    def __init__(self, query_dim: int, kv_dim: int, hidden_dim: int,
                 num_heads: int, device, dropout: float = 0.0):
        super().__init__()
        if hidden_dim % num_heads:
            raise ValueError("hidden_dim must divide by num_heads")
        self.num_heads = num_heads
        self.dropout = Dropout(dropout)  # on the attention weights
        self.head_dim = hidden_dim // num_heads
        self.query_proj = Linear(query_dim, hidden_dim, device=device)
        self.key_proj = Linear(kv_dim, hidden_dim, device=device)
        self.value_proj = Linear(kv_dim, hidden_dim, device=device)
        self.output_proj = Linear(hidden_dim, hidden_dim, device=device)

    def forward(self, query: torch.Tensor, kv: torch.Tensor,
                kv_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if kv.ndim == 2:
            kv = kv[:, None, :]
        b, s = kv.shape[:2]
        h, d = self.num_heads, self.head_dim
        q = self.query_proj(query).view(b, h, d)
        k = self.key_proj(kv).view(b, s, h, d)
        v = self.value_proj(kv).view(b, s, h, d)
        scores = torch.einsum("bhd,bshd->bhs", q, k) / math.sqrt(d)
        if kv_mask is not None:
            scores = torch.where(kv_mask[:, None, :] > 0, scores,
                                 torch.full_like(scores, -1e9))
        weights = torch.softmax(scores.float(), dim=-1).to(q.dtype)
        ctx = torch.einsum("bhs,bshd->bhd", self.dropout(weights), v)
        return self.output_proj(ctx.reshape(b, h * d)), weights[:, :, None, :]


class ConcatenationFusion(nn.Module):
    def __init__(self, image_dim: int, text_dim: int, hidden_dim: int,
                 device, dropout: float = 0.0):
        super().__init__()
        self.dropout = Dropout(dropout)
        self.fuse1 = Linear(image_dim + text_dim, hidden_dim, device=device)
        self.fuse2 = Linear(hidden_dim, hidden_dim, device=device)

    def forward(self, image_embedding: torch.Tensor,
                text_embedding: torch.Tensor, **_ignored
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        combined = torch.cat([image_embedding, text_embedding], dim=-1)
        return self.fuse2(self.dropout(torch.relu(self.fuse1(combined)))), {}


class AttentionFusion(nn.Module):
    def __init__(self, image_dim: int, text_dim: int, hidden_dim: int,
                 num_heads: int, device, use_residual: bool = True,
                 attend_over_tokens: bool = False, dropout: float = 0.0):
        super().__init__()
        self.use_residual = use_residual
        self.dropout = Dropout(dropout)
        self.attend_over_tokens = attend_over_tokens
        self.image_proj = Linear(image_dim, hidden_dim, device=device)
        self.text_proj = Linear(text_dim, hidden_dim, device=device)
        if attend_over_tokens:
            # the BERT tokens are hidden_size wide, as the CLS embedding
            # (the text tower's projection is off in this model)
            self.text_token_proj = Linear(text_dim, hidden_dim,
                                          device=device)
        self.image_to_text_attention = CrossModalAttention(
            hidden_dim, hidden_dim, hidden_dim, num_heads, device, dropout)
        self.text_to_image_attention = CrossModalAttention(
            hidden_dim, hidden_dim, hidden_dim, num_heads, device, dropout)
        self.layer_norm_image = nn.LayerNorm(hidden_dim, eps=_FLAX_LN_EPS,
                                             device=device)
        self.layer_norm_text = nn.LayerNorm(hidden_dim, eps=_FLAX_LN_EPS,
                                            device=device)
        self.fusion1 = Linear(2 * hidden_dim, hidden_dim, device=device)
        self.fusion2 = Linear(hidden_dim, hidden_dim, device=device)

    def forward(self, image_embedding: torch.Tensor,
                text_embedding: torch.Tensor,
                text_tokens: Optional[torch.Tensor] = None,
                text_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        image_proj = self.image_proj(image_embedding)
        text_proj = self.text_proj(text_embedding)
        if self.attend_over_tokens and text_tokens is not None:
            text_kv, kv_mask = self.text_token_proj(text_tokens), text_mask
        else:
            text_kv, kv_mask = text_proj, None
        image_att, i2t_w = self.image_to_text_attention(image_proj, text_kv,
                                                        kv_mask)
        text_att, t2i_w = self.text_to_image_attention(text_proj, image_proj)
        if self.use_residual:
            image_att = image_proj + image_att
            text_att = text_proj + text_att
        combined = torch.cat([self.layer_norm_image(image_att),
                              self.layer_norm_text(text_att)], dim=-1)
        fused = self.fusion2(self.dropout(torch.relu(self.fusion1(combined))))
        return fused, {"image_to_text_attention": i2t_w,
                       "text_to_image_attention": t2i_w}


class GatedFusion(nn.Module):
    def __init__(self, image_dim: int, text_dim: int, hidden_dim: int,
                 device, dropout: float = 0.0):
        super().__init__()
        self.dropout = Dropout(dropout)
        self.image_proj = Linear(image_dim, hidden_dim, device=device)
        self.text_proj = Linear(text_dim, hidden_dim, device=device)
        self.gate = Linear(2 * hidden_dim, hidden_dim, device=device)
        self.output = Linear(hidden_dim, hidden_dim, device=device)

    def forward(self, image_embedding: torch.Tensor,
                text_embedding: torch.Tensor, **_ignored
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        image_proj = self.image_proj(image_embedding)
        text_proj = self.text_proj(text_embedding)
        gate = torch.sigmoid(self.gate(torch.cat([image_proj, text_proj],
                                                 dim=-1)))
        fused = gate * image_proj + (1.0 - gate) * text_proj
        return self.dropout(torch.relu(self.output(fused))), {"gate": gate}


def create_fusion_module(cfg, image_dim: int, text_dim: int, device,
                         attend_over_tokens: bool = False) -> nn.Module:
    """cfg: a FusionConfig (`config.py`)."""
    if cfg.fusion_type == "concatenation":
        return ConcatenationFusion(image_dim, text_dim, cfg.hidden_dim,
                                   device, cfg.dropout)
    if cfg.fusion_type == "attention":
        return AttentionFusion(image_dim, text_dim, cfg.hidden_dim,
                               cfg.num_attention_heads, device,
                               use_residual=cfg.use_residual,
                               attend_over_tokens=attend_over_tokens,
                               dropout=cfg.dropout)
    if cfg.fusion_type == "gated":
        return GatedFusion(image_dim, text_dim, cfg.hidden_dim, device,
                           cfg.dropout)
    raise ValueError(f"Unknown fusion_type: {cfg.fusion_type!r}")
