"""CNN image encoder: a ResNet-50 or EfficientNet-B0 backbone + proj1 →
relu → dropout → proj2, the counterpart of
`multimodal_rare_disease_tpu/models/cnn_encoder.py`."""

from __future__ import annotations

import torch
from torch import nn

from multimodal_rare_disease_tpu_torch.models.efficientnet import (
    EfficientNetB0Encoder,
)
from multimodal_rare_disease_tpu_torch.models.layers import Dropout, Linear
from multimodal_rare_disease_tpu_torch.models.resnet import ResNet50Encoder


class CNNEncoder(nn.Module):
    def __init__(self, cfg, device):
        """cfg: the JAX package's CNNEncoderConfig."""
        super().__init__()
        self.backbone_name = cfg.backbone
        if cfg.backbone == "resnet50":
            kw = {}
            if cfg.stage_sizes is not None:
                kw["stage_sizes"] = tuple(cfg.stage_sizes)
            self.backbone = ResNet50Encoder(device, **kw)
        elif cfg.backbone in ("efficientnet_b0", "efficientnet-b0"):
            # stage_sizes is ResNet's: EfficientNet ignores it, as in JAX
            self.backbone = EfficientNetB0Encoder(device)
        else:
            raise ValueError(f"Unknown backbone: {cfg.backbone!r}")
        feat = self.backbone.feature_dim()
        self.proj1 = Linear(feat, cfg.embedding_dim, device=device)
        self.proj2 = Linear(cfg.embedding_dim, cfg.embedding_dim,
                            device=device)
        self.drop = Dropout(cfg.dropout)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] normalized images → [B, embedding_dim]."""
        return self.project(self.backbone(images))

    def project(self, pooled: torch.Tensor) -> torch.Tensor:
        return self.proj2(self.drop(torch.relu(self.proj1(pooled))))

    def backbone_features(self, images: torch.Tensor):
        """Only the conv backbone: (pooled, {stage name: NHWC map}), the
        ResNet's "stage1".."stage4" or EfficientNet's "stage1".."stage7"
        and "head". Grad-CAM re-runs the tail from a captured map through
        `embed_from_feature_map`."""
        return self.backbone(images, return_features=True)

    def embed_from_feature_map(self, feature_map: torch.Tensor
                               ) -> torch.Tensor:
        """Last-stage feature map [B, h, w, C] → embedding (mean over h,
        w, then the projection)."""
        return self.project(feature_map.mean(dim=(1, 2)))

    @property
    def gradcam_layer(self) -> str:
        return "stage4" if self.backbone_name == "resnet50" else "head"

    @property
    def num_stages(self) -> int:
        return 4 if self.backbone_name == "resnet50" else 7


def create_cnn_encoder(cfg, device) -> CNNEncoder:
    return CNNEncoder(cfg, device)
