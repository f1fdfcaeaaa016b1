"""ResNet-50 image backbone: the counterpart of
`multimodal_rare_disease_tpu/models/resnet.py`.

Canonical 7×7/s2 stem (the JAX module's space-to-depth stem computes the
same conv at inference and is not ported; its train mode uses the
canonical conv too), bottleneck blocks with projection shortcuts,
BatchNorm (eps 1e-5; running statistics in eval mode, batch statistics
in train mode), max-pool 3/2/1 and a global mean. The public input and the stage feature maps (Grad-CAM's target is
"stage4") are NHWC like the JAX module's; inside, the tensor is an NCHW
view in channels_last memory, which cuDNN convolves natively.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_rare_disease_tpu_torch.models.layers import BatchNorm, Conv2d

_BN_EPS = 1e-5


def _conv(in_ch: int, out_ch: int, k: int, stride: int, device) -> Conv2d:
    # the JAX module pads k // 2 on every side (its [(k//2, k//2)] * 2)
    return Conv2d(in_ch, out_ch, k, stride=stride, padding=k // 2,
                  bias=False, device=device)


class BottleneckBlock(nn.Module):
    """1x1 → 3x3 (strided) → 1x1, projection shortcut when the shape
    changes; output width 4 * filters."""

    def __init__(self, in_ch: int, filters: int, strides: int, device):
        super().__init__()
        out_ch = filters * 4
        self.conv1 = _conv(in_ch, filters, 1, 1, device)
        self.bn1 = BatchNorm(filters, _BN_EPS, device)
        self.conv2 = _conv(filters, filters, 3, strides, device)
        self.bn2 = BatchNorm(filters, _BN_EPS, device)
        self.conv3 = _conv(filters, out_ch, 1, 1, device)
        self.bn3 = BatchNorm(out_ch, _BN_EPS, device)
        if in_ch != out_ch or strides != 1:
            self.downsample_conv = _conv(in_ch, out_ch, 1, strides, device)
            self.downsample_bn = BatchNorm(out_ch, _BN_EPS, device)
        else:
            self.downsample_conv = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x
        if self.downsample_conv is not None:
            residual = self.downsample_bn(self.downsample_conv(x))
        return F.relu(out + residual)


class ResNet50Encoder(nn.Module):
    """[B, H, W, 3] → [B, 2048] pooled features."""

    def __init__(self, device, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 widths: Sequence[int] = (64, 128, 256, 512)):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.stem_conv = _conv(3, 64, 7, 2, device)
        self.stem_bn = BatchNorm(64, _BN_EPS, device)
        in_ch = 64
        for i, (n, w) in enumerate(zip(self.stage_sizes, widths)):
            for b in range(n):
                strides = 2 if (b == 0 and i > 0) else 1
                self.add_module(f"stage{i + 1}_block{b}",
                                BottleneckBlock(in_ch, w, strides, device))
                in_ch = w * 4

    def forward(self, images_nhwc: torch.Tensor,
                return_features: bool = False):
        """[B, H, W, 3] → pooled [B, 2048]; with `return_features`,
        (pooled, {"stage1".."stage4": the stage's output as an NHWC
        view}), the JAX module's (pooled, features)."""
        x = images_nhwc.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
        features = {}
        for i, n in enumerate(self.stage_sizes):
            for b in range(n):
                x = getattr(self, f"stage{i + 1}_block{b}")(x)
            if return_features:
                features[f"stage{i + 1}"] = x.permute(0, 2, 3, 1)
        pooled = x.mean(dim=(2, 3))
        return (pooled, features) if return_features else pooled

    @staticmethod
    def feature_dim() -> int:
        return 2048
