"""EfficientNet-B0 image backbone: the counterpart of
`multimodal_rare_disease_tpu/models/efficientnet.py`.

Stem 3x3/s2 conv → 16 MBConv blocks (`_B0_BLOCKS`: 1x1 expansion, a
depthwise k×k conv with symmetric k // 2 padding, squeeze-excitation, a
1x1 projection, the residual where the shape is kept) → 1x1 head conv
to 1280 → global mean. Activations are swish (`F.silu`); BatchNorm has
eps 1e-3 (running statistics in eval mode, batch statistics in train
mode, as `layers.BatchNorm`). Module names follow the flax tree
(`stem_conv`, `stage{i}_block{r}.dw_conv`, `se.reduce`, `head_bn`, ...),
so `models/convert.py` and the freeze rules take it unchanged. The public
input and the feature maps ("stage1".."stage7", "head") are NHWC like
the JAX module's; inside, the tensor is an NCHW view in channels_last
memory, as in `models/resnet.py`. The JAX package has no Pallas kernel
here: the convolutions are cuDNN's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_rare_disease_tpu_torch.models.layers import BatchNorm, Conv2d

_BN_EPS = 1e-3

# (expand_ratio, out_channels, num_repeats, stride, kernel)
_B0_BLOCKS = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)


class SqueezeExcite(nn.Module):
    def __init__(self, channels: int, reduced: int, device):
        super().__init__()
        self.reduce = Conv2d(channels, reduced, 1, device=device)
        self.expand = Conv2d(reduced, channels, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.expand(F.silu(self.reduce(s)))
        return x * torch.sigmoid(s)


class MBConvBlock(nn.Module):
    def __init__(self, in_ch: int, expand_ratio: int, out_ch: int,
                 stride: int, kernel: int, device, se_ratio: float = 0.25):
        super().__init__()
        mid = in_ch * expand_ratio
        if expand_ratio != 1:
            self.expand_conv = Conv2d(in_ch, mid, 1, bias=False,
                                      device=device)
            self.expand_bn = BatchNorm(mid, _BN_EPS, device)
        else:
            self.expand_conv = None
        self.dw_conv = Conv2d(mid, mid, kernel, stride=stride,
                              padding=kernel // 2, groups=mid, bias=False,
                              device=device)
        self.dw_bn = BatchNorm(mid, _BN_EPS, device)
        self.se = SqueezeExcite(mid, max(1, int(in_ch * se_ratio)), device)
        self.project_conv = Conv2d(mid, out_ch, 1, bias=False, device=device)
        self.project_bn = BatchNorm(out_ch, _BN_EPS, device)
        self.residual = stride == 1 and in_ch == out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x
        if self.expand_conv is not None:
            out = F.silu(self.expand_bn(self.expand_conv(out)))
        out = F.silu(self.dw_bn(self.dw_conv(out)))
        out = self.project_bn(self.project_conv(self.se(out)))
        return out + x if self.residual else out


class EfficientNetB0Encoder(nn.Module):
    """[B, H, W, 3] → [B, 1280] pooled features."""

    def __init__(self, device):
        super().__init__()
        self.stem_conv = Conv2d(3, 32, 3, stride=2, padding=1, bias=False,
                                device=device)
        self.stem_bn = BatchNorm(32, _BN_EPS, device)
        in_ch = 32
        for i, (expand, out_ch, repeats, stride, kernel) in enumerate(
                _B0_BLOCKS):
            for r in range(repeats):
                self.add_module(f"stage{i + 1}_block{r}", MBConvBlock(
                    in_ch, expand, out_ch, stride if r == 0 else 1, kernel,
                    device))
                in_ch = out_ch
        self.head_conv = Conv2d(in_ch, 1280, 1, bias=False, device=device)
        self.head_bn = BatchNorm(1280, _BN_EPS, device)

    def forward(self, images_nhwc: torch.Tensor,
                return_features: bool = False):
        """[B, H, W, 3] → pooled [B, 1280]; with `return_features`,
        (pooled, {"stage1".."stage7", "head": NHWC views}), the JAX
        module's (pooled, features)."""
        x = images_nhwc.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        x = F.silu(self.stem_bn(self.stem_conv(x)))
        features = {}
        for i, (_, _, repeats, _, _) in enumerate(_B0_BLOCKS):
            for r in range(repeats):
                x = getattr(self, f"stage{i + 1}_block{r}")(x)
            if return_features:
                features[f"stage{i + 1}"] = x.permute(0, 2, 3, 1)
        x = F.silu(self.head_bn(self.head_conv(x)))
        pooled = x.mean(dim=(2, 3))
        if return_features:
            features["head"] = x.permute(0, 2, 3, 1)
            return pooled, features
        return pooled

    @staticmethod
    def num_stages() -> int:
        return 7

    @staticmethod
    def feature_dim() -> int:
        return 1280
