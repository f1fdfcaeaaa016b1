"""Deterministic eval preprocessing on the device: the eval path of
`multimodal_rare_disease_tpu/ops/preprocess.py`.

uint8 images staged at 256 px → antialiased separable bilinear resample
composed with the center crop to `image_size` (two batched f32 matmuls,
which the JAX package leaves to XLA and this port to PyTorch) →
ImageNet normalization. Images that already arrive at `image_size` are
only normalized, by K4 (`kernels/image.py`, a hand-written CUDA kernel
on the card). Layout is NHWC throughout, as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _axis_weights(scale: torch.Tensor, shift: torch.Tensor, out_size: int,
                  in_size: int, filter_width: float = 1.0) -> torch.Tensor:
    """Per-image 1-D interpolation matrices W [B, out, in]: source
    coordinate src(o) = scale*o + shift; W[b,o,i] = tent((src-i)/fw),
    rows renormalized (clamp-to-edge). fw > 1 widens the tent to PIL's
    antialiasing triangle."""
    fw = float(max(filter_width, 1.0))
    dev = scale.device
    o = torch.arange(out_size, dtype=torch.float32, device=dev)
    i = torch.arange(in_size, dtype=torch.float32, device=dev)
    src = scale[:, None] * o[None, :] + shift[:, None]           # [B, out]
    d = (src[:, :, None] - i[None, None, :]).abs()               # [B, out, in]
    w = (1.0 - d / fw).clamp(0.0, 1.0)
    return w / w.sum(-1, keepdim=True).clamp_min(1e-8)


def separable_resample(images: torch.Tensor,
                       scale_y: torch.Tensor, shift_y: torch.Tensor,
                       scale_x: torch.Tensor, shift_x: torch.Tensor,
                       out_size: int, filter_width: float = 1.0
                       ) -> torch.Tensor:
    """Axis-aligned affine resample of [B,H,W,C] by two batched matmuls
    in f32 → [B, out, out, C] f32."""
    _, h, w, _ = images.shape
    x = images.to(torch.float32)
    wy = _axis_weights(scale_y, shift_y, out_size, h, filter_width)
    wx = _axis_weights(scale_x, shift_x, out_size, w, filter_width)
    x = torch.einsum("boh,bhwc->bowc", wy, x)
    return torch.einsum("bpw,bowc->bopc", wx, x)


def eval_resample_params(in_size: int, image_size: int, mode: str
                         ) -> Tuple[float, float, float]:
    """(scale, shift, filter_width) of the eval resample, PIL half-pixel
    convention. 'resize_crop' = Resize(image_size+10) + CenterCrop;
    'resize' = Resize(image_size)."""
    if mode == "resize":
        resize_size = image_size
    elif mode == "resize_crop":
        resize_size = image_size + 10
    else:
        raise ValueError(f"unknown eval_transform {mode!r}")
    scale = in_size / resize_size
    offset = (resize_size - image_size) / 2.0
    shift = (offset + 0.5) * scale - 0.5
    return scale, shift, max(scale, 1.0)


def _normalize01(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return ((x - mean) / std).to(dtype)


def normalize_images(images: torch.Tensor,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B,H,W,3] in [0,1] (or uint8 0..255) → ImageNet-normalized dtype."""
    x = images.to(torch.float32)
    if images.dtype == torch.uint8:
        x = x / 255.0
    return _normalize01(x, dtype)


def eval_preprocess(images_uint8: torch.Tensor, cfg,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B, S, S, 3] uint8 → [B, image_size, image_size, 3] normalized.

    Images that already arrive at `image_size` (S == image_size, e.g.
    the predictor's 256-px staging with image_size 256) are only
    normalized, by the fused uint8 normalize K4: its CUDA kernel on the
    card, its plain version for CPU tensors, as the JAX package's
    `eval_preprocess(use_pallas=True)` takes its Pallas kernel."""
    d = cfg.data
    b, in_size = images_uint8.shape[0], images_uint8.shape[1]
    if in_size == d.image_size:
        from multimodal_rare_disease_tpu_torch.kernels.image import (
            fused_normalize_u8,
        )

        return fused_normalize_u8(images_uint8, dtype)
    scale, shift, fw = eval_resample_params(
        in_size, d.image_size, getattr(d, "eval_transform", "resize_crop"))
    dev = images_uint8.device
    scale_b = torch.full((b,), scale, dtype=torch.float32, device=dev)
    shift_b = torch.full((b,), shift, dtype=torch.float32, device=dev)
    x = separable_resample(images_uint8, scale_b, shift_b, scale_b, shift_b,
                           d.image_size, filter_width=fw) / 255.0
    return _normalize01(x, dtype)
