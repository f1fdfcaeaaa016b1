"""Image preprocessing on the device: the counterpart of
`multimodal_rare_disease_tpu/ops/preprocess.py`.

Eval: uint8 images staged at 256 px → antialiased separable bilinear
resample composed with the center crop to `image_size` (two batched f32
matmuls, which the JAX package leaves to XLA and this port to PyTorch) →
ImageNet normalization. Images that already arrive at `image_size` are
only normalized, by K4 (`kernels/image.py`, a hand-written CUDA kernel
on the card), unless the caller turns it off as the trainer's
validation does.

Train (`train_preprocess`, the JAX `geometry_mode='separable'` stack):
horizontal flip, random resized crop as the same separable resample,
Paeth rotation (`ops/rotate.py`) through bf16, brightness / contrast /
saturation jitter and hue jitter, then normalization. Each random op is
split into a draw (`draw_train_params`, from an explicit
`torch.Generator`, in the JAX order of subkeys) and an apply at given
parameters (`train_preprocess_apply`): torch cannot reproduce a JAX key,
so the apply half is what is held against the JAX package. The
default-off extras of the JAX stack (blur, noise, erasing, perspective,
CLAHE, elastic, coarse dropout, the `gather` geometry) are not ported: a
config that turns one on raises NotImplementedError.

Layout is NHWC throughout, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

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
                    dtype: torch.dtype = torch.float32,
                    use_kernel: bool = True) -> torch.Tensor:
    """[B, S, S, 3] uint8 → [B, image_size, image_size, 3] normalized.

    Images that already arrive at `image_size` (S == image_size, e.g.
    the predictor's 256-px staging with image_size 256) are only
    normalized, by the fused uint8 normalize K4 (its CUDA kernel on the
    card, its plain version for CPU tensors) as the JAX package's
    `eval_preprocess(use_pallas=True)` takes its Pallas kernel, or in
    plain torch with `use_kernel=False` (its `use_pallas=False`)."""
    d = cfg.data
    b, in_size = images_uint8.shape[0], images_uint8.shape[1]
    if in_size == d.image_size and not use_kernel:
        return _normalize01(images_uint8.to(torch.float32) / 255.0, dtype)
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


# ---------------------------------------------------------------------------
# train augmentation
# ---------------------------------------------------------------------------

# the JAX stack's default-off extras, not ported: (flag, value that is off)
_UNPORTED_EXTRAS = (
    ("gaussian_blur_prob", 0.0), ("gaussian_noise_std", 0.0),
    ("random_erasing_prob", 0.0), ("perspective_prob", 0.0),
    ("clahe_prob", 0.0), ("elastic_prob", 0.0),
    ("coarse_dropout_prob", 0.0), ("geometry_mode", "separable"),
)


def check_train_augmentation(data_cfg) -> None:
    """Raise NotImplementedError, naming the flag, for a config that
    turns on an augmentation the port does not have."""
    for flag, off in _UNPORTED_EXTRAS:
        value = getattr(data_cfg, flag, off)
        if value != off:
            raise NotImplementedError(
                f"data.{flag}={value!r} is not ported to the torch package "
                f"(ROADMAP P10b)")


def _crop_params(in_size: float, out_size: float, crop_scale: torch.Tensor,
                 shift_frac: torch.Tensor):
    """(area fraction, [-1, 1] center offset) → (scale, shift) for one
    axis of separable_resample."""
    crop_size = in_size * torch.sqrt(crop_scale)
    scale = crop_size / out_size
    slack = (in_size - crop_size) / 2.0
    center = (in_size - 1.0) / 2.0 + shift_frac * slack
    return scale, center - scale * (out_size - 1.0) / 2.0


def color_jitter(images: torch.Tensor, brightness: torch.Tensor,
                 contrast: torch.Tensor, saturation: torch.Tensor
                 ) -> torch.Tensor:
    """Brightness, contrast and saturation factors [B] applied to
    [B, H, W, 3] in [0, 1] (the JAX `color_jitter` at drawn factors)."""
    bf, cf, sf = (f.reshape(-1, 1, 1, 1) for f in
                  (brightness, contrast, saturation))
    x = images * bf
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    x = (x - mean) * cf + mean
    gray = x.mean(dim=-1, keepdim=True)
    x = (x - gray) * sf + gray
    return x.clamp(0.0, 1.0)


def hue_rotate(images: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Rotate the hue of [B, H, W, 3] in [0, 1] by `delta` [B, 1, 1]
    fractions of the hue circle (PIL/colorsys HSV semantics)."""
    r, g, b = images[..., 0], images[..., 1], images[..., 2]
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    diff = mx - mn
    safe = torch.where(diff > 0, diff, torch.ones_like(diff))
    h = torch.where(
        mx == r, (g - b) / safe,
        torch.where(mx == g, 2.0 + (b - r) / safe, 4.0 + (r - g) / safe)
    ) / 6.0
    h = torch.where(diff > 0, torch.remainder(h, 1.0), torch.zeros_like(h))
    s = torch.where(mx > 0, diff / mx.clamp_min(1e-12), torch.zeros_like(mx))
    v = mx
    h = torch.remainder(h + delta, 1.0)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.to(torch.int64) % 6

    def select(*vals):
        out = vals[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out

    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                        select(p, p, t, v, v, q)], dim=-1)


def draw_train_params(batch: int, cfg, gen: torch.Generator,
                      device=None) -> Dict[str, torch.Tensor]:
    """The random parameters of one batch's train augmentation, [B]
    each, drawn from `gen` in the order of the JAX subkeys
    (`preprocess.py:553-556` there): crop scale, angle (radians), flip,
    the crop centre's y and x offsets, the brightness, contrast and
    saturation factors, and the hue shift."""
    d = cfg.data
    check_train_augmentation(d)
    device = device if device is not None else gen.device

    def uniform(lo, hi):
        u = torch.rand(batch, generator=gen, device=device)
        return lo + (hi - lo) * u

    max_rad = math.radians(d.rotation_degrees)
    out = {
        "crop_scale": uniform(d.crop_scale_min, 1.0),
        "angle": uniform(-max_rad, max_rad),
        "flip": (uniform(0.0, 1.0) < d.horizontal_flip_prob).float(),
        "shift_y": uniform(-1.0, 1.0),
        "shift_x": uniform(-1.0, 1.0),
    }
    for name, f in (("brightness", d.brightness_factor),
                    ("contrast", d.contrast_factor),
                    ("saturation", d.saturation_factor)):
        out[name] = 1.0 + uniform(-f, f)
    out["hue"] = uniform(-d.hue_factor, d.hue_factor)
    return out


def train_preprocess_apply(images_uint8: torch.Tensor,
                           params: Dict[str, torch.Tensor], cfg,
                           dtype: torch.dtype = torch.float32
                           ) -> torch.Tensor:
    """[B, S, S, 3] uint8 → [B, image_size, image_size, 3] normalized, at
    the given parameters (`draw_train_params`): flip, random resized crop
    (separable resample), rotation after the crop at image_size (the
    reference's order) with the input rounded to bf16 as in the JAX
    stack, colour and hue jitter."""
    d = cfg.data
    check_train_augmentation(d)
    in_size = float(images_uint8.shape[1])
    x = images_uint8.to(torch.float32)
    x = torch.where(params["flip"].reshape(-1, 1, 1, 1) > 0, x.flip(2), x)
    scale_y, shift_y = _crop_params(in_size, float(d.image_size),
                                    params["crop_scale"], params["shift_y"])
    scale_x, shift_x = _crop_params(in_size, float(d.image_size),
                                    params["crop_scale"], params["shift_x"])
    x = separable_resample(x, scale_y, shift_y, scale_x, shift_x,
                           d.image_size) / 255.0
    if d.rotation_degrees > 0 and d.online_rotation:
        from multimodal_rare_disease_tpu_torch.ops.rotate import rotate_batch

        x = rotate_batch(x.to(torch.bfloat16), params["angle"],
                         max_degrees=d.rotation_degrees).to(torch.float32)
    x = color_jitter(x, params["brightness"], params["contrast"],
                     params["saturation"])
    if d.hue_factor > 0:
        x = hue_rotate(x, params["hue"].reshape(-1, 1, 1))
    return _normalize01(x, dtype)


def train_preprocess(images_uint8: torch.Tensor, gen: torch.Generator, cfg,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The random train augmentation of one batch, drawn from `gen` (a
    generator on the images' device)."""
    params = draw_train_params(images_uint8.shape[0], cfg, gen,
                               images_uint8.device)
    return train_preprocess_apply(images_uint8, params, cfg, dtype)
