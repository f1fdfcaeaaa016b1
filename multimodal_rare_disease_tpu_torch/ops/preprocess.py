"""Image preprocessing on the device: the counterpart of
`multimodal_rare_disease_tpu/ops/preprocess.py`.

Eval: uint8 images staged at 256 px → antialiased separable bilinear
resample composed with the center crop to `image_size` (two batched f32
matmuls, which the JAX package leaves to XLA and this port to PyTorch) →
ImageNet normalization. Images that already arrive at `image_size` are
only normalized, by K4 (`kernels/image.py`, a hand-written CUDA kernel
on the card), unless the caller turns it off as the trainer's
validation does.

Train (`train_preprocess`): with the default `geometry_mode='separable'`,
horizontal flip, random resized crop as the same separable resample and
Paeth rotation (`ops/rotate.py`) through bf16; with `'gather'`, crop,
rotation and flip composed into one affine map per image and sampled
bilinearly by index (`_compose_affine`, `affine_resample`). Then
brightness / contrast / saturation and hue jitter, and the default-off
extras in the JAX order: Gaussian blur, Gaussian noise, random erasing,
perspective, CLAHE (tiled when both sides divide by 8, else global),
elastic and coarse dropout; then normalization. Each random op is split
into a draw (`draw_train_params`, from an explicit `torch.Generator`, in
the JAX order of subkeys) and an apply at given parameters
(`train_preprocess_apply`): torch cannot reproduce a JAX key, so the
apply half is what is held against the JAX package.

Layout is NHWC throughout, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
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


# ---------------------------------------------------------------------------
# geometry by index: the `gather` mode, perspective and elastic warps
# ---------------------------------------------------------------------------

def _bilinear_sample(images: torch.Tensor, ys: torch.Tensor,
                     xs: torch.Tensor) -> torch.Tensor:
    """Sample images [B, H, W, C] at float coordinates ys / xs [B, h, w]
    with edge clamping: the JAX `_bilinear_sample`'s index math (floor,
    the fractions, the four neighbours clamped to the image), batched."""
    b, h, w, c = images.shape
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = (ys - y0)[..., None]
    wx = (xs - x0)[..., None]
    y0i = y0.to(torch.int64).clamp(0, h - 1)
    y1i = (y0i + 1).clamp(0, h - 1)
    x0i = x0.to(torch.int64).clamp(0, w - 1)
    x1i = (x0i + 1).clamp(0, w - 1)
    flat = images.reshape(b * h * w, c)
    base = (torch.arange(b, device=images.device) * (h * w)).view(b, 1, 1)

    def at(yi, xi):
        return flat[(base + yi * w + xi).reshape(-1)].reshape(
            *yi.shape, c)

    top = at(y0i, x0i) * (1 - wx) + at(y0i, x1i) * wx
    bot = at(y1i, x0i) * (1 - wx) + at(y1i, x1i) * wx
    return top * (1 - wy) + bot * wy


def _out_grid(out_size: int, device):
    ii = torch.arange(out_size, dtype=torch.float32, device=device)
    return torch.meshgrid(ii, ii, indexing="ij")


def affine_resample(images: torch.Tensor, matrices: torch.Tensor,
                    out_size: int) -> torch.Tensor:
    """Affine warp [B, H, W, C] × [B, 2, 3] → [B, out, out, C] f32; the
    matrices map OUTPUT pixel coordinates (y, x) to INPUT ones."""
    gy, gx = _out_grid(out_size, images.device)
    m = matrices[:, :, :, None, None]
    ys = m[:, 0, 0] * gy + m[:, 0, 1] * gx + m[:, 0, 2]
    xs = m[:, 1, 0] * gy + m[:, 1, 1] * gx + m[:, 1, 2]
    return _bilinear_sample(images.to(torch.float32), ys, xs)


def _compose_affine(in_size: float, out_size: float,
                    crop_scale: torch.Tensor, angle_rad: torch.Tensor,
                    flip: torch.Tensor, shift_y: torch.Tensor,
                    shift_x: torch.Tensor) -> torch.Tensor:
    """The [B, 2, 3] output→input maps: rotate about the crop centre,
    scale crop → out, translate to the crop window, optional horizontal
    flip (the JAX `_compose_affine`, over a batch of [B] parameters)."""
    crop_size = in_size * torch.sqrt(crop_scale)
    scale = crop_size / out_size
    cos = torch.cos(angle_rad) * scale
    sin = torch.sin(angle_rad) * scale
    fx = torch.where(flip > 0, -1.0, 1.0)
    oc = (out_size - 1) / 2.0
    slack = (in_size - crop_size) / 2.0
    cy = (in_size - 1) / 2.0 + shift_y * slack
    cx = (in_size - 1) / 2.0 + shift_x * slack
    a00, a01, a10, a11 = cos, -sin * fx, sin, cos * fx
    t0 = cy - a00 * oc - a01 * oc
    t1 = cx - a10 * oc - a11 * oc
    return torch.stack([torch.stack([a00, a01, t0], -1),
                        torch.stack([a10, a11, t1], -1)], 1)


def perspective_resample(images: torch.Tensor, homographies: torch.Tensor,
                         out_size: int) -> torch.Tensor:
    """Projective warp [B, H, W, C] × [B, 3, 3] → [B, out, out, C] f32;
    the homographies map OUTPUT (y, x, 1) to INPUT homogeneous
    coordinates."""
    gy, gx = _out_grid(out_size, images.device)
    m = homographies[:, :, :, None, None]
    d = m[:, 2, 0] * gy + m[:, 2, 1] * gx + m[:, 2, 2]
    d = torch.where(d.abs() < 1e-8, 1e-8, d)
    ys = (m[:, 0, 0] * gy + m[:, 0, 1] * gx + m[:, 0, 2]) / d
    xs = (m[:, 1, 0] * gy + m[:, 1, 1] * gx + m[:, 1, 2]) / d
    return _bilinear_sample(images.to(torch.float32), ys, xs)


def _solve_homography(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """DLT: four point pairs (y, x) [B, 4, 2] src → dst → [B, 3, 3] H with
    H · (src_y, src_x, 1) ∝ (dst_y, dst_x, 1); the 8 × 8 system solved in
    f32."""
    rows = []
    for i in range(4):
        sy, sx = src[:, i, 0], src[:, i, 1]
        dy, dx = dst[:, i, 0], dst[:, i, 1]
        one, zero = torch.ones_like(sy), torch.zeros_like(sy)
        rows.append(torch.stack([sy, sx, one, zero, zero, zero,
                                 -dy * sy, -dy * sx], -1))
        rows.append(torch.stack([zero, zero, zero, sy, sx, one,
                                 -dx * sy, -dx * sx], -1))
    a = torch.stack(rows, 1)                                  # [B, 8, 8]
    rhs = dst.reshape(dst.shape[0], 8, 1)
    h = torch.linalg.solve(a, rhs)[..., 0]                    # [B, 8]
    return torch.cat([h, torch.ones_like(h[:, :1])], -1).reshape(-1, 3, 3)


def random_perspective(images: torch.Tensor, displacement: torch.Tensor,
                       apply: torch.Tensor) -> torch.Tensor:
    """torchvision RandomPerspective at drawn parameters: each corner is
    moved inward by `displacement` [B, 4, 2] (U(0, distortion_scale),
    in units of half the side); the image is warped so that the whole
    frame maps onto the moved quad, where `apply` [B] is set."""
    b, h, w, _ = images.shape
    dev = images.device
    corners = torch.tensor([[0.0, 0.0], [0.0, w - 1.0], [h - 1.0, 0.0],
                            [h - 1.0, w - 1.0]], device=dev)
    sign = torch.tensor([[1.0, 1.0], [1.0, -1.0], [-1.0, 1.0],
                         [-1.0, -1.0]], device=dev)
    half = torch.tensor([(h - 1) / 2.0, (w - 1) / 2.0], device=dev)
    endpoints = corners[None] + sign[None] * displacement * half[None, None]
    hm = _solve_homography(corners[None].expand_as(endpoints), endpoints)
    warped = perspective_resample(images, hm, h)
    return torch.where(apply.view(-1, 1, 1, 1), warped,
                       images.to(torch.float32))


def elastic_transform(images: torch.Tensor, displacement: torch.Tensor,
                      apply: torch.Tensor, alpha: float = 30.0,
                      sigma: float = 6.0) -> torch.Tensor:
    """albumentations ElasticTransform at a drawn field: `displacement`
    [B, H, W, 2] ~ U(-1, 1), blurred at `sigma` (2·ceil(2σ) + 1 taps)
    and scaled by `alpha`, bends the sampling grid where `apply` [B]."""
    _, h, w, _ = images.shape
    disp = gaussian_blur(displacement, sigma=sigma,
                         kernel_size=int(2 * math.ceil(2 * sigma) + 1)) \
        * alpha
    ii = torch.arange(h, dtype=torch.float32, device=images.device)
    jj = torch.arange(w, dtype=torch.float32, device=images.device)
    gy, gx = torch.meshgrid(ii, jj, indexing="ij")
    warped = _bilinear_sample(images.to(torch.float32),
                              gy + disp[..., 0], gx + disp[..., 1])
    return torch.where(apply.view(-1, 1, 1, 1), warped,
                       images.to(torch.float32))


# ---------------------------------------------------------------------------
# filters, noise and masks
# ---------------------------------------------------------------------------

def _conv1d(images: torch.Tensor, k: torch.Tensor, dim: int) -> torch.Tensor:
    """Same-size 1-D convolution of [B, H, W, C] along H (dim 1) or W
    (dim 2), edge-padded: a sum of clamped shifts, in the JAX order."""
    n = images.shape[dim]
    half = (k.shape[0] - 1) // 2
    out = torch.zeros_like(images)
    for i in range(k.shape[0]):
        idx = (torch.arange(n, device=images.device) + (i - half)).clamp(
            0, n - 1)
        out = out + k[i] * images.index_select(dim, idx)
    return out


def gaussian_blur(images: torch.Tensor, sigma: float = 1.0,
                  kernel_size: int = 5) -> torch.Tensor:
    """Separable Gaussian blur of [B, H, W, C]: along W, then along H,
    each edge-padded."""
    half = kernel_size // 2
    xs = np.arange(-half, half + 1, dtype=np.float32)
    k = np.exp(-(xs ** 2) / (2 * sigma ** 2))
    k = torch.from_numpy(k / k.sum()).to(images.device, images.dtype)
    return _conv1d(_conv1d(images, k, 2), k, 1)


def gaussian_noise(images: torch.Tensor, noise: torch.Tensor,
                   std: float) -> torch.Tensor:
    """Additive Gaussian noise: `noise` ~ N(0, 1) of the images' shape,
    scaled by `std`, the sum clipped to [0, 1]."""
    return (images + std * noise).clamp(0.0, 1.0)


def _boxes(h: int, w: int, frac, uy, ux, device):
    """(y inside, x inside) masks of boxes of `frac` of the area, placed
    at uy / ux ∈ [0, 1) of the slack: [..., H, 1] and [..., 1, W]."""
    side_h = torch.sqrt(frac) * h
    side_w = torch.sqrt(frac) * w
    y0 = uy * (h - side_h)
    x0 = ux * (w - side_w)
    yy = torch.arange(h, dtype=torch.float32, device=device)
    xx = torch.arange(w, dtype=torch.float32, device=device)
    iy = (yy >= y0[..., None]) & (yy < (y0 + side_h)[..., None])
    ix = (xx >= x0[..., None]) & (xx < (x0 + side_w)[..., None])
    return iy[..., :, None], ix[..., None, :]


def random_erasing(images: torch.Tensor, apply: torch.Tensor,
                   frac: torch.Tensor, uy: torch.Tensor, ux: torch.Tensor
                   ) -> torch.Tensor:
    """torchvision RandomErasing at drawn parameters: where `apply` [B],
    a rectangle of `frac` [B] of the area at uy, ux [B] ∈ [0, 1) of the
    slack is zeroed."""
    _, h, w, _ = images.shape
    iy, ix = _boxes(h, w, frac, uy, ux, images.device)      # [B, H|1, 1|W]
    erase = apply.view(-1, 1, 1) & iy & ix
    return torch.where(erase[..., None], 0.0, images)


def coarse_dropout(images: torch.Tensor, apply: torch.Tensor,
                   n_active: torch.Tensor, frac: torch.Tensor,
                   uy: torch.Tensor, ux: torch.Tensor) -> torch.Tensor:
    """albumentations CoarseDropout at drawn parameters: where `apply`
    [B], the first `n_active` [B] of the holes (frac, uy, ux [B, holes],
    as random_erasing's) are zeroed."""
    _, h, w, _ = images.shape
    iy, ix = _boxes(h, w, frac, uy, ux, images.device)  # [B, n, H|1, 1|W]
    active = (torch.arange(frac.shape[1], device=images.device)[None]
              < n_active[:, None])
    hole = (iy & ix & active[:, :, None, None]).any(dim=1)
    erase = apply.view(-1, 1, 1) & hole
    return torch.where(erase[..., None], 0.0, images)


# ---------------------------------------------------------------------------
# CLAHE
# ---------------------------------------------------------------------------

def _clahe_interp_weights(size: int, grid: int) -> np.ndarray:
    """[size, grid] bilinear weights of each tile's CDF for each pixel
    coordinate (≤ 2 nonzeros per row; border pixels clamp to the edge
    tile)."""
    tile = size / grid
    pos = (np.arange(size) + 0.5) / tile - 0.5
    pos = np.clip(pos, 0.0, grid - 1.0)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, grid - 1)
    w_hi = pos - lo
    weights = np.zeros((size, grid), np.float32)
    weights[np.arange(size), lo] += 1.0 - w_hi
    weights[np.arange(size), hi] += w_hi
    return weights


def _luminance_bins(x: torch.Tensor, num_bins: int):
    """(luminance [B, H, W], its bin index int(lum · bins) clamped)."""
    lum = 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
    idx = (lum * num_bins).to(torch.int64).clamp(0, num_bins - 1)
    return lum, idx


def _clip_and_cdf(hist: torch.Tensor, clip_limit: float, n: int,
                  num_bins: int) -> torch.Tensor:
    """Contrast-limited histogram (excess spread over every bin) → CDF."""
    limit = clip_limit * n / num_bins
    clipped = torch.minimum(hist, torch.tensor(limit, device=hist.device))
    excess = (hist - clipped).sum(-1, keepdim=True) / num_bins
    return torch.cumsum(clipped + excess, -1) / n


def _rescale_by_luminance(x, lum, mapped):
    ratio = mapped / lum.clamp_min(1e-6)
    return (x * ratio[..., None]).clamp(0.0, 1.0)


def clahe_batch_tiled(images: torch.Tensor, clip_limit: float = 4.0,
                      num_bins: int = 64, grid: int = 8) -> torch.Tensor:
    """CLAHE: 8 × 8-tiled contrast-limited histogram equalization of the
    luminance of [B, H, W, 3] in [0, 1], each pixel's mapping a bilinear
    blend of the four surrounding tiles' CDFs (H and W divisible by
    `grid`). The JAX function's one-hot sums, taken by index: the tile
    histograms by counting (exact), and each pixel's blend at its own
    bin (the one-hot product keeps that term alone)."""
    x = images.to(torch.float32)
    lum, idx = _luminance_bins(x, num_bins)
    b, h, w = lum.shape
    g = grid
    th, tw = h // g, w // g
    dev = x.device
    tile = ((torch.arange(h, device=dev) // th)[:, None] * g
            + (torch.arange(w, device=dev) // tw)[None, :])    # [H, W]
    flat = ((torch.arange(b, device=dev)[:, None, None] * (g * g) + tile)
            * num_bins + idx).reshape(-1)
    hist = torch.bincount(flat, minlength=b * g * g * num_bins).to(
        torch.float32).reshape(b, g, g, num_bins)
    cdf = _clip_and_cdf(hist, clip_limit, th * tw, num_bins)   # [B,G,G,K]
    wy = torch.from_numpy(_clahe_interp_weights(h, g)).to(dev)  # [H, G]
    wx = torch.from_numpy(_clahe_interp_weights(w, g)).to(dev)  # [W, G]
    cdf_y = torch.einsum("yr,brck->byck", wy, cdf)             # [B,H,G,K]
    # cdf_y at each pixel's bin, for every tile column: [B, H, W, G]
    at_bin = torch.gather(
        cdf_y.permute(0, 1, 3, 2), 2,
        idx[..., None].expand(b, h, w, g))
    mapped = (at_bin * wx[None, None]).sum(-1)                 # [B, H, W]
    return _rescale_by_luminance(x, lum, mapped)


def clahe_batch(images: torch.Tensor, clip_limit: float = 4.0,
                num_bins: int = 64) -> torch.Tensor:
    """Contrast-limited GLOBAL histogram equalization of the luminance of
    [B, H, W, 3] in [0, 1]: one CDF per image (the fallback for sizes
    the tile grid does not divide)."""
    x = images.to(torch.float32)
    lum, idx = _luminance_bins(x, num_bins)
    b, h, w = lum.shape
    flat = (torch.arange(b, device=x.device)[:, None, None] * num_bins
            + idx).reshape(-1)
    hist = torch.bincount(flat, minlength=b * num_bins).to(
        torch.float32).reshape(b, num_bins)
    cdf = _clip_and_cdf(hist, clip_limit, h * w, num_bins)     # [B, K]
    mapped = torch.gather(cdf, 1, idx.reshape(b, -1)).reshape(b, h, w)
    return _rescale_by_luminance(x, lum, mapped)


def clahe(images: torch.Tensor) -> torch.Tensor:
    """Tiled CLAHE where both sides divide by the 8 × 8 grid, else the
    global equalization (the JAX train stack's choice)."""
    if images.shape[1] % 8 == 0 and images.shape[2] % 8 == 0:
        return clahe_batch_tiled(images)
    return clahe_batch(images)


# ---------------------------------------------------------------------------
# the train stack: draws, then the apply at the drawn parameters
# ---------------------------------------------------------------------------

ERASING_AREA = (0.02, 0.2)
DROPOUT_HOLE_AREA = (0.02, 0.035)


def draw_train_params(batch: int, cfg, gen: torch.Generator,
                      device=None) -> Dict[str, torch.Tensor]:
    """The random parameters of one batch's train augmentation, drawn
    from `gen` in the order of the JAX subkeys (`preprocess.py:554-556`
    there): crop scale, angle (radians), flip, the crop centre's y and x
    offsets, the brightness, contrast and saturation factors, the hue
    shift [B] each; then, only for the extras the config turns on, the
    blur selection, the noise [B, S, S, 3] (S = image_size), the
    erasing's (apply, area, y, x), the perspective's corner shifts
    [B, 4, 2] and apply, the CLAHE selection, the elastic field
    [B, S, S, 2] and apply, and coarse dropout's (apply, holes,
    areas / y / x [B, holes])."""
    d = cfg.data
    device = device if device is not None else gen.device

    def uniform(lo, hi, shape=(batch,)):
        u = torch.rand(shape, generator=gen, device=device)
        return lo + (hi - lo) * u

    def chance(p):
        return uniform(0.0, 1.0) < p

    max_rad = math.radians(d.rotation_degrees)
    out = {
        "crop_scale": uniform(d.crop_scale_min, 1.0),
        "angle": uniform(-max_rad, max_rad),
        "flip": chance(d.horizontal_flip_prob).float(),
        "shift_y": uniform(-1.0, 1.0),
        "shift_x": uniform(-1.0, 1.0),
    }
    for name, f in (("brightness", d.brightness_factor),
                    ("contrast", d.contrast_factor),
                    ("saturation", d.saturation_factor)):
        out[name] = 1.0 + uniform(-f, f)
    out["hue"] = uniform(-d.hue_factor, d.hue_factor)
    s = d.image_size
    if d.gaussian_blur_prob > 0:
        out["blur"] = chance(d.gaussian_blur_prob)
    if d.gaussian_noise_std > 0:
        out["noise"] = torch.randn((batch, s, s, 3), generator=gen,
                                   device=device)
    if d.random_erasing_prob > 0:
        out["erase"] = chance(d.random_erasing_prob)
        out["erase_area"] = uniform(*ERASING_AREA)
        out["erase_y"] = uniform(0.0, 1.0)
        out["erase_x"] = uniform(0.0, 1.0)
    if d.perspective_prob > 0:
        out["perspective_shift"] = uniform(
            0.0, 1.0, (batch, 4, 2)) * d.perspective_distortion
        out["perspective"] = chance(d.perspective_prob)
    if d.clahe_prob > 0:
        out["clahe"] = chance(d.clahe_prob)
    if d.elastic_prob > 0:
        out["elastic_field"] = uniform(-1.0, 1.0, (batch, s, s, 2))
        out["elastic"] = chance(d.elastic_prob)
    if d.coarse_dropout_prob > 0:
        n = d.coarse_dropout_holes
        out["dropout"] = chance(d.coarse_dropout_prob)
        out["dropout_holes"] = torch.randint(1, n + 1, (batch,),
                                             generator=gen, device=device)
        out["dropout_area"] = uniform(*DROPOUT_HOLE_AREA, (batch, n))
        out["dropout_y"] = uniform(0.0, 1.0, (batch, n))
        out["dropout_x"] = uniform(0.0, 1.0, (batch, n))
    return out


def _select(sel: torch.Tensor, a: torch.Tensor, b: torch.Tensor
            ) -> torch.Tensor:
    return torch.where(sel.view(-1, 1, 1, 1), a, b)


def train_preprocess_apply(images_uint8: torch.Tensor,
                           params: Dict[str, torch.Tensor], cfg,
                           dtype: torch.dtype = torch.float32
                           ) -> torch.Tensor:
    """[B, S, S, 3] uint8 → [B, image_size, image_size, 3] normalized, at
    the given parameters (`draw_train_params`), in the JAX order:
    geometry (flip, random resized crop as the separable resample, then
    the rotation at image_size through bf16; or all three as one affine
    gather), colour and hue jitter, blur, noise, erasing, perspective,
    CLAHE, elastic, coarse dropout."""
    d = cfg.data
    in_size = float(images_uint8.shape[1])
    if d.geometry_mode == "gather":
        mats = _compose_affine(in_size, float(d.image_size),
                               params["crop_scale"], params["angle"],
                               params["flip"], params["shift_y"],
                               params["shift_x"])
        x = affine_resample(images_uint8, mats, d.image_size) / 255.0
    else:
        x = images_uint8.to(torch.float32)
        x = torch.where(params["flip"].reshape(-1, 1, 1, 1) > 0, x.flip(2),
                        x)
        scale_y, shift_y = _crop_params(in_size, float(d.image_size),
                                        params["crop_scale"],
                                        params["shift_y"])
        scale_x, shift_x = _crop_params(in_size, float(d.image_size),
                                        params["crop_scale"],
                                        params["shift_x"])
        x = separable_resample(x, scale_y, shift_y, scale_x, shift_x,
                               d.image_size) / 255.0
        if d.rotation_degrees > 0 and d.online_rotation:
            from multimodal_rare_disease_tpu_torch.ops.rotate import (
                rotate_batch,
            )

            x = rotate_batch(x.to(torch.bfloat16), params["angle"],
                             max_degrees=d.rotation_degrees).to(
                                 torch.float32)
    x = color_jitter(x, params["brightness"], params["contrast"],
                     params["saturation"])
    if d.hue_factor > 0:
        x = hue_rotate(x, params["hue"].reshape(-1, 1, 1))
    if d.gaussian_blur_prob > 0:
        x = _select(params["blur"], gaussian_blur(x), x)
    if d.gaussian_noise_std > 0:
        x = gaussian_noise(x, params["noise"], d.gaussian_noise_std)
    if d.random_erasing_prob > 0:
        x = random_erasing(x, params["erase"], params["erase_area"],
                           params["erase_y"], params["erase_x"])
    if d.perspective_prob > 0:
        x = random_perspective(x, params["perspective_shift"],
                               params["perspective"])
    if d.clahe_prob > 0:
        x = _select(params["clahe"], clahe(x), x)
    if d.elastic_prob > 0:
        x = elastic_transform(x, params["elastic_field"], params["elastic"])
    if d.coarse_dropout_prob > 0:
        x = coarse_dropout(x, params["dropout"], params["dropout_holes"],
                           params["dropout_area"], params["dropout_y"],
                           params["dropout_x"])
    return _normalize01(x, dtype)


def train_preprocess(images_uint8: torch.Tensor, gen: torch.Generator, cfg,
                     dtype: torch.dtype = torch.float32,
                     rows: slice = slice(None)) -> torch.Tensor:
    """The random train augmentation of one batch, drawn from `gen` (a
    generator on the images' device). With `rows`, the whole batch's
    draws are applied to those rows alone (a rank's share of a batch
    split over a mesh draws what one device draws)."""
    params = draw_train_params(images_uint8.shape[0], cfg, gen,
                               images_uint8.device)
    return train_preprocess_apply(
        images_uint8[rows], {k: v[rows] for k, v in params.items()}, cfg,
        dtype)


def augment_batch(images_uint8: torch.Tensor, gen: torch.Generator, cfg,
                  train: bool, dtype: torch.dtype = torch.float32
                  ) -> torch.Tensor:
    """The train augmentation drawn from `gen`, or the eval preprocess."""
    if train:
        return train_preprocess(images_uint8, gen, cfg, dtype)
    return eval_preprocess(images_uint8, cfg, dtype)
