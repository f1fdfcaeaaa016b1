"""Batched image rotation by the Paeth three-shear decomposition: the
counterpart of `multimodal_rare_disease_tpu/ops/rotate.py`, the same
math.

R(θ) = Sx(-tan θ/2) ∘ Sy(sin θ) ∘ Sx(-tan θ/2), each shear evaluated as
a sum over static shifts of one zero-padded buffer, weighted by per-row
(or per-column) tent weights:

    out[h, j] = Σ_k  tent(δ(h) - k) · in[h, j - k]

The k-range is bounded by the largest rotation angle. Corners fill with
zeros (torchvision RandomRotation). The values differ from a bilinear
warp's (each shear interpolates along one axis), so `F.grid_sample` is
not a substitute.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _shear(x: torch.Tensor, factor: torch.Tensor, axis: str,
           max_abs_factor: float) -> torch.Tensor:
    """Along x, out[h,j] = in[h, j - factor*(h-c)]; along y,
    out[h,j] = in[h - factor*(j-c), j]. x is [B, H, W, C]; `factor` [B].
    The weights are f32, so a bf16 `x` gives an f32 result, as the JAX
    module's type promotion does."""
    b, h, w, c = x.shape
    n = h if axis == "x" else w
    coord = torch.arange(n, dtype=torch.float32, device=x.device) \
        - (n - 1) / 2.0
    delta = factor[:, None].float() * coord[None, :]      # [B, H or W]
    k_max = int(math.ceil(max_abs_factor * (n - 1) / 2.0)) + 1
    if axis == "x":
        padded = F.pad(x, (0, 0, k_max, k_max))           # pad W
    else:
        padded = F.pad(x, (0, 0, 0, 0, k_max, k_max))     # pad H
    acc = torch.zeros_like(x)
    for k in range(-k_max, k_max + 1):
        wk = (1.0 - (delta - k).abs()).clamp(0.0, 1.0)    # [B, H|W]
        if axis == "x":
            shifted = padded[:, :, k_max - k:k_max - k + w]
            acc = acc + wk[:, :, None, None] * shifted
        else:
            shifted = padded[:, k_max - k:k_max - k + h]
            acc = acc + wk[:, None, :, None] * shifted
    return acc


def rotate_batch(images: torch.Tensor, angles: torch.Tensor,
                 max_degrees: float = 15.0) -> torch.Tensor:
    """Rotate [B, H, W, C] images by per-image `angles` (radians),
    |angle| <= max_degrees, about the center, zero-filled corners."""
    max_rad = math.radians(max_degrees)
    a = -torch.tan(angles / 2.0)
    b = torch.sin(angles)
    max_a = abs(math.tan(max_rad / 2.0))
    max_b = abs(math.sin(max_rad))
    x = _shear(images, a, "x", max_a)
    x = _shear(x, b, "y", max_b)
    return _shear(x, a, "x", max_a)
