"""K4: the fused uint8 ImageNet normalize, by hand for Hopper.

    y = u * scale[c] + bias[c],  scale = 1 / (255 std),  bias = -mean / std

uint8 [B, H, W, 3] → f32 or bf16 [B, H, W, 3]. Counterpart of
`multimodal_rare_disease_tpu/ops/pallas/image_kernels.py`. The CUDA
kernel (`csrc/normalize_u8.cu`) replaces its `_normalize_kernel`, in the
same multiply-add form with scale and bias derived in f32 as there;
`normalize_u8_plain` is the same math in PyTorch (the product and the
sum each rounded to f32, as the kernel computes them).

Device rule, as `kernels/ffn.py`: CPU tensors take the plain version;
CUDA tensors launch the kernel or raise, except where the stated gate
`normalize_u8_fusible` sends them to the plain version, which counts in
`PLAIN_ON_CUDA`. `FORCE_PLAIN` is set only by tests and chip_smoke.py.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from multimodal_rare_disease_tpu_torch.kernels import build
from multimodal_rare_disease_tpu_torch.ops.preprocess import (
    IMAGENET_MEAN,
    IMAGENET_STD,
)

FORCE_PLAIN = False
# launches of the CUDA kernel (incremented only where it is launched)
LAUNCHES = 0
# CUDA calls that the shape/dtype gate sent to the plain version
PLAIN_ON_CUDA = 0

_OUT_DTYPES = (torch.float32, torch.bfloat16)


def normalize_affine() -> Tuple[np.ndarray, np.ndarray]:
    """(scale, bias) per channel in f32, derived as the TPU wrapper does."""
    mean = np.asarray(IMAGENET_MEAN, np.float32)
    std = np.asarray(IMAGENET_STD, np.float32)
    scale = (1.0 / (255.0 * std)).astype(np.float32)
    bias = (-mean / std).astype(np.float32)
    return scale, bias


def normalize_u8_fusible(shape, in_dtype: torch.dtype,
                         out_dtype: torch.dtype) -> bool:
    """Gate of the CUDA kernel: NHWC uint8 with 3 channels in, f32 or
    bf16 out; any size (the kernel handles a tail that is not a multiple
    of its 16-byte vectors)."""
    return (len(shape) == 4 and shape[-1] == 3 and in_dtype == torch.uint8
            and out_dtype in _OUT_DTYPES)


def normalize_u8_plain(images_uint8: torch.Tensor,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The kernel's math in PyTorch: [B, H, W, 3] uint8 → dtype."""
    scale, bias = (torch.from_numpy(a).to(images_uint8.device)
                   for a in normalize_affine())
    return (images_uint8.to(torch.float32) * scale + bias).to(dtype)


def fused_normalize_u8(images_uint8: torch.Tensor,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 [B, H, W, 3] → ImageNet-normalized dtype [B, H, W, 3]."""
    global PLAIN_ON_CUDA
    if images_uint8.device.type == "cpu" or FORCE_PLAIN:
        return normalize_u8_plain(images_uint8, dtype)
    if images_uint8.device.type != "cuda":
        raise RuntimeError(
            f"fused_normalize_u8: unsupported device {images_uint8.device}")
    if not normalize_u8_fusible(images_uint8.shape, images_uint8.dtype,
                                dtype):
        PLAIN_ON_CUDA += 1
        return normalize_u8_plain(images_uint8, dtype)
    return _launch(images_uint8, dtype)


def _launch(images: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    global LAUNCHES
    dev = images.device
    x = images.contiguous()
    if x.data_ptr() % 16:  # a view at an odd offset: copy to a fresh buffer
        x = x.clone()
    y = torch.empty(x.shape, dtype=dtype, device=dev)
    scale, bias = ((ctypes.c_float * 3)(*a.tolist())
                   for a in normalize_affine())
    lib = build.load_library(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mrd_normalize_u8(x.data_ptr(), y.data_ptr(), x.numel(),
                                   scale, bias, int(dtype == torch.bfloat16),
                                   sms, stream)
    build.check_launch(lib, err, "normalize_u8")
    LAUNCHES += 1
    return y
