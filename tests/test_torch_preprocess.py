"""Eval preprocessing of the torch package (ops/preprocess.py) and K4,
its fused uint8 normalize (kernels/image.py), against the JAX package's
on the same uint8 images, on the CPU. The JAX side of K4 is its Pallas
kernel in interpret mode. The CUDA kernel itself is checked against the
plain version on the card by tests/test_torch_gpu.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_rare_disease_tpu.config import resolve_config
from multimodal_rare_disease_tpu.ops import preprocess as jpre
from multimodal_rare_disease_tpu.ops.pallas import image_kernels as jik
from multimodal_rare_disease_tpu_torch.kernels import image as k4
from multimodal_rare_disease_tpu_torch.ops import preprocess as tpre

# f32: the two resample matmuls sum ~256 terms in another order; values
# are O(1) after normalization
ATOL = 1e-5


def _u8(seed, b, s):
    return np.random.default_rng(seed).integers(0, 256, (b, s, s, 3),
                                                dtype=np.uint8)


@pytest.mark.parametrize("in_size,image_size,mode", [
    (256, 224, "resize_crop"), (256, 224, "resize"),
    (64, 32, "resize_crop"), (32, 48, "resize")])
def test_eval_preprocess_matches_jax(in_size, image_size, mode):
    cfg = resolve_config("default", {"data.image_size": image_size,
                                     "data.eval_transform": mode})
    imgs = _u8(in_size, 2, in_size)
    ref = np.asarray(jpre.eval_preprocess(jnp.asarray(imgs), cfg,
                                          use_pallas=False))
    got = tpre.eval_preprocess(torch.from_numpy(imgs), cfg).numpy()
    assert got.shape == (2, image_size, image_size, 3)
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_images_already_at_size_are_only_normalized_on_cpu():
    cfg = resolve_config("default", {"data.image_size": 32})
    imgs = _u8(1, 2, 32)
    ref = np.asarray(jpre.eval_preprocess(jnp.asarray(imgs), cfg,
                                          use_pallas=False))
    got = tpre.eval_preprocess(torch.from_numpy(imgs), cfg).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_axis_weights_and_resample_match_jax():
    rng = np.random.default_rng(2)
    scale = rng.uniform(0.5, 2.0, size=3).astype(np.float32)
    shift = rng.uniform(-2.0, 2.0, size=3).astype(np.float32)
    ref_w = np.asarray(jpre._axis_weights(jnp.asarray(scale),
                                          jnp.asarray(shift), 20, 40, 1.7))
    got_w = tpre._axis_weights(torch.from_numpy(scale),
                               torch.from_numpy(shift), 20, 40, 1.7).numpy()
    np.testing.assert_allclose(got_w, ref_w, atol=1e-6)  # one f32 divide
    imgs = _u8(3, 3, 40)
    args = [scale, shift, scale[::-1].copy(), shift[::-1].copy()]
    ref = np.asarray(jpre.separable_resample(
        jnp.asarray(imgs), *map(jnp.asarray, args), 20, filter_width=1.7))
    got = tpre.separable_resample(torch.from_numpy(imgs),
                                  *map(torch.from_numpy, args), 20,
                                  filter_width=1.7).numpy()
    # uint8-scale values (0..255): f32 relative roundoff of 40-term sums
    np.testing.assert_allclose(got, ref, atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_normalize_images_matches_jax(dtype):
    imgs = _u8(4, 2, 8)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = np.asarray(jpre.normalize_images(jnp.asarray(imgs), jdt),
                     np.float32)
    got = tpre.normalize_images(torch.from_numpy(imgs), dtype).float().numpy()
    # f32: one subtract and divide; bf16: the same f32 value rounded once
    np.testing.assert_allclose(got, ref, atol=ATOL if dtype == torch.float32
                               else 1.6e-2)


def _jax_k4(imgs, jdt):
    """The TPU kernel in interpret mode, called as
    tests/test_tpu_kernels.py calls it."""
    b, h, w, c = imgs.shape
    scale = (1.0 / (255.0 * jik.IMAGENET_STD)).astype(np.float32)
    bias = (-jik.IMAGENET_MEAN / jik.IMAGENET_STD).astype(np.float32)
    out = jik._fused_normalize_impl(
        jnp.asarray(imgs).reshape(b, h, w * c),
        jnp.asarray(np.tile(scale, w))[None, :],
        jnp.asarray(np.tile(bias, w))[None, :],
        dtype=jnp.dtype(jdt), interpret=True)
    return np.asarray(out, np.float32).reshape(imgs.shape)


# f32: the same multiply-add with scale and bias derived the same way,
# one rounding apart at most (the compiled-vs-interpret bound of
# tests/test_tpu_kernels.py); against the unfused (u/255 - mean)/std,
# a few f32 roundings (its bound, 1e-5). bf16: the same f32 value
# rounded once, so one bf16 ulp (1.6e-2 at |y| < 4) where an f32
# rounding apart flips it.
@pytest.mark.parametrize("shape", [(2, 8, 8, 3), (3, 37, 41, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_plain_matches_interpreted_kernel_and_normalize(shape, dtype):
    imgs = np.random.default_rng(sum(shape)).integers(
        0, 256, shape, dtype=np.uint8)
    f32 = dtype == torch.float32
    jdt = jnp.float32 if f32 else jnp.bfloat16
    got = k4.normalize_u8_plain(torch.from_numpy(imgs), dtype)
    assert got.dtype == dtype and got.shape == shape
    got = got.float().numpy()
    np.testing.assert_allclose(got, _jax_k4(imgs, jdt),
                               atol=1e-6 if f32 else 1.6e-2)
    ref = np.asarray(jpre.normalize_images(jnp.asarray(imgs), jdt),
                     np.float32)
    np.testing.assert_allclose(got, ref, atol=ATOL if f32 else 1.6e-2)


def test_k4_cpu_tensor_takes_the_plain_path_and_launches_nothing():
    imgs = torch.from_numpy(_u8(6, 2, 16))
    counts = (k4.LAUNCHES, k4.PLAIN_ON_CUDA)
    assert torch.equal(k4.fused_normalize_u8(imgs, torch.bfloat16),
                       k4.normalize_u8_plain(imgs, torch.bfloat16))
    assert (k4.LAUNCHES, k4.PLAIN_ON_CUDA) == counts


def test_k4_gate():
    u8, bf = torch.uint8, torch.bfloat16
    assert k4.normalize_u8_fusible((256, 256, 256, 3), u8, bf)
    assert k4.normalize_u8_fusible((3, 37, 41, 3), u8, torch.float32)
    assert not k4.normalize_u8_fusible((2, 8, 8, 4), u8, bf)   # 3 channels
    assert not k4.normalize_u8_fusible((2, 8, 8, 3), torch.float32, bf)
    assert not k4.normalize_u8_fusible((2, 8, 8, 3), u8, torch.float16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_at_size_eval_preprocess_matches_jax_pallas_path(dtype):
    # images staged at image_size: the JAX package's use_pallas=True path
    # (its Pallas kernel, interpreted on the CPU) against the port's K4
    cfg = resolve_config("default", {"data.image_size": 48})
    imgs = _u8(7, 2, 48)
    f32 = dtype == torch.float32
    jdt = jnp.float32 if f32 else jnp.bfloat16
    ref = np.asarray(jpre.eval_preprocess(jnp.asarray(imgs), cfg, dtype=jdt,
                                          use_pallas=True), np.float32)
    got = tpre.eval_preprocess(torch.from_numpy(imgs), cfg, dtype=dtype)
    assert got.shape == (2, 48, 48, 3) and got.dtype == dtype
    # the bounds of the K4 test above
    np.testing.assert_allclose(got.float().numpy(), ref,
                               atol=1e-6 if f32 else 1.6e-2)
