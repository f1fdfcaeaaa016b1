"""Eval preprocessing of the torch package (ops/preprocess.py) against
the JAX package's on the same uint8 images, in f32 on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_rare_disease_tpu.config import resolve_config
from multimodal_rare_disease_tpu.ops import preprocess as jpre
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
