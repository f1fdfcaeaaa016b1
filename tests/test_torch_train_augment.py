"""The train augmentation of the torch package (ops/preprocess.py,
ops/rotate.py) against the JAX package's at given parameters, in f32 on
the CPU: the Paeth rotation, the flip and the separable random resized
crop, colour jitter and hue rotation, and the whole `train_preprocess`
fed the parameters re-derived from the JAX key with `jax.random`; plus
the port's own draws (the default-off extras are in
test_torch_augment_extras.py)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_rare_disease_tpu.config import resolve_config as jax_config
from multimodal_rare_disease_tpu.ops import preprocess as jpre
from multimodal_rare_disease_tpu.ops.rotate import rotate_batch as jrotate
from multimodal_rare_disease_tpu_torch.config import resolve_config
from multimodal_rare_disease_tpu_torch.ops import preprocess as tpre
from multimodal_rare_disease_tpu_torch.ops.rotate import rotate_batch

# f32, the same arithmetic in another order (the resample is a sum over
# the input rows, values in [0, 255] / 255)
ATOL = 1e-5
# normalized outputs after the rotation's bf16 rounding: one bf16 ulp of
# a value in [0.5, 1) is 2^-8, and an input that lands on the other side
# of a rounding boundary moves the output by up to that, / the smallest
# ImageNet std 0.224; such flips are rare, so the mean is held tightly
BF16_ATOL = 2 ** -8 / 0.224
BF16_MEAN_ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _images(seed, b=3, s=48):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rotate_batch_matches_jax_at_given_angles(dtype):
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (4, 40, 36, 3)).astype(np.float32)
    angles = np.radians([-15.0, -4.0, 0.0, 13.5]).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(jrotate(jx, jnp.asarray(angles), max_degrees=15.0)
                      .astype(jnp.float32))
    got = rotate_batch(_t(x).to(getattr(torch, dtype)), _t(angles),
                       max_degrees=15.0)
    # bf16 in: both promote to f32 at the first weighted sum
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    # zero angle is the identity; corners fill with zeros
    np.testing.assert_allclose(got[2].numpy(), np.asarray(jx[2], np.float32),
                               atol=ATOL)
    assert float(got[0, 0, 0].abs().max()) == 0.0


def test_flip_and_crop_match_jax_at_given_parameters():
    u8 = _images(2, b=4, s=64)
    rng = np.random.default_rng(3)
    crop = rng.uniform(0.8, 1.0, 4).astype(np.float32)
    sy, sx = (rng.uniform(-1, 1, 4).astype(np.float32) for _ in range(2))
    flip = np.array([1, 0, 1, 0], np.float32)
    out = 40
    jy = jpre._crop_params(64.0, float(out), jnp.asarray(crop),
                           jnp.asarray(sy))
    jx_ = jpre._crop_params(64.0, float(out), jnp.asarray(crop),
                            jnp.asarray(sx))
    ty = tpre._crop_params(64.0, float(out), _t(crop), _t(sy))
    tx = tpre._crop_params(64.0, float(out), _t(crop), _t(sx))
    for a, b in zip(ty + tx, jy + jx_):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    x = jnp.asarray(u8).astype(jnp.float32)
    x = jnp.where(jnp.asarray(flip)[:, None, None, None] > 0,
                  x[:, :, ::-1, :], x)
    want = jpre.separable_resample(x, *jy, *jx_, out)
    t = _t(u8).float()
    t = torch.where(_t(flip)[:, None, None, None] > 0, t.flip(2), t)
    got = tpre.separable_resample(t, *ty, *tx, out)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)
    np.testing.assert_allclose(got.numpy() / 255.0, np.asarray(want) / 255.0,
                               atol=ATOL)


def test_color_jitter_and_hue_rotate_match_jax_at_given_factors():
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, (3, 20, 24, 3)).astype(np.float32)
    x[0, :4, :4] = 0.5                       # gray pixels: zero saturation
    x[1, :2, :2] = 0.0                       # black: zero value
    bf, cf, sf = (rng.uniform(0.8, 1.2, 3).astype(np.float32)
                  for _ in range(3))
    key = jax.random.key(0)
    kb, kc, ks = jax.random.split(key, 3)

    # the JAX color_jitter at these factors: its draws replaced by them
    def jitter(x):
        x = x * jnp.asarray(bf)[:, None, None, None]
        mean = jnp.mean(x, axis=(1, 2, 3), keepdims=True)
        x = (x - mean) * jnp.asarray(cf)[:, None, None, None] + mean
        gray = jnp.mean(x, axis=-1, keepdims=True)
        return jnp.clip((x - gray) * jnp.asarray(sf)[:, None, None, None]
                        + gray, 0.0, 1.0)

    # the jitter's draws, as jpre.color_jitter makes them, reproduce it
    b = 0.2
    draws = [1.0 + jax.random.uniform(k, (3, 1, 1, 1), minval=-b, maxval=b)
             for k in (kb, kc, ks)]
    bf2, cf2, sf2 = (np.asarray(d).reshape(3) for d in draws)
    np.testing.assert_allclose(
        np.asarray(jpre.color_jitter(jnp.asarray(x), key, b, b, b)),
        tpre.color_jitter(_t(x), _t(bf2), _t(cf2), _t(sf2)).numpy(),
        atol=ATOL)
    np.testing.assert_allclose(
        tpre.color_jitter(_t(x), _t(bf), _t(cf), _t(sf)).numpy(),
        np.asarray(jitter(jnp.asarray(x))), atol=ATOL)
    for delta in (np.array([0.1, -0.1, 0.5]), np.array([0.0, 0.93, -0.37])):
        d = delta.astype(np.float32)[:, None, None]
        np.testing.assert_allclose(
            tpre.hue_rotate(_t(x), _t(d)).numpy(),
            np.asarray(jpre.hue_rotate(jnp.asarray(x), jnp.asarray(d))),
            atol=ATOL)


def _jax_params(key, b, cfg):
    """The parameters the JAX train_preprocess draws from `key`,
    re-derived with jax.random in its order of subkeys."""
    d = cfg.data
    (k_scale, k_angle, k_flip, k_sy, k_sx, k_jit, k_hue,
     *_rest) = jax.random.split(key, 14)
    max_rad = np.deg2rad(d.rotation_degrees)
    kb, kc, ks = jax.random.split(k_jit, 3)

    def jit_factor(k, f):
        return 1.0 + jax.random.uniform(k, (b, 1, 1, 1), minval=-f,
                                        maxval=f)

    p = {
        "crop_scale": jax.random.uniform(k_scale, (b,),
                                         minval=d.crop_scale_min,
                                         maxval=1.0),
        "angle": jax.random.uniform(k_angle, (b,), minval=-max_rad,
                                    maxval=max_rad),
        "flip": (jax.random.uniform(k_flip, (b,)) < d.horizontal_flip_prob
                 ).astype(jnp.float32),
        "shift_y": jax.random.uniform(k_sy, (b,), minval=-1.0, maxval=1.0),
        "shift_x": jax.random.uniform(k_sx, (b,), minval=-1.0, maxval=1.0),
        "brightness": jit_factor(kb, d.brightness_factor),
        "contrast": jit_factor(kc, d.contrast_factor),
        "saturation": jit_factor(ks, d.saturation_factor),
        "hue": jax.random.uniform(k_hue, (b, 1, 1), minval=-d.hue_factor,
                                  maxval=d.hue_factor),
    }
    return {k: _t(np.asarray(v)).reshape(b) for k, v in p.items()}


@pytest.mark.parametrize("over", [
    {}, {"data.rotation_degrees": 0.0, "data.hue_factor": 0.0},
    {"data.online_rotation": False, "data.crop_scale_min": 0.5}],
    ids=["default", "no-rotation-no-hue", "no-online-rotation"])
def test_train_preprocess_matches_jax_at_the_jax_draws(over):
    over = {"data.image_size": 40, **over}
    cfg, jcfg = resolve_config("default", over), jax_config("default", over)
    u8 = _images(5, b=6, s=64)
    for seed in (0, 1):
        key = jax.random.key(seed)
        want = np.asarray(jpre.train_preprocess(jnp.asarray(u8), key, jcfg))
        got = tpre.train_preprocess_apply(_t(u8), _jax_params(key, 6, cfg),
                                          cfg)
        assert got.shape == want.shape == (6, 40, 40, 3)
        err = np.abs(got.numpy() - want)
        if cfg.data.rotation_degrees > 0 and cfg.data.online_rotation:
            assert err.max() <= BF16_ATOL and err.mean() <= BF16_MEAN_ATOL
        else:
            assert err.max() <= ATOL


def test_train_preprocess_draws_are_seeded_and_in_range():
    cfg = resolve_config("default", {"data.image_size": 32})
    u8 = _t(_images(6, b=16, s=48))
    a = tpre.train_preprocess(u8, torch.Generator().manual_seed(3), cfg)
    b = tpre.train_preprocess(u8, torch.Generator().manual_seed(3), cfg)
    c = tpre.train_preprocess(u8, torch.Generator().manual_seed(4), cfg)
    assert torch.equal(a, b) and not torch.allclose(a, c)
    assert a.shape == (16, 32, 32, 3) and a.dtype == torch.float32
    p = tpre.draw_train_params(4096, cfg, torch.Generator().manual_seed(0))
    d = cfg.data
    bounds = {"crop_scale": (d.crop_scale_min, 1.0),
              "angle": (-math.radians(15), math.radians(15)),
              "shift_y": (-1, 1), "shift_x": (-1, 1),
              "brightness": (0.8, 1.2), "contrast": (0.8, 1.2),
              "saturation": (0.8, 1.2), "hue": (-0.1, 0.1)}
    for k, (lo, hi) in bounds.items():
        assert lo <= float(p[k].min()) and float(p[k].max()) <= hi, k
        assert float(p[k].max() - p[k].min()) > 0.9 * (hi - lo), k
    assert abs(float(p["flip"].mean()) - 0.5) < 0.05
    bf = tpre.train_preprocess(u8, torch.Generator().manual_seed(3), cfg,
                               dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16


def test_eval_preprocess_without_the_kernel_normalizes_plainly():
    cfg = resolve_config("default", {"data.image_size": 48})
    u8 = _images(7, b=2, s=48)
    got = tpre.eval_preprocess(_t(u8), cfg, use_kernel=False)
    want = jpre.eval_preprocess(jnp.asarray(u8), jax_config(
        "default", {"data.image_size": 48}), use_pallas=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
