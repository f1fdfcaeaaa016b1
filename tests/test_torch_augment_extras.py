"""The default-off train augmentation extras of the torch package
(ops/preprocess.py) against the JAX package's, in f32 on the CPU, each
applied at the parameters the JAX function draws (re-derived here from
its subkeys with jax.random): Gaussian blur, Gaussian noise, random
erasing, coarse dropout, perspective, tiled and global CLAHE, elastic,
the `gather` geometry; then the whole `train_preprocess` with every
extra on, `augment_batch`, and the port's own draws."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_rare_disease_tpu.config import resolve_config as jax_config
from multimodal_rare_disease_tpu.ops import preprocess as jpre
from multimodal_rare_disease_tpu_torch.config import resolve_config
from multimodal_rare_disease_tpu_torch.ops import preprocess as tpre
from tests.test_torch_train_augment import BF16_ATOL, BF16_MEAN_ATOL
from tests.test_torch_train_augment import _jax_params as _jax_base_params

# f32, the same arithmetic in another order, on values in [0, 1]
ATOL = 1e-5
# the perspective warp: the 8 x 8 DLT solve in f32 by another LU (XLA's
# against LAPACK's) moves the homography by round-off, ~1e-6 relative;
# sampled coordinates of up to ~S = 40 px move by ~1e-4 px, and a
# bilinear sample of [0, 1] pixels moves by at most that times the
# largest step between neighbours (1): held at 1e-3, the mean at 1e-5
PERSPECTIVE_ATOL = 1e-3
PERSPECTIVE_MEAN_ATOL = 1e-5

EXTRAS = {"data.gaussian_blur_prob": 0.5, "data.gaussian_noise_std": 0.05,
          "data.random_erasing_prob": 0.5, "data.perspective_prob": 0.5,
          "data.clahe_prob": 0.5, "data.elastic_prob": 0.5,
          "data.coarse_dropout_prob": 0.5}


def _t(a):
    return torch.from_numpy(np.array(a))


def _x(seed, b=3, s=32):
    return np.random.default_rng(seed).uniform(0, 1, (b, s, s, 3)).astype(
        np.float32)


def _extra_params(key, b, s, cfg):
    """The extras' parameters as the JAX train_preprocess draws them from
    `key` (its subkeys 7..13), in the port's names."""
    d = cfg.data
    (*_, k_bsel, k_noise, k_erase, k_persp, k_clahe, k_elastic,
     k_dropout) = jax.random.split(key, 14)
    p = {"blur": jax.random.uniform(k_bsel, (b,)) < d.gaussian_blur_prob,
         "noise": jax.random.normal(k_noise, (b, s, s, 3))}
    kp, ka, ky, kx = jax.random.split(k_erase, 4)
    p["erase"] = (jax.random.uniform(kp, (b, 1, 1, 1))
                  < d.random_erasing_prob).reshape(b)
    p["erase_area"] = jax.random.uniform(ka, (b,), minval=0.02, maxval=0.2)
    p["erase_y"] = jax.random.uniform(ky, (b,))
    p["erase_x"] = jax.random.uniform(kx, (b,))
    kc, kp = jax.random.split(k_persp)
    p["perspective_shift"] = (jax.random.uniform(kc, (b, 4, 2))
                              * d.perspective_distortion)
    p["perspective"] = (jax.random.uniform(kp, (b, 1, 1, 1))
                        < d.perspective_prob).reshape(b)
    p["clahe"] = (jax.random.uniform(k_clahe, (b, 1, 1, 1))
                  < d.clahe_prob).reshape(b)
    kd, kp = jax.random.split(k_elastic)
    p["elastic_field"] = jax.random.uniform(kd, (b, s, s, 2), minval=-1.0,
                                            maxval=1.0)
    p["elastic"] = (jax.random.uniform(kp, (b, 1, 1, 1))
                    < d.elastic_prob).reshape(b)
    n = d.coarse_dropout_holes
    kp, kn, ka, ky, kx = jax.random.split(k_dropout, 5)
    p["dropout"] = (jax.random.uniform(kp, (b, 1, 1, 1))
                    < d.coarse_dropout_prob).reshape(b)
    p["dropout_holes"] = jax.random.randint(kn, (b,), 1, n + 1)
    p["dropout_area"] = jax.random.uniform(ka, (b, n), minval=0.02,
                                           maxval=0.035)
    p["dropout_y"] = jax.random.uniform(ky, (b, n))
    p["dropout_x"] = jax.random.uniform(kx, (b, n))
    out = {k: _t(np.asarray(v)) for k, v in p.items()}
    out["dropout_holes"] = out["dropout_holes"].long()
    return out


def test_bilinear_sample_matches_jax_at_edges_and_integers():
    img = _x(0, b=2, s=9)[:, :, :7]                       # [2, 9, 7, 3]
    rng = np.random.default_rng(1)
    ys = rng.uniform(-3, 12, (2, 6, 5)).astype(np.float32)
    xs = rng.uniform(-3, 10, (2, 6, 5)).astype(np.float32)
    # exact integers (floor at the integer), the corners and beyond
    ys[:, 0] = [-1.0, 0.0, 8.0, 9.0, 4.0]
    xs[:, 0] = [0.0, 6.0, 6.0, 7.0, -2.0]
    want = np.stack([np.asarray(jpre._bilinear_sample(
        jnp.asarray(img[i]), jnp.asarray(ys[i]), jnp.asarray(xs[i])))
        for i in range(2)])
    got = tpre._bilinear_sample(_t(img), _t(ys), _t(xs))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    np.testing.assert_array_equal(got[:, 0, 1].numpy(), img[:, 0, 6])
    np.testing.assert_array_equal(got[:, 0, 2].numpy(), img[:, 8, 6])


@pytest.mark.parametrize("crop_min", [0.8, 0.25])
def test_gather_geometry_matches_jax(crop_min):
    # small crops put sampled coordinates near the clamp edges
    rng = np.random.default_rng(2)
    b, s, out = 6, 48, 32
    u8 = rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8)
    crop = rng.uniform(crop_min, 1.0, b).astype(np.float32)
    angle = rng.uniform(-0.26, 0.26, b).astype(np.float32)
    angle[0] = 0.0
    flip = np.array([1, 0, 1, 0, 1, 1], np.float32)
    sy, sx = (rng.uniform(-1, 1, b).astype(np.float32) for _ in range(2))
    sy[1], sx[1] = 1.0, -1.0
    want_m = jax.vmap(lambda *a: jpre._compose_affine(float(s), float(out),
                                                      *a))(
        *map(jnp.asarray, (crop, angle, flip, sy, sx)))
    got_m = tpre._compose_affine(float(s), float(out), *map(
        _t, (crop, angle, flip, sy, sx)))
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), atol=1e-5)
    want = np.asarray(jpre.affine_resample(jnp.asarray(u8), want_m, out))
    got = tpre.affine_resample(_t(u8), got_m, out)
    assert got.dtype == torch.float32 and got.shape == (b, out, out, 3)
    np.testing.assert_allclose(got.numpy() / 255.0, want / 255.0, atol=ATOL)


@pytest.mark.parametrize("sigma,taps", [(1.0, 5), (6.0, 25)])
def test_gaussian_blur_matches_jax(sigma, taps):
    # 25 taps on 20 px: every output reads clamped edge pixels
    x = _x(3, s=20)
    want = np.asarray(jpre.gaussian_blur(jnp.asarray(x), sigma, taps))
    got = tpre.gaussian_blur(_t(x), sigma, taps)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    # a constant image stays constant: the edge padding
    flat = tpre.gaussian_blur(torch.full((1, 7, 9, 2), 0.3), sigma, taps)
    np.testing.assert_allclose(flat.numpy(), 0.3, atol=ATOL)


def _jax_cfg_and_key(seed, **over):
    over = {"data.image_size": 32, **EXTRAS, **over}
    return jax_config("default", over), resolve_config("default", over), \
        jax.random.key(seed)


def test_noise_erasing_and_coarse_dropout_match_jax_at_its_draws():
    jcfg, cfg, key = _jax_cfg_and_key(4)
    b, s = 8, 32
    x = _x(5, b=b, s=s)
    p = _extra_params(key, b, s, cfg)
    (*_, k_noise, k_erase, _, _, _, k_dropout) = jax.random.split(key, 14)
    pairs = [
        (jpre.gaussian_noise(jnp.asarray(x), k_noise, 0.05),
         tpre.gaussian_noise(_t(x), p["noise"], 0.05)),
        (jpre.random_erasing(jnp.asarray(x), k_erase, 0.5),
         tpre.random_erasing(_t(x), p["erase"], p["erase_area"],
                             p["erase_y"], p["erase_x"])),
        (jpre.coarse_dropout(jnp.asarray(x), k_dropout, 0.5, num_holes=8),
         tpre.coarse_dropout(_t(x), p["dropout"], p["dropout_holes"],
                             p["dropout_area"], p["dropout_y"],
                             p["dropout_x"])),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # the masks zero whole rectangles, and only where apply is set
    erased = (pairs[1][1] == 0).all(-1)
    assert erased[p["erase"]].any() and not erased[~p["erase"]].any()
    holes = (pairs[2][1] == 0).all(-1)
    assert not holes[~p["dropout"]].any()


def test_perspective_matches_jax_at_its_draws():
    jcfg, cfg, key = _jax_cfg_and_key(6, **{"data.perspective_prob": 1.0})
    b, s = 5, 40
    x = _x(7, b=b, s=s)
    k_persp = jax.random.split(key, 14)[10]
    p = _extra_params(key, b, s, cfg)
    assert bool(p["perspective"].all())
    want = np.asarray(jpre.random_perspective(jnp.asarray(x), k_persp, 0.2,
                                              1.0))
    got = tpre.random_perspective(_t(x), p["perspective_shift"],
                                  p["perspective"])
    err = np.abs(got.numpy() - want)
    assert err.max() <= PERSPECTIVE_ATOL and err.mean() <= \
        PERSPECTIVE_MEAN_ATOL
    # the warp moves the corners inward: the frame's corners sample the
    # displaced quad, whose homography maps the frame's corners onto it
    corners = torch.tensor([[0.0, 0.0], [0.0, s - 1.0], [s - 1.0, 0.0],
                            [s - 1.0, s - 1.0]])
    sign = torch.tensor([[1.0, 1.0], [1.0, -1.0], [-1.0, 1.0],
                         [-1.0, -1.0]])
    ends = corners + sign * p["perspective_shift"] * (s - 1) / 2.0
    hm = tpre._solve_homography(corners.expand(b, 4, 2), ends)
    hom = torch.cat([corners, torch.ones(4, 1)], 1)          # [4, 3]
    mapped = torch.einsum("bij,kj->bki", hm, hom)
    np.testing.assert_allclose((mapped[..., :2] / mapped[..., 2:]).numpy(),
                               ends.numpy(), atol=1e-3)
    want_h = np.asarray(jpre._solve_homography(
        jnp.asarray(corners.expand(b, 4, 2).numpy()),
        jnp.asarray(ends.numpy())))
    np.testing.assert_allclose(hm.numpy(), want_h, rtol=1e-4, atol=1e-5)


def _jax_bins(x, num_bins=64):
    lum = 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
    return np.asarray(jax.jit(lambda lum: jnp.clip(
        (lum * num_bins).astype(jnp.int32), 0, num_bins - 1))(lum))


@pytest.mark.parametrize("size", [32, 36], ids=["tiled", "global"])
def test_clahe_matches_jax(size):
    # 36 is not divisible by the 8 x 8 grid: the global equalization.
    # Bin flips: a pixel whose luminance sits within an ulp of a bin edge
    # could land in the neighbouring bin when one side fuses the sum
    # with FMAs; its own value would then jump by a CDF step, and its
    # tile's histogram move by one count. The bins are compared first
    # and the flips counted: at these inputs there are none, so every
    # pixel is held at ATOL (a flip would fail the test, not be skipped).
    x = _x(8, b=4, s=size)
    x[0, :8, :8] = 0.0                       # black: the 1e-6 guard
    x[1] = x[1] * 0.3                        # a dark image: clipped bins
    _, idx = tpre._luminance_bins(_t(x), 64)
    flips = int((idx.numpy() != _jax_bins(jnp.asarray(x))).sum())
    assert flips == 0
    fn = jpre.clahe_batch_tiled if size % 8 == 0 else jpre.clahe_batch
    want = np.asarray(fn(jnp.asarray(x)))
    got = tpre.clahe(_t(x))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    # the other variant at a size it takes, against JAX as well
    if size % 8 == 0:
        np.testing.assert_allclose(
            tpre.clahe_batch(_t(x)).numpy(),
            np.asarray(jpre.clahe_batch(jnp.asarray(x))), atol=ATOL)
    assert float((got - _t(x)).abs().max()) > 0.05


def test_elastic_matches_jax_at_its_draws():
    jcfg, cfg, key = _jax_cfg_and_key(9, **{"data.elastic_prob": 0.5})
    b, s = 6, 24
    x = _x(10, b=b, s=s)
    k_elastic = jax.random.split(key, 14)[12]
    p = _extra_params(key, b, s, cfg)
    assert bool(p["elastic"].any()) and not bool(p["elastic"].all())
    want = np.asarray(jpre.elastic_transform(jnp.asarray(x), k_elastic,
                                             prob=0.5))
    got = tpre.elastic_transform(_t(x), p["elastic_field"], p["elastic"])
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    moved = (got - _t(x)).abs().amax(dim=(1, 2, 3))
    assert bool((moved[p["elastic"]] > 0.01).all())
    assert bool((moved[~p["elastic"]] == 0).all())


@pytest.mark.parametrize("over", [
    {}, {"data.geometry_mode": "gather"},
    {"data.geometry_mode": "gather", "data.image_size": 36}],
    ids=["separable", "gather", "gather-global-clahe"])
def test_train_preprocess_with_every_extra_matches_jax(over):
    jcfg, cfg, _ = _jax_cfg_and_key(0, **over)
    s = cfg.data.image_size
    u8 = np.random.default_rng(11).integers(0, 256, (6, 48, 48, 3),
                                            dtype=np.uint8)
    for seed in (0, 1):
        key = jax.random.key(seed)
        want = np.asarray(jpre.train_preprocess(jnp.asarray(u8), key, jcfg))
        params = {**_jax_base_params(key, 6, cfg),
                  **_extra_params(key, 6, s, cfg)}
        got = tpre.train_preprocess_apply(_t(u8), params, cfg)
        assert got.shape == want.shape == (6, s, s, 3)
        err = np.abs(got.numpy() - want)
        if cfg.data.geometry_mode == "separable":
            # the rotation's bf16 rounding (test_torch_train_augment.py)
            assert err.max() <= BF16_ATOL and err.mean() <= BF16_MEAN_ATOL
        else:
            # normalized: / the smallest ImageNet std; the perspective's
            # solve as in test_perspective_matches_jax_at_its_draws
            assert err.max() <= PERSPECTIVE_ATOL / 0.224
            assert err.mean() <= PERSPECTIVE_MEAN_ATOL / 0.224


def test_augment_batch_train_and_eval():
    cfg = resolve_config("default", {"data.image_size": 32, **EXTRAS})
    u8 = _t(np.random.default_rng(12).integers(0, 256, (4, 40, 40, 3),
                                               dtype=np.uint8))
    a = tpre.augment_batch(u8, torch.Generator().manual_seed(5), cfg, True)
    b = tpre.train_preprocess(u8, torch.Generator().manual_seed(5), cfg)
    assert torch.equal(a, b) and a.shape == (4, 32, 32, 3)
    e = tpre.augment_batch(u8, None, cfg, False, dtype=torch.bfloat16)
    assert e.dtype == torch.bfloat16
    assert torch.equal(e, tpre.eval_preprocess(u8, cfg, torch.bfloat16))


def test_extra_draws_are_seeded_in_range_and_only_when_on():
    base = resolve_config("default", {"data.image_size": 16})
    p0 = tpre.draw_train_params(64, base, torch.Generator().manual_seed(0))
    assert set(p0) == {"crop_scale", "angle", "flip", "shift_y", "shift_x",
                       "brightness", "contrast", "saturation", "hue"}
    cfg = resolve_config("default", {"data.image_size": 16, **EXTRAS,
                                     "data.random_erasing_prob": 0.25,
                                     "data.gaussian_blur_prob": 0.2})
    p = tpre.draw_train_params(4096, cfg, torch.Generator().manual_seed(0))
    q = tpre.draw_train_params(4096, cfg, torch.Generator().manual_seed(0))
    assert all(torch.equal(p[k], q[k]) for k in p)
    # the default draws come first, unchanged by the extras
    p64 = tpre.draw_train_params(64, cfg, torch.Generator().manual_seed(0))
    assert all(torch.equal(p0[k], p64[k]) for k in p0)
    for k, share in (("blur", 0.2), ("erase", 0.25), ("perspective", 0.5),
                     ("clahe", 0.5), ("elastic", 0.5), ("dropout", 0.5)):
        assert p[k].dtype == torch.bool
        assert abs(float(p[k].float().mean()) - share) < 0.03, k
    assert p["noise"].shape == (4096, 16, 16, 3)
    assert abs(float(p["noise"].std()) - 1.0) < 0.01
    assert p["elastic_field"].shape == (4096, 16, 16, 2)
    holes = p["dropout_holes"]
    assert int(holes.min()) == 1 and int(holes.max()) == 8
    for k, (lo, hi) in (("erase_area", (0.02, 0.2)),
                        ("dropout_area", (0.02, 0.035)),
                        ("erase_y", (0, 1)), ("dropout_x", (0, 1)),
                        ("perspective_shift", (0, 0.2))):
        assert lo <= float(p[k].min()) and float(p[k].max()) <= hi, k
    assert math.isclose(float(p["perspective_shift"].max()), 0.2,
                        rel_tol=0.01)
