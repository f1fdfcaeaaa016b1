"""Image tower of the torch package (models/resnet.py, cnn_encoder.py)
against the JAX modules on the same weights and random BatchNorm
statistics, in f32 on the CPU, at a cut depth (one block per stage)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_rare_disease_tpu.config import resolve_config
from multimodal_rare_disease_tpu.models.cnn_encoder import (
    create_cnn_encoder as jax_cnn,
)
from multimodal_rare_disease_tpu.models.resnet import ResNet50Encoder
from multimodal_rare_disease_tpu_torch.models.cnn_encoder import (
    create_cnn_encoder,
)
from multimodal_rare_disease_tpu_torch.models.convert import (
    state_dict_from_jax,
)
from multimodal_rare_disease_tpu_torch.models.resnet import (
    ResNet50Encoder as TorchResNet,
)

# f32 on the CPU over ~17 conv layers of O(1) activations: summation
# order of the convolutions (the JAX stem also runs as its
# space-to-depth equivalent)
ATOL = 1e-4


def _randomize(variables, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        x = np.asarray(x)
        name = path[-1].key
        noise = rng.normal(size=x.shape).astype(np.float32)
        if name == "var":
            return (1.0 + 0.2 * np.abs(noise)).astype(np.float32)
        if name in ("mean", "bias"):
            return (0.1 * noise).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * noise).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(leaf, variables)


def _images(seed, b=2, s=32):
    return np.random.default_rng(seed).normal(size=(b, s, s, 3)).astype(
        np.float32)


@pytest.mark.parametrize("size", [32, 48])
def test_resnet_pooled_features_match_jax(size):
    jnet = ResNet50Encoder(stage_sizes=(1, 1, 1, 1), dtype=jnp.float32)
    x = _images(0, s=size)
    v = _randomize(jnet.init(jax.random.key(0), jnp.asarray(x[:1])), 1)
    ref, _ = jnet.apply(v, jnp.asarray(x))
    tnet = TorchResNet("cpu", stage_sizes=(1, 1, 1, 1))
    tnet.load_state_dict(state_dict_from_jax(v["params"], v["batch_stats"]),
                         strict=True)
    with torch.no_grad():
        got = tnet(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 2048)
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL)


def test_cnn_encoder_embedding_matches_jax():
    cfg = resolve_config("default", {"cnn_encoder.stage_sizes": (1, 1, 1, 1),
                                     "cnn_encoder.embedding_dim": 32})
    jenc = jax_cnn(cfg.cnn_encoder, dtype=jnp.float32)
    x = _images(2)
    v = _randomize(jenc.init(jax.random.key(1), jnp.asarray(x[:1])), 3)
    ref = np.asarray(jenc.apply(v, jnp.asarray(x)))
    tenc = create_cnn_encoder(cfg.cnn_encoder, "cpu")
    tenc.load_state_dict(state_dict_from_jax(v["params"], v["batch_stats"]),
                         strict=True)
    with torch.no_grad():
        got = tenc(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 32)
    np.testing.assert_allclose(got, ref, atol=ATOL)

