"""EfficientNet-B0 of the torch package (models/efficientnet.py and the
backbone switch of cnn_encoder.py) against the JAX module on the same
weights, in f32 on the CPU: the pooled features and every feature map in
eval mode, the train-mode features with the new BatchNorm statistics,
the weight bridge's depthwise and squeeze-excitation layouts, the
freeze mask of the efficientnet_clinicalbert preset, and Grad-CAM on its
"head" map (with the ValueError for "stage4", where the JAX Grad-CAM
fails in its tail)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_rare_disease_tpu.config import resolve_config as jax_config
from multimodal_rare_disease_tpu.explain import GradCAM as JaxGradCAM
from multimodal_rare_disease_tpu.models.cnn_encoder import (
    create_cnn_encoder as jax_cnn,
)
from multimodal_rare_disease_tpu.models.efficientnet import (
    EfficientNetB0Encoder as JaxEfficientNet,
)
from multimodal_rare_disease_tpu.train import freeze as jfreeze
from multimodal_rare_disease_tpu_torch.config import resolve_config
from multimodal_rare_disease_tpu_torch.explain import GradCAM
from multimodal_rare_disease_tpu_torch.models.cnn_encoder import (
    create_cnn_encoder,
)
from multimodal_rare_disease_tpu_torch.models.convert import (
    state_dict_from_jax,
)
from multimodal_rare_disease_tpu_torch.models.efficientnet import (
    EfficientNetB0Encoder,
)
from multimodal_rare_disease_tpu_torch.models.layers import BatchNorm
from multimodal_rare_disease_tpu_torch.train.freeze import apply_freeze
from multimodal_rare_disease_tpu.models import create_model as jax_model
from multimodal_rare_disease_tpu_torch.models.classifier import create_model
from tests.test_torch_classifier import _randomize as _randomize_model
from tests.test_torch_evaluation import eval_overrides
from tests.test_torch_resnet import _randomize

# f32 on the CPU through 16 MBConv blocks (~50 conv layers) of O(1)
# activations: the convolutions sum in another order than XLA's
ATOL = 1e-4
# train mode: the running statistics are means of O(1) activations. At
# 64 px and batch 4 the head's 2 x 2 map gives 16 values per channel, so
# flax's fast variance E[x^2] - E[x]^2 does not cancel to round-off as at
# two values (ROADMAP D6)
STATS_ATOL = 1e-5
# Grad-CAM: a [0, 1] map; logits O(1-10) (as test_torch_explain.py)
CAM_ATOL = 1e-4
NO_DROPOUT = {"text_encoder.dropout": 0.0, "fusion.dropout": 0.0,
              "classifier.dropout": 0.0, "cnn_encoder.dropout": 0.0}


def _images(seed, b=2, s=64):
    return np.random.default_rng(seed).normal(size=(b, s, s, 3)).astype(
        np.float32)


_init = jax.jit(lambda key, x: JaxEfficientNet().init(key, x))
_apply = jax.jit(lambda v, x: JaxEfficientNet().apply(v, x))
_apply_train = jax.jit(lambda v, x: JaxEfficientNet().apply(
    v, x, train=True, mutable=["batch_stats"]))


def _pair(seed):
    # the parameters do not depend on the input size
    v = _randomize(_init(jax.random.key(seed), jnp.zeros((1, 32, 32, 3))),
                   seed + 1)
    net = EfficientNetB0Encoder("cpu")
    net.load_state_dict(state_dict_from_jax(v["params"], v["batch_stats"]),
                        strict=True)
    return v, net


@pytest.mark.parametrize("size", [32, 64])
def test_efficientnet_pooled_features_and_maps_match_jax(size):
    v, net = _pair(0)
    x = _images(1, s=size)
    ref, ref_feats = _apply(v, jnp.asarray(x))
    with torch.no_grad():
        got, feats = net(torch.from_numpy(x), return_features=True)
        assert torch.equal(net(torch.from_numpy(x)), got)
    assert got.shape == (2, 1280)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    assert sorted(feats) == sorted(ref_feats) == sorted(
        [f"stage{i}" for i in range(1, 8)] + ["head"])
    for k, f in feats.items():
        assert f.shape == ref_feats[k].shape, k
        np.testing.assert_allclose(f.numpy(), np.asarray(ref_feats[k]),
                                   atol=ATOL, err_msg=k)


def test_efficientnet_train_mode_and_batch_stats_match_jax():
    v, net = _pair(2)
    x = _images(3, b=4)
    (ref, _), mutated = _apply_train(v, jnp.asarray(x))
    net.train()
    got = net(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=ATOL)
    want = state_dict_from_jax(v["params"], mutated["batch_stats"])
    old = state_dict_from_jax(v["params"], v["batch_stats"])
    sd = net.state_dict()
    keys = [k for k in want if ".running_" in k]
    n_bn = sum(isinstance(m, BatchNorm) for m in net.modules())
    assert len(keys) == 2 * n_bn == 2 * 49
    for k in keys:
        assert not torch.equal(want[k], old[k]), k
        np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(),
                                   atol=STATS_ATOL, err_msg=k)


def test_weight_bridge_carries_the_depthwise_and_se_layouts():
    v, net = _pair(4)
    p = v["params"]["stage3_block1"]
    sd = net.state_dict()
    dw = np.asarray(p["dw_conv"]["kernel"])           # (k, k, 1, mid)
    assert dw.shape == (5, 5, 1, 240)
    assert sd["stage3_block1.dw_conv.weight"].shape == (240, 1, 5, 5)
    np.testing.assert_array_equal(
        sd["stage3_block1.dw_conv.weight"].numpy()[17, 0],
        dw[:, :, 0, 17])
    for conv in ("reduce", "expand"):
        np.testing.assert_array_equal(
            sd[f"stage3_block1.se.{conv}.bias"].numpy(),
            np.asarray(p["se"][conv]["bias"]))
    assert net.stage1_block0.expand_conv is None
    assert net.stage2_block0.dw_conv.stride == (2, 2)
    assert net.stage5_block0.dw_conv.padding == (2, 2)
    assert net.stem_bn.eps == 1e-3


def test_cnn_encoder_switch_matches_jax():
    for name in ("efficientnet_b0", "efficientnet-b0"):
        cfg = resolve_config("default", {"cnn_encoder.backbone": name,
                                         "cnn_encoder.embedding_dim": 32})
        enc = create_cnn_encoder(cfg.cnn_encoder, "cpu")
        assert isinstance(enc.backbone, EfficientNetB0Encoder)
        assert enc.proj1.in_features == 1280
        assert (enc.gradcam_layer, enc.num_stages) == ("head", 7)
    jcfg = jax_config("default", {"cnn_encoder.backbone": "efficientnet_b0",
                                  "cnn_encoder.embedding_dim": 32})
    jenc = jax_cnn(jcfg.cnn_encoder)
    x = _images(5, s=32)
    jv = _randomize(jax.jit(jenc.init)(jax.random.key(5),
                                       jnp.asarray(x[:1])), 6)
    enc.load_state_dict(state_dict_from_jax(jv["params"],
                                            jv["batch_stats"]), strict=True)
    with torch.no_grad():
        got = enc(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jax.jit(jenc.apply)(jv, jnp.asarray(x))), atol=ATOL)
    bad = resolve_config("default", {"cnn_encoder.backbone": "vgg16"})
    with pytest.raises(ValueError, match="vgg16"):
        create_cnn_encoder(bad.cnn_encoder, "cpu")


def test_preset_freeze_mask_freezes_the_stem_and_stages_1_to_3():
    cfg = resolve_config("efficientnet_clinicalbert")
    jcfg = jax_config("efficientnet_clinicalbert")
    assert cfg.cnn_encoder.freeze_stages == 3
    enc = create_cnn_encoder(cfg.cnn_encoder, "meta")
    model = torch.nn.Module()
    model.cnn_encoder = enc
    apply_freeze(cfg, model)
    got = {n: p.requires_grad for n, p in model.named_parameters()}
    for name, trainable in got.items():
        part = name.split(".")[2]
        frozen = part.startswith(("stem_", "stage1_", "stage2_", "stage3_"))
        assert trainable != frozen, name
        # the JAX rule on the same path
        path = tuple(name.split("."))
        assert trainable == (not jfreeze._is_frozen(path, jcfg)), name
    assert sum(not t for t in got.values()) == 3 + 10 + 2 * 13 + 2 * 13
    assert got["cnn_encoder.backbone.head_conv.weight"]
    assert got["cnn_encoder.proj1.weight"]


def model_pair(mode, seed, **over):
    """(JAX config, JAX model, its randomized variables, port config,
    port model on the same weights): test_torch_evaluation.model_pair
    with the JAX init jitted (EfficientNet's eager init is slow)."""
    jcfg = jax_config("default", eval_overrides(**over))
    cfg = resolve_config("default", eval_overrides(**over))
    jm = jax_model(jcfg, mode=mode)
    images = jnp.zeros((1, 64, 64, 3))
    ids = jnp.ones((1, 32), jnp.int32)
    args = (images, ids, ids) if mode == "multimodal" else (images,)
    init = jax.jit(lambda key, *a: jm.init(key, *a, train=False))
    v = _randomize_model(init(jax.random.key(seed), *args), seed)
    tm = create_model(cfg, mode=mode, device="cpu", seed=None)
    tm.load_state_dict(state_dict_from_jax(v["params"], v["batch_stats"]),
                       strict=True)
    return jcfg, jm, v, cfg, tm


@pytest.mark.parametrize("mode", ["image_only", "multimodal"])
def test_gradcam_on_the_head_map_matches_jax(mode):
    over = {"cnn_encoder.backbone": "efficientnet_b0",
            "explainability.gradcam_layer": "head", **NO_DROPOUT}
    jcfg, jm, v, cfg, tm = model_pair(mode, 21, **over)
    images = np.random.default_rng(22).integers(0, 256, (2, 96, 96, 3),
                                                dtype=np.uint8)
    text = {}
    if mode == "multimodal":
        rng = np.random.default_rng(23)
        ids = rng.integers(1, 90, (2, 32)).astype(np.int32)
        text = dict(input_ids=ids, attention_mask=np.ones_like(ids))
    cam, logits = GradCAM(cfg, tm, mode=mode)(images, **text)
    jcam, jlogits = JaxGradCAM(jcfg, jm, v["params"], v["batch_stats"],
                               mode=mode)(images, **text)
    # 64-px model input: a 2 x 2 head map
    assert cam.shape == jcam.shape == (2, 2, 2)
    np.testing.assert_allclose(logits, np.asarray(jlogits), atol=ATOL)
    np.testing.assert_allclose(cam, np.asarray(jcam), atol=CAM_ATOL)


def test_gradcam_on_stage4_raises_naming_the_layer():
    # the default gradcam_layer "stage4" is EfficientNet's 80-channel
    # map; the tail pools 1,280 channels (ROADMAP F6)
    jcfg, jm, v, cfg, tm = model_pair(
        "image_only", 24, **{"cnn_encoder.backbone": "efficientnet_b0"})
    assert cfg.explainability.gradcam_layer == "stage4"
    images = np.zeros((1, 64, 64, 3), np.uint8)
    with pytest.raises(ValueError, match=r"'stage4'.*80-channel.*"
                       r'explainability.gradcam_layer="head"'):
        GradCAM(cfg, tm, mode="image_only")(images)
    with pytest.raises(Exception, match="1280"):
        JaxGradCAM(jcfg, jm, v["params"], v["batch_stats"],
                   mode="image_only")(images)
