"""Explainability of the torch package against the JAX package on the
same weights, in f32 on the CPU: Grad-CAM (CAM and logits) for the
image-only and multimodal models, the text-token attention, the
cross-modal attention summary, and the heatmap helpers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_rare_disease_tpu.explain import GradCAM as JaxGradCAM
from multimodal_rare_disease_tpu.explain import (
    cross_modal_attention_summary as jax_summary,
)
from multimodal_rare_disease_tpu.explain import (
    gradcam_heatmap as jax_heatmap,
)
from multimodal_rare_disease_tpu.explain import (
    overlay_heatmap as jax_overlay,
)
from multimodal_rare_disease_tpu.explain import (
    text_token_attention as jax_text_attention,
)
from multimodal_rare_disease_tpu.config import resolve_config as jax_config
from multimodal_rare_disease_tpu.data.tokenizer import (
    get_tokenizer as jax_tokenizer,
)
from multimodal_rare_disease_tpu.models import create_model as jax_model
from multimodal_rare_disease_tpu_torch.config import resolve_config
from multimodal_rare_disease_tpu_torch.data.tokenizer import get_tokenizer
from multimodal_rare_disease_tpu_torch.explain import (
    GradCAM,
    cam_from_gradients,
    cross_modal_attention_summary,
    gradcam_heatmap,
    overlay_heatmap,
    text_token_attention,
)
from multimodal_rare_disease_tpu_torch.explain.attention import (
    plot_cross_modal_attention,
    plot_text_attention,
)
from multimodal_rare_disease_tpu_torch.models.classifier import create_model
from multimodal_rare_disease_tpu_torch.models.convert import (
    state_dict_from_jax,
)

from tests.test_torch_classifier import _randomize
from tests.test_torch_evaluation import eval_overrides, model_pair

# CAM: a normalized [0, 1] map from f32 sums in another order (the JAX
# stem is the space-to-depth form of the same conv); logits: O(1-10),
# the same roundoff through the image tower as test_torch_classifier.py
CAM_ATOL = 1e-4
LOGIT_ATOL = 1e-4
ATOL = 1e-5
TEXT = "Patient presents with hypertelorism and a wide mouth with full lips"


@pytest.mark.parametrize("mode", ["image_only", "multimodal"])
def test_gradcam_matches_jax(mode):
    # 128-px images: a 4 x 4 stage4 map
    jcfg, jm, v, cfg, tm = model_pair(mode, 11, **{"data.image_size": 128})
    images = np.random.default_rng(12).integers(0, 256, (3, 256, 256, 3),
                                                dtype=np.uint8)
    text = {}
    if mode == "multimodal":
        ids, mask, _ = get_tokenizer().encode_batch(
            [TEXT, "short note", TEXT[:30]], 32)
        text = dict(input_ids=ids, attention_mask=mask)
    want = JaxGradCAM(jcfg, jm, v["params"], v.get("batch_stats", {}),
                      mode=mode)
    got = GradCAM(cfg, tm, mode=mode)
    for class_idx in (None, np.array([1, 5, 9])):
        cam, logits = got(images, class_idx=class_idx, **text)
        jcam, jlogits = want(images, class_idx=class_idx, **text)
        assert cam.shape == jcam.shape == (3, 4, 4)
        assert cam.dtype == np.float32 and cam.min() >= 0 \
            and cam.max() <= 1
        np.testing.assert_allclose(logits, np.asarray(jlogits),
                                   atol=LOGIT_ATOL)
        np.testing.assert_allclose(cam, np.asarray(jcam), atol=CAM_ATOL)


def test_gradcam_math_sees_a_flipped_gradient_or_a_dropped_alpha():
    # what chip_smoke.py's Grad-CAM check relies on: each fault moves
    # the CAM far past CAM_ATOL
    _, _, _, cfg, tm = model_pair("image_only", 13,
                                  **{"data.image_size": 128})
    images = np.random.default_rng(14).integers(0, 256, (2, 256, 256, 3),
                                                dtype=np.uint8)
    fmap, grad, _ = GradCAM(cfg, tm).gradients(images)
    cam = cam_from_gradients(fmap, grad)
    for fault in (cam_from_gradients(fmap, -grad),
                  cam_from_gradients(fmap, torch.ones_like(grad))):
        assert (fault - cam).abs().max() > 0.1


def test_gradcam_needs_an_image_model():
    _, _, _, cfg, tm = model_pair("text_only", 15)
    with pytest.raises(ValueError):
        GradCAM(cfg, tm, mode="text_only")


def test_text_token_attention_matches_jax():
    jcfg, jm, v, cfg, tm = model_pair("multimodal", 16)
    tok = get_tokenizer()
    want = jax_text_attention(jcfg, jm, v["params"], v["batch_stats"],
                              jax_tokenizer(), TEXT)
    got = text_token_attention(cfg, tm, tok, TEXT)
    assert [t for t, _ in got] == [t for t, _ in want]
    assert len(got) >= 8 and "[CLS]" not in dict(got)
    np.testing.assert_allclose([w for _, w in got], [w for _, w in want],
                               atol=ATOL)
    assert sum(w for _, w in got) == pytest.approx(1.0, abs=1e-6)
    for layer in (0, 1):
        a = text_token_attention(cfg, tm, tok, TEXT, layer=layer)
        b = jax_text_attention(jcfg, jm, v["params"], v["batch_stats"],
                               jax_tokenizer(), TEXT, layer=layer)
        np.testing.assert_allclose([w for _, w in a], [w for _, w in b],
                                   atol=ATOL)


@pytest.mark.parametrize("attend_over_tokens", [False, True],
                         ids=["pooled", "tokens"])
def test_cross_modal_attention_summary_matches_jax(tmp_path,
                                                   attend_over_tokens):
    jm = jax_model(jax_config("default", eval_overrides()),
                   mode="multimodal", attend_over_tokens=attend_over_tokens)
    tok = get_tokenizer()
    ids, mask, _ = tok.encode(TEXT, 32)
    images = np.random.default_rng(17).normal(size=(1, 64, 64, 3)).astype(
        np.float32)
    args = (jnp.asarray(images), jnp.asarray(ids[None]),
            jnp.asarray(mask[None]))
    v = _randomize(jm.init(jax.random.key(17), *args, train=False), 17)
    tm = create_model(resolve_config("default", eval_overrides()),
                      mode="multimodal", device="cpu", seed=None,
                      attend_over_tokens=attend_over_tokens)
    tm.load_state_dict(state_dict_from_jax(v["params"], v["batch_stats"]),
                       strict=True)
    want = jax_summary(jm.apply(v, *args, return_attention=True)
                       ["attention_info"], tok, ids)
    with torch.no_grad():
        out = tm(*(torch.from_numpy(np.asarray(a)) for a in
                   (images, ids[None].astype(np.int64),
                    mask[None].astype(np.int64))), return_attention=True)
    got = cross_modal_attention_summary(out["attention_info"], tok, ids)
    assert sorted(got) == sorted(want)
    assert ("tokens" in got) == attend_over_tokens
    assert got["image_to_text"].shape == (4, 32 if attend_over_tokens else 1)
    for k in want:
        if k == "tokens":
            assert list(got[k]) == list(want[k])
        else:
            np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                       atol=ATOL)
    plot_cross_modal_attention(got, tmp_path / "cm.png")
    plot_text_attention([("a", 0.6), ("b", 0.4)], tmp_path / "ta.png")
    assert (tmp_path / "cm.png").stat().st_size > 0
    assert (tmp_path / "ta.png").stat().st_size > 0


def test_heatmap_and_overlay_equal_jax():
    cam = np.random.default_rng(18).random((7, 7)).astype(np.float32)
    big = gradcam_heatmap(cam, 224)
    np.testing.assert_array_equal(big, jax_heatmap(cam, 224))
    img = np.random.default_rng(19).integers(0, 256, (224, 224, 3),
                                             dtype=np.uint8)
    for c in (cam, big):
        np.testing.assert_array_equal(overlay_heatmap(img, c),
                                      jax_overlay(img, c))
