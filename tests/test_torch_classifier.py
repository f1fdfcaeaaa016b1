"""Assembled models of the torch package (models/classifier.py,
fusion.py, convert.py) against the JAX models on the same weights, in
f32 on the CPU: the multimodal model's `forward` and `packed_forward`,
every mode (multimodal, image_only, text_only) and fusion type
(attention, gated, concatenation, and attention over the text tokens)
with their embeddings and attention maps, and the strict weight bridge
of every tree."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_rare_disease_tpu.config import resolve_config
from multimodal_rare_disease_tpu.models import create_model as jax_model
from multimodal_rare_disease_tpu_torch.inference.packing import pack_texts
from multimodal_rare_disease_tpu_torch.models.classifier import create_model
from multimodal_rare_disease_tpu_torch.models.convert import (
    state_dict_from_jax,
)

# f32 on the CPU, same weights and inputs: summation order through the
# towers, fusion and head; probabilities are in [0, 1]
ATOL = 1e-5


def _cfg(**over):
    return resolve_config("default", {
        "text_encoder.num_layers": 2, "text_encoder.num_heads": 4,
        "text_encoder.hidden_size": 64,
        "text_encoder.intermediate_size": 128,
        "text_encoder.vocab_size": 90,
        "text_encoder.max_position_embeddings": 128,
        "cnn_encoder.stage_sizes": (1, 1, 1, 1),
        "cnn_encoder.embedding_dim": 32,
        "fusion.hidden_dim": 32, "fusion.num_attention_heads": 4,
        "data.image_size": 32, "training.compute_dtype": "float32", **over})


def _randomize(variables, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        x = np.asarray(x)
        noise = rng.normal(size=x.shape).astype(np.float32)
        if path[-1].key == "var":
            return (1.0 + 0.2 * np.abs(noise)).astype(np.float32)
        return (x + 0.05 * noise).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, variables)


def _inputs(seed, n, t=40, lo=10):
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(n, 32, 32, 3)).astype(np.float32)
    lens = rng.integers(lo, t + 1, size=n)
    ids = np.zeros((n, t), np.int32)
    mask = np.zeros((n, t), np.int32)
    for i, k in enumerate(lens):
        ids[i, :k] = rng.integers(1, 90, size=k)
        mask[i, :k] = 1
    return images, ids, mask


def _pair(cfg, seed):
    jm = jax_model(cfg, mode="multimodal")
    images, ids, mask = _inputs(seed, 1)
    v = jm.init(jax.random.key(seed), jnp.asarray(images), jnp.asarray(ids),
                jnp.asarray(mask), train=False)
    v = _randomize(v, seed)
    tm = create_model(cfg, device="cpu", seed=None)
    tm.load_state_dict(state_dict_from_jax(v["params"], v["batch_stats"]),
                       strict=True)
    return jm, v, tm


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("activation", ["relu", "gelu", "leaky_relu"])
def test_forward_probs_match_jax(activation):
    cfg = _cfg(**{"classifier.activation": activation})
    jm, v, tm = _pair(cfg, 0)
    images, ids, mask = _inputs(1, 5)
    ref = jm.apply(v, jnp.asarray(images), jnp.asarray(ids),
                   jnp.asarray(mask), train=False)
    with torch.no_grad():
        got = tm(_t(images), _t(ids).long(), _t(mask))
    # logits are O(1-10) before the softmax squeezes them: f32 roundoff
    # of the same sums in another order
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(ref["logits"]), atol=1e-4)
    np.testing.assert_allclose(got["probs"].numpy(),
                               np.asarray(ref["probs"]), atol=ATOL)


def test_packed_forward_probs_match_jax():
    cfg = _cfg()
    jm, v, tm = _pair(cfg, 2)
    images, ids, mask = _inputs(3, 7)
    pb = pack_texts(ids, mask, capacity=128)
    args = (pb.input_ids, pb.position_ids, pb.segment_ids,
            pb.query_positions, pb.doc_row, pb.doc_slot)
    ref = jm.apply(v, jnp.asarray(images), *map(jnp.asarray, args),
                   method="packed_forward")
    with torch.no_grad():
        got = tm.packed_forward(_t(images), *(_t(a).long() for a in args))
        classic = tm(_t(images), _t(ids).long(), _t(mask))
    np.testing.assert_allclose(got["probs"].numpy(),
                               np.asarray(ref["probs"]), atol=ATOL)
    np.testing.assert_allclose(got["probs"].numpy(),
                               classic["probs"].numpy(), atol=ATOL)


def test_weight_bridge_is_strict():
    cfg = _cfg()
    _, v, tm = _pair(cfg, 4)
    sd = state_dict_from_jax(v["params"], v["batch_stats"])
    assert set(sd) == set(tm.state_dict())
    qkv = v["params"]["text_encoder"]["bert"]["layer0"]["attention"]["qkv"]
    # flax [H, 3, h, d] → Linear [3*h*d, H]
    np.testing.assert_array_equal(
        sd["text_encoder.bert.layer0.attention.qkv.weight"].numpy(),
        np.asarray(qkv["kernel"]).reshape(64, -1).T)
    missing = dict(sd)
    missing.pop("head.logits.bias")
    with pytest.raises(RuntimeError):
        tm.load_state_dict(missing, strict=True)
    with pytest.raises(KeyError):
        state_dict_from_jax({"head": {"logits": {"weird": np.zeros(3)}}})


def test_weight_bridge_loads_a_fused_attn_out_tree_strictly(monkeypatch):
    # the JAX model built (and run) with its fused attention-output
    # sublayer engaged has the same tree, and the port's model with
    # fused_attn_out loads it with no key missing or left over
    from multimodal_rare_disease_tpu.ops.pallas import attn_out as jax_ao

    monkeypatch.setattr(jax_ao, "FORCE_INTERPRET", True)
    cfg = _cfg(**{"text_encoder.fused_attn_out": True,
                  "text_encoder.hidden_size": 128,
                  "text_encoder.intermediate_size": 256})
    jm, v, tm = _pair(cfg, 5)
    assert tm.text_encoder.bert.layer0.fused_attn_out
    images, ids, mask = _inputs(6, 2, t=16)
    ref = jm.apply(v, jnp.asarray(images), jnp.asarray(ids),
                   jnp.asarray(mask), train=False)
    with torch.no_grad():
        got = tm(_t(images), _t(ids).long(), _t(mask))
    np.testing.assert_allclose(got["probs"].numpy(),
                               np.asarray(ref["probs"]), atol=ATOL)


def _mode_pair(cfg, mode, seed, attend_over_tokens=False):
    """The JAX model of `mode` and the port's, on the same randomized
    weights; the inputs of one forward of `mode`."""
    kw = ({"attend_over_tokens": attend_over_tokens}
          if mode == "multimodal" else {})
    jm = jax_model(cfg, mode=mode, **kw)
    images, ids, mask = _inputs(seed, 3)
    args = {"multimodal": (images, ids, mask), "image_only": (images,),
            "text_only": (ids, mask)}[mode]
    v = jm.init(jax.random.key(seed), *map(jnp.asarray, args), train=False)
    v = _randomize(v, seed)
    tm = create_model(cfg, mode=mode, device="cpu", seed=None, **kw)
    tm.load_state_dict(state_dict_from_jax(v["params"],
                                           v.get("batch_stats", {})),
                       strict=True)
    return jm, v, tm, args


def _check_mode(cfg, mode, seed, attend_over_tokens=False):
    jm, v, tm, args = _mode_pair(cfg, mode, seed, attend_over_tokens)
    kw = {"return_embeddings": True}
    if mode == "multimodal":
        kw["return_attention"] = True
    ref = jm.apply(v, *map(jnp.asarray, args), train=False, **kw)
    with torch.no_grad():
        got = tm(*(_t(a).long() if a.dtype == np.int32 else _t(a)
                   for a in args), **kw)
    assert set(got) == set(ref)
    np.testing.assert_allclose(got["probs"].numpy(),
                               np.asarray(ref["probs"]), atol=ATOL)
    # embeddings and logits are O(1-10): the f32 roundoff of the towers'
    # sums in another order, as for the logits above
    for key in ("logits", "image_embedding", "text_embedding",
                "fused_embedding"):
        if key in ref:
            np.testing.assert_allclose(got[key].numpy(),
                                       np.asarray(ref[key]), atol=1e-4)
    info = ref.get("attention_info", {})
    assert set(got.get("attention_info", {})) == set(info)
    for key, w in info.items():
        np.testing.assert_allclose(got["attention_info"][key].numpy(),
                                   np.asarray(w), atol=ATOL)
    return got


@pytest.mark.parametrize("over", [{"fusion.fusion_type": "gated"},
                                  {"fusion.fusion_type": "concatenation"}])
def test_gated_and_concatenation_fusions_match_jax(over):
    got = _check_mode(_cfg(**over), "multimodal", 20)
    assert ("gate" in got["attention_info"]) == (
        over["fusion.fusion_type"] == "gated")


# the unimodal models have no fusion module
@pytest.mark.parametrize("mode,fusion", [
    ("multimodal", "attention"), ("multimodal", "gated"),
    ("multimodal", "concatenation"), ("image_only", "attention"),
    ("text_only", "attention")])
def test_every_mode_and_fusion_matches_jax(mode, fusion):
    _check_mode(_cfg(**{"fusion.fusion_type": fusion}), mode, 21)


def test_attend_over_tokens_matches_jax():
    got = _check_mode(_cfg(), "multimodal", 22, attend_over_tokens=True)
    # the image attends over the 40 text tokens, padded ones weighted 0
    w = got["attention_info"]["image_to_text_attention"]
    assert w.shape == (3, 4, 1, 40)
    _, ids, mask = _inputs(22, 3)
    assert torch.all(w[torch.from_numpy(mask == 0)[:, None, None, :]
                       .expand_as(w)] == 0)


def test_create_model_rejects_an_unknown_mode():
    with pytest.raises(ValueError):
        create_model(_cfg(), mode="audio_only", device="cpu")


def test_seeded_init_is_reproducible():
    cfg = _cfg()
    a = create_model(cfg, device="cpu", seed=7).state_dict()
    b = create_model(cfg, device="cpu", seed=7).state_dict()
    c = create_model(cfg, device="cpu", seed=8).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["head.logits.weight"], c["head.logits.weight"])
