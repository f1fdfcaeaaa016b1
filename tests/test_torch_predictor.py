"""Predictor and serving of the torch package against the JAX package:
the JSON contract and probabilities of `predict_batch` on the classic
(n=1) and packed (n=12) paths, under the default configuration and
under the fused-sublayer one (K3, K2, K1 and K4 on the path), the numpy
packing copy, an HTTP round trip through the port's MicroBatcher, and a
run in a fresh process that loads neither jax nor the JAX package."""

import base64
import io
import json
import subprocess
import sys
import threading
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from http.server import ThreadingHTTPServer
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multimodal_rare_disease_tpu.config import resolve_config as jax_config
from multimodal_rare_disease_tpu.inference import packing as jax_packing
from multimodal_rare_disease_tpu.inference.predictor import (
    MultimodalPredictor as JaxPredictor,
)
from multimodal_rare_disease_tpu.models import create_model as jax_model
from multimodal_rare_disease_tpu.ops.pallas import attn_out as jax_ao_mod
from multimodal_rare_disease_tpu.ops.pallas import ffn as jax_ffn_mod
from multimodal_rare_disease_tpu_torch.cli.serve import (
    MicroBatcher,
    make_handler,
)
from multimodal_rare_disease_tpu_torch.config import (
    SYNDROME_NAMES,
    resolve_config,
)
from multimodal_rare_disease_tpu_torch.data.clinical_text import (
    ClinicalTextAugmenter,
    _builtin_descriptions,
)
from multimodal_rare_disease_tpu_torch.data.tokenizer import get_tokenizer
from multimodal_rare_disease_tpu_torch.inference import packing
from multimodal_rare_disease_tpu_torch.inference.predictor import (
    MultimodalPredictor,
    load_predictor,
)
from multimodal_rare_disease_tpu_torch.models.classifier import create_model
from multimodal_rare_disease_tpu_torch.models.convert import (
    state_dict_from_jax,
)
from multimodal_rare_disease_tpu_torch.utils.checkpoint import (
    save_checkpoint,
)

REPO = Path(__file__).resolve().parent.parent


_SMALL = {
    "text_encoder.num_layers": 1, "text_encoder.num_heads": 4,
    "text_encoder.hidden_size": 64,
    "text_encoder.intermediate_size": 128,
    "text_encoder.vocab_size": 8192,
    "cnn_encoder.stage_sizes": (1, 1, 1, 1),
    "cnn_encoder.embedding_dim": 32,
    "fusion.hidden_dim": 32, "fusion.num_attention_heads": 4,
    "classifier.hidden_dims": (32,),
    "data.image_size": 32, "data.max_text_length": 128,
    # the JAX model is otherwise built in bf16
    "training.compute_dtype": "float32"}
# the fused-sublayer serving configuration at a small width: 2 layers,
# so the first takes K3 then K2 and the CLS-only last one K1; images
# arrive at image_size (the 256-px staging), so the preprocess is K4.
# H=128 / F=256 keep the JAX kernels' gates open.
_SLICE = {**_SMALL, "text_encoder.num_layers": 2,
          "text_encoder.hidden_size": 128,
          "text_encoder.intermediate_size": 256,
          "text_encoder.fused_attn_out": True, "data.image_size": 256}


def _pair(over):
    """The JAX and the torch predictor on the same perturbed weights."""
    cfg, jcfg = resolve_config("default", over), jax_config("default", over)
    s = jcfg.data.image_size
    jm = jax_model(jcfg, mode="multimodal")
    v = jm.init(jax.random.key(0), jnp.zeros((1, s, s, 3)),
                jnp.zeros((1, 16), jnp.int32), jnp.ones((1, 16), jnp.int32),
                train=False)
    rng = np.random.default_rng(0)
    v = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.normal(size=x.shape)
        .astype(np.float32), v)
    v["batch_stats"] = jax.tree_util.tree_map(np.abs, v["batch_stats"])
    tok = get_tokenizer()
    jp = JaxPredictor(jcfg, v["params"], v["batch_stats"], tokenizer=tok)
    tm = create_model(cfg, device="cpu", seed=None)
    tm.load_state_dict(state_dict_from_jax(v["params"], v["batch_stats"]),
                       strict=True)
    return jp, MultimodalPredictor(cfg, tm, "cpu", tokenizer=tok), v


@pytest.fixture(scope="module")
def predictors():
    return _pair(_SMALL)


def _requests(n, seed=0):
    """n (image, text) pairs: one long report (a full description plus
    an examination note, ~110 tokens, so the length bucket is 128) and
    short augmented reports (~20-40 tokens), as a serving batch mixes
    them."""
    rng = np.random.default_rng(seed)
    aug = ClinicalTextAugmenter(_builtin_descriptions(),
                                rng=np.random.default_rng(seed))
    names = list(SYNDROME_NAMES)
    texts = [aug.augment(names[0], 0) + " " + aug.augment(names[0], 2)] + [
        aug.augment(names[i % 10], (1, 3)[i % 2]) for i in range(1, n)]
    images = [rng.integers(0, 256, (256, 256, 3), dtype=np.uint8)
              for _ in range(n)]
    return images, texts


def _assert_same(got, ref):
    for g, r in zip(got, ref):
        assert set(g) == set(r) == {"predictions", "top_prediction",
                                    "all_probabilities"}
        assert [p["class_id"] for p in g["predictions"]] == \
            [p["class_id"] for p in r["predictions"]]
        gp = np.array(list(g["all_probabilities"].values()))
        rp = np.array(list(r["all_probabilities"].values()))
        # f32 on the CPU, same weights and inputs: summation order
        np.testing.assert_allclose(gp, rp, atol=1e-5)


def test_single_request_classic_path_matches_jax(predictors):
    jp, tp, _ = predictors
    images, texts = _requests(1)
    classic = tp.classic_calls
    _assert_same(tp.predict_batch(images, texts, top_k=3),
                 jp.predict_batch(images, texts, top_k=3))
    assert tp.classic_calls == classic + 1


def test_packed_batch_matches_jax(predictors):
    jp, tp, _ = predictors
    images, texts = _requests(12, seed=1)
    ids, mask = tp._prep_texts(texts, 32)
    assert ids.shape[1] == 128
    assert jax_packing.packing_wins(mask.sum(1), 128, capacity=256)
    packed = tp.packed_calls
    _assert_same(tp.predict_batch(images, texts),
                 jp.predict_batch(images, texts))
    assert tp.packed_calls == packed + 1


def test_unbucketed_batch_matches_jax(predictors):
    jp, tp, _ = predictors
    images, texts = _requests(9, seed=4)
    jp.length_bucketing = tp.length_bucketing = False
    try:
        classic = tp.classic_calls
        _assert_same(tp.predict_batch(images, texts),
                     jp.predict_batch(images, texts))
        # no length buckets: rows stay max_text_length, nothing is packed
        assert tp.classic_calls == classic + 1
    finally:
        jp.length_bucketing = tp.length_bucketing = True


@pytest.mark.parametrize("seed", range(4))
def test_packing_copy_equals_jax(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 60))
    lens = rng.integers(1, 200, size=n)
    t = int(lens.max())
    ids = rng.integers(1, 1000, size=(n, t)).astype(np.int32)
    mask = (np.arange(t)[None] < lens[:, None]).astype(np.int32)
    for cap in (256, 384):
        a = packing.pack_texts(ids, mask, capacity=cap)
        b = jax_packing.pack_texts(ids, mask, capacity=cap)
        for f in ("input_ids", "position_ids", "segment_ids",
                  "query_positions", "doc_row", "doc_slot"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        for bucket in (64, 128, 256):
            assert packing.packing_wins(lens, bucket, cap) == \
                jax_packing.packing_wins(lens, bucket, cap)


def test_format_report_and_checkpoint_round_trip(predictors, tmp_path):
    _, tp, _ = predictors
    images, texts = _requests(2, seed=2)
    res = tp.predict_batch(images, texts)
    assert "RARE DISEASE DIAGNOSIS REPORT" in tp.format_report(res[0], "P1")
    vocab = [t for t, _ in sorted(tp.tokenizer.vocab.items(),
                                  key=lambda kv: kv[1])]
    save_checkpoint(tmp_path / "ck", tp.model.state_dict(),
                    {"config": tp.cfg.to_dict(), "mode": "multimodal",
                     "vocab": vocab, "class_names": tp.class_names})
    again = load_predictor(tmp_path / "ck", "cpu")
    _assert_same(again.predict_batch(images, texts), res)


def test_http_round_trip(predictors):
    from PIL import Image

    _, tp, _ = predictors
    batcher = MicroBatcher(tp, window_ms=50.0)
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(batcher))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        health = json.load(urllib.request.urlopen(url + "/healthz",
                                                  timeout=30))
        assert health["status"] == "ok" and health["device"] == "cpu"
        images, texts = _requests(3, seed=3)

        def post(i):
            buf = io.BytesIO()
            Image.fromarray(images[i]).save(buf, format="PNG")
            body = json.dumps({"image": base64.b64encode(buf.getvalue())
                               .decode(), "text": texts[i],
                               "top_k": 2}).encode()
            req = urllib.request.Request(
                url + "/predict", data=body,
                headers={"Content-Type": "application/json"})
            return json.load(urllib.request.urlopen(req, timeout=60))

        calls = batcher.batch_calls
        with ThreadPoolExecutor(3) as ex:
            results = list(ex.map(post, range(3)))
        for r in results:
            assert len(r["predictions"]) == 2
            assert r["top_prediction"]["syndrome"] in SYNDROME_NAMES
        assert batcher.batch_calls - calls <= 3
    finally:
        srv.shutdown()
        srv.server_close()
        batcher.close()


def test_slice_predictor_matches_jax(monkeypatch):
    # the JAX predictor with its fused attention-output and FFN kernels
    # engaged (interpreted on the CPU) and its fused normalize (Pallas,
    # interpreted), against the port's plain versions of K3, K2, K1, K4
    monkeypatch.setattr(jax_ao_mod, "FORCE_INTERPRET", True)
    monkeypatch.setattr(jax_ffn_mod, "FORCE_INTERPRET", True)
    jp, tp, _ = _pair(_SLICE)
    layers = [getattr(tp.model.text_encoder.bert, f"layer{i}")
              for i in range(2)]
    assert all(la.fused_attn_out for la in layers)
    images, texts = _requests(12, seed=5)
    _assert_same(tp.predict_batch(images, texts),
                 jp.predict_batch(images, texts))
    _assert_same(tp.predict_batch(images[:1], texts[:1]),
                 jp.predict_batch(images[:1], texts[:1]))
    assert tp.packed_calls == tp.classic_calls == 1


def test_missing_card_raises_instead_of_falling_back(predictors, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tp, _ = predictors
    cfg = tp.cfg
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultimodalPredictor(cfg, tp.model)
    save_checkpoint(tmp_path / "ck", tp.model.state_dict(),
                    {"config": cfg.to_dict(), "mode": "multimodal"})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_predictor(tmp_path / "ck")


def test_port_imports_and_runs_without_jax():
    # a fresh process: tests/conftest.py imports jax into this one. The
    # slice configuration at a small width: K3, K2, K1 and K4 on the path
    code = """
import sys
import numpy as np
from multimodal_rare_disease_tpu_torch.cli import serve
from multimodal_rare_disease_tpu_torch.config import resolve_config
from multimodal_rare_disease_tpu_torch.inference.predictor import (
    MultimodalPredictor)
from multimodal_rare_disease_tpu_torch.models.classifier import create_model
cfg = resolve_config("default", {
    "text_encoder.num_layers": 2, "text_encoder.hidden_size": 32,
    "text_encoder.num_heads": 2, "text_encoder.intermediate_size": 64,
    "text_encoder.fused_attn_out": True,
    "cnn_encoder.stage_sizes": (1, 1, 1, 1), "data.image_size": 256})
p = MultimodalPredictor(cfg, create_model(cfg, device="cpu"), "cpu")
img = np.zeros((256, 256, 3), np.uint8)
out = p.predict_batch([img] * 9, ["a short report"] * 9)
assert len(out) == 9 and p.classic_calls + p.packed_calls == 1
bad = [m for m in sys.modules if m.split(".")[0] in
       ("jax", "jaxlib", "flax", "optax", "orbax",
        "multimodal_rare_disease_tpu")]
assert not bad, bad
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


@pytest.mark.parametrize("mode", ["multimodal", "image_only", "text_only"])
def test_every_mode_with_embeddings_matches_jax(tmp_path, mode):
    # the three modes through a port checkpoint that load_predictor reads
    # with an explicit mode; embeddings take the classic path
    from multimodal_rare_disease_tpu_torch.utils.checkpoint import (
        save_checkpoint,
    )
    from tests.test_torch_evaluation import model_pair

    jcfg, _, v, cfg, tm = model_pair(mode, 40)
    jp = JaxPredictor(jcfg, v["params"], v.get("batch_stats", {}), mode=mode)
    save_checkpoint(tmp_path, tm.state_dict(), meta={"config": cfg.to_dict()})
    tp = load_predictor(tmp_path, "cpu", mode=mode)
    assert tp.mode == mode and (tp.tokenizer is None) == (mode ==
                                                          "image_only")
    images, texts = _requests(9, seed=5)
    kw = {"images": images if mode != "text_only" else None,
          "texts": texts if mode != "image_only" else None}
    got = tp.predict_batch(**kw, return_embeddings=True)
    want = jp.predict_batch(**kw, return_embeddings=True)
    assert tp.packed_calls == 0
    for g, w in zip(got, want):
        ge, we = g.pop("embeddings"), w.pop("embeddings")
        assert set(ge) == set(we) == {
            "multimodal": {"image", "text", "fused"},
            "image_only": {"image"}, "text_only": {"text"}}[mode]
        for key in we:
            # O(1-10) values: the towers' f32 roundoff, as the logits
            np.testing.assert_allclose(ge[key], we[key], atol=1e-4)
    _assert_same(got, want)
    single = tp.predict(image=kw["images"] and images[0],
                        text=kw["texts"] and texts[0],
                        return_embeddings=True)
    assert "embeddings" in single
    # a modality the mode needs is missing (the other one is given)
    for need, other in (("images", "texts"), ("texts", "images")):
        if kw[need] is None:
            continue
        bad = {need: None, other: images if other == "images" else texts}
        with pytest.raises(ValueError, match="requires"):
            jp.predict_batch(**bad)
        with pytest.raises(ValueError, match="requires"):
            tp.predict_batch(**bad)
