"""The torch package's sharded predictor on gloo ranks on the CPU against
the JAX single-device predictor on the same weights (through
`state_dict_from_jax`): an 8 x 1, a 4 x 2 and a 2 x 2 mesh in one world
of 8 ranks, at `tests/test_predict_sharded.py`'s config and requests,
within that test's limits; the bucket of one request on 8-way data; and
the fused-sublayer configuration (K3's context and Wo and K1/K2's
weights gathered over the model axis) on a 1 x 2 mesh against the port
on one device. Every rank runs the plain versions of the kernels."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multimodal_rare_disease_tpu.config import resolve_config as jax_config
from multimodal_rare_disease_tpu.data.tokenizer import (
    get_tokenizer as jax_tokenizer,
)
from multimodal_rare_disease_tpu.inference.predictor import (
    MultimodalPredictor as JaxPredictor,
)
from multimodal_rare_disease_tpu.models import create_model as jax_model
from multimodal_rare_disease_tpu_torch.config import resolve_config
from multimodal_rare_disease_tpu_torch.data.tokenizer import (
    BertWordPieceTokenizer,
)
from multimodal_rare_disease_tpu_torch.inference.predictor import (
    MultimodalPredictor,
)
from multimodal_rare_disease_tpu_torch.models.classifier import create_model
from multimodal_rare_disease_tpu_torch.models.convert import (
    state_dict_from_jax,
)
from multimodal_rare_disease_tpu_torch.parallel.distributed import run_ranks
from tests.test_predict_sharded import TEXTS
# the ranks' functions, by the module name that spawned ranks import
# (pytest puts tests/ on the path)
import _torch_parallel_workers as workers

# tests/test_predict_sharded.py's config
SMALL = {
    "data.image_size": 64,
    "data.max_text_length": 32,
    "text_encoder.num_layers": 2,
    "text_encoder.num_heads": 2,
    "text_encoder.hidden_size": 32,
    "text_encoder.intermediate_size": 64,
    "text_encoder.vocab_size": 8192,
    "text_encoder.max_length": 32,
    "fusion.text_proj_dim": 32,
    "fusion.hidden_dim": 32,
    "fusion.num_attention_heads": 2,
    "cnn_encoder.embedding_dim": 32,
    "cnn_encoder.stage_sizes": (1, 1, 1, 1),
    "classifier.hidden_dims": (32,),
    "training.compute_dtype": "float32",
}
FUSED = {**SMALL, "text_encoder.fused_attn_out": True}
# the JAX sharded-predict test's limits
ATOL, RTOL = 2e-5, 2e-4
MESHES = ((8, 1), (4, 2), (2, 2))


def _probs(results):
    return np.array([[r["all_probabilities"][k]
                      for k in sorted(r["all_probabilities"])]
                     for r in results])


@pytest.fixture(scope="module")
def jax_init():
    jcfg = jax_config("default", SMALL)
    tok = jax_tokenizer()
    ids, mask, _ = tok.encode_batch(TEXTS[:1], jcfg.data.max_text_length)
    v = jax_model(jcfg, mode="multimodal").init(
        jax.random.key(0), jnp.zeros((1, 64, 64, 3)), jnp.asarray(ids),
        jnp.asarray(mask), train=False)
    rng = np.random.default_rng(1)
    images = [rng.integers(0, 256, (64, 64, 3), np.uint8) for _ in TEXTS]
    return v, tok, images


def _jax_probs(jax_init, over):
    v, tok, images = jax_init
    return _probs(JaxPredictor(jax_config("default", over), v["params"],
                               v["batch_stats"], tokenizer=tok)
                  .predict_batch(images=images, texts=TEXTS))


@pytest.fixture(scope="module")
def setup(jax_init):
    v, tok, images = jax_init
    state = state_dict_from_jax(v["params"], v["batch_stats"])
    return state, dict(tok.vocab), images, _jax_probs(jax_init, SMALL)


def test_sharded_predict_matches_the_jax_single_device_predict(setup,
                                                               tmp_path):
    state, vocab, images, ref = setup
    outs = run_ranks(workers.predict_rank, 8, backend="gloo",
                     args=(SMALL, state, vocab, images, TEXTS, MESHES),
                     timeout_s=240, init_dir=str(tmp_path))
    for d, m in MESHES:
        key = f"{d}x{m}"
        ranks = [o[key] for o in outs[:d * m]]
        assert all(key not in o for o in outs[d * m:])
        for probs, bucket1, packed, classic, qkv, _ in ranks:
            # every rank holds the whole batch's probabilities, in order
            np.testing.assert_allclose(probs, ref, atol=ATOL, rtol=RTOL,
                                       err_msg=key)
            assert packed + classic == 1
            assert qkv == (3 * 32 // m, 32)  # its heads of q, k and v
            # bucket 1 does not split over the data axis: one request
            # serves at bucket 8, as the JAX predictor's
            assert bucket1 == 8


def test_bucket_rounds_to_the_data_axis_as_jax():
    cfg = resolve_config("default", SMALL)
    p = MultimodalPredictor(cfg, create_model(cfg, "image_only", "cpu"),
                            "cpu", mode="image_only")
    assert p._bucket(1) == 1 and p._bucket(9) == 32 and p._bucket(300) == 512
    for d, want in ((8, {1: 8, 9: 32, 257: 264}), (6, {1: 24, 30: 48}),
                    (2, {1: 8, 33: 256})):
        p._data_size = d
        jp = JaxPredictor.__new__(JaxPredictor)
        jp._data_size = d
        for n, b in want.items():
            assert p._bucket(n) == jp._bucket(n) == b, (d, n)


def test_fused_sublayers_on_a_1x2_mesh_match_one_device(setup, tmp_path):
    state, vocab, images, _ = setup
    cfg = resolve_config("default", FUSED)
    model = create_model(cfg, device="cpu", seed=None)
    model.load_state_dict(state, strict=True)
    one = _probs(MultimodalPredictor(
        cfg, model, "cpu", tokenizer=BertWordPieceTokenizer(vocab))
        .predict_batch(images=images, texts=TEXTS))
    outs = run_ranks(workers.predict_rank, 2, backend="gloo",
                     args=(FUSED, state, vocab, images, TEXTS, ((1, 2),)),
                     timeout_s=120, init_dir=str(tmp_path))
    for o in outs:
        np.testing.assert_allclose(o["1x2"][0], one, atol=ATOL, rtol=RTOL)


QUANT = {**SMALL, "text_encoder.quantized_inference": True}
# the sharded int8 layers compute the single-device codes and int32
# accumulators (maxima and integer sums over the model axis are exact);
# what is left is float work in another order (on these ranks: none)
MESH_Q8_ATOL = 1e-6


def test_quantized_predict_on_2x1_and_1x2_matches_one_device_and_jax(
        jax_init, setup, tmp_path):
    state, vocab, images, _ = setup
    cfg = resolve_config("default", QUANT)
    model = create_model(cfg, device="cpu", seed=None)
    model.load_state_dict(state, strict=True)
    one = _probs(MultimodalPredictor(
        cfg, model, "cpu", tokenizer=BertWordPieceTokenizer(vocab))
        .predict_batch(images=images, texts=TEXTS))
    ref = _jax_probs(jax_init, QUANT)
    np.testing.assert_allclose(one, ref, atol=ATOL, rtol=RTOL)
    outs = run_ranks(workers.predict_rank, 2, backend="gloo",
                     args=(QUANT, state, vocab, images, TEXTS,
                           ((2, 1), (1, 2))),
                     timeout_s=240, init_dir=str(tmp_path))
    for key in ("2x1", "1x2"):
        for o in outs:
            probs = o[key][0]
            np.testing.assert_allclose(probs, one, atol=MESH_Q8_ATOL, rtol=0,
                                       err_msg=key)
            np.testing.assert_allclose(probs, ref, atol=ATOL, rtol=RTOL,
                                       err_msg=key)
            assert o[key][5] == 0  # no K1 under int8
    # the 1x2 layers hold half of each product's columns or rows
    assert outs[0]["1x2"][4] == (3 * 32 // 2, 32)


def test_sharded_int8_cache_equals_the_cache_made_on_the_shards(tmp_path):
    # a cache made from the whole f32 weights and cut by shard_model (a
    # model cast before it is sharded keeps it) equals the one made on
    # the shards, whose row-parallel scales are maxima over the axis
    outs = run_ranks(workers.int8_cache_rank, 2, backend="gloo",
                     args=(QUANT,), timeout_s=120, init_dir=str(tmp_path))
    for o in outs:
        assert len(o) == 8
        assert all(codes and scales for codes, scales, _ in o.values())
        assert sum(row for _, _, row in o.values()) == 4
