"""The torch package's pretrained-weight converters against the JAX
package's on the CPU: torchvision ResNet-50 and EfficientNet-B0 and HF
BERT state dicts into the port's names bit for bit equal to the JAX
converter's tree through `state_dict_from_jax`; a tiny HF `BertModel`
against the port's BERT on the converted weights; `merge_converted`'s
refusal of a weight that does not land; `cli/convert_weights.py`, whose
checkpoint `load_predictor` serves with the JAX predictor's
probabilities on the same weights; and `tools/jax_checkpoint_to_torch.py`
from an orbax checkpoint to the JAX predictor's probabilities (f32,
1e-5)."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_rare_disease_tpu.cli import convert_weights as jax_cli
from multimodal_rare_disease_tpu.config import resolve_config as jax_config
from multimodal_rare_disease_tpu.inference.predictor import (
    load_predictor as jax_load_predictor,
)
from multimodal_rare_disease_tpu.models import convert as jconv
from multimodal_rare_disease_tpu.models import create_model as jax_model
from multimodal_rare_disease_tpu.utils.checkpoint import (
    load_checkpoint as jax_load,
)
from multimodal_rare_disease_tpu.utils.checkpoint import (
    save_checkpoint as jax_save,
)
from multimodal_rare_disease_tpu_torch.cli import convert_weights
from multimodal_rare_disease_tpu_torch.inference.predictor import (
    load_predictor,
)
from multimodal_rare_disease_tpu_torch.models import convert
from multimodal_rare_disease_tpu_torch.models.bert import BertEncoder
from multimodal_rare_disease_tpu_torch.utils.checkpoint import (
    load_checkpoint,
)

from tests.test_convert_parity import _TorchEffNetB0, _TorchResNet50
from tests.test_torch_evaluation import model_pair

REPO = Path(__file__).resolve().parent.parent
ATOL = 1e-5  # f32 on the CPU, same weights and inputs
# the JAX package's own HF parity bound (tests/test_convert.py)
HF_ATOL = 2e-5
TEXTS = ["Patient presents with hypertelorism and a wide mouth",
         "Developmental delay, seizures and a happy demeanor",
         "Short stature with downslanting palpebral fissures"]


def _seeded(module, seed):
    """A torch module's state dict with every tensor redrawn from a
    seeded generator (BatchNorm variances positive)."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in module.state_dict().items():
        if not v.is_floating_point():
            sd[k] = v
        elif k.endswith("running_var"):
            sd[k] = torch.rand(v.shape, generator=gen) + 0.5
        else:
            sd[k] = torch.randn(v.shape, generator=gen) * 0.05
    return sd


def _hf_bert(seed=0, layers=2):
    from transformers import BertConfig, BertModel

    torch.manual_seed(seed)
    return BertModel(BertConfig(
        vocab_size=128, hidden_size=32, num_hidden_layers=layers,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=64, type_vocab_size=2,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)).eval()


def _assert_bit_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("arch", ["resnet50", "efficientnet_b0"])
def test_torchvision_converters_equal_jax(arch):
    module = _TorchResNet50() if arch == "resnet50" else _TorchEffNetB0()
    sd = _seeded(module, 1)
    port_fn = {"resnet50": convert.convert_torchvision_resnet50,
               "efficientnet_b0":
                   convert.convert_torchvision_efficientnet_b0}[arch]
    jax_fn = {"resnet50": jconv.convert_torchvision_resnet50,
              "efficientnet_b0":
                  jconv.convert_torchvision_efficientnet_b0}[arch]
    _assert_bit_equal(port_fn(sd), convert.state_dict_from_jax(*jax_fn(sd)))


@pytest.mark.parametrize("prefix", ["", "bert."])
def test_hf_bert_converter_equals_jax(prefix):
    sd = {prefix + k: v for k, v in _hf_bert(1).state_dict().items()}
    _assert_bit_equal(convert.convert_hf_bert(sd, 2, 4),
                      convert.state_dict_from_jax(
                          jconv.convert_hf_bert(sd, 2, 4)))
    with pytest.raises(ValueError, match="heads"):
        convert.convert_hf_bert(sd, 2, 5)


def test_hf_bert_forward_matches_the_port():
    """A tiny HF BertModel and the port's BertEncoder on its converted
    weights: last hidden states and pooled output."""
    hf = _hf_bert(2)
    enc = BertEncoder(128, 32, 2, 4, 64, 64, 2, device="cpu")
    enc.load_state_dict(convert.convert_hf_bert(hf.state_dict(), 2, 4),
                        strict=True)
    enc.eval()
    ids = torch.tensor([[2, 5, 9, 11, 3, 0, 0, 0], [2, 7, 7, 3, 0, 0, 0, 0]])
    mask = (ids != 0).long()
    with torch.no_grad():
        ref = hf(input_ids=ids, attention_mask=mask)
        out = enc(ids, mask)
    valid = mask.bool()
    np.testing.assert_allclose(out["last_hidden_state"][valid].numpy(),
                               ref.last_hidden_state[valid].numpy(),
                               atol=HF_ATOL, rtol=0)
    np.testing.assert_allclose(out["pooler_output"].numpy(),
                               ref.pooler_output.numpy(), atol=HF_ATOL,
                               rtol=0)


def test_merge_converted_fails_on_weights_that_do_not_land():
    model = {"a.weight": torch.zeros(2, 3), "a.bias": torch.zeros(2)}
    merged = convert.merge_converted(model, {"weight": torch.ones(2, 3)},
                                     "a.")
    assert torch.equal(merged["a.weight"], torch.ones(2, 3))
    assert not model["a.weight"].any()  # a copy
    with pytest.raises(KeyError, match="do not land"):
        convert.merge_converted(model, {"weight": torch.ones(3, 2)}, "a.")
    with pytest.raises(KeyError, match="do not land"):
        convert.merge_converted(model, {"scale": torch.ones(2)}, "a.")


def test_load_torch_state_dict_unwraps(tmp_path):
    sd = {"w": torch.arange(3.0)}
    for i, obj in enumerate((sd, {"state_dict": sd},
                             {"model_state_dict": sd})):
        torch.save(obj, tmp_path / f"{i}.pt")
        got = convert.load_torch_state_dict(str(tmp_path / f"{i}.pt"))
        assert torch.equal(got["w"], sd["w"])


# -- the CLI and the orbax converter ----------------------------------------

def _jax_tree_like(template, state, prefix=()):
    """The port's state dict back in the layout of a JAX tree (the
    inverse of `state_dict_from_jax`'s rules, read off the template's
    leaf shapes)."""
    out = {}
    for k, v in template.items():
        path = prefix + (k,)
        if isinstance(v, dict):
            out[k] = _jax_tree_like(v, state, path)
            continue
        name = {"kernel": "weight", "scale": "weight", "embedding": "weight",
                "mean": "running_mean", "var": "running_var"}.get(k, k)
        w = state[".".join(path[:-1] + (name,))].numpy()
        shape = np.shape(v)
        if k == "kernel" and len(shape) == 4 and path[-2] != "qkv":
            w = w.transpose(2, 3, 1, 0)
        elif k == "kernel":
            w = w.T
        out[k] = w.reshape(shape)
    return out


def _small_overrides():
    return {"data.image_size": 64, "data.max_text_length": 32,
            "text_encoder.max_length": 32, "fusion.hidden_dim": 32,
            "fusion.num_attention_heads": 4,
            "cnn_encoder.embedding_dim": 32,
            "classifier.hidden_dims": (16,),
            "training.compute_dtype": "float32"}


def _images(n=3, seed=5):
    return list(np.random.default_rng(seed).integers(
        0, 256, (n, 256, 256, 3), dtype=np.uint8))


def _probs(results):
    return np.array([[r["all_probabilities"][c]
                      for c in sorted(r["all_probabilities"])]
                     for r in results])


def test_convert_weights_cli_serves_the_jax_probabilities(tmp_path, capsys):
    """ResNet-50 and BERT files through the port's CLI: the checkpoint's
    converted weights equal the JAX CLI's conversion, its vocab is the
    directory's, and `load_predictor` serves it with the probabilities
    of the JAX predictor on the same weights."""
    rn = tmp_path / "resnet50.pth"
    torch.save(_seeded(_TorchResNet50(), 3), rn)
    hf_dir = tmp_path / "bert"
    _hf_bert(4).save_pretrained(hf_dir)  # model.safetensors
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [
        w for w in ("patient presents with hypertelorism and a wide mouth "
                    "developmental delay seizures happy demeanor short "
                    "stature downslanting palpebral fissures").split()]
    vocab += [f"##x{i}" for i in range(128 - len(vocab))]
    (hf_dir / "vocab.txt").write_text("\n".join(vocab) + "\n")
    over = _small_overrides()
    sets = sum((["--set", f"{k}={v!r}"] for k, v in over.items()), [])
    out = tmp_path / "port"
    assert convert_weights.main(
        ["--backbone", str(rn), "--hf-bert", str(hf_dir), "--out", str(out),
         "--num-layers", "2", "--num-heads", "4", "--device", "cpu",
         *sets]) == 0
    assert jax_cli.main(["--backbone", str(rn), "--hf-bert", str(hf_dir),
                         "--out", str(tmp_path / "jax_sub"),
                         "--num-layers", "2", "--num-heads", "4",
                         "--platform", "cpu"]) == 0
    state, meta = load_checkpoint(out)
    assert meta["vocab"] == vocab and meta["mode"] == "multimodal"
    sub, sub_stats, _ = jax_load(tmp_path / "jax_sub")
    for prefix, tree, stats in (
            ("cnn_encoder.backbone.", sub["backbone"], sub_stats["backbone"]),
            ("text_encoder.bert.", sub["bert"], None)):
        want = convert.state_dict_from_jax(tree, stats)
        for k, v in want.items():
            assert torch.equal(state[prefix + k], v), prefix + k

    # the JAX model of the same config on the checkpoint's weights
    pred = load_predictor(out, "cpu")
    jcfg = jax_config("multimodal", {**over, **{
        f"text_encoder.{k}": getattr(pred.cfg.text_encoder, k)
        for k in ("num_layers", "num_heads", "vocab_size", "hidden_size",
                  "embedding_dim", "intermediate_size",
                  "max_position_embeddings")}})
    v = jax_model(jcfg).init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)),
                             jnp.ones((1, 32), jnp.int32),
                             jnp.ones((1, 32), jnp.int32), train=False)
    jax_save(tmp_path / "jax_full",
             _jax_tree_like(jax.device_get(v["params"]), state),
             _jax_tree_like(jax.device_get(v["batch_stats"]), state), 0,
             meta={"config": jcfg.to_dict(), "mode": "multimodal",
                   "vocab": vocab})
    jpred = jax_load_predictor(tmp_path / "jax_full")
    images = _images()
    np.testing.assert_allclose(_probs(pred.predict_batch(images, TEXTS)),
                               _probs(jpred.predict_batch(images, TEXTS)),
                               atol=ATOL, rtol=0)


def test_convert_weights_cli_needs_an_input_and_a_card_or_cpu(tmp_path):
    with pytest.raises(SystemExit):
        convert_weights.main(["--out", str(tmp_path / "x")])
    if torch.cuda.is_available():
        return
    rn = tmp_path / "resnet50.pth"
    torch.save(_seeded(_TorchResNet50(), 3), rn)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert_weights.main(["--backbone", str(rn), "--out",
                              str(tmp_path / "x")])


def _tool():
    spec = importlib.util.spec_from_file_location(
        "jax_checkpoint_to_torch", REPO / "tools" / "jax_checkpoint_to_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("mode", ["multimodal", "text_only"])
def test_jax_checkpoint_converter_serves_the_jax_probabilities(tmp_path,
                                                                mode):
    jcfg, _, v, _, _ = model_pair(mode, 41)
    jax_save(tmp_path / "jax", v["params"], v.get("batch_stats", {}), 3,
             meta={"config": jcfg.to_dict(), "mode": mode,
                   "class_names": [f"c{i}" for i in range(10)]})
    assert _tool().main([str(tmp_path / "jax"), str(tmp_path / "port")]) == 0
    pred = load_predictor(tmp_path / "port", "cpu")
    jpred = jax_load_predictor(tmp_path / "jax")
    assert pred.mode == mode and pred.class_names == jpred.class_names
    images = _images() if mode == "multimodal" else None
    np.testing.assert_allclose(_probs(pred.predict_batch(images, TEXTS)),
                               _probs(jpred.predict_batch(images, TEXTS)),
                               atol=ATOL, rtol=0)


def test_chip_smoke_schemas_match_the_libraries():
    """chip_smoke.py builds its torchvision ResNet-50 and HF BERT files
    from key lists (the card's machine has neither library): the lists
    equal torchvision's schema (tests/test_convert_parity.py's module)
    and a transformers BertModel's, key for key and shape for shape."""
    from transformers import BertConfig, BertModel

    from chip_smoke import hf_bert_shapes, torchvision_resnet50_shapes

    rn = {k: tuple(v.shape) for k, v in _TorchResNet50().state_dict().items()}
    want = torchvision_resnet50_shapes()
    assert {k: v for k, v in want.items() if not k.startswith("fc.")} == rn
    cfg = BertConfig(vocab_size=99, hidden_size=32, num_hidden_layers=3,
                     num_attention_heads=4, intermediate_size=48,
                     max_position_embeddings=40, type_vocab_size=2)
    hf = {k: tuple(v.shape) for k, v in BertModel(cfg).state_dict().items()
          if k != "embeddings.position_ids"}
    assert hf_bert_shapes(99, 32, 3, 48, 40, 2) == hf
