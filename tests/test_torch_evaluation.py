"""Evaluation of the torch package against the JAX package: the data
pipeline's batches (key for key, byte for byte, on a corpus of synthetic
PNGs), `compute_metrics` and the classification report against the
JAX Evaluator's sklearn ones (floats within 1e-12), the artifacts of
`save_results` / `compare_models`, and `Evaluator.collect_predictions`
against the JAX Evaluator on the same weights, in f32 on the CPU."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_rare_disease_tpu.config import resolve_config as jax_config
from multimodal_rare_disease_tpu.evaluation import Evaluator as JaxEvaluator
from multimodal_rare_disease_tpu.evaluation import (
    compare_models as jax_compare_models,
)
from multimodal_rare_disease_tpu.models import create_model as jax_model
from multimodal_rare_disease_tpu.train.pipeline import (
    DataPipeline as JaxPipeline,
)
from multimodal_rare_disease_tpu_torch.config import (
    SYNDROME_NAMES,
    resolve_config,
)
from multimodal_rare_disease_tpu_torch.data.tokenizer import get_tokenizer
from multimodal_rare_disease_tpu_torch.evaluation import (
    Evaluator,
    compare_models,
    compute_metrics,
)
from multimodal_rare_disease_tpu_torch.evaluation.evaluator import (
    classification_report,
)
from multimodal_rare_disease_tpu_torch.models.classifier import create_model
from multimodal_rare_disease_tpu_torch.models.convert import (
    state_dict_from_jax,
)
from multimodal_rare_disease_tpu_torch.train.pipeline import DataPipeline

from tests.test_torch_classifier import _randomize
from tests.test_torch_host_copies import _write_corpus

# f32 on the CPU, same weights and inputs (as test_torch_classifier.py)
ATOL = 1e-5
# the metrics are the same sums and quotients in float64
METRIC_ATOL = 1e-12
MODES = ("multimodal", "image_only", "text_only")


def eval_overrides(**over):
    """A small model whose vocab covers the default tokenizer's, over
    32-token texts and 64-px images, batches of 4."""
    return {
        "text_encoder.num_layers": 2, "text_encoder.num_heads": 4,
        "text_encoder.hidden_size": 64,
        "text_encoder.intermediate_size": 128,
        "text_encoder.vocab_size": get_tokenizer().vocab_size,
        "text_encoder.max_position_embeddings": 64,
        "cnn_encoder.stage_sizes": (1, 1, 1, 1),
        "cnn_encoder.embedding_dim": 32,
        "fusion.hidden_dim": 32, "fusion.num_attention_heads": 4,
        "data.image_size": 64, "data.max_text_length": 32,
        "training.batch_size": 4, "evaluation.eval_batch_size": 4,
        "training.compute_dtype": "float32", **over}


def model_pair(mode, seed, preset="default", **over):
    """(JAX config, JAX model, its randomized variables, port config,
    port model on the same weights)."""
    jcfg = jax_config(preset, eval_overrides(**over))
    cfg = resolve_config(preset, eval_overrides(**over))
    jm = jax_model(jcfg, mode=mode)
    images = jnp.zeros((1, 64, 64, 3))
    ids = jnp.ones((1, 32), jnp.int32)
    args = {"multimodal": (images, ids, ids), "image_only": (images,),
            "text_only": (ids, ids)}[mode]
    v = _randomize(jm.init(jax.random.key(seed), *args, train=False), seed)
    tm = create_model(cfg, mode=mode, device="cpu", seed=None)
    tm.load_state_dict(state_dict_from_jax(v["params"],
                                           v.get("batch_stats", {})),
                       strict=True)
    return jcfg, jm, v, cfg, tm


def assert_same(got, want, path="result"):
    """Equal structure and keys, ints and strings equal, floats within
    METRIC_ATOL."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert isinstance(got, float) and abs(got - want) <= METRIC_ATOL, \
            (path, got, want)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


# -- the data pipeline ------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("flat", [True, False], ids=["flat", "folders"])
def test_data_pipeline_batches_equal_jax(tmp_path, flat, mode):
    _write_corpus(tmp_path, np.random.default_rng(5), flat)
    over = eval_overrides(**{"seed": 7})
    port = DataPipeline(resolve_config("default", over), mode=mode,
                        image_dir=str(tmp_path))
    ref = JaxPipeline(jax_config("default", over), mode=mode,
                      image_dir=str(tmp_path))
    assert [s.path for s in port.train_samples] == \
        [s.path for s in ref.train_samples]
    assert [s.path for s in port.val_samples] == \
        [s.path for s in ref.val_samples]
    np.testing.assert_array_equal(port.class_weights, ref.class_weights)
    assert port.steps_per_epoch == ref.steps_per_epoch
    for it in ("val_batches", "train_batches", "train_batches",
               "val_index_batches", "train_index_batches"):
        got, want = list(getattr(port, it)()), list(getattr(ref, it)())
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert list(g) == list(w)
            for k in w:
                assert g[k].dtype == w[k].dtype and g[k].shape == \
                    w[k].shape, k
                assert g[k].tobytes() == w[k].tobytes(), k
    got, want = port.device_corpus(), ref.device_corpus()
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and \
            got[k].tobytes() == want[k].tobytes(), k


# -- metrics ----------------------------------------------------------------

def collected(case, n=120, seed=0):
    """{labels, predictions, probabilities} for a label set: all 10
    classes present; some missing (the absent classes' probability mass
    is real, as a model gives it, or negligible); two classes; one."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(n, 10)) * 2.0
    classes = {"all": range(10), "missing": (0, 3, 4, 7, 9),
               "missing-negligible": (1, 2, 5, 8), "two": (2, 6),
               "one": (4,)}[case]
    labels = rng.choice(list(classes), n)
    if case == "all":
        labels[:10] = np.arange(10)
    if case == "missing-negligible":
        absent = [c for c in range(10) if c not in classes]
        logits[:, absent] = -40.0
    # a model that is right about half of the time
    logits[np.arange(n), labels] += rng.random(n) * 3.0
    probs = torch.softmax(torch.from_numpy(logits).float(), -1).numpy()
    return {"labels": labels.astype(np.int64),
            "predictions": probs.argmax(-1).astype(np.int64),
            "probabilities": probs}


CASES = ["all", "missing", "missing-negligible", "two", "one"]


@pytest.mark.parametrize("case", CASES)
def test_compute_metrics_equals_the_jax_evaluator(case):
    c = collected(case)
    want = JaxEvaluator(jax_config("default"), None, None,
                        None).compute_metrics(c)
    got = compute_metrics(c)
    assert_same(got, want)
    # sklearn raises on columns that do not sum to 1 and on two columns;
    # the reference then leaves the key out, and so does the port
    assert ("roc_auc_ovr" in got) == (case in ("all",
                                               "missing-negligible"))


@pytest.mark.parametrize("case", CASES)
def test_classification_report_equals_sklearn(case):
    from sklearn.metrics import classification_report as sk_report

    c = collected(case)
    want = sk_report(c["labels"], c["predictions"], labels=np.arange(10),
                     target_names=list(SYNDROME_NAMES), zero_division=0)
    assert classification_report(c["labels"], c["predictions"], 10,
                                 list(SYNDROME_NAMES)) == want


def test_save_results_and_compare_models_write_the_jax_artifacts(tmp_path):
    c = collected("missing", seed=3)
    cfg = resolve_config("default")
    port = Evaluator(cfg, torch.nn.Linear(1, 1), mode="image_only")
    ref = JaxEvaluator(jax_config("default"), None, None, None,
                       mode="image_only")
    got = port.save_results(c, tmp_path / "port")
    want = ref.save_results(c, tmp_path / "jax")
    assert_same(got, want)
    table = compare_models({"image_only": got, "text_only": want},
                           tmp_path / "port")
    assert table == jax_compare_models({"image_only": got,
                                        "text_only": want},
                                       tmp_path / "jax")
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == names
    for name in names:
        a, b = tmp_path / "port" / name, tmp_path / "jax" / name
        if name.endswith(".json"):
            assert_same(json.loads(a.read_text()), json.loads(b.read_text()))
        elif name.endswith(".txt"):
            assert a.read_text() == b.read_text()
        elif name.endswith(".npz"):
            pa, pb = np.load(a), np.load(b)
            assert sorted(pa.files) == sorted(pb.files)
            for k in pb.files:
                np.testing.assert_array_equal(pa[k], pb[k])
        else:
            assert name.endswith(".png") and a.stat().st_size > 0


# -- the forward ------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_collect_predictions_matches_the_jax_evaluator(tmp_path, mode):
    _write_corpus(tmp_path, np.random.default_rng(6), flat=True)
    jcfg, jm, v, cfg, tm = model_pair(mode, 8)
    batches = list(DataPipeline(cfg, mode=mode,
                                image_dir=str(tmp_path)).val_batches())
    # the last batch is padded: its `valid` mask drops the padding rows
    n_valid = int(sum(b["valid"].sum() for b in batches))
    assert n_valid < 4 * len(batches)
    got = Evaluator(cfg, tm, mode=mode).collect_predictions(batches)
    want = JaxEvaluator(jcfg, jm, v["params"], v.get("batch_stats", {}),
                        mode=mode).collect_predictions(batches)
    assert len(got["labels"]) == n_valid
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_allclose(got["probabilities"], want["probabilities"],
                               atol=ATOL)
    np.testing.assert_array_equal(got["predictions"], want["predictions"])
    assert {k: a.dtype for k, a in got.items()} == \
        {k: a.dtype for k, a in want.items()}
