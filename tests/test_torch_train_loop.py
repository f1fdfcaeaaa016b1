"""The torch package's Trainer end to end on the CPU, on a synthetic PNG
corpus (data/synthetic.py) under tmp_path: two epochs in the resident
and in the streaming mode (the same history: both modes draw the same
batches; the streaming run profiles an epoch), the best/last
checkpoints and their meta, `--resume` continuing the step count, a
trained checkpoint scored by `load_predictor` and the Evaluator, and
`cli/train.py --smoke-test --device cpu`."""

import json

import numpy as np
import pytest
import torch

from multimodal_rare_disease_tpu_torch.cli import train as train_cli
from multimodal_rare_disease_tpu_torch.config import resolve_config
from multimodal_rare_disease_tpu_torch.data.synthetic import (
    generate_synthetic_for_training,
)
from multimodal_rare_disease_tpu_torch.evaluation import Evaluator
from multimodal_rare_disease_tpu_torch.inference.predictor import (
    load_predictor,
)
from multimodal_rare_disease_tpu_torch.train.pipeline import DataPipeline
from multimodal_rare_disease_tpu_torch.train.trainer import Trainer
from multimodal_rare_disease_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    load_train_state,
    role_path,
)

SMALL = {
    "text_encoder.num_layers": 2, "text_encoder.num_heads": 2,
    "text_encoder.hidden_size": 32, "text_encoder.intermediate_size": 64,
    "cnn_encoder.stage_sizes": (1, 1, 1, 1),
    "cnn_encoder.embedding_dim": 32, "fusion.hidden_dim": 32,
    "fusion.num_attention_heads": 2, "classifier.hidden_dims": (32,),
    "data.image_size": 32, "data.max_text_length": 32,
    "text_encoder.max_length": 32, "training.batch_size": 8,
    "training.compute_dtype": "float32", "training.warmup_epochs": 0,
    "training.learning_rate": 1e-3, "training.num_epochs": 2,
    "evaluation.eval_batch_size": 8,
}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    generate_synthetic_for_training(d, num_per_class=3, image_size=64)
    return d


def _trainer(corpus, workdir, **over):
    cfg = resolve_config("default", {**SMALL, **over})
    pipe = DataPipeline(cfg, mode="multimodal", image_dir=str(corpus))
    return Trainer(cfg, "multimodal", pipeline=pipe, workdir=str(workdir),
                   device="cpu")


@pytest.fixture(scope="module")
def trained(corpus, tmp_path_factory):
    """Two epochs in each data mode; the streaming run profiles its first
    epoch and writes no checkpoint."""
    res_dir = tmp_path_factory.mktemp("resident")
    res = _trainer(corpus, res_dir)
    out_r = res.train()
    prof = tmp_path_factory.mktemp("prof")
    stream = _trainer(corpus, tmp_path_factory.mktemp("streaming"), **{
        "training.device_corpus_budget_gb": 0.0,
        "training.profile_dir": str(prof), "training.profile_epoch": 0,
        "training.save_checkpoints": False})
    out_s = stream.train()
    return res, out_r, res_dir, stream, out_s, prof


def test_resident_and_streaming_modes_train_alike(trained):
    res, out_r, _, stream, out_s, prof = trained
    assert res.resident and not stream.resident
    for out in (out_r, out_s):
        h = out["history"]
        assert set(h) == {"train_loss", "train_acc", "val_loss", "val_acc",
                          "lr"}
        assert all(len(v) == 2 for v in h.values())
        assert all(np.isfinite(v).all() for v in h.values())
        assert out["skipped_steps"] == 0
    # the same rows, texts, augmentation and dropout draws in both modes
    for k in out_r["history"]:
        np.testing.assert_allclose(out_r["history"][k], out_s["history"][k],
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    spe = res.pipeline.steps_per_epoch
    assert res.state.step == stream.state.step == 2 * spe
    # the profiled epoch's trace; no checkpoint from the streaming run
    trace = prof / "train_epoch0.json"
    assert trace.is_file() and trace.stat().st_size > 0
    assert not role_path(stream.workdir, "multimodal", "best").exists()


def test_checkpoints_resume_and_evaluate(corpus, trained):
    tr, _, workdir, *_ = trained
    spe = tr.pipeline.steps_per_epoch
    best = role_path(workdir, "multimodal", "best")
    last = role_path(workdir, "multimodal", "last")
    state, meta = load_checkpoint(last)
    assert {"step", "mode", "epoch", "best_metric", "best_metric_name",
            "history", "config", "vocab"} <= set(meta)
    assert meta["step"] == 2 * spe and meta["epoch"] == 1
    ts = load_train_state(last)
    assert ts["step"] == 2 * spe and ts["skipped_steps"] == 0
    assert load_train_state(best) is None
    assert set(state) == set(tr.model.state_dict())

    # resume: the history, the optimizer moments and the step carry on
    again = _trainer(corpus, workdir)
    again.load(last)
    assert again.state.step == 2 * spe
    assert again.history == tr.history
    moments = {n: again.state.optimizer.state[p]["exp_avg"]
               for n, p in again.model.named_parameters() if p.requires_grad}
    ref = {n: tr.state.optimizer.state[p]["exp_avg"]
           for n, p in tr.model.named_parameters() if p.requires_grad}
    assert all(torch.equal(moments[n], ref[n]) for n in ref)
    out = again.train(num_epochs=3)
    assert len(out["history"]["train_loss"]) == 3
    assert again.state.step == 3 * spe

    # the best checkpoint scores through the predictor's loader and the
    # Evaluator as the trainer's validation scored it
    _, best_meta = load_checkpoint(best)
    p = load_predictor(best, device="cpu")
    assert p.mode == "multimodal"
    collected = Evaluator(p.cfg, p.model).collect_predictions(
        tr.pipeline.val_batches())
    acc = float(np.mean(collected["predictions"] == collected["labels"]))
    assert collected["probabilities"].shape == (
        len(tr.pipeline.val_samples), 10)
    assert acc == pytest.approx(
        best_meta["history"]["val_acc"][best_meta["epoch"]], abs=1e-6)


def test_train_cli_smoke_test_prints_its_summary(tmp_path, capsys):
    assert train_cli.main(["--smoke-test", "--device", "cpu",
                           "--checkpoint-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    summary = json.loads(out[out.index("{"):])
    assert summary["mode"] == "multimodal" and summary["epochs_run"] == 2
    assert summary["skipped_steps"] == 0
    assert np.isfinite(summary["final_train_loss"])
    assert summary["checkpoint_dir"] == str(tmp_path)
    assert role_path(tmp_path, "multimodal", "last").is_dir()


def test_train_cli_needs_a_card_or_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--smoke-test", "--checkpoint-dir", str(tmp_path)])
