"""The torch package's Trainer over gloo ranks on the CPU: two SGD steps
on a 2 x 1 and a 1 x 2 mesh from the same weights, against the port's
Trainer in one process and against the JAX step on one device, with
global-batch semantics (the loss over the global batch's class weights,
BatchNorm over the global batch, the gradients summed over the data
axis, the global grad norm over the model axis under a binding clip):

- `train_step` on raw uint8 batches with the augmentation, dropout
  (embeddings, attention probabilities, sublayer outputs, head) and
  mixup on, against the port's one-process step: the same draws, sliced;
- `apply_step` on model-ready images with a given mixup and no dropout,
  against the port's one-process step and the JAX step on one device
  (jitted value_and_grad and `apply_gradients`);

losses at rtol 2e-5 and every parameter, BatchNorm statistic and
momentum at 1e-5 (tests/test_tp.py's limits for its TP-against-DP
steps). Then the 1 x 2 trainer's checkpoint, written from its gathered
shards, loads onto a 2 x 1 mesh unchanged; and a validation batch with
padded rows gives the one-process sums on either mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_rare_disease_tpu.config import resolve_config as jax_config
from multimodal_rare_disease_tpu.models import create_model as jax_model
from multimodal_rare_disease_tpu.train.state import (
    apply_gradients as jax_apply_gradients,
)
from multimodal_rare_disease_tpu.train.state import (
    create_train_state as jax_train_state,
)
from multimodal_rare_disease_tpu.train.trainer import (
    weighted_ce_loss as jax_ce,
)
from multimodal_rare_disease_tpu_torch.config import resolve_config
from multimodal_rare_disease_tpu_torch.models.convert import (
    state_dict_from_jax,
)
from multimodal_rare_disease_tpu_torch.parallel.distributed import run_ranks
from multimodal_rare_disease_tpu_torch.train.trainer import Trainer
from multimodal_rare_disease_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    load_train_state,
)
from tests.test_torch_classifier import _inputs, _randomize
from tests.test_torch_train_models import NO_DROPOUT
# the ranks' functions, by the module name that spawned ranks import
# (pytest puts tests/ on the path)
import _torch_parallel_workers as workers

B = 8
LOSS_RTOL, PARAM_ATOL = 2e-5, 1e-5
LRS = (1e-2, 5e-3)
BASE = {
    "text_encoder.num_layers": 2, "text_encoder.num_heads": 4,
    "text_encoder.hidden_size": 64, "text_encoder.intermediate_size": 128,
    "text_encoder.vocab_size": 90,
    "text_encoder.max_position_embeddings": 128,
    "cnn_encoder.stage_sizes": (1, 1, 1, 1), "cnn_encoder.embedding_dim": 32,
    "fusion.hidden_dim": 32, "fusion.num_attention_heads": 4,
    "data.image_size": 32, "training.compute_dtype": "float32",
    "training.optimizer": "sgd", "training.weight_decay": 0.0,
    "training.gradient_clip_val": 1.0, "training.label_smoothing": 0.1,
    "training.batch_size": B, "evaluation.eval_batch_size": B,
}
DROPOUT = {k: 0.1 for k in NO_DROPOUT}
FULL = {**BASE, **DROPOUT, "data.mixup_alpha": 0.4}
PLAIN = {**BASE, **NO_DROPOUT}


def _raw_batch(seed):
    rng = np.random.default_rng(seed)
    _, ids, mask = _inputs(seed, B)
    return {"labels": rng.integers(0, 10, B),
            "images": rng.integers(0, 256, (B, 48, 48, 3)).astype(np.uint8),
            "input_ids": ids.astype(np.int64),
            "attention_mask": mask.astype(np.int64)}


def _ready(seed):
    """Model-ready images, the text and labels, and a mixup."""
    images, ids, mask = _inputs(seed, B)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, B)
    lam, perm = 0.3, rng.permutation(B)
    images = (lam * images + (1 - lam) * images[perm]).astype(np.float32)
    return images, {"labels": labels, "input_ids": ids.astype(np.int64),
                    "attention_mask": mask.astype(np.int64)}, (lam, perm)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    jcfg = jax_config("default", PLAIN)
    images, ids, mask = _inputs(3, 1)
    jm = jax_model(jcfg, mode="multimodal")
    v = jax.jit(lambda k, *a: jm.init(k, *a, train=False))(
        jax.random.key(3), jnp.asarray(images), jnp.asarray(ids),
        jnp.asarray(mask))
    v = _randomize(v, 3)
    state = state_dict_from_jax(v["params"], v["batch_stats"])
    class_w = np.linspace(0.5, 1.5, 10).astype(np.float32)
    batches = {"train": [(lr, _raw_batch(10 + i)) for i, lr in
                         enumerate(LRS)],
               "apply": [(lr, _ready(20 + i)[1]) for i, lr in
                         enumerate(LRS)]}
    val = _raw_batch(30)
    val["valid"] = np.array([1, 1, 1, 1, 1, 1, 0, 0], np.float32)
    batches["eval"] = val
    steps = {"train": [None] * len(LRS),
             "apply": [(_ready(20 + i)[0], _ready(20 + i)[2])
                       for i in range(len(LRS))]}
    workdir = tmp_path_factory.mktemp("mesh_ckpt")
    outs = run_ranks(workers.train_rank, 2, backend="gloo",
                     args=({"full": FULL, "plain": PLAIN}, state, class_w,
                           batches, steps, str(workdir)),
                     timeout_s=300, init_dir=str(workdir))
    return v, state, class_w, batches, steps, outs[0], workdir


def _one_process(over, state, class_w, batches, steps, kind, workdir):
    tr = Trainer(resolve_config("default", over), "multimodal",
                 device="cpu", workdir=str(workdir))
    tr.model.load_state_dict(state, strict=True)
    tr.class_weights = torch.from_numpy(class_w)
    losses = []
    for (lr, batch), step in zip(batches[kind], steps[kind]):
        b = {k: torch.from_numpy(v) for k, v in batch.items()}
        if kind == "train":
            r = tr.train_step(b, lr)
        else:
            images, (lam, perm) = step
            r = tr.apply_step(torch.from_numpy(images), b, lr,
                              (lam, torch.from_numpy(perm)))
        losses.append(float(r["loss"]))
    return losses, tr


def _close(got, want, what):
    assert set(got) == set(want), what
    for k, w in want.items():
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(w, np.float64),
                                   atol=PARAM_ATOL, err_msg=f"{what}: {k}")


def _momenta(opt_state, tr):
    """{parameter name: momentum buffer} of a gathered SGD state dict."""
    names = [n for g in tr.state.optimizer.param_groups for p in g["params"]
             for n, q in tr.model.named_parameters() if q is p]
    return {names[int(i)]: st["momentum_buffer"]
            for i, st in opt_state["state"].items()}


@pytest.mark.parametrize("kind", ["train", "apply"])
def test_mesh_steps_match_one_process(run, kind):
    _, state, class_w, batches, steps, out, workdir = run
    losses, tr = _one_process(FULL if kind == "train" else PLAIN, state,
                              class_w, batches, steps, kind, workdir)
    want = tr.model.state_dict()
    for mesh in ("2x1", "1x2"):
        metrics, got, opt = out[(mesh, kind)]
        np.testing.assert_allclose([m[0] for m in metrics], losses,
                                   rtol=LOSS_RTOL, err_msg=mesh)
        assert [m[2] for m in metrics] == [0, 0]
        _close(got, want, f"{mesh} {kind}")
        _close(_momenta(opt, tr), {n: tr.state.optimizer.state[p][
            "momentum_buffer"] for n, p in tr.model.named_parameters()
            if p.requires_grad}, f"{mesh} {kind} momenta")
    if kind == "train":
        # the class-weighted validation sums of the global batch
        tr.sync_eval_model()
        ev = tr.eval_step({k: torch.from_numpy(v)
                           for k, v in batches["eval"].items()})
        for mesh in ("2x1", "1x2"):
            got = out[(mesh, "eval")]
            assert got["count"] == float(ev["count"]) == 6.0
            assert got["correct"] == float(ev["correct"])
            np.testing.assert_allclose(got["loss_sum"], float(ev["loss_sum"]),
                                       rtol=LOSS_RTOL, err_msg=mesh)
        # the dropout, augmentation and mixup draws moved the step: the
        # same batches without them give another loss
        plain, _ = _one_process(PLAIN, state, class_w, batches, steps,
                                "train", workdir)
        assert abs(plain[0] - losses[0]) > 1e-3


def _jax_steps(v, class_w, steps, batches):
    jcfg = jax_config("default", PLAIN)
    jm = jax_model(jcfg, mode="multimodal")
    ls = jcfg.training.label_smoothing
    cw = jnp.asarray(class_w)

    def loss_fn(params, batch_stats, images, ids, mask, labels, lam, perm):
        out, mutated = jm.apply(
            {"params": params, "batch_stats": batch_stats}, images, ids,
            mask, train=True, mutable=["batch_stats"])
        loss = lam * jax_ce(out["logits"], labels, cw, ls) + (1 - lam) * \
            jax_ce(out["logits"], labels[perm], cw, ls)
        return loss, mutated["batch_stats"]

    grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    state = jax.jit(lambda v: jax_train_state(jcfg, v))(v)
    apply = jax.jit(jax_apply_gradients)
    losses = []
    for (lr, batch), (images, (lam, perm)) in zip(batches, steps):
        (loss, new_bs), g = grad(
            state.params, state.batch_stats, jnp.asarray(images),
            jnp.asarray(batch["input_ids"], jnp.int32),
            jnp.asarray(batch["attention_mask"], jnp.int32),
            jnp.asarray(batch["labels"], jnp.int32), lam, jnp.asarray(perm))
        state = apply(state, g, jnp.asarray(lr, jnp.float32), new_bs,
                      ~jnp.isfinite(loss))
        losses.append(float(loss))
    return losses, state_dict_from_jax(state.params, state.batch_stats)


def test_mesh_steps_match_the_jax_step_on_one_device(run):
    v, _, class_w, batches, steps, out, _ = run
    losses, want = _jax_steps(v, class_w, steps["apply"], batches["apply"])
    for mesh in ("2x1", "1x2"):
        metrics, got, _ = out[(mesh, "apply")]
        np.testing.assert_allclose([m[0] for m in metrics], losses,
                                   rtol=LOSS_RTOL, err_msg=mesh)
        _close(got, {k: w.numpy() for k, w in want.items()}, f"{mesh} jax")


def test_tp_checkpoint_loads_onto_another_mesh(run):
    _, _, _, _, _, out, _ = run
    path, reloaded, opt, step = out["reloaded"]
    _, saved_opt = out[("1x2", "apply")][1:]
    weights, _ = load_checkpoint(path)
    # the file holds the 1x2 trainer's gathered tensors, bit for bit
    for k, w in out[("1x2", "apply")][1].items():
        assert torch.equal(weights[k], w), k
        assert torch.equal(reloaded[k], w), k
    ts = load_train_state(path)
    assert ts["step"] == step == len(LRS)
    for i, st in saved_opt["state"].items():
        for key in ("momentum_buffer",):
            assert torch.equal(ts["optimizer"]["state"][i][key], st[key])
            assert torch.equal(opt["state"][i][key], st[key])
