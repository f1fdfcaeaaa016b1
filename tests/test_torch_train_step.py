"""The torch package's train step against the JAX package's, in f32 on
the CPU: the optimizer update of `train/state.py` against the JAX
`apply_gradients` (adam, adamw and sgd, with and without the multimodal
preset's freeze mask and LR multipliers, with clipping), one whole
Trainer step from the same weights on the same batch (no dropout, no
augmentation; with and without mixup), the non-finite guard, and the
loss."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

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
from multimodal_rare_disease_tpu_torch.train.freeze import apply_freeze
from multimodal_rare_disease_tpu_torch.train.state import TrainState
from multimodal_rare_disease_tpu_torch.train.trainer import (
    Trainer,
    mixup_loss,
    weighted_ce_loss,
)
from tests.test_torch_classifier import _inputs, _randomize
from tests.test_torch_train_models import NO_DROPOUT

OPTIMIZERS = ("adam", "adamw", "sgd")
# f32 on the CPU, the same update formulas evaluated in another order
ATOL = 1e-5

# a parameter tree whose names reach every freeze rule and multiplier
# of the multimodal preset (frozen stem and stages 1-3, stage 4 trained;
# BERT layers below 6 frozen, layer 6 trained; fusion and head 1x)
TREE = {
    "cnn_encoder": {"backbone": {
        "stem_conv": {"kernel": (3, 2)},
        "stage2_block0": {"bn1": {"scale": (4,)}},
        "stage4_block0": {"conv1": {"kernel": (2, 3)},
                          "bn1": {"scale": (3,), "bias": (3,)}}},
        "proj1": {"kernel": (3, 3), "bias": (3,)}},
    "text_encoder": {"bert": {
        "word_embeddings": {"embedding": (5, 2)},
        "layer1": {"qkv": {"kernel": (2, 6)}},
        "layer6": {"qkv": {"kernel": (2, 6), "bias": (6,)}}}},
    "fusion": {"fusion1": {"kernel": (4, 2)}},
    "head": {"logits": {"kernel": (2, 3), "bias": (3,)}},
}


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


class _Params(nn.Module):
    """The TREE's leaves as parameters named as the port names them."""

    def __init__(self, values):
        super().__init__()
        self.names = {}
        for path, arr in values.items():
            name = ".".join(path[:-1] + ({"kernel": "weight",
                                          "scale": "weight",
                                          "embedding": "weight"}
                                         .get(path[-1], path[-1]),))
            self.names[path] = name
            self.register_parameter(name.replace(".", "__"),
                                    nn.Parameter(torch.tensor(arr)))

    def named_parameters(self, *a, **k):
        for n, p in super().named_parameters(*a, **k):
            yield n.replace("__", "."), p

    def param(self, path):
        return getattr(self, self.names[path].replace(".", "__"))


def _nest(flat):
    out = {}
    for path, v in flat.items():
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = v
    return out


@pytest.mark.parametrize("frozen", [False, True], ids=["all", "frozen"])
@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_apply_gradients_matches_jax(optimizer, frozen):
    """Three updates of the same parameters with the same gradients: the
    moments, the coupled or decoupled decay, the clip (gradients drawn
    large, so it binds), the multipliers and the mask."""
    over = {"training.optimizer": optimizer, "training.weight_decay": 0.1,
            "training.gradient_clip_val": 1.0}
    if not frozen:
        over.update({"cnn_encoder.freeze_stages": 0,
                     "text_encoder.freeze_layers": 0,
                     "training.lr_mult_cnn": 1.0,
                     "training.lr_mult_text": 1.0})
    cfg = resolve_config("multimodal", over)
    jcfg = jax_config("multimodal", over)
    rng = np.random.default_rng(0)
    values = {p: rng.normal(size=s).astype(np.float32)
              for p, s in _leaves(TREE)}
    model = _Params(values)
    apply_freeze(cfg, model)
    state = TrainState(cfg, model)
    jstate = jax_train_state(jcfg, {"params": _nest(
        {p: jnp.array(v) for p, v in values.items()})})
    lrs = (0.1, 0.05, 0.02)
    for step, lr in enumerate(lrs):
        grads = {p: (3.0 * rng.normal(size=v.shape)).astype(np.float32)
                 for p, v in values.items()}
        for path, g in grads.items():
            p = model.param(path)
            p.grad = torch.tensor(g) if p.requires_grad else None
        assert state.apply_gradients(torch.tensor(1.0), lr)
        jstate = jax_apply_gradients(
            jstate, _nest({p: jnp.array(g) for p, g in grads.items()}),
            jnp.asarray(lr, jnp.float32))
    assert state.step == jstate.step == len(lrs)
    jflat = dict(_leaves(jax.tree_util.tree_map(np.asarray,
                                                jstate.params)))
    moved = 0
    for path, v in values.items():
        got = model.param(path).detach().numpy()
        np.testing.assert_allclose(got, jflat[path], atol=ATOL,
                                   err_msg=str(path))
        moved += not np.array_equal(got, v)
    n_frozen = sum(not p.requires_grad for p in model.parameters())
    assert n_frozen == (3 if frozen else 0)  # stem, stage 2, layer 1
    assert moved == len(values) - n_frozen


def _step_cfg(optimizer, frozen, **over):
    base = {
        "text_encoder.num_layers": 2, "text_encoder.num_heads": 4,
        "text_encoder.hidden_size": 64,
        "text_encoder.intermediate_size": 128,
        "text_encoder.vocab_size": 90,
        "text_encoder.max_position_embeddings": 128,
        "cnn_encoder.stage_sizes": (1, 1, 1, 1),
        "cnn_encoder.embedding_dim": 32,
        "fusion.hidden_dim": 32, "fusion.num_attention_heads": 4,
        "data.image_size": 32, "training.compute_dtype": "float32",
        "training.optimizer": optimizer, "training.weight_decay": 0.05,
        "training.gradient_clip_val": 1.0, "training.label_smoothing": 0.1,
        **NO_DROPOUT, **over}
    if frozen:  # the multimodal preset's freeze (2 layers: 6 freezes both)
        base["text_encoder.freeze_layers"] = 1
    preset = "multimodal" if frozen else "default"
    return resolve_config(preset, base), jax_config(preset, base)


_GRADS = {}


def _jax_grads(jcfg, v, images, ids, mask, labels, class_w, mix):
    """The JAX loss, gradients and new batch statistics of the train
    forward (jitted; the same for every optimizer and freeze mask, so
    computed once per mixup case)."""
    key = mix is not None
    if key not in _GRADS:
        jm = jax_model(jcfg, mode="multimodal")
        ls = jcfg.training.label_smoothing

        def loss_fn(params, batch_stats):
            out, mutated = jm.apply(
                {"params": params, "batch_stats": batch_stats},
                jnp.asarray(images), jnp.asarray(ids), jnp.asarray(mask),
                train=True, mutable=["batch_stats"])
            loss = jax_ce(out["logits"], jnp.asarray(labels), class_w, ls)
            if mix is not None:
                lam, perm = mix
                loss = lam * loss + (1 - lam) * jax_ce(
                    out["logits"], jnp.asarray(labels[perm]), class_w, ls)
            return loss, mutated["batch_stats"]

        fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        _GRADS[key] = fn(v["params"], v["batch_stats"])
    return _GRADS[key]


def _jax_step(jcfg, v, images, ids, mask, labels, class_w, lr, mix=None):
    (loss, new_bs), grads = _jax_grads(jcfg, v, images, ids, mask, labels,
                                       class_w, mix)
    state = jax.jit(lambda v: jax_train_state(jcfg, v))(v)
    state = jax.jit(jax_apply_gradients)(
        state, grads, jnp.asarray(lr, jnp.float32), new_bs,
        ~jnp.isfinite(loss))
    return float(loss), state


def _torch_pair(cfg, v, tmp_path, class_w):
    tr = Trainer(cfg, "multimodal", device="cpu", workdir=str(tmp_path))
    tr.model.load_state_dict(state_dict_from_jax(v["params"],
                                                 v["batch_stats"]),
                             strict=True)
    tr.class_weights = torch.from_numpy(class_w)
    return tr


def _batch(seed, n=4):
    images, ids, mask = _inputs(seed, n)
    labels = np.random.default_rng(seed).integers(0, 10, n).astype(np.int32)
    t = {"labels": torch.from_numpy(labels).long(),
         "input_ids": torch.from_numpy(ids).long(),
         "attention_mask": torch.from_numpy(mask).long()}
    return images, ids, mask, labels, t


_VARIABLES = {}


def _init(jcfg, images, ids, mask, seed):
    """Randomized JAX variables of the step tests' model (one set per
    seed: every case has the same architecture)."""
    if seed not in _VARIABLES:
        jm = jax_model(jcfg, mode="multimodal")
        init = jax.jit(lambda key, *a: jm.init(key, *a, train=False))
        v = init(jax.random.key(seed), jnp.asarray(images[:1]),
                 jnp.asarray(ids[:1]), jnp.asarray(mask[:1]))
        _VARIABLES[seed] = _randomize(v, seed)
    return _VARIABLES[seed]


@pytest.mark.parametrize("case", [
    ("adam", False, False), ("adam", True, False), ("adamw", False, False),
    ("adamw", True, True), ("sgd", False, False), ("sgd", True, False)],
    ids=["adam", "adam-frozen", "adamw", "adamw-frozen-mixup", "sgd",
         "sgd-frozen"])
def test_one_trainer_step_matches_jax(case, tmp_path):
    optimizer, frozen, mixup = case
    cfg, jcfg = _step_cfg(optimizer, frozen)
    images, ids, mask, labels, batch = _batch(21)
    v = _init(jcfg, images, ids, mask, 21)
    class_w = np.linspace(0.5, 1.5, 10).astype(np.float32)
    mix = None
    if mixup:
        lam, perm = 0.3, np.array([2, 0, 3, 1])
        images = (lam * images + (1 - lam) * images[perm]).astype(np.float32)
        mix = (lam, perm)
    # Adam's first update is lr·g/(|g| + eps) per element: where g (with
    # the coupled decay) is at round-off level, it can take either sign
    # in either library, so one element of many may differ by up to 2·lr.
    # Adam steps at 4e-6 to keep that under the tolerance; its updates
    # are then held through its first moments (0.1·g) below, and the
    # update formulas at large rates by test_apply_gradients_matches_jax.
    # SGD moves by lr·g
    lr = 4e-6 if optimizer != "sgd" else 1e-2
    jloss, jstate = _jax_step(jcfg, v, images, ids, mask, labels,
                              jnp.asarray(class_w), lr, mix)
    tr = _torch_pair(cfg, v, tmp_path, class_w)
    tmix = (mix[0], torch.from_numpy(mix[1])) if mix else None
    m = tr.apply_step(torch.from_numpy(images), batch, lr, tmix)
    assert m["skipped"] == 0 and tr.state.step == 1
    assert abs(float(m["loss"]) - jloss) < ATOL
    want = state_dict_from_jax(jstate.params, jstate.batch_stats)
    before = state_dict_from_jax(v["params"], v["batch_stats"])
    got = tr.model.state_dict()
    assert set(got) == set(want)
    moved = frozen_seen = 0
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), atol=ATOL,
                                   err_msg=k)
        p = dict(tr.model.named_parameters()).get(k)
        if p is not None and not p.requires_grad:
            frozen_seen += 1
            assert torch.equal(got[k], before[k]), k
        moved += not torch.equal(w, before[k])
    assert (frozen_seen > 0) == frozen
    assert moved > len(want) // 2
    # the first moment (adam: 0.1·g; sgd's momentum buffer: g) of every
    # trained parameter, against the JAX optimizer state
    jmoment = (jstate.opt_state[0].mu if optimizer != "sgd"
               else jstate.opt_state[0].trace)
    jmoment = state_dict_from_jax(jmoment)
    named = dict(tr.model.named_parameters())
    held = 0
    for k, w in jmoment.items():
        p = named[k]
        if not p.requires_grad:
            continue
        st = tr.state.optimizer.state[p]
        t = st["exp_avg"] if optimizer != "sgd" else st["momentum_buffer"]
        scale = 0.1 if optimizer != "sgd" else 1.0
        np.testing.assert_allclose(t.numpy(), w.numpy(),
                                   atol=scale * ATOL, err_msg=k)
        held += 1
    assert held == sum(p.requires_grad for p in named.values())


def test_non_finite_step_changes_nothing(tmp_path):
    cfg, jcfg = _step_cfg("adamw", True)
    images, ids, mask, labels, batch = _batch(21)
    v = _init(jcfg, images, ids, mask, 21)
    tr = _torch_pair(cfg, v, tmp_path, np.ones(10, np.float32))
    x = torch.from_numpy(images)
    assert tr.apply_step(x, batch, 1e-3)["skipped"] == 0
    with torch.no_grad():
        tr.model.head.logits.bias[3] = float("nan")

    def bits(t):
        return t.detach().clone().view(torch.int32)

    params = {k: bits(t) for k, t in tr.model.state_dict().items()}
    moments = {id(p): {k: bits(s) for k, s in st.items()
                       if torch.is_tensor(s)}
               for p, st in tr.state.optimizer.state.items()}
    m = tr.apply_step(x, batch, 1e-3)
    assert m["skipped"] == 1 and not torch.isfinite(m["loss"])
    assert tr.state.skipped_steps == 1 and tr.state.step == 2
    for k, t in tr.model.state_dict().items():
        assert torch.equal(bits(t), params[k]), k   # BatchNorm stats too
    for p, st in tr.state.optimizer.state.items():
        for k, s in st.items():
            if torch.is_tensor(s):
                assert torch.equal(bits(s), moments[id(p)][k])
    assert all(p.grad is None for p in tr.model.parameters())


def test_trainer_creates_its_directories_as_jax_does(tmp_path):
    """Building a Trainer creates training.checkpoint_dir and
    evaluation.results_dir, in both packages, and nothing else."""
    from multimodal_rare_disease_tpu.train.trainer import (
        Trainer as JaxTrainer,
    )

    made = {}
    for name in ("jax", "torch"):
        root = tmp_path / name
        cfg, jcfg = _step_cfg("sgd", False, **{
            "training.checkpoint_dir": str(root / "runs" / "ckpt"),
            "evaluation.results_dir": str(root / "results")})
        if name == "jax":
            JaxTrainer(jcfg, "multimodal")
        else:
            Trainer(cfg, "multimodal", device="cpu")
        made[name] = sorted(str(p.relative_to(root))
                            for p in root.rglob("*"))
    assert made["torch"] == made["jax"] == ["results", "runs", "runs/ckpt"]


def test_weighted_ce_loss_matches_jax():
    rng = np.random.default_rng(5)
    logits = (3 * rng.normal(size=(12, 10))).astype(np.float32)
    labels = rng.integers(0, 10, 12).astype(np.int32)
    class_w = rng.uniform(0.2, 3.0, 10).astype(np.float32)
    valid = (rng.uniform(size=12) > 0.3).astype(np.float32)
    for ls in (0.0, 0.1, 0.12):
        for vm in (None, valid):
            got = weighted_ce_loss(torch.from_numpy(logits),
                                   torch.from_numpy(labels).long(),
                                   torch.from_numpy(class_w), ls,
                                   None if vm is None
                                   else torch.from_numpy(vm))
            want = jax_ce(jnp.asarray(logits), jnp.asarray(labels),
                          jnp.asarray(class_w), ls,
                          None if vm is None else jnp.asarray(vm))
            assert abs(float(got) - float(want)) < 1e-6
    # torch's own CrossEntropyLoss where its definition and the JAX
    # package's coincide: class weights without smoothing, smoothing
    # without class weights. With both, torch weights the smoothing term
    # by each class's weight while the JAX loss (and so the port's)
    # weights a sample's whole smoothed target by its label's weight:
    # here 3.546 against torch's 3.693 (ROADMAP Queue 3, F4)
    x, y = torch.from_numpy(logits), torch.from_numpy(labels).long()
    w = torch.from_numpy(class_w)
    for cw, ls in ((w, 0.0), (None, 0.1)):
        ref = nn.CrossEntropyLoss(weight=cw, label_smoothing=ls)(x, y)
        got = weighted_ce_loss(x, y, torch.ones(10) if cw is None else cw,
                               ls)
        assert abs(float(got) - float(ref)) < 1e-6
    both = nn.CrossEntropyLoss(weight=w, label_smoothing=0.1)(x, y)
    assert abs(float(weighted_ce_loss(x, y, w, 0.1)) - float(both)) > 0.1


def test_mixup_loss_matches_jax():
    rng = np.random.default_rng(6)
    logits = rng.normal(size=(8, 10)).astype(np.float32)
    labels = rng.integers(0, 10, 8).astype(np.int32)
    class_w = rng.uniform(0.5, 2.0, 10).astype(np.float32)
    perm = rng.permutation(8)
    for lam in (0.0, 0.37, 1.0):
        got = mixup_loss(torch.from_numpy(logits),
                         torch.from_numpy(labels).long(),
                         torch.from_numpy(perm), lam,
                         torch.from_numpy(class_w), 0.1)
        jl, jw = jnp.asarray(logits), jnp.asarray(class_w)
        want = lam * jax_ce(jl, jnp.asarray(labels), jw, 0.1) + (1 - lam) \
            * jax_ce(jl, jnp.asarray(labels[perm]), jw, 0.1)
        assert abs(float(got) - float(want)) < 1e-6
