"""Train mode of the torch package's models against the JAX models'
`apply(..., train=True, mutable=['batch_stats'])` on the same weights,
in f32 on the CPU: the logits and the new BatchNorm statistics of every
mode at dropout 0 (with a batch whose biased and unbiased variances
differ), seeded dropout (the survivors' scale, the drawn share, the same
mask from the same seed), and the rule that no kernel runs in train
mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_rare_disease_tpu.models import create_model as jax_model
from multimodal_rare_disease_tpu_torch.models import bert as tbert
from multimodal_rare_disease_tpu_torch.models.classifier import create_model
from multimodal_rare_disease_tpu_torch.models.convert import (
    state_dict_from_jax,
)
from multimodal_rare_disease_tpu_torch.models.layers import (
    BatchNorm,
    Dropout,
    set_dropout_generator,
)
from tests.test_torch_classifier import _cfg, _inputs, _randomize

NO_DROPOUT = {"text_encoder.dropout": 0.0, "fusion.dropout": 0.0,
              "classifier.dropout": 0.0, "cnn_encoder.dropout": 0.0}
# f32 on the CPU: logits O(1-10), the same sums in another order (as the
# inference parity tests); the running statistics are means of O(1)
# activations
LOGIT_ATOL = 1e-4
STATS_ATOL = 1e-5


def _t(a):
    t = torch.from_numpy(np.asarray(a))
    return t.long() if t.dtype == torch.int32 else t


def train_pair(cfg, mode, seed, n=4, t=40):
    """The JAX model of `mode` and the port's trainable model on the same
    randomized weights; the inputs of one forward of `mode`."""
    jm = jax_model(cfg, mode=mode)
    images, ids, mask = _inputs(seed, n, t)
    args = {"multimodal": (images, ids, mask), "image_only": (images,),
            "text_only": (ids, mask)}[mode]
    init = jax.jit(lambda key, *a: jm.init(key, *a, train=False))
    v = _randomize(init(jax.random.key(seed), *map(jnp.asarray, args)),
                   seed)
    tm = create_model(cfg, mode=mode, device="cpu", seed=None,
                      trainable=True)
    tm.load_state_dict(state_dict_from_jax(v["params"],
                                           v.get("batch_stats", {})),
                       strict=True)
    return jm, v, tm, args


@pytest.mark.parametrize("mode", ["multimodal", "image_only", "text_only"])
def test_train_forward_and_batch_stats_match_jax(mode):
    cfg = _cfg(**NO_DROPOUT)
    jm, v, tm, args = train_pair(cfg, mode, 11)
    assert tm.training and all(p.requires_grad for p in tm.parameters())
    ref, mutated = jax.jit(lambda v, *a: jm.apply(
        v, *a, train=True, mutable=["batch_stats"]))(
        v, *map(jnp.asarray, args))
    got = tm(*map(_t, args))
    np.testing.assert_allclose(got["logits"].detach().numpy(),
                               np.asarray(ref["logits"]), atol=LOGIT_ATOL)
    if mode == "text_only":
        assert not any(isinstance(m, BatchNorm) for m in tm.modules())
        return
    want = state_dict_from_jax(v["params"], mutated["batch_stats"])
    old = state_dict_from_jax(v["params"], v["batch_stats"])
    sd = tm.state_dict()
    keys = [k for k in want if ".running_" in k]
    assert len(keys) == 2 * sum(isinstance(m, BatchNorm)
                                for m in tm.modules())
    for k in keys:
        np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(),
                                   atol=STATS_ATOL, err_msg=k)
        assert not torch.equal(want[k], old[k]), k
    # the last stage sees 1x1 maps of a batch of 4: four values per
    # channel, so the unbiased variance (what F.batch_norm folds into
    # running_var) is 4/3 of the biased one (flax's); the averages above
    # are the biased ones. (At two values per channel E[x²] − E[x]²
    # cancels to the convolutions' round-off in both libraries, so the
    # batch is 4.)
    k = "cnn_encoder.backbone.stage4_block0.bn3.running_var"
    batch_var = (want[k] - 0.9 * old[k]) / 0.1
    unbiased = 0.9 * old[k] + 0.1 * batch_var * 4.0 / 3.0
    assert (unbiased - want[k]).abs().max() > 100 * STATS_ATOL


def test_frozen_batch_norm_normalizes_by_batch_stats_and_updates_them():
    bn = BatchNorm(3, 1e-5, "cpu")
    torch.nn.init.ones_(bn.weight)
    torch.nn.init.zeros_(bn.bias)
    torch.nn.init.zeros_(bn.running_mean)
    torch.nn.init.ones_(bn.running_var)
    bn.requires_grad_(False)          # frozen, as a frozen ResNet stage
    x = torch.randn(4, 3, 5, 5, generator=torch.Generator().manual_seed(0))
    bn.train()
    y = bn(x)
    mean = x.mean((0, 2, 3))
    var = (x * x).mean((0, 2, 3)) - mean * mean
    np.testing.assert_allclose(bn.running_mean.numpy(), 0.1 * mean.numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               (0.9 + 0.1 * var).numpy(), atol=1e-6)
    # normalized by the batch's biased statistics
    np.testing.assert_allclose(
        y.numpy(), ((x - mean[None, :, None, None])
                    / torch.sqrt(var[None, :, None, None] + 1e-5)).numpy(),
        atol=1e-5)
    bn.eval()
    stats = (bn.running_mean.clone(), bn.running_var.clone())
    bn(x)
    assert torch.equal(stats[0], bn.running_mean)
    assert torch.equal(stats[1], bn.running_var)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_scales_survivors_and_draws_a_binomial_share(rate):
    n = 200_000
    x = torch.rand(n, generator=torch.Generator().manual_seed(1)) + 0.5
    drop = Dropout(rate)
    assert drop(x) is x          # a new layer is in eval mode
    drop.train()
    drop.generator = torch.Generator().manual_seed(7)
    y = drop(x)
    kept = y != 0
    np.testing.assert_allclose(y[kept].numpy(),
                               (x[kept] / (1.0 - rate)).numpy(), rtol=1e-6)
    # the share dropped is Binomial(n, rate) / n: within 5 sigma
    sigma = np.sqrt(rate * (1 - rate) / n)
    assert abs(float((~kept).float().mean()) - rate) < 5 * sigma
    drop.generator = torch.Generator().manual_seed(7)
    assert torch.equal(drop(x) != 0, kept)
    drop.generator = torch.Generator().manual_seed(8)
    assert not torch.equal(drop(x) != 0, kept)
    drop.eval()
    assert drop(x) is x
    drop.train()
    drop.generator = None
    with pytest.raises(RuntimeError, match="generator"):
        drop(x)


def test_model_dropout_is_seeded_and_off_in_eval():
    cfg = _cfg()
    tm = create_model(cfg, device="cpu", seed=3, trainable=True)
    assert {round(m.rate, 3) for m in tm.modules()
            if isinstance(m, Dropout)} == {0.1, 0.3, 0.5}
    images, ids, mask = map(_t, _inputs(4, 3))

    def logits(seed):
        set_dropout_generator(tm, torch.Generator().manual_seed(seed))
        with torch.no_grad():
            return tm(images, ids, mask)["logits"]

    a, b, c = logits(0), logits(0), logits(1)
    assert torch.equal(a, b) and not torch.allclose(a, c)
    tm.eval()
    set_dropout_generator(tm, None)  # eval mode draws nothing
    with torch.no_grad():
        e = tm(images, ids, mask)["logits"]
    assert torch.isfinite(e).all() and not torch.allclose(a, e)


def test_no_kernel_runs_in_train_mode(monkeypatch):
    """The kernel wrappers are called only in eval mode (the JAX `not
    train` gates): counted here through the model's bindings."""
    calls = {"ffn": 0, "attn_out": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tbert, "fused_ffn_ln",
                        counting("ffn", tbert.fused_ffn_ln))
    monkeypatch.setattr(tbert, "fused_attn_out_ln",
                        counting("attn_out", tbert.fused_attn_out_ln))
    cfg = _cfg(**{"text_encoder.fused_attn_out": True})
    tm = create_model(cfg, device="cpu", seed=0, trainable=True)
    set_dropout_generator(tm, torch.Generator().manual_seed(0))
    images, ids, mask = map(_t, _inputs(5, 2))
    loss = tm(images, ids, mask)["logits"].sum()
    loss.backward()
    assert calls == {"ffn": 0, "attn_out": 0}
    assert tm.text_encoder.bert.layer0.intermediate.weight.grad is not None
    tm.eval()
    with torch.no_grad():
        tm(images, ids, mask)
    # layer 0: K3 then K2; the CLS-only last layer: K1
    assert calls == {"ffn": 2, "attn_out": 1}
