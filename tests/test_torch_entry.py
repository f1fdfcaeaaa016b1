"""The torch package's `entry()` (`multimodal_rare_disease_tpu_torch/
entry.py`) against `__graft_entry__.entry()`: the same inputs bit for
bit, and the same probabilities from the JAX entry's variables carried
across by `state_dict_from_jax`, with the port's model in bf16 (as
`entry()` builds it) and in f32. The JAX entry runs once per file (its
variables take most of a minute to build on the CPU)."""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as reference
from multimodal_rare_disease_tpu_torch import entry as tentry
from multimodal_rare_disease_tpu_torch.config import resolve_config
from multimodal_rare_disease_tpu_torch.models.classifier import create_model
from multimodal_rare_disease_tpu_torch.models.convert import (
    state_dict_from_jax,
)
from multimodal_rare_disease_tpu_torch.parallel import dryrun

# The JAX forward computes in bf16. The port's, from the same variables,
# read max|dprob| 1.22e-3 / mean 3.0e-4 in bf16 and 1.25e-3 / 2.65e-4
# with its model in f32: bf16 roundings taken in another order in the
# image tower, the fusion and the head (ROADMAP O1). The limits are
# those readings with half again of margin, and top-1 must agree on
# every row.
PROB_MAX_ATOL = 2e-3
PROB_MEAN_ATOL = 5e-4


@pytest.fixture(scope="module")
def jax_entry():
    forward, (variables, images, ids, mask) = reference.entry()
    probs = jax.jit(forward)(variables, images, ids, mask)
    return {"images": np.asarray(images), "ids": np.asarray(ids),
            "mask": np.asarray(mask),
            "probs": np.asarray(probs, np.float32),
            "state_dict": state_dict_from_jax(variables["params"],
                                              variables["batch_stats"])}


@pytest.fixture(scope="module")
def port_entry():
    return tentry.entry(device="cpu")


def test_inputs_equal_the_jax_entry(jax_entry, port_entry):
    _, (_, images, ids, mask) = port_entry
    for name, got in (("images", images), ("ids", ids), ("mask", mask)):
        want = jax_entry[name]
        got = got.numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert images.shape == (8, 256, 256, 3)
    assert ids.shape == mask.shape == (8, 128)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_probabilities_match_the_jax_entry(jax_entry, port_entry, dtype):
    forward, (model, images, ids, mask) = port_entry
    if dtype == "float32":
        model = create_model(resolve_config("default"), "multimodal", "cpu",
                             seed=None)
    model.load_state_dict(jax_entry["state_dict"], strict=True)
    assert next(model.parameters()).dtype == getattr(torch, dtype)
    probs = forward(model, images, ids, mask).float().numpy()
    want = jax_entry["probs"]
    assert probs.shape == want.shape == (8, 10)
    d = np.abs(probs - want)
    assert d.max() <= PROB_MAX_ATOL and d.mean() <= PROB_MEAN_ATOL, (
        d.max(), d.mean())
    np.testing.assert_array_equal(probs.argmax(1), want.argmax(1))


def test_entry_runs_on_the_card_by_default(port_entry, monkeypatch):
    forward, (model, images, ids, mask) = port_entry
    assert not model.training
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    assert images.device.type == "cpu"
    probs = forward(model, images, ids, mask)
    assert probs.shape == (8, 10) and torch.isfinite(probs).all()
    torch.testing.assert_close(probs.sum(1), torch.ones(8), atol=1e-3,
                               rtol=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.entry()


def test_dryrun_is_the_parallel_one_and_main_runs_eight_ranks(monkeypatch):
    assert tentry.dryrun_multichip is dryrun.dryrun_multichip
    calls = []
    monkeypatch.setattr(dryrun, "dryrun_multichip",
                        lambda *a: calls.append(a))
    assert tentry.main([]) == 0
    assert calls == [(8, "cuda", "gloo")]
