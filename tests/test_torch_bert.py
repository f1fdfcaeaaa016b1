"""BERT text tower of the torch package (models/bert.py) against the JAX
module on the same weights: classic rows, sequence-packed rows and the
CLS-only last layer, in f32 on the CPU, with the default FFN dispatch
(K1) and with `fused_attn_out` (K3 then K2 in every layer but the
CLS-only last one), and the pre-LN layers of
`text_encoder.pre_layernorm` (no kernel, as in the JAX dispatch). The
JAX side runs its classic XLA path, and its
Pallas kernels in interpret mode where the JAX package's own tests run
them that way (FORCE_INTERPRET)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_rare_disease_tpu.config import resolve_config
from multimodal_rare_disease_tpu.models.bert import create_text_encoder
from multimodal_rare_disease_tpu.ops.pallas import attn_out as jax_ao_mod
from multimodal_rare_disease_tpu.ops.pallas import ffn as jax_ffn_mod
from multimodal_rare_disease_tpu_torch.inference.packing import pack_texts
from multimodal_rare_disease_tpu_torch.models import bert as tbert
from multimodal_rare_disease_tpu_torch.models.convert import (
    state_dict_from_jax,
)

# f32 on the CPU, same weights and inputs: summation order, fast vs
# two-pass LayerNorm variance and (interpret mode) the Pallas erf
# polynomial (|err| <= 1.5e-7) against exact erf
ATOL = 1e-5

# In a process where XLA has run, the first parallel torch.erf, the one
# that starts torch's OpenMP workers, could give one worker's share of the
# rows other values (up to 7e-5 downstream) than every later call: 2 of
# 217 fresh processes. With one parallel op run first, none of 456 did
# (ROADMAP, Queue 3, F3), so the workers start here, before any forward.
torch.erf(torch.linspace(-3.0, 3.0, 1 << 16))


def _cfg(hidden=64, layers=2, ffn=128, **over):
    return resolve_config("default", {
        "text_encoder.num_layers": layers, "text_encoder.num_heads": 4,
        "text_encoder.hidden_size": hidden,
        "text_encoder.intermediate_size": ffn,
        "text_encoder.vocab_size": 120,
        "text_encoder.max_position_embeddings": 128, **over})


def _randomize(tree, rng, scale=0.05):
    """Perturb every leaf so biases / LayerNorm params are not 0 / 1."""
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.normal(size=x.shape).astype(np.float32)
        * scale, tree)


def _pair(cfg, seed=0, t=16, fused_ffn=True):
    jenc = create_text_encoder(cfg.text_encoder, dtype=jnp.float32)
    ids = jnp.ones((1, t), jnp.int32)
    params = jenc.init(jax.random.key(seed), ids, ids)["params"]
    params = _randomize(params, np.random.default_rng(seed))
    tcfg = cfg.text_encoder
    if not fused_ffn:
        from dataclasses import replace
        tcfg = replace(tcfg, fused_ffn=False)
    tenc = tbert.create_text_encoder(tcfg, "cpu")
    tenc.load_state_dict(state_dict_from_jax(params), strict=True)
    return jenc, {"params": params}, tenc.eval()


def _batch(rng, b, t, vocab=120, lo=5):
    lens = rng.integers(lo, t + 1, size=b)
    ids = np.zeros((b, t), np.int32)
    mask = np.zeros((b, t), np.int32)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.integers(1, vocab, size=n)
        mask[i, :n] = 1
    return ids, mask


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


@pytest.fixture(params=[False, True], ids=["jax-xla", "jax-interpret"])
def jax_interpret(request, monkeypatch):
    monkeypatch.setattr(jax_ffn_mod, "FORCE_INTERPRET", request.param)
    return request.param


@pytest.mark.parametrize("fused_ffn", [True, False],
                         ids=["k1-plain", "classic"])
def test_classic_cls_embedding_matches_jax(jax_interpret, fused_ffn):
    # H=128 / F=256 / M=B*T=64 is inside the JAX kernel's gate, so the
    # interpret variant really runs the Pallas kernel in layers 0..L-2
    cfg = _cfg(hidden=128, ffn=256)
    jenc, v, tenc = _pair(cfg, seed=1, fused_ffn=fused_ffn)
    ids, mask = _batch(np.random.default_rng(2), 4, 16)
    ref = np.asarray(jenc.apply(v, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        got = tenc(_t(ids), _t(mask)).numpy()
    assert got.shape == ref.shape == (4, 128)
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_full_sequence_and_cls_only_last_layer_match_jax():
    cfg = _cfg()
    jenc, v, tenc = _pair(cfg, seed=3)
    ids, mask = _batch(np.random.default_rng(4), 3, 16)
    _, jout = jenc.apply(v, jnp.asarray(ids), jnp.asarray(mask),
                         output_hidden_states=True)  # full forward
    with torch.no_grad():
        full = tenc.bert(_t(ids), _t(mask), cls_only_final=False)
        cls_only = tenc.bert(_t(ids), _t(mask), cls_only_final=True)
    np.testing.assert_allclose(full["last_hidden_state"].numpy(),
                               np.asarray(jout["last_hidden_state"]),
                               atol=ATOL)
    np.testing.assert_allclose(full["pooler_output"].numpy(),
                               np.asarray(jout["pooler_output"]), atol=ATOL)
    assert cls_only["last_hidden_state"].shape == (3, 1, 64)
    np.testing.assert_allclose(cls_only["cls"].numpy(),
                               np.asarray(jout["cls"]), atol=ATOL)


def test_packed_rows_match_jax_and_unpacked(jax_interpret):
    cfg = _cfg(hidden=128, ffn=256)
    jenc, v, tenc = _pair(cfg, seed=5)
    ids, mask = _batch(np.random.default_rng(6), 7, 40, lo=10)
    pb = pack_texts(ids, mask, capacity=128)
    kw = dict(position_ids=pb.position_ids, segment_ids=pb.segment_ids,
              query_positions=pb.query_positions)
    ref = np.asarray(jenc.apply(v, jnp.asarray(pb.input_ids), None,
                                **{k: jnp.asarray(a) for k, a in kw.items()}))
    with torch.no_grad():
        got = tenc(_t(pb.input_ids), None,
                   **{k: _t(a) for k, a in kw.items()}).numpy()
        unpacked = tenc(_t(ids), _t(mask)).numpy()
    docs = (pb.doc_row, pb.doc_slot)
    np.testing.assert_allclose(got[docs], ref[docs], atol=ATOL)
    np.testing.assert_allclose(got[docs], unpacked, atol=ATOL)


@pytest.mark.parametrize("pooler,proj", [(True, 0), (False, 16), (True, 16)])
def test_pooler_and_projection_readouts_match_jax(pooler, proj):
    cfg = _cfg(**{"text_encoder.use_pooler_output": pooler})
    jenc = create_text_encoder(cfg.text_encoder, dtype=jnp.float32,
                               projection_dim=proj)
    ones = jnp.ones((1, 16), jnp.int32)
    params = _randomize(jenc.init(jax.random.key(7), ones, ones)["params"],
                        np.random.default_rng(7))
    tenc = tbert.create_text_encoder(cfg.text_encoder, "cpu",
                                     projection_dim=proj)
    tenc.load_state_dict(state_dict_from_jax(params), strict=True)
    ids, mask = _batch(np.random.default_rng(8), 3, 16)
    ref = np.asarray(jenc.apply({"params": params}, jnp.asarray(ids),
                                jnp.asarray(mask)))
    with torch.no_grad():
        got = tenc.eval()(_t(ids), _t(mask)).numpy()
    assert got.shape == ref.shape == (3, proj or 64)
    np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.fixture
def jax_kernels_interpreted(monkeypatch):
    """The JAX layer's fused attention-output (K3) and FFN (K1/K2)
    dispatch, run by the Pallas interpreter, as
    tests/test_attn_out_kernel.py runs it."""
    monkeypatch.setattr(jax_ao_mod, "FORCE_INTERPRET", True)
    monkeypatch.setattr(jax_ffn_mod, "FORCE_INTERPRET", True)


def _k3_cfg(**over):
    # H=128 / F=256 and M = B*T a multiple of 16 and >= 32 are inside the
    # JAX kernels' gates, so the interpreted Pallas kernels really run
    return _cfg(hidden=128, ffn=256, **{"text_encoder.fused_attn_out": True,
                                        **over})


@pytest.mark.parametrize("fused_ffn", [True, False],
                         ids=["k3-k2-plain", "k3-classic-ffn"])
def test_fused_attn_out_classic_rows_match_jax(jax_kernels_interpreted,
                                               fused_ffn):
    cfg = _k3_cfg()
    jenc, v, tenc = _pair(cfg, seed=11, fused_ffn=fused_ffn)
    assert all(getattr(tenc.bert, f"layer{i}").fused_attn_out
               for i in range(2))
    ids, mask = _batch(np.random.default_rng(12), 4, 16)
    ref = np.asarray(jenc.apply(v, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        got = tenc(_t(ids), _t(mask)).numpy()
    assert got.shape == ref.shape == (4, 128)
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_fused_attn_out_full_sequence_layers_match_jax(
        jax_kernels_interpreted):
    # no CLS-only layer: every BertLayer takes K3 then K2
    cfg = _k3_cfg()
    jenc, v, tenc = _pair(cfg, seed=13)
    ids, mask = _batch(np.random.default_rng(14), 2, 32)
    _, jout = jenc.apply(v, jnp.asarray(ids), jnp.asarray(mask),
                         output_hidden_states=True)
    with torch.no_grad():
        full = tenc.bert(_t(ids), _t(mask), cls_only_final=False)
    np.testing.assert_allclose(full["last_hidden_state"].numpy(),
                               np.asarray(jout["last_hidden_state"]),
                               atol=ATOL)


def test_fused_attn_out_packed_rows_match_jax_and_unpacked(
        jax_kernels_interpreted):
    cfg = _k3_cfg()
    jenc, v, tenc = _pair(cfg, seed=15)
    ids, mask = _batch(np.random.default_rng(16), 7, 40, lo=10)
    pb = pack_texts(ids, mask, capacity=128)
    kw = dict(position_ids=pb.position_ids, segment_ids=pb.segment_ids,
              query_positions=pb.query_positions)
    ref = np.asarray(jenc.apply(v, jnp.asarray(pb.input_ids), None,
                                **{k: jnp.asarray(a) for k, a in kw.items()}))
    with torch.no_grad():
        got = tenc(_t(pb.input_ids), None,
                   **{k: _t(a) for k, a in kw.items()}).numpy()
        unpacked = tenc(_t(ids), _t(mask)).numpy()
    docs = (pb.doc_row, pb.doc_slot)
    np.testing.assert_allclose(got[docs], ref[docs], atol=ATOL)
    np.testing.assert_allclose(got[docs], unpacked, atol=ATOL)


def test_fused_attn_out_keeps_the_parameter_tree():
    # K3 uses the attention output and attention_ln modules as they are:
    # the same state dict keys and shapes as the default layer
    a = tbert.create_text_encoder(_k3_cfg().text_encoder, "cpu")
    b = tbert.create_text_encoder(_cfg(hidden=128, ffn=256).text_encoder,
                                  "cpu")
    assert {k: v.shape for k, v in a.state_dict().items()} == \
        {k: v.shape for k, v in b.state_dict().items()}


def _flat_pair(seed, **over):
    """(JAX flat encoder and variables, the port's flat encoder, the
    port's classic encoder) on the same weights."""
    cfg = _k3_cfg(**{"text_encoder.flat_residual": True, **over})
    jenc, v, flat = _pair(cfg, seed=seed)
    from dataclasses import replace

    classic = tbert.create_text_encoder(
        replace(cfg.text_encoder, flat_residual=False), "cpu").eval()
    classic.load_state_dict(flat.state_dict())
    return jenc, v, flat, classic


@pytest.mark.parametrize("fused_attn_out", [False, True],
                         ids=["k1", "k3-k2"])
@pytest.mark.parametrize("cls_only_final", [True, False],
                         ids=["cls-only", "full"])
def test_flat_residual_is_bit_equal_to_the_classic_stream(
        monkeypatch, cls_only_final, fused_attn_out):
    # the JAX flat branches change no value (tests/test_models.py holds
    # them bit-exact there); the kernels take the same rows either way
    _, _, flat, classic = _flat_pair(
        51, **{"text_encoder.fused_attn_out": fused_attn_out})
    assert flat.bert.flat_residual and not classic.bert.flat_residual
    ids, mask = _batch(np.random.default_rng(52), 4, 16)
    outs, counts = [], []
    for enc in (flat, classic):
        calls = _counting(monkeypatch)
        with torch.no_grad():
            outs.append(enc.bert(_t(ids), _t(mask),
                                 cls_only_final=cls_only_final))
        counts.append(dict(calls))
    # K3 then K2 in the full layers, K1 in a CLS-only last one
    k3 = (1 if cls_only_final else 2) if fused_attn_out else 0
    assert counts[0] == counts[1] == {"k3": k3, "ffn": 2}
    t_out = 1 if cls_only_final else 16
    for key in ("last_hidden_state", "cls", "pooler_output"):
        assert outs[0][key].shape == outs[1][key].shape
        assert torch.equal(outs[0][key], outs[1][key]), key
    assert outs[0]["last_hidden_state"].shape == (4, t_out, 128)


@pytest.mark.parametrize("cls_only_final", [True, False],
                         ids=["cls-only", "full"])
def test_flat_residual_matches_the_jax_flat_encoder(jax_kernels_interpreted,
                                                    cls_only_final):
    jenc, v, flat, _ = _flat_pair(53)
    ids, mask = _batch(np.random.default_rng(54), 4, 16)
    jout = jenc.apply(v, jnp.asarray(ids), jnp.asarray(mask),
                      method=lambda m, *a: m.bert(
                          *a, cls_only_final=cls_only_final))
    with torch.no_grad():
        out = flat.bert(_t(ids), _t(mask), cls_only_final=cls_only_final)
    for key in ("last_hidden_state", "cls", "pooler_output"):
        assert out[key].shape == jout[key].shape
        np.testing.assert_allclose(out[key].numpy(), np.asarray(jout[key]),
                                   atol=ATOL, err_msg=key)


def test_flat_residual_keeps_3d_states_on_the_viz_path():
    _, _, flat, classic = _flat_pair(55)
    ids, mask = _batch(np.random.default_rng(56), 3, 16)
    flags = {"output_hidden_states": True, "output_attentions": True}
    with torch.no_grad():
        (ef, of), (ec, oc) = (enc(_t(ids), _t(mask), **flags)
                              for enc in (flat, classic))
    assert torch.equal(ef, ec)
    for key in ("hidden_states", "attentions"):
        for a, b in zip(of[key], oc[key]):
            assert a.dim() == (3 if key == "hidden_states" else 4)
            assert torch.equal(a, b)


@pytest.mark.parametrize("flat", [False, True], ids=["classic", "flat"])
@pytest.mark.parametrize("fused_attn_out", [False, True],
                         ids=["default", "fused-attn-out"])
def test_quantized_layers_run_no_kernel_and_match_jax(
        jax_kernels_interpreted, monkeypatch, fused_attn_out, flat):
    # the JAX gates `not q8` turn K1, K2 and K3 off; the quantized
    # stream is held to the JAX quantized (and flat) encoder
    cfg = _k3_cfg(**{"text_encoder.fused_attn_out": fused_attn_out,
                     "text_encoder.quantized_inference": True,
                     "text_encoder.flat_residual": flat})
    jenc, v, tenc = _pair(cfg, seed=57)
    calls = _counting(monkeypatch)
    ids, mask = _batch(np.random.default_rng(58), 4, 16)
    ref = np.asarray(jenc.apply(v, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        got = tenc(_t(ids), _t(mask)).numpy()
    assert calls == {"k3": 0, "ffn": 0}
    np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("flags", [
    {"output_hidden_states": True}, {"output_attentions": True},
    {"output_hidden_states": True, "output_attentions": True}],
    ids=["hidden", "attentions", "both"])
@pytest.mark.parametrize("fused_attn_out", [False, True],
                         ids=["classic", "fused-attn-out"])
def test_hidden_states_and_attentions_match_jax(jax_kernels_interpreted,
                                                monkeypatch, fused_attn_out,
                                                flags):
    # the JAX layer's dispatch under the explainability flags: every layer
    # runs over all positions; K1 (or K3 -> K2) stays on for hidden
    # states, and attention maps turn K3 off but keep K1
    cfg = _k3_cfg() if fused_attn_out else _cfg(hidden=128, ffn=256)
    jenc, v, tenc = _pair(cfg, seed=17)
    ids, mask = _batch(np.random.default_rng(18), 4, 16)
    jemb, jout = jenc.apply(v, jnp.asarray(ids), jnp.asarray(mask), **flags)
    calls = {"k3": 0, "ffn": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(tbert, "fused_attn_out_ln",
                        counted("k3", tbert.fused_attn_out_ln))
    monkeypatch.setattr(tbert, "fused_ffn_ln",
                        counted("ffn", tbert.fused_ffn_ln))
    with torch.no_grad():
        emb, out = tenc(_t(ids), _t(mask), **flags)
    k3_on = fused_attn_out and not flags.get("output_attentions")
    assert calls == {"k3": 2 if k3_on else 0, "ffn": 2}
    np.testing.assert_allclose(emb.numpy(), np.asarray(jemb), atol=ATOL)
    assert out["last_hidden_state"].shape == (4, 16, 128)
    assert set(out) == set(jout)
    for key in ("hidden_states", "attentions"):
        if key not in jout:
            continue
        # hidden states: the embedding output and each layer's output;
        # attentions: each layer's [B, heads, T, T] softmax
        assert len(out[key]) == len(jout[key]) == 3 - (key == "attentions")
        for got, want in zip(out[key], jout[key]):
            assert got.shape == want.shape
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=ATOL)
    if "attentions" in out:
        rows = torch.stack(out["attentions"]).sum(-1)
        np.testing.assert_allclose(rows.numpy(), 1.0, atol=1e-6)


def _counting(monkeypatch):
    """Count the calls of the port's kernel wrappers from the BERT layer."""
    calls = {"k3": 0, "ffn": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(tbert, "fused_attn_out_ln",
                        counted("k3", tbert.fused_attn_out_ln))
    monkeypatch.setattr(tbert, "fused_ffn_ln",
                        counted("ffn", tbert.fused_ffn_ln))
    return calls


@pytest.mark.parametrize("fused_attn_out", [False, True],
                         ids=["default", "fused-attn-out"])
def test_pre_ln_classic_and_cls_only_match_jax(jax_kernels_interpreted,
                                               monkeypatch, fused_attn_out):
    # pre-LN: the JAX layer turns K1 and K3 off (`not self.pre_ln`), so
    # neither wrapper is called whatever fused_ffn / fused_attn_out say
    cfg = _cfg(hidden=128, ffn=256, **{
        "text_encoder.pre_layernorm": True,
        "text_encoder.fused_attn_out": fused_attn_out})
    jenc, v, tenc = _pair(cfg, seed=31)
    assert "final_ln" in v["params"]["bert"]
    assert tenc.bert.final_ln is not None
    calls = _counting(monkeypatch)
    ids, mask = _batch(np.random.default_rng(32), 4, 16)
    ref = np.asarray(jenc.apply(v, jnp.asarray(ids), jnp.asarray(mask)))
    _, jout = jenc.apply(v, jnp.asarray(ids), jnp.asarray(mask),
                         output_hidden_states=True)   # full forward
    with torch.no_grad():
        got = tenc(_t(ids), _t(mask)).numpy()
        full = tenc.bert(_t(ids), _t(mask), cls_only_final=False)
        cls_only = tenc.bert(_t(ids), _t(mask), cls_only_final=True)
    assert calls == {"k3": 0, "ffn": 0}
    assert got.shape == ref.shape == (4, 128)
    np.testing.assert_allclose(got, ref, atol=ATOL)
    np.testing.assert_allclose(full["last_hidden_state"].numpy(),
                               np.asarray(jout["last_hidden_state"]),
                               atol=ATOL)
    assert cls_only["last_hidden_state"].shape == (4, 1, 128)
    np.testing.assert_allclose(cls_only["cls"].numpy(),
                               np.asarray(jout["cls"]), atol=ATOL)


def test_pre_ln_packed_rows_match_jax_and_unpacked(monkeypatch):
    cfg = _cfg(**{"text_encoder.pre_layernorm": True})
    jenc, v, tenc = _pair(cfg, seed=33)
    calls = _counting(monkeypatch)
    ids, mask = _batch(np.random.default_rng(34), 7, 40, lo=10)
    pb = pack_texts(ids, mask, capacity=128)
    kw = dict(position_ids=pb.position_ids, segment_ids=pb.segment_ids,
              query_positions=pb.query_positions)
    ref = np.asarray(jenc.apply(v, jnp.asarray(pb.input_ids), None,
                                **{k: jnp.asarray(a) for k, a in kw.items()}))
    with torch.no_grad():
        got = tenc(_t(pb.input_ids), None,
                   **{k: _t(a) for k, a in kw.items()}).numpy()
        unpacked = tenc(_t(ids), _t(mask)).numpy()
    assert calls == {"k3": 0, "ffn": 0}
    docs = (pb.doc_row, pb.doc_slot)
    np.testing.assert_allclose(got[docs], ref[docs], atol=ATOL)
    np.testing.assert_allclose(got[docs], unpacked, atol=ATOL)


def test_pre_ln_hidden_states_and_attentions_match_jax(monkeypatch):
    cfg = _cfg(**{"text_encoder.pre_layernorm": True})
    jenc, v, tenc = _pair(cfg, seed=35)
    calls = _counting(monkeypatch)
    ids, mask = _batch(np.random.default_rng(36), 3, 16)
    flags = {"output_hidden_states": True, "output_attentions": True}
    jemb, jout = jenc.apply(v, jnp.asarray(ids), jnp.asarray(mask), **flags)
    with torch.no_grad():
        emb, out = tenc(_t(ids), _t(mask), **flags)
    assert calls == {"k3": 0, "ffn": 0}
    np.testing.assert_allclose(emb.numpy(), np.asarray(jemb), atol=ATOL)
    np.testing.assert_allclose(out["last_hidden_state"].numpy(),
                               np.asarray(jout["last_hidden_state"]),
                               atol=ATOL)
    for key in ("hidden_states", "attentions"):
        assert len(out[key]) == len(jout[key])
        for got, want in zip(out[key], jout[key]):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=ATOL)


def test_pre_ln_adds_only_the_final_layer_norm_to_the_tree():
    pre = tbert.create_text_encoder(
        _cfg(**{"text_encoder.pre_layernorm": True}).text_encoder, "cpu")
    post = tbert.create_text_encoder(_cfg().text_encoder, "cpu")
    extra = set(pre.state_dict()) - set(post.state_dict())
    assert extra == {"bert.final_ln.weight", "bert.final_ln.bias"}
    assert set(post.state_dict()) <= set(pre.state_dict())
