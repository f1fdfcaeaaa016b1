"""The f32 path of the torch package's fused BERT sublayers: which CUDA
kernel a call takes (`kernels/ffn.py::ffn_route`,
`kernels/attn_out.py::attn_out_route`), the f32 FFN kernel's launch plan
and its split-F emulation against the JAX package's Pallas kernel run in
interpret mode, and the dispatch of an f32 eval-mode model (default and
`fused_attn_out`) against the JAX layer's Pallas dispatch: the same
calls, in the same order, with the same dtypes. The f32 CUDA kernels
themselves are checked against the plain versions on the card by
tests/test_torch_gpu.py and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_rare_disease_tpu.config import resolve_config
from multimodal_rare_disease_tpu.models.bert import create_text_encoder
from multimodal_rare_disease_tpu.ops.pallas import attn_out as jax_ao_mod
from multimodal_rare_disease_tpu.ops.pallas import ffn as jax_ffn_mod
from multimodal_rare_disease_tpu_torch.kernels import attn_out as k3
from multimodal_rare_disease_tpu_torch.kernels import ffn as k1
from multimodal_rare_disease_tpu_torch.models import bert as tbert
from multimodal_rare_disease_tpu_torch.models.convert import (
    state_dict_from_jax,
)

F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16
BF, FP, PLAIN = k1.ROUTE_BF16, k1.ROUTE_F32, k1.ROUTE_PLAIN

# (x dtype, vector dtypes, m, H, F, input_ln) -> route. Vectors: b1, b2,
# gamma, beta, and for K1 the LN0 pair.
_FFN_ROUTES = [
    # f32 and bf16 at BERT-base width go to their kernels, any m >= 1
    (F32, [F32] * 6, 16384, 768, 3072, True, FP),
    (F32, [F32] * 4, 16384, 768, 3072, False, FP),
    (F32, [F32] * 6, 1, 768, 3072, True, FP),
    (F32, [F32] * 4, 37, 768, 3072, False, FP),
    (F32, [F32] * 6, 1024, 768, 3072, True, FP),
    (BF16, [BF16] * 6, 16384, 768, 3072, True, BF),
    (BF16, [F32] * 6, 37, 768, 3072, True, BF),     # K1 bf16 reads f32 too
    (BF16, [BF16] * 4, 1, 768, 3072, False, BF),
    # mixed dtypes take the counted plain path
    (BF16, [F32] * 4, 64, 768, 3072, False, PLAIN),  # K2 bf16: bf16 only
    (F32, [BF16] * 6, 64, 768, 3072, True, PLAIN),
    (F32, [F32] * 5 + [BF16], 64, 768, 3072, True, PLAIN),
    (F32, [BF16] * 4, 64, 768, 3072, False, PLAIN),
    # the compact BERTs' 512 and 128, BERT-large's 1,024, MiniLM's 384, 640
    # (cases 20-21) and the widths above 1,024 (cases 25-26) take their
    # kernels; widths outside KERNEL_WIDTHS (cases 23-24), F off the
    # chunk, other dtypes and no rows do not
    (F32, [F32] * 6, 64, 512, 3072, True, FP),
    (F32, [F32] * 4, 64, 128, 256, False, FP),
    (BF16, [BF16] * 6, 64, 1024, 4096, True, BF),
    (F32, [F32] * 6, 64, 768, 3000, True, PLAIN),
    (F32, [F32] * 6, 64, 768, 3072 - 64, True, PLAIN),  # f32: tiles of 128
    (BF16, [BF16] * 6, 64, 768, 3072 - 64, True, BF),   # bf16: chunks of 64
    (F16, [F16] * 6, 64, 768, 3072, True, PLAIN),
    (F32, [F32] * 6, 0, 768, 3072, True, PLAIN),
    (F32, [F32] * 6, 64, 384, 1536, True, FP),
    (BF16, [BF16] * 4, 64, 640, 2560, False, BF),
    (BF16, [BF16] * 6, 64, 256, 1024, True, BF),
    (F32, [F32] * 6, 64, 1664, 6656, True, PLAIN),
    (BF16, [BF16] * 4, 64, 2048, 8192, False, PLAIN),
    (F32, [F32] * 6, 64, 1152, 4608, True, FP),
    (BF16, [BF16] * 4, 64, 1408, 5632, False, BF),
]


@pytest.mark.parametrize("x,vecs,m,h,f,input_ln,want", _FFN_ROUTES,
                         ids=[f"case{i}" for i in range(len(_FFN_ROUTES))])
def test_ffn_route(x, vecs, m, h, f, input_ln, want):
    assert k1.ffn_route(x, vecs, m, h, f, input_ln) == want
    assert k1.ffn_ln_fusible(m, h, f, x) == (
        want != PLAIN or x in (BF16, F32) and m >= 1
        and h in (128, 256, 384, 512, 640, 768, 896, 1024, 1152, 1280,
                  1408, 1536)
        and f % (64 if x == BF16 else 128) == 0)


# (ctx dtype, x dtype, vector dtypes, m, H) -> route
_ATTN_ROUTES = [
    (F32, F32, [F32] * 3, 16384, 768, FP),
    (F32, F32, [F32] * 3, 1, 768, FP),
    (F32, F32, [F32] * 3, 37, 768, FP),
    (BF16, BF16, [BF16] * 3, 16384, 768, BF),
    (BF16, BF16, [BF16] * 3, 1, 768, BF),
    (BF16, BF16, [F32] * 3, 64, 768, PLAIN),
    (F32, F32, [BF16] * 3, 64, 768, PLAIN),
    (F32, BF16, [F32] * 3, 64, 768, PLAIN),
    (BF16, F32, [BF16] * 3, 64, 768, PLAIN),
    (F32, F32, [F32] * 3, 64, 512, FP),
    (BF16, BF16, [BF16] * 3, 64, 128, BF),
    (F16, F16, [F16] * 3, 64, 768, PLAIN),
    (F32, F32, [F32] * 3, 0, 768, PLAIN),
    (F32, F32, [F32] * 3, 64, 384, FP),
    (BF16, BF16, [BF16] * 3, 64, 896, BF),
    (F32, F32, [F32] * 3, 64, 1664, PLAIN),
    (BF16, BF16, [BF16] * 3, 64, 2048, PLAIN),
    (F32, F32, [F32] * 3, 64, 1280, FP),
    (BF16, BF16, [BF16] * 3, 64, 1536, BF),
]


@pytest.mark.parametrize("ctx,x,vecs,m,h,want", _ATTN_ROUTES,
                         ids=[f"case{i}" for i in range(len(_ATTN_ROUTES))])
def test_attn_out_route(ctx, x, vecs, m, h, want):
    assert k3.attn_out_route(ctx, x, vecs, m, h) == want


# (m, row tiles, slices, k-tiles per slice) of the f32 FFN kernels on a
# card with 132 SMs at F = 3072 (row tiles of 128; the second product's 6
# column tiles of 128 and 96 k-tiles of 32, at least 8 per slice): the
# single request (1, then its length bucket 64), a ragged tile, the
# CLS-only last layer at B=256 (48 output tiles x 8 slices), a mid size
# and the packed batch, whose output tiles fill the card without a split
_F32_PLANS = [(1, 1, 12, 8), (37, 1, 12, 8), (64, 1, 12, 8),
              (1024, 8, 8, 12), (4096, 32, 1, 96), (16384, 128, 1, 96)]


@pytest.mark.parametrize("m,tiles,slices,k_tiles", _F32_PLANS,
                         ids=[f"m{p[0]}" for p in _F32_PLANS])
def test_f32_plan_at_the_main_path_row_counts(m, tiles, slices, k_tiles):
    plan = k1.ffn_plan_f32(m, 3072, 132)
    assert (plan.tiles, plan.slices, plan.k_tiles) == (tiles, slices, k_tiles)
    # the TF32 planes of x, the weights and h, and one partial per slice
    assert plan.scratch == (2 * m * 768 + 4 * 3072 * 768 + 2 * m * 3072
                            + slices * m * 768)


@pytest.mark.parametrize("input_ln", [True, False], ids=["k1", "k2"])
def test_f32_split_emulation_matches_interpreted_jax(input_ln):
    # the f32 kernels' split: H = 768, F = 768 in 24 k-tiles of 32, three
    # slices of 8, as ffn_plan_f32 gives a single request
    rng = np.random.default_rng(21)
    m, h, f = 32, 768, 768

    def a(shape, scale, offset=0.0):
        return (offset + rng.normal(size=shape) * scale).astype(np.float32)

    z = a((m, h), 0.5)
    args = (a((h, f), 0.05), a((f,), 0.01), a((f, h), 0.05), a((h,), 0.01),
            a((h,), 0.05, 1.0), a((h,), 0.01))
    g0, o0 = a((h,), 0.05, 1.0), a((h,), 0.01)
    assert k1.ffn_plan_f32(m, f, 132).slices == 3
    pre = (dict(pre_gamma=jnp.asarray(g0), pre_beta=jnp.asarray(o0))
           if input_ln else {})
    ref = np.asarray(jax_ffn_mod.fused_ffn_ln(
        jnp.asarray(z), *map(jnp.asarray, args), interpret=True, **pre))
    ln0 = (dict(pre_gamma=torch.from_numpy(g0), pre_beta=torch.from_numpy(o0))
           if input_ln else {})
    got = k1.ffn_ln_plain(torch.from_numpy(z),
                          *map(torch.from_numpy, args), input_ln=input_ln,
                          slices=3, **ln0).numpy()
    # f32: the Pallas kernel's erf polynomial (|err| <= 1.5e-7) against
    # exact erf, and summation order; the JAX kernel test's bound
    np.testing.assert_allclose(got, ref, atol=5e-5)


def _cfg(**over):
    # H=128 / F=256 and M = B*T, and the B CLS rows, multiples of 16 and
    # >= 32: inside the JAX kernels' gates, so the JAX layer dispatches
    # to its (interpreted) Pallas kernels in every layer
    return resolve_config("default", {
        "text_encoder.num_layers": 2, "text_encoder.num_heads": 4,
        "text_encoder.hidden_size": 128,
        "text_encoder.intermediate_size": 256,
        "text_encoder.vocab_size": 120,
        "text_encoder.max_position_embeddings": 128,
        "training.compute_dtype": "float32", **over})


def _recorder(calls, kind, fn, x_index, vec_keys):
    """Wrap `fn`, recording (kind, rows, x dtype, vector dtypes) per call;
    vec_keys name the keyword arguments or positions of the vectors."""
    def rec(*args, **kw):
        x = args[x_index]
        vecs = [kw[k] if isinstance(k, str) else args[k] for k in vec_keys
                if (k in kw if isinstance(k, str) else k < len(args))]
        vecs = [v for v in vecs if v is not None]
        calls.append((kind, int(x.shape[0]), str(x.dtype).split(".")[-1],
                      tuple(str(v.dtype).split(".")[-1] for v in vecs)))
        return fn(*args, **kw)
    return rec


def _ffn_kind(kw):
    return "K1" if kw.get("pre_gamma") is not None else "K2"


@pytest.mark.parametrize("fused_attn_out", [False, True],
                         ids=["default", "fused_attn_out"])
def test_f32_model_dispatch_matches_jax(monkeypatch, fused_attn_out):
    cfg = _cfg(**{"text_encoder.fused_attn_out": fused_attn_out})
    jenc = create_text_encoder(cfg.text_encoder, dtype=jnp.float32)
    ones = jnp.ones((1, 16), jnp.int32)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + np.random.default_rng(31).normal(
            size=a.shape).astype(np.float32) * 0.05,
        jenc.init(jax.random.key(31), ones, ones)["params"])
    tenc = tbert.create_text_encoder(cfg.text_encoder, "cpu")
    tenc.load_state_dict(state_dict_from_jax(params), strict=True)
    tenc.eval()
    assert all(p.dtype == torch.float32 for p in tenc.parameters())

    b, t = 32, 8
    rng = np.random.default_rng(32)
    ids = rng.integers(1, 120, size=(b, t)).astype(np.int32)
    mask = np.ones((b, t), np.int32)
    mask[::3, t // 2:] = 0

    jax_calls, torch_calls = [], []
    monkeypatch.setattr(jax_ffn_mod, "FORCE_INTERPRET", True)
    monkeypatch.setattr(jax_ao_mod, "FORCE_INTERPRET", True)
    jffn, jao = jax_ffn_mod.fused_ffn_ln, jax_ao_mod.fused_attn_out_ln

    def jax_ffn(*a, **kw):
        return _recorder(jax_calls, _ffn_kind(kw), jffn, 0,
                         (2, 4, 5, 6, "pre_gamma", "pre_beta"))(*a, **kw)

    def torch_ffn(*a, **kw):
        return _recorder(torch_calls, _ffn_kind(kw), tffn, 0,
                         (2, 4, 5, 6, "pre_gamma", "pre_beta"))(*a, **kw)

    tffn = tbert.fused_ffn_ln
    monkeypatch.setattr(jax_ffn_mod, "fused_ffn_ln", jax_ffn)
    monkeypatch.setattr(jax_ao_mod, "fused_attn_out_ln", _recorder(
        jax_calls, "K3", jao, 0, (3, 4, 5)))
    monkeypatch.setattr(tbert, "fused_ffn_ln", torch_ffn)
    monkeypatch.setattr(tbert, "fused_attn_out_ln", _recorder(
        torch_calls, "K3", tbert.fused_attn_out_ln, 0, (3, 4, 5)))

    ref = np.asarray(jenc.apply({"params": params}, jnp.asarray(ids),
                                jnp.asarray(mask)))
    with torch.no_grad():
        got = tenc(torch.from_numpy(ids).long(),
                   torch.from_numpy(mask).long()).numpy()

    # the JAX dispatch: K1 in every layer, or K3 then K2 in every layer but
    # the CLS-only last one, which takes K1 on the B CLS rows; all in f32
    f32 = "float32"
    if fused_attn_out:
        want = [("K3", b * t, f32, (f32,) * 3), ("K2", b * t, f32, (f32,) * 4),
                ("K1", b, f32, (f32,) * 6)]
    else:
        want = [("K1", b * t, f32, (f32,) * 6), ("K1", b, f32, (f32,) * 6)]
    assert jax_calls == want
    assert torch_calls == jax_calls
    # at BERT-base width, the same calls take the f32 kernels on the card
    for kind, m, _, vecs in torch_calls:
        dts = [getattr(torch, v) for v in vecs]
        route = (k3.attn_out_route(F32, F32, dts, m, 768) if kind == "K3"
                 else k1.ffn_route(F32, dts, m, 768, 3072, kind == "K1"))
        assert route == k1.ROUTE_F32
    # the numbers, as tests/test_torch_bert.py holds them
    np.testing.assert_allclose(got, ref, atol=1e-5)
