"""K1, K2 and K3 of the torch package at BERT-large width (H = 1,024,
F = 4,096, 16 heads of 64): the plain versions against the JAX package's
Pallas kernels run in interpret mode, the gates, the launch plans and
scratch sizes of the bf16 and f32 kernels built for that width, the
device rule on the CPU, and the port's classifier at that width against
the JAX model on the same weights, in f32. The CUDA kernels themselves
are checked against the plain versions on the card by
tests/test_torch_gpu.py and chip_smoke.py (phase 17)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_rare_disease_tpu.config import resolve_config
from multimodal_rare_disease_tpu.models import create_model as jax_model
from multimodal_rare_disease_tpu.ops.pallas import attn_out as jax_ao
from multimodal_rare_disease_tpu.ops.pallas import ffn as jax_ffn_mod
from multimodal_rare_disease_tpu_torch.kernels import attn_out as k3
from multimodal_rare_disease_tpu_torch.kernels import ffn as k1
from multimodal_rare_disease_tpu_torch.models.classifier import create_model
from multimodal_rare_disease_tpu_torch.models.convert import (
    state_dict_from_jax,
)

H, F = 1024, 4096
BF, F32 = torch.bfloat16, torch.float32
# f32: the Pallas kernel's erf polynomial (|err| <= 1.5e-7) against exact
# erf, and summation order; bf16: roundings of x, the GELU chunk and y from
# f32 sums taken in another order, one bf16 ulp apart at most. The JAX
# kernel tests' bounds (tests/test_ffn_kernel.py, test_attn_out_kernel.py)
ATOL = {"float32": 5e-5, "bfloat16": 5e-2}


def _a(rng, shape, scale, offset=0.0):
    return (offset + rng.normal(size=shape) * scale).astype(np.float32)


def _ffn_args(m, seed):
    rng = np.random.default_rng(seed)
    z = _a(rng, (m, H), 0.5)
    args = (_a(rng, (H, F), 0.05), _a(rng, (F,), 0.01),
            _a(rng, (F, H), 0.05), _a(rng, (H,), 0.01),
            _a(rng, (H,), 0.05, 1.0), _a(rng, (H,), 0.01))
    return z, args, (_a(rng, (H,), 0.05, 1.0), _a(rng, (H,), 0.01))


# the JAX gate needs M % 16 == 0: a full 64-row tile and a ragged 48
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [64, 48])
@pytest.mark.parametrize("input_ln", [True, False], ids=["k1", "k2"])
def test_ffn_plain_matches_interpreted_jax(input_ln, m, dtype):
    z, args, (g0, o0) = _ffn_args(m, 100 + m + input_ln)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    pre = (dict(pre_gamma=jnp.asarray(g0), pre_beta=jnp.asarray(o0))
           if input_ln else {})
    ref = np.asarray(jax_ffn_mod.fused_ffn_ln(
        jnp.asarray(z, jdt), *map(jnp.asarray, args), interpret=True,
        **pre), np.float32)
    ln0 = (dict(pre_gamma=torch.from_numpy(g0), pre_beta=torch.from_numpy(o0))
           if input_ln else {})
    got = k1.ffn_ln_plain(torch.from_numpy(z).to(tdt),
                          *map(torch.from_numpy, args), input_ln=input_ln,
                          **ln0)
    assert got.dtype == tdt and got.shape == (m, H)
    np.testing.assert_allclose(got.float().numpy(), ref, atol=ATOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [64, 48])
def test_attn_out_plain_matches_interpreted_jax(m, dtype):
    rng = np.random.default_rng(200 + m)
    ctx, x = _a(rng, (m, H), 0.5), _a(rng, (m, H), 0.5)
    args = (_a(rng, (H, H), 0.05), _a(rng, (H,), 0.01),
            _a(rng, (H,), 0.05, 1.0), _a(rng, (H,), 0.01))
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ref = np.asarray(jax_ao.fused_attn_out_ln(
        jnp.asarray(ctx, jdt), jnp.asarray(x, jdt), *map(jnp.asarray, args),
        interpret=True), np.float32)
    got = k3.attn_out_ln_plain(torch.from_numpy(ctx).to(tdt),
                               torch.from_numpy(x).to(tdt),
                               *map(torch.from_numpy, args))
    assert got.dtype == tdt and got.shape == (m, H)
    np.testing.assert_allclose(got.float().numpy(), ref, atol=ATOL[dtype])


def test_split_emulations_match_interpreted_jax_f32():
    # the kernels' split sums at this width: F in 4 slices (the bf16 FFN at
    # the 1,024 CLS rows) and the product's k in 4 slices (K3-f32 at a
    # single request)
    z, args, (g0, o0) = _ffn_args(64, 7)
    ref = np.asarray(jax_ffn_mod.fused_ffn_ln(
        jnp.asarray(z), *map(jnp.asarray, args), interpret=True,
        pre_gamma=jnp.asarray(g0), pre_beta=jnp.asarray(o0)))
    got = k1.ffn_ln_plain(torch.from_numpy(z), *map(torch.from_numpy, args),
                          input_ln=True, pre_gamma=torch.from_numpy(g0),
                          pre_beta=torch.from_numpy(o0), slices=4).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL["float32"])
    rng = np.random.default_rng(8)
    ctx, x = _a(rng, (64, H), 0.5), _a(rng, (64, H), 0.5)
    a3 = (_a(rng, (H, H), 0.05), _a(rng, (H,), 0.01),
          _a(rng, (H,), 0.05, 1.0), _a(rng, (H,), 0.01))
    ref = np.asarray(jax_ao.fused_attn_out_ln(
        jnp.asarray(ctx), jnp.asarray(x), *map(jnp.asarray, a3),
        interpret=True))
    got = k3.attn_out_ln_plain(torch.from_numpy(ctx), torch.from_numpy(x),
                               *map(torch.from_numpy, a3), slices=4).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL["float32"])


@pytest.mark.parametrize("dtype", [BF, F32], ids=["bf16", "f32"])
def test_gates_take_the_built_widths(dtype):
    rows = (1, 37, 64, 1024, 16384, 16385)
    assert k1.KERNEL_WIDTHS == (768, 1024)
    assert all(k1.ffn_ln_fusible(m, H, F, dtype) for m in rows)
    assert all(k3.attn_out_ln_fusible(m, H, dtype) for m in rows)
    assert not k1.ffn_ln_fusible(0, H, F, dtype)
    assert not k3.attn_out_ln_fusible(0, H, dtype)
    # widths the build has no kernel for stay on the counted plain version
    for h in (512, 896, 1280):
        assert not k1.ffn_ln_fusible(64, h, 4 * h, dtype)
        assert not k3.attn_out_ln_fusible(64, h, dtype)
        assert k1.ffn_route(dtype, [dtype] * 6, 64, h, 4 * h,
                            True) == k1.ROUTE_PLAIN
    route = k1.ROUTE_BF16 if dtype == BF else k1.ROUTE_F32
    assert k1.ffn_route(dtype, [dtype] * 6, 16384, H, F, True) == route
    assert k1.ffn_route(dtype, [dtype] * 4, 16384, H, F, False) == route
    assert k3.attn_out_route(dtype, dtype, [dtype] * 3, 16384, H) == route
    # mixed dtypes take the counted plain path, as at 768
    other = F32 if dtype == BF else BF
    assert k3.attn_out_route(dtype, dtype, [other] * 3, 64,
                             H) == k3.ROUTE_PLAIN


def test_wrappers_refuse_a_width_the_build_lacks():
    # an entry for a width outside the built set raises before any launch
    class Lib:
        mrd_ffn_pre_ln_bf16 = mrd_ffn_pre_ln_bf16_h1024 = object()

    assert k1.entry(Lib, "mrd_ffn_pre_ln_bf16", 768) \
        is Lib.mrd_ffn_pre_ln_bf16
    assert k1.entry(Lib, "mrd_ffn_pre_ln_bf16", 1024) \
        is Lib.mrd_ffn_pre_ln_bf16_h1024
    with pytest.raises(ValueError, match="no kernel is built"):
        k1.entry(Lib, "mrd_ffn_pre_ln_bf16", 512)


# (m, row tiles, slices, chunks per slice) of the bf16 kernels at H =
# 1,024 on a card with 132 SMs: each row tile is two blocks (column groups
# of 512), so the split starts below 66 row tiles. FFN: 64 chunks of F;
# K3: 16 k chunks. The single request (1, then its length bucket 64), the
# 1,024 CLS rows, a mid size (128 blocks, just short of the card: the
# rule's waves x chunks is 63 x 1 against 1 x 64 for the FFN, a tie for
# K3) and the packed batch
_PLANS = [(1, 1, 64, 1, 16, 1), (64, 1, 64, 1, 16, 1),
          (1024, 16, 4, 16, 4, 4), (4096, 64, 64, 1, 1, 16),
          (16384, 256, 1, 64, 1, 16)]


@pytest.mark.parametrize("m,tiles,slices,chunks,k3_slices,k3_chunks",
                         _PLANS, ids=[f"m{p[0]}" for p in _PLANS])
def test_bf16_plans(m, tiles, slices, chunks, k3_slices, k3_chunks):
    plan = k1.ffn_plan(m, F, 132, H)
    assert (plan.tiles, plan.slices, plan.chunks) == (tiles, slices, chunks)
    # each pair applies the LayerNorm itself (its row statistics over
    # distributed shared memory) unless the k loop is split
    assert plan.scratch == (None if slices == 1 else (slices, m, H))
    plan3 = k3.attn_out_plan(m, 132, H)
    assert (plan3.tiles, plan3.slices, plan3.chunks) == (tiles, k3_slices,
                                                        k3_chunks)
    assert plan3.scratch == (None if k3_slices == 1 else (k3_slices, m, H))
    # BERT-base's plans are those of a single block per row tile
    assert k1.ffn_plan(m, 3072, 132) == k1.ffn_plan(m, 3072, 132, 768)


# (m, row tiles, FFN slices, k-tiles, K3 slices, k-tiles) of the f32
# GEMMs at H = 1,024 (8 column tiles of 128; the FFN's second product 128
# k-tiles, K3's 32, at least 8 per slice)
_PLANS_F32 = [(1, 1, 16, 8, 4, 8), (64, 1, 16, 8, 4, 8),
              (1024, 8, 2, 64, 2, 16), (16384, 128, 1, 128, 1, 32),
              (16385, 129, 1, 128, 1, 32)]


@pytest.mark.parametrize("m,tiles,slices,k_tiles,k3_slices,k3_k_tiles",
                         _PLANS_F32, ids=[f"m{p[0]}" for p in _PLANS_F32])
def test_f32_plans_and_scratch(m, tiles, slices, k_tiles, k3_slices,
                               k3_k_tiles):
    plan = k1.ffn_plan_f32(m, F, 132, H)
    assert (plan.tiles, plan.slices, plan.k_tiles) == (tiles, slices,
                                                        k_tiles)
    # the TF32 planes of x, the weights and h, and one partial per slice
    assert plan.scratch == (2 * m * H + 4 * F * H + 2 * m * F
                            + slices * m * H)
    plan3 = k3.attn_out_plan_f32(m, 132, H)
    assert (plan3.tiles, plan3.slices, plan3.k_tiles) == (tiles, k3_slices,
                                                           k3_k_tiles)
    assert plan3.scratch == 2 * H * H + k3_slices * m * H


def test_f32_scratch_at_the_packed_batch():
    # 805,306,368 bytes per K1-f32 / K2-f32 call at M = 16,384 (PERF.md),
    # 75.5 MB per K3-f32 call
    assert k1.ffn_plan_f32(16384, F, 132, H).scratch * 4 == 805_306_368
    assert k3.attn_out_plan_f32(16384, 132, H).scratch * 4 == 75_497_472


@pytest.mark.parametrize("input_ln", [True, False], ids=["k1", "k2"])
def test_cpu_tensors_take_the_plain_path_and_launch_nothing(input_ln):
    z, args, (g0, o0) = _ffn_args(37, 3)
    t = [torch.from_numpy(a).to(BF) for a in args]
    ln0 = (dict(pre_gamma=torch.from_numpy(g0), pre_beta=torch.from_numpy(o0))
           if input_ln else {})
    names = [n for n in dir(k1) if n.startswith("LAUNCHES")] + [
        "PLAIN_ON_CUDA"]
    counts = [getattr(k1, n) for n in names] + [k3.LAUNCHES_1024,
                                                k3.LAUNCHES_F32_1024]
    zb = torch.from_numpy(z).to(BF)
    got = k1.fused_ffn_ln(zb, *t, **ln0)
    assert torch.equal(got, k1.ffn_ln_plain(zb, *t, input_ln=input_ln,
                                            **ln0))
    a3 = (zb, zb, t[0][:, :H], t[3], t[4], t[5])  # wo: a [H, H] view
    assert torch.equal(k3.fused_attn_out_ln(*a3), k3.attn_out_ln_plain(*a3))
    assert [getattr(k1, n) for n in names] + [
        k3.LAUNCHES_1024, k3.LAUNCHES_F32_1024] == counts


# ---- the slice: the classifier at BERT-large width, 2 layers

def _cfg(**over):
    return resolve_config("default", {
        "text_encoder.num_layers": 2, "text_encoder.num_heads": 16,
        "text_encoder.hidden_size": H, "text_encoder.intermediate_size": F,
        "text_encoder.max_position_embeddings": 512,
        "cnn_encoder.stage_sizes": (1, 1, 1, 1),
        "data.image_size": 32, "training.compute_dtype": "float32", **over})


def _inputs(seed, n, t=48, lo=12):
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(n, 32, 32, 3)).astype(np.float32)
    lens = rng.integers(lo, t + 1, size=n)
    ids = np.zeros((n, t), np.int32)
    mask = np.zeros((n, t), np.int32)
    for i, k in enumerate(lens):
        ids[i, :k] = rng.integers(1, 28996, size=k)
        mask[i, :k] = 1
    return images, ids, mask


@pytest.mark.parametrize("fused_attn_out", [False, True],
                         ids=["default", "fused_attn_out"])
def test_bert_large_classifier_matches_jax(monkeypatch, fused_attn_out):
    """The port's MultimodalClassifier at BERT-large width (H = 1,024, 16
    heads, F = 4,096; the vocabulary of BERT-large-cased, 28,996; 2
    layers, ResNet stages (1, 1, 1, 1)) against the JAX model on the same
    weights through `state_dict_from_jax`, f32 on the CPU: the default
    layer (K1's plain version here) and the fused-sublayer one (K3 then
    K2), whose JAX kernels run in interpret mode."""
    monkeypatch.setattr(jax_ao, "FORCE_INTERPRET", True)
    monkeypatch.setattr(jax_ffn_mod, "FORCE_INTERPRET", True)
    cfg = _cfg(**{"text_encoder.fused_attn_out": fused_attn_out})
    assert cfg.text_encoder.vocab_size == 28996
    jm = jax_model(cfg, mode="multimodal")
    images, ids, mask = _inputs(0, 1)
    v = jm.init(jax.random.key(0), jnp.asarray(images), jnp.asarray(ids),
                jnp.asarray(mask), train=False)
    rng = np.random.default_rng(1)

    def leaf(path, x):
        x = np.asarray(x)
        if path[-1].key == "var":
            return (1.0 + 0.2 * np.abs(rng.normal(size=x.shape))).astype(
                np.float32)
        return (x + 0.02 * rng.normal(size=x.shape)).astype(np.float32)

    v = jax.tree_util.tree_map_with_path(leaf, v)
    tm = create_model(cfg, device="cpu", seed=None)
    tm.load_state_dict(state_dict_from_jax(v["params"], v["batch_stats"]),
                       strict=True)
    assert tm.text_encoder.bert.layer0.hidden_size == H
    images, ids, mask = _inputs(2, 4)
    ref = jm.apply(v, jnp.asarray(images), jnp.asarray(ids),
                   jnp.asarray(mask), train=False)
    with torch.no_grad():
        got = tm(torch.from_numpy(images), torch.from_numpy(ids).long(),
                 torch.from_numpy(mask))
    # f32 roundoff of the same sums in another order (the bound of
    # tests/test_torch_classifier.py); probabilities at its ATOL
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(ref["logits"]), atol=1e-4)
    np.testing.assert_allclose(got["probs"].numpy(),
                               np.asarray(ref["probs"]), atol=1e-5)
    assert (got["probs"].numpy().argmax(1)
            == np.asarray(ref["probs"]).argmax(1)).all()
