"""K1, K2 and K3 of the torch package at the widths built besides
BERT-base's 768: BERT-large (H = 1,024, F = 4,096, 16 heads of 64) and
google-research/bert's compact BERT-Medium (H = 512, F = 2,048, 8 heads),
BERT-Mini (256, 1,024, 4) and BERT-Tiny (128, 512, 2). Each test runs at
every one of these widths: the plain versions against the JAX package's
Pallas kernels run in interpret mode, the gates, the launch plans and
scratch sizes of the bf16 and f32 kernels built for the width, the
device rule on the CPU, and the port's classifier at the width against
the JAX model on the same weights, in f32. The CUDA kernels themselves
are checked against the plain versions on the card by
tests/test_torch_gpu.py and chip_smoke.py (phases 17 and 18)."""

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
from multimodal_rare_disease_tpu_torch.kernels import build
from multimodal_rare_disease_tpu_torch.kernels import ffn as k1
from multimodal_rare_disease_tpu_torch.models.classifier import create_model
from multimodal_rare_disease_tpu_torch.models.convert import (
    state_dict_from_jax,
)

BF, F32 = torch.bfloat16, torch.float32
# hidden width -> (heads of 64, intermediate width F = 4H): BERT-large and
# the compact BERT-Medium, -Mini and -Tiny
WIDTHS = {1024: (16, 4096), 512: (8, 2048), 256: (4, 1024), 128: (2, 512)}
by_width = pytest.mark.parametrize("h", list(WIDTHS),
                                   ids=[f"h{h}" for h in WIDTHS])
# f32: the Pallas kernel's erf polynomial (|err| <= 1.5e-7) against exact
# erf, and summation order; bf16: roundings of x, the GELU chunk and y from
# f32 sums taken in another order, one bf16 ulp apart at most. The JAX
# kernel tests' bounds (tests/test_ffn_kernel.py, test_attn_out_kernel.py)
ATOL = {"float32": 5e-5, "bfloat16": 5e-2}


def _a(rng, shape, scale, offset=0.0):
    return (offset + rng.normal(size=shape) * scale).astype(np.float32)


def _ffn_args(m, seed, h):
    f = WIDTHS[h][1]
    rng = np.random.default_rng(seed)
    z = _a(rng, (m, h), 0.5)
    args = (_a(rng, (h, f), 0.05), _a(rng, (f,), 0.01),
            _a(rng, (f, h), 0.05), _a(rng, (h,), 0.01),
            _a(rng, (h,), 0.05, 1.0), _a(rng, (h,), 0.01))
    return z, args, (_a(rng, (h,), 0.05, 1.0), _a(rng, (h,), 0.01))


def _attn_args(m, seed, h):
    rng = np.random.default_rng(seed)
    ctx, x = _a(rng, (m, h), 0.5), _a(rng, (m, h), 0.5)
    return ctx, x, (_a(rng, (h, h), 0.05), _a(rng, (h,), 0.01),
                    _a(rng, (h,), 0.05, 1.0), _a(rng, (h,), 0.01))


# the JAX gate needs M % 16 == 0: a full 64-row tile and a ragged 48
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [64, 48])
@pytest.mark.parametrize("input_ln", [True, False], ids=["k1", "k2"])
@by_width
def test_ffn_plain_matches_interpreted_jax(h, input_ln, m, dtype):
    z, args, (g0, o0) = _ffn_args(m, 100 + m + input_ln, h)
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
    assert got.dtype == tdt and got.shape == (m, h)
    np.testing.assert_allclose(got.float().numpy(), ref, atol=ATOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [64, 48])
@by_width
def test_attn_out_plain_matches_interpreted_jax(h, m, dtype):
    ctx, x, args = _attn_args(m, 200 + m, h)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ref = np.asarray(jax_ao.fused_attn_out_ln(
        jnp.asarray(ctx, jdt), jnp.asarray(x, jdt), *map(jnp.asarray, args),
        interpret=True), np.float32)
    got = k3.attn_out_ln_plain(torch.from_numpy(ctx).to(tdt),
                               torch.from_numpy(x).to(tdt),
                               *map(torch.from_numpy, args))
    assert got.dtype == tdt and got.shape == (m, h)
    np.testing.assert_allclose(got.float().numpy(), ref, atol=ATOL[dtype])


# the kernels' split sums at each width: F in the bf16 FFN's slices at the
# 1,024 CLS rows, and the product's k in the slices of K3 at a single
# request (bf16; at 1,024 K3-f32's 4)
_SPLITS = {1024: (4, 4), 512: (8, 8), 256: (8, 4), 128: (8, 2)}


@by_width
def test_split_emulations_match_interpreted_jax_f32(h):
    ffn_slices, k3_slices = _SPLITS[h]
    z, args, (g0, o0) = _ffn_args(64, 7, h)
    ref = np.asarray(jax_ffn_mod.fused_ffn_ln(
        jnp.asarray(z), *map(jnp.asarray, args), interpret=True,
        pre_gamma=jnp.asarray(g0), pre_beta=jnp.asarray(o0)))
    got = k1.ffn_ln_plain(torch.from_numpy(z), *map(torch.from_numpy, args),
                          input_ln=True, pre_gamma=torch.from_numpy(g0),
                          pre_beta=torch.from_numpy(o0),
                          slices=ffn_slices).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL["float32"])
    ctx, x, a3 = _attn_args(64, 8, h)
    ref = np.asarray(jax_ao.fused_attn_out_ln(
        jnp.asarray(ctx), jnp.asarray(x), *map(jnp.asarray, a3),
        interpret=True))
    got = k3.attn_out_ln_plain(torch.from_numpy(ctx), torch.from_numpy(x),
                               *map(torch.from_numpy, a3),
                               slices=k3_slices).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL["float32"])


@pytest.mark.parametrize("dtype", [BF, F32], ids=["bf16", "f32"])
@by_width
def test_gates_take_the_built_widths(h, dtype):
    f = WIDTHS[h][1]
    rows = (1, 37, 64, 1024, 16384, 16385)
    assert k1.KERNEL_WIDTHS == (128, 256, 512, 768, 1024) \
        == build.ROW_WIDTHS
    assert all(k1.ffn_ln_fusible(m, h, f, dtype) for m in rows)
    assert all(k3.attn_out_ln_fusible(m, h, dtype) for m in rows)
    assert not k1.ffn_ln_fusible(0, h, f, dtype)
    assert not k3.attn_out_ln_fusible(0, h, dtype)
    # widths the build has no kernel for stay on the counted plain version
    for w in (384, 640, 896, 1280):
        assert not k1.ffn_ln_fusible(64, w, 4 * w, dtype)
        assert not k3.attn_out_ln_fusible(64, w, dtype)
        assert k1.ffn_route(dtype, [dtype] * 6, 64, w, 4 * w,
                            True) == k1.ROUTE_PLAIN
    route = k1.ROUTE_BF16 if dtype == BF else k1.ROUTE_F32
    assert k1.ffn_route(dtype, [dtype] * 6, 16384, h, f, True) == route
    assert k1.ffn_route(dtype, [dtype] * 4, 16384, h, f, False) == route
    assert k3.attn_out_route(dtype, dtype, [dtype] * 3, 16384, h) == route
    # mixed dtypes take the counted plain path, as at 768
    other = F32 if dtype == BF else BF
    assert k3.attn_out_route(dtype, dtype, [other] * 3, 64,
                             h) == k3.ROUTE_PLAIN


@by_width
def test_wrappers_refuse_a_width_the_build_lacks(h):
    # each built width has its own entry; a width outside the built set
    # raises before any launch
    class Lib:
        mrd_ffn_pre_ln_bf16 = object()

    setattr(Lib, f"mrd_ffn_pre_ln_bf16_h{h}", object())
    assert k1.entry(Lib, "mrd_ffn_pre_ln_bf16", 768) \
        is Lib.mrd_ffn_pre_ln_bf16
    assert k1.entry(Lib, "mrd_ffn_pre_ln_bf16", h) \
        is getattr(Lib, f"mrd_ffn_pre_ln_bf16_h{h}")
    with pytest.raises(ValueError, match="no kernel is built"):
        k1.entry(Lib, "mrd_ffn_pre_ln_bf16", 384)


# (m, row tiles, slices, chunks per slice, K3 slices, K3 chunks per slice)
# of the bf16 kernels on a card with 132 SMs: the single request (1, then
# its length bucket 64), the 1,024 CLS rows, a mid size and the packed
# batch. FFN: F / 64 chunks of F; K3: H / 64 k chunks. At H = 1,024 each
# row tile is two blocks (column groups of 512), so the split starts below
# 66 row tiles, and at 4,096 rows (128 blocks, just short of the card) the
# rule's waves x chunks is 63 x 1 against 1 x 64 for the FFN, a tie for
# K3. The compact widths are one block per row tile, as 768: at 4,096 rows
# (64 blocks) two slices tie with more, and the smaller wins
_PLANS = {
    1024: [(1, 1, 64, 1, 16, 1), (64, 1, 64, 1, 16, 1),
           (1024, 16, 4, 16, 4, 4), (4096, 64, 64, 1, 1, 16),
           (16384, 256, 1, 64, 1, 16)],
    512: [(1, 1, 32, 1, 8, 1), (64, 1, 32, 1, 8, 1), (1024, 16, 8, 4, 8, 1),
          (4096, 64, 2, 16, 2, 4), (16384, 256, 1, 32, 1, 8)],
    256: [(1, 1, 16, 1, 4, 1), (64, 1, 16, 1, 4, 1), (1024, 16, 8, 2, 4, 1),
          (4096, 64, 2, 8, 2, 2), (16384, 256, 1, 16, 1, 4)],
    128: [(1, 1, 8, 1, 2, 1), (64, 1, 8, 1, 2, 1), (1024, 16, 8, 1, 2, 1),
          (4096, 64, 2, 4, 2, 1), (16384, 256, 1, 8, 1, 2)],
}
_PLAN_CASES = [(h, *p) for h, ps in _PLANS.items() for p in ps]


@pytest.mark.parametrize("h,m,tiles,slices,chunks,k3_slices,k3_chunks",
                         _PLAN_CASES,
                         ids=[f"h{p[0]}-m{p[1]}" for p in _PLAN_CASES])
def test_bf16_plans(h, m, tiles, slices, chunks, k3_slices, k3_chunks):
    f = WIDTHS[h][1]
    plan = k1.ffn_plan(m, f, 132, h)
    assert (plan.tiles, plan.slices, plan.chunks) == (tiles, slices, chunks)
    # each block (at 1,024 each pair, its row statistics over distributed
    # shared memory) applies the LayerNorm itself unless the k loop is
    # split
    assert plan.scratch == (None if slices == 1 else (slices, m, h))
    plan3 = k3.attn_out_plan(m, 132, h)
    assert (plan3.tiles, plan3.slices, plan3.chunks) == (tiles, k3_slices,
                                                        k3_chunks)
    assert plan3.scratch == (None if k3_slices == 1 else (k3_slices, m, h))
    # whole slices of whole chunks
    assert slices * chunks == f // 64 and k3_slices * k3_chunks == h // 64
    # BERT-base's plans are those of a single block per row tile
    assert k1.ffn_plan(m, 3072, 132) == k1.ffn_plan(m, 3072, 132, 768)


# (m, row tiles, FFN slices, k-tiles, K3 slices, k-tiles) of the f32
# GEMMs (H / 128 column tiles of 128; the FFN's second product F / 32
# k-tiles, K3's H / 32, at least 8 per slice). At H = 128 the packed batch
# is 128 output tiles on 132 SMs, and the rule keeps one slice: two
# slices of 8 k-tiles take 2 waves, a tie of 16 k-tiles a block
_PLANS_F32 = {
    1024: [(1, 1, 16, 8, 4, 8), (64, 1, 16, 8, 4, 8),
           (1024, 8, 2, 64, 2, 16), (16384, 128, 1, 128, 1, 32),
           (16385, 129, 1, 128, 1, 32)],
    512: [(1, 1, 8, 8, 2, 8), (64, 1, 8, 8, 2, 8), (1024, 8, 4, 16, 2, 8),
          (16384, 128, 1, 64, 1, 16), (16385, 129, 1, 64, 1, 16)],
    256: [(1, 1, 4, 8, 1, 8), (64, 1, 4, 8, 1, 8), (1024, 8, 4, 8, 1, 8),
          (16384, 128, 1, 32, 1, 8), (16385, 129, 1, 32, 1, 8)],
    128: [(1, 1, 2, 8, 1, 4), (64, 1, 2, 8, 1, 4), (1024, 8, 2, 8, 1, 4),
          (16384, 128, 1, 16, 1, 4), (16385, 129, 1, 16, 1, 4)],
}
_PLAN_F32_CASES = [(h, *p) for h, ps in _PLANS_F32.items() for p in ps]


@pytest.mark.parametrize("h,m,tiles,slices,k_tiles,k3_slices,k3_k_tiles",
                         _PLAN_F32_CASES,
                         ids=[f"h{p[0]}-m{p[1]}" for p in _PLAN_F32_CASES])
def test_f32_plans_and_scratch(h, m, tiles, slices, k_tiles, k3_slices,
                               k3_k_tiles):
    f = WIDTHS[h][1]
    plan = k1.ffn_plan_f32(m, f, 132, h)
    assert (plan.tiles, plan.slices, plan.k_tiles) == (tiles, slices,
                                                        k_tiles)
    # the TF32 planes of x, the weights and h, and one partial per slice
    assert plan.scratch == (2 * m * h + 4 * f * h + 2 * m * f
                            + slices * m * h)
    plan3 = k3.attn_out_plan_f32(m, 132, h)
    assert (plan3.tiles, plan3.slices, plan3.k_tiles) == (tiles, k3_slices,
                                                           k3_k_tiles)
    assert plan3.scratch == 2 * h * h + k3_slices * m * h


# bytes of scratch per K1-f32 / K2-f32 call and per K3-f32 call at M =
# 16,384 (PERF.md): 805,306,368 and 75.5 MB at 1,024
_SCRATCH = {1024: (805_306_368, 75_497_472), 512: (385_875_968, 35_651_584),
            256: (188_743_680, 17_301_504), 128: (93_323_264, 8_519_680)}


@by_width
def test_f32_scratch_at_the_packed_batch(h):
    ffn_bytes, k3_bytes = _SCRATCH[h]
    assert k1.ffn_plan_f32(16384, WIDTHS[h][1], 132, h).scratch * 4 \
        == ffn_bytes
    assert k3.attn_out_plan_f32(16384, 132, h).scratch * 4 == k3_bytes


@pytest.mark.parametrize("input_ln", [True, False], ids=["k1", "k2"])
@by_width
def test_cpu_tensors_take_the_plain_path_and_launch_nothing(h, input_ln):
    z, args, (g0, o0) = _ffn_args(37, 3, h)
    t = [torch.from_numpy(a).to(BF) for a in args]
    ln0 = (dict(pre_gamma=torch.from_numpy(g0), pre_beta=torch.from_numpy(o0))
           if input_ln else {})
    names = [n for n in dir(k1) if n.startswith("LAUNCHES")] + [
        "PLAIN_ON_CUDA"]
    names3 = [n for n in dir(k3) if n.startswith("LAUNCHES")] + [
        "PLAIN_ON_CUDA"]
    counts = [getattr(k1, n) for n in names] + [getattr(k3, n)
                                                for n in names3]
    zb = torch.from_numpy(z).to(BF)
    got = k1.fused_ffn_ln(zb, *t, **ln0)
    assert torch.equal(got, k1.ffn_ln_plain(zb, *t, input_ln=input_ln,
                                            **ln0))
    a3 = (zb, zb, t[0][:, :h], t[3], t[4], t[5])  # wo: a [h, h] view
    assert torch.equal(k3.fused_attn_out_ln(*a3), k3.attn_out_ln_plain(*a3))
    assert [getattr(k1, n) for n in names] + [
        getattr(k3, n) for n in names3] == counts


# ---- the slice: the classifier at each width, 2 layers (BERT-Tiny's
# full depth). BERT-large keeps the default vocabulary, BERT-large-cased's
# 28,996; the compact BERTs are uncased, 30,522

def _cfg(h, **over):
    heads, f = WIDTHS[h]
    return resolve_config("default", {
        "text_encoder.num_layers": 2, "text_encoder.num_heads": heads,
        "text_encoder.hidden_size": h, "text_encoder.intermediate_size": f,
        "text_encoder.max_position_embeddings": 512,
        **({} if h == 1024 else {"text_encoder.vocab_size": 30522}),
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
@by_width
def test_bert_large_classifier_matches_jax(monkeypatch, h, fused_attn_out):
    """The port's MultimodalClassifier at each width (BERT-large: H =
    1,024, 16 heads, F = 4,096, the vocabulary of BERT-large-cased,
    28,996; BERT-Medium, -Mini and -Tiny: H = 512, 256, 128 with 8, 4, 2
    heads, F = 4H, the uncased 30,522; 2 layers, ResNet stages (1, 1, 1,
    1)) against the JAX model on the same weights through
    `state_dict_from_jax`, f32 on the CPU: the default layer (K1's plain
    version here) and the fused-sublayer one (K3 then K2), whose JAX
    kernels run in interpret mode."""
    monkeypatch.setattr(jax_ao, "FORCE_INTERPRET", True)
    monkeypatch.setattr(jax_ffn_mod, "FORCE_INTERPRET", True)
    cfg = _cfg(h, **{"text_encoder.fused_attn_out": fused_attn_out})
    assert cfg.text_encoder.vocab_size == (28996 if h == 1024 else 30522)
    jm = jax_model(cfg, mode="multimodal")
    # flax's initializers take shapes, not values: initialized on the
    # batch the test applies, the JAX model compiles its ops once
    images, ids, mask = _inputs(2, 4)
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
    assert tm.text_encoder.bert.layer0.hidden_size == h
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
