"""The checks that tests/test_torch_bert_large.py,
tests/test_torch_odd_widths.py and tests/test_torch_wide_widths.py run at
each hidden width the torch package
builds K1, K2 and K3 for besides BERT-base's 768: the plain versions
against the JAX package's Pallas kernels run in interpret mode, the split
emulations, the gates, the launch plans and scratch sizes, the device
rule on the CPU, and the port's classifier at the width against the JAX
model on the same weights, in f32. Each test file holds its widths'
expected plans and parametrizes thin tests over these checks; the files
run on separate workers of the tier-1 run."""

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
# hidden width -> (heads, intermediate width F): BERT-large, the compact
# BERT-Medium, -Mini and -Tiny (heads of 64, F = 4H), MiniLM-L12-H384 (12
# heads of 32, F = 1,536), the widths 640 and 896 (heads of 64, F = 4H),
# and 1,152, 1,280, 1,408 and 1,536 (heads of 64, F = 4H; 1,536 is
# microsoft/deberta-v2-xlarge's width)
WIDTHS = {1024: (16, 4096), 512: (8, 2048), 256: (4, 1024), 128: (2, 512),
          384: (12, 1536), 640: (10, 2560), 896: (14, 3584),
          1152: (18, 4608), 1280: (20, 5120), 1408: (22, 5632),
          1536: (24, 6144)}
# every width the kernels are built for, and widths above 1,536 that stay
# on the counted plain version (the JAX package's bf16 Pallas FFN stops
# fitting its VMEM limit there)
BUILT = (128, 256, 384, 512, 640, 768, 896, 1024, 1152, 1280, 1408, 1536)
UNBUILT = (1664, 2048)
# f32: the Pallas kernel's erf polynomial (|err| <= 1.5e-7) against exact
# erf, and summation order; bf16: roundings of x, the GELU chunk and y from
# f32 sums taken in another order, one bf16 ulp apart at most. The JAX
# kernel tests' bounds (tests/test_ffn_kernel.py, test_attn_out_kernel.py)
ATOL = {"float32": 5e-5, "bfloat16": 5e-2}


def param_widths(widths):
    return pytest.mark.parametrize("h", list(widths),
                                   ids=[f"h{h}" for h in widths])


def _a(rng, shape, scale, offset=0.0):
    return (offset + rng.normal(size=shape) * scale).astype(np.float32)


def ffn_args(m, seed, h):
    f = WIDTHS[h][1]
    rng = np.random.default_rng(seed)
    z = _a(rng, (m, h), 0.5)
    args = (_a(rng, (h, f), 0.05), _a(rng, (f,), 0.01),
            _a(rng, (f, h), 0.05), _a(rng, (h,), 0.01),
            _a(rng, (h,), 0.05, 1.0), _a(rng, (h,), 0.01))
    return z, args, (_a(rng, (h,), 0.05, 1.0), _a(rng, (h,), 0.01))


def attn_args(m, seed, h):
    rng = np.random.default_rng(seed)
    ctx, x = _a(rng, (m, h), 0.5), _a(rng, (m, h), 0.5)
    return ctx, x, (_a(rng, (h, h), 0.05), _a(rng, (h,), 0.01),
                    _a(rng, (h,), 0.05, 1.0), _a(rng, (h,), 0.01))


def check_ffn_plain(h, input_ln, m, dtype):
    z, args, (g0, o0) = ffn_args(m, 100 + m + input_ln, h)
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


def check_attn_out_plain(h, m, dtype):
    ctx, x, args = attn_args(m, 200 + m, h)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ref = np.asarray(jax_ao.fused_attn_out_ln(
        jnp.asarray(ctx, jdt), jnp.asarray(x, jdt), *map(jnp.asarray, args),
        interpret=True), np.float32)
    got = k3.attn_out_ln_plain(torch.from_numpy(ctx).to(tdt),
                               torch.from_numpy(x).to(tdt),
                               *map(torch.from_numpy, args))
    assert got.dtype == tdt and got.shape == (m, h)
    np.testing.assert_allclose(got.float().numpy(), ref, atol=ATOL[dtype])


def check_split_emulations(h, ffn_slices, k3_slices):
    z, args, (g0, o0) = ffn_args(64, 7, h)
    ref = np.asarray(jax_ffn_mod.fused_ffn_ln(
        jnp.asarray(z), *map(jnp.asarray, args), interpret=True,
        pre_gamma=jnp.asarray(g0), pre_beta=jnp.asarray(o0)))
    got = k1.ffn_ln_plain(torch.from_numpy(z), *map(torch.from_numpy, args),
                          input_ln=True, pre_gamma=torch.from_numpy(g0),
                          pre_beta=torch.from_numpy(o0),
                          slices=ffn_slices).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL["float32"])
    ctx, x, a3 = attn_args(64, 8, h)
    ref = np.asarray(jax_ao.fused_attn_out_ln(
        jnp.asarray(ctx), jnp.asarray(x), *map(jnp.asarray, a3),
        interpret=True))
    got = k3.attn_out_ln_plain(torch.from_numpy(ctx), torch.from_numpy(x),
                               *map(torch.from_numpy, a3),
                               slices=k3_slices).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL["float32"])


def check_gates(h, dtype):
    f = WIDTHS[h][1]
    rows = (1, 37, 64, 1024, 16384, 16385)
    assert k1.KERNEL_WIDTHS == BUILT == build.ROW_WIDTHS
    assert all(k1.ffn_ln_fusible(m, h, f, dtype) for m in rows)
    assert all(k3.attn_out_ln_fusible(m, h, dtype) for m in rows)
    assert not k1.ffn_ln_fusible(0, h, f, dtype)
    assert not k3.attn_out_ln_fusible(0, h, dtype)
    # widths the build has no kernel for stay on the counted plain version
    for w in UNBUILT:
        assert not k1.ffn_ln_fusible(64, w, 4 * w, dtype)
        assert not k3.attn_out_ln_fusible(64, w, dtype)
        assert k1.ffn_route(dtype, [dtype] * 6, 64, w, 4 * w,
                            True) == k1.ROUTE_PLAIN
        assert k3.attn_out_route(dtype, dtype, [dtype] * 3, 64,
                                 w) == k3.ROUTE_PLAIN
    route = k1.ROUTE_BF16 if dtype == BF else k1.ROUTE_F32
    assert k1.ffn_route(dtype, [dtype] * 6, 16384, h, f, True) == route
    assert k1.ffn_route(dtype, [dtype] * 4, 16384, h, f, False) == route
    assert k3.attn_out_route(dtype, dtype, [dtype] * 3, 16384, h) == route
    # mixed dtypes take the counted plain path, as at 768
    other = F32 if dtype == BF else BF
    assert k3.attn_out_route(dtype, dtype, [other] * 3, 64,
                             h) == k3.ROUTE_PLAIN


def check_entry(h):
    # each built width has its own entry; a width outside the built set
    # raises before any launch
    class Lib:
        mrd_ffn_pre_ln_bf16 = object()

    setattr(Lib, f"mrd_ffn_pre_ln_bf16_h{h}", object())
    assert k1.entry(Lib, "mrd_ffn_pre_ln_bf16", 768) \
        is Lib.mrd_ffn_pre_ln_bf16
    assert k1.entry(Lib, "mrd_ffn_pre_ln_bf16", h) \
        is getattr(Lib, f"mrd_ffn_pre_ln_bf16_h{h}")
    for w in UNBUILT:
        with pytest.raises(ValueError, match="no kernel is built"):
            k1.entry(Lib, "mrd_ffn_pre_ln_bf16", w)


def check_bf16_plan(h, m, tiles, slices, chunks, k3_slices, k3_chunks):
    f = WIDTHS[h][1]
    plan = k1.ffn_plan(m, f, 132, h)
    assert (plan.tiles, plan.slices, plan.chunks) == (tiles, slices, chunks)
    # each block (from 896 up each pair, its row statistics over
    # distributed shared memory) applies the LayerNorm itself unless the k
    # loop is split
    assert plan.scratch == (None if slices == 1 else (slices, m, h))
    plan3 = k3.attn_out_plan(m, 132, h)
    assert (plan3.tiles, plan3.slices, plan3.chunks) == (tiles, k3_slices,
                                                        k3_chunks)
    assert plan3.scratch == (None if k3_slices == 1 else (k3_slices, m, h))
    # whole slices of whole chunks
    assert slices * chunks == f // 64 and k3_slices * k3_chunks == h // 64
    # BERT-base's plans are those of a single block per row tile
    assert k1.ffn_plan(m, 3072, 132) == k1.ffn_plan(m, 3072, 132, 768)


def check_ffn_plan(h, f, m, tiles, slices, chunks):
    """The bf16 FFN's plan at width h for m rows and intermediate width f
    (any whole number of chunks): the SM count's plan, one block per row
    tile below 896, two (column groups, launched as clusters of two, which
    the H100's 66 resident pairs fill: build/pair_probe.py) from 896 up.
    K3's plan at the width is not the FFN's."""
    plan = k1.ffn_plan(m, f, 132, h)
    assert (plan.tiles, plan.slices, plan.chunks) == (tiles, slices, chunks)
    # a ragged last tile is a tile: its rows past m are neither read nor
    # written
    assert tiles == -(-m // 64)
    assert plan.scratch == (None if slices == 1 else (slices, m, h))
    # whole slices of whole chunks
    assert slices * chunks == f // 64
    assert k3.attn_out_plan(m, 132, h) == k1.split_plan(m, h // 64, 132,
                                                        hidden=h)


# clusters of K3-f32's pass over whole rows that the H100 holds at once
# (cudaOccupancyMaxActiveClusters, PERF.md)
H100_ROWS_CLUSTERS = {128: 132, 256: 66, 384: 39, 512: 30, 640: 22}


def check_f32_plan(h, m, tiles, slices, k_tiles, k3_slices, k3_k_tiles):
    f = WIDTHS[h][1]
    plan = k1.ffn_plan_f32(m, f, 132, h)
    assert (plan.tiles, plan.slices, plan.k_tiles) == (tiles, slices,
                                                        k_tiles)
    # the TF32 planes of x, the weights and h, and one partial per slice;
    # at H = 128 and 256 the packed batch takes the one-pass form, whose
    # scratch is the weights' planes alone
    ffn_rows = h in (128, 256) and m >= 16384
    assert plan.rows == ffn_rows
    assert plan.scratch == (4 * f * h if ffn_rows else
                            2 * m * h + 4 * f * h + 2 * m * f
                            + slices * m * h)
    plan3 = k3.attn_out_plan_f32(m, 132, h, H100_ROWS_CLUSTERS.get(h, 0))
    assert (plan3.tiles, plan3.slices, plan3.k_tiles) == (tiles, k3_slices,
                                                           k3_k_tiles)
    # Wo's planes, and the partials unless the pass over whole rows runs
    # (H = 128-640 with one slice, at these row counts)
    rows = h <= 640 and k3_slices == 1
    assert plan3.rows == rows
    assert plan3.scratch == 2 * h * h + (0 if rows else k3_slices * m * h)


def check_overlap_rule(h, m, want):
    """K3's bf16 form for m rows at h (128 or 640) on 132 SMs: the
    overlapped form (at 128 the tile form) where `want`, the C entry's
    `slices` 0, else the one-block form with the plan's slices, which the
    rule never changes."""
    plan = k3.attn_out_plan(m, 132, h)
    assert plan == k1.split_plan(m, h // 64, 132, hidden=h)
    assert k3.launch_slices(m, h, 132) == (0 if want else plan.slices)
    if h == 640:
        assert k3.overlap_form(h, plan.slices) is want
        # only where the plan leaves the k loop whole: a single request's
        # 64 rows keep the split path
        assert want == (plan.slices == 1)


def check_overlap_forced(h, forced):
    """FORCE_OVERLAP sends every bf16 call at 640 to the overlapped form
    (True) or to the one-block form (False), at any row count; at 128 every
    call takes the tile form either way, and no call at another width
    takes either."""
    old = k3.FORCE_OVERLAP
    k3.FORCE_OVERLAP = forced
    try:
        for m in (1, 64, 1024, 16384, 16385):
            slices = k3.attn_out_plan(m, 132, h).slices
            assert k3.launch_slices(m, h, 132) == (
                0 if h == 128 or (forced and h == 640) else slices)
    finally:
        k3.FORCE_OVERLAP = old


def check_scratch(h, ffn_bytes, k3_bytes):
    assert k1.ffn_plan_f32(16384, WIDTHS[h][1], 132, h).scratch * 4 \
        == ffn_bytes
    assert k3.attn_out_plan_f32(16384, 132, h, H100_ROWS_CLUSTERS.get(
        h, 0)).scratch * 4 == k3_bytes


def check_cpu_rule(h, input_ln):
    z, args, (g0, o0) = ffn_args(37, 3, h)
    t = [torch.from_numpy(a).to(BF) for a in args]
    ln0 = (dict(pre_gamma=torch.from_numpy(g0), pre_beta=torch.from_numpy(o0))
           if input_ln else {})
    names = [n for n in dir(k1) if n.startswith("LAUNCHES")] + [
        "PLAIN_ON_CUDA"]
    names3 = [n for n in dir(k3) if n.startswith("LAUNCHES")] + [
        "PLAIN_ON_CUDA", "OVERLAP_CALLS"]
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


# ---- the classifier at a width, 2 layers. BERT-large keeps the default
# vocabulary, BERT-large-cased's 28,996; the others take the uncased
# 30,522

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


def check_classifier(monkeypatch, h, fused_attn_out):
    """The port's MultimodalClassifier at width h (WIDTHS' heads and F; 2
    layers, ResNet stages (1, 1, 1, 1)) against the JAX model on the same
    weights through `state_dict_from_jax`, f32 on the CPU: the default
    layer (K1's plain version here) and the fused-sublayer one (K3 then
    K2), whose JAX kernels run in interpret mode."""
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
    layer = tm.text_encoder.bert.layer0
    assert layer.hidden_size == h
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
