"""K3 of the torch package (kernels/attn_out.py): the plain version
against the JAX package's Pallas kernel run in interpret mode, at the
tolerances of tests/test_attn_out_kernel.py, the launch plans of the bf16
and f32 kernels and the split-K path's plain emulation (also at the f32
kernel's slice counts), and the device rule on the CPU. The CUDA
kernel itself is checked against the plain version on the card by
tests/test_torch_gpu.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_rare_disease_tpu.ops.pallas.attn_out import (
    fused_attn_out_ln as jax_attn_out,
)
from multimodal_rare_disease_tpu_torch.kernels import attn_out as k3


def _make(m, h, seed):
    """The inputs of tests/test_attn_out_kernel.py, as numpy f32."""
    rng = np.random.default_rng(seed)
    ctx = (rng.normal(size=(m, h)) * 0.5).astype(np.float32)
    x = (rng.normal(size=(m, h)) * 0.5).astype(np.float32)
    wo = (rng.normal(size=(h, h)) * 0.05).astype(np.float32)
    bo = (rng.normal(size=(h,)) * 0.01).astype(np.float32)
    g = (1.0 + rng.normal(size=(h,)) * 0.05).astype(np.float32)
    o = (rng.normal(size=(h,)) * 0.01).astype(np.float32)
    return ctx, x, (wo, bo, g, o)


# f32: summation order of the 256-term dot and the LayerNorm sums; bf16:
# the output rounds to bf16 from f32 values that differ by summation
# order, so an element may land one bf16 ulp apart. Both are the bounds
# of tests/test_attn_out_kernel.py.
@pytest.mark.parametrize("dtype,atol,m,seed", [
    ("float32", 5e-5, 64, 0), ("float32", 5e-5, 96, 3),
    ("bfloat16", 5e-2, 64, 1)])
def test_plain_matches_interpreted_k3(dtype, atol, m, seed):
    ctx, x, args = _make(m, 256, seed)
    jdt = jnp.dtype(dtype)
    ref = np.asarray(jax_attn_out(jnp.asarray(ctx, jdt), jnp.asarray(x, jdt),
                                  *map(jnp.asarray, args), interpret=True),
                     np.float32)
    tdt = getattr(torch, dtype)
    got = k3.attn_out_ln_plain(torch.from_numpy(ctx).to(tdt),
                               torch.from_numpy(x).to(tdt),
                               *map(torch.from_numpy, args))
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), ref, atol=atol)


def test_cpu_tensor_takes_the_plain_path_and_launches_nothing():
    ctx, x, args = _make(37, 128, 2)
    t = [torch.from_numpy(a) for a in (ctx, x, *args)]
    launches, plain_on_cuda = k3.LAUNCHES, k3.PLAIN_ON_CUDA
    got = k3.fused_attn_out_ln(*t)
    assert torch.equal(got, k3.attn_out_ln_plain(*t))
    assert (k3.LAUNCHES, k3.PLAIN_ON_CUDA) == (launches, plain_on_cuda)


def test_plain_keeps_the_projection_in_f32():
    # the numerics contract: ctx @ wo is not rounded to bf16 before the
    # residual; a version that rounds it differs from this one
    ctx, x, args = _make(64, 256, 4)
    bf = torch.bfloat16
    c, xx = torch.from_numpy(ctx).to(bf), torch.from_numpy(x).to(bf)
    wo, bo, g, o = map(torch.from_numpy, args)
    got = k3.attn_out_ln_plain(c, xx, wo, bo, g, o).float()
    want = k3.ln_f32(c.float() @ wo.to(bf).float() + bo + xx.float(),
                     g, o, 1e-12).to(bf).float()
    assert torch.equal(got, want)


def test_fusible_gate_follows_the_cuda_tiling():
    bf = torch.bfloat16
    # any row count: TMA zero-fills and clips the ragged 64-row tile
    assert all(k3.attn_out_ln_fusible(m, 768, bf) for m in (1, 8, 37, 16384))
    assert not k3.attn_out_ln_fusible(0, 768, bf)
    assert not k3.attn_out_ln_fusible(64, 1664, bf)    # not a built width
    assert k3.attn_out_ln_fusible(64, 384, bf)         # MiniLM's
    assert k3.attn_out_ln_fusible(64, 512, bf)         # BERT-Medium's
    # f32 at H = 768: the f32 kernel (128-row tiles, TMA zero-fills and
    # the epilogue clips the ragged one)
    f32 = torch.float32
    assert all(k3.attn_out_ln_fusible(m, 768, f32) for m in (1, 8, 37, 16384))
    assert not k3.attn_out_ln_fusible(0, 768, f32)
    assert not k3.attn_out_ln_fusible(64, 2048, f32)   # not a built width
    assert k3.attn_out_ln_fusible(64, 640, f32)        # an odd multiple of 128
    assert k3.attn_out_ln_fusible(64, 512, f32)        # BERT-Medium's
    assert not k3.attn_out_ln_fusible(64, 768, torch.float16)
    # mixed dtypes stay outside the kernels
    assert k3.attn_out_route(f32, f32, [bf] * 3, 64, 768) == k3.ROUTE_PLAIN
    assert k3.attn_out_route(bf, bf, [f32] * 3, 64, 768) == k3.ROUTE_PLAIN
    assert k3.attn_out_route(f32, bf, [f32] * 3, 64, 768) == k3.ROUTE_PLAIN


# (m, tiles, slices, chunks per slice) on a card with 132 SMs (12 k chunks
# of 64): the single request (m = 1, then the length bucket 64), the
# CLS-only rows at B=256, and the row counts whose tiles fill the card
# without a split (132 tiles, and the packed batch's 256)
_PLANS = [(1, 1, 12, 1), (64, 1, 12, 1), (1024, 16, 6, 2),
          (8448, 132, 1, 12), (16384, 256, 1, 12)]


@pytest.mark.parametrize("m,tiles,slices,chunks", _PLANS,
                         ids=[f"m{p[0]}" for p in _PLANS])
def test_plan_at_the_main_path_row_counts(m, tiles, slices, chunks):
    plan = k3.attn_out_plan(m, 132)
    assert (plan.tiles, plan.slices, plan.chunks) == (tiles, slices, chunks)
    # the f32 partials are kept for the valid rows only, one set per slice
    assert plan.scratch == (None if slices == 1 else (slices, m, 768))


@pytest.mark.parametrize("slices", [2, 4])
def test_split_emulation_matches_plain_f32(slices):
    ctx, x, args = _make(48, 256, 5)
    t = [torch.from_numpy(a) for a in (ctx, x, *args)]
    whole = k3.attn_out_ln_plain(*t)
    split = k3.attn_out_ln_plain(*t, slices=slices)
    # the same 256-term dot, taken as `slices` partials: f32 rounding of
    # the partial sums only
    np.testing.assert_allclose(split.numpy(), whole.numpy(), atol=1e-5)


def test_split_emulation_matches_interpreted_k3_f32():
    ctx, x, args = _make(64, 256, 6)
    ref = np.asarray(jax_attn_out(jnp.asarray(ctx), jnp.asarray(x),
                                  *map(jnp.asarray, args), interpret=True))
    got = k3.attn_out_ln_plain(torch.from_numpy(ctx), torch.from_numpy(x),
                               *map(torch.from_numpy, args), slices=4)
    # the bound of test_plain_matches_interpreted_k3 in f32
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-5)


# (m, row tiles, slices, k-tiles per slice) of the f32 kernel's GEMM on a
# card with 132 SMs (6 column tiles of 128, 24 k-tiles of 32, at least 8
# per slice): the single request (1, a ragged tile, its length bucket 64)
# and the 1,024 CLS rows split the k loop; the packed batch and a ragged
# tile past it fill the card without a split
_PLANS_F32 = [(1, 1, 3, 8), (37, 1, 3, 8), (64, 1, 3, 8), (1024, 8, 2, 12),
              (16384, 128, 1, 24), (16385, 129, 1, 24)]


@pytest.mark.parametrize("m,tiles,slices,k_tiles", _PLANS_F32,
                         ids=[f"m{p[0]}" for p in _PLANS_F32])
def test_f32_plan_at_the_main_path_row_counts(m, tiles, slices, k_tiles):
    plan = k3.attn_out_plan_f32(m, 132)
    assert (plan.tiles, plan.slices, plan.k_tiles) == (tiles, slices,
                                                        k_tiles)
    assert plan.slices <= 3 and plan.slices * plan.k_tiles == 24
    # Wo^T's two TF32 planes, then one f32 partial per slice of the rows
    assert plan.scratch == 2 * 768 * 768 + slices * m * 768


@pytest.mark.parametrize("slices", [2, 3])
def test_f32_split_emulation_at_the_kernel_width(slices):
    # the f32 kernel's slice counts at H = 768: k slices of 384 and 256
    ctx, x, args = _make(64, 768, 7)
    t = [torch.from_numpy(a) for a in (ctx, x, *args)]
    whole = k3.attn_out_ln_plain(*t)
    split = k3.attn_out_ln_plain(*t, slices=slices)
    # the same 768-term dot, taken as `slices` partials: f32 rounding of
    # the partial sums only (the bound of test_split_emulation_matches_plain_f32)
    np.testing.assert_allclose(split.numpy(), whole.numpy(), atol=1e-5)


@pytest.mark.parametrize("slices", [2, 3])
def test_f32_split_emulation_matches_interpreted_k3(slices):
    ctx, x, args = _make(64, 768, 8)
    ref = np.asarray(jax_attn_out(jnp.asarray(ctx), jnp.asarray(x),
                                  *map(jnp.asarray, args), interpret=True))
    got = k3.attn_out_ln_plain(torch.from_numpy(ctx), torch.from_numpy(x),
                               *map(torch.from_numpy, args), slices=slices)
    # the bound of test_plain_matches_interpreted_k3 in f32
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-5)
