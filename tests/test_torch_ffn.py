"""K1 and K2 of the torch package (kernels/ffn.py): the plain version
against the JAX package's Pallas kernels run in interpret mode, the
launch plan and the split-F path's plain emulation, the device rule on
the CPU, the kernel build's key, and the kernel modules' import on a
machine with no nvcc and no triton. The CUDA kernels
themselves are checked against the plain version on the card by
tests/test_torch_gpu.py and chip_smoke.py."""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_rare_disease_tpu.ops.pallas.ffn import fused_ffn_ln as jax_ffn
from multimodal_rare_disease_tpu_torch.kernels import ffn as k1

REPO = Path(__file__).resolve().parent.parent


def _make(m, h, f, seed):
    rng = np.random.default_rng(seed)
    z = (rng.normal(size=(m, h)) * 0.5).astype(np.float32)
    w1 = (rng.normal(size=(h, f)) * 0.05).astype(np.float32)
    b1 = (rng.normal(size=(f,)) * 0.01).astype(np.float32)
    w2 = (rng.normal(size=(f, h)) * 0.05).astype(np.float32)
    b2 = (rng.normal(size=(h,)) * 0.01).astype(np.float32)
    g = (1.0 + rng.normal(size=(h,)) * 0.05).astype(np.float32)
    o = (rng.normal(size=(h,)) * 0.01).astype(np.float32)
    g0 = (1.0 + rng.normal(size=(h,)) * 0.05).astype(np.float32)
    o0 = (rng.normal(size=(h,)) * 0.01).astype(np.float32)
    return z, (w1, b1, w2, b2, g, o), (g0, o0)


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("m,h,f,seed", [(32, 128, 256, 0),
                                        (64, 256, 512, 1)])
def test_plain_matches_interpreted_k1_f32(m, h, f, seed):
    z, args, (g0, o0) = _make(m, h, f, seed)
    ref = np.asarray(jax_ffn(jnp.asarray(z), *map(jnp.asarray, args),
                             interpret=True, pre_gamma=jnp.asarray(g0),
                             pre_beta=jnp.asarray(o0)))
    got = k1.ffn_ln_plain(torch.from_numpy(z), *_t(args), input_ln=True,
                          pre_gamma=torch.from_numpy(g0),
                          pre_beta=torch.from_numpy(o0)).numpy()
    # f32: the Pallas kernel's erf polynomial (|err| <= 1.5e-7) against
    # torch's exact erf, and summation order; the JAX kernel test's bound
    np.testing.assert_allclose(got, ref, atol=5e-5)


@pytest.mark.parametrize("m,h,f,seed", [(64, 128, 256, 2),
                                        (128, 256, 512, 5)])
def test_plain_without_input_ln_matches_interpreted_k2_f32(m, h, f, seed):
    z, args, _ = _make(m, h, f, seed)
    ref = np.asarray(jax_ffn(jnp.asarray(z), *map(jnp.asarray, args),
                             interpret=True))
    got = k1.ffn_ln_plain(torch.from_numpy(z), *_t(args),
                          input_ln=False).numpy()
    # same bound as above: erf polynomial vs exact erf
    np.testing.assert_allclose(got, ref, atol=5e-5)


def test_plain_without_input_ln_matches_interpreted_k2_bf16():
    z, args, _ = _make(64, 128, 256, 6)
    bf = torch.bfloat16
    ref = np.asarray(jax_ffn(jnp.asarray(z, jnp.bfloat16),
                             *map(jnp.asarray, args), interpret=True),
                     np.float32)
    got = k1.ffn_ln_plain(torch.from_numpy(z).to(bf), *_t(args),
                          input_ln=False)
    assert got.dtype == bf
    # bf16 roundings of x, the GELU chunk and y from f32 sums taken in
    # another order: one bf16 ulp apart at most; the JAX kernel test's
    # bf16 bound
    np.testing.assert_allclose(got.float().numpy(), ref, atol=5e-2)


@pytest.mark.parametrize("input_ln", [True, False], ids=["k1", "k2"])
def test_cpu_tensor_takes_the_plain_path_and_launches_nothing(input_ln):
    z, args, (g0, o0) = _make(37, 128, 256, 3)
    ln0 = (dict(pre_gamma=torch.from_numpy(g0), pre_beta=torch.from_numpy(o0))
           if input_ln else {})
    counts = (k1.LAUNCHES_K1, k1.LAUNCHES_K2, k1.PLAIN_ON_CUDA)
    got = k1.fused_ffn_ln(torch.from_numpy(z), *_t(args), **ln0)
    want = k1.ffn_ln_plain(torch.from_numpy(z), *_t(args),
                           input_ln=input_ln, **ln0)
    assert torch.equal(got, want)  # the same function on the same inputs
    assert (k1.LAUNCHES_K1, k1.LAUNCHES_K2, k1.PLAIN_ON_CUDA) == counts


def test_fusible_gate_follows_the_cuda_tiling():
    bf = torch.bfloat16
    # any row count: the kernel masks its ragged 64-row tile
    assert all(k1.ffn_ln_fusible(m, 768, 3072, bf)
               for m in (1, 31, 37, 63, 64, 65, 24576))
    assert not k1.ffn_ln_fusible(0, 768, 3072, bf)
    assert not k1.ffn_ln_fusible(64, 1664, 6656, bf)     # not a built width
    assert k1.ffn_ln_fusible(64, 384, 1536, bf)          # MiniLM's
    assert k1.ffn_ln_fusible(64, 512, 2048, bf)          # BERT-Medium's
    assert not k1.ffn_ln_fusible(64, 768, 3000, bf)      # F in chunks of 64
    # f32 at H = 768: the f32 kernels (128-row tiles, F in output tiles
    # of 128)
    f32 = torch.float32
    assert all(k1.ffn_ln_fusible(m, 768, 3072, f32)
               for m in (1, 31, 127, 128, 129, 1024, 16385))
    assert not k1.ffn_ln_fusible(0, 768, 3072, f32)
    assert not k1.ffn_ln_fusible(64, 2048, 8192, f32)    # not a built width
    assert k1.ffn_ln_fusible(64, 896, 3584, f32)         # a pair's width
    assert k1.ffn_ln_fusible(64, 128, 256, f32)          # BERT-Tiny's H
    assert not k1.ffn_ln_fusible(64, 128, 192, f32)      # tiles of 128
    assert not k1.ffn_ln_fusible(64, 768, 3072 - 64, f32)  # tiles of 128
    assert not k1.ffn_ln_fusible(64, 768, 3072, torch.float16)
    # mixed dtypes stay outside the kernels: f32 rows with bf16 vectors,
    # and K2's bf16 rows with f32 vectors
    assert k1.ffn_route(f32, [bf] * 6, 64, 768, 3072, True) == k1.ROUTE_PLAIN
    assert k1.ffn_route(bf, [f32] * 4, 64, 768, 3072, False) == k1.ROUTE_PLAIN


# (m, tiles, slices, chunks per slice) on a card with 132 SMs at F=3072
# (48 chunks): the single request (m = 1, then the length bucket 64), a
# ragged tile, the CLS-only last layer at B=256, a mid size, and the packed
# batch, whose 256 tiles fill the card without a split
_PLANS = [(1, 1, 48, 1), (37, 1, 48, 1), (64, 1, 48, 1), (1024, 16, 8, 6),
          (4096, 64, 2, 24), (16384, 256, 1, 48)]


@pytest.mark.parametrize("m,tiles,slices,chunks", _PLANS,
                         ids=[f"m{p[0]}" for p in _PLANS])
def test_plan_at_the_main_path_row_counts(m, tiles, slices, chunks):
    plan = k1.ffn_plan(m, 3072, 132)
    assert (plan.tiles, plan.slices, plan.chunks) == (tiles, slices, chunks)
    # the f32 partials are kept for the valid rows only, one set per slice
    assert plan.scratch == (None if slices == 1 else (slices, m, 768))


@pytest.mark.parametrize("n_sm", [1, 78, 114, 132])
def test_plan_splits_f_evenly_and_only_when_tiles_leave_sms_idle(n_sm):
    for m in range(1, 20000, 97):
        plan = k1.ffn_plan(m, 3072, n_sm)
        assert plan.slices * plan.chunks == 48       # every slice equal
        assert plan.tiles == -(-m // 64)
        if plan.tiles >= n_sm:
            assert plan.slices == 1
        else:  # no fewer waves than without the split
            waves = -(-plan.tiles * plan.slices // n_sm) * plan.chunks
            assert waves <= -(-plan.tiles // n_sm) * 48


@pytest.mark.parametrize("slices", [2, 4])
@pytest.mark.parametrize("input_ln", [True, False], ids=["k1", "k2"])
def test_split_emulation_matches_plain_f32(input_ln, slices):
    z, args, (g0, o0) = _make(48, 128, 256, 7)
    ln0 = (dict(pre_gamma=torch.from_numpy(g0), pre_beta=torch.from_numpy(o0))
           if input_ln else {})
    whole = k1.ffn_ln_plain(torch.from_numpy(z), *_t(args),
                            input_ln=input_ln, **ln0)
    split = k1.ffn_ln_plain(torch.from_numpy(z), *_t(args),
                            input_ln=input_ln, slices=slices, **ln0)
    # the same sum of 256 products, taken as `slices` partials: f32
    # rounding of the partial sums only
    np.testing.assert_allclose(split.numpy(), whole.numpy(), atol=1e-5)


@pytest.mark.parametrize("input_ln", [True, False], ids=["k1", "k2"])
def test_split_emulation_matches_interpreted_jax_f32(input_ln):
    z, args, (g0, o0) = _make(64, 128, 256, 8)
    pre = (dict(pre_gamma=jnp.asarray(g0), pre_beta=jnp.asarray(o0))
           if input_ln else {})
    ref = np.asarray(jax_ffn(jnp.asarray(z), *map(jnp.asarray, args),
                             interpret=True, **pre))
    ln0 = (dict(pre_gamma=torch.from_numpy(g0), pre_beta=torch.from_numpy(o0))
           if input_ln else {})
    got = k1.ffn_ln_plain(torch.from_numpy(z), *_t(args), input_ln=input_ln,
                          slices=4, **ln0).numpy()
    # the Pallas kernel's erf polynomial against exact erf, as above
    np.testing.assert_allclose(got, ref, atol=5e-5)


def test_kernel_module_imports_without_nvcc_or_triton(tmp_path):
    code = (
        "import sys\n"
        "from multimodal_rare_disease_tpu_torch.kernels import (\n"
        "    attn_out, build, ffn, image)\n"
        "assert 'triton' not in sys.modules\n"
        "assert build.sources(), 'no CUDA sources found'\n"
        "try:\n"
        "    build.find_nvcc()\n"
        "except build.KernelBuildError:\n"
        "    print('no-nvcc')\n"
        "else:\n"
        "    print('nvcc')\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = str(tmp_path)  # nothing on PATH
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    if not Path("/usr/local/cuda/bin/nvcc").is_file():
        assert out.stdout.strip() == "no-nvcc"


def test_build_is_keyed_by_the_sources():
    from multimodal_rare_disease_tpu_torch.kernels import build

    p = build.library_path()
    assert p.name == build.LIB_NAME
    assert p.parent.parent == build.BUILD_DIR
    assert {s.name for s in build.sources()} >= {
        "ffn_ln.cu", "ffn_ln_odd.cu", "ffn_ln_wide.cu", "ffn_ln_wide2.cu",
        "attn_out_ln.cu", "attn_out_ln_overlap.cu", "attn_out_ln_wide.cu",
        "normalize_u8.cu",
        "ffn_ln_f32.cu", "attn_out_ln_f32.cu"}


def test_build_key_covers_the_headers(tmp_path, monkeypatch):
    # a header-only edit must not reuse a library built before it
    from multimodal_rare_disease_tpu_torch.kernels import build

    headers = ["attn_out_ln.cuh", "attn_out_rows_f32.cuh", "common.cuh",
               "ffn_ln.cuh", "ffn_rows_f32.cuh", "gemm_tf32x3.cuh",
               "hopper.cuh", "rows.cuh", "rows_f32.cuh"]
    assert [h.name for h in build.headers()] == headers
    for src in (*build.sources(), *build.headers()):
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    before = build.library_path()
    for name in headers:
        with open(tmp_path / name, "a") as f:
            f.write("// edited\n")
        after = build.library_path()
        assert after != before
        before = after
