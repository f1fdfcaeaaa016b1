"""K1, K2 and K3 of the torch package above BERT-large width: H = 1,152,
1,280, 1,408 and 1,536 (heads of 64, F = 4H; 1,536 is
microsoft/deberta-v2-xlarge's width). Each test runs at each of these
widths the checks of tests/_torch_width_cases.py, as
tests/test_torch_odd_widths.py does at 384, 640 and 896: the plain
versions against the JAX package's Pallas kernels run in interpret mode
(the JAX gates take any multiple of 128), the split emulations, the
gates (and the counted plain path at 1,664 and 2,048), the launch plans
and scratch sizes of the bf16 and f32 kernels, the device rule on the
CPU, and a 2-layer classifier through the weight bridge against the JAX
model in f32, at 1,152 and 1,536 only (each such model takes the JAX
package seconds to build and run). The CUDA kernels themselves are
checked against the plain versions on the card by tests/test_torch_gpu.py
and chip_smoke.py (phase 20)."""

import pytest

from _torch_width_cases import (
    BF,
    F32,
    check_attn_out_plain,
    check_bf16_plan,
    check_classifier,
    check_cpu_rule,
    check_entry,
    check_f32_plan,
    check_ffn_plain,
    check_gates,
    check_ffn_plan,
    check_scratch,
    check_split_emulations,
    param_widths,
)

WIDTHS = (1152, 1280, 1408, 1536)
by_width = param_widths(WIDTHS)


# the JAX gate needs M % 16 == 0: a full 64-row tile and a ragged 48
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [64, 48])
@pytest.mark.parametrize("input_ln", [True, False], ids=["k1", "k2"])
@by_width
def test_ffn_plain_matches_interpreted_jax(h, input_ln, m, dtype):
    check_ffn_plain(h, input_ln, m, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [64, 48])
@by_width
def test_attn_out_plain_matches_interpreted_jax(h, m, dtype):
    check_attn_out_plain(h, m, dtype)


# the kernels' split sums at each width: F in the bf16 FFN's slices at the
# 1,024 CLS rows, and the product's k in the slices of bf16 K3 at a single
# request (every k chunk its own slice)
_SPLITS = {1152: (4, 18), 1280: (4, 20), 1408: (4, 22), 1536: (4, 24)}


@by_width
def test_split_emulations_match_interpreted_jax_f32(h):
    check_split_emulations(h, *_SPLITS[h])


@pytest.mark.parametrize("dtype", [BF, F32], ids=["bf16", "f32"])
@by_width
def test_gates_take_the_built_widths(h, dtype):
    check_gates(h, dtype)


@by_width
def test_wrappers_refuse_a_width_the_build_lacks(h):
    check_entry(h)


# (m, row tiles, slices, chunks per slice, K3 slices, K3 chunks per slice)
# of the bf16 kernels on a card with 132 SMs: the single request (1, then
# its length bucket 64), the 1,024 CLS rows, a mid size and the packed
# batch. FFN: F / 64 chunks (72, 80, 88, 96); K3: H / 64 k chunks (18, 20,
# 22, 24). Each row tile is two blocks (column groups of H / 2), as at
# 1,024: at 1,024 rows (32 blocks) 4 slices of F fill 128 SMs once; at
# 4,096 (128 blocks) the FFN's rule reads 35-47 waves of 2 chunks against
# one wave of all F / 64, as at 896, and K3's one slice wins
_PLANS = {
    1152: [(1, 1, 36, 2, 18, 1), (64, 1, 36, 2, 18, 1),
           (1024, 16, 4, 18, 18, 1), (4096, 64, 36, 2, 1, 18),
           (16384, 256, 1, 72, 1, 18), (16385, 257, 1, 72, 1, 18)],
    1280: [(1, 1, 40, 2, 20, 1), (64, 1, 40, 2, 20, 1),
           (1024, 16, 4, 20, 4, 5), (4096, 64, 40, 2, 1, 20),
           (16384, 256, 1, 80, 1, 20), (16385, 257, 1, 80, 1, 20)],
    1408: [(1, 1, 44, 2, 22, 1), (64, 1, 44, 2, 22, 1),
           (1024, 16, 4, 22, 11, 2), (4096, 64, 44, 2, 1, 22),
           (16384, 256, 1, 88, 1, 22), (16385, 257, 1, 88, 1, 22)],
    1536: [(1, 1, 48, 2, 24, 1), (64, 1, 48, 2, 24, 1),
           (1024, 16, 4, 24, 4, 6), (4096, 64, 48, 2, 1, 24),
           (16384, 256, 1, 96, 1, 24), (16385, 257, 1, 96, 1, 24)],
}
_PLAN_CASES = [(h, *p) for h, ps in _PLANS.items() for p in ps]


@pytest.mark.parametrize("h,m,tiles,slices,chunks,k3_slices,k3_chunks",
                         _PLAN_CASES,
                         ids=[f"h{p[0]}-m{p[1]}" for p in _PLAN_CASES])
def test_bf16_plans(h, m, tiles, slices, chunks, k3_slices, k3_chunks):
    check_bf16_plan(h, m, tiles, slices, chunks, k3_slices, k3_chunks)


# (m, row tiles, slices, chunks per slice) of the bf16 FFN at the pair
# widths with F = 4H - 64, an odd number of chunks, from a single
# request's row to the ragged tile past the packed batch: below a wave the
# plan takes slices of one chunk, where the second block of a pair that
# takes turns at chunks (896, 1,024) has none
_PAIR_PLANS = {
    (1152, 4544): [(1, 1, 71, 1), (64, 1, 71, 1), (1024, 16, 71, 1),
                   (16384, 256, 1, 71), (16385, 257, 1, 71)],
    (1280, 5056): [(1, 1, 79, 1), (64, 1, 79, 1), (1024, 16, 79, 1),
                   (16384, 256, 1, 79), (16385, 257, 1, 79)],
    (1408, 5568): [(1, 1, 87, 1), (64, 1, 87, 1), (1024, 16, 87, 1),
                   (16384, 256, 1, 87), (16385, 257, 1, 87)],
    (1536, 6080): [(1, 1, 95, 1), (64, 1, 95, 1), (1024, 16, 95, 1),
                   (16384, 256, 1, 95), (16385, 257, 1, 95)],
}
_PAIR_CASES = [(h, f, *p) for (h, f), ps in _PAIR_PLANS.items() for p in ps]


@pytest.mark.parametrize("h,f,m,tiles,slices,chunks", _PAIR_CASES,
                         ids=[f"h{p[0]}-f{p[1]}-m{p[2]}"
                              for p in _PAIR_CASES])
def test_bf16_pair_plans_odd_chunks(h, f, m, tiles, slices, chunks):
    check_ffn_plan(h, f, m, tiles, slices, chunks)


# (m, row tiles, FFN slices, k-tiles, K3 slices, k-tiles) of the f32
# GEMMs: H / 128 column tiles of 128 (9, 10, 11, 12); the FFN's second
# product F / 32 k-tiles (144, 160, 176, 192), K3's H / 32 (36, 40, 44,
# 48), at least 8 per slice
_PLANS_F32 = {
    1152: [(1, 1, 12, 12, 4, 9), (64, 1, 12, 12, 4, 9),
           (1024, 8, 9, 16, 3, 12), (16384, 128, 1, 144, 1, 36),
           (16385, 129, 1, 144, 1, 36)],
    1280: [(1, 1, 10, 16, 5, 8), (64, 1, 10, 16, 5, 8),
           (1024, 8, 8, 20, 4, 10), (16384, 128, 1, 160, 1, 40),
           (16385, 129, 1, 160, 1, 40)],
    1408: [(1, 1, 11, 16, 4, 11), (64, 1, 11, 16, 4, 11),
           (1024, 8, 22, 8, 4, 11), (16384, 128, 1, 176, 1, 44),
           (16385, 129, 1, 176, 1, 44)],
    1536: [(1, 1, 8, 24, 6, 8), (64, 1, 8, 24, 6, 8),
           (1024, 8, 4, 48, 4, 12), (16384, 128, 1, 192, 1, 48),
           (16385, 129, 1, 192, 1, 48)],
}
_PLAN_F32_CASES = [(h, *p) for h, ps in _PLANS_F32.items() for p in ps]


@pytest.mark.parametrize("h,m,tiles,slices,k_tiles,k3_slices,k3_k_tiles",
                         _PLAN_F32_CASES,
                         ids=[f"h{p[0]}-m{p[1]}" for p in _PLAN_F32_CASES])
def test_f32_plans_and_scratch(h, m, tiles, slices, k_tiles, k3_slices,
                               k3_k_tiles):
    check_f32_plan(h, m, tiles, slices, k_tiles, k3_slices, k3_k_tiles)


# bytes of scratch per K1-f32 / K2-f32 call and per K3-f32 call at M =
# 16,384 (PERF.md): 1.26 GB per FFN call at 1,536
_SCRATCH = {1152: (915_406_848, 86_114_304),
            1280: (1_027_604_480, 96_993_280),
            1408: (1_141_899_264, 108_134_400),
            1536: (1_258_291_200, 119_537_664)}


@by_width
def test_f32_scratch_at_the_packed_batch(h):
    check_scratch(h, *_SCRATCH[h])


@pytest.mark.parametrize("input_ln", [True, False], ids=["k1", "k2"])
@by_width
def test_cpu_tensors_take_the_plain_path_and_launch_nothing(h, input_ln):
    check_cpu_rule(h, input_ln)


@pytest.mark.parametrize("fused_attn_out", [False, True],
                         ids=["default", "fused_attn_out"])
@param_widths((1152, 1536))
def test_wide_width_classifier_matches_jax(monkeypatch, h, fused_attn_out):
    """The port's MultimodalClassifier at 1,152 and 1,536 (heads of 64,
    F = 4H, the uncased vocabulary of 30,522; 2 layers) against the JAX
    model on the same weights, f32 on the CPU, default and fused-sublayer
    layers."""
    check_classifier(monkeypatch, h, fused_attn_out)
