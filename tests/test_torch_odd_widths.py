"""K1, K2 and K3 of the torch package at the odd multiples of 128 below
1,024: H = 384 (microsoft/MiniLM-L12-H384: 12 heads of 32, F = 1,536),
640 and 896 (heads of 64, F = 4H). Each test runs at each of these widths
the checks of tests/_torch_width_cases.py, as
tests/test_torch_bert_large.py does at 1,024, 512, 256 and 128: the plain
versions against the JAX package's Pallas kernels run in interpret mode
(the JAX gates take any multiple of 128), the split emulations, the
gates, the launch plans and scratch sizes of the bf16 and f32 kernels,
the device rule on the CPU, and a 2-layer classifier through the weight
bridge against the JAX model, in f32. The CUDA kernels themselves are
checked against the plain versions on the card by tests/test_torch_gpu.py
and chip_smoke.py (phase 19)."""

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
    check_overlap_forced,
    check_overlap_rule,
    check_scratch,
    check_split_emulations,
    param_widths,
)

WIDTHS = (384, 640, 896)
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
_SPLITS = {384: (8, 6), 640: (8, 10), 896: (4, 14)}


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
# batch. FFN: F / 64 chunks (24, 40, 56); K3: H / 64 k chunks (6, 10, 14).
# 384 and 640 are one block per row tile: at 1,024 rows (16 blocks) 8
# slices of F fill 128 SMs once, and at 4,096 (64 blocks) two slices tie
# with four and the smaller wins. At 896 each row tile is two blocks
# (column groups of 448), as at 1,024: at 4,096 rows (128 blocks) the
# FFN's rule reads 55 waves x 1 chunk against 1 x 56, and K3's ties
_PLANS = {
    384: [(1, 1, 24, 1, 6, 1), (64, 1, 24, 1, 6, 1), (1024, 16, 8, 3, 6, 1),
          (4096, 64, 2, 12, 2, 3), (16384, 256, 1, 24, 1, 6)],
    640: [(1, 1, 40, 1, 10, 1), (64, 1, 40, 1, 10, 1),
          (1024, 16, 8, 5, 5, 2), (4096, 64, 2, 20, 2, 5),
          (16384, 256, 1, 40, 1, 10)],
    896: [(1, 1, 56, 1, 14, 1), (64, 1, 56, 1, 14, 1),
          (1024, 16, 4, 14, 7, 2), (4096, 64, 56, 1, 1, 14),
          (16384, 256, 1, 56, 1, 14), (16385, 257, 1, 56, 1, 14)],
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
    (896, 3520): [(1, 1, 55, 1), (64, 1, 55, 1), (1024, 16, 55, 1),
                  (16384, 256, 1, 55), (16385, 257, 1, 55)],
}
_PAIR_CASES = [(h, f, *p) for (h, f), ps in _PAIR_PLANS.items() for p in ps]


@pytest.mark.parametrize("h,f,m,tiles,slices,chunks", _PAIR_CASES,
                         ids=[f"h{p[0]}-f{p[1]}-m{p[2]}"
                              for p in _PAIR_CASES])
def test_bf16_pair_plans_odd_chunks(h, f, m, tiles, slices, chunks):
    check_ffn_plan(h, f, m, tiles, slices, chunks)


# (m, row tiles, slices, chunks per slice) of the bf16 FFN's one-block
# forms at odd counts: F = 4H - 64 (23 and 39 chunks: slices of one chunk
# below a wave but 13 slices of 3 at 640's 17 tiles, the whole count in
# one slice past the packed batch) and MiniLM's F = 1,536 and 640's 4H at
# the odd tile counts of a request's 65, 127 and 129 rows and at 17 tiles
_NARROW_PLANS = {
    (384, 1472): [(1, 1, 23, 1), (65, 2, 23, 1), (129, 3, 23, 1),
                  (1088, 17, 23, 1), (16385, 257, 1, 23)],
    (640, 2496): [(1, 1, 39, 1), (127, 2, 39, 1), (1088, 17, 13, 3),
                  (16385, 257, 1, 39)],
    (384, 1536): [(65, 2, 24, 1), (127, 2, 24, 1), (129, 3, 24, 1),
                  (1088, 17, 6, 4)],
    (640, 2560): [(65, 2, 40, 1), (129, 3, 40, 1), (1088, 17, 20, 2)],
}
_NARROW_CASES = [(h, f, *p) for (h, f), ps in _NARROW_PLANS.items()
                 for p in ps]


@pytest.mark.parametrize("h,f,m,tiles,slices,chunks", _NARROW_CASES,
                         ids=[f"h{p[0]}-f{p[1]}-m{p[2]}"
                              for p in _NARROW_CASES])
def test_bf16_narrow_plans_odd_counts(h, f, m, tiles, slices, chunks):
    check_ffn_plan(h, f, m, tiles, slices, chunks)


# (m, row tiles, FFN slices, k-tiles, K3 slices, k-tiles) of the f32
# GEMMs: H / 128 column tiles of 128 (3, 5, 7); the FFN's second product
# F / 32 k-tiles (48, 80, 112), K3's H / 32 (12, 20, 28), at least 8 per
# slice, so K3-f32 at 384 never splits and at 640 and 896 into two
_PLANS_F32 = {
    384: [(1, 1, 6, 8, 1, 12), (64, 1, 6, 8, 1, 12), (1024, 8, 4, 12, 1, 12),
          (16384, 128, 1, 48, 1, 12), (16385, 129, 1, 48, 1, 12)],
    640: [(1, 1, 10, 8, 2, 10), (64, 1, 10, 8, 2, 10),
          (1024, 8, 8, 10, 2, 10), (16384, 128, 1, 80, 1, 20),
          (16385, 129, 1, 80, 1, 20)],
    896: [(1, 1, 14, 8, 2, 14), (64, 1, 14, 8, 2, 14),
          (1024, 8, 7, 16, 2, 14), (16384, 128, 1, 112, 1, 28),
          (16385, 129, 1, 112, 1, 28)],
}
_PLAN_F32_CASES = [(h, *p) for h, ps in _PLANS_F32.items() for p in ps]


@pytest.mark.parametrize("h,m,tiles,slices,k_tiles,k3_slices,k3_k_tiles",
                         _PLAN_F32_CASES,
                         ids=[f"h{p[0]}-m{p[1]}" for p in _PLAN_F32_CASES])
def test_f32_plans_and_scratch(h, m, tiles, slices, k_tiles, k3_slices,
                               k3_k_tiles):
    check_f32_plan(h, m, tiles, slices, k_tiles, k3_slices, k3_k_tiles)


# bytes of scratch per K1-f32 / K2-f32 call and per K3-f32 call at M =
# 16,384 (PERF.md); K3-f32 at 384 and 640 takes its pass over whole rows
# there, which needs Wo's planes alone (2 H^2 f32)
_SCRATCH = {384: (286_261_248, 1_179_648), 640: (487_587_840, 3_276_800),
            896: (697_303_040, 65_142_784)}


@by_width
def test_f32_scratch_at_the_packed_batch(h):
    check_scratch(h, *_SCRATCH[h])


@pytest.mark.parametrize("input_ln", [True, False], ids=["k1", "k2"])
@by_width
def test_cpu_tensors_take_the_plain_path_and_launch_nothing(h, input_ln):
    check_cpu_rule(h, input_ln)


# K3's overlapped form at 640 (persistent clusters of two): the form the
# rule takes for m rows, from a single request's row to the ragged tile
# past the packed batch: every count whose plan leaves the k loop whole
# (7,553 rows up); below, the one-block form's split path
_OVERLAP_RULE = [(m, m >= 8448)
                 for m in (1, 37, 64, 1024, 4096, 8448, 16384, 16385)]


@pytest.mark.parametrize("m,want", _OVERLAP_RULE,
                         ids=[f"h640-m{m}" for m, _ in _OVERLAP_RULE])
def test_k3_overlap_rule(m, want):
    check_overlap_rule(640, m, want)


@pytest.mark.parametrize("forced", [True, False], ids=["on", "off"])
@by_width
def test_k3_overlap_forced(h, forced):
    check_overlap_forced(h, forced)


@pytest.mark.parametrize("fused_attn_out", [False, True],
                         ids=["default", "fused_attn_out"])
@by_width
def test_odd_width_classifier_matches_jax(monkeypatch, h, fused_attn_out):
    """The port's MultimodalClassifier at each width (384: MiniLM's 12
    heads of 32 and F = 1,536; 640 and 896: heads of 64, F = 4H; the
    uncased vocabulary of 30,522; 2 layers) against the JAX model on the
    same weights, f32 on the CPU, default and fused-sublayer layers."""
    check_classifier(monkeypatch, h, fused_attn_out)
