"""K1, K2 and K3 of the torch package at the widths built besides
BERT-base's 768 that published BERTs use: BERT-large (H = 1,024, F = 4,096,
16 heads of 64) and google-research/bert's compact BERT-Medium (H = 512,
F = 2,048, 8 heads), BERT-Mini (256, 1,024, 4) and BERT-Tiny (128, 512,
2). Each test runs at every one of these widths the checks of
tests/_torch_width_cases.py: the plain versions against the JAX package's
Pallas kernels run in interpret mode, the gates, the launch plans and
scratch sizes of the bf16 and f32 kernels built for the width, the
device rule on the CPU, and the port's classifier at the width against
the JAX model on the same weights, in f32. tests/test_torch_odd_widths.py
runs the same checks at H = 384, 640 and 896. The CUDA kernels themselves
are checked against the plain versions on the card by
tests/test_torch_gpu.py and chip_smoke.py (phases 17 and 18)."""

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

WIDTHS = (1024, 512, 256, 128)
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
# 1,024 CLS rows, and the product's k in the slices of K3 at a single
# request (bf16; at 1,024 K3-f32's 4)
_SPLITS = {1024: (4, 4), 512: (8, 8), 256: (8, 4), 128: (8, 2)}


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
# batch. FFN: F / 64 chunks of F; K3: H / 64 k chunks. At H = 1,024 each
# row tile is two blocks (column groups of 512), so the split starts below
# 66 row tiles, and at 4,096 rows (128 blocks, just short of the card) the
# rule's waves x chunks is 63 x 1 against 1 x 64 for the FFN, a tie for
# K3. The compact widths are one block per row tile, as 768: at 4,096 rows
# (64 blocks) two slices tie with more, and the smaller wins
_PLANS = {
    1024: [(1, 1, 64, 1, 16, 1), (64, 1, 64, 1, 16, 1),
           (1024, 16, 4, 16, 4, 4), (4096, 64, 64, 1, 1, 16),
           (16384, 256, 1, 64, 1, 16), (16385, 257, 1, 64, 1, 16)],
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
    check_bf16_plan(h, m, tiles, slices, chunks, k3_slices, k3_chunks)


# (m, row tiles, slices, chunks per slice) of the bf16 FFN at the pair
# widths with F = 4H - 64, an odd number of chunks, from a single
# request's row to the ragged tile past the packed batch: below a wave the
# plan takes slices of one chunk, where the second block of a pair that
# takes turns at chunks (896, 1,024) has none
_PAIR_PLANS = {
    (1024, 4032): [(1, 1, 63, 1), (64, 1, 63, 1), (1024, 16, 63, 1),
                   (16384, 256, 1, 63), (16385, 257, 1, 63)],
}
_PAIR_CASES = [(h, f, *p) for (h, f), ps in _PAIR_PLANS.items() for p in ps]


@pytest.mark.parametrize("h,f,m,tiles,slices,chunks", _PAIR_CASES,
                         ids=[f"h{p[0]}-f{p[1]}-m{p[2]}"
                              for p in _PAIR_CASES])
def test_bf16_pair_plans_odd_chunks(h, f, m, tiles, slices, chunks):
    check_ffn_plan(h, f, m, tiles, slices, chunks)


# (m, row tiles, slices, chunks per slice) of the bf16 FFN's one-block
# forms at odd counts: F = 4H - 64 (7, 15 and 31 chunks, a prime or an odd
# number of them: slices of one chunk below a wave, the whole odd count in
# one slice at the ragged tile past the packed batch) and F = 4H at the odd
# tile counts of a request's 65, 127 and 129 rows and at 17 tiles (1,088
# rows), where H = 128 takes 4 slices of 2 chunks
_NARROW_PLANS = {
    (128, 448): [(1, 1, 7, 1), (65, 2, 7, 1), (127, 2, 7, 1), (129, 3, 7, 1),
                 (1088, 17, 7, 1), (16385, 257, 1, 7)],
    (256, 960): [(1, 1, 15, 1), (129, 3, 15, 1), (1088, 17, 15, 1),
                 (16385, 257, 1, 15)],
    (512, 1984): [(1, 1, 31, 1), (129, 3, 31, 1), (1088, 17, 31, 1),
                  (16385, 257, 1, 31)],
    (128, 512): [(65, 2, 8, 1), (127, 2, 8, 1), (129, 3, 8, 1),
                 (1088, 17, 4, 2)],
    (512, 2048): [(65, 2, 32, 1), (129, 3, 32, 1), (1088, 17, 32, 1)],
}
_NARROW_CASES = [(h, f, *p) for (h, f), ps in _NARROW_PLANS.items()
                 for p in ps]


@pytest.mark.parametrize("h,f,m,tiles,slices,chunks", _NARROW_CASES,
                         ids=[f"h{p[0]}-f{p[1]}-m{p[2]}"
                              for p in _NARROW_CASES])
def test_bf16_narrow_plans_odd_counts(h, f, m, tiles, slices, chunks):
    check_ffn_plan(h, f, m, tiles, slices, chunks)


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
    check_f32_plan(h, m, tiles, slices, k_tiles, k3_slices, k3_k_tiles)


# bytes of scratch per K1-f32 / K2-f32 call and per K3-f32 call at M =
# 16,384 (PERF.md): 805,306,368 and 75.5 MB at 1,024; K3-f32 at 512, 256
# and 128 takes its pass over whole rows there, which needs Wo's planes
# alone (2 H^2 f32), and K1-f32 / K2-f32 at 256 and 128 their one-pass
# form, which needs the weights' planes alone (4 F H f32)
_SCRATCH = {1024: (805_306_368, 75_497_472), 512: (385_875_968, 2_097_152),
            256: (4_194_304, 524_288), 128: (1_048_576, 131_072)}


@by_width
def test_f32_scratch_at_the_packed_batch(h):
    check_scratch(h, *_SCRATCH[h])


@pytest.mark.parametrize("input_ln", [True, False], ids=["k1", "k2"])
@by_width
def test_cpu_tensors_take_the_plain_path_and_launch_nothing(h, input_ln):
    check_cpu_rule(h, input_ln)


# K3 at 128 (the tile form, one block per 64-row tile, three an SM): every
# row count takes it, a single request's 64 rows among them; the width has
# no split path
_OVERLAP_M = (1, 37, 64, 1024, 4096, 8448, 16384, 16385)


@pytest.mark.parametrize("m", _OVERLAP_M,
                         ids=[f"h128-m{m}" for m in _OVERLAP_M])
def test_k3_overlap_rule(m):
    check_overlap_rule(128, m, True)


@pytest.mark.parametrize("forced", [True, False], ids=["on", "off"])
@by_width
def test_k3_overlap_forced(h, forced):
    check_overlap_forced(h, forced)


# ---- the slice: the classifier at each width, 2 layers (BERT-Tiny's
# full depth)

@pytest.mark.parametrize("fused_attn_out", [False, True],
                         ids=["default", "fused_attn_out"])
@by_width
def test_bert_large_classifier_matches_jax(monkeypatch, h, fused_attn_out):
    """The port's MultimodalClassifier at each width (BERT-large: H =
    1,024, 16 heads, F = 4,096, the vocabulary of BERT-large-cased,
    28,996; BERT-Medium, -Mini and -Tiny: H = 512, 256, 128 with 8, 4, 2
    heads, F = 4H, the uncased 30,522; 2 layers) against the JAX model on
    the same weights, f32 on the CPU, default and fused-sublayer
    layers."""
    check_classifier(monkeypatch, h, fused_attn_out)
