"""The choice between K1-f32's and K2-f32's two forms and the plan each
takes, on a card with 132 SMs: at H = 128 and 256 the one-pass form
(`csrc/ffn_rows_f32.cuh`: one block per row tile of 128 with h kept on the
chip; the weights' TF32 planes are its only scratch) wherever its waves of
row tiles cost no more than the four launches (the operands' planes, h
through device memory, the partials and split_reduce_f32), the four
launches elsewhere and at every other width. CPU only: the kernels
themselves run in tests/test_torch_gpu.py (`-k f32ffnrows`)."""

import pytest

from multimodal_rare_disease_tpu_torch.kernels import ffn as k1

# the single request (1, then its length bucket 64), the 1,024 CLS rows,
# the packed batch, a ragged tile past it, and 64 x 257 rows (129 tiles,
# the last ragged)
_ROWS = [1, 64, 1024, 16384, 16385, 64 * 257]
_F = {128: 512, 256: 1024, 384: 1536, 768: 3072}
# (row tiles, slices, k-tiles per slice) of gemm_plan_f32 at each of _ROWS:
# the four launches' split of h @ w2's k loop, which the plan keeps either
# way
_GEMM = {128: [(1, 2, 8), (1, 2, 8), (8, 2, 8), (128, 1, 16), (129, 1, 16),
               (129, 1, 16)],
         256: [(1, 4, 8), (1, 4, 8), (8, 4, 8), (128, 1, 32), (129, 1, 32),
               (129, 1, 32)],
         384: [(1, 6, 8), (1, 6, 8), (8, 4, 12), (128, 1, 48), (129, 1, 48),
               (129, 1, 48)],
         768: [(1, 12, 8), (1, 12, 8), (8, 8, 12), (128, 1, 96),
               (129, 1, 96), (129, 1, 96)]}
# the form: the pass at 128 and 256 for the packed batch and past it (one
# wave of at most 132 blocks against the four launches' 128-129 tiles);
# a single request's one tile and the CLS rows' 8 keep the four launches
_FORMS = {128: [False, False, False, True, True, True],
          256: [False, False, False, True, True, True],
          384: [False] * 6, 768: [False] * 6}
_PLANS = [(h, m, *g, rows) for h in _FORMS
          for m, g, rows in zip(_ROWS, _GEMM[h], _FORMS[h])]


@pytest.mark.parametrize("h,m,tiles,slices,k_tiles,rows", _PLANS,
                         ids=[f"f32ffnrows-h{p[0]}-m{p[1]}" for p in _PLANS])
def test_f32_ffn_form_and_plan(h, m, tiles, slices, k_tiles, rows):
    f = _F[h]
    plan = k1.ffn_plan_f32(m, f, 132, h)
    assert tuple(plan[:3]) == (tiles, slices, k_tiles)
    assert plan.rows == rows == k1.f32_rows_form(m, f, h, 132)
    # the pass: W1^T's and W2^T's planes; the four launches: x's, the
    # weights', h's, and one partial per slice
    assert plan.scratch == (4 * f * h if rows else
                            2 * m * h + 4 * f * h + 2 * m * f
                            + slices * m * h)


@pytest.mark.parametrize("h", [128, 256, 384, 768])
def test_f32_ffn_rows_needs_a_known_sm_count(h):
    # without the card's SM count (0) the four launches run
    assert not k1.f32_rows_form(16384, _F[h], h, 0)
    assert not k1.ffn_plan_f32(16384, _F[h], 0, h).rows


@pytest.mark.parametrize("h,first", [(128, 56), (256, 84)])
def test_f32_ffn_rows_crossing(h, first):
    # the fewest row tiles the pass takes (a wave of its blocks against the
    # four launches' time, PERF.md); from 133 tiles it costs two waves
    f = _F[h]
    assert not k1.f32_rows_form(128 * (first - 1), f, h, 132)
    assert k1.f32_rows_form(128 * first, f, h, 132)
    assert k1.f32_rows_form(128 * 132, f, h, 132)
    assert not k1.f32_rows_form(128 * 133, f, h, 132)


@pytest.mark.parametrize("h", [128, 256, 384, 768])
@pytest.mark.parametrize("rows", [True, False])
def test_f32_ffn_forced_form(h, rows):
    # a forced form (FORCE_F32_ROWS) is the pass only where it exists,
    # at any row count; the slices stay gemm_plan_f32's
    f = _F[h]
    plan = k1.ffn_plan_f32(64, f, 132, h, rows)
    assert plan.rows == (rows and h in (128, 256))
    assert tuple(plan[:3]) == k1.gemm_plan_f32(64, f, 132, h)
    assert (plan.scratch == 4 * f * h) == plan.rows


def test_f32_ffn_rows_widths_are_built_ones():
    assert k1.ROWS_F32_WIDTHS == (128, 256)
    assert set(k1.ROWS_F32_WIDTHS) <= set(k1.KERNEL_WIDTHS)
