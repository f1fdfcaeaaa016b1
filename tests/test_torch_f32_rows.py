"""The choice between K3-f32's two forms at the narrow widths (H = 128-640)
and the plan each takes, on a card with 132 SMs that holds the H100's
clusters of the pass over whole rows (`csrc/attn_out_rows_f32.cuh`,
clusters of H / 128 blocks with the LayerNorm in the product's epilogue;
Wo's TF32 planes are its only scratch) at once: the pass wherever the
plan leaves the k loop whole and its rounds of clusters cost no more than
the three-launch form's waves and reduce pass, the three-launch form (f32
partials and split_reduce_f32) elsewhere. CPU only: the kernels themselves
run in tests/test_torch_gpu.py (`-k f32narrow`)."""

import pytest

from multimodal_rare_disease_tpu_torch.kernels import attn_out as k3
from multimodal_rare_disease_tpu_torch.kernels import ffn as k1

from _torch_width_cases import H100_ROWS_CLUSTERS

# (h, m, row tiles, slices, k-tiles per slice, pass over whole rows): the
# single request (1, then its length bucket 64), the 1,024 CLS rows, an
# Evaluator batch (2,048), 33 row tiles (4,224), 44 (5,632), 64 (8,192),
# the packed batch and a ragged tile past it. 128-384 have fewer than 16
# k-tiles, one slice at every count; 512 and 640 split theirs in two below
# 4,224 and 2,048 rows. The rounds of the H100's 132 / 66 / 39 / 30 / 22
# clusters against the three launches' waves of 132 tiles: at 384 44 row
# tiles are two rounds against one wave of 132 tiles, at 512 33 and 64
# tiles two and three rounds against one and two waves
_ROWS = [1, 64, 1024, 2048, 4224, 5632, 8192, 16384, 16385]
_FORMS = {128: [True] * 9, 256: [True] * 9,
          384: [True] * 5 + [False] + [True] * 3,
          512: [False] * 5 + [True, False, True, True],
          640: [False] * 3 + [True] * 6}
_PLANS = [(h, m, -(-m // 128),
           2 if (h == 512 and m <= 2048) or (h == 640 and m <= 1024) else 1,
           rows)
          for h, forms in _FORMS.items() for m, rows in zip(_ROWS, forms)]


@pytest.mark.parametrize("h,m,tiles,slices,rows", _PLANS,
                         ids=[f"f32narrow-h{p[0]}-m{p[1]}" for p in _PLANS])
def test_f32_narrow_form_and_plan(h, m, tiles, slices, rows):
    resident = H100_ROWS_CLUSTERS[h]
    plan = k3.attn_out_plan_f32(m, 132, h, resident)
    assert tuple(plan[:3]) == (tiles, slices, h // 32 // slices)
    assert plan.rows == rows == k3.f32_rows_form(m, h, 132, resident, slices)
    # Wo's two TF32 planes, then one f32 partial per slice where the
    # three-launch form runs
    assert plan.scratch == 2 * h * h + (0 if rows else slices * m * h)
    # the slices are gemm_plan_f32's either way
    assert k1.gemm_plan_f32(m, h, 132, h) == plan[:3]


@pytest.mark.parametrize("h", [768, 896, 1024, 1152, 1280, 1408, 1536])
@pytest.mark.parametrize("m", [64, 2048, 16384])
def test_f32_wider_forms_keep_their_partials(h, m):
    # from 768 up every call is the three-launch form, as before
    plan = k3.attn_out_plan_f32(m, 132, h, 132)
    assert not plan.rows
    assert plan.scratch == 2 * h * h + plan.slices * m * h


@pytest.mark.parametrize("h", k3.ROWS_F32_WIDTHS)
def test_f32_narrow_form_needs_a_known_cluster_count(h):
    # without the card's resident clusters (0), and with the k loop split,
    # the three launches run
    assert not k3.f32_rows_form(16384, h, 132, 0, 1)
    assert not k3.f32_rows_form(16384, h, 132, H100_ROWS_CLUSTERS[h], 2)
    assert not k3.attn_out_plan_f32(16384, 132, h).rows


def test_f32_narrow_widths_are_the_built_ones_below_768():
    assert k3.ROWS_F32_WIDTHS == tuple(
        h for h in k1.KERNEL_WIDTHS if h < 768)
