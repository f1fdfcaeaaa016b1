"""K3: the fused post-LN BERT attention-output sublayer, by hand for
Hopper.

    y = LN(x + ctx @ wo + bo)

Counterpart of `multimodal_rare_disease_tpu/ops/pallas/attn_out.py`, whose
Pallas kernel runs in the model's compute dtype. Two CUDA sources replace
its `_attn_out_ln_kernel`: `csrc/attn_out_ln.cu` for bf16 (wgmma on 64-row
tiles, Wo streamed by TMA from a producer warpgroup) and
`csrc/attn_out_ln_f32.cu` for f32 (three launches: Wo split into TF32
planes, the f32 FFN's 3xTF32 wgmma GEMM fed by TMA with ctx split into its
planes in shared memory, and a LayerNorm pass over its f32 partials; at H
= 128-640, where `f32_rows_form` takes it, two: Wo's planes, then one pass
over whole rows by clusters of H / 128 blocks with the LayerNorm in the
product's epilogue, `csrc/attn_out_rows_f32.cuh`);
`attn_out_ln_plain` is the same math in PyTorch, under
the TPU module's numerics contract: the product accumulates in f32 and
is not rounded, bo and the residual are added in f32, and the two-pass
LayerNorm runs in f32 (unlike the JAX `attn_out_ln_reference`, which
rounds the projection and the residual sum to the compute dtype first).

Both sources are templates over the hidden width, built for
`ffn.KERNEL_WIDTHS` (768, BERT-base; 1,024, BERT-large; 512, 256 and 128,
the compact BERTs; 384, MiniLM; 640 and 896; 1,152, 1,280, 1,408 and
1,536), each width with C entries and launch counters of its own
(`LAUNCHES` at 768, `LAUNCHES_<width>` otherwise); the bf16 kernel is
`csrc/attn_out_ln.cuh`, instantiated by `csrc/attn_out_ln.cu`,
`csrc/attn_out_ln_overlap.cu` (128 and 640) and `csrc/attn_out_ln_wide.cu`.

When the output tiles would fill fewer blocks than the card has SMs (a
single request's 64 rows), the bf16 kernel splits the H / 64 k chunks of
the product into slices, each block writes an f32 partial of ctx @ wo for
its slice, and a second kernel (the FFN kernel's split reduction) sums
the partials in slice order before bo, the residual and LN. From H = 896
up the whole k loop runs, where it is faster (the packed batch), on
persistent clusters of four blocks, one per quarter of the columns, that
walk groups of 128 rows (each Wo tile a block takes serves 128 rows) and
share the LayerNorm's row statistics over distributed shared memory;
otherwise, and on the split path, on a cluster pair of two column groups
of H / 2 (at 896 and 1,024 sharing ctx by TMA multicast, above 1,024
streaming it). At H = 640 the whole k loop has an overlapped form
(`csrc/attn_out_ln_overlap.cu`), taken where `overlap_form` says so: the
same persistent kernel in clusters of two, each block 128 rows by 320
columns on n160 Wo tiles, the producer loading the next group while the
consumers finish the last. At H = 128 every call takes the tile form
(the same source), the width's only form: one block per 64-row tile with
x loaded up front beside ctx and all of Wo, three blocks an SM, so that
one tile's LayerNorm and store overlap the other tiles' loads; it beat
the split path at every row count it was timed at, so 128 has none.
Python passes `slices` 0 to the C entry to ask for either
(`launch_slices`). The f32 GEMM writes f32 partials (one slice at the
packed batch) and splits its H / 32 k-tiles the same way below 132
output tiles; at H = 128-640 the pass over whole rows, which writes only
y, runs instead where its rounds of clusters cost less (`f32_rows_form`).
`attn_out_plan` and `attn_out_plan_f32` choose the slices by
`ffn.split_plan`'s and `ffn.gemm_plan_f32`'s rules, and
`attn_out_ln_plain(..., slices=S)` emulates the split sum in the
kernel's order, so the CPU tests reach both.

Device rule, as `kernels/ffn.py`: CPU tensors take the plain version;
CUDA tensors launch the kernel of their dtype or raise, except where
`attn_out_route` (the stated gate `attn_out_ln_fusible`, x in ctx's
dtype and the vectors in it too) sends them to the plain version, which
counts in `PLAIN_ON_CUDA`. A launch raises when grad mode is on and an
input requires grad: the kernels have no backward. `FORCE_PLAIN` is set
only by tests and chip_smoke.py.
"""

from __future__ import annotations

import functools

import torch

from multimodal_rare_disease_tpu_torch.kernels import build
from multimodal_rare_disease_tpu_torch.kernels.ffn import (
    KERNEL_F32_COLS,
    KERNEL_F32_ROWS,
    KERNEL_ROWS,
    KERNEL_WIDTHS,
    ROUTE_BF16,
    ROUTE_F32,
    ROUTE_PLAIN,
    F32Plan,
    RowPlan,
    count_launch,
    dot_f32,
    entry,
    gemm_plan_f32,
    ln_f32,
    no_autograd,
    sm_count,
    split_plan,
)

FORCE_PLAIN = False
# launches of the bf16 and of the f32 CUDA kernel at H = 768, and the same
# at the other built widths (incremented only where each is launched)
LAUNCHES = 0
LAUNCHES_F32 = 0
LAUNCHES_1024 = 0
LAUNCHES_F32_1024 = 0
LAUNCHES_512 = 0
LAUNCHES_F32_512 = 0
LAUNCHES_256 = 0
LAUNCHES_F32_256 = 0
LAUNCHES_128 = 0
LAUNCHES_F32_128 = 0
LAUNCHES_384 = 0
LAUNCHES_F32_384 = 0
LAUNCHES_640 = 0
LAUNCHES_F32_640 = 0
LAUNCHES_896 = 0
LAUNCHES_F32_896 = 0
LAUNCHES_1152 = 0
LAUNCHES_F32_1152 = 0
LAUNCHES_1280 = 0
LAUNCHES_F32_1280 = 0
LAUNCHES_1408 = 0
LAUNCHES_F32_1408 = 0
LAUNCHES_1536 = 0
LAUNCHES_F32_1536 = 0
# CUDA calls that the shape/dtype gate sent to the plain version
PLAIN_ON_CUDA = 0
# the bf16 calls above that took the overlapped form at 640 (`overlap_form`)
# or the tile form at 128 (every call there), also counted in their
# LAUNCHES_<width>
OVERLAP_CALLS = 0

# the k chunk csrc/attn_out_ln.cu was written for (see its header); the f32
# kernel's GEMM tiles as `ffn.gemm_plan_f32` says
KERNEL_CHUNK = 64
# the widths whose f32 kernel has the pass over whole rows
# (csrc/attn_out_rows_f32.cuh): clusters of hidden / 128 blocks
ROWS_F32_WIDTHS = (128, 256, 384, 512, 640)
# the pass against the three launches, in percent of one wave of the
# three-launch GEMM's 128 x 128 tiles, from each launch's time on the H100
# at 64 to 16,384 rows (build/attn_out_f32_probe.py; PERF.md §6): the
# pass's first round of clusters ~105, each further round ~88 (the next
# tile's loads overlap the last one's epilogue); the reduce pass ~10 plus
# ~1.1 a row tile
ROWS_FIRST_ROUND = 105
ROWS_ROUND = 88
REDUCE_FIXED = 10
REDUCE_PER_10_TILES = 11
# the widths whose bf16 kernel has the overlapped form
# (csrc/attn_out_ln_overlap.cu): 640 on persistent clusters of two blocks
# of 128 rows where `overlap_form` takes it, 128 (the tile form, one block
# per 64-row tile, three an SM) at every row count
OVERLAP_WIDTHS = (128, 640)
# set only by tests and scripts: True sends every bf16 call at 640 to the
# overlapped form, False to the one-block form; None leaves it to
# `overlap_form`
FORCE_OVERLAP = None


def attn_out_plan(m: int, n_sm: int, hidden: int = 768) -> RowPlan:
    """The launch of the kernel for m rows at a built hidden width on a
    card with n_sm SMs: `split_plan` over the hidden / 64 k chunks of the
    product (12 at 768, 16 at 1,024, 8 / 4 / 2 at 512 / 256 / 128, 6 /
    10 / 14 at 384 / 640 / 896, 18 / 20 / 22 / 24 at 1,152 / 1,280 /
    1,408 / 1,536), two blocks a tile from 896 up. With one slice the
    kernel there runs as clusters of four over groups of two tiles, as
    many as the card holds at once, where their rounds take less time than
    the pairs' waves (csrc/attn_out_ln.cuh::quad_clusters): the same blocks
    a tile. At 128 no call takes the plan: `launch_slices` sends every one
    to the tile form."""
    return split_plan(m, hidden // KERNEL_CHUNK, n_sm, hidden=hidden)


def overlap_form(hidden: int, slices: int) -> bool:
    """Whether a bf16 call at 640 takes the overlapped form
    (csrc/attn_out_ln_overlap.cu): where the plan leaves the k loop whole
    (`slices` 1: on 132 SMs every count from 7,553 rows, the packed batch
    among them, and none below). A single request's 64 rows and the other
    split counts keep the one-block form's split path. On the H100 the
    form's 66 resident pairs walk the row groups of 128 in as many rounds
    as the one-block form's 64-row tiles take waves over its 132 SMs, each
    group cheaper than two tiles."""
    return hidden == 640 and slices == 1


def launch_slices(m: int, hidden: int, n_sm: int) -> int:
    """The `slices` the bf16 C entry takes for m rows: 0 at 128 (the tile
    form, the width's only form), 0 at 640 where `overlap_form` (or
    FORCE_OVERLAP) takes the overlapped form, else the plan's slices of
    the k loop."""
    if hidden == 128:
        return 0
    slices = attn_out_plan(m, n_sm, hidden).slices
    if hidden == 640 and (FORCE_OVERLAP if FORCE_OVERLAP is not None
                          else overlap_form(hidden, slices)):
        return 0
    return slices


def f32_rows_form(m: int, hidden: int, n_sm: int, resident: int,
                  slices: int) -> bool:
    """Whether a call of the f32 kernel for m rows takes the pass over
    whole rows (csrc/attn_out_rows_f32.cuh) on a card with n_sm SMs that
    holds `resident` of its clusters at once (`f32_rows_clusters`; 0: not
    known, never): at the widths that have one, when the plan leaves the k
    loop whole (`slices` 1; with more, a single request's 64 rows at 512
    and 640, the three launches spread it over more SMs than a row tile's
    cluster has), and when its rounds of clusters over the row tiles cost
    no more than the three launches' waves of 128 x 128 tiles and their
    reduce pass (ROWS_FIRST_ROUND ..: at 512 the 33 row tiles of 4,224
    rows are two rounds of 30 clusters against one wave of 132 tiles)."""
    if hidden not in ROWS_F32_WIDTHS or slices != 1 or resident < 1:
        return False
    tiles = -(-m // KERNEL_F32_ROWS)
    rounds = -(-tiles // resident)
    waves = -(-tiles * (hidden // KERNEL_F32_COLS) // n_sm)
    return (ROWS_FIRST_ROUND + ROWS_ROUND * (rounds - 1)
            <= 100 * waves + REDUCE_FIXED + REDUCE_PER_10_TILES * tiles // 10)


@functools.lru_cache(maxsize=4096)
def attn_out_plan_f32(m: int, n_sm: int, hidden: int = 768,
                      resident: int = 0) -> F32Plan:
    """The launch of the f32 kernel for m rows at a built hidden width on
    a card with n_sm SMs: `gemm_plan_f32` over the hidden / 32 k-tiles of
    the product (at most hidden / 256 slices of 8), the form
    (`f32_rows_form`, with `resident` clusters of the pass over whole
    rows), and the scratch of one call: Wo^T's TF32 planes (2 * hidden^2)
    and, unless the pass over whole rows runs, the f32 partials [slices,
    m, hidden]. Cached, as `split_plan`."""
    tiles, slices, k_tiles = gemm_plan_f32(m, hidden, n_sm, hidden)
    h = hidden
    rows = f32_rows_form(m, h, n_sm, resident, slices)
    return F32Plan(tiles, slices, k_tiles,
                   2 * h * h + (0 if rows else slices * m * h), rows)


@functools.lru_cache(maxsize=64)
def f32_rows_clusters(dev: torch.device, hidden: int) -> int:
    """The clusters of the pass over whole rows at `hidden` (one of
    ROWS_F32_WIDTHS) that the card holds at once
    (cudaOccupancyMaxActiveClusters): a launch takes as many, at most one
    per row tile of 128. Read once per card and width."""
    lib = build.load_library(dev)
    with torch.cuda.device(dev):
        return getattr(lib, f"mrd_attn_out_f32_clusters_h{hidden}")()


def attn_out_ln_fusible(m: int, hidden: int, dtype: torch.dtype) -> bool:
    """Shape/dtype gate of the CUDA kernels: they tile rows (64 in bf16,
    128 in f32) and mask the ragged tile, so any m >= 1 works (the TPU's
    m >= 32, m % 16 == 0 came from its (8, 128) tiling), and they are
    compiled for the widths of `ffn.KERNEL_WIDTHS` (every multiple of 128
    up to 1,536), in bf16 and in f32."""
    return (m >= 1 and hidden in KERNEL_WIDTHS
            and dtype in (torch.bfloat16, torch.float32))


def attn_out_route(ctx_dtype: torch.dtype, x_dtype: torch.dtype,
                   vec_dtypes, m: int, hidden: int) -> str:
    """Which CUDA path a call takes: the kernel of ctx's dtype (ROUTE_BF16
    or ROUTE_F32) inside `attn_out_ln_fusible` when x and bo, gamma and
    beta (`vec_dtypes`) are in that dtype too (a model passes its own
    vectors, cast to its dtype), else ROUTE_PLAIN, the counted plain
    version."""
    if not attn_out_ln_fusible(m, hidden, ctx_dtype) \
            or x_dtype != ctx_dtype or set(vec_dtypes) != {ctx_dtype}:
        return ROUTE_PLAIN
    return ROUTE_F32 if ctx_dtype == torch.float32 else ROUTE_BF16


def attn_out_ln_plain(ctx2d: torch.Tensor, x2d: torch.Tensor,
                      wo: torch.Tensor, bo: torch.Tensor, gamma: torch.Tensor,
                      beta: torch.Tensor, eps: float = 1e-12, *,
                      slices: int = 1) -> torch.Tensor:
    """The kernel's math in PyTorch. ctx2d, x2d [M, H]; wo [H, H] as
    (in, out); bo, gamma, beta [H]. The output is in ctx2d's dtype.
    `slices` > 1 emulates the kernel's split-K path: ctx @ wo as one f32
    partial per slice of the k rows, summed in slice order."""
    dt = ctx2d.dtype
    f32 = torch.float32
    wo = wo.to(dt)
    n = wo.shape[0] // slices
    acc = dot_f32(ctx2d[:, :n], wo[:n]) if slices > 1 else dot_f32(ctx2d, wo)
    for s in range(1, slices):
        acc = acc + dot_f32(ctx2d[:, s * n:(s + 1) * n], wo[s * n:(s + 1) * n])
    z = acc + bo.to(f32) + x2d.to(f32)
    return ln_f32(z, gamma.to(f32), beta.to(f32), eps).to(dt)


def fused_attn_out_ln(ctx2d: torch.Tensor, x2d: torch.Tensor,
                      wo: torch.Tensor, bo: torch.Tensor, gamma: torch.Tensor,
                      beta: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """LN(x + ctx @ wo + bo) as [M, H] in ctx2d.dtype. Same layout as the
    TPU entry point: wo [H_in, H_out] (a transposed view of an nn.Linear
    weight costs no copy)."""
    global PLAIN_ON_CUDA
    args = (ctx2d, x2d, wo, bo, gamma, beta, eps)
    if ctx2d.device.type == "cpu" or FORCE_PLAIN:
        return attn_out_ln_plain(*args)
    if ctx2d.device.type != "cuda":
        raise RuntimeError(
            f"fused_attn_out_ln: unsupported device {ctx2d.device}")
    m, hidden = ctx2d.shape
    route = attn_out_route(ctx2d.dtype, x2d.dtype,
                           (v.dtype for v in (bo, gamma, beta)), m, hidden)
    if route == ROUTE_PLAIN:
        PLAIN_ON_CUDA += 1
        return attn_out_ln_plain(*args)
    no_autograd("fused_attn_out_ln", *args[:6])
    return (_launch_f32 if route == ROUTE_F32 else _launch)(*args)


def _launch(ctx, x, wo, bo, gamma, beta, eps):
    global OVERLAP_CALLS
    dev = ctx.device
    m, hidden = ctx.shape
    if x.shape != ctx.shape or wo.shape != (hidden, hidden):
        raise ValueError(f"fused_attn_out_ln: x {tuple(x.shape)} / wo "
                         f"{tuple(wo.shape)} do not match ctx [{m}, {hidden}]")
    bf = torch.bfloat16
    ctx, x = ctx.contiguous(), x.contiguous()
    # the kernel reads nn.Linear's [out, in] layout: Wo^T
    wot = wo.to(bf).t().contiguous()
    vecs = [v.contiguous() for v in (bo, gamma, beta)]  # bf16 (the gate)
    for t in (x, wot, *vecs):
        if t.device != dev:
            raise ValueError(
                f"fused_attn_out_ln: tensors on {t.device} and {dev}")
    if any(v.numel() != hidden for v in vecs):
        raise ValueError("fused_attn_out_ln: bias/LayerNorm vectors do not "
                         "match")
    # the rows are read by TMA (tensor maps) and 16 bytes at a time
    if any(t.data_ptr() % 16 for t in (ctx, x, wot)):
        raise ValueError("fused_attn_out_ln: ctx, x and wo must be 16-byte "
                         "aligned")
    y = torch.empty_like(ctx)
    lib = build.load_library(dev)
    fn = entry(lib, "mrd_attn_out_ln_bf16", hidden)
    slices = launch_slices(m, hidden, sm_count(dev))
    # the split path's f32 partials (the plan's scratch)
    scratch = (torch.empty((slices, m, hidden), dtype=torch.float32,
                           device=dev) if slices > 1 else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        # slices 0: the overlapped form at 640, the tile form at 128
        err = fn(ctx.data_ptr(), x.data_ptr(), wot.data_ptr(),
                 *(v.data_ptr() for v in vecs), y.data_ptr(),
                 scratch.data_ptr() if scratch is not None else None, m,
                 slices, float(eps), stream)
    build.check_launch(lib, err, "attn_out_ln_bf16")
    count_launch(globals(), "LAUNCHES", hidden)
    OVERLAP_CALLS += slices == 0
    return y


def _launch_f32(ctx, x, wo, bo, gamma, beta, eps):
    dev = ctx.device
    m, hidden = ctx.shape
    if x.shape != ctx.shape or wo.shape != (hidden, hidden):
        raise ValueError(f"fused_attn_out_ln: x {tuple(x.shape)} / wo "
                         f"{tuple(wo.shape)} do not match ctx [{m}, {hidden}]")
    ctx, x = ctx.contiguous(), x.contiguous()
    f32 = torch.float32
    # f32 as it is: the kernel reads nn.Linear's [out, in] layout, Wo^T (a
    # transposed view of an nn.Linear weight costs no copy), and splits it
    # into TF32 planes itself
    wot = wo.to(f32).t().contiguous()
    vecs = [v.contiguous() for v in (bo, gamma, beta)]  # f32 (the route)
    for t in (x, wot, *vecs):
        if t.device != dev:
            raise ValueError(
                f"fused_attn_out_ln: tensors on {t.device} and {dev}")
    if any(v.numel() != hidden for v in vecs):
        raise ValueError("fused_attn_out_ln: bias/LayerNorm vectors do not "
                         "match")
    # ctx is read by TMA (a tensor map), the rest 16 bytes at a time
    ctx, x, *vecs = [t.clone() if t.data_ptr() % 16 else t
                     for t in (ctx, x, *vecs)]
    if wot.data_ptr() % 16:
        raise ValueError("fused_attn_out_ln: wo must be 16-byte aligned")
    y = torch.empty_like(ctx)
    lib = build.load_library(dev)
    fn = entry(lib, "mrd_attn_out_ln_f32", hidden)
    resident = (f32_rows_clusters(dev, hidden)
                if hidden in ROWS_F32_WIDTHS else 0)
    plan = attn_out_plan_f32(m, sm_count(dev), hidden, resident)
    scratch = torch.empty(plan.scratch, dtype=f32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        # slices 0: the pass over whole rows
        err = fn(ctx.data_ptr(), x.data_ptr(), wot.data_ptr(),
                 *(v.data_ptr() for v in vecs), y.data_ptr(),
                 scratch.data_ptr(), m, 0 if plan.rows else plan.slices,
                 float(eps), stream)
    build.check_launch(lib, err, "attn_out_ln_f32")
    count_launch(globals(), "LAUNCHES_F32", hidden)
    return y
