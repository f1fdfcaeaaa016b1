"""K1 and K2: the fused post-LN BERT FFN sublayer, by hand for Hopper.

    y = LN2(x + GELU(x @ w1 + b1) @ w2 + b2)
    K1: x = LN0(z), with pre_gamma / pre_beta (the default layer)
    K2: x = the input rows (after K3, `kernels/attn_out.py`)

Counterpart of `multimodal_rare_disease_tpu/ops/pallas/ffn.py`, whose
Pallas kernels run in the model's compute dtype. Two CUDA sources
replace its `_ffn_pre_ln_kernel` (K1) and `_ffn_ln_kernel` (K2):
`csrc/ffn_ln.cuh` for bf16 (one fused kernel, wgmma fed by TMA, 64 rows
per block; instantiated by `csrc/ffn_ln.cu`, `csrc/ffn_ln_odd.cu`,
`csrc/ffn_ln_wide.cu` and `csrc/ffn_ln_wide2.cu`) and `csrc/ffn_ln_f32.cu`
for f32 (a sequence of launches:
the operands split into TF32 planes, the two products as 3xTF32 wgmma
GEMMs fed by TMA, with h through device memory, and a LayerNorm pass; at
H = 128 and 256, where `f32_rows_form` takes it, two: the weights'
planes, then one pass over whole row tiles of 128 that keeps h on the
chip, `csrc/ffn_rows_f32.cuh`, built by `csrc/ffn_rows_f32.cu`);
`ffn_ln_plain` is the same math in PyTorch. Both sources are templates
over the hidden width, built for KERNEL_WIDTHS: 768 (BERT-base), 1,024
(BERT-large), 512, 256 and 128 (google-research/bert's BERT-Medium,
-Mini and -Tiny), 384 (microsoft/MiniLM-L12-H384), 640 and 896, and
1,152, 1,280, 1,408 and 1,536 (microsoft/deberta-v2-xlarge's width),
each width with C entries of its own. From 896 up a row tile's output
columns are cut into two groups of H / 2, one bf16 block each
(`KERNEL_GROUPS`), run as a cluster of two (a pair) that shares the GELU
chunks and LN2's row statistics over distributed shared memory: at 896
and 1,024 the two blocks take turns at whole chunks and copy each to the
other; above 1,024 each block keeps only its half of x, and the pair
exchanges the f32 partials of x @ w1 over its halves. Every other width
is one block per row tile.

When the output tiles would fill fewer blocks than the card has SMs,
the bf16 kernel splits F into slices and the f32 one the k loop of
h @ w2; each block writes an f32 partial of h @ w2 for its slice, and a
second kernel sums the partials in slice order before the residual and
LN2. `ffn_plan` and `ffn_plan_f32` choose the slices; they are plain
Python, and `ffn_ln_plain(..., slices=S)` emulates the split sum in the
kernel's order, so the CPU tests reach both.

Device rule: `fused_ffn_ln` runs `ffn_ln_plain` for CPU tensors; for
CUDA tensors it launches a kernel or raises. `ffn_route` picks the
kernel from the dtypes and the shape: bf16 or f32 x inside the stated
shape gate `ffn_ln_fusible` (the counterpart of the TPU module's gate of
the same name), with vectors the kernel reads (K1 bf16: f32 or bf16; K2
bf16: bf16, as the model passes its own cast to bf16; f32: f32). Any
other CUDA call runs the plain version and is counted in
`PLAIN_ON_CUDA`, which the main path keeps at 0. `FORCE_PLAIN` (set
only by tests and chip_smoke.py, the counterpart of the TPU module's
`FORCE_INTERPRET`) sends CUDA tensors to the plain version to build an
on-card reference. The kernels have no backward, so a launch raises
when grad mode is on and an input requires grad (`no_autograd`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from multimodal_rare_disease_tpu_torch.kernels import build

_SQRT1_2 = 0.7071067811865476

FORCE_PLAIN = False
# launches of the bf16 CUDA kernel with (K1) and without (K2) the input
# LayerNorm, and of the f32 one, at H = 768; the same at the other built
# widths (`_<width>`); each incremented only where its kernel is launched
LAUNCHES_K1 = 0
LAUNCHES_K2 = 0
LAUNCHES_K1_F32 = 0
LAUNCHES_K2_F32 = 0
LAUNCHES_K1_1024 = 0
LAUNCHES_K2_1024 = 0
LAUNCHES_K1_F32_1024 = 0
LAUNCHES_K2_F32_1024 = 0
LAUNCHES_K1_512 = 0
LAUNCHES_K2_512 = 0
LAUNCHES_K1_F32_512 = 0
LAUNCHES_K2_F32_512 = 0
LAUNCHES_K1_256 = 0
LAUNCHES_K2_256 = 0
LAUNCHES_K1_F32_256 = 0
LAUNCHES_K2_F32_256 = 0
LAUNCHES_K1_128 = 0
LAUNCHES_K2_128 = 0
LAUNCHES_K1_F32_128 = 0
LAUNCHES_K2_F32_128 = 0
LAUNCHES_K1_384 = 0
LAUNCHES_K2_384 = 0
LAUNCHES_K1_F32_384 = 0
LAUNCHES_K2_F32_384 = 0
LAUNCHES_K1_640 = 0
LAUNCHES_K2_640 = 0
LAUNCHES_K1_F32_640 = 0
LAUNCHES_K2_F32_640 = 0
LAUNCHES_K1_896 = 0
LAUNCHES_K2_896 = 0
LAUNCHES_K1_F32_896 = 0
LAUNCHES_K2_F32_896 = 0
LAUNCHES_K1_1152 = 0
LAUNCHES_K2_1152 = 0
LAUNCHES_K1_F32_1152 = 0
LAUNCHES_K2_F32_1152 = 0
LAUNCHES_K1_1280 = 0
LAUNCHES_K2_1280 = 0
LAUNCHES_K1_F32_1280 = 0
LAUNCHES_K2_F32_1280 = 0
LAUNCHES_K1_1408 = 0
LAUNCHES_K2_1408 = 0
LAUNCHES_K1_F32_1408 = 0
LAUNCHES_K2_F32_1408 = 0
LAUNCHES_K1_1536 = 0
LAUNCHES_K2_1536 = 0
LAUNCHES_K1_F32_1536 = 0
LAUNCHES_K2_F32_1536 = 0
# CUDA calls that the shape/dtype gate sent to the plain version
PLAIN_ON_CUDA = 0
# the f32 calls above that took the one-pass form (`f32_rows_form`), also
# counted in their LAUNCHES_K*_F32_<width>
ROWS_F32_CALLS = 0

# The hidden widths the CUDA kernels of K1, K2 and K3 (kernels/attn_out.py)
# are built for, in bf16 and in f32, each with the column groups a bf16 row
# tile is cut into (one block each; two run as a cluster that shares the
# LayerNorm's row statistics). Any other width takes the counted plain
# version. A width's C entries and launch counters carry no suffix at 768,
# `_h<width>` and `_<width>` otherwise (`build.ROW_WIDTHS` binds the
# entries of the same widths). Widths from 1,664 up stay plain: the JAX
# package's bf16 Pallas FFN itself stops fitting its VMEM limit there
# (ROADMAP Queue 2).
KERNEL_GROUPS = {128: 1, 256: 1, 384: 1, 512: 1, 640: 1, 768: 1, 896: 2,
                 1024: 2, 1152: 2, 1280: 2, 1408: 2, 1536: 2}
KERNEL_WIDTHS = tuple(KERNEL_GROUPS)

# the tiling csrc/ffn_ln.cuh (bf16) and the f32 GEMM of csrc/ffn_ln_f32.cu
# and csrc/attn_out_ln_f32.cu (csrc/gemm_tf32x3.cuh) were written for (see
# their headers): bf16 F chunks and row tiles; the f32 GEMM's output tiles
# (rows x columns) and k-tiles, and the fewest k-tiles a slice of a split
# k loop keeps
KERNEL_CHUNK = 64
KERNEL_ROWS = 64
KERNEL_F32_ROWS = 128
KERNEL_F32_COLS = 128
KERNEL_F32_K = 32
KERNEL_F32_MIN_K_TILES = 8

# what `ffn_route` (and `attn_out.attn_out_route`) return
ROUTE_BF16, ROUTE_F32, ROUTE_PLAIN = "bf16", "f32", "plain"

# the widths whose f32 kernels have the one-pass form
# (csrc/ffn_rows_f32.cuh): one block per row tile of 128 holds the tile's
# whole output, h stays on the chip
ROWS_F32_WIDTHS = (128, 256)
# the pass against the four launches, in us at F = 4H, from K1-f32's
# device time on the H100 (700 W) at 64 to 16,385 rows
# (build/ffn_f32_probe.py; PERF.md §6): a wave of the pass's blocks (one a
# row tile, at most one an SM) ROWS_WAVE_US; the four launches
# FOUR_FIXED_US plus FOUR_TILE_US a row tile (the line through 33 and 129
# tiles; below 33 their fixed part is larger still). The pass takes 56 row
# tiles and up at 128, 84 and up at 256
ROWS_WAVE_US = {128: 54.0, 256: 165.0}
FOUR_FIXED_US = {128: 15.8, 256: 16.5}
FOUR_TILE_US = {128: 0.686, 256: 1.783}
# set only by tests and scripts: True sends every f32 call at
# ROWS_F32_WIDTHS to the pass, False to the four launches; None leaves it
# to `f32_rows_form`
FORCE_F32_ROWS: Optional[bool] = None


class RowPlan(NamedTuple):
    """How one call of a 64-row tile kernel is launched: `tiles` tiles
    of 64 rows (each `KERNEL_GROUPS[hidden]` blocks) times `slices`
    slices of its k loop, each of `chunks` chunks of 64; `scratch` is the
    shape of the f32 partials buffer, None where the blocks apply the
    LayerNorm themselves."""
    tiles: int
    slices: int
    chunks: int
    scratch: Optional[Tuple[int, int, int]]


def split_slices(tiles: int, n_chunks: int, n_sm: int,
                 max_slices: Optional[int] = None) -> int:
    """How many slices to cut a k loop of n_chunks into, for `tiles`
    output tiles on a card with n_sm SMs: one when the tiles fill the
    card; else S, a divisor of n_chunks (at most max_slices), that
    minimises the waves of one-block-per-SM times the chunks per block,
    ceil(tiles * S / n_sm) * (n_chunks / S); on a tie the smaller S,
    which writes and sums fewer partials."""
    if tiles >= n_sm:
        return 1
    return min((s for s in range(1, (max_slices or n_chunks) + 1)
                if n_chunks % s == 0),
               key=lambda s: (-(-tiles * s // n_sm) * (n_chunks // s), s))


@functools.lru_cache(maxsize=4096)
def split_plan(m: int, n_chunks: int, n_sm: int,
               rows: int = KERNEL_ROWS, hidden: int = 768) -> RowPlan:
    """The launch of a row tile kernel (FFN: the F chunks; K3, the
    attention-output kernel: the hidden / 64 k chunks) for m rows in tiles
    of `rows` at a built width `hidden` on a card with n_sm SMs:
    `split_slices` over the blocks (row tiles times the width's column
    groups). Cached: a launch asks for it on every call, with few
    distinct row counts."""
    tiles = -(-m // rows)
    slices = split_slices(tiles * KERNEL_GROUPS[hidden], n_chunks, n_sm)
    scratch = (slices, m, hidden) if slices > 1 else None
    return RowPlan(tiles, slices, n_chunks // slices, scratch)


def ffn_plan(m: int, f: int, n_sm: int, hidden: int = 768) -> RowPlan:
    """The launch of the bf16 FFN kernel for m rows, hidden width
    `hidden` and intermediate width f: `split_plan` over the f / 64
    chunks of F."""
    return split_plan(m, f // KERNEL_CHUNK, n_sm, hidden=hidden)


class F32Plan(NamedTuple):
    """How one call of an f32 kernel's 3xTF32 GEMM (csrc/gemm_tf32x3.cuh)
    with H output columns is launched: `tiles` row tiles of 128 (times
    H / 128 column tiles of 128), the k loop in `slices` slices of
    `k_tiles` k-tiles of 32 each; `scratch` f32 elements of the call's
    scratch buffer. The FFN (`ffn_plan_f32`): the TF32 planes (hi, lo) of
    x [m, H], of W1^T and W2^T (f * H each) and of h [m, f], and the
    partials [slices, m, H] of h @ w2, the product that is split, or,
    where `rows` (its one-pass form, `f32_rows_form`), the weights'
    planes alone. K3 (`attn_out.attn_out_plan_f32`): the planes of Wo^T
    [H, H] and the partials of ctx @ wo, or, where `rows` (its pass over
    whole rows, `attn_out.f32_rows_form`), the planes alone."""
    tiles: int
    slices: int
    k_tiles: int
    scratch: int
    rows: bool = False


def gemm_plan_f32(m: int, k: int, n_sm: int,
                  hidden: int = 768) -> Tuple[int, int, int]:
    """(row tiles, slices, k-tiles per slice) of the 3xTF32 GEMM with
    `hidden` output columns and a k loop of k / 32 k-tiles, for m rows on
    a card with n_sm SMs: `split_slices` over its output tiles, with at
    least KERNEL_F32_MIN_K_TILES k-tiles per slice (a block's fixed cost,
    the prologue of its 3-stage ring and its epilogue, is a few k-tiles'
    time)."""
    tiles = -(-m // KERNEL_F32_ROWS)
    n_k = k // KERNEL_F32_K
    slices = split_slices(tiles * (hidden // KERNEL_F32_COLS), n_k,
                          n_sm, max(1, n_k // KERNEL_F32_MIN_K_TILES))
    return tiles, slices, n_k // slices


def f32_rows_form(m: int, f: int, hidden: int, n_sm: int) -> bool:
    """Whether an f32 FFN call for m rows takes the one-pass form
    (csrc/ffn_rows_f32.cuh) on a card with n_sm SMs (0: not known, never):
    at the widths that have one, when its waves of row tiles cost no more
    than the four launches (ROWS_WAVE_US .., both scaled by f / 4H). At
    a single request's 64 rows and the 1,024 CLS rows the pass's 1 and 8
    blocks would leave the card nearly idle for a whole tile's time."""
    if hidden not in ROWS_F32_WIDTHS or n_sm < 1:
        return False
    tiles = -(-m // KERNEL_F32_ROWS)
    waves = -(-tiles // n_sm)
    scale = f / (4 * hidden)
    return (waves * ROWS_WAVE_US[hidden] * scale
            <= FOUR_FIXED_US[hidden] + FOUR_TILE_US[hidden] * tiles * scale)


@functools.lru_cache(maxsize=4096)
def ffn_plan_f32(m: int, f: int, n_sm: int, hidden: int = 768,
                 rows: Optional[bool] = None) -> F32Plan:
    """The launch of the f32 FFN kernels for m rows, hidden width
    `hidden` and intermediate width f: `gemm_plan_f32` of the second
    product (k = f), and the form: the one-pass form where `rows` (None:
    `f32_rows_form`; it exists only at ROWS_F32_WIDTHS), whose scratch is
    the weights' planes alone. Cached, as `split_plan`."""
    tiles, slices, k_tiles = gemm_plan_f32(m, f, n_sm, hidden)
    h = hidden
    rows = (f32_rows_form(m, f, h, n_sm) if rows is None
            else rows and h in ROWS_F32_WIDTHS)
    if rows:
        return F32Plan(tiles, slices, k_tiles, 4 * f * h, True)
    return F32Plan(tiles, slices, k_tiles,
                   2 * m * h + 4 * f * h + 2 * m * f + slices * m * h)


def ffn_ln_fusible(m: int, hidden: int, intermediate: int,
                   dtype: torch.dtype) -> bool:
    """Shape/dtype gate of the CUDA kernels. They tile rows (64 in bf16,
    128 in f32) and mask the ragged tile, so any m >= 1 works (the TPU's
    m >= 32, m % 16 == 0 came from its (8, 128) tiling and does not
    apply); they are compiled for the hidden widths of KERNEL_WIDTHS
    (BERT-base's 768, BERT-large's 1,024, the compact BERTs' 512, 256
    and 128, MiniLM's 384, 640 and 896, and 1,152 to 1,536: every
    multiple of 128 up to 1,536) and walk F in chunks of 64
    in bf16 (which also keeps W2's rows a multiple of TMA's 16 bytes)
    and in output tiles of 128 in f32."""
    chunk = {torch.bfloat16: KERNEL_CHUNK,
             torch.float32: KERNEL_F32_COLS}.get(dtype)
    return (chunk is not None and m >= 1 and hidden in KERNEL_WIDTHS
            and intermediate > 0 and intermediate % chunk == 0)


def ffn_route(x_dtype: torch.dtype, vec_dtypes, m: int, hidden: int,
              intermediate: int, input_ln: bool) -> str:
    """Which CUDA path a call takes: ROUTE_BF16 or ROUTE_F32 (the kernel
    of x's dtype) inside `ffn_ln_fusible` when the kernel reads the
    vectors' dtypes (K1 in bf16: f32 or bf16; K2 in bf16: bf16; f32: f32),
    else ROUTE_PLAIN, the counted plain version. `vec_dtypes`: the dtypes
    of b1, b2, gamma, beta and, for K1 (`input_ln`), the LN0 vectors."""
    if not ffn_ln_fusible(m, hidden, intermediate, x_dtype):
        return ROUTE_PLAIN
    vec_dtypes = set(vec_dtypes)
    if x_dtype == torch.float32:
        return ROUTE_F32 if vec_dtypes == {torch.float32} else ROUTE_PLAIN
    return (ROUTE_BF16 if input_ln or vec_dtypes == {torch.bfloat16}
            else ROUTE_PLAIN)


def ln_f32(z: torch.Tensor, g: torch.Tensor, o: torch.Tensor,
            eps: float) -> torch.Tensor:
    """Two-pass LayerNorm statistics in f32, as the TPU kernel's."""
    mu = z.mean(dim=-1, keepdim=True)
    var = (z - mu).square().mean(dim=-1, keepdim=True)
    return (z - mu) * torch.rsqrt(var + eps) * g + o


def dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with an f32 result that is not rounded to a's dtype."""
    if a.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.is_cuda:  # cuBLAS: bf16 operands, f32 accumulation and output
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))


def ffn_ln_plain(x2d: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                 w2: torch.Tensor, b2: torch.Tensor, gamma: torch.Tensor,
                 beta: torch.Tensor, eps: float = 1e-12, *,
                 input_ln: bool = True,
                 pre_gamma: Optional[torch.Tensor] = None,
                 pre_beta: Optional[torch.Tensor] = None,
                 slices: int = 1) -> torch.Tensor:
    """The kernel's math in PyTorch. x2d [M, H]; w1 [H, F]; b1 [F];
    w2 [F, H]; b2/gamma/beta [H]. With `input_ln`, x2d is the
    unnormalized residual z and x = LN0(z) with pre_gamma/pre_beta (K1);
    without it x2d is x itself (the TPU's `_ffn_ln_kernel`, K2).

    The dots take x2d's dtype and keep their f32 accumulation (as the
    kernel's, and the TPU kernel's preferred_element_type=f32); GELU
    (exact erf) and both LayerNorms run in f32; the output is in x2d's
    dtype. `slices` > 1 emulates the kernel's split-F path: h @ w2 as
    one f32 partial per slice of F, summed in slice order."""
    dt = x2d.dtype
    f32 = torch.float32
    if input_ln:
        if pre_gamma is None or pre_beta is None:
            raise ValueError("input_ln needs pre_gamma and pre_beta")
        x = ln_f32(x2d.to(f32), pre_gamma.to(f32), pre_beta.to(f32),
                   eps).to(dt)
    else:
        x = x2d
    h = dot_f32(x, w1.to(dt)) + b1.to(f32)
    h = (0.5 * h * (1.0 + torch.erf(h * _SQRT1_2))).to(dt)
    w2 = w2.to(dt)
    n = w2.shape[0] // slices
    acc = dot_f32(h[:, :n], w2[:n]) if slices > 1 else dot_f32(h, w2)
    for s in range(1, slices):
        acc = acc + dot_f32(h[:, s * n:(s + 1) * n], w2[s * n:(s + 1) * n])
    y = acc + b2.to(f32) + x.to(f32)
    return ln_f32(y, gamma.to(f32), beta.to(f32), eps).to(dt)


def fused_ffn_ln(x2d: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                 w2: torch.Tensor, b2: torch.Tensor, gamma: torch.Tensor,
                 beta: torch.Tensor, eps: float = 1e-12,
                 pre_gamma: Optional[torch.Tensor] = None,
                 pre_beta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LN(x + gelu(x @ w1 + b1) @ w2 + b2), x = LN0(x2d) when pre_gamma
    is given (K1), x = x2d otherwise (K2); [M, H] in x2d.dtype. Same
    layouts as the TPU entry point: w1 [H, F], w2 [F, H] (a transposed
    view of an nn.Linear weight costs no copy)."""
    global PLAIN_ON_CUDA
    input_ln = pre_gamma is not None
    args = (x2d, w1, b1, w2, b2, gamma, beta, eps)
    if x2d.device.type == "cpu" or FORCE_PLAIN:
        return ffn_ln_plain(*args, input_ln=input_ln, pre_gamma=pre_gamma,
                            pre_beta=pre_beta)
    if x2d.device.type != "cuda":
        raise RuntimeError(f"fused_ffn_ln: unsupported device {x2d.device}")
    m, hidden = x2d.shape
    vecs = (b1, b2, gamma, beta) + ((pre_gamma, pre_beta) if input_ln
                                    else ())
    route = ffn_route(x2d.dtype, (v.dtype for v in vecs), m, hidden,
                      w1.shape[1], input_ln)
    if route == ROUTE_PLAIN:
        PLAIN_ON_CUDA += 1
        return ffn_ln_plain(*args, input_ln=input_ln, pre_gamma=pre_gamma,
                            pre_beta=pre_beta)
    no_autograd("fused_ffn_ln", *args[:7], pre_gamma, pre_beta)
    launch = _launch_f32 if route == ROUTE_F32 else _launch
    return launch(x2d, w1, b1, w2, b2, gamma, beta, pre_gamma, pre_beta,
                  eps)


def no_autograd(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """The CUDA kernels have no backward: a launch on inputs that
    autograd tracks would return an output cut off from the graph, so it
    raises instead (run the forward under torch.no_grad() or
    torch.inference_mode(), as the model's inference paths do)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, and an input "
            f"requires grad; run it under torch.no_grad()")


def entry(lib, name: str, hidden: int):
    """The C entry `name` of the kernel built for `hidden` (768: `name`;
    any other built width: `name`_h<hidden>); a width the build has no
    kernel for raises before any launch."""
    if hidden not in KERNEL_GROUPS:
        raise ValueError(f"{name}: no kernel is built for hidden width "
                         f"{hidden} (built: {KERNEL_WIDTHS})")
    return getattr(lib, name if hidden == 768 else f"{name}_h{hidden}")


def count_launch(module_globals: dict, counter: str, hidden: int) -> None:
    """Add one to the launch counter of the kernel built for `hidden`
    (`counter` at 768, `counter`_<hidden> otherwise) in `module_globals`."""
    module_globals[counter if hidden == 768 else f"{counter}_{hidden}"] += 1


def _launch(z, w1, b1, w2, b2, gamma, beta, g0, o0, eps):
    input_ln = g0 is not None
    dev = z.device
    m, hidden = z.shape
    f = w1.shape[1]
    if w1.shape != (hidden, f) or w2.shape != (f, hidden):
        raise ValueError(f"fused_ffn_ln: w1 {tuple(w1.shape)} / w2 "
                         f"{tuple(w2.shape)} do not match x [{m}, {hidden}]")
    bf = torch.bfloat16
    z = z.contiguous()
    # the kernel reads nn.Linear's [out, in] layout: W1^T [F, H], W2^T [H, F]
    w1t = w1.to(bf).t().contiguous()
    w2t = w2.to(bf).t().contiguous()
    # K1 reads the vectors as bf16 when all of them are (a model cast to
    # bf16: no cast per call), otherwise as f32; K2 reads bf16 (its gate)
    vecs = (b1, b2, gamma, beta) + ((g0, o0) if input_ln else ())
    vec_dtype = (bf if all(v.dtype == bf for v in vecs) else torch.float32)
    vecs = [v.to(device=dev, dtype=vec_dtype).contiguous() for v in vecs]
    for t in (z, w1t, w2t, *vecs):
        if t.device != dev:
            raise ValueError(f"fused_ffn_ln: tensors on {t.device} and {dev}")
    if w1t.data_ptr() % 16 or w2t.data_ptr() % 16:
        raise ValueError("fused_ffn_ln: weights must be 16-byte aligned "
                         "(TMA tensor maps)")
    if z.data_ptr() % 16:  # the rows are read 16 bytes at a time
        z = z.clone()
    if vecs[0].numel() != f or any(v.numel() != hidden for v in vecs[1:]):
        raise ValueError("fused_ffn_ln: bias/LayerNorm vectors do not match")
    y = torch.empty_like(z)
    lib = build.load_library(dev)
    fn = entry(lib, "mrd_ffn_pre_ln_bf16" if input_ln else "mrd_ffn_ln_bf16",
               hidden)
    plan = ffn_plan(m, f, sm_count(dev), hidden)
    scratch = (torch.empty(plan.scratch, dtype=torch.float32, device=dev)
               if plan.scratch else None)
    ptrs = [t.data_ptr() for t in (z, w1t, vecs[0], w2t, *vecs[1:])]
    tail = (y.data_ptr(), scratch.data_ptr() if scratch is not None
            else None, m, f, plan.slices, float(eps))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if input_ln:
            err = fn(*ptrs, *tail, int(vec_dtype == bf), stream)
        else:
            err = fn(*ptrs, *tail, stream)
    build.check_launch(lib, err, "ffn_pre_ln_bf16" if input_ln
                       else "ffn_ln_bf16")
    count_launch(globals(), "LAUNCHES_K1" if input_ln else "LAUNCHES_K2",
                 hidden)
    return y


def _launch_f32(z, w1, b1, w2, b2, gamma, beta, g0, o0, eps):
    global ROWS_F32_CALLS
    input_ln = g0 is not None
    dev = z.device
    m, hidden = z.shape
    f = w1.shape[1]
    if w1.shape != (hidden, f) or w2.shape != (f, hidden):
        raise ValueError(f"fused_ffn_ln: w1 {tuple(w1.shape)} / w2 "
                         f"{tuple(w2.shape)} do not match x [{m}, {hidden}]")
    f32 = torch.float32
    # f32 as they are: the kernels read nn.Linear's [out, in] layout,
    # W1^T [F, H] and W2^T [H, F] (a transposed view of an nn.Linear
    # weight costs no copy), and split them into TF32 planes themselves
    w1t = w1.to(f32).t().contiguous()
    w2t = w2.to(f32).t().contiguous()
    vecs = [v.contiguous() for v in (b1, b2, gamma, beta)
            + ((g0, o0) if input_ln else ())]  # f32 (the route)
    z = z.contiguous()
    for t in (w1t, w2t, *vecs):
        if t.device != dev:
            raise ValueError(f"fused_ffn_ln: tensors on {t.device} and {dev}")
    if vecs[0].numel() != f or any(v.numel() != hidden for v in vecs[1:]):
        raise ValueError("fused_ffn_ln: bias/LayerNorm vectors do not match")
    # rows, weights and vectors are read 16 bytes at a time
    z, *vecs = [t.clone() if t.data_ptr() % 16 else t for t in (z, *vecs)]
    if w1t.data_ptr() % 16 or w2t.data_ptr() % 16:
        raise ValueError("fused_ffn_ln: weights must be 16-byte aligned")
    y = torch.empty_like(z)
    lib = build.load_library(dev)
    fn = entry(lib, "mrd_ffn_pre_ln_f32" if input_ln else "mrd_ffn_ln_f32",
               hidden)
    plan = ffn_plan_f32(m, f, sm_count(dev), hidden, FORCE_F32_ROWS)
    scratch = torch.empty(plan.scratch, dtype=f32, device=dev)
    ptrs = [t.data_ptr() for t in (z, w1t, vecs[0], w2t, *vecs[1:])]
    # slices 0: the one-pass form
    tail = (y.data_ptr(), scratch.data_ptr(), m, f,
            0 if plan.rows else plan.slices, float(eps))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*ptrs, *tail, stream)
    build.check_launch(lib, err, "ffn_pre_ln_f32" if input_ln
                       else "ffn_ln_f32")
    count_launch(globals(), "LAUNCHES_K1_F32" if input_ln
                 else "LAUNCHES_K2_F32", hidden)
    ROWS_F32_CALLS += plan.rows
    return y


@functools.lru_cache(maxsize=None)
def sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count
