"""The numerics of the f32 kernels' 3xTF32 GEMM (csrc/gemm_tf32x3.cuh, in
the f32 FFN kernels of csrc/ffn_ln_f32.cu and the f32 attention-output
kernel of csrc/attn_out_ln_f32.cu), emulated on the CPU: each f32
operand a is split into TF32 planes, a_hi = tf32(a) (round to nearest,
ties away from zero, as cvt.rna.tf32.f32) and a_lo = a - a_hi, and a
product is taken on the tensor cores as
a_hi . b_hi + (a_hi . b_lo + a_lo . b_hi), the last two summed in an
accumulator of their own. The emulation sums in f32 on the CPU; it does
not model the tensor cores' own rounding of their sums, which the kernels
bound by moving them into a register total every 256 of k. It holds the
kernels' 3xTF32 split to the f32 limits that tests/test_torch_gpu.py and
chip_smoke.py hold the kernels to against `ffn_ln_plain` and
`attn_out_ln_plain` (TF32 off), and shows that the limits refuse one
TF32 pass and a split that drops a cross term. The kernels themselves
are checked on the card."""

import numpy as np
import pytest
import torch

from multimodal_rare_disease_tpu_torch.kernels import attn_out as k3
from multimodal_rare_disease_tpu_torch.kernels import ffn as k1

# chip_smoke.py's ROW_F32_ATOL / ROW_F32_MEAN_ATOL, tests/test_torch_gpu.py's
# _F32_MAX_ATOL / _F32_MEAN_ATOL
_F32_MAX_ATOL, _F32_MEAN_ATOL = 1e-4, 1e-5
_SQRT1_2 = 0.7071067811865476
_LOW13 = 0x1FFF


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10-bit mantissa) by int32 bit operations:
    add half of the dropped 13 bits to the magnitude, then clear them
    (round to nearest, ties away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~_LOW13).view(torch.float32)


def tf32_read(x: torch.Tensor) -> torch.Tensor:
    """What the tensor core takes of an f32 operand: its sign, exponent
    and top 10 mantissa bits (the low 13 bits cleared). Exact on a hi
    plane; on a lo plane it drops that plane's own low bits."""
    return (x.contiguous().view(torch.int32) & ~_LOW13).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, x - hi


def dot(a: torch.Tensor, b: torch.Tensor, terms) -> torch.Tensor:
    """a @ b from TF32 operands: `terms` of ("hh", "hl", "lh"), "hh" in
    one f32 accumulator and the cross terms in another, added at the
    end; ("1",) is a single TF32 pass."""
    if terms == ("1",):
        return tf32_read(a) @ tf32_read(b)
    (ah, al), (bh, bl) = split(a), split(b)
    big = tf32_read(ah) @ tf32_read(bh)
    small = torch.zeros_like(big)
    if "hl" in terms:
        small = small + tf32_read(ah) @ tf32_read(bl)
    if "lh" in terms:
        small = small + tf32_read(al) @ tf32_read(bh)
    return big + small


def ffn_ln_tf32(z, w1, b1, w2, b2, gamma, beta, eps=1e-12, *, input_ln,
                pre_gamma=None, pre_beta=None, terms=("hh", "hl", "lh")):
    """`ffn_ln_plain` in f32 with both products taken as `dot`."""
    x = k1.ln_f32(z, pre_gamma, pre_beta, eps) if input_ln else z
    h = dot(x, w1, terms) + b1
    h = 0.5 * h * (1.0 + torch.erf(h * _SQRT1_2))
    return k1.ln_f32(dot(h, w2, terms) + b2 + x, gamma, beta, eps)


def attn_out_ln_tf32(ctx, x, wo, bo, gamma, beta, eps=1e-12, *,
                     terms=("hh", "hl", "lh")):
    """`attn_out_ln_plain` in f32 with the product taken as `dot`."""
    return k1.ln_f32(dot(ctx, wo, terms) + bo + x, gamma, beta, eps)


def _inputs(m=64, h=768, f=512, seed=13):
    # the scales of the card's checks (tests/test_torch_gpu.py): rows at
    # 1.0, weights at 0.05, biases and shifts at 0.5, scales at 1 +- 0.25
    rng = np.random.default_rng(seed)

    def t(shape, scale, offset=0.0):
        return torch.from_numpy(
            (offset + rng.normal(size=shape) * scale).astype(np.float32))

    z = t((m, h), 1.0)
    args = (t((h, f), 0.05), t((f,), 0.5), t((f, h), 0.05), t((h,), 0.5),
            t((h,), 0.25, 1.0), t((h,), 0.5))
    ln0 = dict(pre_gamma=t((h,), 0.25, 1.0), pre_beta=t((h,), 0.5))
    return z, args, ln0


def _attn_inputs(m=64, h=768, seed=14):
    # the scales of the card's f32 K3 checks: ctx and x at 1.0, Wo at
    # 0.05, bo and beta at 0.5, gamma at 1 +- 0.25
    rng = np.random.default_rng(seed)

    def t(shape, scale, offset=0.0):
        return torch.from_numpy(
            (offset + rng.normal(size=shape) * scale).astype(np.float32))

    return (t((m, h), 1.0), t((m, h), 1.0), t((h, h), 0.05), t((h,), 0.5),
            t((h,), 0.25, 1.0), t((h,), 0.5))


def _err(kernel, terms):
    if kernel == "k3":
        args = _attn_inputs()
        want = k3.attn_out_ln_plain(*args)
        got = attn_out_ln_tf32(*args, terms=terms)
    else:
        input_ln = kernel == "k1"
        z, args, ln0 = _inputs()
        ln0 = ln0 if input_ln else {}
        want = k1.ffn_ln_plain(z, *args, input_ln=input_ln, **ln0)
        got = ffn_ln_tf32(z, *args, input_ln=input_ln, terms=terms, **ln0)
    d = (got - want).abs()
    return d.max().item(), d.mean().item()


def test_tf32_split_is_exact_and_rounds_to_nearest():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(np.concatenate([
        rng.normal(size=4096) * 10.0 ** rng.integers(-6, 6, size=4096),
        [0.0, -0.0, 1.0, -1.0]]).astype(np.float32))
    hi, lo = split(x)
    assert torch.equal(hi + lo, x)  # the two planes hold a exactly
    assert not (hi.view(torch.int32) & _LOW13).any()  # hi is exact TF32
    # the nearest TF32 value: |lo| at most half a TF32 ulp of |x| (normal
    # numbers: 2^-10 of the binade's lower end)
    ulp = torch.ldexp(torch.ones_like(x), torch.frexp(x)[1] - 11)
    assert (lo.abs() <= ulp / 2).all()
    # ties go away from zero: 1 + 2^-11 lies halfway between TF32 1 and
    # 1 + 2^-10
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])
    assert torch.equal(tf32_rna(tie),
                       torch.tensor([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]))


# K1 and K2 (the FFN), K3 (the attention output)
_KERNELS = ["k1", "k2", "k3"]


@pytest.mark.parametrize("kernel", _KERNELS)
def test_three_tf32_passes_meet_the_f32_limits(kernel):
    worst, mean = _err(kernel, ("hh", "hl", "lh"))
    assert worst <= _F32_MAX_ATOL and mean <= _F32_MEAN_ATOL, (worst, mean)


@pytest.mark.parametrize("kernel", _KERNELS)
def test_one_tf32_pass_fails_the_f32_limits(kernel):
    worst, mean = _err(kernel, ("1",))
    assert worst > _F32_MAX_ATOL and mean > _F32_MEAN_ATOL, (worst, mean)


@pytest.mark.parametrize("terms", [("hh", "lh"), ("hh", "hl")],
                         ids=["no_hi_lo", "no_lo_hi"])
@pytest.mark.parametrize("kernel", _KERNELS)
def test_dropping_a_cross_term_fails_the_f32_limits(kernel, terms):
    worst, mean = _err(kernel, terms)
    assert worst > _F32_MAX_ATOL or mean > _F32_MEAN_ATOL, (worst, mean)
