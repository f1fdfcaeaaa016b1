"""Int8 (W8A8) serving path of the BERT tower: the counterpart of
`multimodal_rare_disease_tpu/models/quant.py`.

Dynamic symmetric quantization of the four big products of each layer
(qkv, the attention output, the FFN's intermediate and output), gated by
`text_encoder.quantized_inference` and never used in train mode:

- weights per output column: scale = max(amax over K, 1e-8) / 127,
  codes = clip(round(w / scale), -127, 127) (round half to even), from
  the f32 master weights;
- activations per row (per token), the same formula over K, at every
  call, in f32;
- int8 x int8 -> int32 through `torch._int_mm`, on the card and on the
  CPU (the JAX package leaves its s8 x s8 -> s32 dot to XLA, so this is
  a library product, not a hand-written kernel), then
  acc * sx * sw + bias in f32 and one cast to the compute dtype.

On CUDA `_int_mm` takes more than 16 rows; fewer (the CLS-only last
layer of one request, a micro-batch of one) are padded with zero rows,
which quantize to zero codes, and sliced off: the same values. Both
scales divide by 127 as a device tensor, because ATen turns a division
of a CUDA tensor by a Python float into a product with its reciprocal,
one ulp off the CPU's true division for some inputs.

`QuantLinear` keeps `Linear`'s parameters (the flax `DenseGeneral` tree
of the JAX `MaybeQuantDenseGeneral`), so checkpoints are the same with
the flag on or off. The JAX layer quantizes its f32 params at every
call. The port's serving models hold bf16 weights, whose rounding would
change the codes, so `prepare_quantized` quantizes each layer once from
the f32 weights, before the model is cast (ROADMAP D24), and keeps the
codes and the f32 scales and biases in non-persistent integer buffers,
which `.to(dtype)` leaves alone. A layer without that cache quantizes
its weights at each call, as the JAX layer does; loading a state dict
clears the cache, and `parallel/tp.py::shard_model` shards it with its
weight.

Over a mesh's model axis a column-parallel layer (qkv, intermediate)
quantizes its own columns: its scales are per column anyway. A
row-parallel one (the attention and FFN outputs, `row_axis` set) holds
a share of K: the activation's per-row amax and the weight's per-column
amax are maxima over the axis, and the int32 partial products are
summed over it as int32 (exact), so the sharded layer computes the
single-device values.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch
from torch import nn

from multimodal_rare_disease_tpu_torch.models.layers import Linear
from multimodal_rare_disease_tpu_torch.parallel.collectives import (
    all_max,
    all_sum,
)

# torch._int_mm on CUDA: the first operand needs more than 16 rows
CUDA_MIN_ROWS = 17
# `int_mm` calls whose rows were padded, and the rows added (observability;
# chip_smoke.py)
PADDED_CALLS = 0
PADDED_ROWS = 0


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """max(amax, 1e-8) / 127 in f32, by true division on every device."""
    return amax.clamp_min(1e-8) / torch.full(
        (), 127.0, dtype=torch.float32, device=amax.device)


def _codes(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.round(x / scale).clamp(-127, 127).to(torch.int8)


def quantize_weight(w: torch.Tensor, axis=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """w [K, N] → (int8 codes [K, N], f32 scale [N]), per column, in f32.
    `axis`: the mesh axis over which K is split (the amax is a max over
    it)."""
    w = w.float()
    scale = _scale(all_max(w.abs().amax(dim=0), axis))
    return _codes(w, scale), scale


def quantize_act(x: torch.Tensor, axis=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [M, K] → (int8 codes [M, K], f32 scale [M, 1]), per row, in f32;
    `axis` as in `quantize_weight`."""
    x = x.float()
    scale = _scale(all_max(x.abs().amax(dim=-1, keepdim=True), axis))
    return _codes(x, scale), scale


def int_mm(xq: torch.Tensor, wq: torch.Tensor,
           min_rows: Optional[int] = None) -> torch.Tensor:
    """int8 [M, K] x int8 [K, N] → int32 [M, N] by `torch._int_mm`. Rows
    are padded with zeros up to `min_rows` (default: CUDA_MIN_ROWS on the
    card, none on the CPU) and sliced off."""
    global PADDED_CALLS, PADDED_ROWS
    if min_rows is None:
        min_rows = CUDA_MIN_ROWS if xq.is_cuda else 0
    m = xq.shape[0]
    if m >= min_rows:
        return torch._int_mm(xq, wq)
    PADDED_CALLS += 1
    PADDED_ROWS += min_rows - m
    padded = xq.new_zeros((min_rows, xq.shape[1]))
    padded[:m] = xq
    return torch._int_mm(padded, wq)[:m]


def int8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [M, K] (any float dtype) x w [K, N] via dynamic W8A8 → f32."""
    xq, sx = quantize_act(x)
    wq, sw = quantize_weight(w)
    return int_mm(xq, wq).float() * sx * sw


def quant_linear(x: torch.Tensor, w_codes: torch.Tensor,
                 w_scale: torch.Tensor, bias: Optional[torch.Tensor],
                 dtype: torch.dtype, axis=None) -> torch.Tensor:
    """x [..., K] through the int8 product with w_codes [K, N] and
    w_scale [N]: (acc * sx * sw + bias) in f32, cast once to `dtype` (the
    JAX `MaybeQuantDenseGeneral` rule). `axis`: the mesh axis over which
    K is split (row-parallel); the int32 partials are summed over it
    before the scales and the bias."""
    lead = x.shape[:-1]
    xq, sx = quantize_act(x.reshape(-1, x.shape[-1]), axis)
    acc = all_sum(int_mm(xq, w_codes), axis)
    y = acc.float() * sx * w_scale
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype).reshape(*lead, y.shape[-1])


class QuantLinear(Linear):
    """`Linear` (weight [out, in]) with the int8 path: `q8(x)` is the
    quantized product; `quantized` says whether the tower runs it.
    `row_axis`: the model axis when this layer is row-parallel
    (parallel/tp.py). The cache, filled by `prepare`: codes [out, in]
    int8, and the f32 scales and bias as int32 bits [2, out]."""

    def __init__(self, in_features: int, out_features: int, device,
                 quantized: bool = False):
        super().__init__(in_features, out_features, device=device)
        self.quantized = quantized
        self.row_axis = None
        self.register_buffer("codes", None, persistent=False)
        self.register_buffer("master_bits", None, persistent=False)

    def prepare(self, weight: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None) -> None:
        """Quantize `weight`/`bias` (default: this layer's own) into the
        cache. Every rank of `row_axis` must call it."""
        weight = self.weight if weight is None else weight
        bias = self.bias if bias is None else bias
        with torch.no_grad():
            codes, scale = quantize_weight(
                weight.detach().to(self.weight.device).t(), self.row_axis)
            self.codes = codes.t().contiguous()
            self.master_bits = torch.stack(
                [scale, bias.detach().to(scale.device).float()]
            ).view(torch.int32)

    def int8_state(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(codes [in, out], f32 scale [out], f32 bias [out]): the cache,
        else this layer's weights quantized now."""
        if self.codes is not None:
            scale, bias = self.master_bits.view(torch.float32)
            return self.codes.t(), scale, bias
        codes, scale = quantize_weight(self.weight.t(), self.row_axis)
        return codes, scale, self.bias.float()

    def q8(self, x: torch.Tensor) -> torch.Tensor:
        return quant_linear(x, *self.int8_state(), dtype=x.dtype,
                            axis=self.row_axis)

    def _load_from_state_dict(self, *args, **kwargs):
        # new weights: the cache no longer holds their codes
        self.codes = self.master_bits = None
        super()._load_from_state_dict(*args, **kwargs)


def quant_layers(model: nn.Module):
    """(name, QuantLinear) of the layers that run quantized: those of a
    BERT tower built with `quantized_inference`."""
    return [(n, m) for n, m in model.named_modules()
            if isinstance(m, QuantLinear) and m.quantized]


def prepare_quantized(model: nn.Module,
                      state: Optional[Mapping[str, torch.Tensor]] = None
                      ) -> int:
    """Fill the int8 cache of every quantized layer of `model`: from
    `state` (a state dict with the f32 master weights, e.g. the Trainer's
    for its bf16 validation copy), else from the layer's own weights,
    where it has no cache yet or they are f32 (a cache made from f32
    masters is kept when the model has been cast since). → the layers
    filled. Call it before casting a model to a lower precision; on a
    mesh, every rank calls it."""
    filled = 0
    for name, m in quant_layers(model):
        if state is not None:
            m.prepare(state[f"{name}.weight"], state[f"{name}.bias"])
        elif m.codes is None or m.weight.dtype == torch.float32:
            m.prepare()
        else:
            continue
        filled += 1
    return filled
