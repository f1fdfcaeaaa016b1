"""Leaf layers and seeded initialization shared by the port's models.

The layers allocate their parameters without initializing them (their
`reset_parameters` does nothing), so building a model never draws from
the global RNG; `init_weights` then fills them from an explicit
`torch.Generator`, or a state dict is loaded on top. `Dropout` draws its
masks from an explicit generator too (`set_dropout_generator`), and
`BatchNorm` switches to batch statistics in train mode, both as flax's
layers do under `train=True`. Both start in eval mode, so a module built
from them computes the inference path until `.train()` is called on it
(as the trainer and `create_model(trainable=True)` do). Initializers follow
the JAX package's: flax's `lecun_normal` for Dense and Conv kernels,
N(0, 0.02) for the BERT tower (HF's init), zero biases, unit
LayerNorm/BatchNorm scales, BatchNorm statistics 0 / 1.

On a rank mesh (`parallel/tp.py::shard_model`) the batch is split over
the data axis: `BatchNorm` then takes its train statistics over the
global batch (one sum over the data axis of Σx, Σx² and the count), and
`Dropout` draws the global batch's mask and keeps this rank's slice (of
the heads too, where the model axis splits them), so a step on the mesh
draws what the step on one device draws.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_rare_disease_tpu_torch.parallel.collectives import (
    sum_with_grad,
)


class Linear(nn.Linear):
    # init_weights or a loaded state dict fills the parameters
    def reset_parameters(self) -> None:
        pass


class Conv2d(nn.Conv2d):
    def reset_parameters(self) -> None:
        pass


class Embedding(nn.Embedding):
    def reset_parameters(self) -> None:
        pass


class BatchNorm(nn.Module):
    """BatchNorm over channel dim 1 with the flax tree's four leaves:
    weight (scale), bias, running_mean, running_var.

    Eval mode is flax's `use_running_average=True`. Train mode is flax's
    `use_running_average=False, momentum=0.9`, computed as flax computes
    it: the batch mean and the biased variance E[x²] − E[x]² in f32
    (flax's fast variance, clamped at 0; `F.batch_norm` takes a two-pass
    variance, which differs where few values share a channel, and would
    fold the unbiased one into `running_var`), the output
    (x − mean)·rsqrt(var + eps)·weight + bias with gradients through the
    statistics, returned in x's dtype, and the running averages
    0.9·ra + 0.1·batch. They move in train mode whether or not the
    weight and bias are frozen, as in the JAX trainer. The mean and E[x²]
    are Σx/n and Σx²/n; with `data_axis` set (a batch split over a rank
    mesh), those of the global batch: Σx, Σx² and n are summed over the
    axis, and their gradient flows back to every rank."""

    MOMENTUM = 0.9
    data_axis = None

    def __init__(self, channels: int, eps: float, device):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(channels, device=device))
        self.bias = nn.Parameter(torch.empty(channels, device=device))
        self.register_buffer("running_mean",
                             torch.empty(channels, device=device))
        self.register_buffer("running_var",
                             torch.empty(channels, device=device))
        self.train(False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, training=False,
                                eps=self.eps)
        dims = [d for d in range(x.ndim) if d != 1]
        shape = [1, -1] + [1] * (x.ndim - 2)
        xf = x.float()
        c = xf.shape[1]
        n = torch.full((1,), float(xf.numel() // c), device=x.device)
        sums = sum_with_grad(torch.cat(
            [xf.sum(dims), (xf * xf).sum(dims), n]), self.data_axis)
        mean = sums[:c] / sums[-1]
        var = (sums[c:2 * c] / sums[-1] - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            m = self.MOMENTUM
            self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
            self.running_var.mul_(m).add_(var, alpha=1.0 - m)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        y = (xf - mean.view(shape)) * mul.view(shape) \
            + self.bias.float().view(shape)
        return y.to(x.dtype)


class Dropout(nn.Module):
    """flax's `nn.Dropout`: in train mode each element is zeroed with
    probability `rate` and the survivors are scaled by 1/(1 − rate); in
    eval mode it is the identity. The mask is drawn (in f32, so that it
    does not depend on the compute dtype) from `self.generator`, which
    `set_dropout_generator` sets, never from the global RNG: train mode
    with a nonzero rate and no generator raises. `split` holds (dim,
    mesh axis) pairs: x is this rank's slice of a tensor split along
    each dim over the axis, so the mask is drawn whole and sliced."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.generator: Optional[torch.Generator] = None
        self.split: Tuple = ()
        self.train(False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError(
                "Dropout in train mode needs a generator: call "
                "set_dropout_generator(model, torch.Generator(...)) first")
        keep = 1.0 - self.rate
        shape = list(x.shape)
        for dim, axis in self.split:
            shape[dim] *= axis.size
        mask = torch.empty(shape, dtype=torch.float32, device=x.device)
        mask.bernoulli_(keep, generator=self.generator)
        for dim, axis in self.split:
            mask = mask.narrow(dim, axis.rank * x.shape[dim], x.shape[dim])
        return x * (mask / keep).to(x.dtype)


def set_dropout_generator(module: nn.Module,
                          gen: Optional[torch.Generator]) -> None:
    """Give every Dropout under `module` the generator its masks come
    from (a generator on the device the model runs on)."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = gen


def _normal_(t: torch.Tensor, std: float, gen: torch.Generator) -> None:
    with torch.no_grad():
        t.copy_(torch.randn(t.shape, generator=gen, dtype=torch.float32)
                .mul_(std))


def init_weights(module: nn.Module, gen: torch.Generator,
                 std: Optional[float] = None) -> None:
    """Fill every layer under `module` from `gen` (a CPU generator, so a
    seed gives the same weights on every device). `std` set: N(0, std)
    for Linear/Embedding weights (BERT); else lecun_normal."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            _normal_(m.weight, std if (std and isinstance(m, nn.Linear))
                     else 1.0 / math.sqrt(fan_in), gen)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.Embedding):
            _normal_(m.weight, std if std else 1.0, gen)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
        elif isinstance(m, BatchNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
            nn.init.zeros_(m.running_mean)
            nn.init.ones_(m.running_var)
