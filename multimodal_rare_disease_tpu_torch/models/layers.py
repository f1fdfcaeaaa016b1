"""Leaf layers and seeded initialization shared by the port's models.

The layers allocate their parameters without initializing them (their
`reset_parameters` does nothing), so building a model never draws from
the global RNG; `init_weights` then fills them from an explicit
`torch.Generator`, or a state dict is loaded on top. Initializers follow
the JAX package's: flax's `lecun_normal` for Dense and Conv kernels,
N(0, 0.02) for the BERT tower (HF's init), zero biases, unit
LayerNorm/BatchNorm scales, BatchNorm statistics 0 / 1.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


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
    """Inference-mode BatchNorm over channel dim 1 (flax's
    `use_running_average=True`), with the flax tree's four leaves:
    weight (scale), bias, running_mean, running_var."""

    def __init__(self, channels: int, eps: float, device):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(channels, device=device))
        self.bias = nn.Parameter(torch.empty(channels, device=device))
        self.register_buffer("running_mean",
                             torch.empty(channels, device=device))
        self.register_buffer("running_var",
                             torch.empty(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, training=False,
                            eps=self.eps)


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
