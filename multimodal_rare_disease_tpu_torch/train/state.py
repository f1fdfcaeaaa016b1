"""Train state and optimizer: the counterpart of
`multimodal_rare_disease_tpu/train/state.py`.

One `TrainState` holds the model's optimizer (`torch.optim` Adam, AdamW
or SGD with momentum 0.9, one parameter group per component LR
multiplier of `train/freeze.py`), the step and the skip counter of the
non-finite guard. `apply_gradients` equals the JAX `apply_gradients`:

1. frozen parameters (`requires_grad=False`) carry no gradient and are
   not in the optimizer, so they count in no norm and never move; a
   trainable parameter the loss does not reach steps on a zero gradient,
   as the JAX step does (its weight decay still acts);
2. the gradients are clipped by their global norm with torch's
   `clip_coef = max / (norm + 1e-6)`, clamped at 1;
3. the optimizer steps: adam and sgd add the coupled decay wd·p to the
   clipped gradient (torch's `weight_decay`), adamw decays decoupled by
   lr·multiplier·wd; Adam's eps sits outside the square root.

A step whose loss, or (with `nan_guard`) whose gradient norm, is not
finite changes nothing (no parameter, no optimizer moment, no BatchNorm
running statistic) and counts one in `skipped_steps`. The BatchNorm
running statistics move during the forward, before the loss is known, so
`save_batch_stats` copies them before each forward and a skipped step
copies them back. Deciding costs one host read of a flag per step.

On a rank mesh (`set_mesh`) the gradients arrive summed over the data
axis (the trainer sums them). The global norm then adds the squares of
the parameters split over the model axis (`parallel/tp.py`) across that
axis and counts the replicated ones once, and the verdict on a non-finite
step is one sum over every rank of the mesh, so that no rank steps alone.
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn

from multimodal_rare_disease_tpu_torch.config import Config
from multimodal_rare_disease_tpu_torch.models.layers import BatchNorm
from multimodal_rare_disease_tpu_torch.parallel.collectives import all_sum
from multimodal_rare_disease_tpu_torch.train.freeze import lr_multiplier

_ADAM_BETAS = (0.9, 0.999)
_ADAM_EPS = 1e-8
_SGD_MOMENTUM = 0.9


def param_groups(cfg: Config, model: nn.Module) -> List[Dict]:
    """The trainable parameters, one group per LR multiplier, in the
    model's order; each group carries its `lr_mult`."""
    groups: Dict[float, Dict] = {}
    for name, p in model.named_parameters():
        if p.requires_grad:
            mult = lr_multiplier(cfg, name)
            groups.setdefault(mult, {"params": [], "lr_mult": mult})
            groups[mult]["params"].append(p)
    return list(groups.values())


def create_optimizer(cfg: Config, model: nn.Module
                     ) -> torch.optim.Optimizer:
    t = cfg.training
    groups = param_groups(cfg, model)
    lr, wd = t.learning_rate, t.weight_decay
    if t.optimizer == "adam":
        return torch.optim.Adam(groups, lr=lr, betas=_ADAM_BETAS,
                                eps=_ADAM_EPS, weight_decay=wd)
    if t.optimizer == "adamw":
        return torch.optim.AdamW(groups, lr=lr, betas=_ADAM_BETAS,
                                 eps=_ADAM_EPS, weight_decay=wd)
    if t.optimizer == "sgd":
        return torch.optim.SGD(groups, lr=lr, momentum=_SGD_MOMENTUM,
                               weight_decay=wd)
    raise ValueError(f"Unknown optimizer: {t.optimizer!r}")


class TrainState:
    """The optimizer, the step and the skip counter of `model`, whose
    `requires_grad` flags (the freeze rules) are already set."""

    def __init__(self, cfg: Config, model: nn.Module):
        self.optimizer = create_optimizer(cfg, model)
        self.params = [p for g in self.optimizer.param_groups
                       for p in g["params"]]
        self.step = 0
        self.skipped_steps = 0
        self.gradient_clip_val = float(cfg.training.gradient_clip_val or 0.0)
        self.nan_guard = bool(cfg.training.nan_guard)
        self._stats = [b for m in model.modules() if isinstance(m, BatchNorm)
                       for b in (m.running_mean, m.running_var)]
        self._saved = [torch.empty_like(b) for b in self._stats]
        self._sharded: List[bool] = [False] * len(self.params)
        self._model_axis = self._world_axis = None

    def set_mesh(self, mesh, sharded) -> None:
        """Norm and verdict over `mesh`; `sharded`: the parameters that
        hold a share over its model axis."""
        ids = {id(p) for p in sharded}
        self._sharded = [id(p) in ids for p in self.params]
        self._model_axis = mesh.axis("model")
        self._world_axis = mesh.axis("world")

    def _global_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        norms = torch._foreach_norm(grads)
        if self._model_axis is None or self._model_axis.size == 1:
            return torch.linalg.vector_norm(torch.stack(norms))
        sq = torch.stack(norms).square()
        split = torch.tensor(self._sharded, device=sq.device)
        shared = all_sum(sq[split].sum(), self._model_axis)
        return torch.sqrt(shared + sq[~split].sum())

    def save_batch_stats(self) -> None:
        """Copy the BatchNorm running statistics aside (before a train
        forward), for a skipped step to restore."""
        if self._stats:
            torch._foreach_copy_(self._saved, self._stats)

    def apply_gradients(self, loss: torch.Tensor, lr: float) -> bool:
        """One optimizer step at learning rate `lr` on the gradients that
        `loss.backward()` left; True when it was applied, False when the
        guard skipped it. Clears the gradients either way."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        total = self._global_norm(grads)
        finite = torch.isfinite(loss.detach())
        if self.nan_guard:
            finite = finite & torch.isfinite(total)
        if self._world_axis is not None and self._world_axis.size > 1:
            bad = all_sum((~finite).float(), self._world_axis)
            finite = bad == 0
        if self.gradient_clip_val > 0:
            coef = (self.gradient_clip_val / (total + 1e-6)).clamp(max=1.0)
            torch._foreach_mul_(grads, coef)
        applied = bool(finite)  # the one host read of the step
        if applied:
            for g in self.optimizer.param_groups:
                g["lr"] = lr * g["lr_mult"]
            self.optimizer.step()
        else:
            if self._stats:
                torch._foreach_copy_(self._stats, self._saved)
            self.skipped_steps += 1
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1
        return applied
