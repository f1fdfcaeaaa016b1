"""Learning-rate schedules, host-computed per step: the torch package's
own copy of `multimodal_rare_disease_tpu/train/schedules.py` (pinned
equal to it by tests/test_torch_host_copies.py).

Covers the reference's scheduler options (`src/train.py:213-231`:
cosine / step / plateau, plus CosineAnnealingWarmRestarts(T_0=10, T_mult=2)
used by the multimodal and small-data trainers). The LR is computed on the
host and set on the optimizer's parameter groups before each step, so
every schedule, including the val-metric-driven plateau reduction (which
no pure function of step can express), drives the same step.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Optional

from multimodal_rare_disease_tpu_torch.config import TrainingConfig


@dataclass
class PlateauState:
    best: float = math.inf
    num_bad: int = 0
    scale: float = 1.0


class Schedule:
    """lr(step) with optional epoch/val hooks (plateau)."""

    def __init__(self, fn: Callable[[int], float], plateau: Optional[dict] = None):
        self._fn = fn
        self._plateau = PlateauState() if plateau is not None else None
        self._plateau_cfg = plateau or {}

    def __call__(self, step: int) -> float:
        lr = self._fn(step)
        if self._plateau is not None:
            lr *= self._plateau.scale
        return float(lr)

    def on_validation(self, val_loss: float) -> None:
        """Plateau hook: reduce LR when val loss stops improving."""
        if self._plateau is None:
            return
        p = self._plateau
        cfg = self._plateau_cfg
        if val_loss < p.best - cfg.get("min_delta", 1e-4):
            p.best = val_loss
            p.num_bad = 0
        else:
            p.num_bad += 1
            if p.num_bad > cfg.get("patience", 5):
                p.scale *= cfg.get("factor", 0.1)
                p.num_bad = 0


def make_schedule(tc: TrainingConfig, steps_per_epoch: int) -> Schedule:
    base = tc.learning_rate
    warmup_steps = tc.warmup_epochs * steps_per_epoch
    total_steps = max(1, tc.num_epochs * steps_per_epoch)

    def warmup(step: int) -> float:
        if warmup_steps > 0 and step < warmup_steps:
            return (step + 1) / warmup_steps
        return 1.0

    name = tc.scheduler
    if name == "constant":
        fn = lambda s: base * warmup(s)  # noqa: E731
    elif name == "cosine":
        def fn(s: int) -> float:
            w = warmup(s)
            if warmup_steps > 0 and s < warmup_steps:
                return base * w
            frac = (s - warmup_steps) / max(1, total_steps - warmup_steps)
            frac = min(1.0, frac)
            return base * 0.5 * (1 + math.cos(math.pi * frac))
    elif name == "warm_restarts":
        t0 = max(1, tc.restart_period_epochs * steps_per_epoch)
        mult = max(1, tc.restart_mult)

        def fn(s: int) -> float:
            # position within the current restart cycle
            t_cur, t_i = s, t0
            while t_cur >= t_i:
                t_cur -= t_i
                t_i *= mult
            return base * 0.5 * (1 + math.cos(math.pi * t_cur / t_i))
    elif name == "step":
        milestones = sorted(m * steps_per_epoch for m in tc.lr_decay_epochs)

        def fn(s: int) -> float:
            k = sum(1 for m in milestones if s >= m)
            return base * (tc.lr_decay_factor ** k) * warmup(s)
    elif name == "plateau":
        return Schedule(lambda s: base,
                        plateau={"patience": tc.plateau_patience,
                                 "factor": tc.lr_decay_factor,
                                 "min_delta": tc.min_delta})
    else:
        raise ValueError(f"Unknown scheduler: {name!r}")
    return Schedule(fn)


class EarlyStopping:
    """min/max-mode early stopping (ref `src/train.py:54-100`)."""

    def __init__(self, patience: int = 15, min_delta: float = 1e-3,
                 mode: str = "min"):
        self.patience = patience
        self.min_delta = min_delta
        self.mode = mode
        self.best: Optional[float] = None
        self.counter = 0
        self.should_stop = False

    def update(self, value: float) -> bool:
        improved = (
            self.best is None
            or (self.mode == "min" and value < self.best - self.min_delta)
            or (self.mode == "max" and value > self.best + self.min_delta)
        )
        if improved:
            self.best = value
            self.counter = 0
        else:
            self.counter += 1
            if self.counter >= self.patience:
                self.should_stop = True
        return improved
