"""Parameter freezing and per-component learning-rate multipliers: the
rules of `multimodal_rare_disease_tpu/train/freeze.py` over the port's
parameter names (the flax paths joined with '.', e.g.
`cnn_encoder.backbone.stage1_block0.conv1.weight`).

The reference freezes modules by setting `requires_grad=False`
(`src/cnn_encoder.py:102-166`, `src/text_encoder.py:69-93`) and builds
per-component optimizer param groups with LR multipliers
(`src/train_multimodal.py:422-454`: CNN 0.1×, text 0.5×, fusion/head 1.0×).
Here the JAX package's trainable mask becomes `requires_grad`
(`apply_freeze`) and its multiplier tree becomes one optimizer parameter
group per multiplier (`train/state.py`). A frozen BatchNorm still updates
its running statistics in train mode, as in the JAX trainer.
"""

from __future__ import annotations

import re
from typing import Tuple

from torch import nn

from multimodal_rare_disease_tpu_torch.config import Config

_STAGE_RE = re.compile(r"stage(\d+)")
_LAYER_RE = re.compile(r"layer(\d+)$")
_EMBED_NAMES = (
    "word_embeddings", "position_embeddings", "token_type_embeddings",
    "embeddings_ln",
)


def _is_frozen(names: Tuple[str, ...], cfg: Config) -> bool:
    if "cnn_encoder" in names and "backbone" in names:
        if cfg.cnn_encoder.freeze_backbone:
            return True
        n = cfg.cnn_encoder.freeze_stages
        if n > 0:
            if "stem_conv" in names or "stem_bn" in names:
                return True
            for part in names:
                m = _STAGE_RE.match(part)
                if m and int(m.group(1)) <= n:
                    return True
    if "text_encoder" in names:
        if cfg.text_encoder.freeze_embeddings and any(
                e in names for e in _EMBED_NAMES):
            return True
        n = cfg.text_encoder.freeze_layers
        if n > 0:
            for part in names:
                m = _LAYER_RE.match(part)
                if m and int(m.group(1)) < n:
                    return True
    return False


def _component(names: Tuple[str, ...]) -> str:
    for comp in ("cnn_encoder", "text_encoder", "fusion", "head"):
        if comp in names:
            return comp
    return "other"


def is_trainable(cfg: Config, name: str) -> bool:
    """False where the parameter `name` is frozen."""
    return not _is_frozen(tuple(name.split(".")), cfg)


def lr_multiplier(cfg: Config, name: str) -> float:
    """The component LR multiplier of the parameter `name`."""
    t = cfg.training
    return {
        "cnn_encoder": t.lr_mult_cnn,
        "text_encoder": t.lr_mult_text,
        "fusion": t.lr_mult_fusion,
        "head": t.lr_mult_classifier,
        "other": 1.0,
    }[_component(tuple(name.split(".")))]


def apply_freeze(cfg: Config, model: nn.Module) -> None:
    """Set each parameter's `requires_grad` by the freeze rules."""
    for name, p in model.named_parameters():
        p.requires_grad_(is_trainable(cfg, name))


def count_params(model: nn.Module) -> Tuple[int, int]:
    """(total, trainable) parameter counts."""
    total = trainable = 0
    for p in model.parameters():
        total += p.numel()
        trainable += p.numel() if p.requires_grad else 0
    return total, trainable
