"""Checkpoints of the torch package: a directory with `model.pt` (the
state dict, via torch.save) and `meta.json` with the JAX checkpoint's
meta keys (`config`, `mode`, `vocab`, `class_names`).

Converting a JAX orbax checkpoint needs orbax, which this package does
not import: load it with the JAX package and pass its trees through
`models/convert.py::state_dict_from_jax`.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

MODEL_FILE = "model.pt"
META_FILE = "meta.json"


def save_checkpoint(path: str | Path, state_dict: Mapping[str, torch.Tensor],
                    meta: Optional[Dict[str, Any]] = None) -> Path:
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()},
               path / MODEL_FILE)
    with open(path / META_FILE, "w") as f:
        json.dump(meta or {}, f, indent=2, default=str)
    return path


def load_checkpoint(path: str | Path
                    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """→ (state dict on the CPU, meta)."""
    path = Path(path)
    state = torch.load(path / MODEL_FILE, map_location="cpu",
                       weights_only=True)
    meta: Dict[str, Any] = {}
    if (path / META_FILE).exists():
        with open(path / META_FILE) as f:
            meta = json.load(f)
    return state, meta
