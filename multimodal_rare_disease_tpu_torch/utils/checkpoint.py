"""Checkpoints of the torch package: a directory with `model.pt` (the
state dict, via torch.save) and `meta.json` with the JAX checkpoint's
meta keys (`config`, `mode`, `vocab`, `class_names`; the trainer adds
`step`, `epoch`, `best_metric`, `best_metric_name` and `history`). A
resumable train checkpoint (the trainer's `last` role) also holds
`train_state.pt`: the optimizer's state dict, the step and the skip
counter. The trainer's roles are `{mode}_best` and `{mode}_last`, as in
the JAX package.

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
TRAIN_STATE_FILE = "train_state.pt"


def save_checkpoint(path: str | Path, state_dict: Mapping[str, torch.Tensor],
                    meta: Optional[Dict[str, Any]] = None,
                    train_state: Optional[Dict[str, Any]] = None) -> Path:
    """Write the model's state dict and `meta`; with `train_state`
    (optimizer state dict, step, skip counter) also the resumable part.
    A checkpoint rewritten without it loses an older one."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()},
               path / MODEL_FILE)
    with open(path / META_FILE, "w") as f:
        json.dump(meta or {}, f, indent=2, default=str)
    if train_state is not None:
        torch.save(train_state, path / TRAIN_STATE_FILE)
    else:
        (path / TRAIN_STATE_FILE).unlink(missing_ok=True)
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


def load_train_state(path: str | Path) -> Optional[Dict[str, Any]]:
    """The resumable train state of a checkpoint (on the CPU), or None."""
    f = Path(path) / TRAIN_STATE_FILE
    if not f.exists():
        return None
    return torch.load(f, map_location="cpu", weights_only=True)


def checkpoint_exists(path: str | Path) -> bool:
    return (Path(path) / MODEL_FILE).exists()


def role_path(checkpoint_dir: str | Path, mode: str, role: str) -> Path:
    """The trainer's best/last role path for a mode."""
    return Path(checkpoint_dir) / f"{mode}_{role}"
