"""JAX parameter trees → the port's state dict.

The port's modules carry the flax tree's names, so each leaf maps by its
path (joined with '.') and a per-layout rule:

- Dense kernel [in, out]                → Linear weight [out, in] (.T)
- DenseGeneral kernel [H, 3, h, d] (qkv), [in, h, d] (features (h, d))
                                        → Linear weight, flattened, .T
- DenseGeneral kernel [h, d, out] (attention `output`, `output_proj`)
                                        → Linear weight, flattened, .T
- Conv kernel HWIO                      → Conv2d weight OIHW
- BatchNorm scale / bias + batch_stats mean / var
                                        → weight / bias / running_mean /
                                          running_var
- LayerNorm scale / bias                → weight / bias
- Embed embedding                       → Embedding weight

The trees are nested dicts of array-likes (numpy or jax arrays); no jax
import is needed. Load the result with `strict=True`, so that a leaf
the rules miss, or a parameter no leaf reaches, fails loudly.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

_MERGED_INPUT_AXES = ("output", "output_proj")  # [h, d, out] kernels


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def _kernel_to_torch(path: Tuple[str, ...], k: np.ndarray) -> np.ndarray:
    parent = path[-2] if len(path) > 1 else ""
    if k.ndim == 2:
        return k.T
    if k.ndim == 4 and parent != "qkv":
        return k.transpose(3, 2, 0, 1)                 # HWIO → OIHW
    if k.ndim == 3 and parent in _MERGED_INPUT_AXES:
        return k.reshape(-1, k.shape[-1]).T            # [h, d, out]
    return k.reshape(k.shape[0], -1).T                 # [in, *features]


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    if np.issubdtype(a.dtype, np.floating) or a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(a))


def state_dict_from_jax(params: Mapping[str, Any],
                        batch_stats: Optional[Mapping[str, Any]] = None
                        ) -> Dict[str, torch.Tensor]:
    """JAX `params` (+ `batch_stats`) → state dict of the port's model
    with the same config, in f32."""
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(params):
        name = path[-1]
        if name == "kernel":
            arr, new = _kernel_to_torch(path, leaf), "weight"
        elif name == "bias":
            arr, new = leaf.reshape(-1), "bias"
        elif name in ("scale", "embedding"):
            arr, new = leaf, "weight"
        else:
            raise KeyError(f"unmapped parameter leaf {'/'.join(path)}")
        out[".".join(path[:-1] + (new,))] = _to_tensor(arr)
    for path, leaf in _flatten(batch_stats or {}):
        new = {"mean": "running_mean", "var": "running_var"}.get(path[-1])
        if new is None:
            raise KeyError(f"unmapped batch_stats leaf {'/'.join(path)}")
        out[".".join(path[:-1] + (new,))] = _to_tensor(leaf)
    return out
