"""Weights from elsewhere → the port's state dict: JAX parameter trees
(`state_dict_from_jax`), and user-supplied torchvision ResNet-50,
torchvision EfficientNet-B0 and Hugging Face BERT state dicts
(`convert_torchvision_resnet50`, `convert_torchvision_efficientnet_b0`,
`convert_hf_bert`; no JAX in between), merged into a model's state dict
by `merge_converted`.

JAX trees:

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
- PReLU alpha (MTCNN)                   → alpha

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
        elif name == "alpha":                          # MTCNN's PReLU
            arr, new = leaf, "alpha"
        else:
            raise KeyError(f"unmapped parameter leaf {'/'.join(path)}")
        out[".".join(path[:-1] + (new,))] = _to_tensor(arr)
    for path, leaf in _flatten(batch_stats or {}):
        new = {"mean": "running_mean", "var": "running_var"}.get(path[-1])
        if new is None:
            raise KeyError(f"unmapped batch_stats leaf {'/'.join(path)}")
        out[".".join(path[:-1] + (new,))] = _to_tensor(leaf)
    return out


# ---------------------------------------------------------------------------
# torchvision and Hugging Face state dicts → the port's names
#
# The port's modules carry the flax names, which the JAX package's
# converters (`multimodal_rare_disease_tpu/models/convert.py`) target, and
# torch layouts, which these files already have: convolutions stay OIHW,
# Linear weights [out, in]; BatchNorm's weight / bias / running_mean /
# running_var keep their names (torchvision's num_batches_tracked has no
# counterpart); HF's query / key / value Linears stack into the fused
# `qkv` Linear. The results are f32 and keyed relative to the backbone
# (`cnn_encoder.backbone.`) or the BERT tower (`text_encoder.bert.`).
# ---------------------------------------------------------------------------

_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def _f32(w) -> torch.Tensor:
    t = w.detach() if isinstance(w, torch.Tensor) else torch.from_numpy(
        np.asarray(w))
    return t.to(device="cpu", dtype=torch.float32).contiguous()


def _copy(out: Dict[str, torch.Tensor], sd: Mapping[str, Any], dst: str,
          src: str, leaves=("weight",)) -> None:
    for leaf in leaves:
        out[f"{dst}.{leaf}"] = _f32(sd[f"{src}.{leaf}"])


_BLOCKS_PER_STAGE = (3, 4, 6, 3)


def convert_torchvision_resnet50(sd: Mapping[str, Any]
                                 ) -> Dict[str, torch.Tensor]:
    """torchvision resnet50 state dict → the ResNet-50 backbone's (its
    `fc` ignored: the reference replaces it with Identity)."""
    out: Dict[str, torch.Tensor] = {}
    _copy(out, sd, "stem_conv", "conv1")
    _copy(out, sd, "stem_bn", "bn1", _BN_LEAVES)
    for stage, nblocks in enumerate(_BLOCKS_PER_STAGE, start=1):
        for b in range(nblocks):
            src, dst = f"layer{stage}.{b}", f"stage{stage}_block{b}"
            for i in (1, 2, 3):
                _copy(out, sd, f"{dst}.conv{i}", f"{src}.conv{i}")
                _copy(out, sd, f"{dst}.bn{i}", f"{src}.bn{i}", _BN_LEAVES)
            if f"{src}.downsample.0.weight" in sd:
                _copy(out, sd, f"{dst}.downsample_conv",
                      f"{src}.downsample.0")
                _copy(out, sd, f"{dst}.downsample_bn",
                      f"{src}.downsample.1", _BN_LEAVES)
    return out


# (expand_ratio, num_repeats) per features.1..7 of torchvision's
# efficientnet_b0
_B0_STAGES = ((1, 1), (6, 2), (6, 2), (6, 3), (6, 3), (6, 4), (6, 1))


def convert_torchvision_efficientnet_b0(sd: Mapping[str, Any]
                                        ) -> Dict[str, torch.Tensor]:
    """torchvision efficientnet_b0 state dict → the EfficientNet-B0
    backbone's (its classifier ignored). torchvision: features.0 is the
    stem, features.s.b.block.i the MBConv stages (expand, depthwise, SE
    fc1 / fc2, project; no expand stage at ratio 1), features.8 the
    1280-wide head; its StochasticDepth has no parameters."""
    out: Dict[str, torch.Tensor] = {}
    _copy(out, sd, "stem_conv", "features.0.0")
    _copy(out, sd, "stem_bn", "features.0.1", _BN_LEAVES)
    for s, (expand, repeats) in enumerate(_B0_STAGES, start=1):
        for b in range(repeats):
            src, dst = f"features.{s}.{b}.block", f"stage{s}_block{b}"
            convs = (("expand",) if expand != 1 else ()) + ("dw", "se",
                                                            "project")
            for i, part in enumerate(convs):
                if part == "se":
                    for fc, name in (("fc1", "reduce"), ("fc2", "expand")):
                        _copy(out, sd, f"{dst}.se.{name}", f"{src}.{i}.{fc}",
                              ("weight", "bias"))
                    continue
                _copy(out, sd, f"{dst}.{part}_conv", f"{src}.{i}.0")
                _copy(out, sd, f"{dst}.{part}_bn", f"{src}.{i}.1",
                      _BN_LEAVES)
    _copy(out, sd, "head_conv", "features.8.0")
    _copy(out, sd, "head_bn", "features.8.1", _BN_LEAVES)
    return out


def convert_hf_bert(sd: Mapping[str, Any], num_layers: int = 12,
                    num_heads: int = 12) -> Dict[str, torch.Tensor]:
    """HF BertModel state dict (keys with or without `bert.`) → the BERT
    tower's, with the fused qkv Linear: [q; k; v] stacked on the output
    axis (each head's d columns together, as in HF's Linears)."""
    def g(key: str) -> torch.Tensor:
        for prefix in ("", "bert."):
            if prefix + key in sd:
                return _f32(sd[prefix + key])
        raise KeyError(key)

    out = {
        "word_embeddings.weight": g("embeddings.word_embeddings.weight"),
        "position_embeddings.weight":
            g("embeddings.position_embeddings.weight"),
        "token_type_embeddings.weight":
            g("embeddings.token_type_embeddings.weight"),
        "embeddings_ln.weight": g("embeddings.LayerNorm.weight"),
        "embeddings_ln.bias": g("embeddings.LayerNorm.bias"),
        "pooler.weight": g("pooler.dense.weight"),
        "pooler.bias": g("pooler.dense.bias"),
    }
    hidden = out["word_embeddings.weight"].shape[1]
    if hidden % num_heads:
        raise ValueError(f"hidden size {hidden} does not split into "
                         f"{num_heads} heads")
    for i in range(num_layers):
        src, dst = f"encoder.layer.{i}", f"layer{i}"
        for leaf in ("weight", "bias"):
            out[f"{dst}.attention.qkv.{leaf}"] = torch.cat(
                [g(f"{src}.attention.self.{n}.{leaf}")
                 for n in ("query", "key", "value")])
            for name, hf in (("attention.output", "attention.output.dense"),
                             ("attention_ln", "attention.output.LayerNorm"),
                             ("intermediate", "intermediate.dense"),
                             ("output", "output.dense"),
                             ("output_ln", "output.LayerNorm")):
                out[f"{dst}.{name}.{leaf}"] = g(f"{src}.{hf}.{leaf}")
    return out


def load_torch_state_dict(path: str) -> Dict[str, Any]:
    """A state dict saved with torch.save (also inside a
    {'state_dict': ...} or {'model_state_dict': ...} wrapper), on the
    CPU."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if isinstance(obj, dict) and "model_state_dict" in obj:
        obj = obj["model_state_dict"]
    return obj


def merge_converted(state_dict: Mapping[str, torch.Tensor],
                    converted: Mapping[str, torch.Tensor],
                    prefix: str) -> Dict[str, torch.Tensor]:
    """A copy of a model's `state_dict` with `converted` (keys relative to
    `prefix`, e.g. "cnn_encoder.backbone." or "text_encoder.bert.")
    written over it. Fails when a converted key has no parameter of the
    same shape to land on, so a converter and a model that disagree
    cannot load silently."""
    out = dict(state_dict)
    bad = [f"{prefix}{k} {tuple(v.shape)}" for k, v in converted.items()
           if prefix + k not in out
           or tuple(out[prefix + k].shape) != tuple(v.shape)]
    if bad:
        raise KeyError(f"{len(bad)} converted weights do not land in the "
                       f"model: {bad[:5]}")
    for k, v in converted.items():
        out[prefix + k] = v.to(out[prefix + k].dtype)
    return out
