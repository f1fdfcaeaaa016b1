"""Tensor parallelism (Megatron) over the mesh's model axis: the
counterpart of `multimodal_rare_disease_tpu/parallel/tp.py`.

The BERT tower's attention heads and FFN inner dimension are split over
the model axis while the residual stream stays replicated. The JAX
package states this as shardings of its parameter tree and lets XLA
insert the two sums per layer; here each rank keeps only its shards
(`shard_model`) and the layers call the sums themselves
(`models/bert.py`). The rules, on the port's parameter names and torch's
(out, in) layout, are the JAX `tp_spec`'s six:

  layer*.attention.qkv.weight   [3H, H]  rows, by heads within each of q, k, v
  layer*.attention.qkv.bias     [3H]     the same
  layer*.attention.output.weight[H, H]   columns (the heads' inputs)
  layer*.intermediate.weight    [F, H]   rows (F)
  layer*.intermediate.bias      [F]      F
  layer*.output.weight          [H, F]   columns (F)

The attention leaves split when the head count divides by the axis, the
FFN ones when F does; anything else (embeddings, LayerNorms, pooler, the
CNN, fusion, head, BatchNorm statistics) is replicated. The optimizer's
moments follow their parameters, so its update stays local.

`shard_model` also gives every Dropout and BatchNorm its place on the
data axis (models/layers.py), the row-parallel projections their
`row_axis`, and cuts an int8 cache made before it (models/quant.py) as
it cuts the weights. Checkpoints hold whole tensors:
`gather_state_dict` / `gather_optimizer_state` join the shards and
`shard_state_dict` / `shard_optimizer_state` cut a whole checkpoint for
any mesh.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from multimodal_rare_disease_tpu_torch.parallel.collectives import (
    gather_stack,
)
from multimodal_rare_disease_tpu_torch.parallel.mesh import Axis, Mesh


class TPSplit(NamedTuple):
    """A leaf's split over the model axis: along torch dim `dim`, which
    holds `blocks` equal blocks (3 for qkv: q, k, v), each cut into one
    contiguous share per rank."""
    dim: int
    blocks: int


def tp_spec(name: str, shape: Sequence[int], model_size: int,
            num_heads: int) -> Optional[TPSplit]:
    """The split of one parameter (or of a moment of it), by its name's
    tail and its whole shape; None: replicated. `num_heads`: the BERT
    tower's head count."""
    t = tuple(name.split("."))
    nd = len(shape)
    heads_div = num_heads % model_size == 0
    if t[-3:] == ("attention", "qkv", "weight") and nd == 2 and heads_div:
        return TPSplit(0, 3)
    if t[-3:] == ("attention", "qkv", "bias") and nd == 1 and heads_div:
        return TPSplit(0, 3)
    if t[-3:] == ("attention", "output", "weight") and nd == 2 \
            and heads_div:
        return TPSplit(1, 1)
    if t[-2:] == ("intermediate", "weight") and nd == 2 \
            and shape[0] % model_size == 0:
        return TPSplit(0, 1)
    if t[-2:] == ("intermediate", "bias") and nd == 1 \
            and shape[0] % model_size == 0:
        return TPSplit(0, 1)
    # the FFN's output projection: layer*.output.weight [H, F] (the tail
    # alone would also match attention.output, caught above)
    if len(t) >= 3 and t[-2:] == ("output", "weight") \
            and t[-3].startswith("layer") and nd == 2 \
            and shape[1] % model_size == 0:
        return TPSplit(1, 1)
    return None


def shard_tensor(full: torch.Tensor, spec: TPSplit, rank: int,
                 size: int) -> torch.Tensor:
    """Rank `rank`'s share of a whole tensor."""
    d = spec.dim
    x = full.unflatten(d, (spec.blocks, size, -1)).select(d + 1, rank)
    return x.flatten(d, d + 1).contiguous()


def unshard(stacked: torch.Tensor, spec: TPSplit) -> torch.Tensor:
    """The whole tensor from every rank's share, stacked [size, ...]."""
    d = spec.dim
    x = stacked.unflatten(d + 1, (spec.blocks, -1)).movedim(0, d + 1)
    return x.flatten(d, d + 2)


def gather_tensor(local: torch.Tensor, spec: TPSplit, axis: Axis
                  ) -> torch.Tensor:
    return unshard(gather_stack(local, axis), spec)


def _bert_heads(model: nn.Module) -> int:
    from multimodal_rare_disease_tpu_torch.models.bert import (
        BertSelfAttention,
    )

    heads = {m.num_heads * (m.tp.size if m.tp is not None else 1)
             for m in model.modules() if isinstance(m, BertSelfAttention)}
    if len(heads) > 1:
        raise ValueError(f"BERT layers with head counts {sorted(heads)}")
    return heads.pop() if heads else 1


def model_specs(model: nn.Module, model_size: int
                ) -> Dict[str, TPSplit]:
    """{parameter name: split} of an unsharded model."""
    heads = _bert_heads(model)
    specs = {}
    for name, p in model.named_parameters():
        spec = tp_spec(name, tuple(p.shape), model_size, heads)
        if spec is not None:
            specs[name] = spec
    return specs


def shard_model(model: nn.Module, mesh: Mesh) -> Dict[str, TPSplit]:
    """Cut a whole model (in place) to this rank's shards and give its
    modules their axes: the BERT attention and FFN their model axis
    where split, every Dropout its data split (and the attention
    probabilities' their heads split), every BatchNorm its data axis.
    → the splits by parameter name, kept as `model.tp_specs`. Call it
    before the model's optimizer is made."""
    from multimodal_rare_disease_tpu_torch.models.bert import (
        BertLayer,
        BertSelfAttention,
    )
    from multimodal_rare_disease_tpu_torch.models.layers import (
        BatchNorm,
        Dropout,
    )
    from multimodal_rare_disease_tpu_torch.models.quant import QuantLinear

    if getattr(model, "tp_specs", None) is not None:
        raise ValueError("the model is already sharded")
    data, mdl = mesh.axis("data"), mesh.axis("model")
    specs = model_specs(model, mdl.size) if mdl.size > 1 else {}
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, spec in specs.items():
            params[name].data = shard_tensor(params[name].data, spec,
                                             mdl.rank, mdl.size)
    for m in model.modules():
        if isinstance(m, Dropout) and data.size > 1:
            m.split = ((0, data),)
        elif isinstance(m, BatchNorm):
            m.data_axis = data if data.size > 1 else None
    for mod_name, m in model.named_modules():
        if isinstance(m, BertSelfAttention) \
                and f"{mod_name}.qkv.weight" in specs:
            m.tp = m.output.row_axis = mdl
            m.num_heads //= mdl.size
            m.dropout.split = m.dropout.split + ((1, mdl),)
        elif isinstance(m, BertLayer) \
                and f"{mod_name}.intermediate.weight" in specs:
            m.tp = m.output.row_axis = mdl
        elif isinstance(m, QuantLinear) and m.codes is not None \
                and f"{mod_name}.weight" in specs:
            _shard_int8_cache(m, specs, mod_name, mdl)
    model.tp_specs = specs
    return specs


def _shard_int8_cache(m, specs, name: str, axis: Axis) -> None:
    """Cut a QuantLinear's int8 cache (models/quant.py) as its weight was
    cut: the codes [out, in] by the weight's split; the scales and the
    bias [2, out] by the bias's, or whole when the layer is row-parallel
    (its column scales are those of the whole weight)."""
    with torch.no_grad():
        m.codes = shard_tensor(m.codes, specs[f"{name}.weight"], axis.rank,
                               axis.size)
        bias = specs.get(f"{name}.bias")
        if bias is not None:
            m.master_bits = shard_tensor(m.master_bits,
                                         TPSplit(1, bias.blocks), axis.rank,
                                         axis.size)


def _specs(model: nn.Module) -> Dict[str, TPSplit]:
    return getattr(model, "tp_specs", None) or {}


def gather_state_dict(model: nn.Module, mesh: Optional[Mesh]
                      ) -> Dict[str, torch.Tensor]:
    """The whole state dict of a sharded model, on the CPU. Every rank
    of the model axis must call it."""
    specs = _specs(model)
    out = {}
    for k, v in model.state_dict().items():
        if k in specs:
            v = gather_tensor(v, specs[k], mesh.axis("model"))
        out[k] = v.detach().cpu()
    return out


def shard_state_dict(state: Mapping[str, torch.Tensor], model: nn.Module,
                     mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """This rank's part of a whole state dict, for `model` sharded on
    `mesh` (the state dict unchanged when nothing is split)."""
    specs = _specs(model)
    if not specs:
        return dict(state)
    ax = mesh.axis("model")
    return {k: (shard_tensor(v, specs[k], ax.rank, ax.size) if k in specs
                else v) for k, v in state.items()}


def _optimizer_names(optimizer: torch.optim.Optimizer, model: nn.Module
                     ) -> Dict[int, str]:
    """{index in the optimizer's state dict: parameter name}."""
    by_id = {id(p): n for n, p in model.named_parameters()}
    flat = [p for g in optimizer.param_groups for p in g["params"]]
    return {i: by_id[id(p)] for i, p in enumerate(flat)}


def _map_optimizer_state(sd: Dict[str, Any], optimizer, model,
                         fn) -> Dict[str, Any]:
    names = _optimizer_names(optimizer, model)
    specs = _specs(model)
    state = {}
    for i, st in sd["state"].items():
        spec = specs.get(names[int(i)])
        state[i] = {k: (fn(v, spec) if spec is not None
                        and isinstance(v, torch.Tensor) and v.ndim > 0
                        else v) for k, v in st.items()}
    return {"state": state, "param_groups": sd["param_groups"]}


def gather_optimizer_state(optimizer: torch.optim.Optimizer,
                           model: nn.Module, mesh: Optional[Mesh]
                           ) -> Dict[str, Any]:
    """The optimizer's state dict with whole moments. Every rank of the
    model axis must call it."""
    sd = optimizer.state_dict()
    if not _specs(model):
        return sd
    ax = mesh.axis("model")
    return _map_optimizer_state(
        sd, optimizer, model, lambda v, s: gather_tensor(v, s, ax).cpu())


def shard_optimizer_state(sd: Dict[str, Any],
                          optimizer: torch.optim.Optimizer,
                          model: nn.Module, mesh: Optional[Mesh]
                          ) -> Dict[str, Any]:
    """This rank's part of an optimizer state dict with whole moments."""
    if not _specs(model):
        return sd
    ax = mesh.axis("model")
    return _map_optimizer_state(
        sd, optimizer, model,
        lambda v, s: shard_tensor(v, s, ax.rank, ax.size))


def sharded_parameters(model: nn.Module) -> Tuple[nn.Parameter, ...]:
    """The parameters that hold a share over the model axis."""
    specs = _specs(model)
    return tuple(p for n, p in model.named_parameters() if n in specs)


def describe_tp(model: nn.Module, mesh: Mesh) -> str:
    """How many of the parameters are split over the model axis."""
    specs = _specs(model)
    size = mesh.axis("model").size
    total = sharded = 0
    for n, p in model.named_parameters():
        whole = p.numel() * (size if n in specs else 1)
        total += whole
        sharded += whole if n in specs else 0
    return (f"tensor-parallel over model={size}: "
            f"{sharded / 1e6:.1f}M of {total / 1e6:.1f}M params sharded "
            f"({100.0 * sharded / max(total, 1):.0f}%)")
