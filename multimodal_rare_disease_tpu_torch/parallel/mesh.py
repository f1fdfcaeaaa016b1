"""The rank mesh: the counterpart of
`multimodal_rare_disease_tpu/parallel/mesh.py`.

The JAX package lays its devices out as a `jax.sharding.Mesh` over
('data', 'model') in one process. Here each rank is a process: the
world's ranks are laid out row-major as a (data, model) grid, rank =
data_index * model + model_index, and each rank gets two process groups,
its data group (the ranks with its model index) and its model group (the
ranks with its data index). A batch is split over the data axis, each
rank taking its contiguous slice of the leading axis (`shard_batch`);
parameters are replicated, except the BERT tower's Megatron shards over
the model axis (`parallel/tp.py`). The shape rules are the JAX ones:
`data_axis=-1` takes every rank the model axis leaves, and a request
that does not divide the ranks, or needs more than there are, raises
ValueError with the JAX text. A world of one is a 1x1 mesh that calls no
collective.

Unlike the JAX mesh, a rank past data x model holds no place in it:
`create_mesh` returns None there (ROADMAP D17). The groups come from
`dist.new_group`, not `init_device_mesh`: that one needs a mesh that
covers the whole world and picks each rank's card by its rank, where
here ranks may share a card (`devices=`) or leave ranks out.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from multimodal_rare_disease_tpu_torch.config import Config, MeshConfig
from multimodal_rare_disease_tpu_torch.parallel.distributed import (
    DEFAULT_TIMEOUT_S,
    rank as world_rank,
    world_size,
)


class Axis(NamedTuple):
    """One axis of the mesh as a rank sees it: the process group (None
    when the axis holds this rank alone), the rank's index along it and
    its size."""
    group: Any
    rank: int
    size: int


@dataclass(frozen=True)
class Mesh:
    data: int
    model: int
    rank: int
    device: torch.device
    axes: Dict[str, Axis]
    axis_names: Tuple[str, ...] = ("data", "model")

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_names[0]: self.data, self.axis_names[1]: self.model}

    def axis(self, name: str) -> Axis:
        """'data', 'model' or 'world' (every rank of the mesh)."""
        return self.axes[name]

    def rows(self, n: int) -> slice:
        """This rank's contiguous slice of n rows over the data axis."""
        d = self.data
        if n % d:
            raise ValueError(f"{n} rows do not split evenly over the data "
                             f"axis of {d} ranks")
        r = self.axes["data"].rank
        return slice(r * (n // d), (r + 1) * (n // d))

    def describe(self) -> str:
        return (f"mesh {self.shape} on {self.device} (rank {self.rank}: "
                f"data {self.axes['data'].rank}, model "
                f"{self.axes['model'].rank})")


def mesh_shape(n: int, data_axis: int = -1, model_axis: int = 1
               ) -> Tuple[int, int]:
    """(data, model) for n ranks, by the JAX `create_mesh` rules."""
    if model_axis <= 0:
        model_axis = 1
    if data_axis == -1:
        if n % model_axis != 0:
            raise ValueError(
                f"{n} devices not divisible by model_axis={model_axis}")
        data_axis = n // model_axis
    if data_axis * model_axis > n:
        raise ValueError(
            f"mesh {data_axis}x{model_axis} needs {data_axis * model_axis} "
            f"devices, have {n}")
    return data_axis, model_axis


def rank_devices(n: int, device="cuda") -> Tuple[torch.device, ...]:
    """The device of each of n ranks: with a bare 'cuda', rank r takes
    card r modulo the cards there are (so ranks share a card when there
    are fewer cards than ranks); any other device is every rank's. No
    card and a CUDA device raises: nothing falls back to the CPU."""
    from multimodal_rare_disease_tpu_torch.models.classifier import (
        resolve_device,
    )

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        count = torch.cuda.device_count()
        return tuple(torch.device("cuda", r % count) for r in range(n))
    return (dev,) * n


def describe_devices(device="cuda") -> str:
    """'<ranks>x <type>:<name>' for the world (one rank when no process
    group is up), as the JAX `describe_devices`."""
    from multimodal_rare_disease_tpu_torch.models.classifier import (
        resolve_device,
    )

    dev = resolve_device(device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    cards = (f", {torch.cuda.device_count()} card(s)"
             if dev.type == "cuda" else "")
    return f"{world_size()}x {dev.type}:{name}{cards}"


def _new_group(ranks: Sequence[int], timeout_s: float):
    import datetime

    return dist.new_group(list(ranks),
                          timeout=datetime.timedelta(seconds=timeout_s))


def create_mesh(cfg: Optional[Config] = None, *,
                data_axis: Optional[int] = None,
                model_axis: Optional[int] = None,
                devices: Optional[Sequence[Any]] = None,
                timeout_s: float = DEFAULT_TIMEOUT_S) -> Optional[Mesh]:
    """This rank's place in the run mesh over the default process group
    (a world of one without one).

    `devices`: each rank's device, one per rank of the world (2-4 ranks
    may name one card); by default `rank_devices(world)`, the card. The
    `mesh.allow_cpu_fallback` flag does not move a CUDA run to the CPU.
    CPU ranks of a world of n take at most cores / n threads each. Every
    rank of the world must call it, in the same order as any other
    `create_mesh`: it makes the process groups. → None on a rank past
    data x model."""
    mc = cfg.mesh if cfg is not None else MeshConfig()
    if data_axis is None:
        data_axis = mc.data_axis
    if model_axis is None:
        model_axis = mc.model_axis
    n = world_size()
    devs = (tuple(torch.device(d) for d in devices) if devices is not None
            else rank_devices(n))
    if len(devs) != n:
        raise ValueError(f"{len(devs)} devices named for a world of {n} "
                         f"ranks")
    d, m = mesh_shape(n, data_axis, model_axis)
    me = world_rank()
    grid = np.arange(d * m).reshape(d, m)
    groups: Dict[str, Any] = {}
    if n > 1:
        # every rank makes every group, in one order (torch's rule)
        for i in range(d):
            g = _new_group(grid[i], timeout_s) if m > 1 else None
            if me in grid[i]:
                groups["model"] = g
        for j in range(m):
            g = _new_group(grid[:, j], timeout_s) if d > 1 else None
            if me in grid[:, j]:
                groups["data"] = g
        groups["world"] = (_new_group(range(d * m), timeout_s)
                           if d * m < n else dist.group.WORLD)
    if me >= d * m:
        return None
    dev = devs[me]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    elif n > 1:
        # CPU ranks share the host's cores
        torch.set_num_threads(min(torch.get_num_threads(),
                                  max(1, (os.cpu_count() or 1) // n)))
    names = tuple(mc.axis_names)
    axes = {
        "data": Axis(groups.get("data"), me // m, d),
        "model": Axis(groups.get("model"), me % m, m),
        "world": Axis(groups.get("world"), me, d * m),
    }
    return Mesh(d, m, me, dev, axes, names)


class Sharding(NamedTuple):
    """Where an array lives on the mesh: split over the data axis
    (`axis='data'`) or replicated (`axis=None`)."""
    mesh: Mesh
    axis: Optional[str]


def batch_sharding(mesh: Mesh) -> Sharding:
    """Leading-axis (batch) split over the data axis."""
    return Sharding(mesh, "data")


def replicated_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def _place(x, mesh: Mesh, split: bool) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        a = np.asarray(x)
        x = torch.from_numpy(a if a.flags.c_contiguous else a.copy())
    t = x
    if split and t.ndim >= 1:
        t = t[mesh.rows(t.shape[0])]
    return t.to(mesh.device)


def shard_batch(mesh: Mesh, batch: Any) -> Any:
    """A host batch (a dict, list or tuple of arrays, nested) on this
    rank's device, each array's leading axis cut to the rank's contiguous
    slice over the data axis; scalars whole. Pads nothing: a leading axis
    that the data axis does not divide raises ValueError."""
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(mesh, v) for v in batch)
    return _place(batch, mesh, split=True)


def param_sharding(mesh: Mesh, params: Any) -> Any:
    """Replicated shardings matching a parameter dict."""
    rep = replicated_sharding(mesh)
    return {k: rep for k in params}


def data_axis_size(mesh: Mesh) -> int:
    return mesh.shape[mesh.axis_names[0]]
