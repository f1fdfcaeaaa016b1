"""Rank functions of the torch package's mesh tests
(tests/test_torch_parallel*.py), run by `parallel.distributed.run_ranks`
in spawned processes over gloo, on the CPU (and on one card for
tests/test_torch_gpu.py). This module imports torch and the torch
package only, so a rank does not load jax."""

import numpy as np
import torch

from multimodal_rare_disease_tpu_torch.config import resolve_config
from multimodal_rare_disease_tpu_torch.data.tokenizer import (
    BertWordPieceTokenizer,
)
from multimodal_rare_disease_tpu_torch.inference.predictor import (
    MultimodalPredictor,
)
from multimodal_rare_disease_tpu_torch.models.classifier import create_model
from multimodal_rare_disease_tpu_torch.parallel import collectives as col
from multimodal_rare_disease_tpu_torch.parallel.mesh import create_mesh
from multimodal_rare_disease_tpu_torch.parallel.tp import (
    gather_optimizer_state,
    gather_state_dict,
    shard_state_dict,
)
from multimodal_rare_disease_tpu_torch.train.trainer import Trainer


def _mesh(world, d, m, cfg=None, device="cpu"):
    torch.set_num_threads(1)
    return create_mesh(cfg, data_axis=d, model_axis=m,
                       devices=[device] * world)


def collectives_rank(rank, world):
    """Each collective on a 1 x world mesh (the model axis) and on a
    world x 1 one (the data axis)."""
    out = {}
    mesh = _mesh(world, 1, world)
    ax = mesh.axis("model")
    x = torch.arange(6, dtype=torch.float32).view(2, 3) + 10 * rank
    out["gather0"] = col.all_gather(x, ax, dim=0).numpy()
    out["gather1"] = col.all_gather(x.to(torch.bfloat16), ax,
                                    dim=-1).float().numpy()
    out["sum_bf16"] = col.all_sum(torch.full((3,), 0.5 + rank,
                                             dtype=torch.bfloat16),
                                  ax).float().numpy()
    obj = {"texts": ["a", "b"], "images": [np.full((2, 2), 7, np.uint8)]}
    got = col.broadcast_object(obj if rank == 0 else None, ax,
                               col.object_device(ax, mesh.device))
    out["broadcast"] = (got["texts"], got["images"][0].tolist())
    # autograd: d/dx of sum(w * f(x)) for each of the three forms
    w = torch.tensor([1.0, 2.0, 3.0]) * (rank + 1)
    grads = {}
    for name, fn in (("sum", col.sum_with_grad),
                     ("reduce", col.reduce_from_model),
                     ("copy", col.copy_to_model)):
        xx = torch.full((3,), 1.0 + rank, requires_grad=True)
        (fn(xx, ax) * w).sum().backward()
        grads[name] = xx.grad.numpy()
    out["grads"] = grads
    dmesh = _mesh(world, world, 1)
    out["rows"] = dmesh.rows(4 * world)
    return out


class _FaultyPredictor:
    """A predictor whose batch fails on rank 1 before its collective;
    rank 0 waits in that collective, as the sharded predictor's gather."""

    mode = "text_only"

    def __init__(self, mesh, rank):
        self.mesh, self.device, self.rank = mesh, mesh.device, rank

    def predict_batch(self, images=None, texts=None, top_k=5):
        if self.rank == 1:
            raise RuntimeError("follower fault on rank 1")
        col.all_sum(torch.ones(1), self.mesh.axis("world"))
        return [{} for _ in texts]


def serve_fault_rank(rank, world):
    """`cli/serve.py`'s leader and follower over a predictor that fails
    on rank 1 only."""
    from multimodal_rare_disease_tpu_torch.cli import serve

    predictor = _FaultyPredictor(_mesh(world, world, 1), rank)
    if rank != 0:
        return serve.follow(predictor)
    leader = serve.MeshLeader(predictor, ping_s=3600.0)
    leader.predict_batch(texts=["a", "b"])
    leader.close()
    return "served"


def predict_rank(rank, world, over, state, vocab, images, texts, shapes,
                 device="cpu"):
    """The sharded predictor over each (data, model) mesh of `shapes` on
    `device`, from the whole `state` (None: the weights of seed 0): →
    {'DxM': (probs, bucket of 1, packed calls, classic calls, this rank's
    qkv rows, K1 launches)} on the ranks of each mesh."""
    from multimodal_rare_disease_tpu_torch.kernels import ffn

    cfg = resolve_config("default", over)
    tok = BertWordPieceTokenizer(vocab)
    out = {}
    for d, m in shapes:
        mesh = _mesh(world, d, m, cfg, device)
        if mesh is None:
            continue
        model = create_model(cfg, device="cpu",
                             seed=0 if state is None else None)
        if state is not None:
            model.load_state_dict(state, strict=True)
        p = MultimodalPredictor(cfg, model, mesh=mesh, tokenizer=tok)
        ffn.LAUNCHES_K1 = 0
        res = p.predict_batch(images=images, texts=texts)
        probs = np.array([[r["all_probabilities"][k]
                           for k in sorted(r["all_probabilities"])]
                          for r in res])
        qkv = p.model.text_encoder.bert.layer0.attention.qkv.weight
        out[f"{d}x{m}"] = (probs, p._bucket(1), p.packed_calls,
                           p.classic_calls, tuple(qkv.shape),
                           ffn.LAUNCHES_K1)
    return out


def _trainer(cfg, mesh, state, class_w, workdir):
    tr = Trainer(cfg, "multimodal", device="cpu", mesh=mesh,
                 workdir=workdir)
    tr.model.load_state_dict(shard_state_dict(state, tr.model, mesh),
                             strict=True)
    tr.class_weights = torch.from_numpy(class_w)
    return tr


def train_rank(rank, world, over, state, class_w, batches, steps,
               workdir):
    """Two steps on a 2x1 and a 1x2 mesh from the same weights: with
    `train_step` on raw global batches (augmentation, dropout, mixup) and
    with `apply_step` on model-ready images and a given mixup; then the
    1x2 trainer's checkpoint, loaded by a trainer on a 2x1 mesh. → per
    mesh: losses, skipped flags and the gathered state dicts."""
    cfg = resolve_config("default", over["full"])
    cfg_plain = resolve_config("default", over["plain"])
    out = {}
    for d, m in ((2, 1), (1, 2)):
        for kind, c in (("train", cfg), ("apply", cfg_plain)):
            tr = _trainer(c, _mesh(world, d, m, c), state, class_w,
                          workdir)
            metrics = []
            for (lr, batch), step in zip(batches[kind], steps[kind]):
                b = {k: torch.from_numpy(v) for k, v in batch.items()}
                if kind == "train":
                    r = tr.train_step(b, lr)
                else:
                    images, mix = step
                    r = tr.apply_step(torch.from_numpy(images), b, lr,
                                      None if mix is None else
                                      (mix[0], torch.from_numpy(mix[1])))
                metrics.append((float(r["loss"]), float(r["acc"]),
                                r["skipped"]))
            out[(f"{d}x{m}", kind)] = (
                metrics, gather_state_dict(tr.model, tr.mesh),
                gather_optimizer_state(tr.state.optimizer, tr.model,
                                       tr.mesh))
            if kind == "train":
                # a validation batch (its last rows padded) on the eval copy
                tr.sync_eval_model()
                out[(f"{d}x{m}", "eval")] = {
                    k: float(v) for k, v in tr.eval_step(
                        {k: torch.from_numpy(v)
                         for k, v in batches["eval"].items()}).items()}
    # the 1x2 trainer's checkpoint (written by rank 0 from its gathered
    # shards) onto a 2x1 mesh
    path = tr.save("last", 0)
    back = Trainer(cfg_plain, "multimodal", device="cpu",
                   mesh=_mesh(world, 2, 1, cfg_plain), workdir=workdir)
    back.load(path)
    out["reloaded"] = (str(path), gather_state_dict(back.model, back.mesh),
                       gather_optimizer_state(back.state.optimizer,
                                              back.model, back.mesh),
                       back.state.step)
    return out if rank == 0 else None


def int8_cache_rank(rank, world, over):
    """On a 1 x world mesh: the int8 cache (models/quant.py) of a bf16
    model, made from the whole f32 weights and cut by `shard_model`,
    against the one `prepare_quantized` makes on the f32 shards (maxima
    over the model axis) → {layer name: (codes equal, scales and bias
    equal, row-parallel)}."""
    from multimodal_rare_disease_tpu_torch.models import quant
    from multimodal_rare_disease_tpu_torch.parallel.tp import shard_model

    cfg = resolve_config("default", over)
    mesh = _mesh(world, 1, world, cfg)
    cut = create_model(cfg, device="cpu", seed=0, dtype=torch.bfloat16)
    assert all(m.codes is not None for _, m in quant.quant_layers(cut))
    shard_model(cut, mesh)
    made = create_model(cfg, device="cpu", seed=0)
    shard_model(made, mesh)
    assert quant.prepare_quantized(made) == len(quant.quant_layers(made))
    return {name: (torch.equal(a.codes, b.codes),
                   torch.equal(a.master_bits, b.master_bits),
                   a.row_axis is not None)
            for (name, a), (_, b) in zip(quant.quant_layers(cut),
                                         quant.quant_layers(made))}
