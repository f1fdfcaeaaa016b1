"""Where the f32 train steps of a 2x1 and a 1x2 mesh leave the 1x1 step
on one card (chip_smoke.py phase 13's config: full width, SGD, TF32 off,
batch 8, dropout on), for three inputs: the default augmentation (the
rotation goes through bf16), the rotation off, and no augmentation
(`apply_step` on eval-preprocessed images). The 1x1 step runs twice, for
the card's own run-to-run spread; the two ranks share the card over
gloo.

    python3 build/mesh_train_diag.py     # from the root of a checkout

Prints, per input, the 1x1 losses and the 1x1-against-1x1 spread, then
per (input, data, model): the losses, their relative difference from
1x1 and the largest parameter and BatchNorm-statistic differences (the
leaf and its size relative to the leaf's largest value)."""
import sys
import time
from pathlib import Path
HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))
import torch

VARIANTS = {"default": {}, "no_rotation": {"data.online_rotation": False},
            "no_augmentation": {}}


def cfg_of(name):
    from multimodal_rare_disease_tpu_torch.config import resolve_config
    import chip_smoke as cs
    return resolve_config("default", {
        "training.compute_dtype": "float32", "training.optimizer": "sgd",
        "training.weight_decay": 0.0, "training.batch_size": cs.MESH_TRAIN_BATCH,
        "evaluation.eval_batch_size": cs.MESH_TRAIN_BATCH, **VARIANTS[name]})


def steps(tr, name, batches, dev):
    import chip_smoke as cs
    from multimodal_rare_disease_tpu_torch.ops.preprocess import eval_preprocess
    losses = []
    for lr, host in zip(cs.MESH_TRAIN_LRS, batches):
        b = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        if name == "no_augmentation":
            x = eval_preprocess(b["images"], tr.cfg, torch.float32, use_kernel=False)
            losses.append(float(tr.apply_step(x, b, lr)["loss"]))
        else:
            losses.append(float(tr.train_step(b, lr)["loss"]))
    return losses


def diffs(state, ref):
    out = {}
    for kind in ("param", "stats"):
        keys = [k for k in ref if (".running_" in k) == (kind == "stats")]
        ab = max(float((state[k] - ref[k]).abs().max()) for k in keys)
        worst = max(keys, key=lambda k: float((state[k] - ref[k]).abs().max()))
        rel = float((state[worst] - ref[worst]).abs().max() / ref[worst].abs().max())
        out[kind] = (ab, worst, rel)
    return out


def rank(r, world, refs_path):
    import chip_smoke as cs
    from multimodal_rare_disease_tpu_torch.parallel.mesh import create_mesh
    from multimodal_rare_disease_tpu_torch.parallel.tp import gather_state_dict
    from multimodal_rare_disease_tpu_torch.train.trainer import Trainer
    dev = torch.device("cuda:0"); torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    refs = torch.load(refs_path, weights_only=False)
    out = {}
    for name in VARIANTS:
        cfg = cfg_of(name)
        batches, _ = cs.mesh_train_batches(cfg)
        for d, m in ((2, 1), (1, 2)):
            mesh = create_mesh(cfg, data_axis=d, model_axis=m, devices=[dev] * world)
            tr = Trainer(cfg, "multimodal", device=dev, mesh=mesh)
            losses = steps(tr, name, batches, dev)
            st = gather_state_dict(tr.model, mesh)
            rl, rs = refs[name]
            out[(name, d, m)] = (losses, [abs(a - b) / b for a, b in zip(losses, rl)], diffs(st, rs))
            del tr; torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    import chip_smoke as cs
    from multimodal_rare_disease_tpu_torch.parallel.distributed import run_ranks
    from multimodal_rare_disease_tpu_torch.train.trainer import Trainer
    dev = torch.device("cuda:0"); torch.cuda.set_device(dev)
    print(cs.card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    refs = {}
    t0 = time.time()
    for name in VARIANTS:
        cfg = cfg_of(name)
        batches, _ = cs.mesh_train_batches(cfg)
        out = []
        for rep in range(2):  # the 1x1 step twice: its own run-to-run spread
            tr = Trainer(cfg, "multimodal", device=dev)
            losses = steps(tr, name, batches, dev)
            out.append((losses, {k: v.detach().cpu() for k, v in tr.model.state_dict().items()}))
            del tr; torch.cuda.empty_cache()
        refs[name] = out[0]
        print(name, "1x1 losses", out[0][0], "1x1 vs 1x1:", [abs(a - b) for a, b in zip(out[0][0], out[1][0])], diffs(out[1][1], out[0][1]), flush=True)
    p = HERE / "build" / "diag_refs.pt"
    torch.save(refs, p)
    res = run_ranks(rank, 2, backend="gloo", args=(str(p),), timeout_s=900)[0]
    for k, v in res.items():
        print(k, v, flush=True)
    print("took", time.time() - t0)
