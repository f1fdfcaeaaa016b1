"""Which rounding moves the f32 train steps of a 2x1 mesh away from the
1x1 step (chip_smoke.py phase 13's config: full width, SGD, TF32 off,
batch 8, the default augmentation and dropout). Each run takes the two
phase-13 steps from the same weights and batches:

- `1x1`, twice: the reference, and the card's run-to-run spread;
- `1x1 mean`: BatchNorm's mean and E[x²] as `mean()` over the batch
  instead of Σx/n and Σx²/n: the same statistics in another rounding;
- `1x1 bn_split`: BatchNorm's Σx, Σx² and n taken as two half-batch
  sums and added, as a 2x1 mesh adds its two ranks' sums;
- `1x1 op_split`: every Conv2d, Linear and Embedding module run on the
  two half-batches and concatenated: the per-rank shapes of 2x1, so the
  kernels cuDNN and cuBLAS choose for them, and weight gradients summed
  over two halves;
- `1x1 both`: bn_split and op_split together, 2x1's rounding on one rank
  without a process group;
- `2x1`: two ranks over gloo, as phase 13;
- `1x1 bn64` and `2x1 bn64`: BatchNorm's sums and its mean and variance
  in f64 (summed over the data axis in f64), everything else as before.

Prints each run's losses and its distance from the plain 1x1 run (loss
relative difference, largest parameter and BatchNorm-statistic
difference), and 2x1 bn64's from 1x1 bn64.

    python3 build/mesh_train_witness.py           # on the card
    python3 build/mesh_train_witness.py --small   # a CPU rehearsal at the
                                                  # CPU tests' widths
"""
import argparse
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))
import torch  # noqa: E402

# the CPU tests' widths (tests/test_torch_parallel_train.py)
SMALL = {"text_encoder.num_layers": 2, "text_encoder.num_heads": 4,
         "text_encoder.hidden_size": 64,
         "text_encoder.intermediate_size": 128,
         "cnn_encoder.stage_sizes": (1, 1, 1, 1),
         "cnn_encoder.embedding_dim": 32, "fusion.hidden_dim": 32,
         "fusion.num_attention_heads": 4, "data.image_size": 32}
# what the patched modules do: set per run, in each process
MODE = {"bn": None, "bn_mean": False, "bn_split": False,
        "bn_acc": torch.float32, "op_split": False}
RUNS_1X1 = {"1x1": {}, "1x1 again": {},
            "1x1 mean": {"bn": True, "bn_mean": True},
            "1x1 bn_split": {"bn": True, "bn_split": True},
            "1x1 op_split": {"op_split": True},
            "1x1 both": {"bn": True, "bn_split": True, "op_split": True},
            "1x1 bn64": {"bn": True, "bn_acc": torch.float64}}
RUNS_2X1 = {"2x1": {}, "2x1 bn64": {"bn": True, "bn_acc": torch.float64}}


def config(small):
    from multimodal_rare_disease_tpu_torch.config import resolve_config
    import chip_smoke as cs
    return resolve_config("default", {
        "training.compute_dtype": "float32", "training.optimizer": "sgd",
        "training.weight_decay": 0.0,
        "training.batch_size": cs.MESH_TRAIN_BATCH,
        "evaluation.eval_batch_size": cs.MESH_TRAIN_BATCH,
        **(SMALL if small else {})})


def patch():
    """Route BatchNorm (train mode) and the Conv2d, Linear and Embedding
    modules through MODE."""
    from torch import nn

    from multimodal_rare_disease_tpu_torch.models import layers
    from multimodal_rare_disease_tpu_torch.parallel.collectives import (
        sum_with_grad,
    )
    import chip_smoke as cs

    bn_orig = layers.BatchNorm.forward

    def bn_forward(self, x):
        if not (self.training and MODE["bn"]):
            return bn_orig(self, x)
        dims = [d for d in range(x.ndim) if d != 1]
        shape = [1, -1] + [1] * (x.ndim - 2)
        xf = x.float()
        c, acc = xf.shape[1], MODE["bn_acc"]
        if MODE["bn_mean"]:
            mean = xf.mean(dims)
            var = ((xf * xf).mean(dims) - mean * mean).clamp_min(0.0)
            return finish(self, x, xf, mean, var, shape)
        sums = 0
        for p in (xf.chunk(2) if MODE["bn_split"] else (xf,)):
            p = p.to(acc)
            sums = sums + torch.cat([
                p.sum(dims), (p * p).sum(dims),
                torch.full((1,), float(p.numel() // c), dtype=acc,
                           device=x.device)])
        axis = self.data_axis
        sums = sum_with_grad(sums, axis if axis is not None
                             and axis.size > 1 else None)
        mean = sums[:c] / sums[-1]
        var = (sums[c:2 * c] / sums[-1] - mean * mean).clamp_min(0.0)
        return finish(self, x, xf, mean.float(), var.float(), shape)

    def finish(self, x, xf, mean, var, shape):
        with torch.no_grad():
            m = self.MOMENTUM
            self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
            self.running_var.mul_(m).add_(var, alpha=1.0 - m)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        y = (xf - mean.view(shape)) * mul.view(shape) \
            + self.bias.float().view(shape)
        return y.to(x.dtype)

    layers.BatchNorm.forward = bn_forward

    def halves(orig):
        def forward(self, x, *a, **kw):
            n = cs.MESH_TRAIN_BATCH
            if MODE["op_split"] and self.training and x.shape[0] == n:
                return torch.cat([orig(self, x[:n // 2], *a, **kw),
                                  orig(self, x[n // 2:], *a, **kw)])
            return orig(self, x, *a, **kw)
        return forward

    for cls in (nn.Conv2d, nn.Linear, nn.Embedding):
        cls.forward = halves(cls.forward)


def two_steps(cfg, dev, mode, mesh=None):
    """The two phase-13 steps under `mode`: (losses, whole state dict)."""
    import chip_smoke as cs
    from multimodal_rare_disease_tpu_torch.parallel.tp import (
        gather_state_dict,
    )
    from multimodal_rare_disease_tpu_torch.train.trainer import Trainer
    MODE.update({"bn": None, "bn_mean": False, "bn_split": False,
                 "bn_acc": torch.float32, "op_split": False, **mode})
    batches, _ = cs.mesh_train_batches(cfg)
    tr = Trainer(cfg, "multimodal", device=dev, mesh=mesh)
    losses = []
    for lr, host in zip(cs.MESH_TRAIN_LRS, batches):
        b = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        losses.append(float(tr.train_step(b, lr)["loss"]))
    return losses, gather_state_dict(tr.model, mesh)


def distance(run, ref):
    (losses, state), (ref_losses, ref_state) = run, ref
    out = {"loss_rel": max(abs(a - b) / abs(b)
                           for a, b in zip(losses, ref_losses))}
    for kind in ("param", "stats"):
        keys = [k for k in ref_state
                if (".running_" in k) == (kind == "stats")]
        d = {k: float((state[k] - ref_state[k]).abs().max()) for k in keys}
        worst = max(d, key=d.get)
        out[kind] = (d[worst], worst)
    return out


def tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rank(r, world, small, dev_name):
    from multimodal_rare_disease_tpu_torch.parallel.mesh import create_mesh
    torch.set_num_threads(1 if dev_name == "cpu" else torch.get_num_threads())
    dev = torch.device(dev_name)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    tf32_off()
    patch()
    cfg = config(small)
    out = {}
    for name, mode in RUNS_2X1.items():
        mesh = create_mesh(cfg, data_axis=world, model_axis=1,
                           devices=[dev] * world)
        res = two_steps(cfg, dev, mode, mesh)
        out[name] = res if r == 0 else None
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--small", action="store_true",
                    help="the CPU tests' widths, on the CPU")
    args = ap.parse_args()
    import chip_smoke as cs
    from multimodal_rare_disease_tpu_torch.parallel.distributed import (
        run_ranks,
    )
    dev = torch.device("cpu" if args.small else "cuda:0")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        print(cs.card_line(), flush=True)
    tf32_off()
    patch()
    cfg = config(args.small)
    t0 = time.time()
    runs = {name: two_steps(cfg, dev, mode)
            for name, mode in RUNS_1X1.items()}
    runs.update(run_ranks(rank, 2, backend="gloo",
                          args=(args.small, str(dev)), timeout_s=900)[0])
    print(f"1x1 losses {runs['1x1'][0]}", flush=True)
    for name, run in runs.items():
        if name != "1x1":
            print(f"{name}: losses {run[0]} | from 1x1 "
                  f"{distance(run, runs['1x1'])}", flush=True)
    print(f"2x1 bn64 from 1x1 bn64: "
          f"{distance(runs['2x1 bn64'], runs['1x1 bn64'])}")
    print(f"took {time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
