"""The learning rate of chip_smoke.py phase 10: its trainer (full width,
the synthetic corpus, batch 8, bf16) at a few rates in one process on
the card, each printing the loss on the training images in eval mode
before and after train() and the train loss by epoch. No checkpoints
are written.

    python3 build/train_lr_sweep.py
"""
import subprocess, sys, time
from pathlib import Path
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import numpy as np, torch
from multimodal_rare_disease_tpu_torch.config import resolve_config, PREFIX_TO_SYNDROME, SYNDROME_NAMES
from multimodal_rare_disease_tpu_torch.data.images import ImageSample
from multimodal_rare_disease_tpu_torch.data.synthetic import SyntheticImageGenerator
from multimodal_rare_disease_tpu_torch.train.pipeline import DataPipeline
from multimodal_rare_disease_tpu_torch.train.trainer import Trainer
dev = torch.device("cuda:0")
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True).stdout.strip(), flush=True)
synth = SyntheticImageGenerator(image_size=256, seed=42)
prefix = {n: c for c, n in PREFIX_TO_SYNDROME.items()}
samples, decoded = [], {}
for c, name in enumerate(SYNDROME_NAMES):
    for i in range(4):
        p = f"synthetic/SYN_{prefix[name]}_{i+1:03d}.png"
        samples.append(ImageSample(p, c, name)); decoded[p] = synth.generate(c, i)
# (lr, text-tower multiplier, epochs, early stopping): phase 10's first
# setting, then the candidates
for lr, mt, ep, early in [(1e-4, 1.0, 12, True), (1e-3, 0.1, 40, True),
                          (3e-4, 0.1, 40, True), (3e-4, 0.1, 40, False)]:
    cfg = resolve_config("default", {"training.num_epochs": ep, "training.warmup_epochs": 0,
        "training.learning_rate": lr, "training.lr_mult_text": mt, "training.save_checkpoints": False,
        "training.early_stopping": early})
    pipe = DataPipeline(cfg, "multimodal", samples=samples, decoded=decoded)
    tr = Trainer(cfg, "multimodal", pipeline=pipe, workdir="build/sweep", device=dev)
    tr.init_state()
    b = 16
    z = np.zeros(len(pipe.train_labels), np.int64)
    ids, mask = pipe.text_pool.gather(pipe.train_labels, z, z)
    ts = [{"images": pipe.train_images[i:i+b], "labels": pipe.train_labels[i:i+b], "valid": np.ones(len(pipe.train_labels[i:i+b]), np.float32),
           "input_ids": ids[i:i+b], "attention_mask": mask[i:i+b]} for i in range(0, len(z), b)]
    before = tr._validate(ts)["loss"]
    t = time.time(); out = tr.train(); el = time.time() - t
    after = tr._validate(ts)["loss"]
    print(f"SWEEP lr {lr} text x{mt} epochs {ep} early stopping {early}: train-set eval loss {before:.4f} -> {after:.4f} in {el:.1f}s; train loss",
          [round(x, 3) for x in out["history"]["train_loss"]], "val acc", out["history"]["val_acc"][-5:], "skipped", out["skipped_steps"], flush=True)
    del tr
    torch.cuda.empty_cache()
