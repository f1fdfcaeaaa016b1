"""Where a full-width train step's time goes on the card: chip_smoke.py
phase 10's trainer (bf16, batch 8, resident) in a fresh process, 20
steps timed (host clock, synchronized), the peak memory of one, 5 steps
under torch.profiler (device busy time from the kernel events), and a
validation pass split into the weight copy and the batch.

    python3 build/train_step_profile.py
"""
import sys, time
from pathlib import Path
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import numpy as np, torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
import chip_smoke as cs
from multimodal_rare_disease_tpu_torch.config import resolve_config, PREFIX_TO_SYNDROME, SYNDROME_NAMES
from multimodal_rare_disease_tpu_torch.data.images import ImageSample
from multimodal_rare_disease_tpu_torch.data.synthetic import SyntheticImageGenerator
from multimodal_rare_disease_tpu_torch.kernels import build
from multimodal_rare_disease_tpu_torch.train.pipeline import DataPipeline
from multimodal_rare_disease_tpu_torch.train.trainer import Trainer
dev = torch.device("cuda:0"); torch.cuda.set_device(dev)
print(cs.card_line(), flush=True)
build.build(); build.load_library(dev)
synth = SyntheticImageGenerator(image_size=256, seed=42)
prefix = {n: c for c, n in PREFIX_TO_SYNDROME.items()}
samples, decoded = [], {}
for c, name in enumerate(SYNDROME_NAMES):
    for i in range(4):
        p = f"synthetic/SYN_{prefix[name]}_{i+1:03d}.png"
        samples.append(ImageSample(p, c, name)); decoded[p] = synth.generate(c, i)
cfg = resolve_config("default", {"training.learning_rate": cs.TRAIN_LR, "training.lr_mult_text": cs.TRAIN_LR_MULT_TEXT,
                                 "training.warmup_epochs": 0})
pipe = DataPipeline(cfg, "multimodal", samples=samples, decoded=decoded)
tr = Trainer(cfg, "multimodal", pipeline=pipe, workdir="build/prof", device=dev)
tr.init_state()
idx = next(pipe.train_index_batches())
for _ in range(3):
    tr.train_step(tr._resident_batch(idx, "train"), cs.TRAIN_LR)
torch.cuda.synchronize()
lat = []
for _ in range(20):
    b = tr._resident_batch(idx, "train")
    torch.cuda.synchronize(); t = time.perf_counter()
    tr.train_step(b, cs.TRAIN_LR); torch.cuda.synchronize()
    lat.append((time.perf_counter() - t) * 1e3)
print("fresh-process train step ms: median", np.median(lat), "all", [round(x, 1) for x in lat], flush=True)
torch.cuda.reset_peak_memory_stats(dev); base = torch.cuda.memory_allocated(dev)
tr.train_step(tr._resident_batch(idx, "train"), cs.TRAIN_LR); torch.cuda.synchronize()
print("memory GiB: before", base / 2**30, "peak", torch.cuda.max_memory_allocated(dev) / 2**30, flush=True)
N = 5
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    torch.cuda.synchronize(); t = time.perf_counter()
    for _ in range(N):
        tr.train_step(tr._resident_batch(idx, "train"), cs.TRAIN_LR)
    torch.cuda.synchronize(); wall = (time.perf_counter() - t) * 1e3 / N
ka = prof.key_averages()
# device time: the kernel and memcpy events; a range that
# torch.profiler records on the device for an annotated host region
# (`Optimizer.step#AdamW.step`) spans kernels counted already, so it is
# left out and shown apart
dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def annotation(e):
    # kernel names hold '#' too ("{lambda(int)#1}"): match the ranges
    return (getattr(e, "is_user_annotation", False)
            or e.name.startswith("Optimizer."))


kern = [e for e in dev if not annotation(e)]
busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3 / N
annot = sum(e.time_range.elapsed_us() for e in dev if annotation(e)) / 1e3 / N
print("annotation ranges left out:",
      sorted({e.name for e in dev if annotation(e)}), flush=True)
step = float(np.median(lat))
print(f"profiled: {len(kern) / N:.0f} device events per step, device busy "
      f"{busy:.2f} ms/step (annotation ranges left out: {annot:.2f} "
      f"ms/step); against the unprofiled median step {step:.2f} ms the "
      f"device is idle {1 - busy / step:.1%} (profiled wall {wall:.2f} "
      f"ms/step)", flush=True)
by_name = {}
for e in kern:
    t, n = by_name.get(e.name, (0.0, 0))
    by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
    print(f"  {t / 1e3 / N:8.3f} ms/step  x{n / N:6.1f}  {name[:100]}")
print("top host self time per step (profiled):")
for e in sorted(ka, key=lambda e: e.self_cpu_time_total, reverse=True)[:8]:
    print(f"  {e.self_cpu_time_total / 1e3 / N:8.3f} ms  x{e.count / N:7.1f}  "
          f"{e.key[:100]}")
# validation: the weight sync against the batch
for _ in range(2):
    tr._validate()
t = time.perf_counter(); tr.sync_eval_model(); torch.cuda.synchronize(); sync = (time.perf_counter() - t) * 1e3
vb = tr._resident_batch(next(pipe.val_index_batches()), "val")
tr.eval_step(vb); torch.cuda.synchronize()
t = time.perf_counter(); tr.eval_step(vb); torch.cuda.synchronize(); ev = (time.perf_counter() - t) * 1e3
t = time.perf_counter(); tr._validate(); torch.cuda.synchronize(); val = (time.perf_counter() - t) * 1e3
print(f"validation ms: whole {val:.2f}, weight sync {sync:.2f}, one eval batch {ev:.2f}", flush=True)
