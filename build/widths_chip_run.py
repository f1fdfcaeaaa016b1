"""One width phase of chip_smoke.py alone, after the kernels' build and
their ptxas check, then the card tests of that phase's widths: phase 17
(BERT-large, H = 1,024), 18 (the compact BERTs, H = 512, 256, 128, with
K1/K2 at intermediate widths other than 4H at every built width), 19
(the odd multiples of 128: MiniLM-L12-H384, H = 640 and 896) or 20 (the
widths above 1,024: the 24-layer tower at microsoft/deberta-v2-xlarge's
widths, H = 1,536, and H = 1,152, 1,280 and 1,408).

    python3 build/widths_chip_run.py [17|18|19|20]  # default 20; from the
                                                    # repository root, on a
                                                    # card
"""
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from multimodal_rare_disease_tpu_torch.inference import (  # noqa: E402
    seeded_batch,
)
from multimodal_rare_disease_tpu_torch.kernels import build  # noqa: E402

# phase -> (its function in chip_smoke.py, the card tests' -k expression)
PHASES = {17: (chip_smoke.bert_large, "h1024"),
          18: (chip_smoke.compact_widths,
               "h512 or h256 or h128 or other_intermediate"),
          19: (chip_smoke.odd_widths, "h384 or h640 or h896"),
          20: (chip_smoke.wide_widths, "h1152 or h1280 or h1408 or h1536")}

phase, tests = PHASES[int(sys.argv[1]) if len(sys.argv) > 1 else 20]
dev = torch.device("cuda:0")
torch.cuda.set_device(dev)
card = chip_smoke.card_line()
print(card, torch.__version__, torch.version.cuda, flush=True)
t0 = time.perf_counter()
lib_path = build.build()
build.load_library(dev)
faults = chip_smoke.ptxas_faults((lib_path.parent / "ptxas.log").read_text())
print(f"build {time.perf_counter() - t0:.1f} s (nvcc "
      f"{build.last_build_seconds:.1f} s); ptxas spills or C75xx: "
      f"{faults or 'none'}", flush=True)
if faults:
    raise SystemExit(1)
images, texts = seeded_batch.seeded_requests(chip_smoke.BATCH, seed=0)
clock = chip_smoke.timing_helpers(images, texts)
launches, times = phase(dev, card, images, texts, clock.in_turns,
                        clock.p50_ms, clock.serve)
print({k: v for k, v in launches.items() if v}, flush=True)
print(times, flush=True)
cmd = [sys.executable, "-m", "pytest", "--noconftest", "-m", "gpu",
       "tests/test_torch_gpu.py", "-q", "-p", "no:cacheprovider", "-k", tests]
t0 = time.perf_counter()
r = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True, timeout=900)
print(" ".join(cmd[1:]), "rc", r.returncode, r.stdout[-3000:],
      r.stderr[-3000:], f"{time.perf_counter() - t0:.1f} s", flush=True)
raise SystemExit(r.returncode)
