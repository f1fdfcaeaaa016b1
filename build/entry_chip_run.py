"""Phase 15 of chip_smoke.py alone (`entry()`'s forward), run twice
after the kernels' build, then the card test of `entry()` and the entry
module's `__main__` (the dry run on 8 gloo ranks sharing the card).

    python3 build/entry_chip_run.py     # from the repository root, on a card
"""
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from multimodal_rare_disease_tpu_torch.kernels import build  # noqa: E402

dev = torch.device("cuda:0")
torch.cuda.set_device(dev)
card = chip_smoke.card_line()
print(card, torch.__version__, torch.version.cuda, flush=True)
t0 = time.perf_counter()
build.build()
build.load_library(dev)
print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
for _ in range(2):
    print(chip_smoke.entry_forward(dev, card), flush=True)
for cmd in ([sys.executable, "-m", "pytest", "--noconftest", "-m", "gpu",
             "tests/test_torch_gpu.py", "-q", "-p", "no:cacheprovider",
             "-k", "test_entry_launches"],
            [sys.executable, "-m", "multimodal_rare_disease_tpu_torch.entry"]):
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                       timeout=600)
    print(" ".join(cmd[1:4]), "rc", r.returncode, r.stdout[-3000:],
          r.stderr[-3000:], f"{time.perf_counter() - t0:.1f} s", flush=True)
