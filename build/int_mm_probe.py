"""torch._int_mm's shape rules and the int8 scale division on the card.

    python3 build/int_mm_probe.py      # on a machine with a CUDA card

Prints, for row counts 1-1024 and the BERT tower's two product shapes,
whether `_int_mm` accepts the call with the second operand column-major
(a transposed [N, K] weight) and row-major, and whether its int32 result
equals the CPU's; then how many of 4,096 per-row scales amax / 127 differ
from the CPU's when the card divides by a Python float, by a 0-d device
tensor and with torch.div, and the codes x / scale card vs CPU."""
import subprocess
import sys

import torch

print(sys.version, torch.__version__, torch.version.cuda)
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout)
dev = torch.device("cuda")
g = torch.Generator().manual_seed(0)
for m in (1, 8, 16, 17, 24, 32, 33, 1024):
    for k, n in ((768, 2304), (3072, 768)):
        a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
        w = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
        ref = a.int() @ w.t().int()
        for lay, b in (("colmajor", w.t()), ("rowmajor", w.t().contiguous())):
            try:
                r = torch._int_mm(a.to(dev), b.to(dev)).cpu()
                print(m, k, n, lay, "ok", bool((r == ref).all()))
            except RuntimeError as e:
                print(m, k, n, lay, "ERR", str(e).splitlines()[0][:160])
x = torch.randn(4096, 3072, generator=g) * 3
amax = x.abs().amax(-1, keepdim=True).clamp_min(1e-8)
cpu = amax / 127.0
for name, fn in (
        ("py-float", lambda t: t / 127.0),
        ("dev-tensor", lambda t: t / torch.full((), 127.0, device=t.device)),
        ("torch.div", lambda t: torch.div(
            t, torch.tensor(127.0, device=t.device)))):
    got = fn(amax.to(dev)).cpu()
    print(name, "ulp-diffs vs CPU:", int((got != cpu).sum()), "of",
          cpu.numel())
q_cpu = torch.round(x / cpu).clamp(-127, 127)
q_dev = torch.round(x.to(dev) / cpu.to(dev)).clamp(-127, 127).cpu()
print("codes x/scale card vs cpu diffs:", int((q_cpu != q_dev).sum()))
