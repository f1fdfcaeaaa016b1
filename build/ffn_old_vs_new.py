#!/usr/bin/env python3
"""Time the FFN kernel template (K1 and K2) of this tree against the WMMA
design it replaced, in one process on one card.

    git archive 313677c | tar -x -C build/pr2   # the replaced tree, once
    python3 build/ffn_old_vs_new.py [M ...]     # default M: 1 64 1024 16384

The replaced `csrc/ffn_ln.cu` is compiled by nvcc from `build/pr2` into
`build/pr2_ffn/` and called through its own C entries; nothing imports
that tree. Both kernels are first held against the plain version, then
timed with CUDA events in turns old, new, new, old (20 launches each) on
the same inputs: bf16 z, weights as `.t()` views of nn.Linear's layout,
bf16 vectors at the scales of chip_smoke.py. Back-to-back calls at a few
rows are paced by each wrapper's host work, so each kernel's device time
is also read with torch.profiler (its kernels' self time over 10 calls).
Prints the card's name and power limit, one line per (kernel, M), and a
JSON line of all readings.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
OLD = ROOT / "build" / "pr2"
sys.path.insert(0, str(ROOT))

from multimodal_rare_disease_tpu_torch.kernels import build, ffn  # noqa: E402


def old_library() -> ctypes.CDLL:
    src = OLD / "multimodal_rare_disease_tpu_torch" / "csrc" / "ffn_ln.cu"
    if not src.is_file():
        raise SystemExit(f"{src} is missing: unpack the replaced tree first "
                         f"(git archive 313677c | tar -x -C build/pr2)")
    out = ROOT / "build" / "pr2_ffn" / "libffn_old.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.find_nvcc(), *build.ARCH_FLAGS, "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", str(out),
                    str(src)], check=True)
    lib = ctypes.CDLL(str(out))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mrd_ffn_pre_ln_bf16.argtypes = [p] * 10 + [i, i, f, i, p]
    lib.mrd_ffn_ln_bf16.argtypes = [p] * 8 + [i, i, f, p]
    lib.mrd_ffn_pre_ln_bf16.restype = lib.mrd_ffn_ln_bf16.restype = i
    return lib


def per_call_ms(fn, n=20) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def device_ms(fn, n=10) -> float:
    """The device time of one call of `fn`: the self time of every
    kernel it launched, summed, over n calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return us / 1e3 / n


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    lib = old_library()
    gen = torch.Generator().manual_seed(3)

    def rnd(shape, scale, offset=0.0):
        return (torch.randn(shape, generator=gen) * scale + offset).to(
            dev, torch.bfloat16)

    h, f = 768, 3072
    w1, w2 = rnd((f, h), 0.05).t(), rnd((h, f), 0.05).t()
    w1t, w2t = w1.t(), w2.t()  # nn.Linear's [out, in]: no copy
    v = dict(b1=rnd((f,), 0.5), b2=rnd((h,), 0.5), gamma=rnd((h,), 0.25, 1.0),
             beta=rnd((h,), 0.5), pre_gamma=rnd((h,), 0.25, 1.0),
             pre_beta=rnd((h,), 0.5))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows = [int(a) for a in sys.argv[1:]] or [1, 64, 1024, 16384]
    readings = []
    print(card)
    for m in rows:
        z = rnd((m, h), 1.0)
        y_old = torch.empty_like(z)
        for name, input_ln in (("K1", True), ("K2", False)):
            ln0 = ({"pre_gamma": v["pre_gamma"], "pre_beta": v["pre_beta"]}
                   if input_ln else {})
            args = (z, w1, v["b1"], w2, v["b2"], v["gamma"], v["beta"])

            def new():
                return ffn.fused_ffn_ln(*args, **ln0)

            def old():
                ptrs = [t.data_ptr() for t in (z, w1t, v["b1"], w2t, v["b2"],
                                               v["gamma"], v["beta"])]
                if input_ln:
                    err = lib.mrd_ffn_pre_ln_bf16(
                        *ptrs, v["pre_gamma"].data_ptr(),
                        v["pre_beta"].data_ptr(), y_old.data_ptr(), m, f,
                        1e-12, 1, stream)
                else:
                    err = lib.mrd_ffn_ln_bf16(*ptrs, y_old.data_ptr(), m, f,
                                              1e-12, stream)
                if err:
                    raise RuntimeError(f"old {name}: CUDA error {err}")
                return y_old

            want = ffn.ffn_ln_plain(*args, input_ln=input_ln, **ln0).float()
            errs = {}
            for tag, fn in (("old", old), ("new", new)):
                got = fn().float()
                torch.cuda.synchronize()
                d = (got - want).abs()
                errs[tag] = (d.max().item(), d.mean().item())
                if errs[tag][0] > 5e-2 or errs[tag][1] > 1e-4:
                    raise SystemExit(f"{tag} {name} at M={m} is off the plain "
                                     f"version: {errs[tag]}")
            old_a, new_a = per_call_ms(old), per_call_ms(new)
            new_b, old_b = per_call_ms(new), per_call_ms(old)
            plan = ffn.ffn_plan(m, f, torch.cuda.get_device_properties(
                dev).multi_processor_count)
            r = {"kernel": name, "m": m, "old_ms": (old_a + old_b) / 2,
                 "new_ms": (new_a + new_b) / 2,
                 "old_device_ms": device_ms(old), "new_device_ms": device_ms(new),
                 "runs_old_new_new_old": [old_a, new_a, new_b, old_b],
                 "tiles": plan.tiles, "slices": plan.slices,
                 "max_abs_err_old": errs["old"][0],
                 "max_abs_err_new": errs["new"][0]}
            readings.append(r)
            print(f"{name} M={m}: old {r['old_ms']:.4f} ms, new "
                  f"{r['new_ms']:.4f} ms ({r['old_ms'] / r['new_ms']:.2f}x; "
                  f"device time old {r['old_device_ms']:.4f}, new "
                  f"{r['new_device_ms']:.4f} ms; "
                  f"runs {old_a:.4f} {new_a:.4f} {new_b:.4f} {old_b:.4f}; "
                  f"{plan.tiles} tiles x {plan.slices} slices); max|diff| "
                  f"from plain old {errs['old'][0]:.3e}, new "
                  f"{errs['new'][0]:.3e}", flush=True)
    print(json.dumps({"card": card, "readings": readings}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
