#!/usr/bin/env python3
"""Time the f32 FFN kernels (K1-f32 and K2-f32) of this tree against the
SIMT FFMA design they replaced, beside the plain version, in one process
on one card.

    mkdir -p build/ffn_f32_old     # the replaced tree, once
    git archive 608eaf6 | tar -x -C build/ffn_f32_old
    python3 build/ffn_f32_old_vs_new.py [M ...]   # default M: 1 64 1024 16384

The replaced `csrc/ffn_ln_f32.cu` (with its `rows_f32.cuh` and
`common.cuh`) is compiled by nvcc from `build/ffn_f32_old` into
`build/ffn_f32_old_lib/` and called through its own C entries, with its own
launch plan (32-row tiles, F split in chunks of 256 when the tiles leave
SMs idle); nothing imports that tree. Both kernels are first held against
the plain version with TF32 off (max 1e-4, mean 1e-5, the limits of
chip_smoke.py), then timed with CUDA events in turns old, new, new, old
(20 calls each, the card spinning first so the calls queue behind it:
device time), and the plain version (two cuBLAS SGEMMs, TF32 off) in turns
with the new kernels, on the same inputs: f32 z, weights as `.t()` views
of nn.Linear's layout, vectors at the scales of chip_smoke.py. Prints the
card's name and power limit, one line per (kernel, M), and a JSON line of
all readings.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
OLD = ROOT / "build" / "ffn_f32_old"
sys.path.insert(0, str(ROOT))

from multimodal_rare_disease_tpu_torch.kernels import build, ffn  # noqa: E402

MAX_ATOL, MEAN_ATOL = 1e-4, 1e-5
OLD_ROWS, OLD_CHUNK = 32, 256  # the replaced kernel's tiling


def old_library() -> ctypes.CDLL:
    src = OLD / "multimodal_rare_disease_tpu_torch" / "csrc" / "ffn_ln_f32.cu"
    if not src.is_file():
        raise SystemExit(f"{src} is missing: unpack the replaced tree first "
                         f"(mkdir -p build/ffn_f32_old && git archive 608eaf6 | "
                         f"tar -x -C build/ffn_f32_old)")
    out = ROOT / "build" / "ffn_f32_old_lib" / "libffn_f32_old.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.find_nvcc(), *build.ARCH_FLAGS, "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", str(out),
                    str(src)], check=True)
    lib = ctypes.CDLL(str(out))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mrd_ffn_pre_ln_f32.argtypes = [p] * 11 + [i, i, i, f, p]
    lib.mrd_ffn_ln_f32.argtypes = [p] * 9 + [i, i, i, f, p]
    lib.mrd_ffn_pre_ln_f32.restype = lib.mrd_ffn_ln_f32.restype = i
    return lib


def sleep_cycles_per_ms() -> float:
    torch.cuda._sleep(1000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    torch.cuda.synchronize()
    return 20_000_000 / start.elapsed_time(end)


def per_call_ms(fn, cycles_per_ms: float, n=20) -> float:
    """CUDA-event time per call over n calls queued behind a spinning
    card, so the events bracket device work only."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # 50 ms: longer than the host takes to issue the n calls
    torch.cuda._sleep(int(50 * cycles_per_ms))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = old_library()
    cycles = sleep_cycles_per_ms()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator().manual_seed(3)

    def rnd(shape, scale, offset=0.0):
        return (torch.randn(shape, generator=gen) * scale + offset).to(dev)

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
        old_slices = ffn.split_slices(-(-m // OLD_ROWS), f // OLD_CHUNK, n_sm)
        old_scratch = torch.empty((old_slices, m, h), device=dev)
        for name, input_ln in (("K1-f32", True), ("K2-f32", False)):
            ln0 = ({"pre_gamma": v["pre_gamma"], "pre_beta": v["pre_beta"]}
                   if input_ln else {})
            args = (z, w1, v["b1"], w2, v["b2"], v["gamma"], v["beta"])

            def new():
                return ffn.fused_ffn_ln(*args, **ln0)

            def plain():
                return ffn.ffn_ln_plain(*args, input_ln=input_ln, **ln0)

            def old():
                ptrs = [t.data_ptr() for t in (z, w1t, v["b1"], w2t, v["b2"],
                                               v["gamma"], v["beta"])]
                tail = (y_old.data_ptr(), old_scratch.data_ptr(), m, f,
                        old_slices, 1e-12, stream)
                if input_ln:
                    err = lib.mrd_ffn_pre_ln_f32(
                        *ptrs, v["pre_gamma"].data_ptr(),
                        v["pre_beta"].data_ptr(), *tail)
                else:
                    err = lib.mrd_ffn_ln_f32(*ptrs, *tail)
                if err:
                    raise RuntimeError(f"old {name}: CUDA error {err}")
                return y_old

            want = plain()
            errs = {}
            for tag, fn in (("old", old), ("new", new)):
                got = fn()
                torch.cuda.synchronize()
                d = (got - want).abs()
                errs[tag] = (d.max().item(), d.mean().item())
                if errs[tag][0] > MAX_ATOL or errs[tag][1] > MEAN_ATOL:
                    raise SystemExit(f"{tag} {name} at M={m} is off the plain "
                                     f"version: {errs[tag]}")
            old_a, new_a = per_call_ms(old, cycles), per_call_ms(new, cycles)
            new_b, old_b = per_call_ms(new, cycles), per_call_ms(old, cycles)
            plain_a, new_c = per_call_ms(plain, cycles), per_call_ms(new, cycles)
            new_d, plain_b = per_call_ms(new, cycles), per_call_ms(plain, cycles)
            plan = ffn.ffn_plan_f32(m, f, n_sm)
            r = {"kernel": name, "m": m, "old_ms": (old_a + old_b) / 2,
                 "new_ms": (new_a + new_b) / 2,
                 "runs_old_new_new_old": [old_a, new_a, new_b, old_b],
                 "plain_ms": (plain_a + plain_b) / 2,
                 "new_ms_beside_plain": (new_c + new_d) / 2,
                 "runs_plain_new_new_plain": [plain_a, new_c, new_d, plain_b],
                 "old_slices": old_slices, "tiles": plan.tiles,
                 "slices": plan.slices,
                 "max_abs_err_old": errs["old"][0],
                 "mean_abs_err_old": errs["old"][1],
                 "max_abs_err_new": errs["new"][0],
                 "mean_abs_err_new": errs["new"][1]}
            readings.append(r)
            print(f"{name} M={m}: old {r['old_ms']:.4f} ms, new "
                  f"{r['new_ms']:.4f} ms ({r['old_ms'] / r['new_ms']:.2f}x; "
                  f"runs {old_a:.4f} {new_a:.4f} {new_b:.4f} {old_b:.4f}); "
                  f"plain {r['plain_ms']:.4f} ms against new "
                  f"{r['new_ms_beside_plain']:.4f} (runs {plain_a:.4f} "
                  f"{new_c:.4f} {new_d:.4f} {plain_b:.4f}); old "
                  f"{-(-m // OLD_ROWS)} tiles x {old_slices} slices, new "
                  f"{plan.tiles} tiles x {plan.slices} slices; max|diff| / "
                  f"mean|diff| from plain old {errs['old'][0]:.3e} / "
                  f"{errs['old'][1]:.3e}, new {errs['new'][0]:.3e} / "
                  f"{errs['new'][1]:.3e}", flush=True)
    print(json.dumps({"card": card, "readings": readings}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
