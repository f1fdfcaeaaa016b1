#!/usr/bin/env python3
"""Time the f32 attention-output kernel (K3-f32) of this tree against the
SIMT FFMA design it replaced, beside the classic f32 chain, in one process
on one card; show where a call's time goes; and check that moving the f32
FFN kernels' GEMM into csrc/gemm_tf32x3.cuh left K1-f32's and K2-f32's
results bit for bit as they were.

    mkdir -p build/attn_out_f32_old     # the replaced tree, once
    git archive 4616011 | tar -x -C build/attn_out_f32_old
    python3 build/attn_out_f32_old_vs_new.py [M ...]   # default M: 64 1024 16384

The replaced tree's `csrc/attn_out_ln_f32.cu` (with its `rows_f32.cuh` and
`common.cuh`) and its `csrc/ffn_ln_f32.cu` are compiled by nvcc, each into
a library of its own under `build/attn_out_f32_old_lib/`, and called
through their own C entries; nothing imports that tree. For each M, on the
same inputs (f32 ctx and x, Wo as a `.t()` view of nn.Linear's layout,
vectors at the scales of chip_smoke.py):
- both K3-f32 kernels are held against the plain version with TF32 off
  (max 1e-4, mean 1e-5, the limits of chip_smoke.py);
- CUDA-event device time per call over 20 calls queued behind a spinning
  card, in turns old, new, new, old, and in turns chain, new, new, chain,
  the chain being the classic f32 `F.linear` + add + `F.layer_norm` (three
  calls, TF32 off), beside the bound of chip_smoke.py's `attn_out_bound`;
- where one new call's device time goes (torch.profiler, self time of each
  of its three kernels over 10 calls: the Wo split, the GEMM, the reduce).
K1-f32 and K2-f32 of both trees run at M = 1,024 (the second product split)
and 16,384 (whole) on the same inputs and must give the same bits.
Prints the card's name and power limit, one line per M, and a JSON line of
all readings.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
OLD = ROOT / "build" / "attn_out_f32_old"
OLD_LIB = ROOT / "build" / "attn_out_f32_old_lib"
sys.path.insert(0, str(ROOT))

from multimodal_rare_disease_tpu_torch.kernels import (  # noqa: E402
    attn_out,
    build,
    ffn,
)

MAX_ATOL, MEAN_ATOL = 1e-4, 1e-5
H, FF = 768, 3072
# chip_smoke.py's bound: published H100 SXM peaks at 700 W, the product as
# three TF32 products at the TF32 rate
PEAK_TF32_FLOPS, PEAK_BYTES, TF32_PASSES = 495e12, 3.35e12, 3
# the three kernels of one new call, as torch.profiler names them
STAGES = ("split_weight", "gemm_tf32x3", "split_reduce_f32")


def old_libraries():
    """The replaced tree's K3-f32 and f32 FFN sources, each built by its own
    nvcc (in parallel) into a library with its own C entries."""
    csrc = OLD / "multimodal_rare_disease_tpu_torch" / "csrc"
    if not (csrc / "attn_out_ln_f32.cu").is_file():
        raise SystemExit(f"{csrc} is missing: unpack the replaced tree first "
                         f"(mkdir -p build/attn_out_f32_old && git archive "
                         f"4616011 | tar -x -C build/attn_out_f32_old)")
    OLD_LIB.mkdir(parents=True, exist_ok=True)
    outs = {name: OLD_LIB / f"lib{name}_old.so"
            for name in ("attn_out_ln_f32", "ffn_ln_f32")}
    procs = [subprocess.Popen(
        [build.find_nvcc(), *build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-o", str(out), str(csrc / f"{name}.cu")])
        for name, out in outs.items()]
    if any(p.wait() for p in procs):
        raise SystemExit("nvcc failed on the replaced tree")
    k3, k12 = (ctypes.CDLL(str(outs[n])) for n in outs)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    k3.mrd_attn_out_ln_f32.argtypes = [p] * 7 + [i, f, p]
    k12.mrd_ffn_pre_ln_f32.argtypes = [p] * 11 + [i, i, i, f, p]
    k12.mrd_ffn_ln_f32.argtypes = [p] * 9 + [i, i, i, f, p]
    for fn in (k3.mrd_attn_out_ln_f32, k12.mrd_ffn_pre_ln_f32,
               k12.mrd_ffn_ln_f32):
        fn.restype = i
    return k3, k12


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


def stage_ms(fn, n=10) -> dict:
    """Each kernel's self device time per call of `fn` (torch.profiler,
    n calls), by the names in STAGES; "other" sums the rest."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys((*STAGES, "other"), 0.0)
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        key = next((s for s in STAGES if s in e.key), "other")
        out[key] += e.self_device_time_total / 1e3 / n
    return out


def bound_ms(m: int) -> float:
    """chip_smoke.py's attn_out_bound(m, 768, 4, 4): ctx and x in, y out,
    Wo, three vectors, in f32; 3 TF32 products at the TF32 rate."""
    t_bytes = (3 * 4 * m * H + 4 * H * H + 4 * 3 * H) / PEAK_BYTES * 1e3
    t_ops = TF32_PASSES * 2.0 * m * H * H / PEAK_TF32_FLOPS * 1e3
    return max(t_bytes, t_ops)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    old3, old12 = old_libraries()
    cycles = sleep_cycles_per_ms()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator().manual_seed(3)

    def rnd(shape, scale, offset=0.0):
        return (torch.randn(shape, generator=gen) * scale + offset).to(dev)

    wo = rnd((H, H), 0.05).t()  # a view of nn.Linear's [out, in]
    wot = wo.t()                # [out, in]: no copy
    v3 = dict(bo=rnd((H,), 0.5), gamma=rnd((H,), 0.25, 1.0),
              beta=rnd((H,), 0.5))
    stream = torch.cuda.current_stream(dev).cuda_stream
    print(card)
    readings = {"card": card, "k3_f32": [], "ffn_bits": []}

    # ---- K1-f32 and K2-f32: the same bits as the replaced tree's
    w1, w2 = rnd((FF, H), 0.05).t(), rnd((H, FF), 0.05).t()
    v = dict(b1=rnd((FF,), 0.5), b2=rnd((H,), 0.5),
             gamma=rnd((H,), 0.25, 1.0), beta=rnd((H,), 0.5),
             pre_gamma=rnd((H,), 0.25, 1.0), pre_beta=rnd((H,), 0.5))
    for m in (1024, 16384):
        z = rnd((m, H), 1.0)
        plan = ffn.ffn_plan_f32(m, FF, n_sm)
        scratch = torch.empty(plan.scratch, device=dev)
        for name, input_ln in (("K1-f32", True), ("K2-f32", False)):
            ln0 = ({"pre_gamma": v["pre_gamma"], "pre_beta": v["pre_beta"]}
                   if input_ln else {})
            new = ffn.fused_ffn_ln(z, w1, v["b1"], w2, v["b2"], v["gamma"],
                                   v["beta"], **ln0)
            y_old = torch.empty_like(z)
            ptrs = [t.data_ptr() for t in (z, w1.t(), v["b1"], w2.t(),
                                           v["b2"], v["gamma"], v["beta"])]
            tail = (y_old.data_ptr(), scratch.data_ptr(), m, FF, plan.slices,
                    1e-12, stream)
            err = (old12.mrd_ffn_pre_ln_f32(*ptrs, v["pre_gamma"].data_ptr(),
                                            v["pre_beta"].data_ptr(), *tail)
                   if input_ln else old12.mrd_ffn_ln_f32(*ptrs, *tail))
            torch.cuda.synchronize()
            if err:
                raise RuntimeError(f"old {name}: CUDA error {err}")
            same = torch.equal(new, y_old)
            readings["ffn_bits"].append({"kernel": name, "m": m,
                                         "slices": plan.slices,
                                         "bit_equal": same})
            print(f"{name} M={m} ({plan.slices} slices): this tree's bits "
                  f"{'equal' if same else 'DIFFER FROM'} the replaced tree's",
                  flush=True)
            if not same:
                raise SystemExit(f"{name} at M={m} changed its bits")

    # ---- K3-f32: old against new, the chain beside them
    for m in [int(a) for a in sys.argv[1:]] or [64, 1024, 16384]:
        ctx, x = rnd((m, H), 1.0), rnd((m, H), 1.0)
        args = (ctx, x, wo, v3["bo"], v3["gamma"], v3["beta"])
        y_old = torch.empty_like(ctx)

        def new():
            return attn_out.fused_attn_out_ln(*args)

        def old():
            err = old3.mrd_attn_out_ln_f32(
                ctx.data_ptr(), x.data_ptr(), wot.data_ptr(),
                *(t.data_ptr() for t in v3.values()), y_old.data_ptr(), m,
                1e-12, stream)
            if err:
                raise RuntimeError(f"old K3-f32: CUDA error {err}")
            return y_old

        def chain():
            return F.layer_norm(F.linear(ctx, wot, v3["bo"]) + x, (H,),
                                v3["gamma"], v3["beta"], 1e-12)

        want = attn_out.attn_out_ln_plain(*args)
        errs = {}
        for tag, fn in (("old", old), ("new", new), ("chain", chain)):
            got = fn()
            torch.cuda.synchronize()
            d = (got - want).abs()
            errs[tag] = (d.max().item(), d.mean().item())
            if tag != "chain" and (errs[tag][0] > MAX_ATOL
                                   or errs[tag][1] > MEAN_ATOL):
                raise SystemExit(f"{tag} K3-f32 at M={m} is off the plain "
                                 f"version: {errs[tag]}")
        old_a, new_a = per_call_ms(old, cycles), per_call_ms(new, cycles)
        new_b, old_b = per_call_ms(new, cycles), per_call_ms(old, cycles)
        chain_a, new_c = per_call_ms(chain, cycles), per_call_ms(new, cycles)
        new_d, chain_b = per_call_ms(new, cycles), per_call_ms(chain, cycles)
        stages = stage_ms(new)
        plan = attn_out.attn_out_plan_f32(m, n_sm)
        bound = bound_ms(m)
        r = {"m": m, "old_ms": (old_a + old_b) / 2,
             "new_ms": (new_a + new_b) / 2,
             "runs_old_new_new_old": [old_a, new_a, new_b, old_b],
             "chain_ms": (chain_a + chain_b) / 2,
             "new_ms_beside_chain": (new_c + new_d) / 2,
             "runs_chain_new_new_chain": [chain_a, new_c, new_d, chain_b],
             "bound_ms": bound, "stages_ms": stages,
             "tiles": plan.tiles, "slices": plan.slices,
             "k_tiles": plan.k_tiles, "scratch_mb": plan.scratch * 4 / 1e6,
             "max_abs_err": {k: e[0] for k, e in errs.items()},
             "mean_abs_err": {k: e[1] for k, e in errs.items()}}
        readings["k3_f32"].append(r)
        print(f"K3-f32 M={m}: old {r['old_ms']:.4f} ms, new "
              f"{r['new_ms']:.4f} ms ({r['old_ms'] / r['new_ms']:.2f}x; runs "
              f"{old_a:.4f} {new_a:.4f} {new_b:.4f} {old_b:.4f}); chain "
              f"{r['chain_ms']:.4f} ms against new "
              f"{r['new_ms_beside_chain']:.4f} (runs {chain_a:.4f} "
              f"{new_c:.4f} {new_d:.4f} {chain_b:.4f}); bound {bound:.4f} ms, "
              f"{bound / r['new_ms']:.1%} of it; profiled "
              + ", ".join(f"{k} {t:.4f}" for k, t in stages.items())
              + f" ms; {plan.tiles} row tiles x 6 x {plan.slices} slices of "
              f"{plan.k_tiles} k-tiles, scratch {r['scratch_mb']:.1f} MB; "
              f"max|diff| / mean|diff| from plain "
              + ", ".join(f"{k} {e[0]:.3e} / {e[1]:.3e}"
                          for k, e in errs.items()), flush=True)
    print(json.dumps(readings))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
