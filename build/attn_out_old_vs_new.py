#!/usr/bin/env python3
"""Time K3, the attention-output + LayerNorm kernel of this tree, against
the WMMA design it replaced and against the TMA-multicast pair that was
tried and not kept, in one process on one card; and check that moving the
FFN kernel's split reduction and tensor maps into csrc/rows.cuh left K1's
and K2's results bit for bit as they were.

    mkdir -p build/pr3 build/pair
    git archive 7ca97e8 | tar -x -C build/pr3    # the replaced design
    git archive 2903563 | tar -x -C build/pair   # this design with the pair
    python3 build/attn_out_old_vs_new.py [M ...]  # default M: 64 16384

Each tree's package is imported from its own directory and builds its own
kernels there (`build/<tree>/build/kernels/`), and every kernel is called
through its tree's own wrapper, as a user calls it. The pair's tree holds
this tree's kernel with a template switch for the pair
(`attn_out.MULTICAST_PAIR`: a cluster of two blocks, each loading half of
every Wo tile into both by `.multicast::cluster`) and with two host
caches that this tree does not keep: tensor maps by address and shape,
and the shared-memory opt-in once per kernel (both trees check the device
once per device). Its wrapper without the pair therefore gives the host
time with those caches beside this tree's without them.

Each kernel is first held against the plain version. Then, on the same
inputs (bf16 ctx and x, Wo as a `.t()` view of nn.Linear's layout, bf16
vectors at the scales of chip_smoke.py), in turns a, b, b, a:
- the time per call over 20 calls, read as chip_smoke.py reads it: device
  time (CUDA events around calls queued while the card spins) and back to
  back (the same events from an idle card, which show the host's pace
  where it is slower than the kernel);
- the device time from torch.profiler (its kernels' self time, 10 calls);
- the host's time to issue one call (100 calls, the card idle before).
Pairs compared: the replaced kernel and this tree's at every M; this tree's and
the cached wrapper at every M; this tree's and the pair on the tiled path.
The host time is also read apart, per call in turns, this tree's against
the pair's tree's: the C entry alone (where the two caches act) and
`load_library` (the device check).
Prints the card's name and power limit, one line per comparison, and a
JSON line of all readings.
"""

from __future__ import annotations

import importlib
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = "multimodal_rare_disease_tpu_torch"
TREES = {"pr3": ("7ca97e8", "the replaced design"),
         "pair": ("2903563", "this design with the multicast pair")}
ATOL, MEAN_ATOL = 5e-2, 1e-4  # chip_smoke.py's ROW_ATOL / ROW_MEAN_ATOL
CYCLES_PER_MS = 0.0  # torch.cuda._sleep's rate, measured in main()


def import_tree(root: Path) -> SimpleNamespace:
    """The kernel modules of the package under `root`. The package's
    entries in sys.modules are set aside while it loads, so its modules
    bind to each other and not to this tree's, and are put back after."""
    def own():
        return {k: sys.modules.pop(k) for k in list(sys.modules)
                if k == PKG or k.startswith(PKG + ".")}

    saved = own()
    sys.path.insert(0, str(root))
    try:
        mods = {n: importlib.import_module(f"{PKG}.kernels.{n}")
                for n in ("attn_out", "build", "ffn")}
    finally:
        sys.path.remove(str(root))
        own()
        sys.modules.update(saved)
    return SimpleNamespace(**mods)


def load_trees() -> dict:
    trees = {"new": import_tree(ROOT)}
    for name, (commit, what) in TREES.items():
        root = ROOT / "build" / name
        if not (root / PKG / "kernels" / "attn_out.py").is_file():
            raise SystemExit(f"{root} does not hold {what}: git archive "
                             f"{commit} | tar -x -C build/{name}")
        trees[name] = import_tree(root)
    with ThreadPoolExecutor(len(trees)) as ex:  # each runs its own nvccs
        list(ex.map(lambda t: t.build.build(), trees.values()))
    return trees


def host_ms(fn, n=100) -> float:
    """The host's time to issue one call of `fn`, the card idle before."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    return t


def events_ms(fn, n, wait=0) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if wait:
        torch.cuda._sleep(wait)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def per_call_ms(fn, n=20):
    """(device, back to back) ms per call of `fn` over n calls, as
    chip_smoke.py reads them: the calls queued while the card spins for
    longer than the host takes to issue them, and from an idle card."""
    b2b = events_ms(fn, n)
    wait = int(3 * host_ms(fn, n) * n * CYCLES_PER_MS) + 100_000
    return events_ms(fn, n, wait), b2b


def sleep_cycles_per_ms() -> float:
    torch.cuda._sleep(1000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    torch.cuda.synchronize()
    return 20_000_000 / start.elapsed_time(end)


def profiled_ms(fn, n=10) -> float:
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


def in_turns(a, b, read):
    """`read` of a and b in turns a, b, b, a: (a's mean, b's mean, runs)."""
    a1, b1 = read(a), read(b)
    b2, a2 = read(b), read(a)
    return (a1 + a2) / 2, (b1 + b2) / 2, [a1, b1, b2, a2]


def compare(tag_a, a, tag_b, b) -> dict:
    """Every reading of a against b, each in turns a, b, b, a."""
    r = {}
    for what, read in (("ms", lambda f: per_call_ms(f)[0]),
                       ("back_to_back_ms", lambda f: per_call_ms(f)[1]),
                       ("host_ms", host_ms)):
        ta, tb, runs = in_turns(a, b, read)
        r[f"{tag_a}_{what}"], r[f"{tag_b}_{what}"] = ta, tb
        r[f"runs_{what}"] = runs
    r[f"{tag_a}_profiled_ms"] = profiled_ms(a)
    r[f"{tag_b}_profiled_ms"] = profiled_ms(b)
    return r


def c_entry(tree, args, plan):
    """The tree's K3 C entry alone, on the wrapper's own arguments."""
    ctx, x, wo, bo, gamma, beta = args
    lib = tree.build.load_library(ctx.device)
    # held by the closure: the kernel writes y and the scratch buffer
    y = torch.empty_like(ctx)
    scratch = (torch.empty(plan.scratch, dtype=torch.float32,
                           device=ctx.device) if plan.scratch else None)
    ptrs = [t.data_ptr() for t in (ctx, x, wo.t(), bo, gamma, beta, y)]
    pair = (0,) if hasattr(tree.attn_out, "MULTICAST_PAIR") else ()
    stream = torch.cuda.current_stream(ctx.device).cuda_stream

    def fn():
        err = lib.mrd_attn_out_ln_bf16(*ptrs, scratch.data_ptr()
                                       if scratch is not None else None,
                                       ctx.shape[0],
                                       plan.slices, *pair, 1e-12, stream)
        if err:
            raise RuntimeError(f"K3 C entry: CUDA error {err}")
    return fn


def line(m, plan, tag_a, tag_b, r) -> str:
    parts = [f"{what} {r[f'{tag_a}_{what}']:.4f} vs {r[f'{tag_b}_{what}']:.4f}"
             f" (runs {' '.join(f'{t:.4f}' for t in r[f'runs_{what}'])})"
             for what in ("ms", "back_to_back_ms", "host_ms")]
    return (f"K3 M={m} ({plan.tiles} tiles x {plan.slices} slices), {tag_a} vs "
            f"{tag_b}: {'; '.join(parts)}; profiled_ms "
            f"{r[f'{tag_a}_profiled_ms']:.4f} vs {r[f'{tag_b}_profiled_ms']:.4f}")


def check(tag, got, want):
    torch.cuda.synchronize()
    d = (got.float() - want.float()).abs()
    err = (d.max().item(), d.mean().item())
    if err[0] > ATOL or err[1] > MEAN_ATOL:
        raise SystemExit(f"{tag} is off the plain version: {err}")
    return err


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    global CYCLES_PER_MS
    CYCLES_PER_MS = sleep_cycles_per_ms()
    t = load_trees()
    new, old, paired = t["new"], t["pr3"], t["pair"]
    gen = torch.Generator().manual_seed(3)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count

    def rnd(shape, scale, offset=0.0):
        return (torch.randn(shape, generator=gen) * scale + offset).to(
            dev, torch.bfloat16)

    h, f = 768, 3072
    print(card)
    readings = {"card": card, "k3": [], "ffn_bits": []}

    # K1 and K2: the same bits from the replaced tree and from this one
    w1, w2 = rnd((f, h), 0.05).t(), rnd((h, f), 0.05).t()
    fv = dict(b1=rnd((f,), 0.5), b2=rnd((h,), 0.5), gamma=rnd((h,), 0.25, 1.0),
              beta=rnd((h,), 0.5))
    ln0 = dict(pre_gamma=rnd((h,), 0.25, 1.0), pre_beta=rnd((h,), 0.5))
    for m in (1, 64, 1024, 16384):
        z = rnd((m, h), 1.0)
        plan = new.ffn.ffn_plan(m, f, n_sm)
        for name, kw in (("K1", ln0), ("K2", {})):
            ys = [tree.ffn.fused_ffn_ln(z, w1, fv["b1"], w2, fv["b2"],
                                        fv["gamma"], fv["beta"], **kw)
                  for tree in (new, old)]
            torch.cuda.synchronize()
            same = torch.equal(*ys)
            readings["ffn_bits"].append({"kernel": name, "m": m,
                                         "slices": plan.slices,
                                         "bit_identical": same})
            print(f"{name} M={m} ({plan.tiles} tiles x {plan.slices} slices): "
                  f"this tree and the replaced one "
                  f"{'bit-identical' if same else 'DIFFER'}",
                  flush=True)
            if not same:
                raise SystemExit(f"{name} at M={m} changed its bits")

    # K3: the replaced kernel, the cached wrapper and the pair against this
    # tree's
    wo = rnd((h, h), 0.05).t()
    v = dict(bo=rnd((h,), 0.5), gamma=rnd((h,), 0.25, 1.0), beta=rnd((h,), 0.5))
    for m in [int(a) for a in sys.argv[1:]] or [64, 16384]:
        args = (rnd((m, h), 1.0), rnd((m, h), 1.0), wo, v["bo"], v["gamma"],
                v["beta"])
        plan = new.attn_out.attn_out_plan(m, n_sm)

        def call(tree, pair=False):
            def fn():
                return tree.attn_out.fused_attn_out_ln(*args)

            def fn_pair():
                tree.attn_out.MULTICAST_PAIR = True
                try:
                    return fn()
                finally:
                    tree.attn_out.MULTICAST_PAIR = False
            return fn_pair if pair else fn

        want = new.attn_out.attn_out_ln_plain(*args)
        r = {"m": m, "tiles": plan.tiles, "slices": plan.slices}
        variants = [("new", call(new)), ("old", call(old)),
                    ("cached", call(paired))]
        if plan.slices == 1:  # the pair runs on the tiled path only
            variants.append(("pair", call(paired, pair=True)))
        for tag, fn in variants:
            r[f"max_abs_err_{tag}"] = check(f"{tag} at M={m}", fn(), want)[0]
        for tag, fn in variants[1:]:
            if tag != "old":
                r[f"{tag}_equals_new"] = torch.equal(fn(), variants[0][1]())
            r[f"new_vs_{tag}"] = compare("new", variants[0][1], tag, fn)
            print(line(m, plan, "new", tag, r[f"new_vs_{tag}"]), flush=True)
        for part, fns in (
                ("c_entry", [c_entry(tr, args, plan) for tr in (new, paired)]),
                ("load_library", [lambda tr=tr: tr.build.load_library(dev)
                                  for tr in (new, paired)])):
            a, b, runs = in_turns(*fns, host_ms)
            r[f"{part}_host_ms"] = {"new": a, "cached": b, "runs": runs}
            print(f"K3 M={m}, host time per call of the {part} alone, new vs "
                  f"cached: {a:.4f} vs {b:.4f} (runs "
                  f"{' '.join(f'{t:.4f}' for t in runs)})", flush=True)
        print(f"K3 M={m}: max|diff| from plain "
              + ", ".join(f"{tag} {r[f'max_abs_err_{tag}']:.3e}"
                          for tag, _ in variants)
              + "; same bits as new: "
              + ", ".join(f"{k[:-len('_equals_new')]} {r[k]}" for k in r
                          if k.endswith("_equals_new")), flush=True)
        readings["k3"].append(r)
    print(json.dumps(readings))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
