#!/usr/bin/env python3
"""Hold redesigned forms of the bf16 FFN kernel (K1 and K2 at the widths
given) or, with --k3, of the bf16 attention-output kernel (K3), or with
--k3f32 of its f32 form (K3-f32), or with --ffnf32 of the f32 FFN (K1-f32
and K2-f32), against an earlier tree, and every other kernel against that
tree's, in one process on one card.

    mkdir -p build/old_4b349d5                   # the earlier tree, once
    git archive 4b349d5 | tar -x -C build/old_4b349d5
    python3 build/pair_old_vs_new.py [--old COMMIT] [--old-dir DIR]
        [--widths H ...] [--rows M ...] [--turns N] [--k3 | --k3f32 | --ffnf32]

Defaults: the tree before the one-block forms' redesign (4b349d5) in
build/old_<commit>, the five one-block widths (128, 256, 384, 512, 640)
and M = 64, 1,024 and 16,384. The cluster-pair forms' redesign was held
to its parent with `--old be933b6 --old-dir build/pair_old --widths 896
1024 1152 1280 1408 1536 --rows 1024 16384`, K3's cluster forms with
`--k3 --old 5b7b4dc --old-dir build/old_5b7b4dc --widths 896 1024 1152
1280 1408 1536 --rows 64 1024 16384`, K3-f32's narrow forms with
`--k3f32 --old 6b702b9 --old-dir build/old_6b702b9 --rows 64 2048 4224
16384 16385`, K3's overlapped forms at 640 and 128 with `--k3 --old
1a815bf --widths 640 128 --rows 64 1024 4096 8448 16384 16385 --turns
4`. `--ffnf32` alone sets the f32 FFN's one-pass form's
comparison: the tree before it (5e786d2) in build/old_5e786d2, widths 128
and 256, M = 64, 1,024, 2,048, 4,224, 8,192, 16,384 and 16,385 (each
overridable). As build/widths_old_vs_new.py,
whose helpers it uses: each tree's package is imported from its own
directory and builds its own kernels there.

- SASS: every kernel function of the earlier tree's library (cuobjdump,
  addresses and constants masked) against the function of the same name
  and template arguments in this tree's, except `ffn_ln_kernel` (with
  --k3, `attn_out_ln_kernel`; with --k3f32 and --ffnf32 none: the new
  passes are functions of their own) at the redesigned widths: identical,
  or the script fails; those are printed, and the functions only this
  tree has. A name that several sources build may lose a copy where
  another copy keeps the same code (with --k3 at 128, split_reduce: the
  one-block form that launched K3's copy is gone).
- Bits: at each M, every kernel outside the redesigned forms on the same
  tensors through both trees' wrappers (K1 with bf16 and f32 vectors, K2
  and K3 at the twelve built widths, K1-f32, K2-f32 and K3-f32 at the
  twelve, K4 on 256 images of 256 x 256): equal bit for bit, or it fails.
- The redesigned forms: K1 (f32 vectors, as the earlier timings took it;
  and bf16 vectors) and K2 (with --k3: K3, beside the classic bf16 chain
  it stands for, `F.linear` + the residual add + `F.layer_norm`, and
  `F.linear` alone, in the same turns; with --k3f32: K3-f32 beside the
  classic f32 chain and `F.linear` in f32; with --ffnf32: K1-f32 and
  K2-f32, and max and mean |new - old|) at each width and M, both
  trees within the limits of their plain version (bf16: 5e-2 max, 1e-4
  mean |diff|, bf16 products with f32 sums; f32 with TF32 off: 1e-4 and
  1e-5); their bits are compared and max |new - old| printed. Device
  time per call (CUDA events over 20 calls queued behind a spinning card)
  in turns old, new, new, old (K3 and K3-f32: old, new, chain, linear,
  then the same in reverse, `--turns` times: short calls read over more
  turns), and new / old.

Prints the card's name and power limit, one line per function and per
reading, and a JSON line of all readings; exits non-zero if any SASS or
bits outside the redesigned forms differ or a redesigned form leaves its
limits.
"""

from __future__ import annotations

import argparse
import importlib
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import torch
import torch.nn.functional as F

import widths_old_vs_new
from h768_old_vs_new import PKG, ROOT, per_call_ms, sleep_cycles_per_ms
from widths_old_vs_new import calls, inputs, sass

OLD_COMMIT = "4b349d5"
REDESIGNED = (128, 256, 384, 512, 640)
# width -> F: every built width, F = 4H but MiniLM's 1,536 and BERT-base's
WIDTHS = {768: 3072, 1024: 4096, 512: 2048, 256: 1024, 128: 512, 384: 1536,
          640: 2560, 896: 3584, 1152: 4608, 1280: 5120, 1408: 5632,
          1536: 6144}
widths_old_vs_new.WIDTHS = WIDTHS  # `inputs` draws F from it
ROW_ATOL, ROW_MEAN_ATOL = 5e-2, 1e-4
F32_ATOL, F32_MEAN_ATOL = 1e-4, 1e-5


def import_tree(root: Path) -> SimpleNamespace:
    """The kernel modules (attn_out, build, ffn, image) of the package
    under `root`, bound to each other and not to this tree's."""
    def own():
        return {k: sys.modules.pop(k) for k in list(sys.modules)
                if k == PKG or k.startswith(PKG + ".")}

    saved = own()
    sys.path.insert(0, str(root))
    try:
        mods = {n: importlib.import_module(f"{PKG}.kernels.{n}")
                for n in ("attn_out", "build", "ffn", "image")}
    finally:
        sys.path.remove(str(root))
        own()
        sys.modules.update(saved)
    return SimpleNamespace(**mods)


def redesigned_form(key: str, widths, k3: bool) -> bool:
    kernel = "attn_out_ln_kernel<{}>" if k3 else "ffn_ln_kernel<{},"
    return any(key.startswith("(anonymous namespace)::" + kernel.format(h))
               for h in widths)


def chain_calls(c, z, wo, vec):
    """The classic bf16 chain K3 stands for, and F.linear alone."""
    h = c.shape[1]
    return {"chain": lambda: F.layer_norm(
                F.linear(c, wo.t(), vec["b2"]) + z, (h,), vec["gamma"],
                vec["beta"], 1e-12),
            "linear": lambda: F.linear(c, wo.t(), vec["b2"])}


def check_k3(trees, by_tree, x, h, m, cyc, readings, bad, key="K3",
             limits=(ROW_ATOL, ROW_MEAN_ATOL), turns=1):
    """K3 (or `key`, K3-f32) of both trees at width h and m rows against
    the plain version, their bits, and their device times in turns (old,
    new, chain, linear, then the same in reverse; `turns` times)."""
    z, c, _, _, wo, vec = x
    new, old = by_tree["new"][key], by_tree["old"][key]
    want = trees["new"].attn_out.attn_out_ln_plain(
        c, z, wo, vec["b2"], vec["gamma"], vec["beta"]).float()
    got = {"new": new().float(), "old": old().float()}
    errs = {n: ((g - want).abs().max().item(), (g - want).abs().mean().item())
            for n, g in got.items()}
    same = torch.equal(got["new"], got["old"])
    apart = (got["new"] - got["old"]).abs().max().item()
    again = torch.equal(got["new"], new().float())
    ok = again and all(e[0] <= limits[0] and e[1] <= limits[1]
                       for e in errs.values())
    fns = {"old": old, "new": new, **chain_calls(c, z, wo, vec)}
    runs = {n: [] for n in fns}
    for n in (list(fns) + list(fns)[::-1]) * turns:
        runs[n].append(per_call_ms(fns[n], cyc))
    ms = {n: sum(v) / len(v) for n, v in runs.items()}
    readings[f"{key} H={h} M={m}"] = dict(
        bit_equal=same, max_new_old=apart, same_bits_twice=again,
        err_new=errs["new"], err_old=errs["old"], ms=ms,
        ratio=ms["new"] / ms["old"], runs=runs)
    print(f"{key} H={h} M={m}: new vs plain {errs['new'][0]:.3e} / "
          f"{errs['new'][1]:.3e} (old {errs['old'][0]:.3e} / "
          f"{errs['old'][1]:.3e}), bit-equal to old {same} (max |new - old| "
          f"{apart:.3e}), same bits twice {again}; dev ms new "
          f"{ms['new']:.4f} old {ms['old']:.4f} (new/old "
          f"{ms['new'] / ms['old']:.4f}); chain {ms['chain']:.4f}, F.linear "
          f"{ms['linear']:.4f} {'ok' if ok else 'OFF'}", flush=True)
    if not ok:
        bad.append(f"{key} H={h} M={m}")


def check_ffn(by_tree, plain, h, m, cyc, readings, bad, limits):
    """Each FFN form of `plain` ({key: its plain call}) through both trees
    at width h and m rows against the plain version (`limits`: max and
    mean |diff|), their bits, max / mean |new - old| and the same bits on a
    second launch, and their device times in turns (old, new, new, old)."""
    for key, want_fn in plain.items():
        new, old = by_tree["new"][key], by_tree["old"][key]
        want = want_fn().float()
        got = {"new": new().float(), "old": old().float()}
        errs = {n: ((g - want).abs().max().item(),
                    (g - want).abs().mean().item()) for n, g in got.items()}
        d = (got["new"] - got["old"]).abs()
        apart = (d.max().item(), d.mean().item())
        same = torch.equal(got["new"], got["old"])
        again = torch.equal(got["new"], new().float())
        ok = again and all(e[0] <= limits[0] and e[1] <= limits[1]
                           for e in errs.values())
        t_old_a, t_new_a = per_call_ms(old, cyc), per_call_ms(new, cyc)
        t_new_b, t_old_b = per_call_ms(new, cyc), per_call_ms(old, cyc)
        t_new, t_old = (t_new_a + t_new_b) / 2, (t_old_a + t_old_b) / 2
        readings[f"{key} H={h} M={m}"] = dict(
            bit_equal=same, max_new_old=apart[0], mean_new_old=apart[1],
            same_bits_twice=again, err_new=errs["new"], err_old=errs["old"],
            new_ms=t_new, old_ms=t_old, ratio=t_new / t_old,
            runs=[t_old_a, t_new_a, t_new_b, t_old_b])
        print(f"{key} H={h} M={m}: new vs plain {errs['new'][0]:.3e} / "
              f"{errs['new'][1]:.3e} (old {errs['old'][0]:.3e} / "
              f"{errs['old'][1]:.3e}), bit-equal to old {same} (max / mean "
              f"|new - old| {apart[0]:.3e} / {apart[1]:.3e}), same bits "
              f"twice {again}; dev ms new {t_new:.4f} old {t_old:.4f} "
              f"(new/old {t_new / t_old:.4f}; runs old {t_old_a:.4f} new "
              f"{t_new_a:.4f} new {t_new_b:.4f} old {t_old_b:.4f}) "
              f"{'ok' if ok else 'OFF'}", flush=True)
        if not ok:
            bad.append(f"{key} H={h} M={m}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", default=OLD_COMMIT, help="the earlier commit")
    ap.add_argument("--old-dir", type=Path,
                    help="its tree (default build/old_<commit>)")
    ap.add_argument("--widths", type=int, nargs="*", default=REDESIGNED,
                    help="the widths whose bf16 FFN forms were redesigned")
    ap.add_argument("--rows", type=int, nargs="*", default=[64, 1024, 16384])
    ap.add_argument("--turns", type=int, default=1,
                    help="K3's and K3-f32's turns of timing (each two runs "
                         "of every call)")
    ap.add_argument("--k3", action="store_true",
                    help="the redesigned forms are K3's (bf16), not K1/K2's")
    ap.add_argument("--k3f32", action="store_true",
                    help="the redesigned forms are K3-f32's")
    ap.add_argument("--ffnf32", action="store_true",
                    help="the redesigned forms are K1-f32's and K2-f32's")
    args = ap.parse_args()
    if args.ffnf32:  # its defaults, where not given
        given = set(sys.argv[1:])
        if "--old" not in given:
            args.old = "5e786d2"
        if "--widths" not in given:
            args.widths = [128, 256]
        if "--rows" not in given:
            args.rows = [64, 1024, 2048, 4224, 8192, 16384, 16385]
    rows, redesigned = args.rows, tuple(args.widths)
    old_root = args.old_dir or ROOT / "build" / f"old_{args.old}"
    if not (old_root / PKG / "kernels" / "ffn.py").is_file():
        raise SystemExit(f"{old_root} is missing: mkdir -p {old_root} "
                         f"&& git archive {args.old} | tar -x -C {old_root}")
    trees = {"new": import_tree(ROOT), "old": import_tree(old_root)}
    with ThreadPoolExecutor(len(trees)) as ex:  # each runs its own nvccs
        list(ex.map(lambda t: t.build.build(), trees.values()))
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    readings, bad = {}, []
    code = {n: sass(t.build.library_path()) for n, t in trees.items()}
    n_same = n_kept = 0
    for k in code["new"].keys() - code["old"].keys():
        print(f"SASS {k}: only in this tree", flush=True)
    for k, old_code in code["old"].items():
        if (k not in code["new"] and k.endswith("'")
                and code["new"].get(k.rstrip("'")) == old_code):
            # one copy fewer of a function that another source still
            # builds the same (with --k3 at 128: split_reduce, whose K3
            # copy left with the one-block form)
            readings[f"SASS {k}"] = "copy removed"
            print(f"SASS {k}: a copy removed, the same code kept",
                  flush=True)
            continue
        if not (args.k3f32 or args.ffnf32) and redesigned_form(
                k, redesigned, args.k3):
            same = code["new"].get(k) == old_code
            readings[f"SASS {k}"] = f"redesigned (identical {same})"
            print(f"SASS {k} (redesigned form): identical {same}", flush=True)
            continue
        same = code["new"].get(k) == old_code
        n_kept += 1
        n_same += same
        readings[f"SASS {k}"] = same
        if not same:
            print(f"SASS {k}: {len(old_code)} instructions (new "
                  f"{len(code['new'].get(k, []))}), identical {same}",
                  flush=True)
            bad.append(f"SASS {k}")
    print(f"SASS outside the redesigned forms: {n_same}/{n_kept} functions "
          f"identical", flush=True)
    log = (trees["new"].build.library_path().parent / "ptxas.log").read_text()
    spills = [ln.strip() for ln in log.splitlines()
              if re.search(r"[1-9]\d* bytes spill (stores|loads)", ln)]
    readings["ptxas spill lines"] = spills
    print(f"ptxas: {len(spills)} lines with spill bytes", flush=True)
    if spills:
        bad.append("ptxas spills")

    # ---- bits of every form outside the redesigned forms
    n_equal = n_forms = 0
    for h in WIDTHS:
        for m in rows:
            for dt in (torch.bfloat16, torch.float32):
                x = inputs(dt, h, m, torch.Generator().manual_seed(h + m), dev)
                by_tree = {n: calls(t, dt, *x) for n, t in trees.items()}
                for k in by_tree["new"]:
                    if h in redesigned and (
                            k == "K3-f32" if args.k3f32 else
                            k in ("K1-f32", "K2-f32") if args.ffnf32 else
                            dt == torch.bfloat16 and (k == "K3") == args.k3):
                        continue
                    same = torch.equal(by_tree["new"][k](),
                                       by_tree["old"][k]())
                    n_forms += 1
                    n_equal += same
                    readings[f"bits {k} H={h} M={m}"] = same
                    if not same:
                        print(f"{k} H={h} M={m}: outputs differ", flush=True)
                        bad.append(f"bits {k} H={h} M={m}")
    u8 = torch.randint(0, 256, (256, 256, 256, 3), dtype=torch.uint8,
                       generator=torch.Generator().manual_seed(4)).to(dev)
    same = torch.equal(trees["new"].image.fused_normalize_u8(u8,
                                                             torch.bfloat16),
                       trees["old"].image.fused_normalize_u8(u8,
                                                             torch.bfloat16))
    n_forms += 1
    n_equal += same
    readings["bits K4"] = same
    if not same:
        bad.append("bits K4")
    print(f"bits outside the redesigned forms: {n_equal}/{n_forms} readings "
          f"equal", flush=True)

    # ---- the redesigned forms: limits against the plain version, bits, times
    cyc = sleep_cycles_per_ms()
    for h in redesigned:
        for m in rows:
            if args.k3f32 or args.ffnf32:
                x = inputs(torch.float32, h, m,
                           torch.Generator().manual_seed(h + m), dev)
                by_tree = {n: calls(t, torch.float32, *x)
                           for n, t in trees.items()}
                if args.ffnf32:
                    z, _, w1, w2, _, vec = x
                    a = (z, w1, vec["b1"], w2, vec["b2"], vec["gamma"],
                         vec["beta"])
                    ln0 = dict(pre_gamma=vec["pre_gamma"],
                               pre_beta=vec["pre_beta"])
                    plain = {"K1-f32": lambda: trees["new"].ffn.ffn_ln_plain(
                                 *a, input_ln=True, **ln0),
                             "K2-f32": lambda: trees["new"].ffn.ffn_ln_plain(
                                 *a, input_ln=False)}
                    check_ffn(by_tree, plain, h, m, cyc, readings, bad,
                              (F32_ATOL, F32_MEAN_ATOL))
                else:
                    check_k3(trees, by_tree, x, h, m, cyc, readings, bad,
                             "K3-f32", (F32_ATOL, F32_MEAN_ATOL), args.turns)
                continue
            x = inputs(torch.bfloat16, h, m,
                       torch.Generator().manual_seed(h + m), dev)
            z, _, w1, w2, _, vec = x
            by_tree = {n: calls(t, torch.bfloat16, *x)
                       for n, t in trees.items()}
            a32 = (z, w1, vec["b1"].float(), w2, vec["b2"].float(),
                   vec["gamma"].float(), vec["beta"].float())
            ln32 = dict(pre_gamma=vec["pre_gamma"].float(),
                        pre_beta=vec["pre_beta"].float())
            a = (z, w1, vec["b1"], w2, vec["b2"], vec["gamma"], vec["beta"])
            if args.k3:
                check_k3(trees, by_tree, x, h, m, cyc, readings, bad,
                         turns=args.turns)
                continue
            plain = {
                "K1": lambda: trees["new"].ffn.ffn_ln_plain(
                    *a, input_ln=True, pre_gamma=vec["pre_gamma"],
                    pre_beta=vec["pre_beta"]),
                "K1 f32 vectors": lambda: trees["new"].ffn.ffn_ln_plain(
                    *a32, input_ln=True, **ln32),
                "K2": lambda: trees["new"].ffn.ffn_ln_plain(
                    *a, input_ln=False)}
            check_ffn(by_tree, plain, h, m, cyc, readings, bad,
                      (ROW_ATOL, ROW_MEAN_ATOL))
    print(json.dumps({"card": card, "old": args.old, "widths": redesigned,
                      "k3": args.k3, "k3f32": args.k3f32,
                      "ffnf32": args.ffnf32,
                      "readings": readings, "off": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
