#!/usr/bin/env python3
"""Hold the H = 768 (BERT-base) kernels of this tree against the tree
before the kernels became templates over the hidden width (the H = 1,024
forms were added beside them), in one process on one card: the same
machine code, the same bits and the same times.

    mkdir -p build/h768_old                      # the earlier tree, once
    git archive 057b045 | tar -x -C build/h768_old
    python3 build/h768_old_vs_new.py [M ...]     # default M: 1024 16384

Each tree's package is imported from its own directory and builds its own
kernels there (`build/<tree>/build/kernels/`), and every kernel is called
through its tree's own wrapper, as a user calls it. First the SASS of
every kernel function of the earlier tree's library (`cuobjdump -sass`) is
compared with its H = 768 instantiation in this tree's, instruction by
instruction (addresses and constants masked), and printed: a function
that became a template (K3's kernel, the f32 K3's weight split) may be
scheduled otherwise by the compiler with the same math. Then every call
below runs a few times in both trees (warm-up), and for each M and each of
K1 (bf16 vectors, as a bf16 model passes them, and f32 ones), K2, K3,
K1-f32, K2-f32 and K3-f32, on the same inputs (rows and weights drawn as
chip_smoke.py draws them, the weights as `.t()` views of nn.Linear's
layout): both outputs must be equal bit for bit, and the CUDA-event
device time per call over 20 calls queued behind a spinning card, taken in
turns old, new, new, old, must agree within 3%. Prints the card's name
and power limit, one line per kernel function and per kernel and M, and a
JSON line of all readings; exits non-zero if any output differs or any
time is off by more than 3%.
"""

from __future__ import annotations

import importlib
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = "multimodal_rare_disease_tpu_torch"
OLD_COMMIT = "057b045"
H, FF = 768, 3072
TIME_TOL = 0.03


def import_tree(root: Path) -> SimpleNamespace:
    """The kernel modules of the package under `root`. This tree's own
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


def sass(lib: Path) -> dict:
    """{demangled kernel name, with the H = 768 template argument dropped:
    [instructions, addresses and immediates masked]} of a library; a name
    that several sources define (the f32 GEMM) gets one entry per copy."""
    dump = subprocess.run(["cuobjdump", "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    funcs, name = {}, None
    for ln in dump.splitlines():
        m = re.match(r"\s+Function : (\S+)", ln)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?);", ln)
        if m and name:
            funcs[name].append(re.sub(r"0x[0-9a-f]+", "X", m.group(1)))
    names = list(funcs)
    plain = subprocess.run(["c++filt"], input="\n".join(names),
                           capture_output=True, text=True).stdout.splitlines()
    out = {}
    for mangled, dem in zip(names, plain):
        if "1024" in dem:
            continue
        head = dem
        for args in ("(CUtensorMap", "(float const*", "(__nv_bfloat16 const*"):
            head = head.split(args)[0]
        key = re.sub(r"^void |<768>|768, ", "", head)
        while key in out:
            key += "'"
        out[key] = funcs[mangled]
    return out


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
    # 100 ms: longer than the host takes to issue the n calls
    torch.cuda._sleep(int(100 * cycles_per_ms))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def calls(tree, dt, m, gen, dev):
    """{kernel: a call of it through `tree`'s wrappers} on inputs drawn
    from `gen` (the same draws for both trees)."""
    def rnd(shape, scale, offset=0.0, dtype=dt):
        return (torch.randn(shape, generator=gen) * scale + offset).to(
            dev, dtype)

    z, c = rnd((m, H), 1.0), rnd((m, H), 1.0)
    w1, w2 = rnd((FF, H), 0.05).t(), rnd((H, FF), 0.05).t()
    wo = rnd((H, H), 0.05).t()
    vec = dict(b1=rnd((FF,), 0.5), b2=rnd((H,), 0.5),
               gamma=rnd((H,), 0.25, 1.0), beta=rnd((H,), 0.5),
               pre_gamma=rnd((H,), 0.25, 1.0), pre_beta=rnd((H,), 0.5))
    a = (z, w1, vec["b1"], w2, vec["b2"], vec["gamma"], vec["beta"])
    ln0 = dict(pre_gamma=vec["pre_gamma"], pre_beta=vec["pre_beta"])
    a3 = (c, z, wo, vec["b2"], vec["gamma"], vec["beta"])
    ffn, attn_out = tree.ffn.fused_ffn_ln, tree.attn_out.fused_attn_out_ln
    sfx = "" if dt == torch.bfloat16 else "-f32"
    out = {f"K1{sfx}": lambda: ffn(*a, **ln0),
           f"K2{sfx}": lambda: ffn(*a),
           f"K3{sfx}": lambda: attn_out(*a3)}
    if dt == torch.bfloat16:  # K1 also reads f32 vectors
        a32 = (z, w1, *(v.float() for v in a[2:3]), w2,
               *(v.float() for v in a[4:]))
        ln32 = {k: v.float() for k, v in ln0.items()}
        out["K1 f32 vectors"] = lambda: ffn(*a32, **ln32)
    return out


def main() -> int:
    rows = [int(a) for a in sys.argv[1:]] or [1024, 16384]
    old_root = ROOT / "build" / "h768_old"
    if not (old_root / PKG / "kernels" / "ffn.py").is_file():
        raise SystemExit(f"{old_root} is missing: mkdir -p build/h768_old && "
                         f"git archive {OLD_COMMIT} | tar -x -C "
                         f"build/h768_old")
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
    libs = {n: t.build.library_path() for n, t in trees.items()}
    code = {n: sass(lib) for n, lib in libs.items()}
    for k, old_code in code["old"].items():
        same = code["new"].get(k) == old_code
        readings[f"SASS {k}"] = same
        print(f"SASS {k}: {len(old_code)} instructions (new "
              f"{len(code['new'].get(k, []))}), identical {same}", flush=True)
    cyc = sleep_cycles_per_ms()
    fns = {(m, dt): {name: calls(t, dt, m, torch.Generator().manual_seed(m),
                                 dev) for name, t in trees.items()}
           for m in rows for dt in (torch.bfloat16, torch.float32)}
    for by_tree in fns.values():  # warm-up: every call of both trees
        for tree_fns in by_tree.values():
            for fn in tree_fns.values():
                for _ in range(3):
                    fn()
    torch.cuda.synchronize()
    for m in rows:
        for dt in (torch.bfloat16, torch.float32):
            for k in fns[m, dt]["new"]:
                new, old = fns[m, dt]["new"][k], fns[m, dt]["old"][k]
                same = torch.equal(new(), old())
                t_old_a, t_new_a = per_call_ms(old, cyc), per_call_ms(new, cyc)
                t_new_b, t_old_b = per_call_ms(new, cyc), per_call_ms(old, cyc)
                t_new, t_old = (t_new_a + t_new_b) / 2, (t_old_a + t_old_b) / 2
                ratio = t_new / t_old
                ok = same and abs(ratio - 1.0) <= TIME_TOL
                readings[f"{k} M={m}"] = dict(
                    bit_equal=same, new_ms=t_new, old_ms=t_old, ratio=ratio,
                    runs=[t_old_a, t_new_a, t_new_b, t_old_b])
                print(f"{k} M={m}: bit-equal {same}; dev ms new {t_new:.4f} "
                      f"old {t_old:.4f} (new/old {ratio:.4f}; runs old "
                      f"{t_old_a:.4f} new {t_new_a:.4f} new {t_new_b:.4f} "
                      f"old {t_old_b:.4f}) {'ok' if ok else 'OFF'}",
                      flush=True)
                if not ok:
                    bad.append(f"{k} M={m}")
    print(json.dumps({"card": card, "readings": readings, "off": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
