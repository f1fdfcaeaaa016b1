#!/usr/bin/env python3
"""Hold the kernels of the widths this tree's parent built (H = 768,
BERT-base; 1,024, BERT-large; 512, 256 and 128, the compact BERTs; 384,
640 and 896, the odd multiples of 128) against that tree, from before the
widths above 1,024 (H = 1,152, 1,280, 1,408, 1,536) were added beside
them, in one process on one card: the same machine code, the same bits and
the same times.

    mkdir -p build/widths_old                    # the earlier tree, once
    git archive aba7f33 | tar -x -C build/widths_old
    python3 build/widths_old_vs_new.py [M ...]   # default M: 1024 16384

As build/h768_old_vs_new.py, whose helpers it uses, at every width: each
tree's package is imported from its own directory and builds its own
kernels there; the SASS of every kernel function of the earlier tree's
library (`cuobjdump -sass`, addresses and constants masked) is compared
with the function of the same name and template arguments in this tree's;
then for each width, M and each of K1 (bf16 vectors and f32 ones), K2,
K3, K1-f32, K2-f32 and K3-f32, on the same tensors, both outputs must be
equal bit for bit and the CUDA-event device time per call over 20 calls
queued behind a spinning card, taken in turns old, new, new, old, must
agree within 3%. Prints the card's name and power limit, one line per
kernel function and per kernel, width and M, and a JSON line of all
readings; exits non-zero if any SASS or output differs or any time is off
by more than 3%.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from h768_old_vs_new import PKG, ROOT, TIME_TOL, import_tree, per_call_ms, \
    sleep_cycles_per_ms

OLD_COMMIT = "aba7f33"
# width -> F of the models the earlier tree served: BERT-base, BERT-large,
# BERT-Medium, -Mini and -Tiny, MiniLM-L12-H384 (F = 1,536), 640 and 896
WIDTHS = {768: 3072, 1024: 4096, 512: 2048, 256: 1024, 128: 512, 384: 1536,
          640: 2560, 896: 3584}


def sass(lib: Path) -> dict:
    """{demangled kernel name with its template arguments, parameters
    dropped: [instructions, addresses and immediates masked]}; a name
    that several sources define gets one entry per copy."""
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
        head = dem
        for args in ("(CUtensorMap", "(float const*", "(__nv_bfloat16 const*"):
            head = head.split(args)[0]
        key = re.sub(r"^void ", "", head)
        while key in out:
            key += "'"
        out[key] = funcs[mangled]
    return out


def inputs(dt, h, m, gen, dev):
    """z, ctx, W1 and W2, Wo and the vectors at width h, drawn from `gen`
    in `dt` on `dev`."""
    f = WIDTHS[h]

    def rnd(shape, scale, offset=0.0, dtype=dt):
        return (torch.randn(shape, generator=gen) * scale + offset).to(
            dev, dtype)

    z, c = rnd((m, h), 1.0), rnd((m, h), 1.0)
    w1, w2 = rnd((f, h), 0.05).t(), rnd((h, f), 0.05).t()
    wo = rnd((h, h), 0.05).t()
    vec = dict(b1=rnd((f,), 0.5), b2=rnd((h,), 0.5),
               gamma=rnd((h,), 0.25, 1.0), beta=rnd((h,), 0.5),
               pre_gamma=rnd((h,), 0.25, 1.0), pre_beta=rnd((h,), 0.5))
    return z, c, w1, w2, wo, vec


def calls(tree, dt, z, c, w1, w2, wo, vec):
    """{kernel: a call of it through `tree`'s wrappers} on `inputs`'
    tensors. Both trees get the same tensors: where each drew its own
    copies of the same values, the copies' places in device memory moved
    some kernels' times by up to 8% with the same machine code (H100)."""
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
    old_root = ROOT / "build" / "widths_old"
    if not (old_root / PKG / "kernels" / "ffn.py").is_file():
        raise SystemExit(f"{old_root} is missing: mkdir -p build/widths_old "
                         f"&& git archive {OLD_COMMIT} | tar -x -C "
                         f"build/widths_old")
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
    for k, old_code in code["old"].items():
        same = code["new"].get(k) == old_code
        readings[f"SASS {k}"] = same
        print(f"SASS {k}: {len(old_code)} instructions (new "
              f"{len(code['new'].get(k, []))}), identical {same}", flush=True)
        if not same:
            bad.append(f"SASS {k}")
    cyc = sleep_cycles_per_ms()
    fns = {}
    for h in WIDTHS:
        for m in rows:
            for dt in (torch.bfloat16, torch.float32):
                x = inputs(dt, h, m, torch.Generator().manual_seed(h + m), dev)
                fns[(h, m, dt)] = {name: calls(t, dt, *x)
                                   for name, t in trees.items()}
    for by_tree in fns.values():  # warm-up: every call of both trees
        for tree_fns in by_tree.values():
            for fn in tree_fns.values():
                for _ in range(3):
                    fn()
    torch.cuda.synchronize()
    for (h, m, dt), by_tree in fns.items():
        for k in by_tree["new"]:
            new, old = by_tree["new"][k], by_tree["old"][k]
            same = torch.equal(new(), old())
            t_old_a, t_new_a = per_call_ms(old, cyc), per_call_ms(new, cyc)
            t_new_b, t_old_b = per_call_ms(new, cyc), per_call_ms(old, cyc)
            t_new, t_old = (t_new_a + t_new_b) / 2, (t_old_a + t_old_b) / 2
            ratio = t_new / t_old
            ok = same and abs(ratio - 1.0) <= TIME_TOL
            readings[f"{k} H={h} M={m}"] = dict(
                bit_equal=same, new_ms=t_new, old_ms=t_old, ratio=ratio,
                runs=[t_old_a, t_new_a, t_new_b, t_old_b])
            print(f"{k} H={h} M={m}: bit-equal {same}; dev ms new "
                  f"{t_new:.4f} old {t_old:.4f} (new/old {ratio:.4f}; runs "
                  f"old {t_old_a:.4f} new {t_new_a:.4f} new {t_new_b:.4f} "
                  f"old {t_old_b:.4f}) {'ok' if ok else 'OFF'}", flush=True)
            if not ok:
                bad.append(f"{k} H={h} M={m}")
    print(json.dumps({"card": card, "readings": readings, "off": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
