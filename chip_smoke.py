#!/usr/bin/env python3
"""Drive the torch package's serving path once on one NVIDIA Hopper card.

    python3 chip_smoke.py          # from the root of a checkout; one card

Phases (each prints one line; any failure raises and exits non-zero):

1. device and toolchain: the card's name and power limit, torch and CUDA
   versions, compute capability 9.0;
2. build: the hand-written CUDA kernels, compiled by nvcc from csrc/ into
   build/kernels/ (seconds taken, registers per thread);
3. K1 (the fused FFN + LayerNorm kernel) against its plain PyTorch version
   on the card, bf16, at M = 1, 37, 4096 and the packed B=256 row count,
   with f32 and with bf16 bias/LayerNorm vectors; and that the check
   fails for a kernel that drops any one of the six vectors;
4. the full-width default model (ResNet-50 224 px, BERT-base 12x768,
   attention fusion, head) from seeded weights in bf16: `predict_batch`
   on 256 (image, clinical text) pairs through the packed path, with K1
   launched once per BERT layer and never bypassed; the same batch with
   the kernel forced off, and with the f32 compute dtype as the reference;
5. serving: the predictor behind the MicroBatcher, 8 concurrent requests
   and 3 single ones, answered with the JSON contract;
6. times: p50 of `predict_batch` at B=256, and K1 against the plain
   version per layer at the packed row count.

Then one JSON line describing each kernel, and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent

# K1 bf16 tolerances. Both versions round x = LN0(z), the GELU chunk and
# y to bf16 from f32 sums taken in another order, so an element may land
# one bf16 ulp apart: 1.6e-2 at |y| in [2, 4), 3.1e-2 in [4, 8). The phase
# 3 inputs keep |y| under 8. Max: the bound of the JAX package's bf16
# kernel test (tests/test_ffn_kernel.py). Mean: such flips are rare; an
# H100 read 3e-7 to 3.3e-6 (PERF.md), and the bound is 1e-4, 1/78 of an
# ulp at |y| in [1, 2). Dropping any one bias or LayerNorm vector moves
# the output by 0.1 or more on average, which phase 3 checks on the card.
K1_ATOL = 5e-2
K1_MEAN_ATOL = 1e-4
# Probabilities. The top-k contract (BASELINE.md) is 1e-3, but bf16's own
# noise is above it for these seeded weights: one ulp of a bf16 logit in
# [2, 4) is 1.6e-2, i.e. up to 3.9e-3 of probability, and sub-ulp order
# differences anywhere flip such roundings from layer to layer. On an
# H100 the kernel read 1.669e-3 from the kernel-off run and 1.95e-3 from
# the f32 model, where the kernel-off run itself reads 1.937e-3 (PERF.md).
# Fixed limits: those readings with about half again of margin.
PROB_ATOL_PLAIN = 2.5e-3
PROB_ATOL_F32 = 3e-3
BATCH = 256
TIMED_RUNS = 10


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    raise SystemExit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def requests(n: int, seed: int):
    """n seeded (uint8 256-px image, clinical text) pairs."""
    import numpy as np

    from multimodal_rare_disease_tpu.config import SYNDROME_NAMES
    from multimodal_rare_disease_tpu.data.clinical_text import (
        ClinicalTextAugmenter,
        _builtin_descriptions,
    )

    rng = np.random.default_rng(seed)
    aug = ClinicalTextAugmenter(_builtin_descriptions(),
                                rng=np.random.default_rng(seed + 1))
    images = list(rng.integers(0, 256, (n, 256, 256, 3), dtype=np.uint8))
    texts = [aug.augment(SYNDROME_NAMES[i % len(SYNDROME_NAMES)],
                         aug.random_level()) for i in range(n)]
    return images, texts


def probs_of(results, class_names):
    import numpy as np

    return np.array([[r["all_probabilities"][c] for c in class_names]
                     for r in results], np.float64)


def run_plain_ffn(pred, images, texts):
    """Probabilities of one batch with K1 forced off (the on-card
    reference of the kernel-off model)."""
    from multimodal_rare_disease_tpu_torch.kernels import ffn as k1

    k1.FORCE_PLAIN = True
    try:
        return probs_of(pred.predict_batch(images, texts), pred.class_names)
    finally:
        k1.FORCE_PLAIN = False


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    sys.path.insert(0, str(HERE))
    try:
        import multimodal_rare_disease_tpu_torch as port
    except ImportError as e:
        fail(f"the torch package is not beside this script: {e}")
    if HERE not in Path(port.__file__).resolve().parents:
        fail(f"the torch package was imported from {port.__file__}, not "
             f"from this checkout")

    from multimodal_rare_disease_tpu.cli.serve import MicroBatcher
    from multimodal_rare_disease_tpu.config import resolve_config
    from multimodal_rare_disease_tpu_torch.inference.predictor import (
        MultimodalPredictor,
    )
    from multimodal_rare_disease_tpu_torch.kernels import build
    from multimodal_rare_disease_tpu_torch.kernels import ffn as k1
    from multimodal_rare_disease_tpu_torch.models.classifier import (
        create_model,
    )

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)

    # ---- 1. device and toolchain
    card = card_line()
    cap = torch.cuda.get_device_capability(dev)
    print(f"[1 device] {card} | torch {torch.__version__} | CUDA "
          f"{torch.version.cuda} | capability {cap} | "
          f"{torch.cuda.device_count()} device(s)")
    if tuple(cap) != (9, 0):
        fail(f"needs compute capability (9, 0), got {cap}")

    # ---- 2. build
    t0 = time.perf_counter()
    lib_path = build.build()
    lib = build.load_library(dev)
    regs = [ln.strip() for ln in
            (lib_path.parent / "ptxas.log").read_text().splitlines()
            if "registers" in ln]
    print(f"[2 build] {lib_path.relative_to(HERE)} in "
          f"{time.perf_counter() - t0:.2f} s (nvcc "
          f"{build.last_build_seconds:.2f} s) | smem/block "
          f"{lib.mrd_ffn_smem_bytes()} B | "
          f"{'; '.join(regs) or 'no ptxas report'}")

    # the serving batch, prepared first so phase 3 tests K1 at its row count
    cfg = resolve_config("default")
    images, texts = requests(BATCH, seed=0)
    t0 = time.perf_counter()
    model = create_model(cfg, device="cpu", seed=0)
    pred = MultimodalPredictor(cfg, model, dev)
    build_s = time.perf_counter() - t0
    ids, mask = pred._prep_texts(texts, BATCH)
    packed = pred._packed_inputs(ids, mask)
    if packed is None:
        fail("packing does not win on the smoke batch")
    rows, cap_tokens = packed[0].shape
    packed_m = rows * cap_tokens

    # ---- 3. K1 against the plain version on the card
    gen = torch.Generator().manual_seed(1)

    def rnd(shape, scale, offset=0.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen) * scale + offset).to(
            dev, dtype)

    h, f = cfg.text_encoder.hidden_size, cfg.text_encoder.intermediate_size
    bf = torch.bfloat16
    w1, w2 = rnd((h, f), 0.05, dtype=bf), rnd((f, h), 0.05, dtype=bf)
    # biases and shifts at the scale of the signal, LayerNorm scales at
    # 1 +- 0.25: every term moves the output well past the tolerances
    vec = dict(b1=rnd((f,), 0.5), b2=rnd((h,), 0.5),
               gamma=rnd((h,), 0.25, 1.0), beta=rnd((h,), 0.5),
               pre_gamma=rnd((h,), 0.25, 1.0), pre_beta=rnd((h,), 0.5))

    def call(fn, z, v):
        return fn(z, w1, v["b1"], w2, v["b2"], v["gamma"], v["beta"],
                  pre_gamma=v["pre_gamma"], pre_beta=v["pre_beta"])

    def ffn(fn, z, v):
        out = call(fn, z, v)
        torch.cuda.synchronize()
        return out.float()

    def diff(got, want):
        d = (got - want).abs()
        return d.max().item(), d.mean().item()

    def within(err):
        return err[0] <= K1_ATOL and err[1] <= K1_MEAN_ATOL

    errs = {}
    for m in (1, 37, 4096, packed_m):
        z = rnd((m, h), 1.0, dtype=bf)
        got = ffn(k1.fused_ffn_ln, z, vec)
        if not torch.isfinite(got).all():
            fail(f"K1 output not finite at M={m}")
        want = ffn(k1.ffn_ln_plain, z, vec)
        errs[f"M={m}"] = diff(got, want)
        if m == 4096:
            z_4k, want_4k = z, want
    # the model's own case: the vectors of a bf16 model are bf16
    vec_bf = {k: v.to(bf) for k, v in vec.items()}
    errs[f"M={packed_m}, bf16 vectors"] = diff(
        ffn(k1.fused_ffn_ln, z, vec_bf), ffn(k1.ffn_ln_plain, z, vec_bf))
    k1_err = max(e[0] for e in errs.values())
    # a kernel that dropped a term: the kernel given the term's neutral
    # value, held against the plain version given the real one
    dropped = {}
    for name, v in vec.items():
        neutral = torch.ones_like(v) if "gamma" in name else torch.zeros_like(v)
        dropped[name] = diff(ffn(k1.fused_ffn_ln, z_4k, {**vec, name: neutral}),
                             want_4k)
    print("[3 K1 vs plain] max|diff| / mean|diff| " + ", ".join(
        f"{k}: {e[0]:.3e} / {e[1]:.3e}" for k, e in errs.items()) +
        f" (bf16, tolerance {K1_ATOL} / {K1_MEAN_ATOL}) | a kernel that "
        f"drops a vector reads, at M=4096: " + ", ".join(
            f"{k} {e[0]:.3e} / {e[1]:.3e}" for k, e in dropped.items()))
    for k, e in errs.items():
        if not within(e):
            fail(f"K1 disagrees with its plain version at {k}: {e}")
    for k, e in dropped.items():
        if within(e):
            fail(f"the K1 check passes a kernel that drops {k}: {e}")

    # ---- 4. the full-width model through the main path
    n_layers = cfg.text_encoder.num_layers
    k1.LAUNCHES = 0
    k1.PLAIN_ON_CUDA = 0
    res = pred.predict_batch(images, texts)
    launches_main, plain_main = k1.LAUNCHES, k1.PLAIN_ON_CUDA
    if pred.packed_calls < 1:
        fail("the batch did not take the packed path")
    if launches_main != n_layers or plain_main != 0:
        fail(f"K1 launches {launches_main} (want {n_layers}), plain on "
             f"CUDA {plain_main} (want 0)")
    probs = probs_of(res, pred.class_names)
    if probs.shape != (BATCH, cfg.num_classes) or not np.isfinite(probs).all():
        fail(f"bad probabilities: shape {probs.shape}")
    if np.abs(probs.sum(1) - 1.0).max() > 1e-3:
        fail("probabilities do not sum to 1")
    probs_plain = run_plain_ffn(pred, images, texts)
    # the f32 reference: the same seeded weights with the f32 compute
    # dtype on the card, FFN in plain f32 (K1 is bf16-only), cuDNN
    # convolutions without TF32
    cfg32 = resolve_config("default", {"training.compute_dtype": "float32"})
    ref = MultimodalPredictor(
        cfg32, create_model(cfg32, device="cpu", seed=0), dev)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        probs_ref = run_plain_ffn(ref, images, texts)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    del ref
    d_kp = float(np.abs(probs - probs_plain).max())
    d_kr = float(np.abs(probs - probs_ref).max())
    d_pr = float(np.abs(probs_plain - probs_ref).max())
    top1 = int((probs.argmax(1) == probs_plain.argmax(1)).sum())
    print(f"[4 model] B={BATCH} packed into {rows}x{cap_tokens} tokens "
          f"(M={packed_m}), classic {ids.shape}; built in {build_s:.1f} s; "
          f"K1 launches {launches_main}/forward, plain-on-CUDA {plain_main};"
          f" max|dprob| kernel vs plain {d_kp:.3e} (tolerance "
          f"{PROB_ATOL_PLAIN}), kernel vs f32 {d_kr:.3e} (tolerance "
          f"{PROB_ATOL_F32}), plain vs f32 {d_pr:.3e}; top-1 kernel = plain "
          f"in {top1}/{BATCH} rows")
    if d_kp > PROB_ATOL_PLAIN:
        fail(f"kernel and plain probabilities differ by {d_kp}")
    if d_kr > PROB_ATOL_F32:
        fail(f"kernel path is {d_kr} from the f32 reference")

    # ---- 5. serving through the MicroBatcher
    k1.LAUNCHES = 0
    k1.PLAIN_ON_CUDA = 0
    classic0 = pred.classic_calls
    batcher = MicroBatcher(pred, window_ms=20.0)
    try:
        s_images, s_texts = requests(11, seed=2)
        with ThreadPoolExecutor(8) as ex:
            futs = [ex.submit(batcher.submit, s_images[i], s_texts[i], 3)
                    for i in range(8)]
            answers = [fu.result(timeout=300) for fu in futs]
        for i in range(8, 11):
            answers.append(batcher.submit(s_images[i], s_texts[i], 3))
        calls = batcher.batch_calls
    finally:
        batcher.close()
    launches_serve, plain_serve = k1.LAUNCHES, k1.PLAIN_ON_CUDA
    for a in answers:
        if set(a) != {"predictions", "top_prediction", "all_probabilities"} \
                or len(a["predictions"]) != 3 \
                or a["top_prediction"] != a["predictions"][0]:
            fail(f"answer breaks the JSON contract: {a}")
    if pred.classic_calls <= classic0:
        fail("single requests did not take the classic path")
    if calls >= len(answers):
        fail(f"{calls} forwards for {len(answers)} requests: no batching")
    if launches_serve != n_layers * calls or plain_serve != 0:
        fail(f"serving: K1 launches {launches_serve} for {calls} forwards")
    print(f"[5 serving] {len(answers)} requests in {calls} forwards, "
          f"K1 launches {launches_serve}, plain-on-CUDA {plain_serve}, "
          f"classic calls {pred.classic_calls - classic0}")

    # ---- 6. times
    for _ in range(2):
        pred.predict_batch(images, texts)
    lat = []
    for _ in range(TIMED_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred.predict_batch(images, texts)  # ends in a device→host copy
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    p50 = float(np.median(lat))

    z = rnd((packed_m, h), 1.0, dtype=bf)

    def per_call_ms(fn, n=20):
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

    # the vectors in bf16, as the model passes them
    def run_kernel():
        return call(k1.fused_ffn_ln, z, vec_bf)

    def run_plain():
        return call(k1.ffn_ln_plain, z, vec_bf)

    plain_a, kern_a = per_call_ms(run_plain), per_call_ms(run_kernel)
    kern_b, plain_b = per_call_ms(run_kernel), per_call_ms(run_plain)
    k1_ms, plain_ms = (kern_a + kern_b) / 2, (plain_a + plain_b) / 2
    print(f"[6 times] {card} | predict_batch B={BATCH} p50 {p50:.2f} ms "
          f"(of {TIMED_RUNS}: {', '.join(f'{x:.1f}' for x in lat)}) | "
          f"K1 at M={packed_m}: {k1_ms:.3f} ms/layer vs plain "
          f"{plain_ms:.3f} ms/layer (runs {plain_a:.3f} {kern_a:.3f} "
          f"{kern_b:.3f} {plain_b:.3f})")

    leaked = sorted(m for m in sys.modules if m.split(".")[0] in
                    ("jax", "jaxlib", "flax", "optax", "orbax"))
    if leaked:
        fail(f"jax modules were imported: {leaked[:5]}")

    print(json.dumps({"kernels": [{
        "name": "ffn_pre_ln_bf16",
        "route": "cuda",
        "source": "multimodal_rare_disease_tpu_torch/csrc/ffn_ln.cu",
        "replaces": "multimodal_rare_disease_tpu/ops/pallas/ffn.py:72",
        "launches": launches_main + launches_serve,
        "max_abs_err": k1_err,
        "ms": k1_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
