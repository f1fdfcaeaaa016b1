#!/usr/bin/env python3
"""Drive the torch package's serving, evaluation, training and data-tool
paths once on one NVIDIA Hopper card.

    python3 chip_smoke.py          # from the root of a checkout; one card

Phases (each prints one line or a few; any failure raises and exits
non-zero):

1. device and toolchain: the card's name and power limit, torch and CUDA
   versions, compute capability 9.0;
2. build: the hand-written CUDA kernels, compiled by nvcc from csrc/ into
   build/kernels/ (seconds taken, registers per thread); it fails when
   ptxas reports spill bytes or a C75xx warning (wgmma serialized,
   setmaxnreg ignored) for any kernel;
3. K1 (the fused FFN + LayerNorm kernel) against its plain PyTorch version
   on the card, bf16, at M = 1, 37, 64, 1024, 4096 and the packed B=256
   row count (the split-F path below 132 row tiles, whole F at the packed
   count), with f32 and with bf16 bias/LayerNorm vectors; and that the
   check fails for a kernel that drops any one of the six vectors;
3b. the same for K2 (the FFN kernel without its input LayerNorm) and K3
   (the fused attention-output + LayerNorm kernel: split-K below 132 row
   tiles, whole K at the packed count), which read bf16 vectors only (f32
   ones go through the counted gate, checked here too),
   and K4 (the fused uint8 normalize) on 256 images of 256 px and on a
   ragged batch, in f32 and bf16;
4. the default path: the full-width model (ResNet-50 224 px, BERT-base
   12x768, attention fusion, head) from seeded weights in bf16:
   `predict_batch` on 256 (image, clinical text) pairs through the packed
   path, with K1 launched once per BERT layer and never bypassed; the
   same batch with the kernel forced off, and with the f32 compute dtype
   as the reference;
5. serving: the predictor behind the MicroBatcher, 8 concurrent requests
   and 3 single ones, answered with the JSON contract;
6. times: p50 of `predict_batch` at B=256, and K1 against the plain
   version per layer at the packed row count, at the 1,024 CLS rows of
   the last layer and at the single request's 64 and 1 rows, each beside
   its bound;
7. the fused-sublayer path: the same model and batch under
   text_encoder.fused_attn_out with images at image_size 256, where every
   layer but the CLS-only last one takes K3 then K2, the last one K1, and
   the images K4; held against every kernel forced off and against the
   f32 model; then once more behind the MicroBatcher;
8. times of that path: p50 of `predict_batch`, and K2, K3 and K4 against
   their plain versions at its shapes, beside each kernel's bound; K3
   also against the classic chain it stands for (bf16 F.linear, the
   residual add and LayerNorm, as BertLayer runs with fused_attn_out
   off) and at a single request's 64 rows (the split-K path), with
   `attn_out_plan`'s tiles x slices per row count; K4 also against the
   one PyTorch call that computes it (addcmul into a bf16 tensor);
9. evaluation and explain: seeded multimodal, image_only and text_only
   models saved as checkpoints and loaded by `load_predictor`; the
   Evaluator over 160 seeded samples (16 per class) in batches of 16,
   with K1 in every BERT layer of a multimodal or text_only batch and
   none for image_only, the multimodal probabilities held against every
   kernel forced off; the metrics of each mode and the statistics across
   them; the Evaluator on the fused-sublayer configuration (K3 11, K2 11,
   K1 1, K4 1 per batch); Grad-CAM of the image_only and multimodal
   models on one image per class (its f32 CAM held against the same
   computation on CPU tensors, and the check shown to fail a flipped
   gradient or a dropped alpha); the BERT attention maps of one clinical
   text at T = 128 on the fused-sublayer configuration (K3 off, K1 in
   all 12 layers), held against the f32 model on the CPU; and the time
   per Evaluator batch, Grad-CAM call and attention-map call;
10. training: the Trainer at full width (bf16 over f32 masters, AdamW)
   on `data/synthetic.py`'s seeded arrays, 4 per class, with their
   class's clinical texts, in the resident mode: `train()` for
   TRAIN_EPOCHS epochs of batch 8, whose train steps launch no kernel
   and whose validation passes launch K1 11 + 1 per batch; the loss on
   the training images in eval mode, which must fall by LOSS_DROP;
   a step fed a NaN parameter on a copy, which the guard
   skips and counts, changing nothing; a bf16 and an f32 step from the
   same weights, and an f32 step on the card against the same step on
   the CPU (TF32 off); one validation pass of the default and of the
   fused-sublayer configuration (K3 11, K2 11, K1 1 per batch); the
   trained checkpoint scored by `load_predictor` and the Evaluator, with
   the kernels-off and the f32 probabilities held to phase 4's limits;
   and ms per train step, ms per validation batch and the peak device
   memory of a step;
11. the efficientnet_clinicalbert preset (EfficientNet-B0 at 224 px,
   BERT-base at max_length 256) from seeded weights in bf16:
   `predict_batch` on phase 4's 256 pairs with K1 in every BERT layer,
   held against every kernel forced off and against the f32 model at
   phase 4's limits, and its p50; its Trainer on phase 10's corpus for
   PRESET_EPOCHS epochs with random erasing and Gaussian blur on (train
   steps launch nothing, a validation batch K1 11 times at 16 x 256 rows
   and once at the 16 CLS rows; the frozen stem, stages 1-3 and BERT
   layers 0-5 bit-equal, every other parameter moved; the blur and
   erasing selections fired on their probabilities' share of the
   images; an f32 SGD step on the card against the CPU), ms per train
   step, per validation batch and the peak memory of a step; every
   augmentation extra (blur, noise, erasing, coarse dropout,
   perspective, tiled and global CLAHE, elastic, the gather geometry)
   applied at one set of draws to the 256 images on the card and on the
   CPU in f32, with its time; the preset under pre-LN, which launches no
   kernel, held against its f32 model; and `cli/train.py --mode
   text_only --data fgdd` on a seeded FGDD table for FGDD_EPOCHS epochs
   at full width, K1 12 per validation batch;
12. face detection and the setup tools: MTCNN from an npz of seeded
   weights on the card over 256 seeded 256-px images (data/synthetic.py),
   its nets held against the CPU's on the inputs the card gave them, its
   boxes against the same detector on the CPU over FACE_CPU_IMAGES (flips
   counted), no detector failure, and the heuristic detector on the same
   images; the face crops (staged by the numpy copy of PIL's bilinear)
   through `predict_batch` at B=256 on the full-width default model, K1
   11 times at the packed rows and once at the CLS rows, held against
   every kernel forced off and the f32 model at phase 4's limits, and its
   p50; one validation pass of a `DataPipeline` with use_face_detection
   on phase 10's decoded corpus; torchvision ResNet-50 and HF BERT-base
   files of seeded tensors (built from their key lists) through
   `cli/convert_weights.py --device cuda` and `load_predictor`, a B=256
   predict with K1 12 held against the same checkpoint in f32 on the
   CPU; `cli/verify_setup.py --full --device cuda` in-process (all seven
   steps, K1 12); the conv VAE trained for 400 epochs on 50 seeded 64-px
   images (the loss falls; ms per epoch), one f32 step on the card
   against the CPU, generation at 256 px; and `utils/profiling.py`'s
   trace around one predict call and its peak memory.

Kernel times are CUDA-event times of 20 calls back to back, read two
ways: queued while the card spins (torch.cuda._sleep), so that the events
bracket device work only, and issued from an idle card, so that the events
also show where the host's pace sets the time ("back to back"). Phase 8
prints K3's host time per call beside them.

Then the card's name and power limit, one JSON line describing each
kernel, and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from functools import partial
from pathlib import Path

HERE = Path(__file__).resolve().parent

# K1-K3 bf16 tolerances. Both versions round the kernel's bf16
# intermediates and y from f32 sums taken in another order, so an element
# may land one bf16 ulp apart: 1.6e-2 at |y| in [2, 4), 3.1e-2 in [4, 8).
# The phase 3 inputs keep |y| under 8. Max: the bound of the JAX package's
# bf16 kernel tests (tests/test_ffn_kernel.py, test_attn_out_kernel.py).
# Mean: such flips are rare; an H100 read 3e-7 to 3.3e-6 for K1 (PERF.md),
# and the bound is 1e-4, 1/78 of an ulp at |y| in [1, 2). Dropping any one
# bias, LayerNorm vector or the residual moves the output by 0.1 or more
# on average, which phases 3 and 3b check on the card.
ROW_ATOL = 5e-2
ROW_MEAN_ATOL = 1e-4
# K4: the kernel rounds the product and the sum to f32 as the plain
# version does. f32: equal up to one rounding (the JAX package's compiled
# vs XLA bound, tests/test_tpu_kernels.py); bf16: one ulp at |y| < 4
# (the outputs lie in [-2.2, 2.7]); such flips are rare, so the mean is
# held to 1e-4 as well.
K4_ATOL = {"float32": 1e-5, "bfloat16": 1.6e-2}
K4_MEAN_ATOL = 1e-4
# Probabilities. The top-k contract (BASELINE.md) is 1e-3, but bf16's own
# noise is above it for these seeded weights: one ulp of a bf16 logit in
# [2, 4) is 1.6e-2, i.e. up to 3.9e-3 of probability, and sub-ulp order
# differences anywhere flip such roundings from layer to layer. On an
# H100 the kernel read 1.669e-3 from the kernel-off run and 1.95e-3 from
# the f32 model, where the kernel-off run itself reads 1.937e-3 (PERF.md).
# Fixed limits: those readings with about half again of margin. Phase 7
# holds the fused-sublayer path to the same limits.
PROB_ATOL_PLAIN = 2.5e-3
PROB_ATOL_F32 = 3e-3
BATCH = 256
TIMED_RUNS = 10
# phase 3's row counts besides the packed one: the single request (1, then
# its length bucket 64), a ragged tile, the CLS-only last layer at B=256
# and a mid size
PHASE3_ROWS = (1, 37, 64, 1024, 4096)
# phase 6's extra K1 row counts: the CLS-only last layer, the single request
SMALL_ROWS = (1024, 64, 1)
# published H100 SXM peaks at 700 W (NVIDIA's data sheet): dense bf16
# tensor-core rate, f32 rate outside the tensor cores, HBM3 rate
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    raise SystemExit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_faults(log: str) -> list:
    """The lines of the compilers' report (-Xptxas=-v) that show spill
    bytes or a C75xx warning (wgmma serialized, setmaxnreg ignored), each
    with the function it was reported for: the traps of the wgmma
    kernels."""
    faults, fn = [], "?"
    for ln in log.splitlines():
        name = re.search(r"(?:entry function|Function properties for) '?([\w$]+)", ln)
        if name:
            fn = name.group(1)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if (spill and spill.group(1) + spill.group(2) != "00") \
                or re.search(r"\bC75\d\d\b", ln):
            faults.append(f"{fn}: {ln.strip()}")
    return faults


def probs_of(results, class_names):
    import numpy as np

    return np.array([[r["all_probabilities"][c] for c in class_names]
                     for r in results], np.float64)


def kernel_modules():
    from multimodal_rare_disease_tpu_torch.kernels import attn_out, ffn, image

    return ffn, attn_out, image


@contextmanager
def plain_kernels():
    """Every kernel forced off: the on-card reference of the kernel-off
    model."""
    mods = kernel_modules()
    for mod in mods:
        mod.FORCE_PLAIN = True
    try:
        yield
    finally:
        for mod in mods:
            mod.FORCE_PLAIN = False


def launch_counts():
    """(K1, K2, K3, K4 launches, calls the gates sent to plain on CUDA)."""
    ffn, attn_out, image = kernel_modules()
    return {"K1": ffn.LAUNCHES_K1, "K2": ffn.LAUNCHES_K2,
            "K3": attn_out.LAUNCHES, "K4": image.LAUNCHES,
            "plain_on_cuda": (ffn.PLAIN_ON_CUDA + attn_out.PLAIN_ON_CUDA
                              + image.PLAIN_ON_CUDA)}


def reset_counts():
    ffn, attn_out, image = kernel_modules()
    ffn.LAUNCHES_K1 = ffn.LAUNCHES_K2 = ffn.PLAIN_ON_CUDA = 0
    attn_out.LAUNCHES = attn_out.PLAIN_ON_CUDA = 0
    image.LAUNCHES = image.PLAIN_ON_CUDA = 0


def bound_ms(bytes_moved: float, ops: float, peak_ops: float):
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over their peak rate."""
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = ops / peak_ops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def ffn_bound(m: int, h: int, f: int, vec_bytes: int, input_ln: bool):
    """K1/K2: x in and y out [m, h] bf16, W1 and W2 bf16, the vectors;
    the two products in bf16 on the tensor cores (the f32 GELU and
    LayerNorm work, under 5% of it, is left out)."""
    n_vec = f + (5 if input_ln else 3) * h
    return bound_ms(2 * 2 * m * h + 2 * 2 * h * f + vec_bytes * n_vec,
                    4.0 * m * h * f, PEAK_BF16_FLOPS)


def attn_out_bound(m: int, h: int, vec_bytes: int):
    """K3: ctx and x in, y out [m, h] bf16, Wo bf16, three vectors; the
    product in bf16 on the tensor cores."""
    return bound_ms(3 * 2 * m * h + 2 * h * h + vec_bytes * 3 * h,
                    2.0 * m * h * h, PEAK_BF16_FLOPS)


def normalize_bound(n: int, out_bytes: int):
    """K4: n uint8 in, n outputs; a multiply and an add in f32 each."""
    return bound_ms(n * (1 + out_bytes), 2.0 * n, PEAK_F32_FLOPS)


def count_launches(fn, want, what, totals):
    """fn() with the counts set to 0 just before and read just after;
    fails unless they are `want`, and adds them to `totals`."""
    import torch

    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    got = launch_counts()
    if got != want:
        fail(f"{what}: launches {got}, want {want}")
    for k, v in got.items():
        totals[k] += v
    return out


# phase 9: the evaluation set (16 per class), the Grad-CAM images (one
# per class), the images held against the CPU in f32, timed repeats
EVAL_PER_CLASS = 16
CAM_F32_IMAGES = 2
PHASE9_RUNS = 5
# Grad-CAM in f32 on the card against the same computation on CPU
# tensors: a [0, 1] map (min-max normalized) from the same f32 model,
# where cuDNN's and the CPU's convolutions sum in other orders through
# ResNet-50; a flipped gradient or a dropped alpha moves it by 0.1 or
# more, which the phase checks too
CAM_F32_ATOL = 1e-3
# Grad-CAM's tail against the Evaluator's forward on the same images, in
# bf16: the same model, reduced in another order and batch (log
# probabilities)
GRADCAM_LOGPROB_ATOL = 0.1
# attention rows: the f32 softmax of the bf16 model's scores
ATTN_ROW_ATOL = 1e-3
# the CLS row's token weights (head-averaged, renormalized; about 1/n
# each) of the bf16 model on the card against the f32 model on the CPU
TOKEN_WEIGHT_ATOL = 1e-3


def evaluation_and_explain(dev, card: str, fused_over: dict):
    """Phase 9: the Evaluator over the three modes' checkpoints (and the
    fused-sublayer configuration), the statistics across them, Grad-CAM
    and the BERT attention maps, each with its launch counts; returns
    the launches of its counted runs."""
    import copy
    import tempfile

    import numpy as np
    import torch

    from multimodal_rare_disease_tpu_torch.config import (
        SYNDROME_NAMES,
        resolve_config,
    )
    from multimodal_rare_disease_tpu_torch.evaluation import (
        Evaluator,
        compare_multimodal_vs_unimodal,
        compute_metrics,
    )
    from multimodal_rare_disease_tpu_torch.explain import (
        GradCAM,
        cam_from_gradients,
        text_token_attention,
    )
    from multimodal_rare_disease_tpu_torch.inference.predictor import (
        load_predictor,
    )
    from multimodal_rare_disease_tpu_torch.models.classifier import (
        create_model,
    )
    from multimodal_rare_disease_tpu_torch.train.pipeline import (
        build_text_pool,
    )
    from multimodal_rare_disease_tpu_torch.utils.checkpoint import (
        save_checkpoint,
    )

    cfg = resolve_config("default")
    n_layers = cfg.text_encoder.num_layers
    totals = dict.fromkeys(("K1", "K2", "K3", "K4", "plain_on_cuda"), 0)

    counted = partial(count_launches, totals=totals)

    def per_batch(k1=0, k2=0, k3=0, k4=0, batches=1):
        return {"K1": k1 * batches, "K2": k2 * batches, "K3": k3 * batches,
                "K4": k4 * batches, "plain_on_cuda": 0}

    def timed_ms(fn):
        fn()
        lat = []
        for _ in range(PHASE9_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(lat))

    # the evaluation set: 16 seeded uint8 images per class at the 256-px
    # staging size, each with its class's clinical description from the
    # text pool (the val texts of the data pipeline)
    rng = np.random.default_rng(9)
    n = EVAL_PER_CLASS * len(SYNDROME_NAMES)
    labels = rng.permutation(np.repeat(np.arange(len(SYNDROME_NAMES)),
                                       EVAL_PER_CLASS))
    images = rng.integers(0, 256, (n, 256, 256, 3), dtype=np.uint8)
    b = cfg.evaluation.eval_batch_size
    n_batches = -(-n // b)

    (HERE / "build").mkdir(exist_ok=True)  # git-ignored, in the checkout
    with tempfile.TemporaryDirectory(dir=HERE / "build") as tmp:
        # seeded weights saved as port checkpoints, loaded back through
        # the predictor's loader onto the card in bf16
        predictors = {}
        for mode in ("multimodal", "image_only", "text_only"):
            path = Path(tmp) / mode
            save_checkpoint(path, create_model(cfg, mode=mode, device="cpu",
                                               seed=0).state_dict(),
                            meta={"config": cfg.to_dict(), "mode": mode})
            predictors[mode] = load_predictor(path, dev)
    tok = predictors["multimodal"].tokenizer
    pool = build_text_pool(cfg, tok, np.random.default_rng(10))
    zeros = np.zeros(n, np.int64)
    ids, mask = pool.gather(labels, zeros, zeros)
    batches = [{"images": images[i:i + b], "labels": labels[i:i + b],
                "valid": np.ones(len(labels[i:i + b]), np.float32),
                "input_ids": ids[i:i + b], "attention_mask": mask[i:i + b]}
               for i in range(0, n, b)]

    # ---- the Evaluator over the three modes: K1 in every BERT layer of
    # a multimodal or text_only batch, none for image_only
    collected, metrics, eval_ms = {}, {}, {}
    for mode, p in predictors.items():
        ev = Evaluator(cfg, p.model, mode=mode)
        want = per_batch(k1=n_layers if mode != "image_only" else 0,
                         batches=n_batches)
        collected[mode] = counted(lambda: ev.collect_predictions(batches),
                                  want, f"Evaluator ({mode})")
        c = collected[mode]
        if c["probabilities"].shape != (n, cfg.num_classes) \
                or not np.isfinite(c["probabilities"]).all() \
                or np.abs(c["probabilities"].sum(1) - 1).max() > 1e-3 \
                or not np.array_equal(c["labels"], labels):
            fail(f"Evaluator ({mode}): bad predictions")
        metrics[mode] = compute_metrics(c)
        m = metrics[mode]
        if abs(m["accuracy"] - float(np.mean(c["predictions"] == labels))) \
                > 1e-12 or np.sum(m["confusion_matrix"]) != n \
                or "roc_auc_ovr" not in m:
            fail(f"compute_metrics ({mode}) is inconsistent: {m}")
        eval_ms[mode] = timed_ms(
            lambda: ev.collect_predictions(batches)) / n_batches
    ev_mm = Evaluator(cfg, predictors["multimodal"].model)
    with plain_kernels():
        plain = ev_mm.collect_predictions(batches)["probabilities"]
    d_plain = float(np.abs(collected["multimodal"]["probabilities"]
                           - plain).max())
    if d_plain > PROB_ATOL_PLAIN:
        fail(f"Evaluator: kernel and plain probabilities differ by "
             f"{d_plain}")
    stats = compare_multimodal_vs_unimodal(
        {m: c["predictions"] for m, c in collected.items()}, labels)
    if set(stats) != {"pairwise", "confidence_intervals", "summary"} \
            or len(stats["pairwise"]) != 3:
        fail(f"compare_multimodal_vs_unimodal: {list(stats)}")

    # ---- the fused-sublayer configuration: K3 -> K2 in layers 0..10, K1
    # in the CLS-only last layer, K4 for images staged at image_size
    cfg_f = resolve_config("default", fused_over)
    model_f = create_model(cfg_f, device="cpu", seed=0).to(dev,
                                                           torch.bfloat16)
    ev_f = Evaluator(cfg_f, model_f)
    fused = counted(lambda: ev_f.collect_predictions(batches),
                    per_batch(1, n_layers - 1, n_layers - 1, 1, n_batches),
                    "Evaluator (fused sublayers)")
    with plain_kernels():
        plain_f = ev_f.collect_predictions(batches)["probabilities"]
    d_plain_f = float(np.abs(fused["probabilities"] - plain_f).max())
    if d_plain_f > PROB_ATOL_PLAIN:
        fail(f"fused Evaluator: kernel and plain probabilities differ by "
             f"{d_plain_f}")
    eval_ms["fused"] = timed_ms(
        lambda: ev_f.collect_predictions(batches)) / n_batches
    print(f"[9 evaluation] {n} samples ({EVAL_PER_CLASS} per class) in "
          f"{n_batches} batches of {b}, T={ids.shape[1]}, from checkpoints "
          f"loaded by load_predictor | launches per batch: multimodal and "
          f"text_only K1 {n_layers}, image_only none, fused K3 "
          f"{n_layers - 1} / K2 {n_layers - 1} / K1 1 / K4 1 | accuracy "
          + ", ".join(f"{k} {v['accuracy']:.4f} (macro F1 "
                      f"{v['f1_macro']:.4f}, ROC-AUC {v['roc_auc_ovr']:.4f})"
                      for k, v in metrics.items())
          + f" | McNemar p: " + ", ".join(
              f"{k} {v['mcnemar']['p_value']:.4f}"
              for k, v in stats["pairwise"].items())
          + f" | max|dprob| kernels vs plain: multimodal {d_plain:.3e}, "
          f"fused {d_plain_f:.3e} (tolerance {PROB_ATOL_PLAIN})")

    # ---- Grad-CAM on one image per class
    first = [int(np.flatnonzero(labels == c)[0])
             for c in range(len(SYNDROME_NAMES))]
    cam_imgs, cam_ids, cam_mask = images[first], ids[first], mask[first]
    cam_ms, cam_lines = {}, []
    for mode, k1 in (("image_only", 0), ("multimodal", n_layers)):
        p = predictors[mode]
        gc = GradCAM(cfg, p.model, mode=mode)
        cam_text = (cam_ids, cam_mask) if mode == "multimodal" else ()
        cam, logits = counted(lambda: gc(cam_imgs, *cam_text),
                              per_batch(k1=k1), f"Grad-CAM ({mode})")
        if cam.shape != (len(first), 7, 7) or not np.isfinite(cam).all() \
                or cam.min() < 0 or cam.max() > 1:
            fail(f"Grad-CAM ({mode}): CAM {cam.shape}, range "
                 f"[{cam.min()}, {cam.max()}]")
        # the default target is the class of the logits it returns
        target = logits.argmax(1)
        cam_t, _ = gc(cam_imgs, *cam_text, class_idx=target)
        d_target = float(np.abs(cam - cam_t).max())
        if d_target > 1e-3:
            fail(f"Grad-CAM ({mode}): the CAM of argmax(logits) differs by "
                 f"{d_target} from the default one")
        # and its tail computes the Evaluator's model: the same log
        # probabilities up to bf16 noise, the same class wherever the
        # forward's top-2 margin exceeds twice that noise
        lp_fwd = np.log(collected[mode]["probabilities"][first])
        z = logits - logits.max(1, keepdims=True)
        lp_cam = z - np.log(np.exp(z).sum(1, keepdims=True))
        d_lp = float(np.abs(lp_fwd - lp_cam).max())
        top2 = np.sort(lp_fwd, 1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > 2 * d_lp
        if d_lp > GRADCAM_LOGPROB_ATOL or not np.array_equal(
                target[sure], lp_fwd.argmax(1)[sure]):
            fail(f"Grad-CAM ({mode}): log-probabilities {d_lp} from the "
                 f"Evaluator's; classes {target} vs {lp_fwd.argmax(1)}")
        cam_ms[mode] = timed_ms(lambda: gc(cam_imgs, *cam_text))
        # f32 on the card against the same computation on CPU tensors
        cpu32 = create_model(cfg, mode=mode, device="cpu", seed=0)
        card32 = copy.deepcopy(cpu32).to(dev)
        cfg32 = resolve_config("default", {"training.compute_dtype":
                                           "float32"})
        text32 = tuple(a[:CAM_F32_IMAGES] for a in cam_text)
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            cam32, _ = GradCAM(cfg32, card32, mode=mode)(
                cam_imgs[:CAM_F32_IMAGES], *text32)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        fmap, grad, _ = GradCAM(cfg32, cpu32, mode=mode).gradients(
            cam_imgs[:CAM_F32_IMAGES], *text32)
        d32 = float(np.abs(cam32 - cam_from_gradients(fmap, grad)
                           .numpy()).max())
        faults = {"flipped gradient": cam_from_gradients(fmap, -grad),
                  "dropped alpha": cam_from_gradients(
                      fmap, torch.ones_like(grad))}
        d_faults = {k: float(np.abs(cam32 - v.numpy()).max())
                    for k, v in faults.items()}
        if d32 > CAM_F32_ATOL:
            fail(f"Grad-CAM ({mode}) in f32: card vs CPU {d32}")
        if min(d_faults.values()) <= CAM_F32_ATOL:
            fail(f"the Grad-CAM check passes a fault: {d_faults}")
        del cpu32, card32
        cam_lines.append(
            f"{mode}: CAM {list(cam.shape)} in [{cam.min():.3f}, "
            f"{cam.max():.3f}]; log-probabilities {d_lp:.3e} from the "
            f"Evaluator's (tolerance {GRADCAM_LOGPROB_ATOL}), the same "
            f"class in {int(sure.sum())} of {len(first)} rows with a "
            f"margin above twice that; f32 card vs CPU "
            f"max|diff| {d32:.3e} (tolerance {CAM_F32_ATOL}; "
            + ", ".join(f"{k} {v:.3f}" for k, v in d_faults.items())
            + ")")
    print(f"[9 Grad-CAM] {len(first)} images, stage4, launches K1 "
          f"{n_layers} per multimodal call (the text tower, no grad), "
          f"none for image_only | " + " | ".join(cam_lines))

    # ---- the BERT attention maps on the fused configuration: K3 off, K1
    # in all 12 layers, every position computed
    text = ("Patient presents with synophrys, long eyelashes, a thin upper "
            "lip and small hands; growth retardation and intellectual "
            "disability were noted at the genetics clinic.")
    t_ids, t_mask, _ = tok.encode(text, cfg.data.max_text_length)
    t_ids = torch.from_numpy(np.asarray(t_ids)).long()[None].to(dev)
    t_mask = torch.from_numpy(np.asarray(t_mask)).long()[None].to(dev)

    def attentions():
        with torch.inference_mode():
            return model_f.text_attentions(t_ids, t_mask)

    attns = counted(attentions, per_batch(k1=n_layers),
                    "text_attentions (fused sublayers)")
    t = cfg.data.max_text_length
    if len(attns) != n_layers or attns[0].shape != (
            1, cfg.text_encoder.num_heads, t, t):
        fail(f"text_attentions: {len(attns)} maps of {attns[0].shape}")
    row_err = float((torch.stack(attns).float().sum(-1) - 1).abs().max())
    if row_err > ATTN_ROW_ATOL:
        fail(f"attention rows sum to 1 within {row_err}")
    got = text_token_attention(cfg_f, model_f, tok, text)
    want = text_token_attention(
        cfg, create_model(cfg, device="cpu", seed=0), tok, text)
    if [w[0] for w in got] != [w[0] for w in want]:
        fail("text_token_attention: the tokens differ from the CPU's")
    d_tok = float(np.abs(np.array([w[1] for w in got])
                         - np.array([w[1] for w in want])).max())
    if d_tok > TOKEN_WEIGHT_ATOL:
        fail(f"CLS-row token weights differ from the f32 CPU ones by {d_tok}")
    attn_ms = timed_ms(attentions)
    print(f"[9 attention maps] fused sublayers, T={t}: {n_layers} maps of "
          f"{list(attns[0].shape)}, launches K3 0 / K1 {n_layers}; rows sum "
          f"to 1 within {row_err:.2e} (tolerance {ATTN_ROW_ATOL}); CLS-row "
          f"token weights of {len(got)} tokens vs f32 on the CPU max|diff| "
          f"{d_tok:.3e} (tolerance {TOKEN_WEIGHT_ATOL})")
    print(f"[9 times] {card} | Evaluator ms per batch of {b}: "
          + ", ".join(f"{k} {v:.2f}" for k, v in eval_ms.items())
          + f" | Grad-CAM ms per call of {len(first)} images: "
          + ", ".join(f"{k} {v:.2f}" for k, v in cam_ms.items())
          + f" | text_attentions ms per call (T={t}, fused sublayers): "
          f"{attn_ms:.2f} | median of {PHASE9_RUNS}, host clock, "
          f"synchronized")
    return totals


# phase 10: the synthetic corpus (per class), the run, its checks
TRAIN_PER_CLASS = 4
TRAIN_EPOCHS = 40
# AdamW at 3e-4 for the image tower, fusion and head, 3e-5 for the text
# tower (multiplier 0.1): from random weights the post-LN text tower does
# not learn this corpus (nor does the JAX trainer's), so the image tower
# carries the fall of the loss; at 1e-3 it fell 3x less (PERF.md §6)
TRAIN_LR = 3e-4
TRAIN_LR_MULT_TEXT = 0.1
TRAIN_STEP_RUNS = 10
# the class-weighted CE (no smoothing) over the training images in eval
# mode, before train() against after: it must fall at least this much
LOSS_DROP = 0.1
# one step's loss, bf16 over f32 masters against f32, from the same
# weights and draws: bf16 noise in the logits (O(1e-2)) moves a CE of
# O(1) by about that much
BF16_LOSS_ATOL = 0.05
# one f32 step (SGD, no dropout, the eval preprocess) on the card, TF32
# off, against the same step on the CPU: the same sums in other orders
# through ResNet-50 and BERT-base. The loss is O(1); a parameter moves by
# lr·g with |g| <= 1 after clipping, so lr·(round-off of g); the
# BatchNorm averages are means of O(1) activations
CARD_CPU_LOSS_ATOL = 1e-4
CARD_CPU_PARAM_ATOL = 1e-5
CARD_CPU_STATS_ATOL = 1e-4
CARD_CPU_LR = 1e-2


def synthetic_corpus():
    """The training corpus: TRAIN_PER_CLASS seeded procedural images per
    class at the staging size, decoded in memory (the card's machine has
    no PIL): (samples, {path: uint8 image})."""
    from multimodal_rare_disease_tpu_torch.config import (
        PREFIX_TO_SYNDROME,
        SYNDROME_NAMES,
    )
    from multimodal_rare_disease_tpu_torch.data.images import ImageSample
    from multimodal_rare_disease_tpu_torch.data.synthetic import (
        SyntheticImageGenerator,
    )
    from multimodal_rare_disease_tpu_torch.train.pipeline import STAGING_SIZE

    synth = SyntheticImageGenerator(image_size=STAGING_SIZE, seed=42)
    prefix = {name: code for code, name in PREFIX_TO_SYNDROME.items()}
    samples, decoded = [], {}
    for c, name in enumerate(SYNDROME_NAMES):
        for i in range(TRAIN_PER_CLASS):
            path = f"synthetic/SYN_{prefix[name]}_{i + 1:03d}.png"
            samples.append(ImageSample(path, c, name))
            decoded[path] = synth.generate(c, i)
    return samples, decoded


def card_cpu_step(cfg_sgd, trained, host, dev, workdir, counted):
    """One f32 step of `cfg_sgd` (SGD at CARD_CPU_LR, no dropout) from
    the `trained` state on the host batch `host`, through the eval
    preprocess, on the card and on the CPU with TF32 off. Fails past the
    CARD_CPU tolerances; returns (loss |diff|, the two losses, parameters
    max|diff|, BatchNorm statistics max|diff|, the most the CPU step
    moved a parameter)."""
    import numpy as np
    import torch

    from multimodal_rare_disease_tpu_torch.ops.preprocess import (
        eval_preprocess,
    )
    from multimodal_rare_disease_tpu_torch.train.trainer import Trainer

    step_out = []
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for where in (dev, torch.device("cpu")):
            t = Trainer(cfg_sgd, "multimodal", device=where,
                        workdir=str(workdir / "probe"))
            t.model.load_state_dict(trained)
            b = {k: torch.from_numpy(np.asarray(v)).to(where)
                 for k, v in host.items() if k != "valid"}
            b = {k: (v.long() if k != "images" else v) for k, v in b.items()}
            images = eval_preprocess(b["images"], cfg_sgd, torch.float32,
                                     use_kernel=False)
            m = counted(lambda: t.apply_step(images, b, CARD_CPU_LR),
                        {"K1": 0, "K2": 0, "K3": 0, "K4": 0,
                         "plain_on_cuda": 0}, f"f32 step on {where.type}")
            step_out.append((float(m["loss"]), {
                k: v.detach().cpu() for k, v in t.model.state_dict().items()}))
            del t
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    (l_card, sd_card), (l_cpu, sd_cpu) = step_out
    d_loss = abs(l_card - l_cpu)
    d_param = max(float((sd_card[k] - sd_cpu[k]).abs().max())
                  for k in sd_cpu if ".running_" not in k)
    d_stats = max(float((sd_card[k] - sd_cpu[k]).abs().max())
                  for k in sd_cpu if ".running_" in k)
    moved = max(float((sd_cpu[k] - trained[k].cpu()).abs().max())
                for k in sd_cpu if ".running_" not in k)
    if d_loss > CARD_CPU_LOSS_ATOL or d_param > CARD_CPU_PARAM_ATOL \
            or d_stats > CARD_CPU_STATS_ATOL:
        fail(f"f32 step card vs CPU: loss {d_loss}, params {d_param}, "
             f"BatchNorm statistics {d_stats}")
    return d_loss, (l_card, l_cpu), d_param, d_stats, moved


def training(dev, card: str, fused_over: dict):
    """Phase 10: the Trainer at full width on the card; returns the
    launches of its counted runs."""
    import tempfile

    import numpy as np
    import torch

    from multimodal_rare_disease_tpu_torch.config import resolve_config
    from multimodal_rare_disease_tpu_torch.evaluation import (
        Evaluator,
        compute_metrics,
    )
    from multimodal_rare_disease_tpu_torch.inference.predictor import (
        load_predictor,
    )
    from multimodal_rare_disease_tpu_torch.train.pipeline import DataPipeline
    from multimodal_rare_disease_tpu_torch.train.trainer import Trainer
    from multimodal_rare_disease_tpu_torch.utils.checkpoint import role_path

    totals = dict.fromkeys(("K1", "K2", "K3", "K4", "plain_on_cuda"), 0)

    counted = partial(count_launches, totals=totals)

    def counts(k1=0, k2=0, k3=0):
        return {"K1": k1, "K2": k2, "K3": k3, "K4": 0, "plain_on_cuda": 0}

    samples, decoded = synthetic_corpus()
    over = {"training.num_epochs": TRAIN_EPOCHS,
            "training.warmup_epochs": 0,
            "training.learning_rate": TRAIN_LR,
            "training.lr_mult_text": TRAIN_LR_MULT_TEXT,
            "training.early_stopping": False,
            # the resumable `last` checkpoint (1.6 GB with the Adam
            # moments) every 10 epochs, not every epoch
            "training.checkpoint_every_epochs": 10}
    cfg = resolve_config("default", over)
    pipe = DataPipeline(cfg, "multimodal", samples=samples, decoded=decoded)
    n_layers = cfg.text_encoder.num_layers
    b_eval = cfg.evaluation.eval_batch_size
    n_val = len(pipe.val_samples)
    val_batches = -(-n_val // b_eval)
    spe = pipe.steps_per_epoch

    def host_batches(images, labels):
        """Eval batches of whole images with their class's full clinical
        description (the text pool's level 0)."""
        zeros = np.zeros(len(labels), np.int64)
        ids, mask = pipe.text_pool.gather(labels, zeros, zeros)
        return [{"images": images[i:i + b_eval],
                 "labels": labels[i:i + b_eval],
                 "valid": np.ones(len(labels[i:i + b_eval]), np.float32),
                 "input_ids": ids[i:i + b_eval],
                 "attention_mask": mask[i:i + b_eval]}
                for i in range(0, len(labels), b_eval)]

    train_set = host_batches(pipe.train_images, pipe.train_labels)

    (HERE / "build").mkdir(exist_ok=True)  # git-ignored, in the checkout
    tmp = tempfile.TemporaryDirectory(dir=HERE / "build")
    workdir = Path(tmp.name)
    trainer = Trainer(cfg, "multimodal", pipeline=pipe,
                      workdir=str(workdir / "run"), device=dev)
    trainer.init_state()
    if not trainer.resident:
        fail("the synthetic corpus did not take the resident mode")
    loss_before = trainer._validate(train_set)["loss"]

    # ---- the main path: train() with its validation every epoch; the
    # train steps launch nothing, each validation batch K1 11 + 1
    t0 = time.perf_counter()
    result = counted(trainer.train,
                     counts(k1=n_layers * val_batches * TRAIN_EPOCHS),
                     "train()")
    train_s = time.perf_counter() - t0
    hist = result["history"]
    loss_after = trainer._validate(train_set)["loss"]
    if not all(np.isfinite(v).all() for v in hist.values()) \
            or result["skipped_steps"] != 0:
        fail(f"train(): history {hist}, skipped {result['skipped_steps']}")
    fall = loss_before - loss_after
    if fall < LOSS_DROP:
        fail(f"the training-set loss fell from {loss_before:.4f} to "
             f"{loss_after:.4f}, less than {LOSS_DROP}; train loss by "
             f"epoch {hist['train_loss']}")
    if trainer.state.step != spe * TRAIN_EPOCHS:
        fail(f"train(): {trainer.state.step} steps, want "
             f"{spe * TRAIN_EPOCHS}")
    print(f"[10 training] multimodal, full width, AdamW lr {TRAIN_LR} "
          f"(text tower x{TRAIN_LR_MULT_TEXT}; cosine, no warmup, no early "
          f"stopping), bf16 over f32 masters, batch "
          f"{cfg.training.batch_size}, {len(pipe.train_samples)} train / "
          f"{n_val} val synthetic images (256 px -> 224) with clinical "
          f"texts (T={cfg.data.max_text_length}), resident corpus | "
          f"{TRAIN_EPOCHS} epochs x {spe} steps in {train_s:.1f} s, "
          f"launches: train steps none, validation K1 {n_layers} per batch "
          f"x {val_batches} x {TRAIN_EPOCHS} | train loss by epoch "
          + ", ".join(f"{x:.3f}" for x in hist["train_loss"])
          + " | val acc by epoch "
          + ", ".join(f"{x:.2f}" for x in hist["val_acc"])
          + f" | training-set loss in eval mode (CE, no smoothing) "
          f"{loss_before:.4f} -> {loss_after:.4f} (must fall >= "
          f"{LOSS_DROP})")

    trained = {k: v.detach().clone()
               for k, v in trainer.model.state_dict().items()}
    idx = next(pipe.train_index_batches())

    def probe(c):
        """A fresh trainer of config `c` on the trained weights."""
        t = Trainer(c, "multimodal", pipeline=pipe,
                    workdir=str(workdir / "probe"), device=dev)
        t.model.load_state_dict(trained)
        t.init_state()
        return t

    # ---- the guard: one good step, then a NaN parameter
    p16 = probe(cfg)
    batch = p16._resident_batch(idx, "train")
    counted(lambda: p16.train_step(batch, TRAIN_LR), counts(), "train step")
    with torch.no_grad():
        p16.model.head.logits.bias[0] = float("nan")

    def bits(t):
        return t.detach().clone().view(torch.int32)

    before = {k: bits(v) for k, v in p16.model.state_dict().items()}
    moments = [bits(s) for st in p16.state.optimizer.state.values()
               for s in st.values() if torch.is_tensor(s)]
    m = counted(lambda: p16.train_step(batch, TRAIN_LR), counts(),
                "poisoned train step")
    after = {k: bits(v) for k, v in p16.model.state_dict().items()}
    moments_after = [bits(s) for st in p16.state.optimizer.state.values()
                     for s in st.values() if torch.is_tensor(s)]
    if m["skipped"] != 1 or p16.state.skipped_steps != 1 \
            or any(not torch.equal(before[k], after[k]) for k in before) \
            or len(moments) != len(moments_after) \
            or any(not torch.equal(a, b)
                   for a, b in zip(moments, moments_after)):
        fail(f"the non-finite guard: skipped {m['skipped']} / "
             f"{p16.state.skipped_steps}, or the state changed")
    del p16

    # ---- bf16 against f32, one step from the same weights and draws
    cfg32 = resolve_config("default", {**over,
                                       "training.compute_dtype": "float32"})
    losses = {}
    for name, c in (("bf16", cfg), ("f32", cfg32)):
        t = probe(c)
        losses[name] = float(t.train_step(t._resident_batch(idx, "train"),
                                          TRAIN_LR)["loss"])
        if name == "bf16":
            # the step's time and peak memory, on this copy
            step_ms = []
            for _ in range(TRAIN_STEP_RUNS):
                b = t._resident_batch(idx, "train")
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                t.train_step(b, TRAIN_LR)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t1) * 1e3)
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            t.train_step(t._resident_batch(idx, "train"), TRAIN_LR)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(dev)
        del t
    d_loss = abs(losses["bf16"] - losses["f32"])
    if d_loss > BF16_LOSS_ATOL:
        fail(f"bf16 and f32 step losses differ by {d_loss}")

    # ---- f32 on the card against the CPU: SGD, no dropout, no
    # augmentation (the eval preprocess of one batch)
    cfg_sgd = resolve_config("default", {
        **over, "training.compute_dtype": "float32",
        "training.optimizer": "sgd", "training.learning_rate": CARD_CPU_LR,
        "text_encoder.dropout": 0.0, "fusion.dropout": 0.0,
        "classifier.dropout": 0.0, "cnn_encoder.dropout": 0.0})
    host = train_set[0]
    d_step_loss, (l_card, l_cpu), d_param, d_stats, moved = card_cpu_step(
        cfg_sgd, trained, host, dev, workdir, counted)
    print(f"[10 steps] NaN parameter on a copy: skipped 1, parameters, "
          f"moments and BatchNorm statistics bit-equal | one step bf16 vs "
          f"f32 loss {losses['bf16']:.5f} vs {losses['f32']:.5f}, |diff| "
          f"{d_loss:.2e} (tolerance {BF16_LOSS_ATOL}) | f32 SGD step "
          f"(lr {CARD_CPU_LR}, batch {len(host['labels'])}) card vs CPU, "
          f"TF32 off: loss {l_card:.6f} vs {l_cpu:.6f} |diff| "
          f"{d_step_loss:.2e} (tolerance {CARD_CPU_LOSS_ATOL}), parameters "
          f"max|diff| {d_param:.2e} (tolerance {CARD_CPU_PARAM_ATOL}; the "
          f"step moved them up to {moved:.2e}), BatchNorm statistics "
          f"{d_stats:.2e} (tolerance {CARD_CPU_STATS_ATOL}) | launches in "
          f"every step: none")

    # ---- one validation pass on each config
    def val_ms(t, n):
        lat = []
        for _ in range(PHASE9_RUNS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            t._validate()
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t1) * 1e3 / n)
        return float(np.median(lat))

    val_default = counted(trainer._validate,
                          counts(k1=n_layers * val_batches),
                          "validation (default)")
    cfg_f = resolve_config("default", {**over, **fused_over,
                                       "data.image_size": cfg.data.image_size})
    t_f = probe(cfg_f)
    val_fused = counted(t_f._validate,
                        counts(k1=val_batches,
                               k2=(n_layers - 1) * val_batches,
                               k3=(n_layers - 1) * val_batches),
                        "validation (fused sublayers)")
    vms = {"default": val_ms(trainer, val_batches),
           "fused": val_ms(t_f, val_batches)}
    del t_f

    # ---- the trained checkpoint through load_predictor and the
    # Evaluator, over all the images; O1 on trained weights
    best = role_path(workdir / "run", "multimodal", "best")
    pred = load_predictor(best, dev)
    every = host_batches(np.concatenate([pipe.train_images,
                                         pipe.val_images]),
                         np.concatenate([pipe.train_labels,
                                         pipe.val_labels]))
    ev = Evaluator(cfg, pred.model)
    collected = counted(lambda: ev.collect_predictions(every),
                        counts(k1=n_layers * len(every)),
                        "Evaluator (trained checkpoint)")
    probs = collected["probabilities"]
    metrics = compute_metrics(collected)
    with plain_kernels():
        plain = ev.collect_predictions(every)["probabilities"]
        p32 = load_predictor(best, dev, cfg=cfg32)
        tf32c = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            f32 = Evaluator(cfg32, p32.model).collect_predictions(
                every)["probabilities"]
        finally:
            torch.backends.cudnn.allow_tf32 = tf32c
    d_plain = float(np.abs(probs - plain).max())
    d_f32 = float(np.abs(probs - f32).max())
    d_pf = float(np.abs(plain - f32).max())
    best_epoch = json.loads((best / "meta.json").read_text())["epoch"]
    print(f"[10 trained checkpoint] {best.name} (epoch {best_epoch + 1}, "
          f"lowest validation loss) via load_predictor: Evaluator over "
          f"{len(probs)} images in "
          f"{len(every)} batches, K1 {n_layers} per batch | accuracy "
          f"{metrics['accuracy']:.4f}, macro F1 {metrics['f1_macro']:.4f} "
          f"| O1 on trained weights: max|dprob| kernels vs plain "
          f"{d_plain:.3e} (limit {PROB_ATOL_PLAIN}), kernels vs f32 "
          f"{d_f32:.3e} (limit {PROB_ATOL_F32}), plain vs f32 {d_pf:.3e} | "
          f"validation loss / acc default {val_default['loss']:.4f} / "
          f"{val_default['acc']:.3f}, fused sublayers {val_fused['loss']:.4f}"
          f" / {val_fused['acc']:.3f}")
    if probs.shape != (len(samples), cfg.num_classes) \
            or not np.isfinite(probs).all() \
            or np.abs(probs.sum(1) - 1).max() > 1e-3:
        fail("Evaluator on the trained checkpoint: bad probabilities")
    if d_plain > PROB_ATOL_PLAIN:
        fail(f"trained checkpoint: kernel and plain probabilities differ by "
             f"{d_plain}")
    if d_f32 > PROB_ATOL_F32:
        fail(f"trained checkpoint: the kernels are {d_f32} from f32")
    print(f"[10 times] {card} | train step (bf16, batch "
          f"{cfg.training.batch_size}, resident) median "
          f"{float(np.median(step_ms)):.2f} ms of {TRAIN_STEP_RUNS} ("
          + ", ".join(f"{x:.1f}" for x in step_ms)
          + f"); peak device memory of a step {peak / 2**30:.2f} GiB "
          f"(allocated before it {base / 2**30:.2f} GiB) | validation ms per "
          f"batch of {b_eval}: " + ", ".join(f"{k} {v:.2f}"
                                             for k, v in vms.items())
          + f" | median of {PHASE9_RUNS}, host clock, synchronized")
    tmp.cleanup()
    return totals


# phase 11: the efficientnet_clinicalbert preset (EfficientNet-B0 at
# 224 px, BERT-base at max_length 256, attention fusion, head), its
# training with random erasing and Gaussian blur on, every augmentation
# extra on the card against the CPU, pre-LN BERT, and the FGDD text
# pipeline through cli/train.py
PRESET = "efficientnet_clinicalbert"
# the preset's train run on phase 10's corpus (4 synthetic images per
# class) at its own batch 8 and augmentation factor 10, for this many
# epochs. Its lr 2e-5 with the stem, stages 1-3 and BERT layers 0-5
# frozen does not train random weights (the JAX config.py:558-562), so
# the loss is not checked, only that it is finite
PRESET_EPOCHS = 2
# the share of the train images whose blur (erasing) selection fired
# lies within this many binomial standard deviations of its probability
FIRED_SIGMAS = 4.0
# the parameters that the preset's steps leave unmoved though trainable:
# zero at the start and zero gradient, so neither the update nor the
# decay moves them (tests/test_torch_gpu.py's full-width step): the
# pooled cross-attentions' query and key biases (one key: the softmax
# is 1) and the pooler's (unused without use_pooler_output)
STILL_TRAINABLE = {f"fusion.{a}_attention.{k}_proj.bias"
                   for a in ("image_to_text", "text_to_image")
                   for k in ("query", "key")} | {
    "text_encoder.bert.pooler.bias"}
# each extra, applied at the same draws to the same f32 batch on the card
# and on CPU tensors. Elementwise ops, the blur's sum of shifted copies
# and the masks: the same IEEE operations in the same order, held at
# 1e-6. CLAHE: the bins come from the same elementwise luminance on both
# (their flips are counted and must be 0), the CDF's cumulative sum and
# the tile blend sum in another order: 1e-5 on [0, 1]. The perspective:
# the 8 x 8 solve by another LU moves the homography by round-off
# (~1e-6 relative) and the sampled coordinates by ~2e-4 px at 224 px;
# a bilinear sample of [0, 1] pixels moves by that times the largest
# neighbour step (1): 1e-3, mean 1e-5 (as the CPU tests hold it against
# JAX); its coordinates stay inside the image. The elastic warp and the
# gather geometry sample at the same coordinates on both: 1e-5. The
# gather's affine maps are computed on each side and held apart
# (AFFINE_ATOL), and the CPU's maps are the ones both sides sample with:
# outside the image the JAX sampling is discontinuous at whole pixels
# (the clamped y0 = 0 and y1 = y0 + 1 = 1 mix rows 0 and 1 by the
# fraction), so an ulp of sin or cos can move a sample by a whole pixel
# step (a first run read 0.45 at one of 38.5M values, mean 2.1e-6)
EXTRA_ATOL = {"blur": 1e-6, "noise": 1e-6, "erasing": 1e-6,
              "coarse dropout": 1e-6, "perspective": 1e-3,
              "CLAHE tiled": 1e-5, "CLAHE global": 1e-5, "elastic": 1e-5,
              "gather geometry": 1e-5}
# the gather's [B, 2, 3] maps, card against CPU: rotation and scale O(1),
# translations up to ~300 px, where an f32 ulp is 3e-5
AFFINE_ATOL = 1e-4
EXTRA_MEAN_ATOL = 1e-5
EXTRA_RUNS = 5
# the FGDD corpus the phase writes: patients, diseases (two more than
# the top-10 cut), HP:* columns, and the share of phenotypes present
FGDD_PATIENTS = 300
FGDD_DISEASES = 12
FGDD_HP = 64
FGDD_PRESENT = 0.15
FGDD_EPOCHS = 2


def write_fgdd(root: Path, seed: int = 0) -> None:
    """A seeded FGDD corpus: root/FGDD/FGDD.csv (patient_id,
    Disease_name and FGDD_HP one-hot HP:* columns, the diseases drawn
    with skewed frequencies) and root/FGDD/Raw data/phenotype.csv."""
    import numpy as np

    rng = np.random.default_rng(seed)
    hp = [f"HP:{1000 + 7 * j:07d}" for j in range(FGDD_HP)]
    diseases = [f"Synthetic disorder {i}" for i in range(FGDD_DISEASES)]
    w = np.linspace(2.0, 0.5, FGDD_DISEASES)
    lines = [",".join(["patient_id", "Disease_name"] + hp)]
    for i in range(FGDD_PATIENTS):
        d = int(rng.choice(FGDD_DISEASES, p=w / w.sum()))
        onehot = (rng.uniform(size=FGDD_HP) < FGDD_PRESENT).astype(int)
        lines.append(",".join([str(i + 1), diseases[d]]
                              + [str(v) for v in onehot]))
    (root / "FGDD" / "Raw data").mkdir(parents=True)
    (root / "FGDD" / "FGDD.csv").write_text("\n".join(lines) + "\n")
    (root / "FGDD" / "Raw data" / "phenotype.csv").write_text(
        "\n".join(["phenotype_id,phenotype_name"]
                  + [f"{h},phenotype term {j}" for j, h in enumerate(hp)])
        + "\n")


def preset_and_extras(dev, card: str, images, texts, agreement, p50_ms):
    """Phase 11; returns the launches of its counted runs."""
    import contextlib
    import io
    import tempfile

    import numpy as np
    import torch

    from multimodal_rare_disease_tpu_torch.cli import train as train_cli
    from multimodal_rare_disease_tpu_torch.config import resolve_config
    from multimodal_rare_disease_tpu_torch.inference.predictor import (
        MultimodalPredictor,
    )
    from multimodal_rare_disease_tpu_torch.models import bert
    from multimodal_rare_disease_tpu_torch.models.classifier import (
        create_model,
    )
    from multimodal_rare_disease_tpu_torch.models.efficientnet import (
        EfficientNetB0Encoder,
    )
    from multimodal_rare_disease_tpu_torch.ops import preprocess as pre
    from multimodal_rare_disease_tpu_torch.train.pipeline import DataPipeline
    from multimodal_rare_disease_tpu_torch.train.text_pipeline import (
        fgdd_text_pipeline,
    )
    from multimodal_rare_disease_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    totals = dict.fromkeys(("K1", "K2", "K3", "K4", "plain_on_cuda"), 0)

    counted = partial(count_launches, totals=totals)

    def counts(k1=0):
        return {"K1": k1, "K2": 0, "K3": 0, "K4": 0, "plain_on_cuda": 0}

    def check_probs(what, probs, n_classes):
        if probs.shape != (BATCH, n_classes) or not np.isfinite(probs).all() \
                or np.abs(probs.sum(1) - 1.0).max() > 1e-3:
            fail(f"{what}: bad probabilities, shape {probs.shape}")

    # ---- serving: predict_batch on phase 4's 256 seeded pairs, K1 in
    # every BERT layer
    cfg = resolve_config(PRESET)
    n_layers = cfg.text_encoder.num_layers
    pred = MultimodalPredictor(cfg, create_model(cfg, device="cpu", seed=0),
                               dev)
    if not isinstance(pred.model.cnn_encoder.backbone,
                      EfficientNetB0Encoder):
        fail("the preset did not build EfficientNet-B0")
    res = counted(lambda: pred.predict_batch(images, texts),
                  counts(n_layers), f"{PRESET} predict_batch")
    probs = probs_of(res, pred.class_names)
    check_probs(PRESET, probs, cfg.num_classes)
    line = agreement(PRESET, pred, probs, {}, preset=PRESET)
    p50, lat = p50_ms(pred)
    print(f"[11 preset] {PRESET}: EfficientNet-B0 224 px, BERT-base "
          f"{n_layers}x{cfg.text_encoder.hidden_size} at max_length "
          f"{cfg.data.max_text_length}, {cfg.fusion.fusion_type} fusion, "
          f"bf16, seeded weights | B={BATCH} launches K1 {n_layers}, "
          f"plain-on-CUDA 0 | {line} | {card} | p50 {p50:.2f} ms "
          f"({', '.join(f'{x:.1f}' for x in lat)})")
    del pred
    torch.cuda.empty_cache()

    # ---- training: the preset's Trainer on phase 10's synthetic corpus,
    # resident; erasing and blur on, frozen stem / stages 1-3 / BERT
    # layers 0-5
    samples, decoded = synthetic_corpus()
    over = {"training.num_epochs": PRESET_EPOCHS,
            "training.warmup_epochs": 0, "training.early_stopping": False,
            "training.checkpoint_every_epochs": PRESET_EPOCHS}
    tcfg = resolve_config(PRESET, over)
    d = tcfg.data
    pipe = DataPipeline(tcfg, "multimodal", samples=samples, decoded=decoded)
    b_eval = tcfg.evaluation.eval_batch_size
    val_batches = -(-len(pipe.val_samples) // b_eval)
    (HERE / "build").mkdir(exist_ok=True)
    tmp = tempfile.TemporaryDirectory(dir=HERE / "build")
    workdir = Path(tmp.name)
    trainer = Trainer(tcfg, "multimodal", pipeline=pipe,
                      workdir=str(workdir / "run"), device=dev)
    trainer.init_state()
    if not trainer.resident:
        fail("the preset's corpus did not take the resident mode")
    start = {n: p.detach().clone()
             for n, p in trainer.model.named_parameters()}
    frozen = {n for n, p in trainer.model.named_parameters()
              if not p.requires_grad}
    want_frozen = {n for n in start
                   if n.startswith(("cnn_encoder.backbone.stem_",
                                    "cnn_encoder.backbone.stage1_",
                                    "cnn_encoder.backbone.stage2_",
                                    "cnn_encoder.backbone.stage3_"))
                   or any(f"text_encoder.bert.layer{i}." in n
                          for i in range(6))}
    if frozen != want_frozen:
        fail(f"the preset froze {len(frozen)} parameters, want "
             f"{len(want_frozen)}")
    fired = {"images": 0, "blur": 0, "erase": 0}
    draw = pre.draw_train_params

    def counting_draw(batch, c, gen, device=None):
        p = draw(batch, c, gen, device)
        fired["images"] += batch
        fired["blur"] += int(p["blur"].sum())
        fired["erase"] += int(p["erase"].sum())
        return p

    pre.draw_train_params = counting_draw
    try:
        t0 = time.perf_counter()
        result = counted(trainer.train,
                         counts(n_layers * val_batches * PRESET_EPOCHS),
                         f"{PRESET} train()")
        train_s = time.perf_counter() - t0
    finally:
        pre.draw_train_params = draw
    hist = result["history"]
    if not all(np.isfinite(v).all() for v in hist.values()) \
            or result["skipped_steps"] != 0:
        fail(f"{PRESET} train(): history {hist}, skipped "
             f"{result['skipped_steps']}")
    after = dict(trainer.model.named_parameters())
    changed = {n for n in start if not torch.equal(
        start[n].view(torch.int32), after[n].detach().view(torch.int32))}
    if changed & frozen:
        fail(f"frozen parameters moved: {sorted(changed & frozen)[:5]}")
    still = set(start) - frozen - changed
    if still != STILL_TRAINABLE:
        fail(f"trainable parameters left unmoved: {sorted(still)[:8]}")
    shares = {}
    for k, prob in (("blur", d.gaussian_blur_prob),
                    ("erase", d.random_erasing_prob)):
        n = fired["images"]
        shares[k] = fired[k] / n
        sigma = (prob * (1 - prob) / n) ** 0.5
        if abs(shares[k] - prob) > FIRED_SIGMAS * sigma:
            fail(f"{k} fired on {fired[k]} of {n} images, probability "
                 f"{prob}")
    # one validation pass: K1 at 16 x 256 = 4,096 rows in layers 0-10,
    # at the 16 CLS rows in the CLS-only last one
    rows = []
    k1_wrapper = bert.fused_ffn_ln

    def rows_of(x, *a, **kw):
        rows.append(x.shape[0])
        return k1_wrapper(x, *a, **kw)

    bert.fused_ffn_ln = rows_of
    try:
        counted(trainer._validate, counts(n_layers * val_batches),
                f"{PRESET} validation")
    finally:
        bert.fused_ffn_ln = k1_wrapper
    t_max = d.max_text_length
    want_rows = ([b_eval * t_max] * (n_layers - 1) + [b_eval]) * val_batches
    if rows != want_rows:
        fail(f"validation K1 rows {rows}, want {want_rows}")
    # a train step launches nothing; its time and peak memory
    idx = next(pipe.train_index_batches())
    step_ms = []
    for _ in range(TRAIN_STEP_RUNS):
        b = trainer._resident_batch(idx, "train")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        counted(lambda: trainer.train_step(b, 1e-5), counts(),
                f"{PRESET} train step")
        step_ms.append((time.perf_counter() - t1) * 1e3)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    trainer.train_step(trainer._resident_batch(idx, "train"), 1e-5)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    val_lat = []
    for _ in range(PHASE9_RUNS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        trainer._validate()
        torch.cuda.synchronize()
        val_lat.append((time.perf_counter() - t1) * 1e3 / val_batches)
    trained = {k: v.detach().clone()
               for k, v in trainer.model.state_dict().items()}
    del trainer
    torch.cuda.empty_cache()

    # one f32 SGD step from the trained weights, card against CPU (TF32
    # off), as phase 10 holds its step: no dropout, the eval preprocess
    cfg_sgd = resolve_config(PRESET, {
        **over, "training.compute_dtype": "float32",
        "training.optimizer": "sgd", "training.learning_rate": CARD_CPU_LR,
        "text_encoder.dropout": 0.0, "fusion.dropout": 0.0,
        "classifier.dropout": 0.0, "cnn_encoder.dropout": 0.0})
    b_step = tcfg.training.batch_size
    zeros = np.zeros(b_step, np.int64)
    labels = pipe.train_labels[:b_step]
    ids, mask = pipe.text_pool.gather(labels, zeros, zeros)
    host = {"images": pipe.train_images[:b_step], "labels": labels,
            "input_ids": ids, "attention_mask": mask}
    d_loss, _, d_param, d_stats, _ = card_cpu_step(
        cfg_sgd, trained, host, dev, workdir, counted)
    print(f"[11 preset training] {PRESET}, bf16 over f32 masters, AdamW "
          f"lr {tcfg.training.learning_rate} ({tcfg.training.scheduler}), "
          f"batch {tcfg.training.batch_size}, augmentation x"
          f"{d.augmentation_factor}, {len(pipe.train_samples)} train / "
          f"{len(pipe.val_samples)} val synthetic images, resident | "
          f"{PRESET_EPOCHS} epochs x {pipe.steps_per_epoch} steps in "
          f"{train_s:.1f} s; train loss by epoch "
          + ", ".join(f"{x:.4f}" for x in hist["train_loss"])
          + f" (not required to fall) | launches: train steps none, "
          f"validation K1 {n_layers - 1} at {b_eval * t_max} rows + 1 at "
          f"{b_eval} per batch | blur fired on {fired['blur']} of "
          f"{fired['images']} images ({shares['blur']:.3f}, p "
          f"{d.gaussian_blur_prob}), erasing on {fired['erase']} "
          f"({shares['erase']:.3f}, p {d.random_erasing_prob}) | "
          f"{len(frozen)} frozen parameters bit-equal, "
          f"{len(changed)} of {len(start) - len(frozen)} trainable moved "
          f"(unmoved: the {len(STILL_TRAINABLE)} zero-gradient biases) | "
          f"f32 SGD step card vs CPU, TF32 off: loss |diff| {d_loss:.2e} "
          f"(tolerance {CARD_CPU_LOSS_ATOL}), parameters {d_param:.2e} "
          f"({CARD_CPU_PARAM_ATOL}), BatchNorm statistics {d_stats:.2e} "
          f"({CARD_CPU_STATS_ATOL})")
    print(f"[11 preset times] {card} | train step median "
          f"{float(np.median(step_ms)):.2f} ms of {TRAIN_STEP_RUNS} ("
          + ", ".join(f"{x:.1f}" for x in step_ms)
          + f"); peak device memory of a step {peak / 2**30:.2f} GiB "
          f"(allocated before it {base / 2**30:.2f} GiB) | validation "
          f"{float(np.median(val_lat)):.2f} ms per batch of {b_eval} "
          f"(median of {PHASE9_RUNS}, with the weight copy)")
    del trained
    torch.cuda.empty_cache()

    # ---- every extra on the card against the CPU, f32, at one set of
    # draws, on the 256 staged images resampled to 224 px
    ecfg = resolve_config(PRESET, {
        "data.gaussian_noise_std": 0.05, "data.perspective_prob": 0.5,
        "data.clahe_prob": 0.5, "data.elastic_prob": 0.5,
        "data.coarse_dropout_prob": 0.5, "data.random_erasing_prob": 0.5,
        "data.geometry_mode": "gather"})
    staged = torch.from_numpy(np.stack(images))
    draws = pre.draw_train_params(BATCH, ecfg, torch.Generator().manual_seed(
        11))
    s_in, s_out = float(staged.shape[1]), ecfg.data.image_size
    scale, shift, fw = pre.eval_resample_params(int(s_in), s_out,
                                                "resize_crop")
    full = torch.full((BATCH,), scale), torch.full((BATCH,), shift)
    x01 = pre.separable_resample(staged, *full, *full, s_out,
                                 filter_width=fw) / 255.0

    def mats(p):
        return pre._compose_affine(s_in, float(s_out), p["crop_scale"],
                                   p["angle"], p["flip"], p["shift_y"],
                                   p["shift_x"])

    affine = mats(draws)
    d_affine = float((mats({k: v.to(dev) for k, v in draws.items()}).cpu()
                      - affine).abs().max())
    if d_affine > AFFINE_ATOL:
        fail(f"the gather's affine maps on the card vs CPU: {d_affine}")

    extras = {
        "blur": lambda x, p: pre.gaussian_blur(x),
        "noise": lambda x, p: pre.gaussian_noise(x, p["noise"], 0.05),
        "erasing": lambda x, p: pre.random_erasing(
            x, p["erase"], p["erase_area"], p["erase_y"], p["erase_x"]),
        "coarse dropout": lambda x, p: pre.coarse_dropout(
            x, p["dropout"], p["dropout_holes"], p["dropout_area"],
            p["dropout_y"], p["dropout_x"]),
        "perspective": lambda x, p: pre.random_perspective(
            x, p["perspective_shift"], p["perspective"]),
        "CLAHE tiled": lambda x, p: pre.clahe_batch_tiled(x),
        "CLAHE global": lambda x, p: pre.clahe_batch(x),
        "elastic": lambda x, p: pre.elastic_transform(
            x, p["elastic_field"], p["elastic"]),
        "gather geometry": lambda x, p: pre.affine_resample(
            p["staged"], p["affine"], s_out) / 255.0,
    }
    cpu_in = (x01, {**draws, "staged": staged, "affine": affine})
    card_in = (x01.to(dev), {k: v.to(dev) for k, v in cpu_in[1].items()})
    _, cpu_bins = pre._luminance_bins(x01, 64)
    _, card_bins = pre._luminance_bins(card_in[0], 64)
    flips = int((cpu_bins != card_bins.cpu()).sum())
    if flips:
        fail(f"CLAHE: {flips} pixels in another luminance bin on the card")
    readings = []
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for name, fn in extras.items():
            want = fn(*cpu_in)
            got = fn(*card_in)
            err = (got.cpu() - want).abs()
            e_max, e_mean = float(err.max()), float(err.mean())
            if e_max > EXTRA_ATOL[name] or e_mean > EXTRA_MEAN_ATOL:
                fail(f"{name} on the card vs CPU: max|diff| {e_max}, mean "
                     f"{e_mean}")
            start_ev = torch.cuda.Event(enable_timing=True)
            end_ev = torch.cuda.Event(enable_timing=True)
            fn(*card_in)
            start_ev.record()
            for _ in range(EXTRA_RUNS):
                fn(*card_in)
            end_ev.record()
            torch.cuda.synchronize()
            ms = start_ev.elapsed_time(end_ev) / EXTRA_RUNS
            readings.append(f"{name} {ms:.3f} ms ({e_max:.1e} / "
                            f"{e_mean:.1e})")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    print(f"[11 extras] {card} | {BATCH} staged images -> {s_out} px, f32, "
          f"one set of draws, card vs CPU max / mean |diff| and the card's "
          f"time per batch (CUDA events, {EXTRA_RUNS} back to back): "
          + "; ".join(readings) + f" | CLAHE bin flips {flips} | the "
          f"gather's affine maps card vs CPU max|diff| {d_affine:.1e} "
          f"(tolerance {AFFINE_ATOL})")
    del cpu_in, card_in, x01, staged
    torch.cuda.empty_cache()

    # ---- pre-LN: no kernel, by the JAX dispatch
    pcfg = resolve_config(PRESET, {"text_encoder.pre_layernorm": True})
    ppred = MultimodalPredictor(pcfg, create_model(pcfg, device="cpu",
                                                   seed=0), dev)
    res = counted(lambda: ppred.predict_batch(images, texts), counts(),
                  "pre-LN predict_batch")
    pprobs = probs_of(res, ppred.class_names)
    check_probs("pre-LN", pprobs, pcfg.num_classes)
    line = agreement("pre-LN", ppred, pprobs,
                     {"text_encoder.pre_layernorm": True}, preset=PRESET)
    print(f"[11 pre-LN] {PRESET} with text_encoder.pre_layernorm: "
          f"B={BATCH} launches none (K1 and K3 off under pre-LN), "
          f"plain-on-CUDA 0 | {line}")
    del ppred
    torch.cuda.empty_cache()

    # ---- FGDD: cli/train.py --mode text_only --data fgdd at full width
    root = workdir / "corpus"
    write_fgdd(root)
    fcfg = resolve_config("default", {"data.data_dirs": (str(root),)})
    fpipe = fgdd_text_pipeline(fcfg)
    f_val = -(-len(fpipe.val_idx) // fcfg.evaluation.eval_batch_size)
    args = ["--data", "fgdd", "--mode", "text_only", "--device", "cuda",
            "--epochs", str(FGDD_EPOCHS),
            "--checkpoint-dir", str(workdir / "fgdd"),
            "--set", f"data.data_dirs=[{str(root)!r}]",
            "--set", f"training.checkpoint_every_epochs={FGDD_EPOCHS}"]
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = counted(lambda: train_cli.main(args),
                     counts(fcfg.text_encoder.num_layers * f_val
                            * FGDD_EPOCHS), "FGDD text_only cli/train.py")
    fgdd_s = time.perf_counter() - t0
    text = out.getvalue()
    summary = json.loads(text[text.index("{"):])
    if rc != 0 or summary["epochs_run"] != FGDD_EPOCHS \
            or not np.isfinite(summary["final_train_loss"]):
        fail(f"FGDD text_only: rc {rc}, summary {summary}")
    print(f"[11 FGDD] cli/train.py --mode text_only --data fgdd on a "
          f"seeded table ({FGDD_PATIENTS} patients, {FGDD_DISEASES} "
          f"diseases -> top {len(fpipe.class_names)}, {FGDD_HP} HP "
          f"columns): {len(fpipe.train_idx)} train / {len(fpipe.val_idx)} "
          f"val texts, BERT-base {fcfg.text_encoder.num_layers}x"
          f"{fcfg.text_encoder.hidden_size}, T={fcfg.data.max_text_length}"
          f" | {FGDD_EPOCHS} epochs in {fgdd_s:.1f} s, final train loss "
          f"{summary['final_train_loss']:.4f}, val acc "
          f"{summary['final_val_acc']:.3f} | launches K1 "
          f"{fcfg.text_encoder.num_layers} per validation batch x {f_val} "
          f"x {FGDD_EPOCHS}, nothing in the train steps | phase 11 took "
          f"{time.perf_counter() - t_phase:.1f} s")
    tmp.cleanup()
    return totals


# phase 12: face detection (MTCNN on the card), the face-cropped predict,
# a converted checkpoint, verify_setup --full, the VAE, the profiler.
# Seeded MTCNN weights (init_mtcnn_params): random nets give nearly equal
# face scores everywhere (P-Net's spread 0.49-0.50), which would make every
# NMS a run of near-ties; each stage's score layer is scaled by
# MTCNN_SCORE_SCALE and its face logit raised by MTCNN_SCORE_BIAS, so
# that every stage keeps candidates with well-separated scores
MTCNN_SCORE_SCALE = 30.0
MTCNN_SCORE_BIAS = {"pnet.conv4_1": 0.5, "rnet.dense5_1": 0.9,
                    "onet.dense6_1": 0.9}
# the detector on the CPU beside the card's, over the first images; the
# nets' inputs recorded on the card over the first NET_TRACE_IMAGES
FACE_CPU_IMAGES = 64
NET_TRACE_IMAGES = 4
# the nets on the card against the CPU on the same inputs, f32 with TF32
# off: probabilities and regressions of O(1) through at most five
# convolutions and three dense layers, summed in another order (cuDNN may
# take Winograd or FFT algorithms, whose round-off is above a direct
# sum's), the face logits scaled by MTCNN_SCORE_SCALE; a wrong layout or
# a dropped term moves them by 0.1 or more
MTCNN_NET_ATOL = 1e-4
# the detector's box, card against CPU: whole pixels (round() of the
# regressed corners). The cascade is discontinuous (thresholds, NMS
# order, floor() of the crop corners): a decision that round-off moves
# changes the box by more than a pixel or whether a face is found. Such
# images are counted as flips and printed; more than FACE_FLIP_LIMIT of
# the FACE_CPU_IMAGES fail the phase
BOX_ATOL = 1
FACE_FLIP_LIMIT = 4
# the converted checkpoint's B=256 bf16 probabilities against the same
# checkpoint in f32 on the CPU, over the first pairs (phase 4's limit)
CONVERT_CPU_PAIRS = 32
# the VAE: the JAX default run (400 epochs) over 5 seeded 64-px images
# per class; its loss must fall to VAE_LOSS_RATIO of the first epoch's.
# One f32 step at VAE_STEP_LR on the card against the CPU (TF32 off):
# Adam's first step moves a parameter by lr·g/(|g| + eps), so round-off
# in g moves it by at most 2·lr (ROADMAP D7); the loss (O(1e3)) within
# VAE_LOSS_RTOL
VAE_PER_CLASS = 5
VAE_EPOCHS = 400
VAE_LOSS_RATIO = 0.5
VAE_STEP_LR = 4e-6
VAE_PARAM_ATOL = 1e-5
VAE_LOSS_RTOL = 1e-5


def mtcnn_weights():
    """The seeded MTCNN state dict with the score layers spread and
    raised (see MTCNN_SCORE_SCALE)."""
    import torch

    from multimodal_rare_disease_tpu_torch.models.mtcnn import (
        init_mtcnn_params,
    )

    sd = init_mtcnn_params(seed=0)
    for layer, bias in MTCNN_SCORE_BIAS.items():
        sd[f"{layer}.weight"] = sd[f"{layer}.weight"] * MTCNN_SCORE_SCALE
        sd[f"{layer}.bias"] = torch.tensor([0.0, bias])
    return sd


def torchvision_resnet50_shapes():
    """torchvision resnet50's state dict schema: {key: shape} (its fc
    included, which the converter ignores)."""
    shapes = {"conv1.weight": (64, 3, 7, 7)}

    def bn(name, c):
        shapes.update({f"{name}.{k}": (c,) for k in
                       ("weight", "bias", "running_mean", "running_var")})
        shapes[f"{name}.num_batches_tracked"] = ()

    bn("bn1", 64)
    cin = 64
    for i, (w, n) in enumerate(zip((64, 128, 256, 512), (3, 4, 6, 3)), 1):
        for b in range(n):
            p = f"layer{i}.{b}"
            for j, (o, ci, k) in enumerate(((w, cin, 1), (w, w, 3),
                                            (4 * w, w, 1)), 1):
                shapes[f"{p}.conv{j}.weight"] = (o, ci, k, k)
                bn(f"{p}.bn{j}", o)
            if b == 0:
                shapes[f"{p}.downsample.0.weight"] = (4 * w, cin, 1, 1)
                bn(f"{p}.downsample.1", 4 * w)
            cin = 4 * w
    shapes.update({"fc.weight": (1000, 2048), "fc.bias": (1000,)})
    return shapes


def hf_bert_shapes(vocab, hidden, layers, inter, positions, types):
    """An HF BertModel's state dict schema: {key: shape}."""
    shapes = {"embeddings.word_embeddings.weight": (vocab, hidden),
              "embeddings.position_embeddings.weight": (positions, hidden),
              "embeddings.token_type_embeddings.weight": (types, hidden),
              "embeddings.LayerNorm.weight": (hidden,),
              "embeddings.LayerNorm.bias": (hidden,),
              "pooler.dense.weight": (hidden, hidden),
              "pooler.dense.bias": (hidden,)}
    for i in range(layers):
        p = f"encoder.layer.{i}"
        for name, (o, ci) in (("attention.self.query", (hidden, hidden)),
                              ("attention.self.key", (hidden, hidden)),
                              ("attention.self.value", (hidden, hidden)),
                              ("attention.output.dense", (hidden, hidden)),
                              ("intermediate.dense", (inter, hidden)),
                              ("output.dense", (hidden, inter))):
            shapes[f"{p}.{name}.weight"] = (o, ci)
            shapes[f"{p}.{name}.bias"] = (o,)
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            shapes[f"{p}.{ln}.weight"] = (hidden,)
            shapes[f"{p}.{ln}.bias"] = (hidden,)
    return shapes


def seeded_state_dict(shapes, seed):
    """Seeded tensors for a schema: weights N(0, 1/fan_in) (so that
    ResNet-50's 16 residual blocks and BERT's 12 layers stay finite in
    bf16), norm scales and BatchNorm variances near 1, shifts, biases and
    means near 0, the batch counter 0."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for k, shape in shapes.items():
        norm = "LayerNorm" in k or "bn" in k or "downsample.1" in k
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.zeros((), dtype=torch.long)
        elif len(shape) > 1:
            fan_in = int(torch.tensor(shape[1:]).prod())
            sd[k] = torch.randn(shape, generator=gen) / fan_in ** 0.5
        elif k.endswith("running_var") or (norm and k.endswith(".weight")):
            sd[k] = 1.0 + 0.1 * torch.rand(shape, generator=gen)
        else:
            sd[k] = 0.1 * torch.randn(shape, generator=gen)
    return sd


def faces_and_tools(dev, card: str, images, texts, agreement, p50_ms):
    """Phase 12; returns the launches of its counted runs."""
    import contextlib
    import io
    import tempfile

    import numpy as np
    import torch

    from multimodal_rare_disease_tpu_torch.cli import convert_weights
    from multimodal_rare_disease_tpu_torch.cli import verify_setup
    from multimodal_rare_disease_tpu_torch.config import (
        Config,
        resolve_config,
    )
    from multimodal_rare_disease_tpu_torch.data import images as dimages
    from multimodal_rare_disease_tpu_torch.data import generative
    from multimodal_rare_disease_tpu_torch.data.synthetic import (
        SyntheticImageGenerator,
    )
    from multimodal_rare_disease_tpu_torch.evaluation import Evaluator
    from multimodal_rare_disease_tpu_torch.inference.predictor import (
        MultimodalPredictor,
        load_predictor,
    )
    from multimodal_rare_disease_tpu_torch.models import bert
    from multimodal_rare_disease_tpu_torch.models import mtcnn
    from multimodal_rare_disease_tpu_torch.models.classifier import (
        create_model,
    )
    from multimodal_rare_disease_tpu_torch.train.pipeline import DataPipeline
    from multimodal_rare_disease_tpu_torch.utils import profiling
    from multimodal_rare_disease_tpu_torch.utils.checkpoint import (
        load_checkpoint,
    )

    t_phase = time.perf_counter()
    totals = dict.fromkeys(("K1", "K2", "K3", "K4", "plain_on_cuda"), 0)
    counted = partial(count_launches, totals=totals)
    cfg = resolve_config("default")
    n_layers = cfg.text_encoder.num_layers

    def counts(k1=0):
        return {"K1": k1, "K2": 0, "K3": 0, "K4": 0, "plain_on_cuda": 0}

    def k1_rows(fn):
        """fn() with the rows of every K1 call recorded."""
        rows, wrapper = [], bert.fused_ffn_ln

        def rec(x, *a, **kw):
            rows.append(x.shape[0])
            return wrapper(x, *a, **kw)

        bert.fused_ffn_ln = rec
        try:
            return fn(), rows
        finally:
            bert.fused_ffn_ln = wrapper

    (HERE / "build").mkdir(exist_ok=True)
    tmp = tempfile.TemporaryDirectory(dir=HERE / "build")
    workdir = Path(tmp.name)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)

    # ---- (a) MTCNN on the card against the same detector on the CPU
    npz = str(workdir / "mtcnn.npz")
    mtcnn.save_mtcnn_npz(mtcnn_weights(), npz)
    card_det = mtcnn.build_face_detector("mtcnn", npz, device=dev)
    cpu_det = mtcnn.build_face_detector("mtcnn", npz, device="cpu")
    synth = SyntheticImageGenerator(image_size=256, seed=12)
    faces = [synth.generate(i % 10, i // 10) for i in range(BATCH)]
    traced = []

    def trace_hook(name):
        def hook(module, inputs, outputs):
            if len(card_boxes) < NET_TRACE_IMAGES:
                traced.append((name, inputs[0].cpu(),
                               [o.cpu() for o in outputs]))
        return hook

    card_boxes = []

    def recording(arr):
        box = card_det(arr)
        card_boxes.append(box)
        return box

    hooks = [getattr(card_det.nets, n).register_forward_hook(trace_hook(n))
             for n in ("pnet", "rnet", "onet")]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    failures0 = dimages.FACE_DETECTOR_FAILURES
    dimages.set_face_detector(recording)
    try:
        t0 = time.perf_counter()
        staged = [dimages.stage_uint8(f, 256) for f in faces]
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu_boxes = [cpu_det(f) for f in faces[:FACE_CPU_IMAGES]]
        cpu_s = time.perf_counter() - t0
        net_err = {}
        for name, x, outs in traced:
            with torch.inference_mode():
                want = getattr(cpu_det.nets, name)(x)
            for i, (g, w) in enumerate(zip(outs, want)):
                key = f"{name}[{i}]"
                net_err[key] = max(net_err.get(key, 0.0),
                                   float((g - w).abs().max()))
    finally:
        dimages.set_face_detector(None)
        for h in hooks:
            h.remove()
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    failures = dimages.FACE_DETECTOR_FAILURES - failures0
    if failures:
        fail(f"the face detector failed {failures} times on the card")
    if len(card_boxes) != BATCH or max(net_err.values()) > MTCNN_NET_ATOL:
        fail(f"MTCNN nets on the card vs CPU: {net_err}")
    flips, box_err = [], 0
    for i, (a, b) in enumerate(zip(card_boxes, cpu_boxes)):
        if a is None or b is None:
            if a != b:
                flips.append(i)
            continue
        d = max(abs(u - v) for u, v in zip(a, b))
        if d > BOX_ATOL:
            flips.append(i)
        else:
            box_err = max(box_err, d)
    if len(flips) > FACE_FLIP_LIMIT:
        fail(f"MTCNN boxes card vs CPU: {len(flips)} flips "
             f"{[(i, card_boxes[i], cpu_boxes[i]) for i in flips]}")
    found = sum(b is not None for b in card_boxes)
    if found < BATCH // 2:
        fail(f"MTCNN found a face in only {found} of {BATCH} images")
    heur_s = time.perf_counter()
    heur = [mtcnn.heuristic_face_box(f) for f in faces]
    heur_s = time.perf_counter() - heur_s
    calls = {n: sum(1 for t in traced if t[0] == n)
             for n in ("pnet", "rnet", "onet")}
    print(f"[12 MTCNN] {card} | {BATCH} seeded 256-px images "
          f"(data/synthetic.py), seeded nets (score layers x"
          f"{MTCNN_SCORE_SCALE:g}, face logits raised "
          f"{list(MTCNN_SCORE_BIAS.values())}), TF32 off | faces found on "
          f"the card {found}/{BATCH} in {card_s:.1f} s "
          f"({1e3 * card_s / BATCH:.1f} ms per image, crop and stage "
          f"included); detector failures {failures} | nets card vs CPU on "
          f"the card's inputs of {NET_TRACE_IMAGES} images ({calls} calls): "
          + ", ".join(f"{k} {v:.1e}" for k, v in net_err.items())
          + f" (tolerance {MTCNN_NET_ATOL}) | boxes card vs CPU over "
          f"{FACE_CPU_IMAGES} images: max |diff| {box_err} px (tolerance "
          f"{BOX_ATOL}), flips {len(flips)} {flips} (limit "
          f"{FACE_FLIP_LIMIT}); the CPU detector took {cpu_s:.1f} s | "
          f"heuristic_face_box: a box in "
          f"{sum(b is not None for b in heur)}/{BATCH} in {heur_s:.1f} s")

    # ---- (b) the face-cropped predict at full width, K1 11 + 1
    pred = MultimodalPredictor(cfg, create_model(cfg, device="cpu", seed=0),
                               dev)
    def want_rows(p):
        """K1's rows in a B=256 predict of `p`: the packed rows in every
        layer but the CLS-only last one, which takes the rows' query
        slots (the classic rows and the CLS rows where packing does not
        win)."""
        ids, mask = p._prep_texts(texts, BATCH)
        packed = p._packed_inputs(ids, mask)
        if packed is None:
            return [ids.size] * (n_layers - 1) + [len(ids)], ids.size
        return ([packed[0].size] * (n_layers - 1) + [packed[3].size],
                packed[0].size)

    res, rows = k1_rows(lambda: counted(
        lambda: pred.predict_batch(staged, texts), counts(n_layers),
        "face-cropped predict_batch"))
    rows_want, packed_m = want_rows(pred)
    if rows != rows_want:
        fail(f"face-cropped predict K1 rows {rows}, want {rows_want}")
    probs = probs_of(res, pred.class_names)
    if probs.shape != (BATCH, cfg.num_classes) or not np.isfinite(probs).all():
        fail(f"face-cropped predict: bad probabilities {probs.shape}")
    line = agreement("face-cropped", pred, probs, {}, batch_images=staged)
    # in turns crops, phase 4's images, phase 4's images, crops: the same
    # predictor on both batches (phase 6 times phase 4's images earlier in
    # the run)
    p50_a, p50_b = p50_ms(pred, staged)[0], p50_ms(pred)[0]
    p50_c, p50_d = p50_ms(pred)[0], p50_ms(pred, staged)[0]
    p50, p50_phase4 = (p50_a + p50_d) / 2, (p50_b + p50_c) / 2
    changed = float(np.mean([not np.array_equal(a, b)
                             for a, b in zip(staged, faces)]))
    print(f"[12 face-cropped predict] {card} | {BATCH} MTCNN crops (20% "
          f"margin, staged to 256 px by the numpy PIL bilinear; "
          f"{changed:.0%} differ from the full frame) with phase 4's texts "
          f"| launches K1 {n_layers - 1} at {packed_m} rows + 1 at "
          f"{rows_want[-1]} query rows, plain-on-CUDA 0 | {line} | p50 "
          f"{p50:.2f} ms on the crops vs {p50_phase4:.2f} ms on phase 4's "
          f"images (in turns {p50_a:.2f} {p50_b:.2f} {p50_c:.2f} "
          f"{p50_d:.2f})")

    # one validation pass of a DataPipeline with face detection on the
    # decoded corpus (phase 10's synthetic images)
    samples, decoded = synthetic_corpus()
    fcfg = resolve_config("default", {
        "data.use_face_detection": True, "data.face_detector": "mtcnn",
        "data.mtcnn_weights": npz})
    t0 = time.perf_counter()
    failures0 = dimages.FACE_DETECTOR_FAILURES
    try:
        pipe = DataPipeline(fcfg, "multimodal", samples=samples,
                            decoded=decoded, device=dev)
    finally:
        dimages.set_face_detector(None)
    pipe_s = time.perf_counter() - t0
    if dimages.FACE_DETECTOR_FAILURES != failures0:
        fail("the face detector failed in the pipeline")
    plain_pipe = DataPipeline(cfg, "multimodal", samples=samples,
                              decoded=decoded, device=dev)
    cropped = sum(not np.array_equal(a, b) for a, b in
                  zip(pipe.val_images, plain_pipe.val_images))
    n_val = -(-len(pipe.val_samples) // fcfg.evaluation.eval_batch_size)
    collected = counted(
        lambda: Evaluator(fcfg, pred.model).collect_predictions(
            pipe.val_batches()), counts(n_layers * n_val),
        "face-detection pipeline validation")
    if not np.isfinite(collected["probabilities"]).all():
        fail("face-detection pipeline: probabilities not finite")
    print(f"[12 face pipeline] {card} | DataPipeline(use_face_detection="
          f"True, mtcnn, decoded) over {len(samples)} images in "
          f"{pipe_s:.1f} s, "
          f"{cropped}/{len(pipe.val_samples)} validation images cropped, "
          f"detector failures 0 | validation K1 {n_layers} x {n_val} batch")
    del pred
    torch.cuda.empty_cache()

    # ---- (c) torchvision ResNet-50 and HF BERT-base files through
    # cli/convert_weights.py, load_predictor and a B=256 predict
    te = cfg.text_encoder
    rn_path, bert_path = workdir / "resnet50.pth", workdir / "bert.bin"
    torch.save(seeded_state_dict(torchvision_resnet50_shapes(), 3), rn_path)
    torch.save(seeded_state_dict(hf_bert_shapes(
        te.vocab_size, te.hidden_size, te.num_layers, te.intermediate_size,
        te.max_position_embeddings, te.type_vocab_size), 4), bert_path)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = convert_weights.main([
            "--backbone", str(rn_path), "--hf-bert", str(bert_path),
            "--num-layers", str(te.num_layers), "--num-heads",
            str(te.num_heads), "--out", str(workdir / "converted"),
            "--device", "cuda"])
    if rc != 0:
        fail(f"cli/convert_weights.py: rc {rc}: {out.getvalue()}")
    cpred = load_predictor(workdir / "converted", dev)
    res, rows = k1_rows(lambda: counted(
        lambda: cpred.predict_batch(images, texts), counts(n_layers),
        "converted checkpoint predict_batch"))
    cprobs = probs_of(res, cpred.class_names)
    meta = load_checkpoint(workdir / "converted")[1]
    meta["config"]["training"]["compute_dtype"] = "float32"
    ref = load_predictor(workdir / "converted", "cpu",
                         cfg=Config.from_dict(meta["config"]))
    ref_probs = probs_of(ref.predict_batch(images[:CONVERT_CPU_PAIRS],
                                           texts[:CONVERT_CPU_PAIRS]),
                         cpred.class_names)
    d_conv = float(np.abs(cprobs[:CONVERT_CPU_PAIRS] - ref_probs).max())
    if not np.isfinite(cprobs).all() or d_conv > PROB_ATOL_F32:
        fail(f"converted checkpoint: card bf16 vs CPU f32 {d_conv}")
    rows_want, conv_m = want_rows(cpred)
    if rows != rows_want:
        fail(f"converted checkpoint K1 rows {rows}, want {rows_want}")
    print(f"[12 converted] {card} | torchvision ResNet-50 "
          f"({len(torchvision_resnet50_shapes())} keys) and HF BERT-base "
          f"files of seeded tensors through cli/convert_weights.py --device "
          f"cuda, load_predictor | B={BATCH} launches K1 {n_layers - 1} at "
          f"{conv_m} rows + 1 at {rows_want[-1]} query rows | "
          f"max|dprob| card bf16 vs the same checkpoint in f32 on the CPU "
          f"over {CONVERT_CPU_PAIRS} pairs {d_conv:.3e} (tolerance "
          f"{PROB_ATOL_F32})")
    del cpred, ref
    torch.cuda.empty_cache()

    # ---- (d) verify_setup --full --device cuda, in-process
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = counted(lambda: verify_setup.main(["--full", "--device",
                                                "cuda"]),
                     counts(n_layers), "verify_setup --full")
    text = out.getvalue()
    if rc != 0 or text.count("[OK]") != 7:
        fail(f"verify_setup --full --device cuda: rc {rc}\n{text}")
    forward = [ln.strip() for ln in text.splitlines() if "7. forward" in ln]
    print(f"[12 verify_setup] {card} | --full --device cuda: all 7 steps "
          f"passed in "
          f"{time.perf_counter() - t0:.1f} s, K1 {n_layers} | {forward[0]}")
    torch.cuda.empty_cache()

    # ---- (e) the VAE: 400 epochs on the card, one f32 step card vs CPU,
    # generation at 256 px
    vsynth = SyntheticImageGenerator(image_size=generative.TRAIN_SIZE,
                                     seed=13)
    vimgs = np.stack([vsynth.generate(c, i) for c in range(10)
                      for i in range(VAE_PER_CLASS)])
    vlabels = np.repeat(np.arange(10), VAE_PER_CLASS)
    _, loss0 = counted(lambda: generative.train_vae(
        vimgs, vlabels, num_epochs=1, seed=0, device=dev), counts(),
        "VAE epoch")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vae, loss = counted(lambda: generative.train_vae(
        vimgs, vlabels, num_epochs=VAE_EPOCHS, seed=0, device=dev),
        counts(), "VAE training")
    torch.cuda.synchronize()
    ms_epoch = (time.perf_counter() - t0) * 1e3 / VAE_EPOCHS
    if not np.isfinite(loss) or loss > VAE_LOSS_RATIO * loss0:
        fail(f"VAE loss {loss0} -> {loss}")
    step = []
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        eps = torch.randn((len(vlabels), 64),
                          generator=torch.Generator().manual_seed(5))
        for where in (dev, torch.device("cpu")):
            m = generative.init_vae(generative.ConvVAE(device="cpu"),
                                    torch.Generator().manual_seed(1)).to(where)
            opt = torch.optim.Adam(m.parameters(), lr=VAE_STEP_LR)
            loss_w = generative.vae_step(
                m, opt, generative.corpus_tensor(vimgs, where),
                torch.from_numpy(vlabels).to(where), eps.to(where),
                VAE_STEP_LR)
            step.append((float(loss_w), {k: v.detach().cpu() for k, v in
                                         m.state_dict().items()}))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    d_vloss = abs(step[0][0] - step[1][0]) / step[1][0]
    d_vparam = max(float((step[0][1][k] - step[1][1][k]).abs().max())
                   for k in step[1][1])
    if d_vloss > VAE_LOSS_RTOL or d_vparam > VAE_PARAM_ATOL:
        fail(f"VAE f32 step card vs CPU: loss {d_vloss}, params {d_vparam}")
    vgen = generative.VAEImageGenerator(vae, image_size=256, seed=3)
    gen_imgs = [vgen.generate(c, 0) for c in range(10)]
    if any(g.shape != (256, 256, 3) or g.dtype != np.uint8
           for g in gen_imgs):
        fail("VAE generation: bad images")
    print(f"[12 VAE] {card} | {len(vlabels)} seeded 64-px images, "
          f"{VAE_EPOCHS} epochs on the card: loss {loss0:.1f} -> {loss:.1f}, "
          f"{ms_epoch:.2f} ms per epoch | f32 step (lr {VAE_STEP_LR}) card vs "
          f"CPU, TF32 off: loss rel |diff| {d_vloss:.1e} (tolerance "
          f"{VAE_LOSS_RTOL}), parameters {d_vparam:.1e} ({VAE_PARAM_ATOL}) "
          f"| generated 10 classes at 256 px")

    # ---- (f) utils/profiling.py around one face-cropped predict call
    ppred = MultimodalPredictor(cfg, create_model(cfg, device="cpu", seed=0),
                                dev)
    ppred.predict_batch(staged, texts)
    torch.cuda.reset_peak_memory_stats(dev)
    with profiling.trace(str(workdir / "trace")):
        ppred.predict_batch(staged, texts)
    trace = json.loads((workdir / "trace" / profiling.TRACE_FILE).read_text())
    kernels = [e for e in trace.get("traceEvents", [])
               if e.get("cat") == "kernel"]
    mem = profiling.device_memory_stats()
    peak = mem[f"cuda:{dev.index or 0}"]["peak_bytes_in_use_mb"]
    if not kernels or peak <= 0:
        fail(f"profiling: {len(kernels)} kernel events, peak {peak} MB")
    print(f"[12 profiling] {card} | trace() around one predict_batch: "
          f"{len(trace['traceEvents'])} events, {len(kernels)} kernels | "
          f"device_memory_stats peak {peak:.0f} MB | phase 12 took "
          f"{time.perf_counter() - t_phase:.1f} s")
    del ppred
    tmp.cleanup()
    torch.cuda.empty_cache()
    return totals


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

    from multimodal_rare_disease_tpu_torch.cli.serve import MicroBatcher
    from multimodal_rare_disease_tpu_torch.config import resolve_config
    from multimodal_rare_disease_tpu_torch.inference.predictor import (
        MultimodalPredictor,
    )
    from multimodal_rare_disease_tpu_torch.inference.seeded_batch import (
        seeded_requests as requests,
    )
    from multimodal_rare_disease_tpu_torch.kernels import build
    from multimodal_rare_disease_tpu_torch.models.classifier import (
        create_model,
    )

    k1, k3, k4 = kernel_modules()  # k1 holds K1 and K2
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
    ptxas_log = (lib_path.parent / "ptxas.log").read_text()
    regs = [ln.strip() for ln in ptxas_log.splitlines() if "registers" in ln]
    faults = ptxas_faults(ptxas_log)
    if faults:
        fail(f"ptxas reports spills or serialized wgmma: {faults}")
    print(f"[2 build] {lib_path.relative_to(HERE)} in "
          f"{time.perf_counter() - t0:.2f} s (nvcc, one per source in "
          f"parallel, {build.last_build_seconds:.2f} s) | smem/block FFN "
          f"{lib.mrd_ffn_smem_bytes()} B, attn-out "
          f"{lib.mrd_attn_out_smem_bytes()} B | "
          f"{'; '.join(regs) or 'no ptxas report'} | no spills, no C75xx "
          f"warnings")

    # the serving batch, prepared first so phase 3 tests the kernels at
    # its row count
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

    gen = torch.Generator().manual_seed(1)

    def rnd(shape, scale, offset=0.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen) * scale + offset).to(
            dev, dtype)

    def diff(got, want):
        d = (got - want).abs()
        return d.max().item(), d.mean().item()

    def within(err):
        return err[0] <= ROW_ATOL and err[1] <= ROW_MEAN_ATOL

    def neutral(name, v):
        return torch.ones_like(v) if "gamma" in name else torch.zeros_like(v)

    def fmt(errs):
        return ", ".join(f"{k}: {e[0]:.3e} / {e[1]:.3e}"
                         for k, e in errs.items())

    # ---- 3. K1 against the plain version on the card
    h, f = cfg.text_encoder.hidden_size, cfg.text_encoder.intermediate_size
    bf = torch.bfloat16
    # drawn in nn.Linear's [out, in] and passed as [in, out] views, as
    # BertLayer passes them: the wrappers then copy no weight
    w1, w2 = rnd((f, h), 0.05, dtype=bf).t(), rnd((h, f), 0.05, dtype=bf).t()
    # biases and shifts at the scale of the signal, LayerNorm scales at
    # 1 +- 0.25: every term moves the output well past the tolerances
    vec = dict(b1=rnd((f,), 0.5), b2=rnd((h,), 0.5),
               gamma=rnd((h,), 0.25, 1.0), beta=rnd((h,), 0.5),
               pre_gamma=rnd((h,), 0.25, 1.0), pre_beta=rnd((h,), 0.5))
    # K2 and K3 read bf16 vectors only, as the model passes them
    k2_vec = {k: vec[k].to(bf) for k in ("b1", "b2", "gamma", "beta")}

    def call(fn, z, v):
        """K1 (v has pre_gamma) or K2 through `fn`, synchronized, f32."""
        ln0 = {k: v[k] for k in ("pre_gamma", "pre_beta") if k in v}
        if fn is k1.ffn_ln_plain:
            ln0["input_ln"] = bool(ln0)
        out = fn(z, w1, v["b1"], w2, v["b2"], v["gamma"], v["beta"], **ln0)
        torch.cuda.synchronize()
        return out.float()

    def check_rows(name, kern, plain, make, vecs, dropped_of):
        """A row kernel against its plain version at the phase-3 row
        counts with `vecs` (and bf16 ones, where `vecs` are f32), and the
        check's failure for a kernel that drops a term; returns (worst
        max|diff|, line)."""
        errs = {}
        for m in PHASE3_ROWS + (packed_m,):
            args = make(m)
            got = kern(*args, vecs)
            if not torch.isfinite(got).all():
                fail(f"{name} output not finite at M={m}")
            errs[f"M={m}"] = diff(got, plain(*args, vecs))
            if m == 4096:
                args_4k, want_4k = args, plain(*args, vecs)
        if any(v.dtype != bf for v in vecs.values()):
            vecs_bf = {k: v.to(bf) for k, v in vecs.items()}
            errs[f"M={packed_m}, bf16 vectors"] = diff(
                kern(*args, vecs_bf), plain(*args, vecs_bf))
        dropped = {term: diff(kern(*dropped_args, dropped_vecs), want_4k)
                   for term, (dropped_args, dropped_vecs)
                   in dropped_of(args_4k, vecs).items()}
        for k, e in errs.items():
            if not within(e):
                fail(f"{name} disagrees with its plain version at {k}: {e}")
        for k, e in dropped.items():
            if within(e):
                fail(f"the {name} check passes a kernel that drops {k}: {e}")
        vec_types = sorted({str(v.dtype).split(".")[1]
                            for v in vecs.values()})
        return max(e[0] for e in errs.values()), (
            f"{name} max|diff| / mean|diff| {fmt(errs)} (bf16, "
            f"{'/'.join(vec_types)} vectors, tolerance "
            f"{ROW_ATOL} / {ROW_MEAN_ATOL}) | a kernel that drops a term "
            f"reads, at M=4096: {fmt(dropped)}")

    def drop_vectors(args, vecs):
        # a kernel that dropped a term: the kernel given the term's
        # neutral value, held against the plain version given the real one
        return {k: (args, {**vecs, k: neutral(k, v)})
                for k, v in vecs.items()}

    def make_z(m):
        return (rnd((m, h), 1.0, dtype=bf),)

    k1_err, line = check_rows("K1", lambda z, v: call(k1.fused_ffn_ln, z, v),
                              lambda z, v: call(k1.ffn_ln_plain, z, v),
                              make_z, vec, drop_vectors)
    print(f"[3 K1 vs plain] {line}")

    # ---- 3b. K2, K3 and K4 against their plain versions on the card
    k2_err, line2 = check_rows(
        "K2", lambda z, v: call(k1.fused_ffn_ln, z, v),
        lambda z, v: call(k1.ffn_ln_plain, z, v), make_z, k2_vec,
        drop_vectors)
    wo = rnd((h, h), 0.05, dtype=bf).t()  # a view of [out, in], as above
    k3_vec = dict(bo=rnd((h,), 0.5, dtype=bf),
                  gamma=rnd((h,), 0.25, 1.0, dtype=bf),
                  beta=rnd((h,), 0.5, dtype=bf))

    def attn(fn, ctx, x, v):
        out = fn(ctx, x, wo, v["bo"], v["gamma"], v["beta"])
        torch.cuda.synchronize()
        return out.float()

    def drop_k3(args, vecs):
        out = drop_vectors(args, vecs)
        out["x"] = ((args[0], torch.zeros_like(args[1])), vecs)
        return out

    k3_err, line3 = check_rows(
        "K3", lambda c, x, v: attn(k3.fused_attn_out_ln, c, x, v),
        lambda c, x, v: attn(k3.attn_out_ln_plain, c, x, v),
        lambda m: (rnd((m, h), 1.0, dtype=bf), rnd((m, h), 1.0, dtype=bf)),
        k3_vec, drop_k3)
    # f32 vectors: outside K2's and K3's gate, so the plain version,
    # counted in PLAIN_ON_CUDA, and no launch
    reset_counts()
    call(k1.fused_ffn_ln, make_z(37)[0],
         {k: v.float() for k, v in k2_vec.items()})
    attn(k3.fused_attn_out_ln, *make_z(37), *make_z(37),
         {k: v.float() for k, v in k3_vec.items()})
    gate = launch_counts()
    if gate != {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "plain_on_cuda": 2}:
        fail(f"K2 and K3 with f32 vectors: counts {gate}, want the gate's "
             f"two plain calls and no launch")
    k4_errs = {}
    u8_full = None
    for shape in ((BATCH, 256, 256, 3), (3, 37, 41, 3)):
        u = torch.randint(0, 256, shape, generator=gen,
                          dtype=torch.uint8).to(dev)
        u8_full = u8_full if u8_full is not None else u
        for dt in (torch.float32, bf):
            name = str(dt).split(".")[1]
            got = k4.fused_normalize_u8(u, dt)
            torch.cuda.synchronize()
            if got.dtype != dt or got.shape != u.shape:
                fail(f"K4 returned {got.dtype} {tuple(got.shape)}")
            e = diff(got.float(), k4.normalize_u8_plain(u, dt).float())
            k4_errs[f"{list(shape)} {name}"] = e
            if e[0] > K4_ATOL[name] or e[1] > K4_MEAN_ATOL:
                fail(f"K4 disagrees with its plain version at {shape} "
                     f"{name}: {e}")
    k4_err = max(e[0] for e in k4_errs.values())
    print(f"[3b K2, K3, K4 vs plain] {line2} || {line3} || K4 max|diff| / "
          f"mean|diff| {fmt(k4_errs)} (tolerance f32 {K4_ATOL['float32']}, "
          f"bf16 {K4_ATOL['bfloat16']}; mean {K4_MEAN_ATOL})")

    # ---- 4. the full-width model through the default path
    n_layers = cfg.text_encoder.num_layers
    reset_counts()
    res = pred.predict_batch(images, texts)
    main4 = launch_counts()
    if pred.packed_calls < 1:
        fail("the batch did not take the packed path")
    if main4 != {"K1": n_layers, "K2": 0, "K3": 0, "K4": 0,
                 "plain_on_cuda": 0}:
        fail(f"default path launches {main4} (want K1 {n_layers} and "
             f"nothing else)")
    probs = probs_of(res, pred.class_names)
    if probs.shape != (BATCH, cfg.num_classes) or not np.isfinite(probs).all():
        fail(f"bad probabilities: shape {probs.shape}")
    if np.abs(probs.sum(1) - 1.0).max() > 1e-3:
        fail("probabilities do not sum to 1")

    def reference_probs(p, over, preset="default", batch_images=None):
        """The kernel-off run of `p`, and the same seeded weights under
        the f32 compute dtype on the card (FFN in plain f32: the kernels
        are bf16-only; cuDNN convolutions without TF32), on phase 4's
        images or `batch_images`."""
        imgs = images if batch_images is None else batch_images
        with plain_kernels():
            plain = probs_of(p.predict_batch(imgs, texts), p.class_names)
            cfg32 = resolve_config(preset, {
                **over, "training.compute_dtype": "float32"})
            ref = MultimodalPredictor(
                cfg32, create_model(cfg32, device="cpu", seed=0), dev)
            tf32 = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = False
            try:
                f32 = probs_of(ref.predict_batch(imgs, texts),
                               p.class_names)
            finally:
                torch.backends.cudnn.allow_tf32 = tf32
        return plain, f32

    def agreement(tag, p, probs, over, preset="default", batch_images=None):
        probs_plain, probs_ref = reference_probs(p, over, preset,
                                                 batch_images)
        d_kp = float(np.abs(probs - probs_plain).max())
        d_kr = float(np.abs(probs - probs_ref).max())
        d_pr = float(np.abs(probs_plain - probs_ref).max())
        top1 = int((probs.argmax(1) == probs_plain.argmax(1)).sum())
        top1_ref = int((probs.argmax(1) == probs_ref.argmax(1)).sum())
        line = (f"max|dprob| kernels vs plain {d_kp:.3e} (tolerance "
                f"{PROB_ATOL_PLAIN}), kernels vs f32 {d_kr:.3e} (tolerance "
                f"{PROB_ATOL_F32}), plain vs f32 {d_pr:.3e}; top-1 kernels = "
                f"plain in {top1}/{BATCH} rows, = f32 in {top1_ref}/{BATCH}")
        if d_kp > PROB_ATOL_PLAIN:
            fail(f"{tag}: kernel and plain probabilities differ by {d_kp}")
        if d_kr > PROB_ATOL_F32:
            fail(f"{tag}: kernel path is {d_kr} from the f32 reference")
        return line

    line4 = agreement("default path", pred, probs, {})
    print(f"[4 model] B={BATCH} packed into {rows}x{cap_tokens} tokens "
          f"(M={packed_m}), classic {ids.shape}; built in {build_s:.1f} s; "
          f"launches {main4}; {line4}")

    # ---- 5. serving through the MicroBatcher
    def serve(p, n_concurrent=8, n_single=3):
        reset_counts()
        classic0 = p.classic_calls
        batcher = MicroBatcher(p, window_ms=20.0)
        try:
            s_images, s_texts = requests(n_concurrent + n_single, seed=2)
            with ThreadPoolExecutor(n_concurrent) as ex:
                futs = [ex.submit(batcher.submit, s_images[i], s_texts[i], 3)
                        for i in range(n_concurrent)]
                answers = [fu.result(timeout=300) for fu in futs]
            for i in range(n_concurrent, n_concurrent + n_single):
                answers.append(batcher.submit(s_images[i], s_texts[i], 3))
            calls = batcher.batch_calls
        finally:
            batcher.close()
        for a in answers:
            if set(a) != {"predictions", "top_prediction",
                          "all_probabilities"} \
                    or len(a["predictions"]) != 3 \
                    or a["top_prediction"] != a["predictions"][0]:
                fail(f"answer breaks the JSON contract: {a}")
        if p.classic_calls <= classic0:
            fail("single requests did not take the classic path")
        if calls >= len(answers):
            fail(f"{calls} forwards for {len(answers)} requests: no batching")
        return len(answers), calls, p.classic_calls - classic0, \
            launch_counts()

    n_ans, calls, n_classic, serve5 = serve(pred)
    if serve5 != {"K1": n_layers * calls, "K2": 0, "K3": 0, "K4": 0,
                  "plain_on_cuda": 0}:
        fail(f"serving: launches {serve5} for {calls} forwards")
    print(f"[5 serving] {n_ans} requests in {calls} forwards, launches "
          f"{serve5}, classic calls {n_classic}")

    # ---- 6. times
    def p50_ms(p, batch_images=None):
        imgs = images if batch_images is None else batch_images
        for _ in range(2):
            p.predict_batch(imgs, texts)
        lat = []
        for _ in range(TIMED_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p.predict_batch(imgs, texts)  # ends in a device→host copy
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(lat)), lat

    def sleep_cycles_per_ms():
        """The rate of torch.cuda._sleep, which spins the card for a
        number of its clock cycles."""
        torch.cuda._sleep(1000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(20_000_000)
        end.record()
        torch.cuda.synchronize()
        return 20_000_000 / start.elapsed_time(end)

    cycles_per_ms = sleep_cycles_per_ms()

    def host_ms(fn, n=20):
        """The host's time to issue one call of `fn` (the wrapper's Python
        and C work and the launch), the card idle before the n calls."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t = (time.perf_counter() - t0) * 1e3 / n
        torch.cuda.synchronize()
        return t

    def events_ms(fn, n, wait=0):
        """CUDA-event time per call of `fn` over n calls back to back,
        after the card has spun for `wait` cycles."""
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
        """The time per call of `fn` over n calls back to back, read two
        ways: (device, back to back). Device: the card first spins for
        longer than the host takes to issue the n calls, so all of them
        are queued when it reaches the start event and the events bracket
        device work only. Back to back: the calls issued from an idle
        card, so where the host takes longer to issue a call than the card
        to run it, the events read the host's pace."""
        b2b = events_ms(fn, n)
        wait = int(3 * host_ms(fn, n) * n * cycles_per_ms) + 100_000
        return events_ms(fn, n, wait), b2b

    def in_turns(kernel, plain):
        """(kernel ms, plain ms, the four runs, (kernel ms, plain ms) back
        to back) in turns plain, kernel, kernel, plain; the first two are
        device times."""
        (plain_a, pb_a), (kern_a, kb_a) = (per_call_ms(plain),
                                           per_call_ms(kernel))
        (kern_b, kb_b), (plain_b, pb_b) = (per_call_ms(kernel),
                                           per_call_ms(plain))
        return ((kern_a + kern_b) / 2, (plain_a + plain_b) / 2,
                f"runs {plain_a:.3f} {kern_a:.3f} {kern_b:.3f} {plain_b:.3f}; "
                f"back to back {pb_a:.3f} {kb_a:.3f} {kb_b:.3f} {pb_b:.3f}",
                ((kb_a + kb_b) / 2, (pb_a + pb_b) / 2))

    p50, lat = p50_ms(pred)
    z = rnd((packed_m, h), 1.0, dtype=bf)
    vec_bf = {k: v.to(bf) for k, v in vec.items()}  # as the model passes them

    def ffn_args(v):
        ln0 = {k: v[k] for k in ("pre_gamma", "pre_beta") if k in v}
        return (z, w1, v["b1"], w2, v["b2"], v["gamma"], v["beta"]), ln0

    a1, ln0 = ffn_args(vec_bf)
    k1_ms, k1_plain_ms, k1_runs, k1_b2b = in_turns(
        lambda: k1.fused_ffn_ln(*a1, **ln0),
        lambda: k1.ffn_ln_plain(*a1, input_ln=True, **ln0))
    k1_bound, k1_by = ffn_bound(packed_m, h, f, 2, True)
    small = []
    for m in SMALL_ROWS:
        zm = rnd((m, h), 1.0, dtype=bf)
        am = (zm,) + a1[1:]
        ms, plain_ms, runs, _ = in_turns(
            lambda: k1.fused_ffn_ln(*am, **ln0),
            lambda: k1.ffn_ln_plain(*am, input_ln=True, **ln0))
        bound, by = ffn_bound(m, h, f, 2, True)
        plan = k1.ffn_plan(m, f, torch.cuda.get_device_properties(
            dev).multi_processor_count)
        small.append(f"M={m} ({plan.tiles} tiles x {plan.slices} slices): "
                     f"{ms:.4f} ms vs plain {plain_ms:.4f} ({runs}), bound "
                     f"{bound:.4f} ms ({by}), {bound / ms:.1%} of it")
    print(f"[6 times] {card} | predict_batch B={BATCH} p50 {p50:.2f} ms "
          f"(of {TIMED_RUNS}: {', '.join(f'{x:.1f}' for x in lat)}) | "
          f"K1 at M={packed_m}: {k1_ms:.3f} ms/layer vs plain "
          f"{k1_plain_ms:.3f} ms/layer ({k1_runs}); bound {k1_bound:.4f} ms "
          f"({k1_by}), {k1_bound / k1_ms:.1%} of it | K1 at "
          f"{'; '.join(small)}")
    del pred, model
    torch.cuda.empty_cache()

    # ---- 7. the fused-sublayer path: K3 -> K2 in layers 0..10, K1 in
    # the CLS-only last layer, K4 on images staged at image_size
    over7 = {"text_encoder.fused_attn_out": True, "data.image_size": 256}
    cfg7 = resolve_config("default", over7)
    pred7 = MultimodalPredictor(cfg7, create_model(cfg7, device="cpu",
                                                   seed=0), dev)
    want7 = {"K1": 1, "K2": n_layers - 1, "K3": n_layers - 1, "K4": 1,
             "plain_on_cuda": 0}
    reset_counts()
    res7 = pred7.predict_batch(images, texts)
    main7 = launch_counts()
    if pred7.packed_calls != 1:
        fail("the fused-sublayer batch did not take the packed path")
    if main7 != want7:
        fail(f"fused-sublayer path launches {main7}, want {want7}")
    probs7 = probs_of(res7, pred7.class_names)
    if probs7.shape != (BATCH, cfg7.num_classes) \
            or not np.isfinite(probs7).all() \
            or np.abs(probs7.sum(1) - 1.0).max() > 1e-3:
        fail(f"bad fused-sublayer probabilities: shape {probs7.shape}")
    line7 = agreement("fused-sublayer path", pred7, probs7, over7)
    n_ans7, calls7, n_classic7, serve7 = serve(pred7, n_single=1)
    if serve7 != {k: v * calls7 for k, v in want7.items()}:
        fail(f"fused-sublayer serving: launches {serve7} for {calls7} "
             f"forwards")
    print(f"[7 fused sublayers] B={BATCH}, image_size 256, fused_attn_out; "
          f"launches per forward {main7}; {line7} | MicroBatcher: "
          f"{n_ans7} requests in {calls7} forwards ({n_classic7} classic), "
          f"launches {serve7}")

    # ---- 8. times of the fused-sublayer path
    p50_7, lat7 = p50_ms(pred7)
    ids7, mask7 = pred7._prep_texts(texts, BATCH)
    m7 = int(np.prod(pred7._packed_inputs(ids7, mask7)[0].shape))
    z7 = rnd((m7, h), 1.0, dtype=bf)
    c7 = rnd((m7, h), 1.0, dtype=bf)
    v2, v3 = k2_vec, k3_vec  # bf16, as the model passes them
    a2 = (z7, w1, v2["b1"], w2, v2["b2"], v2["gamma"], v2["beta"])
    a3 = (c7, z7, wo, v3["bo"], v3["gamma"], v3["beta"])
    k2_ms, k2_plain_ms, k2_runs, k2_b2b = in_turns(
        lambda: k1.fused_ffn_ln(*a2),
        lambda: k1.ffn_ln_plain(*a2, input_ln=False))
    k3_ms, k3_plain_ms, k3_runs, k3_b2b = in_turns(
        lambda: k3.fused_attn_out_ln(*a3), lambda: k3.attn_out_ln_plain(*a3))
    k4_ms, k4_plain_ms, k4_runs, k4_b2b = in_turns(
        lambda: k4.fused_normalize_u8(u8_full, bf),
        lambda: k4.normalize_u8_plain(u8_full, bf))
    # the one PyTorch call that computes K4: addcmul promotes the uint8
    # images to f32 and casts the result to its bf16 `out`
    scale, bias = (torch.from_numpy(a).to(dev) for a in k4.normalize_affine())
    y_lib = torch.empty(u8_full.shape, dtype=bf, device=dev)

    def k4_library():
        return torch.addcmul(bias, u8_full, scale, out=y_lib)

    k4_lib_err = diff(k4_library().float(),
                      k4.normalize_u8_plain(u8_full, bf).float())
    if k4_lib_err[0] > K4_ATOL["bfloat16"] or k4_lib_err[1] > K4_MEAN_ATOL:
        fail(f"addcmul does not compute K4's function: {k4_lib_err}")
    # in turns K4, addcmul, addcmul, K4
    k4_lib_ms, k4_ms_b, k4_lib_runs, _ = in_turns(
        k4_library, lambda: k4.fused_normalize_u8(u8_full, bf))
    k2_bound, k2_by = ffn_bound(m7, h, f, 2, False)
    k3_bound, k3_by = attn_out_bound(m7, h, 2)
    k4_bound, k4_by = normalize_bound(u8_full.numel(), 2)
    # K3 against the classic chain it stands for, as BertLayer runs it with
    # fused_attn_out off: bf16 F.linear (the projection rounded to bf16),
    # the residual add and LayerNorm. Three calls, so K3's library_ms stays
    # null; its distance from the plain version is the rounding K3 skips
    import torch.nn.functional as F

    def k3_classic():
        return F.layer_norm(F.linear(c7, wo.t(), v3["bo"]) + z7, (h,),
                            v3["gamma"], v3["beta"], 1e-12)

    classic_err = diff(k3_classic().float(), k3.attn_out_ln_plain(*a3).float())
    # in turns K3, chain, chain, K3
    classic_ms, k3_ms_b, classic_runs, _ = in_turns(
        k3_classic, lambda: k3.fused_attn_out_ln(*a3))
    # a single request's 64 rows: the split-K path
    a3_64 = (rnd((64, h), 1.0, dtype=bf), rnd((64, h), 1.0, dtype=bf)) + a3[2:]
    k3_64_ms, k3_64_plain_ms, k3_64_runs, _ = in_turns(
        lambda: k3.fused_attn_out_ln(*a3_64),
        lambda: k3.attn_out_ln_plain(*a3_64))
    k3_64_bound, k3_64_by = attn_out_bound(64, h, 2)
    # what the wrapper costs the host per call (Python, tensor maps, launch)
    k3_host = {m: host_ms(lambda: k3.fused_attn_out_ln(*a)) for m, a in
               ((m7, a3), (64, a3_64))}
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    plans = ", ".join(f"M={m}: {p.tiles}x{p.slices}" for m in
                      PHASE3_ROWS + (m7,)
                      for p in [k3.attn_out_plan(m, n_sm)])
    print(f"[8 times] {card} | fused-sublayer predict_batch B={BATCH} p50 "
          f"{p50_7:.2f} ms (of {TIMED_RUNS}: "
          f"{', '.join(f'{x:.1f}' for x in lat7)}) | at M={m7}: K2 "
          f"{k2_ms:.3f} ms/layer vs plain {k2_plain_ms:.3f} ({k2_runs}), "
          f"bound {k2_bound:.4f} ms ({k2_by}), {k2_bound / k2_ms:.1%} of it; "
          f"K3 {k3_ms:.3f} ms/layer vs plain {k3_plain_ms:.3f} ({k3_runs}), "
          f"bound {k3_bound:.4f} ms ({k3_by}), {k3_bound / k3_ms:.1%} of it; "
          f"K3 vs the classic bf16 linear + add + LayerNorm chain: "
          f"{k3_ms_b:.4f} vs {classic_ms:.4f} ms ({classic_runs}; the "
          f"chain's max|diff| / mean|diff| from plain {classic_err[0]:.3e} / "
          f"{classic_err[1]:.3e}); K3 at M=64: {k3_64_ms:.4f} ms vs plain "
          f"{k3_64_plain_ms:.4f} ({k3_64_runs}), bound {k3_64_bound:.4f} ms "
          f"({k3_64_by}), {k3_64_bound / k3_64_ms:.1%} of it; K3's host time "
          f"per call {', '.join(f'M={m}: {t:.4f} ms' for m, t in k3_host.items())}"
          f"; K3 tiles x "
          f"slices {plans} "
          f"| K4 on {list(u8_full.shape)} uint8 -> bf16: {k4_ms:.4f} ms vs "
          f"plain {k4_plain_ms:.4f} ({k4_runs}), bound {k4_bound:.4f} ms "
          f"({k4_by}), {k4_bound / k4_ms:.1%} of it; addcmul into bf16 "
          f"{k4_lib_ms:.4f} ms vs K4 {k4_ms_b:.4f} ({k4_lib_runs}; "
          f"max|diff| / mean|diff| from plain {k4_lib_err[0]:.3e} / "
          f"{k4_lib_err[1]:.3e})")

    # ---- 9. evaluation and explain
    del pred7
    torch.cuda.empty_cache()
    main9 = evaluation_and_explain(dev, card, over7)

    # ---- 10. training
    torch.cuda.empty_cache()
    main10 = training(dev, card, over7)

    # ---- 11. the efficientnet_clinicalbert preset, the augmentation
    # extras, pre-LN and FGDD
    torch.cuda.empty_cache()
    main11 = preset_and_extras(dev, card, images, texts, agreement, p50_ms)

    # ---- 12. face detection, the face-cropped predict, a converted
    # checkpoint, verify_setup --full, the VAE and the profiler
    torch.cuda.empty_cache()
    main12 = faces_and_tools(dev, card, images, texts, agreement, p50_ms)

    leaked = sorted(m for m in sys.modules if m.split(".")[0] in
                    ("jax", "jaxlib", "flax", "optax", "orbax", "sklearn",
                     "matplotlib", "seaborn", "PIL", "pandas",
                     "multimodal_rare_disease_tpu"))
    if leaked:
        fail(f"jax, the JAX package or a package the card's machine lacks "
             f"was imported: {leaked[:5]}")

    src = "multimodal_rare_disease_tpu_torch/csrc/"
    tpu = "multimodal_rare_disease_tpu/ops/pallas/"
    table = [
        # library_ms: one PyTorch call that computes the same function.
        # K1-K3 have none: LayerNorm, the products, GELU and the residual
        # are separate calls
        ("ffn_pre_ln_bf16", "ffn_ln.cu", "ffn.py:72", "K1", k1_err, k1_ms,
         k1_plain_ms, k1_b2b, k1_bound, k1_by, None),
        ("ffn_ln_bf16", "ffn_ln.cu", "ffn.py:103", "K2", k2_err, k2_ms,
         k2_plain_ms, k2_b2b, k2_bound, k2_by, None),
        ("attn_out_ln_bf16", "attn_out_ln.cu", "attn_out.py:38", "K3",
         k3_err, k3_ms, k3_plain_ms, k3_b2b, k3_bound, k3_by, None),
        ("normalize_u8", "normalize_u8.cu", "image_kernels.py:37", "K4",
         k4_err, k4_ms, k4_plain_ms, k4_b2b, k4_bound, k4_by, k4_lib_ms),
    ]
    print(card)
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": src + source,
        "replaces": tpu + replaces,
        # launches on the main paths: phases 4, 5, 7 (both of its runs),
        # 9, 10, 11 and 12 (their counted runs)
        "launches": (main4[k] + serve5[k] + main7[k] + serve7[k]
                     + main9[k] + main10[k] + main11[k] + main12[k]),
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": lib_ms,
        # the same calls timed from an idle card (per_call_ms)
        "ms_back_to_back": b2b[0],
        "plain_ms_back_to_back": b2b[1],
    } for name, source, replaces, k, err, ms, plain_ms, b2b, bound, by,
        lib_ms in table]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
