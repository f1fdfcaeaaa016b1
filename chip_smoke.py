#!/usr/bin/env python3
"""Drive the torch package's serving, evaluation, training, data-tool,
rank-mesh, int8, f32, BERT-large-width, compact-width, odd-width and
wide-width paths and its `entry()` forward once on one NVIDIA Hopper card.

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
   check fails for a kernel that drops any one of the six vectors; the
   same for K1's f32 form (f32 rows, weights and vectors, the f32
   limits; also at M = 16,385, a ragged tile of its 128-row GEMMs), whose
   check also fails the plain version run with its operands rounded to
   TF32 in the kernel's place;
3b. the same for K2 (the FFN kernel without its input LayerNorm) and K3
   (the fused attention-output + LayerNorm kernel: split-K below 132 row
   tiles, whole K at the packed count), which read bf16 vectors only (f32
   ones go through the counted gate, checked here too),
   the f32 forms of K2 and K3 as K1's above, and f32 rows with bf16
   vectors on the gates' counted plain version; and K4 (the fused uint8
   normalize) on 256 images of 256 px and on a ragged batch, in f32 and
   bf16;
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

13. the rank mesh (parallel/): the B=256 predict on a 1x1 mesh over a
   NCCL process group of one, equal to phase 4's; two ranks on this card
   over gloo (NCCL refuses two ranks on one device), each running its
   rows through the kernels: the predict on a 2x1 and a 1x2 mesh (K1 12
   per rank, on gathered W1/W2 under 1x2) and the fused-sublayer one on
   1x2 (K3 11, K2 11, K1 1, K4 1 per rank), held to phase 4's limits,
   and the int8 one (text_encoder.quantized_inference) on 1x2, which
   launches nothing, held to the int8 predict on the 1x1 mesh;
   two f32 SGD steps at full width (TF32 off) on 1x1, 2x1 and 1x2 from
   the same weights and batches, which launch nothing, held to the CPU
   tests' limits, and a bf16 validation batch per rank (K1 12);
   `cli/serve.py --mesh 2x1 --backend gloo` answering 8 concurrent and 3
   single text requests as the single-device predictor does; and
   `dryrun_multichip(2)`. Its times are those of ranks sharing one card,
   their collectives staged through host memory: no scaling figure.
14. int8 serving and the flat residual stream: every quantized product
   of the B=256 forward (M = 1, 16, 1,024 and 16,384 rows x qkv, the
   attention output, the FFN intermediate and output) on bf16
   activations, the card bit-equal to the CPU (int8 codes, scales, f32
   and bf16 outputs; rows below 17 padded for torch._int_mm); the
   quantized B=256 predict on phase 4's batch (K1-K3 off, as the JAX
   `not q8` gates) held against phase 4's kernels-off and f32
   probabilities and against the f32 quantized model, and its p50 in
   turns with the bf16 default path; the quantized fused-sublayer one at
   256 px (K4 1); single requests on a quantized checkpoint through
   `load_predictor` and the MicroBatcher (the padded rows counted); and
   the text tower with text_encoder.flat_residual on against off on the
   same weights and unpacked rows, bit-equal, K1 12 (fused: K3 11, K2 11,
   K1 1).
15. `entry()` (entry.py, the counterpart of
   `__graft_entry__.entry()`) on the card, its forward at B=8, T=128 on
   256-px uint8 images launching K1 12 times (11 at the 1,024 token
   rows, once at the 8 CLS rows) and K2-K4 never, held against every
   kernel forced off and against an f32 copy at phase 4's limits, and
   its p50 over 20 calls after 3 warm-ups.
16. f32 serving: the full-width default and fused-sublayer models under
   training.compute_dtype=float32 (TF32 off) at B=256, launching K1-f32
   12 times (default), or K3-f32 11, K2-f32 11, K1-f32 1 and K4 1
   (fused), no bf16 kernel and nothing on the gates' plain version; the
   probabilities held against the same model with every kernel forced
   off (max and mean |dprob|, top-1 256/256); a few requests through the
   MicroBatcher; the p50 of each path with the kernels and forced off, in
   turns; and each f32 kernel against its plain version at the f32
   paths' shapes beside its bound, K3-f32 also against the classic f32
   linear + add + LayerNorm chain, with its GEMM's plan (row tiles x
   slices) at 64 rows and at the packed count.

17. BERT-large width (H = 1,024, F = 4,096, 16 heads, 24 layers;
   `LARGE_OVER`, the default config's `text_encoder.*` overridden, as
   `--set` does on the CLIs): each H = 1,024 form of K1, K2 and K3, in
   bf16 and f32, against its plain version at M = 1, 64, 1,024, 16,384
   and 16,385, and timed at the packed count beside its bound; the
   24-layer tower from seeded weights through `predict_batch` at B=256 on
   phase 4's pairs, on the default path (K1 24 per forward: 23 at the
   packed rows, 1 at the 1,024 CLS rows) and the fused-sublayer one (K3
   23, K2 23, K1 1, K4 1), in bf16 (held against every kernel forced
   off and against the f32 model at phase 4's limits; one MicroBatcher
   round on the default path) and in f32 (the f32 forms; within
   PROB_ATOL_F32_KERNELS of every kernel forced off, top-1 256/256), and
   the p50 of each.
18. the compact widths (google-research/bert's BERT-Medium, BERT-Mini and
   BERT-Tiny: H = 512, 256 and 128, F = 4H, heads of 64, 8, 4 and 2
   layers, the uncased vocabulary of 30,522; `COMPACT_OVER`): phase 17 at
   each of them, at full width and depth (K1 8 / 4 / 2 per default
   forward; K3 and K2 7 / 3 / 1 and K1 1 and K4 1 per fused one), the
   MicroBatcher round at H = 512 only. At 256 and 128 it also times K1-f32
   and K2-f32 at the packed batch in their one-pass form against the four
   launches forced, in turns, and fails unless the f32 towers' packed-row
   launches took the one-pass form and the CLS layer's the four launches.
19. the odd multiples of 128 below 1,024 (H = 384, 640 and 896; `ODD_OVER`):
   phase 17 at microsoft/MiniLM-L12-H384's widths at full width and depth
   (12 layers, 12 heads of 32, F = 1,536, the uncased vocabulary of
   30,522; K1 12 per default forward, K3 11, K2 11, K1 1 and K4 1 per
   fused one; one MicroBatcher round), and at H = 640 and 896 (heads of
   64, F = 4H), which no published encoder has, at 4 layers. Phases 18
   and 19 print K3-f32's time at 128-640 beside 6b702b9's three-launch
   form and the form the launch took (the pass over whole rows at the
   packed batch), K3's at 640 in its overlapped form beside the one-block
   form forced (in turns) and 1a815bf's time, and K3's at 128 in its tile
   form (the width's only form) beside 1a815bf's time, and fail unless the
   fused towers' packed-row K3 launches at 640 took the overlapped form
   and those at 128 the tile form.
20. above BERT-large width (H = 1,152, 1,280, 1,408 and 1,536; `WIDE_OVER`):
   phase 17 at microsoft/deberta-v2-xlarge's widths and depth with this
   package's BERT layer (H = 1,536, F = 6,144, 24 heads of 64, 24 layers,
   the vocabulary of 128,100; K1 24 per default forward, K3 23, K2 23, K1
   1 and K4 1 per fused one; one MicroBatcher round), and at H = 1,152,
   1,280 and 1,408 (18, 20 and 22 heads of 64, F = 4H), which no published
   encoder has, at 2 layers.

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
# K1-K3 in f32 against their plain versions (TF32 off): f32-accurate
# products (three TF32 products on the tensor cores, the GEMM of
# csrc/gemm_tf32x3.cuh) summed in another order, then LayerNorm. An H100
# read up to 1.9e-5 max and 9.3e-7 mean for K1-f32 and K2-f32 (the tensor
# cores' sums rounded into an f32 total every 256 of k), and up to 1.4e-5
# / 7.0e-7 for the FFMA K3-f32 that the same GEMM replaced; the plain
# version with its operands rounded to TF32 (10-bit
# mantissa) read 1.7e-3-3.2e-3 max and 1.8e-4-3.1e-4 mean (PERF.md), so
# these limits tell f32 from TF32, which phases 3 and 3b check on the
# card.
ROW_F32_ATOL = 1e-4
ROW_F32_MEAN_ATOL = 1e-5
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
# phase 16: the f32 model with the f32 kernels against the same model with
# every kernel off, both f32 with TF32 off: the same f32 sums in another
# order through 12 layers. An H100 read 2.2e-7 (default) and 2.1e-7
# (fused) (PERF.md); the limit gives them 9x of margin and sits 500x
# inside the top-k contract's 1e-3
PROB_ATOL_F32_KERNELS = 2e-6
BATCH = 256
TIMED_RUNS = 10
# phase 3's row counts besides the packed one: the single request (1, then
# its length bucket 64), a ragged tile, the CLS-only last layer at B=256
# and a mid size
PHASE3_ROWS = (1, 37, 64, 1024, 4096)
# and for the f32 forms, a ragged tile of the 128-row GEMMs of K1-f32 and
# K2-f32 past the packed count
PHASE3_F32_ROWS = (16385,)
# phase 6's extra K1 row counts: the CLS-only last layer, the single request
SMALL_ROWS = (1024, 64, 1)
# published H100 SXM peaks at 700 W (NVIDIA's data sheet): dense bf16
# and TF32 tensor-core rates, f32 rate outside the tensor cores, HBM3 rate
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# f32-accurate products on the tensor cores take three TF32 products
# (a_hi b_hi + a_hi b_lo + a_lo b_hi), so the f32 forms of K1-K3 are
# bounded by 3x their operations at the TF32 rate
TF32_PASSES = 3


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


# the hidden widths other than BERT-base's 768 whose forms of K1-K3 have
# launch counters of their own: BERT-large's (phase 17), the compact
# BERTs' (phase 18), the odd multiples of 128 (phase 19) and the widths
# above 1,024 (phase 20)
OTHER_WIDTHS = (1024, 512, 256, 128, 384, 640, 896, 1152, 1280, 1408, 1536)
ROW_KEYS = ("K1", "K2", "K3", "K1_f32", "K2_f32", "K3_f32")
# the launch counts: K1-K4 (the bf16 kernels, and K4 in either output
# dtype), their f32 forms, the forms of K1-K3 in bf16 and f32 at each of
# OTHER_WIDTHS (`<key>_<width>`), and the calls the gates sent to plain on
# CUDA
COUNT_KEYS = (("K1", "K2", "K3", "K4", "K1_f32", "K2_f32", "K3_f32")
              + tuple(f"{k}_{w}" for w in OTHER_WIDTHS for k in ROW_KEYS)
              + ("plain_on_cuda",))


def count_dict(**counts):
    """A launch-count dict: `counts`, every other key 0."""
    if set(counts) - set(COUNT_KEYS):
        raise KeyError(f"unknown launch counts {sorted(counts)}")
    return {k: counts.get(k, 0) for k in COUNT_KEYS}


def launch_counters():
    """{count key: (module, counter name)} of every kernel's launch
    counter: K1 / K2 (and their f32 forms) in kernels/ffn.py, K3 in
    kernels/attn_out.py, K4 in kernels/image.py, each width's with the
    width's suffix."""
    ffn, attn_out, image = kernel_modules()
    counters = {"K4": (image, "LAUNCHES")}
    for w in ("",) + tuple(f"_{w}" for w in OTHER_WIDTHS):
        counters.update({
            f"K1{w}": (ffn, f"LAUNCHES_K1{w}"),
            f"K2{w}": (ffn, f"LAUNCHES_K2{w}"),
            f"K3{w}": (attn_out, f"LAUNCHES{w}"),
            f"K1_f32{w}": (ffn, f"LAUNCHES_K1_F32{w}"),
            f"K2_f32{w}": (ffn, f"LAUNCHES_K2_F32{w}"),
            f"K3_f32{w}": (attn_out, f"LAUNCHES_F32{w}")})
    return counters


def launch_counts():
    """The launches of each kernel and the calls the gates sent to plain
    on CUDA, as a count_dict."""
    mods = kernel_modules()
    return count_dict(
        **{k: getattr(mod, name) for k, (mod, name)
           in launch_counters().items()},
        plain_on_cuda=sum(mod.PLAIN_ON_CUDA for mod in mods))


def reset_counts():
    for mod, name in launch_counters().values():
        setattr(mod, name, 0)
    for mod in kernel_modules():
        mod.PLAIN_ON_CUDA = 0


def bound_ms(bytes_moved: float, ops: float, peak_ops: float):
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over their peak rate."""
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = ops / peak_ops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def product_bound(ops: float, elem: int):
    """The operations' part of a product's bound: bf16 products (elem
    2) at the bf16 tensor-core rate; f32-accurate ones (elem 4) as
    TF32_PASSES TF32 products at the TF32 rate, the least the card needs
    for them (FFMA on the CUDA cores, at the f32 rate, takes 2.5x as
    long)."""
    return ((ops, PEAK_BF16_FLOPS) if elem == 2
            else (TF32_PASSES * ops, PEAK_TF32_FLOPS))


def ffn_bound(m: int, h: int, f: int, vec_bytes: int, input_ln: bool,
              elem: int = 2):
    """K1/K2: x in and y out [m, h], W1 and W2, in `elem`-byte values
    (bf16 2, f32 4), the vectors; the two products by `product_bound`
    (the f32 GELU and LayerNorm work, under 5% of it, is left out)."""
    n_vec = f + (5 if input_ln else 3) * h
    return bound_ms(elem * 2 * m * h + elem * 2 * h * f + vec_bytes * n_vec,
                    *product_bound(4.0 * m * h * f, elem))


def attn_out_bound(m: int, h: int, vec_bytes: int, elem: int = 2):
    """K3: ctx and x in, y out [m, h], Wo, in `elem`-byte values, three
    vectors; the product by `product_bound`."""
    return bound_ms(3 * elem * m * h + elem * h * h + vec_bytes * 3 * h,
                    *product_bound(2.0 * m * h * h, elem))


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
    totals = count_dict()

    counted = partial(count_launches, totals=totals)

    def per_batch(k1=0, k2=0, k3=0, k4=0, batches=1):
        return count_dict(K1=k1 * batches, K2=k2 * batches,
                          K3=k3 * batches, K4=k4 * batches)

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
                        count_dict(), f"f32 step on {where.type}")
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

    totals = count_dict()

    counted = partial(count_launches, totals=totals)

    def counts(k1=0, k2=0, k3=0):
        return count_dict(K1=k1, K2=k2, K3=k3)

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
    totals = count_dict()

    counted = partial(count_launches, totals=totals)

    def counts(k1=0):
        return count_dict(K1=k1)

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
        if n == 0:
            fail(f"{PRESET} train() drew no augmentation through "
                 f"draw_train_params")
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
    totals = count_dict()
    counted = partial(count_launches, totals=totals)
    cfg = resolve_config("default")
    n_layers = cfg.text_encoder.num_layers

    def counts(k1=0):
        return count_dict(K1=k1)

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


# phase 13: the rank mesh (parallel/). The ranks share this one card over
# gloo (NCCL refuses two ranks on one device), so their collectives are
# staged through host memory and their times are no scaling figure.
MESH_SHAPES = ((2, 1), (1, 2))
# the mesh train steps: full width in f32 (TF32 off), SGD, this global
# batch of seeded pairs, these rates. Limits per mesh: (loss rtol,
# parameters, BatchNorm statistics). 1x2 at the CPU tests' limits
# (tests/test_torch_parallel_train.py): the same batch on each rank, and
# an H100 read it at the card's own run-to-run spread (1x1 against 1x1:
# parameters 2.1e-6 to 2.9e-6, statistics 2.5e-6 to 3.5e-6). 2x1 splits
# the batch, so BatchNorm's Σx and Σx² are sums in another order: an
# H100 read losses 1.05e-4 relative at the second step, parameters
# 2.1e-5, statistics 3.0e-4 of running variances up to ~2. On one rank,
# with no process group, changing only the rounding of BatchNorm's
# statistics moves the two steps as far, and running every conv, linear
# and embedding at 2x1's half-batch shapes does not
# (build/mesh_train_witness.py; PERF.md §6): its limits are those
# readings with margin
MESH_TRAIN_BATCH = 8
MESH_TRAIN_LRS = (1e-2, 5e-3)
MESH_TRAIN_LIMITS = {(1, 2): (2e-5, 1e-5, 1e-5), (2, 1): (5e-4, 1e-4, 1e-3)}
# the 1x1 mesh over NCCL against phase 4's predictor: the same kernels on
# the same rows, so the same probabilities
MESH_1X1_ATOL = 1e-6
# the int8 predict on 1x2 against the 1x1 mesh: the same int8 codes and
# int32 sums (maxima and integer sums over the model axis), and attention
# per head; the first H100 run read 0 (PERF.md §6, int8 serving)
MESH_Q8_ATOL = 1e-6
MESH_TIMED_RUNS = 3
MESH_RANK_TIMEOUT_S = 600.0


def mesh_train_config():
    from multimodal_rare_disease_tpu_torch.config import resolve_config

    return resolve_config("default", {
        "training.compute_dtype": "float32", "training.optimizer": "sgd",
        "training.weight_decay": 0.0,
        "training.batch_size": MESH_TRAIN_BATCH,
        "evaluation.eval_batch_size": MESH_TRAIN_BATCH})


def mesh_train_batches(cfg):
    """The global host batches of the mesh train steps, and a
    validation batch: seeded pairs, tokenized at the config's length."""
    import numpy as np

    from multimodal_rare_disease_tpu_torch.data.tokenizer import (
        get_tokenizer,
    )
    from multimodal_rare_disease_tpu_torch.inference.seeded_batch import (
        seeded_requests,
    )

    n = MESH_TRAIN_BATCH
    images, texts = seeded_requests(n * (len(MESH_TRAIN_LRS) + 1), seed=5)
    ids, mask, _ = get_tokenizer().encode_batch(texts,
                                                cfg.data.max_text_length)
    labels = np.random.default_rng(5).integers(0, cfg.num_classes,
                                               len(texts))
    out = []
    for i in range(len(MESH_TRAIN_LRS) + 1):
        rows = slice(i * n, (i + 1) * n)
        out.append({"labels": labels[rows], "images": np.stack(images[rows]),
                    "input_ids": ids[rows].astype(np.int64),
                    "attention_mask": mask[rows].astype(np.int64),
                    "valid": np.ones(n, np.float32)})
    return out[:-1], out[-1]


def mesh_steps(trainer, batches, dev):
    """The train steps on the device batches: (losses, ms per step,
    launches during the steps)."""
    import torch

    losses, ms = [], []
    reset_counts()
    for lr, host in zip(MESH_TRAIN_LRS, batches):
        b = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(trainer.train_step(b, lr)["loss"]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, ms, launch_counts()


def mesh_rank(rank, world, device, ref_path, ref_losses, fused_over):
    """One of two ranks on `device` (phase 13 b and d): the B=256 predict
    on a 2x1 and a 1x2 mesh and the fused-sublayer and int8 ones on 1x2,
    each with its launches and p50; then two f32 train steps on each mesh
    against the 1x1 run's losses and state, and a bf16 validation
    batch."""
    import numpy as np
    import torch

    from multimodal_rare_disease_tpu_torch.config import resolve_config
    from multimodal_rare_disease_tpu_torch.inference.predictor import (
        MultimodalPredictor,
    )
    from multimodal_rare_disease_tpu_torch.inference.seeded_batch import (
        seeded_requests,
    )
    from multimodal_rare_disease_tpu_torch.kernels import build
    from multimodal_rare_disease_tpu_torch.models.classifier import (
        create_model,
    )
    from multimodal_rare_disease_tpu_torch.parallel.mesh import create_mesh
    from multimodal_rare_disease_tpu_torch.parallel.tp import (
        gather_state_dict,
    )
    from multimodal_rare_disease_tpu_torch.train.trainer import Trainer

    dev = torch.device(device)
    torch.cuda.set_device(dev)
    ref_state = torch.load(ref_path, weights_only=True)
    build.build()  # the parent built it: found, not rebuilt
    build.load_library(dev)
    images, texts = seeded_requests(BATCH, seed=0)
    out = {"predict": {}, "train": {}}
    for kind, over, shapes in (("default", {}, MESH_SHAPES),
                               ("fused", fused_over, ((1, 2),)),
                               ("q8", Q8, ((1, 2),))):
        cfg = resolve_config("default", over)
        whole = create_model(cfg, device="cpu", seed=0).state_dict()
        for d, m in shapes:
            mesh = create_mesh(cfg, data_axis=d, model_axis=m,
                               devices=[dev] * world)
            model = create_model(cfg, device="cpu", seed=None)
            model.load_state_dict(whole)
            pred = MultimodalPredictor(cfg, model, mesh=mesh)
            reset_counts()
            res = pred.predict_batch(images, texts)
            torch.cuda.synchronize()
            counts = launch_counts()
            mine = mesh.rows(BATCH)
            ids, mask = pred._prep_texts(texts[mine], mine.stop - mine.start)
            packed = pred._packed_inputs(ids, mask)
            lat = []
            for _ in range(MESH_TIMED_RUNS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pred.predict_batch(images, texts)
                torch.cuda.synchronize()
                lat.append((time.perf_counter() - t0) * 1e3)
            out["predict"][(kind, d, m)] = {
                "probs": probs_of(res, pred.class_names) if rank == 0
                else None,
                "counts": counts, "packed_calls": pred.packed_calls,
                "packed_m": None if packed is None else packed[0].size,
                "p50_ms": float(np.median(lat))}
            del pred, model
            torch.cuda.empty_cache()
    cfg = mesh_train_config()
    # the validation copy in the default compute dtype, bf16
    cfg16 = resolve_config("default", {
        "training.batch_size": MESH_TRAIN_BATCH,
        "evaluation.eval_batch_size": MESH_TRAIN_BATCH})
    batches, val = mesh_train_batches(cfg)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for d, m in MESH_SHAPES:
        mesh = create_mesh(cfg, data_axis=d, model_axis=m,
                           devices=[dev] * world)
        tr = Trainer(cfg, "multimodal", device=dev, mesh=mesh)
        losses, ms, counts = mesh_steps(tr, batches, dev)
        state = gather_state_dict(tr.model, mesh)
        d_param = max(float((state[k] - ref_state[k]).abs().max())
                      for k in ref_state if ".running_" not in k)
        d_stats = max(float((state[k] - ref_state[k]).abs().max())
                      for k in ref_state if ".running_" in k)
        # a bf16 validation batch on the trained weights: the kernels run
        ev = Trainer(cfg16, "multimodal", device=dev, mesh=mesh)
        ev.init_state()
        ev.model.load_state_dict(tr.model.state_dict())
        ev.sync_eval_model()
        vb = {k: torch.from_numpy(v).to(dev) for k, v in val.items()}
        reset_counts()
        sums = ev.eval_step(vb)
        torch.cuda.synchronize()
        out["train"][(d, m)] = {
            "losses": losses, "ms": ms, "step_counts": counts,
            "d_param": d_param, "d_stats": d_stats,
            "loss_rel": max(abs(a - b) / abs(b)
                            for a, b in zip(losses, ref_losses)),
            "val_counts": launch_counts(), "val_count": float(sums["count"]),
            "qkv_rows": tr.model.text_encoder.bert.layer0.attention.qkv
            .weight.shape[0]}
        del tr, ev, state
        torch.cuda.empty_cache()
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32
    return out


def serve_mesh(dev, workdir: Path):
    """Phase 13 c: `cli/serve.py --mesh 2x1 --backend gloo` on a seeded
    full-width text_only checkpoint (the card's machine has no image
    decoder, so requests carry text only): 8 concurrent requests and 3
    single ones over HTTP, against the single-device predictor."""
    import os
    import signal
    import socket
    import urllib.request

    import numpy as np

    from multimodal_rare_disease_tpu_torch.config import resolve_config
    from multimodal_rare_disease_tpu_torch.inference.predictor import (
        load_predictor,
    )
    from multimodal_rare_disease_tpu_torch.inference.seeded_batch import (
        seeded_requests,
    )
    from multimodal_rare_disease_tpu_torch.models.classifier import (
        create_model,
    )
    from multimodal_rare_disease_tpu_torch.utils.checkpoint import (
        save_checkpoint,
    )

    cfg = resolve_config("default")
    ckpt = workdir / "text_only_ckpt"
    save_checkpoint(ckpt, create_model(cfg, "text_only", "cpu",
                                       seed=0).state_dict(),
                    meta={"config": cfg.to_dict(), "mode": "text_only"})
    _, texts = seeded_requests(11, seed=2)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    url = f"http://127.0.0.1:{port}"
    t0 = time.perf_counter()
    log = open(workdir / "serve_mesh.log", "w")
    # the server imports the package this script drives
    import multimodal_rare_disease_tpu_torch as pkg

    root = str(Path(pkg.__file__).resolve().parent.parent)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    proc = subprocess.Popen(
        [sys.executable, "-m", "multimodal_rare_disease_tpu_torch.cli.serve",
         "--checkpoint", str(ckpt), "--mesh", "2x1", "--backend", "gloo",
         "--device", dev.type, "--port", str(port), "--window-ms", "50"],
        cwd=HERE, env=env, stdout=log, stderr=subprocess.STDOUT,
        start_new_session=True)

    def get(path, body=None):
        req = urllib.request.Request(
            url + path, data=None if body is None else json.dumps(
                body).encode(), headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            return json.loads(r.read())

    try:
        deadline = time.monotonic() + 300
        while True:
            if proc.poll() is not None:
                fail(f"serve --mesh exited with {proc.returncode}: "
                     f"{(workdir / 'serve_mesh.log').read_text()[-2000:]}")
            try:
                health = get("/healthz")
                break
            except OSError:
                if time.monotonic() > deadline:
                    fail("serve --mesh did not come up in 300 s")
                time.sleep(1.0)
        up_s = time.perf_counter() - t0
        if health.get("mesh") != {"data": 2, "model": 1}:
            fail(f"serve --mesh /healthz: {health}")
        with ThreadPoolExecutor(8) as ex:
            answers = list(ex.map(lambda t: get("/predict", {
                "text": t, "top_k": 3}), texts[:8]))
        answers += [get("/predict", {"text": t, "top_k": 3})
                    for t in texts[8:]]
        calls = get("/healthz")["batch_calls"]
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            rc = proc.wait()
        log.close()
    if rc != 0:
        fail(f"serve --mesh ended with {rc}")
    for a in answers:
        if set(a) != {"predictions", "top_prediction", "all_probabilities"} \
                or len(a["predictions"]) != 3:
            fail(f"serve --mesh answer breaks the JSON contract: {a}")
    single = load_predictor(ckpt, dev)
    want = probs_of(single.predict_batch(texts=texts), single.class_names)
    got = probs_of(answers, single.class_names)
    d = float(np.abs(got - want).max())
    top1 = int((got.argmax(1) == want.argmax(1)).sum())
    if d > PROB_ATOL_PLAIN or top1 != len(texts):
        fail(f"serve --mesh answers differ from one device: max|dprob| "
             f"{d}, top-1 equal in {top1}/{len(texts)}")
    return (f"{len(answers)} answers in {calls} forwards, up in "
            f"{up_s:.1f} s; max|dprob| from the single-device predictor "
            f"{d:.3e} (tolerance {PROB_ATOL_PLAIN}), top-1 equal "
            f"{top1}/{len(texts)}")


def mesh_phase(dev, card: str, probs4, refs, fused_over):
    """Phase 13; returns the launches of its counted runs (the 1x1 NCCL
    predict and every rank's predicts and validation batches)."""
    import tempfile

    import numpy as np
    import torch

    from multimodal_rare_disease_tpu_torch.config import resolve_config
    from multimodal_rare_disease_tpu_torch.inference.predictor import (
        MultimodalPredictor,
    )
    from multimodal_rare_disease_tpu_torch.inference.seeded_batch import (
        seeded_requests,
    )
    from multimodal_rare_disease_tpu_torch.models.classifier import (
        create_model,
    )
    from multimodal_rare_disease_tpu_torch.parallel import distributed
    from multimodal_rare_disease_tpu_torch.parallel.dryrun import (
        dryrun_multichip,
    )
    from multimodal_rare_disease_tpu_torch.parallel.mesh import create_mesh
    from multimodal_rare_disease_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    totals = count_dict()
    n_layers = resolve_config("default").text_encoder.num_layers
    label = "2 ranks sharing one card over gloo, collectives through host"
    work = Path(tempfile.mkdtemp(prefix="mesh_", dir=HERE / "build"))

    # ---- a: a 1x1 mesh over NCCL (a real process group of one)
    distributed.maybe_initialize(distributed.file_init_method(str(work)),
                                 1, 0, "nccl")
    try:
        cfg = resolve_config("default")
        mesh = create_mesh(cfg, devices=[dev])
        pred = MultimodalPredictor(cfg, create_model(cfg, device="cpu",
                                                     seed=0), mesh=mesh)
        images, texts = seeded_requests(BATCH, seed=0)
        res = count_launches(lambda: pred.predict_batch(images, texts),
                             count_dict(K1=n_layers), "1x1 NCCL mesh", totals)
        d11 = float(np.abs(probs_of(res, pred.class_names) - probs4).max())
        if d11 > MESH_1X1_ATOL:
            fail(f"1x1 NCCL mesh: max|dprob| {d11} from phase 4")
        del pred
        # the int8 predict on the 1x1 mesh: the reference of 1x2's
        cfg_q = resolve_config("default", Q8)
        pred = MultimodalPredictor(cfg_q, create_model(cfg_q, device="cpu",
                                                       seed=0), mesh=mesh)
        probs_q11 = probs_of(count_launches(
            lambda: pred.predict_batch(images, texts),
            count_dict(),
            "1x1 NCCL mesh, int8", totals), pred.class_names)
        del pred
        torch.cuda.empty_cache()
    finally:
        distributed.shutdown()
    print(f"[13 mesh 1x1] {card} | NCCL process group of one: B={BATCH} "
          f"launches K1 {n_layers}, max|dprob| from phase 4 {d11:.3e} "
          f"(tolerance {MESH_1X1_ATOL}); the int8 predict launches nothing")

    # ---- d (reference): two f32 steps on one rank, TF32 off
    cfg_t = mesh_train_config()
    batches, _ = mesh_train_batches(cfg_t)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        runs = []
        for _ in range(2):  # twice: the card's own run-to-run spread
            tr = Trainer(cfg_t, "multimodal", device=dev)
            runs.append(mesh_steps(tr, batches, dev) + ({
                k: v.detach().cpu() for k, v in tr.model.state_dict().items()},))
            del tr
            torch.cuda.empty_cache()
        (ref_losses, ref_ms, ref_counts, ref_state), again = runs
        spread = (max(abs(a - b) / b for a, b in zip(again[0], ref_losses)),
                  max(float((again[3][k] - v).abs().max())
                      for k, v in ref_state.items() if ".running_" not in k),
                  max(float((again[3][k] - v).abs().max())
                      for k, v in ref_state.items() if ".running_" in k))
        # to the ranks by file: a spawned rank's tensor arguments would
        # travel through shared memory, which a container may keep small
        ref_path = work / "mesh_ref_state.pt"
        torch.save(ref_state, ref_path)
        again_counts = again[2]
        del runs, again
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    if ref_counts != {k: 0 for k in totals} \
            or again_counts != {k: 0 for k in totals}:
        fail(f"1x1 train steps launched {ref_counts}, {again_counts}")

    # ---- b and d: two ranks on this card over gloo
    t0 = time.perf_counter()
    outs = distributed.run_ranks(
        mesh_rank, 2, backend="gloo",
        args=(str(dev), str(ref_path), ref_losses, fused_over),
        timeout_s=MESH_RANK_TIMEOUT_S, init_dir=str(work))
    ranks_s = time.perf_counter() - t0
    plain, f32 = refs["default path"]
    plain7, f32_7 = refs["fused-sublayer path"]
    lines = []
    for (kind, d, m), r0 in outs[0]["predict"].items():
        want = {"fused": count_dict(K1=1, K2=n_layers - 1,
                                    K3=n_layers - 1, K4=1),
                "q8": count_dict()}.get(kind, count_dict(K1=n_layers))
        for rank, o in enumerate(outs):
            r = o["predict"][(kind, d, m)]
            if r["counts"] != want or r["packed_calls"] < 1:
                fail(f"{kind} {d}x{m} rank {rank}: launches {r['counts']} "
                     f"(packed {r['packed_calls']}), want {want}")
            for k, v in r["counts"].items():
                totals[k] += v
        probs = r0["probs"]
        if kind == "q8":
            d_q = np.abs(probs - probs_q11)
            top1 = int((probs.argmax(1) == probs_q11.argmax(1)).sum())
            if d_q.max() > MESH_Q8_ATOL:
                fail(f"int8 1x2: max|dprob| {d_q.max()} from the 1x1 mesh")
            lines.append(
                f"int8 1x2: launches per rank {r0['counts']}; max|dprob| vs "
                f"the int8 1x1 NCCL mesh {d_q.max():.3e} mean "
                f"{d_q.mean():.3e} (tolerance {MESH_Q8_ATOL}), top-1 "
                f"{top1}/{BATCH}; predict_batch p50 {r0['p50_ms']:.1f} ms")
            continue
        p_ref, f_ref = (plain7, f32_7) if kind == "fused" else (plain, f32)
        d_kp = float(np.abs(probs - p_ref).max())
        d_kr = float(np.abs(probs - f_ref).max())
        top1 = int((probs.argmax(1) == p_ref.argmax(1)).sum())
        if d_kp > PROB_ATOL_PLAIN or d_kr > PROB_ATOL_F32:
            fail(f"{kind} {d}x{m}: max|dprob| {d_kp} from kernels off, "
                 f"{d_kr} from f32")
        rows = [o["predict"][(kind, d, m)]["packed_m"] for o in outs]
        lines.append(
            f"{kind} {d}x{m}: launches per rank {r0['counts']} (K1/K2 rows "
            f"per rank {rows}); max|dprob| vs kernels off {d_kp:.3e} "
            f"(tolerance {PROB_ATOL_PLAIN}), vs f32 {d_kr:.3e} (tolerance "
            f"{PROB_ATOL_F32}), top-1 = kernels off {top1}/{BATCH}; "
            f"predict_batch p50 {r0['p50_ms']:.1f} ms")
    print(f"[13 mesh predict] {card} | {label} | " + " || ".join(lines))

    train_lines = []
    for (d, m), r0 in outs[0]["train"].items():
        for rank, o in enumerate(outs):
            r = o["train"][(d, m)]
            if r["step_counts"] != {k: 0 for k in totals}:
                fail(f"{d}x{m} train steps launched {r['step_counts']}")
            want = count_dict(K1=n_layers)
            if r["val_counts"] != want or r["val_count"] != MESH_TRAIN_BATCH:
                fail(f"{d}x{m} rank {rank} validation: launches "
                     f"{r['val_counts']}, count {r['val_count']}")
            for k, v in r["val_counts"].items():
                totals[k] += v
        loss_tol, param_tol, stats_tol = MESH_TRAIN_LIMITS[(d, m)]
        if r0["loss_rel"] > loss_tol or r0["d_param"] > param_tol \
                or r0["d_stats"] > stats_tol:
            fail(f"{d}x{m} train steps vs 1x1: loss rel {r0['loss_rel']}, "
                 f"params {r0['d_param']}, BatchNorm statistics "
                 f"{r0['d_stats']}")
        train_lines.append(
            f"{d}x{m}: losses {r0['losses']} (rel diff {r0['loss_rel']:.2e}"
            f", limit {loss_tol}), max|dparam| {r0['d_param']:.2e} "
            f"({param_tol}), BatchNorm statistics {r0['d_stats']:.2e} "
            f"({stats_tol}), ms per step "
            f"{[round(t, 1) for t in r0['ms']]}, bf16 validation K1 "
            f"{r0['val_counts']['K1']} per rank")
    print(f"[13 mesh train] {card} | {label} | f32, SGD, TF32 off, global "
          f"batch {MESH_TRAIN_BATCH}: 1x1 losses {ref_losses}, ms per step "
          f"{[round(t, 1) for t in ref_ms]}; 1x1 run again: loss rel "
          f"{spread[0]:.2e}, max|dparam| {spread[1]:.2e}, BatchNorm "
          f"statistics {spread[2]:.2e} || " + " || ".join(train_lines)
          + f" | the two-rank world took {ranks_s:.1f} s")

    # ---- c: serve --mesh 2x1 over gloo
    print(f"[13 serve --mesh] {card} | 2x1 over gloo, text_only: "
          f"{serve_mesh(dev, work)}")

    # ---- e: the dry run on two ranks of this card
    t0 = time.perf_counter()
    dry = dryrun_multichip(2, device=dev.type, backend="gloo")
    print(f"[13 dryrun] {card} | dryrun_multichip(2): losses "
          f"{dry['losses']}, predict {dry['predict']['rows']} rows on "
          f"{dry['predict']['mesh']} in {time.perf_counter() - t0:.1f} s | "
          f"phase 13 took {time.perf_counter() - t_phase:.1f} s")
    return totals


# phase 14: int8 serving (text_encoder.quantized_inference, models/quant.py)
# and the flat residual stream (text_encoder.flat_residual)
Q8 = {"text_encoder.quantized_inference": True}
# the quantized products of the B=256 forward: rows (one request's CLS
# row, a validation batch of 16, the 1,024 CLS rows, phase 4's packed
# rows) x (K, N) of qkv, the attention output, the FFN intermediate and
# the FFN output
Q8_ROWS = (1, 16, 1024, 16384)
Q8_DENSE = ((768, 2304), (768, 768), (768, 3072), (3072, 768))
# the quantized B=256 predict against the bf16 kernels-off path and the
# f32 model (phase 4's references) and against the f32 quantized model:
# int8 rounding on top of bf16's own noise (ROADMAP O1; the TPU read
# 3.0e-3 / 6.0e-4 against bf16). The first H100 run read at most 4.543e-3
# max and 8.04e-4 mean over the six comparisons of the default and fused
# configurations, and 253/256 top-1 at the least (PERF.md §6, int8):
# the limits are those readings with half again of margin, and twice the
# top-1 misses
Q8_PROB_ATOL = 7e-3
Q8_PROB_MEAN_ATOL = 1.2e-3
Q8_TOP1_MIN = 250
# single requests through the MicroBatcher on a quantized checkpoint, at
# the serve CLI's default window
Q8_SERVE_REQUESTS = 10
Q8_SERVE_WINDOW_MS = 5.0


def quantized_and_flat(dev, card: str, images, texts, refs, p50_ms):
    """Phase 14; returns the launches of its counted runs."""
    import tempfile

    import numpy as np
    import torch

    from multimodal_rare_disease_tpu_torch.cli.serve import MicroBatcher
    from multimodal_rare_disease_tpu_torch.config import resolve_config
    from multimodal_rare_disease_tpu_torch.inference.predictor import (
        MultimodalPredictor,
        load_predictor,
    )
    from multimodal_rare_disease_tpu_torch.inference.seeded_batch import (
        seeded_requests,
    )
    from multimodal_rare_disease_tpu_torch.models import quant
    from multimodal_rare_disease_tpu_torch.models.classifier import (
        create_model,
    )
    from multimodal_rare_disease_tpu_torch.utils.checkpoint import (
        save_checkpoint,
    )

    t_phase = time.perf_counter()
    totals = count_dict()
    none = dict(totals)
    n_layers = resolve_config("default").text_encoder.num_layers

    # ---- a: every quantized product of the B=256 forward, card vs CPU
    gen = torch.Generator().manual_seed(14)
    cpu = torch.device("cpu")
    padded_dense = 0  # on the card
    for k, n in Q8_DENSE:
        w = torch.randn((n, k), generator=gen) * 0.02
        b = torch.randn((n,), generator=gen) * 0.02
        layers = []  # on the CPU, on the card
        for d in (cpu, dev):
            lin = quant.QuantLinear(k, n, d, quantized=True)
            with torch.no_grad():
                lin.weight.copy_(w)
                lin.bias.copy_(b)
            lin.prepare()
            layers.append(lin)
        if not (torch.equal(layers[0].codes, layers[1].codes.cpu())
                and torch.equal(layers[0].master_bits,
                                layers[1].master_bits.cpu())):
            fail(f"int8 weight codes or scales of {k}->{n} differ between "
                 f"the card and the CPU")
        for m in Q8_ROWS:
            x = torch.randn((m, k), generator=gen).to(torch.bfloat16)
            outs = []
            for lin in layers:
                xd = x.to(lin.weight.device)
                codes, scale, bias = lin.int8_state()
                before = quant.PADDED_CALLS
                outs.append((quant.quant_linear(
                    xd, codes, scale, bias, torch.float32).cpu(),
                    lin.q8(xd).cpu()))
                if lin is layers[1]:
                    padded_dense += quant.PADDED_CALLS - before
            for want, got in zip(*outs):
                if got.shape != (m, n) or not torch.equal(got, want):
                    d = (got.float() - want.float()).abs().max().item()
                    fail(f"quantized {k}->{n} at M={m}: the card is not "
                         f"bit-equal to the CPU (max|diff| {d})")
    # M=1 and M=16, two calls each (f32 and bf16 out), per shape
    if padded_dense != 2 * 2 * len(Q8_DENSE):
        fail(f"{padded_dense} padded _int_mm calls in the dense check, want "
             f"{2 * 2 * len(Q8_DENSE)}")
    print(f"[14 int8 products] {card} | torch._int_mm on bf16 activations, "
          f"f32 weights N(0, 0.02) quantized on each side: M "
          f"{list(Q8_ROWS)} x (K->N) {[f'{k}->{n}' for k, n in Q8_DENSE]}: "
          f"codes, scales and the f32 and bf16 outputs bit-equal card vs CPU "
          f"(rows below {quant.CUDA_MIN_ROWS} padded on the card: "
          f"{padded_dense} calls)")

    # ---- b: the quantized B=256 predict, default and fused at 256 px
    def probs_line(tag, probs, plain, f32):
        d_p = np.abs(probs - plain)
        d_f = np.abs(probs - f32)
        top_p = int((probs.argmax(1) == plain.argmax(1)).sum())
        top_f = int((probs.argmax(1) == f32.argmax(1)).sum())
        if d_p.max() > Q8_PROB_ATOL or d_f.max() > Q8_PROB_ATOL \
                or d_p.mean() > Q8_PROB_MEAN_ATOL \
                or d_f.mean() > Q8_PROB_MEAN_ATOL \
                or min(top_p, top_f) < Q8_TOP1_MIN:
            fail(f"{tag}: max|dprob| {d_p.max()} / {d_f.max()}, mean "
                 f"{d_p.mean()} / {d_f.mean()}, top-1 {top_p} / {top_f}")
        return (f"vs bf16 kernels off max {d_p.max():.3e} mean "
                f"{d_p.mean():.3e} top-1 {top_p}/{BATCH}; vs f32 max "
                f"{d_f.max():.3e} mean {d_f.mean():.3e} top-1 "
                f"{top_f}/{BATCH}")

    cfg_q = resolve_config("default", Q8)
    pred_q = MultimodalPredictor(cfg_q, create_model(cfg_q, device="cpu",
                                                     seed=0), dev)
    if not all(m.codes is not None
               for _, m in quant.quant_layers(pred_q.model)):
        fail("the quantized predictor holds no int8 codes")
    res = count_launches(lambda: pred_q.predict_batch(images, texts), none,
                         "quantized default path", totals)
    probs_q = probs_of(res, pred_q.class_names)
    if probs_q.shape != (BATCH, cfg_q.num_classes) \
            or not np.isfinite(probs_q).all():
        fail(f"bad quantized probabilities: shape {probs_q.shape}")
    line_q = probs_line("quantized default path", probs_q,
                        *refs["default path"])
    # the f32 quantized model on the card (TF32 off, as the f32 reference)
    cfg_q32 = resolve_config("default", {**Q8,
                                         "training.compute_dtype": "float32"})
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        pred_q32 = MultimodalPredictor(
            cfg_q32, create_model(cfg_q32, device="cpu", seed=0), dev)
        probs_q32 = probs_of(pred_q32.predict_batch(images, texts),
                             pred_q.class_names)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    del pred_q32
    d_q32 = np.abs(probs_q - probs_q32)
    top_q32 = int((probs_q.argmax(1) == probs_q32.argmax(1)).sum())
    if d_q32.max() > Q8_PROB_ATOL or d_q32.mean() > Q8_PROB_MEAN_ATOL \
            or top_q32 < Q8_TOP1_MIN:
        fail(f"quantized bf16 vs quantized f32: max {d_q32.max()}, mean "
             f"{d_q32.mean()}, top-1 {top_q32}")
    # p50 in turns quantized, bf16, bf16, quantized (phase 4's weights)
    cfg = resolve_config("default")
    pred_d = MultimodalPredictor(cfg, create_model(cfg, device="cpu",
                                                   seed=0), dev)
    q_a, _ = p50_ms(pred_q)
    d_a, _ = p50_ms(pred_d)
    d_b, _ = p50_ms(pred_d)
    q_b, _ = p50_ms(pred_q)
    print(f"[14 quantized predict] {card} | B={BATCH} on phase 4's batch, "
          f"packed {pred_q.packed_calls > 0}: launches {none} (K1-K3 off "
          f"under int8, the JAX `not q8` gates); {line_q} (limits max "
          f"{Q8_PROB_ATOL}, mean {Q8_PROB_MEAN_ATOL}, top-1 >= "
          f"{Q8_TOP1_MIN}); vs the f32 quantized model max "
          f"{d_q32.max():.3e} mean {d_q32.mean():.3e} top-1 "
          f"{top_q32}/{BATCH} | predict_batch p50 quantized "
          f"{(q_a + q_b) / 2:.2f} ms (runs {q_a:.2f}, {q_b:.2f}) vs bf16 "
          f"default {(d_a + d_b) / 2:.2f} ms (runs {d_a:.2f}, {d_b:.2f})")

    over7 = {"text_encoder.fused_attn_out": True, "data.image_size": 256}
    cfg_qf = resolve_config("default", {**over7, **Q8})
    pred_qf = MultimodalPredictor(cfg_qf, create_model(cfg_qf, device="cpu",
                                                       seed=0), dev)
    res = count_launches(lambda: pred_qf.predict_batch(images, texts),
                         {**none, "K4": 1}, "quantized fused path", totals)
    line_qf = probs_line("quantized fused path",
                         probs_of(res, pred_qf.class_names),
                         *refs["fused-sublayer path"])
    print(f"[14 quantized fused] {card} | B={BATCH}, image_size 256, "
          f"fused_attn_out: launches {{K4: 1, K1-K3: 0}}; {line_qf}")
    del pred_qf

    # ---- c: single requests through the MicroBatcher on a quantized
    # checkpoint (load_predictor, as cli/serve.py): the CLS-only last
    # layer's products take one row, padded for _int_mm
    work = Path(tempfile.mkdtemp(prefix="q8_", dir=HERE / "build"))
    save_checkpoint(work / "ckpt", create_model(
        cfg_q, device="cpu", seed=0).state_dict(),
        meta={"config": cfg_q.to_dict(), "mode": "multimodal"})
    served = load_predictor(work / "ckpt", dev)
    for (_, a), (_, b) in zip(quant.quant_layers(served.model),
                              quant.quant_layers(pred_q.model)):
        if not (torch.equal(a.codes, b.codes)
                and torch.equal(a.master_bits, b.master_bits)):
            fail("the checkpoint's int8 codes differ from the seeded "
                 "model's")
    s_images, s_texts = seeded_requests(Q8_SERVE_REQUESTS, seed=14)
    batcher = MicroBatcher(served, window_ms=Q8_SERVE_WINDOW_MS)
    lat, answers = [], []
    try:
        batcher.submit(s_images[0], s_texts[0], 3)  # warm-up
        reset_counts()
        padded0, rows0 = quant.PADDED_CALLS, quant.PADDED_ROWS
        calls0 = batcher.batch_calls
        for i in range(Q8_SERVE_REQUESTS):
            t0 = time.perf_counter()
            answers.append(batcher.submit(s_images[i], s_texts[i], 3))
            lat.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        counts = launch_counts()
        forwards = batcher.batch_calls - calls0
        padded = quant.PADDED_CALLS - padded0
        padded_rows = quant.PADDED_ROWS - rows0
    finally:
        batcher.close()
    if counts != none:
        fail(f"quantized serving: launches {counts}")
    for k, v in counts.items():
        totals[k] += v
    # the last layer's attention output, FFN intermediate and FFN output
    # take the one CLS row of each single request
    if forwards != Q8_SERVE_REQUESTS or padded != 3 * forwards:
        fail(f"quantized serving: {forwards} forwards, {padded} padded "
             f"_int_mm calls (want 3 per forward)")
    # each answer is the predictor's own answer to that one request
    direct = [served.predict(s_images[i], s_texts[i], top_k=3)
              for i in range(Q8_SERVE_REQUESTS)]
    if answers != direct:
        fail("quantized serving: an answer differs from the predictor's "
             "answer to the same single request")
    del served
    print(f"[14 quantized serve] {card} | {Q8_SERVE_REQUESTS} single "
          f"requests on a quantized checkpoint through the MicroBatcher "
          f"(window {Q8_SERVE_WINDOW_MS} ms): {forwards} forwards, launches "
          f"{counts}, padded _int_mm calls {padded} ({padded_rows} zero rows "
          f"added, {padded_rows // max(padded, 1)} per call); p50 per request "
          f"{float(np.median(lat)):.2f} ms (of {len(lat)}: "
          f"{', '.join(f'{x:.1f}' for x in lat)}); each answer equal to "
          f"the predictor's own for that request")

    # ---- d: the flat residual stream against the classic one, on the
    # same weights and unpacked rows: the same kernels, the same values
    ids, mask = pred_d._prep_texts(texts, BATCH)
    ids, mask = pred_d._dev(ids), pred_d._dev(mask)
    flat_lines = []
    pred_f = MultimodalPredictor(resolve_config("default", over7),
                                 create_model(resolve_config(
                                     "default", over7), device="cpu",
                                     seed=0), dev)
    for tag, p, want in (
            ("default", pred_d, {**none, "K1": n_layers}),
            ("fused", pred_f, {**none, "K1": 1, "K2": n_layers - 1,
                               "K3": n_layers - 1})):
        enc = p.model.text_encoder
        outs = []
        for flat in (False, True):
            enc.bert.flat_residual = flat
            with torch.inference_mode():
                outs.append(count_launches(lambda: enc(ids, mask), want,
                                           f"{tag} flat={flat}", totals))
        enc.bert.flat_residual = False
        if not torch.equal(outs[0], outs[1]):
            d = (outs[0].float() - outs[1].float()).abs().max().item()
            fail(f"{tag}: the flat stream differs from the classic one by "
                 f"{d}")
        flat_lines.append(f"{tag}: launches per forward {want}, text "
                          f"embeddings [{', '.join(map(str, outs[1].shape))}]"
                          f" bit-equal")
    del pred_f, pred_d, pred_q
    torch.cuda.empty_cache()
    print(f"[14 flat residual] {card} | unpacked B={BATCH} x "
          f"{ids.shape[1]} tokens (M={ids.numel()}), flat_residual on vs "
          f"off on the same model: " + "; ".join(flat_lines)
          + f" | phase 14 took {time.perf_counter() - t_phase:.1f} s")
    return totals


# phase 15: `entry()` (entry.py, the counterpart of
# __graft_entry__.entry()): B=8 uint8 images at 256 px, T=128 ids
ENTRY_WARMUP = 3
ENTRY_TIMED_RUNS = 20


def entry_forward(dev, card: str):
    """Phase 15; returns the launches of its counted run."""
    import numpy as np
    import torch

    from multimodal_rare_disease_tpu_torch.config import resolve_config
    from multimodal_rare_disease_tpu_torch.entry import entry
    from multimodal_rare_disease_tpu_torch.models import bert
    from multimodal_rare_disease_tpu_torch.models.classifier import (
        create_model,
    )

    t_phase = time.perf_counter()
    totals = count_dict()
    cfg = resolve_config("default")
    n_layers = cfg.text_encoder.num_layers
    forward, (model, images, ids, mask) = entry(dev)
    b, t = ids.shape

    def run(m=model):
        return forward(m, images, ids, mask).float().cpu().numpy()

    # the main path: K1 in every layer, 11 times at the B*T token rows and
    # once at the B CLS rows of the CLS-only last layer; the 256-px images
    # against the 224-px image_size take the resample, not K4
    rows, wrapper = [], bert.fused_ffn_ln

    def rec(x, *a, **kw):
        rows.append(x.shape[0])
        return wrapper(x, *a, **kw)

    bert.fused_ffn_ln = rec
    try:
        probs = count_launches(run, count_dict(K1=n_layers),
                               "entry()", totals)
    finally:
        bert.fused_ffn_ln = wrapper
    if rows != [b * t] * (n_layers - 1) + [b]:
        fail(f"entry(): K1 row counts {rows}, want {b * t} x "
             f"{n_layers - 1} then {b}")
    if probs.shape != (b, cfg.num_classes) or not np.isfinite(probs).all() \
            or np.abs(probs.sum(1) - 1.0).max() > 1e-3:
        fail(f"entry(): bad probabilities, shape {probs.shape}")
    # the references: every kernel forced off, and an f32 copy of the
    # same seeded weights (its FFN in plain f32; cuDNN without TF32)
    with plain_kernels():
        plain = run()
        model32 = create_model(cfg, "multimodal", dev, seed=0)
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            ref = run(model32)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
    del model32
    d_plain = float(np.abs(probs - plain).max())
    d_f32 = float(np.abs(probs - ref).max())
    d_pr = float(np.abs(plain - ref).max())
    top1 = int((probs.argmax(1) == plain.argmax(1)).sum())
    top1_ref = int((probs.argmax(1) == ref.argmax(1)).sum())
    if d_plain > PROB_ATOL_PLAIN:
        fail(f"entry(): kernel and plain probabilities differ by "
             f"{d_plain}")
    if d_f32 > PROB_ATOL_F32:
        fail(f"entry(): kernel path is {d_f32} from the f32 copy")
    # p50 of forward, host clock, synchronized (it ends in a device->host
    # copy of the probabilities)
    for _ in range(ENTRY_WARMUP):
        run()
    lat = []
    for _ in range(ENTRY_TIMED_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    print(f"[15 entry] {card} | entry() forward B={b}, T={t}, "
          f"{images.shape[1]}-px uint8 -> {cfg.data.image_size}: launches "
          f"{totals} (K1 at rows {rows[0]} x {n_layers - 1}, {rows[-1]}); "
          f"max|dprob| kernels vs plain {d_plain:.3e} (tolerance "
          f"{PROB_ATOL_PLAIN}), kernels vs f32 {d_f32:.3e} (tolerance "
          f"{PROB_ATOL_F32}), plain vs f32 {d_pr:.3e}; top-1 kernels = "
          f"plain in {top1}/{b}, = f32 in {top1_ref}/{b} | p50 "
          f"{float(np.median(lat)):.3f} ms (of {ENTRY_TIMED_RUNS} after "
          f"{ENTRY_WARMUP} warm-ups: {', '.join(f'{x:.2f}' for x in lat)})"
          f" | phase 15 took {time.perf_counter() - t_phase:.1f} s")
    return totals


# phase 17: BERT-large width (google-research/bert's cased_L-24_H-1024_A-16:
# H = 1,024, F = 4,096, 16 heads of 64, 24 layers; the vocabulary stays
# at BERT-large-cased's 28,996), served through the normal entry points
# with these overrides of the default config, from seeded weights
LARGE_OVER = {"text_encoder.hidden_size": 1024, "text_encoder.num_layers": 24,
              "text_encoder.num_heads": 16,
              "text_encoder.intermediate_size": 4096,
              "text_encoder.max_position_embeddings": 512}
# the row counts each form of K1-K3 at phases 17 to 20's widths is held to
# its plain version at: the single request (1, then its length bucket 64),
# the 1,024 CLS rows, the packed batch and a ragged 128-row tile past it
LARGE_ROWS = (1, 64, 1024, 16384, 16385)
# phase 18: the compact widths, google-research/bert's BERT-Medium
# (uncased_L-8_H-512_A-8), BERT-Mini (uncased_L-4_H-256_A-4) and BERT-Tiny
# (uncased_L-2_H-128_A-2) from the "Well-Read Students Learn Better"
# release (Turc et al. 2019): F = 4H, heads of 64, the uncased vocabulary
# of 30,522, 512 positions; full width and depth, seeded weights (no
# compact checkpoint is in the repository), as `text_encoder.*` overrides
COMPACT_OVER = {
    name: {"text_encoder.hidden_size": h, "text_encoder.num_layers": layers,
           "text_encoder.num_heads": h // 64,
           "text_encoder.intermediate_size": 4 * h,
           "text_encoder.max_position_embeddings": 512,
           "text_encoder.vocab_size": 30522}
    for name, h, layers in (("BERT-Medium", 512, 8), ("BERT-Mini", 256, 4),
                            ("BERT-Tiny", 128, 2))}


# phase 19: the odd multiples of 128 below 1,024. microsoft/MiniLM-L12-H384
# (Wang et al. 2020, "MiniLM: Deep Self-Attention Distillation"), a
# post-LN BERT of this package's layer at full width and depth: H = 384, 12
# heads of 32, F = 1,536, 12 layers, the uncased vocabulary of 30,522; and
# the widths 640 and 896, which no published encoder has (heads of 64, F =
# 4H), at 4 layers to keep the phase short: every form of K1-K3 at a width
# runs in each of its layers alike. Seeded weights, as `text_encoder.*`
# overrides of the default config
ODD_OVER = {
    "MiniLM-L12-H384": {"text_encoder.hidden_size": 384,
                        "text_encoder.num_layers": 12,
                        "text_encoder.num_heads": 12,
                        "text_encoder.intermediate_size": 1536,
                        "text_encoder.max_position_embeddings": 512,
                        "text_encoder.vocab_size": 30522},
    **{f"H={h}": {"text_encoder.hidden_size": h,
                  "text_encoder.num_layers": 4,
                  "text_encoder.num_heads": h // 64,
                  "text_encoder.intermediate_size": 4 * h,
                  "text_encoder.max_position_embeddings": 512,
                  "text_encoder.vocab_size": 30522} for h in (640, 896)}}


# phase 20: the widths above BERT-large. microsoft/deberta-v2-xlarge (He
# et al. 2021, "DeBERTa"), the published post-LN encoder whose FFN (erf
# GELU) and attention-output sublayers are this package's, at its widths
# and depth: H = 1,536, F = 6,144, 24 heads of 64, 24 layers, the
# vocabulary of 128,100, 512 positions; its disentangled attention is not
# this package's, so this is a BERT tower at those widths, not DeBERTa.
# And 1,152, 1,280 and 1,408 (heads of 64, F = 4H), which no published
# encoder has, at 2 layers: every form of K1-K3 at a width runs in each of
# its layers alike, and at 4 layers, as phase 19's 640 and 896, the phase
# took 128.5 s and the whole smoke a quarter longer than phases 1-19 (494
# s on the H100). Seeded weights, as `text_encoder.*` overrides of the
# default config
WIDE_OVER = {
    "DeBERTa-v2-xlarge widths": {"text_encoder.hidden_size": 1536,
                                 "text_encoder.num_layers": 24,
                                 "text_encoder.num_heads": 24,
                                 "text_encoder.intermediate_size": 6144,
                                 "text_encoder.max_position_embeddings": 512,
                                 "text_encoder.vocab_size": 128100},
    **{f"H={h}": {"text_encoder.hidden_size": h,
                  "text_encoder.num_layers": 2,
                  "text_encoder.num_heads": h // 64,
                  "text_encoder.intermediate_size": 4 * h,
                  "text_encoder.max_position_embeddings": 512,
                  "text_encoder.vocab_size": 30522}
       for h in (1152, 1280, 1408)}}


# the pair forms' K1 / K2 dev ms at M = 16,384 before their redesign
# (commit be933b6's phases 17, 19 and 20, PERF.md; H100 80GB HBM3, 700 W),
# printed beside this run's: the same card compares the two only in turns
# (build/pair_old_vs_new.py)
PAIR_BEFORE_MS = {896: (1.0754, 1.0600), 1024: (1.2703, 1.2418),
                  1152: (2.0423, 1.9544), 1280: (2.4710, 2.3707),
                  1408: (2.7383, 2.5856), 1536: (3.0806, 3.0508)}
# the one-block forms' below 768 before their redesign (commit 4b349d5's
# phases 18 and 19, PERF.md; H100 80GB HBM3, 700 W), printed the same way
# (build/pair_old_vs_new.py compares them in turns)
NARROW_BEFORE_MS = {128: (0.0543, 0.0505), 256: (0.1094, 0.1071),
                    384: (0.1896, 0.1872), 512: (0.2884, 0.2828),
                    640: (0.4360, 0.4317)}
# K3-f32's dev ms at M = 16,384 before its narrow forms took the pass over
# whole rows (the three-launch form of commit 6b702b9, PERF.md; H100 80GB
# HBM3, 700 W), printed the same way (build/pair_old_vs_new.py --k3f32
# compares them in turns)
F32_NARROW_BEFORE_MS = {128: 0.0237, 256: 0.0498, 384: 0.0879, 512: 0.1278,
                        640: 0.1790}
# K1-f32 / K2-f32's dev ms at M = 16,384 before the one-pass form at 128
# and 256 (the four launches of commit 5e786d2, PERF.md; H100 80GB HBM3,
# 700 W), printed the same way (build/pair_old_vs_new.py --ffnf32
# compares them in turns)
F32_FFN_BEFORE_MS = {128: (0.1043, 0.1025), 256: (0.2408, 0.2389)}
# K3's dev ms at M = 16,384 before its overlapped forms at 128 and 640 (the
# one-block form of commit 1a815bf, PERF.md; H100 80GB HBM3, 700 W),
# printed the same way (build/pair_old_vs_new.py --k3 compares them in
# turns)
K3_NARROW_BEFORE_MS = {128: 0.0079, 640: 0.0529}


def forced_form(call, module, flag: str, value: bool):
    """`call` with a kernel module's form flag `flag` set to `value`:
    kernels/ffn.py's FORCE_F32_ROWS (K1-f32 / K2-f32's one-pass form where
    True, else the four launches) or kernels/attn_out.py's FORCE_OVERLAP
    (K3's overlapped form at 640 where True, else the one-block form)."""
    def forced():
        old = getattr(module, flag)
        setattr(module, flag, value)
        try:
            return call()
        finally:
            setattr(module, flag, old)
    return forced


def resident_clusters(dev, h: int) -> int:
    """The clusters of the bf16 FFN kernel's launch at pair width h that
    the card holds at once (cudaOccupancyMaxActiveClusters), for the
    report: the launch plan counts the SMs, all of which the H100's 66
    pairs fill."""
    import torch

    from multimodal_rare_disease_tpu_torch.kernels import build, ffn

    with torch.cuda.device(dev):
        n = ffn.entry(build.load_library(dev), "mrd_ffn_max_clusters", h)()
    if n <= 0:
        fail(f"H={h}: cudaOccupancyMaxActiveClusters failed ({n})")
    return n


def width_phase(dev, over: dict, seed: int, images, texts, in_turns, p50_ms,
                serve=None):
    """The forms of K1-K3 at the hidden width of `over` (overrides of the
    default config; one of OTHER_WIDTHS) in bf16 and f32 against their
    plain versions at LARGE_ROWS, timed at the packed count beside their
    bounds; the text tower of `over` through `predict_batch` at B=256 on
    the default and the fused-sublayer paths, in bf16 and in f32, each
    against the same weights with every kernel forced off (the bf16 paths
    also against the f32 model); with `serve`, one MicroBatcher round on
    the bf16 default path. Returns (the launches of its counted runs,
    {key: (max|diff|, dev ms, plain ms, (b2b ms, plain b2b ms), bound ms,
    bound by)} of each form, the text of its report, the seconds of the
    kernel checks)."""
    import numpy as np
    import torch

    from multimodal_rare_disease_tpu_torch.config import resolve_config
    from multimodal_rare_disease_tpu_torch.inference.predictor import (
        MultimodalPredictor,
    )
    from multimodal_rare_disease_tpu_torch.models.classifier import (
        create_model,
    )

    k1, k3, _ = kernel_modules()
    t_phase = time.perf_counter()
    totals = count_dict()
    cfg = resolve_config("default", over)
    te = cfg.text_encoder
    h, f, n_layers = te.hidden_size, te.intermediate_size, te.num_layers
    bf, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator().manual_seed(seed)

    def rnd(shape, scale, offset=0.0, dtype=f32):
        return (torch.randn(shape, generator=gen) * scale + offset).to(
            dev, dtype)

    def diff(got, want):
        d = (got.float() - want.float()).abs()
        return d.max().item(), d.mean().item()

    # ---- a: each kernel against its plain version (TF32 off for f32)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    forms = {}  # key -> (kernel call, plain call, bound) at the packed M
    errs = {}
    try:
        for dt, tol in ((bf, (ROW_ATOL, ROW_MEAN_ATOL)),
                        (f32, (ROW_F32_ATOL, ROW_F32_MEAN_ATOL))):
            sfx = f"_{h}" if dt == bf else f"_f32_{h}"
            # drawn in nn.Linear's [out, in] and passed as [in, out] views,
            # as BertLayer passes them; the vectors in the model's dtype
            w1, w2 = rnd((f, h), 0.05, dtype=dt).t(), rnd((h, f), 0.05,
                                                          dtype=dt).t()
            wo = rnd((h, h), 0.05, dtype=dt).t()
            v = dict(b1=rnd((f,), 0.5, dtype=dt), b2=rnd((h,), 0.5, dtype=dt),
                     gamma=rnd((h,), 0.25, 1.0, dtype=dt),
                     beta=rnd((h,), 0.5, dtype=dt),
                     pre_gamma=rnd((h,), 0.25, 1.0, dtype=dt),
                     pre_beta=rnd((h,), 0.5, dtype=dt))
            ln0 = dict(pre_gamma=v["pre_gamma"], pre_beta=v["pre_beta"])
            for m in LARGE_ROWS:
                z, c = rnd((m, h), 1.0, dtype=dt), rnd((m, h), 1.0, dtype=dt)
                a = (z, w1, v["b1"], w2, v["b2"], v["gamma"], v["beta"])
                a3 = (c, z, wo, v["b2"], v["gamma"], v["beta"])
                # the arguments bound now: the f32 round rebinds the names
                calls = {
                    "K1" + sfx: (lambda a=a, ln0=ln0: k1.fused_ffn_ln(
                                     *a, **ln0),
                                 lambda a=a, ln0=ln0: k1.ffn_ln_plain(
                                     *a, input_ln=True, **ln0),
                                 ffn_bound(m, h, f, dt.itemsize, True,
                                           dt.itemsize)),
                    "K2" + sfx: (lambda a=a: k1.fused_ffn_ln(*a),
                                 lambda a=a: k1.ffn_ln_plain(
                                     *a, input_ln=False),
                                 ffn_bound(m, h, f, dt.itemsize, False,
                                           dt.itemsize)),
                    "K3" + sfx: (lambda a3=a3: k3.fused_attn_out_ln(*a3),
                                 lambda a3=a3: k3.attn_out_ln_plain(*a3),
                                 attn_out_bound(m, h, dt.itemsize,
                                                dt.itemsize))}
                for key, (kern, plain, bound) in calls.items():
                    reset_counts()
                    got = kern()
                    torch.cuda.synchronize()
                    if launch_counts() != count_dict(**{key: 1}):
                        fail(f"{key} at M={m}: launches {launch_counts()}, "
                             f"want {key} 1 and nothing else")
                    if not torch.isfinite(got).all() or got.shape != (m, h):
                        fail(f"{key} at M={m}: bad output")
                    e = diff(got, plain())
                    errs.setdefault(key, {})[m] = e
                    if e[0] > tol[0] or e[1] > tol[1]:
                        fail(f"{key} disagrees with its plain version at "
                             f"M={m}: {e} (tolerance {tol})")
                    if m == 16384:
                        forms[key] = (kern, plain, bound)
        times = {key: in_turns(kern, plain)
                 for key, (kern, plain, _) in forms.items()}
        # K1-f32 / K2-f32 at 128 and 256: the form the rule takes at the
        # packed batch (the one-pass form) against the four launches forced,
        # in turns
        rows_vs_four = {
            key: in_turns(forms[key][0], forced_form(forms[key][0], k1,
                                                     "FORCE_F32_ROWS", False))
            for key in (f"K1_f32_{h}", f"K2_f32_{h}")
            if h in k1.ROWS_F32_WIDTHS}
        # K3 at 640: the form the rule takes at the packed batch (the
        # overlapped form) against the one-block form forced, in turns (128
        # has the tile form alone)
        overlap_vs_parent = {
            key: in_turns(forms[key][0], forced_form(forms[key][0], k3,
                                                     "FORCE_OVERLAP", False))
            for key in (f"K3_{h}",) if h == 640}
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    t_a = time.perf_counter() - t_phase

    # ---- b: the tower through predict_batch at B=256
    over_fused = {"text_encoder.fused_attn_out": True, "data.image_size": 256}
    lines, served_lines, p50s = [], [], {}
    for tag, over_b, want in (
            ("default", {}, {f"K1_{h}": n_layers}),
            ("fused", over_fused, {f"K1_{h}": 1, f"K2_{h}": n_layers - 1,
                                   f"K3_{h}": n_layers - 1, "K4": 1})):
        cfg_b = resolve_config("default", {**over, **over_b})
        cfg_32 = resolve_config("default", {
            **over, **over_b, "training.compute_dtype": "float32"})
        pb = MultimodalPredictor(cfg_b, create_model(cfg_b, device="cpu",
                                                     seed=0), dev)
        probs = {}
        reset_counts()
        overlap0 = k3.OVERLAP_CALLS
        probs["bf16"] = probs_of(pb.predict_batch(images, texts),
                                 pb.class_names)
        got = launch_counts()
        if got != count_dict(**want) or pb.packed_calls != 1:
            fail(f"H={h} {tag} bf16 path launches {got} (packed "
                 f"{pb.packed_calls}), want {want}")
        # the K3 launches that took the overlapped form (at 128 the tile
        # form): at 128 and 640 every one (each is at the packed rows),
        # elsewhere none
        n_overlap = k3.OVERLAP_CALLS - overlap0
        if n_overlap != (got[f"K3_{h}"] if h in k3.OVERLAP_WIDTHS else 0):
            fail(f"H={h} {tag} bf16 path: {n_overlap} of {got[f'K3_{h}']} "
                 f"K3 launches took the overlapped form")
        forms3 = (f"; K3 launches {got[f'K3_{h}']}, {n_overlap} in the "
                  + ("tile" if h == 128 else "overlapped") + " form"
                  if h in k3.OVERLAP_WIDTHS and tag == "fused" else "")
        for k in totals:
            totals[k] += got[k]
        with plain_kernels():
            probs["bf16 off"] = probs_of(pb.predict_batch(images, texts),
                                         pb.class_names)
        if tag == "default" and serve is not None:
            n_ans, calls, n_classic, served = serve(pb, n_concurrent=4,
                                                    n_single=1)
            if served != count_dict(**{k: v * calls for k, v in
                                       want.items()}):
                fail(f"H={h} serving: launches {served} for {calls} "
                     f"forwards")
            for k in totals:
                totals[k] += served[k]
            served_lines.append(
                f"MicroBatcher: {n_ans} requests in {calls} forwards "
                f"({n_classic} classic), launches "
                f"{ {k: v for k, v in served.items() if v} }")
        p50s[f"{tag} bf16"] = p50_ms(pb)[0]
        del pb
        torch.cuda.empty_cache()
        # the f32 model: its kernels (K1-K3 in f32), and the same model with
        # every kernel forced off, which is also the bf16 path's f32
        # reference; TF32 off for both
        want32 = {(k.replace(f"_{h}", f"_f32_{h}") if k != "K4" else k): v
                  for k, v in want.items()}
        p32 = MultimodalPredictor(cfg_32, create_model(cfg_32, device="cpu",
                                                       seed=0), dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            reset_counts()
            rows0 = k1.ROWS_F32_CALLS
            probs["f32"] = probs_of(p32.predict_batch(images, texts),
                                    p32.class_names)
            got = launch_counts()
            if got != count_dict(**want32) or p32.packed_calls != 1:
                fail(f"H={h} {tag} f32 path launches {got}, want {want32}")
            # the K1-f32 / K2-f32 launches that took the one-pass form (the
            # packed rows' layers at 128 and 256)
            n_ffn32 = got[f"K1_f32_{h}"] + got[f"K2_f32_{h}"]
            n_rows = k1.ROWS_F32_CALLS - rows0
            if h in k1.ROWS_F32_WIDTHS and not 0 < n_rows < n_ffn32:
                fail(f"H={h} {tag} f32 path: {n_rows} of {n_ffn32} K1-f32 / "
                     f"K2-f32 launches took the one-pass form")
            forms32 = (f"; f32 K1 / K2 launches {n_ffn32}, {n_rows} in the "
                       f"one-pass form, {n_ffn32 - n_rows} in the four "
                       f"launches" if h in k1.ROWS_F32_WIDTHS else "")
            for k in totals:
                totals[k] += got[k]
            with plain_kernels():
                probs["f32 off"] = probs_of(p32.predict_batch(images, texts),
                                            p32.class_names)
            p50s[f"{tag} f32"] = p50_ms(p32)[0]
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = tf32
        del p32
        torch.cuda.empty_cache()
        for k, p in probs.items():
            if p.shape != (BATCH, cfg_b.num_classes) \
                    or not np.isfinite(p).all() \
                    or np.abs(p.sum(1) - 1.0).max() > 1e-3:
                fail(f"H={h} {tag} {k}: bad probabilities {p.shape}")
        d = {name: float(np.abs(probs[a] - probs[b]).max())
             for name, a, b in (("bf16 vs off", "bf16", "bf16 off"),
                                ("bf16 vs f32", "bf16", "f32 off"),
                                ("f32 vs off", "f32", "f32 off"))}
        top1 = {name: int((probs[a].argmax(1) == probs[b].argmax(1)).sum())
                for name, a, b in (("bf16", "bf16", "bf16 off"),
                                   ("f32", "f32", "f32 off"))}
        if d["bf16 vs off"] > PROB_ATOL_PLAIN:
            fail(f"H={h} {tag}: kernel and plain probabilities differ by "
                 f"{d['bf16 vs off']}")
        if d["bf16 vs f32"] > PROB_ATOL_F32:
            fail(f"H={h} {tag}: kernel path is {d['bf16 vs f32']} from the "
                 f"f32 reference")
        if d["f32 vs off"] > PROB_ATOL_F32_KERNELS or top1["f32"] != BATCH:
            fail(f"H={h} {tag} f32: max|dprob| {d['f32 vs off']} from the "
                 f"kernels-off f32 run, top-1 {top1['f32']}/{BATCH}")
        lines.append((
            f"{tag}: launches bf16 {want}, f32 {want32}; max|dprob| bf16 "
            f"kernels vs off {d['bf16 vs off']:.3e} (tolerance "
            f"{PROB_ATOL_PLAIN}), vs f32 {d['bf16 vs f32']:.3e} (tolerance "
            f"{PROB_ATOL_F32}), f32 kernels vs off {d['f32 vs off']:.3e} "
            f"(tolerance {PROB_ATOL_F32_KERNELS}); top-1 bf16 = off "
            f"{top1['bf16']}/{BATCH}, f32 = off {top1['f32']}/{BATCH}; p50 "
            f"bf16 {p50s[tag + ' bf16']:.2f} ms, f32 "
            f"{p50s[tag + ' f32']:.2f} ms{forms3}{forms32}"))
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    pair = ""
    if h in PAIR_BEFORE_MS:
        pair = (f"clusters of {k1.KERNEL_GROUPS[h]} resident at once "
                f"{resident_clusters(dev, h)}; ")
    # the redesigned forms, beside their earlier times
    for before, commit in ((PAIR_BEFORE_MS, "be933b6"),
                           (NARROW_BEFORE_MS, "4b349d5")):
        if h in before:
            pair += (f"K1 / K2 dev ms {times[f'K1_{h}'][0]:.4f} / "
                     f"{times[f'K2_{h}'][0]:.4f} against {commit}'s "
                     f"{before[h][0]} / {before[h][1]} (new/old "
                     f"{times[f'K1_{h}'][0] / before[h][0]:.3f} / "
                     f"{times[f'K2_{h}'][0] / before[h][1]:.3f}) | ")
    # K1-f32 / K2-f32's one-pass form beside the four launches (128, 256)
    if rows_vs_four:
        (p1, f1, *_), (p2, f2, *_) = rows_vs_four.values()
        before = F32_FFN_BEFORE_MS[h]
        pair += (f"K1-f32 / K2-f32 dev ms at M=16384 in the one-pass form "
                 f"{p1:.4f} / {p2:.4f} against the four launches' {f1:.4f} / "
                 f"{f2:.4f} in turns (new/old {p1 / f1:.3f} / {p2 / f2:.3f}; "
                 f"5e786d2's {before[0]} / {before[1]}) | ")
    # K3 at 640: the overlapped form beside the one-block form (forced, in
    # turns) and beside 1a815bf's time; at 128 the tile form beside
    # 1a815bf's
    if overlap_vs_parent:
        (t3, t3_old, *_), = overlap_vs_parent.values()
        before = K3_NARROW_BEFORE_MS[h]
        plan_form = ("overlapped" if k3.launch_slices(16384, h, n_sm) == 0
                     else "one-block")
        pair += (f"K3 dev ms at M=16384 in the {plan_form} form "
                 f"{t3:.4f} against the one-block form's {t3_old:.4f} in turns "
                 f"(new/old {t3 / t3_old:.3f}; 1a815bf's {before}, "
                 f"{t3 / before:.3f}) | ")
    elif h == 128:
        t3, before = times[f"K3_{h}"][0], K3_NARROW_BEFORE_MS[h]
        pair += (f"K3 dev ms at M=16384 in the tile form (every row count) "
                 f"{t3:.4f} against 1a815bf's one-block form's {before} "
                 f"(new/old {t3 / before:.3f}) | ")
    # K3-f32's clusters of the pass over whole rows the card holds at once
    # (128-640), its plan at the packed batch
    resident = (k3.f32_rows_clusters(dev, h) if h in k3.ROWS_F32_WIDTHS
                else 0)
    plan32 = k3.attn_out_plan_f32(16384, n_sm, h, resident)
    if h in F32_NARROW_BEFORE_MS:
        t32, before = times[f"K3_f32_{h}"][0], F32_NARROW_BEFORE_MS[h]
        pair += (f"K3-f32 dev ms {t32:.4f} against 6b702b9's {before} "
                 f"(new/old {t32 / before:.3f}), taking "
                 + (f"the pass over whole rows (clusters of {h // 128}, "
                    f"{resident} resident at once)"
                    if plan32.rows else "the three launches") + " | ")
    plans = (f"bf16 FFN {k1.ffn_plan(16384, f, n_sm, h).slices} / "
             f"{k1.ffn_plan(1024, f, n_sm, h).slices} slices at "
             f"M=16384 / 1024, K3 {k3.attn_out_plan(16384, n_sm, h).slices} / "
             f"{k3.attn_out_plan(64, n_sm, h).slices} at 16384 / 64; f32 "
             f"scratch per call at M=16384: FFN "
             f"{k1.ffn_plan_f32(16384, f, n_sm, h).scratch * 4 / 1e6:.1f} "
             f"MB, K3 "
             f"{plan32.scratch * 4 / 1e6:.1f}"
             f" MB")
    text = (f"H={h}, F={f}, {te.num_heads} heads, {n_layers} layers, vocab "
            f"{te.vocab_size} | kernels vs plain (max|diff| / mean|diff|): "
            + "; ".join(f"{k}: " + ", ".join(
                f"M={m} {e[0]:.3e} / {e[1]:.3e}" for m, e in v.items())
                for k, v in errs.items())
            + " | at M=16384, dev ms vs plain (bound, share): " + "; ".join(
                f"{k} {t[0]:.4f} vs {t[1]:.4f} ({t[2]}; bound "
                f"{forms[k][2][0]:.4f} ms, {forms[k][2][1]}, "
                f"{forms[k][2][0] / t[0]:.1%})" for k, t in times.items())
            + f" | {pair}{plans} | " + " || ".join(lines + served_lines))
    return totals, {k: (max(e[0] for e in errs[k].values()), t[0], t[1],
                        t[3], *forms[k][2]) for k, t in times.items()}, \
        text, t_a


def bert_large(dev, card: str, images, texts, in_turns, p50_ms, serve):
    """Phase 17: `width_phase` at BERT-large width (LARGE_OVER), with one
    MicroBatcher round. Returns its launches and its forms' readings."""
    t_phase = time.perf_counter()
    totals, times, text, t_a = width_phase(dev, LARGE_OVER, 17, images,
                                           texts, in_turns, p50_ms, serve)
    print(f"[17 BERT-large] {card} | {text} | kernel checks {t_a:.1f} s, "
          f"phase 17 took {time.perf_counter() - t_phase:.1f} s")
    return totals, times


def width_towers(dev, card: str, images, texts, in_turns, p50_ms, serve,
                 phase: int, tag: str, towers: dict, serve_width: int,
                 seed: int):
    """`width_phase` at each of `towers` (name: overrides; the i-th drawn
    from seed + i) for phase `phase` (printed as `tag`), with one
    MicroBatcher round at H = `serve_width`. Returns the launches of its
    counted runs and every form's readings."""
    t_phase = time.perf_counter()
    totals, times = count_dict(), {}
    for i, (name, over) in enumerate(towers.items()):
        t0 = time.perf_counter()
        got, got_times, text, t_a = width_phase(
            dev, over, seed + i, images, texts, in_turns, p50_ms,
            serve if over["text_encoder.hidden_size"] == serve_width
            else None)
        for k in totals:
            totals[k] += got[k]
        times.update(got_times)
        print(f"[{phase} {tag}] {card} | {name}: {text} | kernel checks "
              f"{t_a:.1f} s, {name} took {time.perf_counter() - t0:.1f} s",
              flush=True)
    print(f"[{phase} {tag}] {card} | phase {phase} took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return totals, times


def compact_widths(dev, card: str, images, texts, in_turns, p50_ms, serve):
    """Phase 18: `width_towers` over COMPACT_OVER's towers, with one
    MicroBatcher round at H = 512."""
    return width_towers(dev, card, images, texts, in_turns, p50_ms, serve,
                        18, "compact widths", COMPACT_OVER, 512, 18)


def odd_widths(dev, card: str, images, texts, in_turns, p50_ms, serve):
    """Phase 19: `width_towers` over ODD_OVER's towers, with one
    MicroBatcher round on MiniLM-L12-H384."""
    return width_towers(dev, card, images, texts, in_turns, p50_ms, serve,
                        19, "odd widths", ODD_OVER, 384, 190)


def wide_widths(dev, card: str, images, texts, in_turns, p50_ms, serve):
    """Phase 20: `width_towers` over WIDE_OVER's towers, with one
    MicroBatcher round on the 1,536-wide tower."""
    return width_towers(dev, card, images, texts, in_turns, p50_ms, serve,
                        20, "wide widths", WIDE_OVER, 1536, 200)


def timing_helpers(images, texts):
    """The serving round and the clocks of the phases, on phase 4's
    batch (`images`, `texts`): serve(p, n_concurrent, n_single), the
    p50 of `predict_batch`, and the device (`events_ms`, `per_call_ms`,
    `in_turns`) and host (`host_ms`) times of a call. Returns them as a
    namespace."""
    from types import SimpleNamespace

    import numpy as np
    import torch

    from multimodal_rare_disease_tpu_torch.cli.serve import MicroBatcher
    from multimodal_rare_disease_tpu_torch.inference.seeded_batch import (
        seeded_requests as requests,
    )

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

    return SimpleNamespace(serve=serve, p50_ms=p50_ms, host_ms=host_ms,
                           events_ms=events_ms, per_call_ms=per_call_ms,
                           in_turns=in_turns)


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
          f"{lib.mrd_ffn_smem_bytes()} B (H=1024: "
          f"{lib.mrd_ffn_smem_bytes_h1024()} B, H=1536: "
          f"{lib.mrd_ffn_smem_bytes_h1536()} B), attn-out "
          f"{lib.mrd_attn_out_smem_bytes()} B (H=1024: "
          f"{lib.mrd_attn_out_smem_bytes_h1024()} B, H=1536: "
          f"{lib.mrd_attn_out_smem_bytes_h1536()} B), f32 FFN "
          f"{lib.mrd_ffn_f32_smem_bytes()} B, f32 attn-out "
          f"{lib.mrd_attn_out_f32_smem_bytes()} B | "
          f"{'; '.join(regs) or 'no ptxas report'} | no spills, no C75xx "
          f"warnings")

    # the serving batch, prepared first so phase 3 tests the kernels at
    # its row count
    cfg = resolve_config("default")
    images, texts = requests(BATCH, seed=0)
    clock = timing_helpers(images, texts)
    serve, p50_ms, host_ms = clock.serve, clock.p50_ms, clock.host_ms
    per_call_ms, in_turns = clock.per_call_ms, clock.in_turns
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

    def within(err, tol=(ROW_ATOL, ROW_MEAN_ATOL)):
        return err[0] <= tol[0] and err[1] <= tol[1]

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

    def call(fn, z, v, w=None):
        """K1 (v has pre_gamma) or K2 through `fn` with the weights `w`
        (phase 3's bf16 pair by default), synchronized, f32."""
        ln0 = {k: v[k] for k in ("pre_gamma", "pre_beta") if k in v}
        if fn is k1.ffn_ln_plain:
            ln0["input_ln"] = bool(ln0)
        wa, wb = w or (w1, w2)
        out = fn(z, wa, v["b1"], wb, v["b2"], v["gamma"], v["beta"], **ln0)
        torch.cuda.synchronize()
        return out.float()

    def check_rows(name, kern, plain, make, vecs, dropped_of, count=None):
        """A row kernel against its plain version at the phase-3 row
        counts with `vecs` (and bf16 ones, where `vecs` are f32 and the
        rows bf16), and the check's failure for a kernel that drops a
        term; returns (worst max|diff|, line). `count`: the f32 kernels'
        launch-count key. Their check holds ROW_F32_ATOL /
        ROW_F32_MEAN_ATOL, counts every launch (plain-on-CUDA 0) and must
        fail the plain version run with its operands rounded to TF32
        (allow_tf32) in the kernel's place."""
        f32 = count is not None
        tol = ((ROW_F32_ATOL, ROW_F32_MEAN_ATOL) if f32
               else (ROW_ATOL, ROW_MEAN_ATOL))
        errs, calls = {}, [0]

        def kernel(*a):
            calls[0] += 1
            return kern(*a)

        reset_counts()
        for m in PHASE3_ROWS + (packed_m,) + (PHASE3_F32_ROWS if f32 else ()):
            args = make(m)
            got = kernel(*args, vecs)
            if not torch.isfinite(got).all():
                fail(f"{name} output not finite at M={m}")
            errs[f"M={m}"] = diff(got, plain(*args, vecs))
            if m == 4096:
                args_4k, want_4k = args, plain(*args, vecs)
        if not f32 and any(v.dtype != bf for v in vecs.values()):
            vecs_bf = {k: v.to(bf) for k, v in vecs.items()}
            errs[f"M={packed_m}, bf16 vectors"] = diff(
                kernel(*args, vecs_bf), plain(*args, vecs_bf))
        dropped = {term: diff(kernel(*dropped_args, dropped_vecs), want_4k)
                   for term, (dropped_args, dropped_vecs)
                   in dropped_of(args_4k, vecs).items()}
        for k, e in errs.items():
            if not within(e, tol):
                fail(f"{name} disagrees with its plain version at {k}: {e}")
        for k, e in dropped.items():
            if within(e, tol):
                fail(f"the {name} check passes a kernel that drops {k}: {e}")
        tf32_line = ""
        if f32:
            if launch_counts() != count_dict(**{count: calls[0]}):
                fail(f"{name}: launches {launch_counts()}, want {count} "
                     f"{calls[0]} and nothing else")
            old = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                tf32 = diff(plain(*args_4k, vecs), want_4k)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = old
            if within(tf32, tol):
                fail(f"the {name} check passes the plain version with TF32 "
                     f"operands: {tf32}")
            tf32_line = (f" | the plain version with TF32 operands reads, at "
                         f"M=4096: {tf32[0]:.3e} / {tf32[1]:.3e}")
        vec_types = sorted({str(v.dtype).split(".")[1]
                            for v in vecs.values()})
        return max(e[0] for e in errs.values()), (
            f"{name} max|diff| / mean|diff| {fmt(errs)} "
            f"({'f32' if f32 else 'bf16'}, {'/'.join(vec_types)} vectors, "
            f"tolerance {tol[0]} / {tol[1]}) | a kernel that drops a term "
            f"reads, at M=4096: {fmt(dropped)}{tf32_line}")

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
    # the f32 kernel (an f32 model's K1) on inputs of their own generator,
    # so that the bf16 checks keep their inputs
    gen32 = torch.Generator().manual_seed(3)

    def rnd32(shape, scale, offset=0.0):
        return (torch.randn(shape, generator=gen32) * scale + offset).to(dev)

    w32 = (rnd32((f, h), 0.05).t(), rnd32((h, f), 0.05).t())
    vec32 = dict(b1=rnd32((f,), 0.5), b2=rnd32((h,), 0.5),
                 gamma=rnd32((h,), 0.25, 1.0), beta=rnd32((h,), 0.5),
                 pre_gamma=rnd32((h,), 0.25, 1.0), pre_beta=rnd32((h,), 0.5))
    k2_vec32 = {k: vec32[k] for k in ("b1", "b2", "gamma", "beta")}

    def make_z32(m):
        return (rnd32((m, h), 1.0),)

    k1_32_err, line32 = check_rows(
        "K1-f32", lambda z, v: call(k1.fused_ffn_ln, z, v, w32),
        lambda z, v: call(k1.ffn_ln_plain, z, v, w32), make_z32, vec32,
        drop_vectors, count="K1_f32")
    print(f"[3 K1 vs plain] {line} || {line32}")

    # ---- 3b. K2, K3 and K4 against their plain versions on the card
    k2_err, line2 = check_rows(
        "K2", lambda z, v: call(k1.fused_ffn_ln, z, v),
        lambda z, v: call(k1.ffn_ln_plain, z, v), make_z, k2_vec,
        drop_vectors)
    wo = rnd((h, h), 0.05, dtype=bf).t()  # a view of [out, in], as above
    k3_vec = dict(bo=rnd((h,), 0.5, dtype=bf),
                  gamma=rnd((h,), 0.25, 1.0, dtype=bf),
                  beta=rnd((h,), 0.5, dtype=bf))

    def attn(fn, ctx, x, v, w=None):
        out = fn(ctx, x, wo if w is None else w, v["bo"], v["gamma"],
                 v["beta"])
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
    if gate != count_dict(plain_on_cuda=2):
        fail(f"K2 and K3 with f32 vectors: counts {gate}, want the gate's "
             f"two plain calls and no launch")
    # the f32 forms of K2 and K3 (an f32 model's fused-sublayer path)
    k2_32_err, line2_32 = check_rows(
        "K2-f32", lambda z, v: call(k1.fused_ffn_ln, z, v, w32),
        lambda z, v: call(k1.ffn_ln_plain, z, v, w32), make_z32, k2_vec32,
        drop_vectors, count="K2_f32")
    wo32 = rnd32((h, h), 0.05).t()
    k3_vec32 = dict(bo=rnd32((h,), 0.5), gamma=rnd32((h,), 0.25, 1.0),
                    beta=rnd32((h,), 0.5))
    k3_32_err, line3_32 = check_rows(
        "K3-f32", lambda c, x, v: attn(k3.fused_attn_out_ln, c, x, v, wo32),
        lambda c, x, v: attn(k3.attn_out_ln_plain, c, x, v, wo32),
        lambda m: (rnd32((m, h), 1.0), rnd32((m, h), 1.0)), k3_vec32,
        drop_k3, count="K3_f32")
    # mixed dtypes stay on the counted gate: f32 rows with bf16 vectors
    reset_counts()
    call(k1.fused_ffn_ln, make_z32(37)[0],
         {k: v.to(bf) for k, v in vec32.items()}, w32)
    attn(k3.fused_attn_out_ln, *make_z32(37), *make_z32(37),
         {k: v.to(bf) for k, v in k3_vec32.items()}, wo32)
    gate32 = launch_counts()
    if gate32 != count_dict(plain_on_cuda=2):
        fail(f"f32 K1 and K3 with bf16 vectors: counts {gate32}, want the "
             f"gate's two plain calls and no launch")
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
    print(f"[3b K2, K3, K4 vs plain] {line2} || {line3} || {line2_32} || "
          f"{line3_32} || f32 rows with bf16 vectors: the gate's plain "
          f"version, {gate32['plain_on_cuda']} calls || K4 max|diff| / "
          f"mean|diff| {fmt(k4_errs)} (tolerance f32 {K4_ATOL['float32']}, "
          f"bf16 {K4_ATOL['bfloat16']}; mean {K4_MEAN_ATOL})")

    # ---- 4. the full-width model through the default path
    n_layers = cfg.text_encoder.num_layers
    reset_counts()
    res = pred.predict_batch(images, texts)
    main4 = launch_counts()
    if pred.packed_calls < 1:
        fail("the batch did not take the packed path")
    if main4 != count_dict(K1=n_layers):
        fail(f"default path launches {main4} (want K1 {n_layers} and "
             f"nothing else)")
    probs = probs_of(res, pred.class_names)
    if probs.shape != (BATCH, cfg.num_classes) or not np.isfinite(probs).all():
        fail(f"bad probabilities: shape {probs.shape}")
    if np.abs(probs.sum(1) - 1.0).max() > 1e-3:
        fail("probabilities do not sum to 1")

    def reference_probs(p, over, preset="default", batch_images=None):
        """The kernel-off run of `p`, and the same seeded weights under
        the f32 compute dtype on the card with every kernel off too (the
        plain f32 model; cuDNN convolutions without TF32), on phase 4's
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

    refs = {}  # tag -> (kernels-off, f32) probabilities, for phase 13

    def agreement(tag, p, probs, over, preset="default", batch_images=None):
        probs_plain, probs_ref = reference_probs(p, over, preset,
                                                 batch_images)
        refs[tag] = (probs_plain, probs_ref)
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
    n_ans, calls, n_classic, serve5 = serve(pred)
    if serve5 != count_dict(K1=n_layers * calls):
        fail(f"serving: launches {serve5} for {calls} forwards")
    print(f"[5 serving] {n_ans} requests in {calls} forwards, launches "
          f"{serve5}, classic calls {n_classic}")

    # ---- 6. times
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
    want7 = count_dict(K1=1, K2=n_layers - 1, K3=n_layers - 1, K4=1)
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

    # ---- 13. the rank mesh: 1x1 over NCCL, 2 ranks on this card over
    # gloo (predict, train, serve --mesh, the dry run)
    torch.cuda.empty_cache()
    main13 = mesh_phase(dev, card, probs, refs, over7)

    # ---- 14. int8 serving and the flat residual stream
    torch.cuda.empty_cache()
    main14 = quantized_and_flat(dev, card, images, texts, refs, p50_ms)

    # ---- 15. entry(), the counterpart of __graft_entry__.entry()
    torch.cuda.empty_cache()
    main15 = entry_forward(dev, card)

    # ---- 16. f32 serving: the full-width models under
    # training.compute_dtype=float32, K1-K3 in their f32 kernels
    torch.cuda.empty_cache()
    t16 = time.perf_counter()
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    main16 = count_dict()
    lines16 = []
    try:
        for tag, over, want in (
                ("default", {}, count_dict(K1_f32=n_layers)),
                ("fused", over7, count_dict(K1_f32=1, K2_f32=n_layers - 1,
                                            K3_f32=n_layers - 1, K4=1))):
            cfg32 = resolve_config("default", {
                **over, "training.compute_dtype": "float32"})
            p32 = MultimodalPredictor(
                cfg32, create_model(cfg32, device="cpu", seed=0), dev)
            reset_counts()
            res32 = p32.predict_batch(images, texts)
            got = launch_counts()
            if got != want or p32.packed_calls != 1:
                fail(f"f32 {tag} path launches {got} (packed "
                     f"{p32.packed_calls}), want {want}")
            probs32 = probs_of(res32, p32.class_names)
            if probs32.shape != (BATCH, cfg32.num_classes) \
                    or not np.isfinite(probs32).all() \
                    or np.abs(probs32.sum(1) - 1.0).max() > 1e-3:
                fail(f"bad f32 {tag} probabilities: {probs32.shape}")
            with plain_kernels():
                off32 = probs_of(p32.predict_batch(images, texts),
                                 p32.class_names)
            d32 = np.abs(probs32 - off32)
            top1 = int((probs32.argmax(1) == off32.argmax(1)).sum())
            if d32.max() > PROB_ATOL_F32_KERNELS or top1 != BATCH:
                fail(f"f32 {tag}: max|dprob| {d32.max()} from the "
                     f"kernels-off f32 run, top-1 {top1}/{BATCH}")
            n_ans, calls, n_classic, served = serve(p32, n_concurrent=4,
                                                    n_single=1)
            if served != {k: v * calls for k, v in want.items()}:
                fail(f"f32 {tag} serving: launches {served} for {calls} "
                     f"forwards")
            for k in main16:
                main16[k] += got[k] + served[k]

            # p50 in turns: kernels off (the path before the f32 kernels),
            # on, on, off
            def p50_off():
                with plain_kernels():
                    return p50_ms(p32)[0]

            off_a, on_a, on_b, off_b = (p50_off(), p50_ms(p32)[0],
                                        p50_ms(p32)[0], p50_off())
            lines16.append(
                f"{tag}: launches {got}; max|dprob| / mean|dprob| from the "
                f"kernels-off f32 run {d32.max():.3e} / {d32.mean():.3e} "
                f"(tolerance {PROB_ATOL_F32_KERNELS}), top-1 {top1}/{BATCH} "
                f"| MicroBatcher: {n_ans} requests in {calls} forwards "
                f"({n_classic} classic), launches {served} | p50 of "
                f"predict_batch B={BATCH}: kernels {(on_a + on_b) / 2:.2f} "
                f"ms vs kernels off {(off_a + off_b) / 2:.2f} ms (runs "
                f"{off_a:.2f} {on_a:.2f} {on_b:.2f} {off_b:.2f})")
            if tag == "fused":
                ids16, mask16 = p32._prep_texts(texts, BATCH)
                m16 = int(np.prod(p32._packed_inputs(ids16, mask16)[0].shape))
            del p32
            torch.cuda.empty_cache()

        # each f32 kernel against its plain version (TF32 off) at the
        # shapes of the f32 paths, beside its bound
        z32 = rnd32((packed_m, h), 1.0)
        zc32 = rnd32((SMALL_ROWS[0], h), 1.0)
        x16, c16 = rnd32((m16, h), 1.0), rnd32((m16, h), 1.0)
        a1_32 = (w32[0], vec32["b1"], w32[1], vec32["b2"], vec32["gamma"],
                 vec32["beta"])
        ln0_32 = dict(pre_gamma=vec32["pre_gamma"],
                      pre_beta=vec32["pre_beta"])
        a3_32 = (c16, x16, wo32, k3_vec32["bo"], k3_vec32["gamma"],
                 k3_vec32["beta"])
        times32 = {}
        for key, kern_fn, plain_fn, bound in (
                ("K1_f32", lambda: k1.fused_ffn_ln(z32, *a1_32, **ln0_32),
                 lambda: k1.ffn_ln_plain(z32, *a1_32, input_ln=True,
                                         **ln0_32),
                 ffn_bound(packed_m, h, f, 4, True, 4)),
                ("K1_f32 CLS", lambda: k1.fused_ffn_ln(zc32, *a1_32,
                                                       **ln0_32),
                 lambda: k1.ffn_ln_plain(zc32, *a1_32, input_ln=True,
                                         **ln0_32),
                 ffn_bound(SMALL_ROWS[0], h, f, 4, True, 4)),
                ("K2_f32", lambda: k1.fused_ffn_ln(x16, *a1_32),
                 lambda: k1.ffn_ln_plain(x16, *a1_32, input_ln=False),
                 ffn_bound(m16, h, f, 4, False, 4)),
                ("K3_f32", lambda: k3.fused_attn_out_ln(*a3_32),
                 lambda: k3.attn_out_ln_plain(*a3_32),
                 attn_out_bound(m16, h, 4, 4))):
            ms, plain_ms, runs, b2b = in_turns(kern_fn, plain_fn)
            times32[key] = (ms, plain_ms, b2b, *bound, runs)

        # K3-f32 against the classic f32 chain it stands for (F.linear,
        # the residual add, F.layer_norm: three calls), in turns K3, chain,
        # chain, K3
        def k3_chain32():
            return F.layer_norm(F.linear(c16, wo32.t(), k3_vec32["bo"]) + x16,
                                (h,), k3_vec32["gamma"], k3_vec32["beta"],
                                1e-12)

        chain_err = diff(k3_chain32(), k3.attn_out_ln_plain(*a3_32))
        chain_ms, k3_32_ms_b, chain_runs, _ = in_turns(
            k3_chain32, lambda: k3.fused_attn_out_ln(*a3_32))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    plan_cls = k1.ffn_plan_f32(SMALL_ROWS[0], f, n_sm)
    plans_k3 = {m: k3.attn_out_plan_f32(m, n_sm) for m in (64, m16)}
    print(f"[16 f32 serving] {card} | training.compute_dtype=float32, "
          f"TF32 off | " + " || ".join(lines16) + " | kernels, TF32-off "
          f"plain beside each: " + "; ".join(
              f"{k} at M={m}: {t[0]:.4f} ms vs plain {t[1]:.4f} ({t[5]}), "
              f"bound {t[3]:.4f} ms ({t[4]}), {t[3] / t[0]:.1%} of it"
              for (k, t), m in zip(times32.items(),
                                   (packed_m, SMALL_ROWS[0], m16, m16)))
          + f" (K1-f32 at M={SMALL_ROWS[0]}: {plan_cls.tiles} tiles x "
          f"{plan_cls.slices} slices; K3-f32's GEMM "
          + ", ".join(f"at M={m}: {p.tiles} row tiles x 6 column tiles x "
                      f"{p.slices} slices of {p.k_tiles} k-tiles"
                      for m, p in plans_k3.items())
          + f", scratch {plans_k3[m16].scratch * 4 / 1e6:.1f} MB per call); "
          f"K3-f32 vs the classic f32 linear + "
          f"add + LayerNorm chain {k3_32_ms_b:.4f} vs {chain_ms:.4f} ms "
          f"({chain_runs}; the chain's max|diff| from plain "
          f"{chain_err[0]:.3e}) | {time.perf_counter() - t16:.1f} s")

    # ---- 17. BERT-large width: K1-K3 at H = 1,024 in bf16 and f32, the
    # 24-layer tower through predict_batch
    torch.cuda.empty_cache()
    main17, times17 = bert_large(dev, card, images, texts, in_turns, p50_ms,
                                 serve)

    # ---- 18. the compact widths: K1-K3 at H = 512, 256 and 128 in bf16
    # and f32, BERT-Medium, -Mini and -Tiny through predict_batch
    torch.cuda.empty_cache()
    main18, times18 = compact_widths(dev, card, images, texts, in_turns,
                                     p50_ms, serve)

    # ---- 19. the odd widths: K1-K3 at H = 384, 640 and 896 in bf16 and
    # f32, MiniLM-L12-H384 and the 640- and 896-wide towers through
    # predict_batch
    torch.cuda.empty_cache()
    main19, times19 = odd_widths(dev, card, images, texts, in_turns, p50_ms,
                                 serve)

    # ---- 20. the wide widths: K1-K3 at H = 1,152, 1,280, 1,408 and 1,536
    # in bf16 and f32, the 24-layer 1,536-wide tower and the 2-layer
    # others through predict_batch
    torch.cuda.empty_cache()
    main20, times20 = wide_widths(dev, card, images, texts, in_turns, p50_ms,
                                  serve)

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
        ("ffn_pre_ln_bf16", "ffn_ln.cuh", "ffn.py:72", "K1", k1_err, k1_ms,
         k1_plain_ms, k1_b2b, k1_bound, k1_by, None),
        ("ffn_ln_bf16", "ffn_ln.cuh", "ffn.py:103", "K2", k2_err, k2_ms,
         k2_plain_ms, k2_b2b, k2_bound, k2_by, None),
        ("attn_out_ln_bf16", "attn_out_ln.cuh", "attn_out.py:38", "K3",
         k3_err, k3_ms, k3_plain_ms, k3_b2b, k3_bound, k3_by, None),
        ("normalize_u8", "normalize_u8.cu", "image_kernels.py:37", "K4",
         k4_err, k4_ms, k4_plain_ms, k4_b2b, k4_bound, k4_by, k4_lib_ms),
        # the f32 forms, timed in phase 16 at the f32 paths' shapes; none
        # has one PyTorch call either (K3-f32's classic chain is three)
        ("ffn_pre_ln_f32", "ffn_ln_f32.cu", "ffn.py:72", "K1_f32",
         k1_32_err, *times32["K1_f32"][:5], None),
        ("ffn_ln_f32", "ffn_ln_f32.cu", "ffn.py:103", "K2_f32", k2_32_err,
         *times32["K2_f32"][:5], None),
        ("attn_out_ln_f32", "attn_out_ln_f32.cu", "attn_out.py:38", "K3_f32",
         k3_32_err, *times32["K3_f32"][:5], None),
        # the H = 1,024 instantiations (BERT-large), checked and timed in
        # phase 17; none has one PyTorch call either
        ("ffn_pre_ln_bf16_h1024", "ffn_ln.cuh", "ffn.py:72", "K1_1024",
         *times17["K1_1024"], None),
        ("ffn_ln_bf16_h1024", "ffn_ln.cuh", "ffn.py:103", "K2_1024",
         *times17["K2_1024"], None),
        ("attn_out_ln_bf16_h1024", "attn_out_ln.cuh", "attn_out.py:38",
         "K3_1024", *times17["K3_1024"], None),
        ("ffn_pre_ln_f32_h1024", "ffn_ln_f32.cu", "ffn.py:72", "K1_f32_1024",
         *times17["K1_f32_1024"], None),
        ("ffn_ln_f32_h1024", "ffn_ln_f32.cu", "ffn.py:103", "K2_f32_1024",
         *times17["K2_f32_1024"], None),
        ("attn_out_ln_f32_h1024", "attn_out_ln_f32.cu", "attn_out.py:38",
         "K3_f32_1024", *times17["K3_f32_1024"], None),
    ] + [
        # the compact, the odd and the wide widths' instantiations, checked
        # and timed in phases 18, 19 and 20; none has one PyTorch call
        # either. K3-f32 at 128-640 runs the pass over whole rows of
        # attn_out_rows_f32.cuh (built by attn_out_ln_f32.cu) at the packed
        # batch, K1-f32 and K2-f32 at 128 and 256 the one-pass form of
        # ffn_rows_f32.cuh (built by ffn_rows_f32.cu), K3 at 128 and 640 the
        # overlapped forms of attn_out_ln_overlap.cu
        (f"{name}_h{w}",
         "attn_out_rows_f32.cuh" if key == "K3_f32" and w <= 640 else
         "ffn_rows_f32.cuh" if key in ("K1_f32", "K2_f32") and w <= 256
         else "attn_out_ln_overlap.cu" if key == "K3" and w in (128, 640)
         else source,
         replaces, f"{key}_{w}",
         *{**times18, **times19, **times20}[f"{key}_{w}"], None)
        for w in (512, 256, 128, 384, 640, 896, 1152, 1280, 1408, 1536)
        for name, source, replaces, key in (
            ("ffn_pre_ln_bf16", "ffn_ln.cuh", "ffn.py:72", "K1"),
            ("ffn_ln_bf16", "ffn_ln.cuh", "ffn.py:103", "K2"),
            ("attn_out_ln_bf16", "attn_out_ln.cuh", "attn_out.py:38", "K3"),
            ("ffn_pre_ln_f32", "ffn_ln_f32.cu", "ffn.py:72", "K1_f32"),
            ("ffn_ln_f32", "ffn_ln_f32.cu", "ffn.py:103", "K2_f32"),
            ("attn_out_ln_f32", "attn_out_ln_f32.cu", "attn_out.py:38",
             "K3_f32"))]
    print(card)
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": src + source,
        "replaces": tpu + replaces,
        # launches on the main paths: phases 4, 5, 7 (both of its runs),
        # 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19 and 20 (their counted
        # runs; 13's on every rank)
        "launches": (main4[k] + serve5[k] + main7[k] + serve7[k]
                     + main9[k] + main10[k] + main11[k] + main12[k]
                     + main13[k] + main14[k] + main15[k] + main16[k]
                     + main17[k] + main18[k] + main19[k] + main20[k]),
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
