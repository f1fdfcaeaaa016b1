"""Environment verification: the JAX package's seven-step check against
the torch package.

    python -m multimodal_rare_disease_tpu_torch.cli.verify_setup \
        [--full] [--device cuda|cpu]

1. imports (torch, numpy, scipy, the package); 2. the device and, on a
card, the kernels' build at first use (nvcc, into build/kernels/) and
their load; 3. config presets; 4. the image corpus; 5. clinical text and
the tokenizer; 6. the multimodal model's build and parameter counts;
7. a forward pass: the small image_only model on the train augmentation
(as the JAX check), or with `--full` the full-size multimodal model
through the predictor in its compute dtype, where on a card every BERT
layer launches the fused FFN kernel (K1). Unlike the JAX check, nothing
falls back to the CPU: with `--device cuda` and no card, step 2 fails
and the CLI exits 1.
"""

from __future__ import annotations

import argparse
import traceback

from multimodal_rare_disease_tpu_torch.cli._common import add_device_arg


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Verify framework setup")
    parser.add_argument("--full", action="store_true",
                        help="include a forward pass of the full-size model")
    add_device_arg(parser)
    args = parser.parse_args(argv)

    steps = []
    state = {}

    def step(name):
        def deco(fn):
            steps.append((name, fn))
            return fn
        return deco

    @step("1. imports")
    def _imports():
        import numpy
        import scipy
        import torch

        import multimodal_rare_disease_tpu_torch as pkg

        return (f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
                f"numpy {numpy.__version__}, scipy {scipy.__version__}, "
                f"pkg {pkg.__version__}")

    @step("2. device & kernels")
    def _devices():
        import time

        import torch

        from multimodal_rare_disease_tpu_torch.kernels import build
        from multimodal_rare_disease_tpu_torch.models.classifier import (
            resolve_device,
        )

        dev = resolve_device(args.device)
        state["device"] = dev
        if dev.type != "cuda":
            return f"{dev}: the kernels' plain versions"
        t0 = time.perf_counter()
        lib = build.build()
        build.load_library(dev)
        return (f"{torch.cuda.get_device_name(dev)} (capability "
                f"{torch.cuda.get_device_capability(dev)}, "
                f"{torch.cuda.device_count()} device(s)); kernels "
                f"{lib.parent.name} built and loaded in "
                f"{time.perf_counter() - t0:.1f} s")

    @step("3. config")
    def _config():
        from multimodal_rare_disease_tpu_torch.config import resolve_config

        cfg = resolve_config("multimodal")
        assert cfg.data.max_text_length == cfg.text_encoder.max_length
        return (f"presets ok; image {cfg.data.image_size}px, "
                f"text {cfg.data.max_text_length} tokens, "
                f"{cfg.classifier.num_classes} classes")

    @step("4. image corpus")
    def _corpus():
        from multimodal_rare_disease_tpu_torch.config import (
            find_image_dir,
            get_config,
        )
        from multimodal_rare_disease_tpu_torch.data.images import (
            class_counts,
            scan_image_corpus,
        )

        d = find_image_dir(get_config())
        if d is None:
            return "no corpus found (synthetic generator available)"
        samples = scan_image_corpus(d)
        counts = class_counts(samples)
        return (f"{len(samples)} images in {d} "
                f"({counts.min()}-{counts.max()}/class)")

    @step("5. clinical text & tokenizer")
    def _text():
        from multimodal_rare_disease_tpu_torch.config import get_config
        from multimodal_rare_disease_tpu_torch.data.clinical_text import (
            load_clinical_descriptions,
        )
        from multimodal_rare_disease_tpu_torch.data.tokenizer import (
            get_tokenizer,
        )

        desc = load_clinical_descriptions(get_config())
        tok = get_tokenizer()
        ids, mask, _ = tok.encode(
            next(iter(desc.values()))["clinical_description"], 128)
        return (f"{len(desc)} syndromes, vocab {tok.vocab_size}, "
                f"{int(mask.sum())} tokens in first description")

    def device():
        if "device" not in state:
            raise RuntimeError("no device: step 2 failed")
        return state["device"]

    def model_config():
        from multimodal_rare_disease_tpu_torch.config import resolve_config

        if args.full:
            return resolve_config("multimodal")
        return resolve_config("multimodal", {
            "text_encoder.num_layers": 2,
            "text_encoder.hidden_size": 64,
            "text_encoder.num_heads": 2,
            "text_encoder.intermediate_size": 128,
            "fusion.text_proj_dim": 64,
            "data.image_size": 64,
            "data.max_text_length": 32,
            "text_encoder.max_length": 32,
        })

    @step("6. model build")
    def _model():
        from multimodal_rare_disease_tpu_torch.models.classifier import (
            create_model,
        )
        from multimodal_rare_disease_tpu_torch.train.freeze import (
            count_params,
        )

        model = create_model(model_config(), mode="multimodal",
                             device=device(), seed=0, trainable=True)
        total, trainable = count_params(model)
        return (f"multimodal model {total / 1e6:.1f}M params "
                f"({trainable / 1e6:.1f}M trainable, "
                f"{100 * trainable / total:.0f}%)")

    @step("7. forward pass")
    def _forward():
        import numpy as np
        import torch

        from multimodal_rare_disease_tpu_torch.config import resolve_config
        from multimodal_rare_disease_tpu_torch.models.classifier import (
            create_model,
        )
        from multimodal_rare_disease_tpu_torch.ops.preprocess import (
            train_preprocess,
        )

        dev = device()
        if args.full:
            return _full_forward(model_config(), dev)
        cfg = resolve_config("default", {
            "data.image_size": 64,
            "text_encoder.num_layers": 1,
            "text_encoder.hidden_size": 32,
            "text_encoder.num_heads": 2,
            "text_encoder.intermediate_size": 64,
        })
        model = create_model(cfg, mode="image_only", device=dev, seed=1)
        u8 = torch.zeros((2, 256, 256, 3), dtype=torch.uint8, device=dev)
        x = train_preprocess(u8, torch.Generator(dev).manual_seed(0), cfg)
        with torch.inference_mode():
            out = model(x)
        probs = out["probs"].float().cpu().numpy()
        assert np.isfinite(probs).all()
        return f"forward ok, probs {tuple(probs.shape)}"

    failed = 0
    for name, fn in steps:
        try:
            msg = fn()
            print(f"  [OK]   {name}: {msg}")
        except Exception as e:  # noqa: BLE001 — report every step
            failed += 1
            print(f"  [FAIL] {name}: {e}")
            traceback.print_exc()
    print()
    if failed:
        print(f"{failed}/{len(steps)} steps FAILED")
        return 1
    print(f"all {len(steps)} steps passed")
    return 0


def _full_forward(cfg, dev) -> str:
    """The full-size multimodal model, seeded, in its compute dtype,
    through `predict_batch` on two seeded requests; on a card, the count
    of fused FFN kernel (K1) launches it took."""
    import numpy as np

    from multimodal_rare_disease_tpu_torch.inference.predictor import (
        MultimodalPredictor,
    )
    from multimodal_rare_disease_tpu_torch.inference.seeded_batch import (
        seeded_requests,
    )
    from multimodal_rare_disease_tpu_torch.kernels import ffn
    from multimodal_rare_disease_tpu_torch.models.classifier import (
        create_model,
    )

    pred = MultimodalPredictor(cfg, create_model(cfg, device="cpu", seed=0),
                               dev)
    images, texts = seeded_requests(2, seed=0)
    k1 = ffn.LAUNCHES_K1
    results = pred.predict_batch(images, texts)
    k1 = ffn.LAUNCHES_K1 - k1
    probs = np.array([list(r["all_probabilities"].values())
                      for r in results])
    assert probs.shape == (2, cfg.num_classes) and np.isfinite(probs).all()
    return (f"full-size {cfg.training.compute_dtype} forward ok on {dev}, "
            f"probs {probs.shape}, fused FFN kernel launches {k1}")


if __name__ == "__main__":
    raise SystemExit(main())
