"""Phases 13 and 14 of chip_smoke.py alone, after the build and the
references of phases 4 and 7 (their kernels-off and f32 probabilities)."""
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main():
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

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    build.build()
    build.load_library(dev)
    card = cs.card_line()
    print(f"built in {time.perf_counter() - t0:.1f} s | {card}", flush=True)
    images, texts = seeded_requests(cs.BATCH, seed=0)
    over7 = {"text_encoder.fused_attn_out": True, "data.image_size": 256}
    refs, probs4 = {}, None
    for tag, over in (("default path", {}), ("fused-sublayer path", over7)):
        cfg = resolve_config("default", over)
        p = MultimodalPredictor(cfg, create_model(cfg, device="cpu",
                                                  seed=0), dev)
        probs = cs.probs_of(p.predict_batch(images, texts), p.class_names)
        with cs.plain_kernels():
            plain = cs.probs_of(p.predict_batch(images, texts),
                                p.class_names)
            cfg32 = resolve_config("default", {
                **over, "training.compute_dtype": "float32"})
            ref = MultimodalPredictor(
                cfg32, create_model(cfg32, device="cpu", seed=0), dev)
            torch.backends.cudnn.allow_tf32 = False
            f32 = cs.probs_of(ref.predict_batch(images, texts),
                              p.class_names)
            torch.backends.cudnn.allow_tf32 = True
        refs[tag] = (plain, f32)
        if probs4 is None:
            probs4 = probs
        del p, ref
        torch.cuda.empty_cache()
    print(f"references in {time.perf_counter() - t0:.1f} s", flush=True)

    def p50_ms(p, batch_images=None):
        imgs = images if batch_images is None else batch_images
        for _ in range(2):
            p.predict_batch(imgs, texts)
        lat = []
        for _ in range(cs.TIMED_RUNS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            p.predict_batch(imgs, texts)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t) * 1e3)
        return float(np.median(lat)), lat

    m13 = cs.mesh_phase(dev, card, probs4, refs, over7)
    m14 = cs.quantized_and_flat(dev, card, images, texts, refs, p50_ms)
    print("launches 13", m13, "14", m14)
    print(f"driver took {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
