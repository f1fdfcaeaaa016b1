"""Explainability CLI of the torch package: a Grad-CAM overlay, the
text-token attention and the cross-modal attention for one sample, or
with --batch for one corpus image per syndrome. Writes
`<sample>_gradcam.png`, `<sample>_text_attention.png`,
`<sample>_cross_modal.png` (multimodal) and `index.json` to --outdir.

  python -m multimodal_rare_disease_tpu_torch.cli.explain \\
      --checkpoint ckpt/multimodal --image face.png --text "..."
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from multimodal_rare_disease_tpu_torch.cli._common import (
    add_device_arg,
    setup_logging,
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Grad-CAM + attention explainability")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--image", default=None)
    parser.add_argument("--text", default=None)
    parser.add_argument("--outdir", default="results/explain")
    parser.add_argument("--batch", action="store_true",
                        help="run one sample per syndrome from the corpus")
    add_device_arg(parser)
    args = parser.parse_args(argv)
    setup_logging(verbose=False)

    import torch
    from PIL import Image

    from multimodal_rare_disease_tpu_torch.data.images import (
        load_image_uint8,
    )
    from multimodal_rare_disease_tpu_torch.explain import (
        GradCAM,
        cross_modal_attention_summary,
        overlay_heatmap,
        text_token_attention,
    )
    from multimodal_rare_disease_tpu_torch.explain.attention import (
        plot_cross_modal_attention,
        plot_text_attention,
    )
    from multimodal_rare_disease_tpu_torch.inference.predictor import (
        load_predictor,
    )
    from multimodal_rare_disease_tpu_torch.ops.preprocess import (
        eval_preprocess,
    )

    predictor = load_predictor(args.checkpoint, args.device)
    cfg = predictor.cfg
    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)

    samples = []
    if args.batch:
        from collections import defaultdict

        from multimodal_rare_disease_tpu_torch.config import find_image_dir
        from multimodal_rare_disease_tpu_torch.data.clinical_text import (
            load_clinical_descriptions,
        )
        from multimodal_rare_disease_tpu_torch.data.images import (
            scan_image_corpus,
        )

        desc = load_clinical_descriptions(cfg)
        by_class = defaultdict(list)
        for s in scan_image_corpus(find_image_dir(cfg)):
            by_class[s.syndrome].append(s)
        for syndrome, group in sorted(by_class.items()):
            samples.append((group[0].path,
                            desc.get(syndrome, {}).get(
                                "clinical_description", syndrome),
                            syndrome))
    else:
        if not args.image:
            parser.error("--image required (or use --batch)")
        samples.append((args.image, args.text or "", "sample"))

    gc = GradCAM(cfg, predictor.model, mode=predictor.mode)
    index = []
    for img_path, text, name in samples:
        tag = name.replace(" ", "_")
        img = load_image_uint8(img_path, 256)
        if predictor.mode != "image_only" and text:
            ids, mask, _ = predictor.tokenizer.encode(
                text, cfg.data.max_text_length)
            ids_b, mask_b = ids[None], mask[None]
        else:
            ids_b = np.zeros((1, 1), np.int32)
            mask_b = np.ones((1, 1), np.int32)

        cam, logits = gc(img[None], ids_b, mask_b)
        pred_class = int(np.argmax(logits[0]))
        Image.fromarray(overlay_heatmap(img, cam[0])).save(
            outdir / f"{tag}_gradcam.png")
        entry = {"sample": name, "image": str(img_path),
                 "predicted_class": pred_class,
                 "predicted_syndrome": predictor.class_names[pred_class],
                 "gradcam": f"{tag}_gradcam.png"}

        if predictor.mode == "multimodal" and text:
            pairs = text_token_attention(cfg, predictor.model,
                                         predictor.tokenizer, text)
            plot_text_attention(pairs, outdir / f"{tag}_text_attention.png")
            entry["top_tokens"] = sorted(pairs, key=lambda p: -p[1])[:8]
            # the cross-modal maps of this sample's own image
            dev = predictor.device
            with torch.inference_mode():
                x = eval_preprocess(
                    torch.from_numpy(np.require(img[None], np.uint8, "CW"))
                    .to(dev), cfg, dtype=predictor.dtype)
                out = predictor.model(
                    x, torch.from_numpy(ids_b).long().to(dev),
                    torch.from_numpy(mask_b).long().to(dev),
                    return_attention=True)
            plot_cross_modal_attention(
                cross_modal_attention_summary(out["attention_info"]),
                outdir / f"{tag}_cross_modal.png")
            entry["cross_modal"] = f"{tag}_cross_modal.png"

        index.append(entry)
        print(f"[{name}] predicted {entry['predicted_syndrome']} -> "
              f"{tag}_gradcam.png")

    (outdir / "index.json").write_text(json.dumps(index, indent=2,
                                                  default=float))
    print(f"wrote {len(index)} sample(s) to {outdir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
