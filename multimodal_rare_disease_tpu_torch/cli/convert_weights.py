"""Offline pretrained-weight conversion CLI: user-supplied torchvision /
Hugging Face files (no network) → a port checkpoint that
`inference/predictor.py::load_predictor` opens.

  # torchvision resnet50 state dict (.pt/.pth)
  python -m multimodal_rare_disease_tpu_torch.cli.convert_weights \
      --backbone resnet50.pth --out checkpoints/imagenet_backbone

  # HF BioBERT directory (pytorch_model.bin or model.safetensors, and
  # vocab.txt)
  python -m multimodal_rare_disease_tpu_torch.cli.convert_weights \
      --hf-bert /path/to/biobert --out checkpoints/biobert

The flags are the JAX CLI's, with `--device` for `--platform`, and
`--preset` / `--set` for the model's config. The JAX CLI writes the
converted subtrees alone; this one writes the whole multimodal model of
that config (default: the "multimodal" preset), its other weights
seeded (seed 0), with the converted ones merged over them
(`models/convert.py::merge_converted`, which fails on a weight that does
not land): a torchvision EfficientNet-B0 file when the preset's backbone
is EfficientNet-B0, a ResNet-50 file otherwise; the text tower sized
from the BERT file. `meta` holds the config, the mode, the converted
sources and, from a BERT directory's vocab.txt, the vocab.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from multimodal_rare_disease_tpu_torch.cli._common import (
    add_config_args,
    build_config,
)


def _load_bert(path: str):
    """(state dict, vocab file or None, the file read) of an HF model
    directory or a state-dict file."""
    from multimodal_rare_disease_tpu_torch.models.convert import (
        load_torch_state_dict,
    )

    src = sd_file = Path(path)
    vocab_file = None
    if src.is_dir():
        for cand in ("pytorch_model.bin", "model.pt", "model.safetensors"):
            if (src / cand).exists():
                sd_file = src / cand
                break
        if (src / "vocab.txt").exists():
            vocab_file = src / "vocab.txt"
    if str(sd_file).endswith(".safetensors"):
        from safetensors.torch import load_file  # optional dependency

        return load_file(str(sd_file)), vocab_file, sd_file
    return load_torch_state_dict(str(sd_file)), vocab_file, sd_file


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Convert torch/HF weights")
    parser.add_argument("--backbone", default=None,
                        help="torchvision resnet50 (or efficientnet_b0, "
                             "with an EfficientNet preset) state_dict file")
    parser.add_argument("--hf-bert", default=None,
                        help="HF BERT model dir or state_dict file")
    parser.add_argument("--out", required=True, help="output checkpoint dir")
    parser.add_argument("--num-layers", type=int, default=12)
    parser.add_argument("--num-heads", type=int, default=12)
    add_config_args(parser)
    args = parser.parse_args(argv)

    if not args.backbone and not args.hf_bert:
        parser.error("provide --backbone and/or --hf-bert")

    from multimodal_rare_disease_tpu_torch.models import convert
    from multimodal_rare_disease_tpu_torch.models.classifier import (
        create_model,
    )
    from multimodal_rare_disease_tpu_torch.utils.checkpoint import (
        save_checkpoint,
    )

    overrides, meta = {}, {"converted": [], "mode": "multimodal"}
    bert = None
    if args.hf_bert:
        sd, vocab_file, sd_file = _load_bert(args.hf_bert)
        bert = convert.convert_hf_bert(sd, num_layers=args.num_layers,
                                       num_heads=args.num_heads)
        vocab, hidden = bert["word_embeddings.weight"].shape
        overrides.update({
            "text_encoder.num_layers": args.num_layers,
            "text_encoder.num_heads": args.num_heads,
            "text_encoder.vocab_size": vocab,
            "text_encoder.hidden_size": hidden,
            "text_encoder.embedding_dim": hidden,
            "text_encoder.intermediate_size":
                bert["layer0.intermediate.weight"].shape[0],
            "text_encoder.max_position_embeddings":
                bert["position_embeddings.weight"].shape[0],
            "text_encoder.type_vocab_size":
                bert["token_type_embeddings.weight"].shape[0]})
        meta["converted"].append(f"bert:{sd_file}")
        if vocab_file:
            with open(vocab_file, encoding="utf-8") as f:
                meta["vocab"] = [line.rstrip("\n") for line in f
                                 if line.strip()]
            print(f"embedded vocab ({len(meta['vocab'])} tokens)")
        print(f"converted BERT encoder from {sd_file}")

    cfg = build_config(args, "multimodal", overrides)
    state = create_model(cfg, device=args.device, seed=0).state_dict()
    if args.backbone:
        sd = convert.load_torch_state_dict(args.backbone)
        if cfg.cnn_encoder.backbone.replace("-", "_") == "efficientnet_b0":
            arch, fn = "efficientnet_b0", \
                convert.convert_torchvision_efficientnet_b0
        else:
            arch, fn = "resnet50", convert.convert_torchvision_resnet50
        state = convert.merge_converted(state, fn(sd), "cnn_encoder.backbone.")
        meta["converted"].append(f"{arch}:{args.backbone}")
        print(f"converted {arch} backbone from {args.backbone}")
    if bert is not None:
        state = convert.merge_converted(state, bert, "text_encoder.bert.")

    meta["config"] = cfg.to_dict()
    save_checkpoint(args.out, state, meta)
    print(f"wrote converted weights to {args.out} (load with "
          f"inference/predictor.py::load_predictor)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
