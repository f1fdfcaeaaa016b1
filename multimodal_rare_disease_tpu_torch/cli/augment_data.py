"""Offline augmentation CLI of the torch package (the JAX package's
`cli/augment_data.py`; parity: `scripts/generate_augmented_data.py`):

    python -m multimodal_rare_disease_tpu_torch.cli.augment_data \
        --src CORPUS --out OUT [--num 10] [--seed 42]

A host tool (PIL); it writes the JAX CLI's files byte for byte."""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Expand an image corpus with deterministic offline "
                    "augmentations (50 -> 550 style)")
    parser.add_argument("--src", required=True, help="source corpus dir")
    parser.add_argument("--out", required=True,
                        help="output dir (images_augmented layout)")
    parser.add_argument("--num", type=int, default=10,
                        help="augmented copies per image")
    parser.add_argument("--seed", type=int, default=42)
    args = parser.parse_args(argv)

    from multimodal_rare_disease_tpu_torch.data.offline_augment import (
        generate_augmented_dataset,
    )

    counts = generate_augmented_dataset(args.src, args.out,
                                        augmentations_per_image=args.num,
                                        seed=args.seed)
    print(f"wrote {counts['original']} originals + "
          f"{counts['augmented']} augmented images to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
