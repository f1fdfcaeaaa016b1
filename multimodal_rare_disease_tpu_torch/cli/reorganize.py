"""Corpus reorganization CLI of the torch package (the JAX package's
`cli/reorganize.py`; parity: `scripts/reorganize_images.py`):

    python -m multimodal_rare_disease_tpu_torch.cli.reorganize \
        --src FLAT_CORPUS --out OUT [--move]"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Reorganize a flat SYN_XXX_NNN corpus into "
                    "folder-per-syndrome layout")
    parser.add_argument("--src", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--move", action="store_true",
                        help="move instead of copy")
    args = parser.parse_args(argv)

    from multimodal_rare_disease_tpu_torch.data.offline_augment import (
        reorganize_images,
    )

    counts = reorganize_images(args.src, args.out, move=args.move)
    for syndrome, n in sorted(counts.items()):
        print(f"  {syndrome}: {n}")
    print(f"total: {sum(counts.values())} images -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
