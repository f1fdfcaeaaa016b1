"""Synthetic corpus generation CLI of the torch package (the JAX
package's `cli/generate_synthetic.py`; parity:
`src/synthetic_image_generator.py` `--network --outdir --num --trunc
--seed`, the network pickle replaced by built-in backends: 'procedural'
(hermetic structured noise) or 'vae' (the class-conditional conv VAE of
`data/generative.py`, trained on the image corpus first, on `--device`,
the card unless `--device cpu` is given):

    python -m multimodal_rare_disease_tpu_torch.cli.generate_synthetic \
        --outdir OUT [--backend vae --image-dir CORPUS --epochs 400]
"""

from __future__ import annotations

import argparse

from multimodal_rare_disease_tpu_torch.cli._common import add_device_arg


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Generate a class-conditional synthetic face corpus")
    parser.add_argument("--outdir", required=True)
    parser.add_argument("--num", type=int, default=5, help="images per class")
    parser.add_argument("--size", type=int, default=256)
    parser.add_argument("--trunc", type=float, default=0.7,
                        help="truncation_psi: latent scale (vae) / texture "
                             "contrast (procedural)")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--backend", choices=("procedural", "vae"),
                        default="procedural",
                        help="'vae' trains a small class-conditional VAE on "
                             "the image corpus first (learned backend)")
    parser.add_argument("--image-dir", default=None,
                        help="training corpus for --backend vae")
    parser.add_argument("--epochs", type=int, default=400,
                        help="VAE training epochs")
    parser.add_argument("--foldered", action="store_true",
                        help="folder-per-class layout instead of flat")
    add_device_arg(parser)
    args = parser.parse_args(argv)

    if args.backend == "vae":
        from multimodal_rare_disease_tpu_torch.data.generative import (
            VAEImageGenerator,
        )

        print(f"training conv VAE on the corpus ({args.epochs} epochs)...")
        gen = VAEImageGenerator.train_on_corpus(
            image_dir=args.image_dir, image_size=args.size, seed=args.seed,
            num_epochs=args.epochs, device=args.device)
        gen.truncation_psi = args.trunc
    else:
        from multimodal_rare_disease_tpu_torch.data.synthetic import (
            SyntheticImageGenerator,
        )

        gen = SyntheticImageGenerator(args.size, args.seed, args.trunc)
    written = gen.generate_dataset(args.outdir, args.num,
                                   flat=not args.foldered)
    total = sum(len(v) for v in written.values())
    print(f"wrote {total} images ({args.num}/class) to {args.outdir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
