"""Offline corpus augmentation (deterministic, PIL-based): the torch
package's own copy of `multimodal_rare_disease_tpu/data/offline_augment.py`,
which writes the same files byte for byte for the same seed.

Expand a small corpus (either layout) into
`images_augmented/SYN_<CODE>/<stem>_{orig,augNN}.png` with a fixed menu
of augmentation types (flip / rotations / brightness / contrast /
saturation / zoom / blur / combinations), seeded per image so the
expansion is reproducible: 50 images × (1 + 10) → 550 files. Also the
flat → folder-per-syndrome reorganization.

This is host tooling for corpus preparation; the online training path
augments on the device (ops/preprocess.py). PIL is imported where an
image is read or changed, not with the module.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, Sequence

import numpy as np

from multimodal_rare_disease_tpu_torch.config import PREFIX_TO_SYNDROME
from multimodal_rare_disease_tpu_torch.data.images import scan_image_corpus
from multimodal_rare_disease_tpu_torch.utils.rng import _stable_hash

_SYNDROME_TO_PREFIX = {v: k for k, v in PREFIX_TO_SYNDROME.items()}


def _flip(im, rng):
    from PIL import Image

    return im.transpose(Image.FLIP_LEFT_RIGHT)


def _rotate(im, rng):
    from PIL import Image

    return im.rotate(float(rng.uniform(-15, 15)), resample=Image.BILINEAR,
                     fillcolor=(128, 128, 128))


def _brightness(im, rng):
    from PIL import ImageEnhance

    return ImageEnhance.Brightness(im).enhance(float(rng.uniform(0.7, 1.3)))


def _contrast(im, rng):
    from PIL import ImageEnhance

    return ImageEnhance.Contrast(im).enhance(float(rng.uniform(0.7, 1.3)))


def _saturation(im, rng):
    from PIL import ImageEnhance

    return ImageEnhance.Color(im).enhance(float(rng.uniform(0.7, 1.3)))


def _zoom(im, rng):
    from PIL import Image

    w, h = im.size
    frac = float(rng.uniform(0.82, 0.95))
    cw, ch = int(w * frac), int(h * frac)
    x0 = int(rng.uniform(0, w - cw))
    y0 = int(rng.uniform(0, h - ch))
    return im.crop((x0, y0, x0 + cw, y0 + ch)).resize((w, h), Image.BILINEAR)


def _blur(im, rng):
    from PIL import ImageFilter

    return im.filter(ImageFilter.GaussianBlur(float(rng.uniform(0.5, 1.2))))


def _flip_rotate(im, rng):
    return _rotate(_flip(im, rng), rng)


def _zoom_brightness(im, rng):
    return _brightness(_zoom(im, rng), rng)


def _rotate_contrast(im, rng):
    return _contrast(_rotate(im, rng), rng)


AUGMENTATION_TYPES: Dict[str, Callable] = {
    "flip": _flip,
    "rotate": _rotate,
    "brightness": _brightness,
    "contrast": _contrast,
    "saturation": _saturation,
    "zoom": _zoom,
    "blur": _blur,
    "flip_rotate": _flip_rotate,
    "zoom_brightness": _zoom_brightness,
    "rotate_contrast": _rotate_contrast,
}


def augment_image(im, aug_type: str, rng: np.random.Generator):
    """A PIL image → its `aug_type` augmentation, drawn from `rng`."""
    if aug_type not in AUGMENTATION_TYPES:
        raise KeyError(f"unknown augmentation {aug_type!r}; "
                       f"available: {sorted(AUGMENTATION_TYPES)}")
    return AUGMENTATION_TYPES[aug_type](im, rng)


def generate_augmented_dataset(
    src_dir: str | Path,
    out_dir: str | Path,
    augmentations_per_image: int = 10,
    seed: int = 42,
    aug_types: Sequence[str] = tuple(AUGMENTATION_TYPES),
) -> Dict[str, int]:
    """Expand src corpus → out_dir/SYN_<CODE>/<stem>_{orig,augNN}.png."""
    from PIL import Image

    samples = scan_image_corpus(src_dir)
    out_dir = Path(out_dir)
    counts = {"original": 0, "augmented": 0}
    for s in samples:
        code = _SYNDROME_TO_PREFIX[s.syndrome]
        target = out_dir / f"SYN_{code}"
        target.mkdir(parents=True, exist_ok=True)
        stem = Path(s.path).stem
        with Image.open(s.path) as im:
            im = im.convert("RGB")
            im.save(target / f"{stem}_orig.png")
            counts["original"] += 1
            rng = np.random.default_rng(seed * 11_113 + _stable_hash(stem))
            for i in range(augmentations_per_image):
                aug_type = aug_types[i % len(aug_types)]
                out = augment_image(im, aug_type, rng)
                out.save(target / f"{stem}_aug{i:02d}.png")
                counts["augmented"] += 1
    return counts


def reorganize_images(src_dir: str | Path, out_dir: str | Path,
                      move: bool = False) -> Dict[str, int]:
    """Flat `SYN_XXX_NNN.png` → `out_dir/<Syndrome_Folder>/` (parity with
    `scripts/reorganize_images.py`)."""
    import shutil

    samples = scan_image_corpus(src_dir)
    out_dir = Path(out_dir)
    counts: Dict[str, int] = {}
    for s in samples:
        folder = out_dir / s.syndrome.replace(" ", "_")
        folder.mkdir(parents=True, exist_ok=True)
        dst = folder / Path(s.path).name
        (shutil.move if move else shutil.copy2)(s.path, dst)
        counts[s.syndrome] = counts.get(s.syndrome, 0) + 1
    return counts
