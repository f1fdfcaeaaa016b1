"""Synthetic image generation: the torch package's own copy of
`multimodal_rare_disease_tpu/data/synthetic.py` (pinned equal to it by
tests/test_torch_host_copies.py). `generate` returns numpy arrays; PIL
is imported only where PNGs are written, so the arrays can be drawn on a
machine without it.

Role parity with `src/synthetic_image_generator.py`: the reference wraps
an external StyleGAN3 pickle (PDIDB, not vendored, network-dependent) to
produce class-conditional synthetic faces. This framework cannot assume
that external dependency either, so the default generator is procedural:
deterministic, class-conditioned structured noise images (per-class color
palette + oriented texture + blob layout) that are (a) hermetic, (b)
learnable — a classifier can separate the classes — and (c) fast. The
`SyntheticImageGenerator` API mirrors the reference's (generate N per
syndrome into per-class folders with SYN_<CODE>_NNN.png naming) so a real
generative backend can be slotted in behind the same interface.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from multimodal_rare_disease_tpu_torch.config import (
    PREFIX_TO_SYNDROME,
    SYNDROME_NAMES,
)

_SYNDROME_TO_PREFIX = {v: k for k, v in PREFIX_TO_SYNDROME.items()}


class SyntheticImageGenerator:
    """Class-conditional procedural image generator (ref API:
    generate(class_idx), generate_dataset(outdir, num_per_class))."""

    def __init__(self, image_size: int = 256, seed: int = 42,
                 truncation_psi: float = 0.7):
        self.image_size = image_size
        self.seed = seed
        # truncation_psi kept for API parity; maps to texture contrast here
        self.truncation_psi = truncation_psi

    def _class_palette(self, class_idx: int) -> np.ndarray:
        rng = np.random.default_rng(1000 + class_idx)
        return rng.uniform(60, 200, size=(3, 3))  # 3 palette colors

    def generate(self, class_idx: int, sample_idx: int = 0) -> np.ndarray:
        """→ uint8 [S, S, 3] deterministic in (class, sample, seed)."""
        S = self.image_size
        rng = np.random.default_rng(
            self.seed * 1_000_003 + class_idx * 1009 + sample_idx)
        palette = self._class_palette(class_idx)

        yy, xx = np.mgrid[0:S, 0:S].astype(np.float32) / S
        # class-specific orientation & frequency texture
        theta = (class_idx / len(SYNDROME_NAMES)) * np.pi
        freq = 4 + (class_idx % 5) * 3
        wave = np.sin(2 * np.pi * freq *
                      (np.cos(theta) * xx + np.sin(theta) * yy)
                      + rng.uniform(0, 2 * np.pi))

        # sample-specific soft blobs
        img = np.zeros((S, S, 3), np.float32)
        base = palette[0]
        img += base[None, None, :]
        for b in range(4):
            cy, cx = rng.uniform(0.2, 0.8, 2)
            rad = rng.uniform(0.08, 0.25)
            blob = np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * rad ** 2)))
            color = palette[1 + b % 2]
            img += blob[..., None] * (color - base)[None, None, :] * 0.8

        contrast = 30.0 * self.truncation_psi
        img += wave[..., None] * contrast
        img += rng.normal(0, 6, size=(S, S, 3))
        return np.clip(img, 0, 255).astype(np.uint8)

    def generate_for_syndrome(self, syndrome: str, num: int
                              ) -> List[np.ndarray]:
        idx = SYNDROME_NAMES.index(syndrome)
        return [self.generate(idx, i) for i in range(num)]

    def generate_dataset(
        self,
        outdir: str | Path,
        num_per_class: int = 5,
        syndromes: Optional[Sequence[str]] = None,
        flat: bool = True,
    ) -> Dict[str, List[str]]:
        """Write PNGs in the corpus layouts the loaders understand."""
        from PIL import Image

        outdir = Path(outdir)
        outdir.mkdir(parents=True, exist_ok=True)
        written: Dict[str, List[str]] = {}
        for name in (syndromes or SYNDROME_NAMES):
            code = _SYNDROME_TO_PREFIX[name]
            cls = SYNDROME_NAMES.index(name)
            paths = []
            target = outdir if flat else outdir / f"SYN_{code}"
            target.mkdir(parents=True, exist_ok=True)
            for i in range(num_per_class):
                arr = self.generate(cls, i)
                p = target / f"SYN_{code}_{i + 1:03d}.png"
                Image.fromarray(arr).save(p)
                paths.append(str(p))
            written[name] = paths
        return written


def generate_synthetic_for_training(outdir: str | Path, num_per_class: int = 5,
                                    image_size: int = 256, seed: int = 42,
                                    flat: bool = True) -> Dict[str, List[str]]:
    """Convenience wrapper (ref `generate_synthetic_for_training`)."""
    return SyntheticImageGenerator(image_size, seed).generate_dataset(
        outdir, num_per_class, flat=flat)
