"""A seeded serving batch for runs on the card: uint8 images at the
256-px staging size and clinical descriptions varied by the augmenter.
`chip_smoke.py` drives the predictor with it and `cli/profile.py`
profiles it, so both measure the same batch."""

from __future__ import annotations

import numpy as np

from multimodal_rare_disease_tpu_torch.config import SYNDROME_NAMES
from multimodal_rare_disease_tpu_torch.data.clinical_text import (
    ClinicalTextAugmenter,
    _builtin_descriptions,
)


def seeded_requests(n: int, seed: int):
    """n seeded (uint8 [256, 256, 3] image, clinical text) pairs; the
    texts cycle through the syndromes at random detail levels."""
    rng = np.random.default_rng(seed)
    aug = ClinicalTextAugmenter(_builtin_descriptions(),
                                rng=np.random.default_rng(seed + 1))
    images = list(rng.integers(0, 256, (n, 256, 256, 3), dtype=np.uint8))
    texts = [aug.augment(SYNDROME_NAMES[i % len(SYNDROME_NAMES)],
                         aug.random_level()) for i in range(n)]
    return images, texts
