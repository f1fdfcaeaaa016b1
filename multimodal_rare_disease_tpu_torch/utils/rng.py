"""Host-side seeded RNG streams of the torch package: its own copy of the
numpy half of `multimodal_rare_disease_tpu/utils/rng.py` (which imports
jax, so the port copies the code, not the module), with its
`seed_everything`.

Host randomness (sampling, splits, text augmentation) uses one
`numpy.random.Generator` per named stream, derived from one seed, so the
data order is reproducible and the same as the JAX package's for the
same seed. Device randomness in the port takes an explicit
`torch.Generator` where it is needed.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def seed_everything(seed: int) -> None:
    """Seed global host RNGs (python hash seed is left alone)."""
    import random

    random.seed(seed)
    np.random.seed(seed)


class RngStreams:
    """Named, independent numpy RNG streams derived from one seed."""

    def __init__(self, seed: int):
        self.seed = int(seed)
        self._host_cache: Dict[str, np.random.Generator] = {}

    def host(self, name: str) -> np.random.Generator:
        if name not in self._host_cache:
            self._host_cache[name] = np.random.default_rng(
                np.random.SeedSequence(entropy=self.seed,
                                       spawn_key=(_stable_hash(name),)))
        return self._host_cache[name]


def _stable_hash(s: str) -> int:
    """Deterministic 31-bit string hash (python's hash() is salted)."""
    h = 0
    for ch in s:
        h = (h * 1000003 + ord(ch)) & 0x7FFFFFFF
    return h
