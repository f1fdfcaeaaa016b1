"""Host image decode of the torch package: `load_image_uint8`, copied
from the JAX package's `data/images.py` (without its optional face
crop, which the port does not have)."""

from __future__ import annotations

import logging

import numpy as np

log = logging.getLogger(__name__)


def load_image_uint8(path: str, size: int = 256) -> np.ndarray:
    """Decode to RGB uint8 [size, size, 3] (bilinear resize when the file
    has another size); a gray placeholder when decoding fails."""
    # PIL only when a path is decoded: a serving host need not have it
    from PIL import Image

    try:
        with Image.open(path) as im:
            arr = np.asarray(im.convert("RGB"), np.uint8)
        if arr.shape[:2] != (size, size):
            arr = np.asarray(
                Image.fromarray(arr).resize((size, size), Image.BILINEAR),
                np.uint8)
        if arr.shape != (size, size, 3):
            raise ValueError(f"bad shape {arr.shape}")
        return arr
    except Exception as e:  # noqa: BLE001
        log.warning("failed to load %s (%s); using gray placeholder", path, e)
        return np.full((size, size, 3), 128, np.uint8)
