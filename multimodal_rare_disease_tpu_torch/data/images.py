"""Image corpus scanning, splits, class balance and host decode of the
torch package: its own copy of the JAX package's `data/images.py`.

- both corpus layouts: flat `SYN_<CODE>_NNN.png` files and
  folder-per-syndrome;
- class counts, inverse-frequency class weights total / (C · count),
  per-sample weights and a seeded weighted sampler;
- the seeded 70/15/15 ratio split, the per-class stratified split with
  at least one validation sample, and the leakage-aware split that keeps
  a photo's `_augNN` / `_orig` variants on one side;
- decode to fixed-size RGB uint8, a gray placeholder for a corrupt file.

PIL is imported only where a file is decoded, so a host that is given
arrays need not have it. The JAX package's optional face crop (MTCNN or a
heuristic detector) is not ported: `configure_face_detection` raises for
`data.use_face_detection=True`.
"""

from __future__ import annotations

import logging
import os
import re
from collections import defaultdict
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from multimodal_rare_disease_tpu_torch.config import (
    FOLDER_TO_SYNDROME,
    PREFIX_TO_SYNDROME,
    SYNDROME_NAMES,
)

log = logging.getLogger(__name__)

_IMAGE_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".webp"}
_PREFIX_UPPER = {k.upper(): v for k, v in PREFIX_TO_SYNDROME.items()}
_FLAT_RE = re.compile(r"^SYN_([A-Za-z0-9]+)_(\d+)")
_AUG_RE = re.compile(r"_(aug\d+|orig)$")


@dataclass(frozen=True)
class ImageSample:
    path: str
    label: int
    syndrome: str

    @property
    def base_id(self) -> str:
        """Identity of the underlying source image, stripping `_augNN`/`_orig`
        suffixes so augmented copies of one photo never straddle a split."""
        return _AUG_RE.sub("", Path(self.path).stem)


def scan_image_corpus(image_dir: str | os.PathLike) -> List[ImageSample]:
    """Discover (path, label) pairs in either supported layout."""
    image_dir = Path(image_dir)
    if not image_dir.is_dir():
        raise FileNotFoundError(f"image dir not found: {image_dir}")
    samples: List[ImageSample] = []

    for d in sorted(image_dir.iterdir()):
        if not d.is_dir():
            continue
        syndrome = FOLDER_TO_SYNDROME.get(d.name)
        if syndrome is None:
            log.warning("skipping unrecognized class folder %s", d.name)
            continue
        label = SYNDROME_NAMES.index(syndrome)
        for f in sorted(d.iterdir()):
            if f.suffix.lower() in _IMAGE_EXTS:
                samples.append(ImageSample(str(f), label, syndrome))

    for f in sorted(image_dir.iterdir()):  # flat layout
        if not f.is_file() or f.suffix.lower() not in _IMAGE_EXTS:
            continue
        m = _FLAT_RE.match(f.stem)
        if not m:
            log.warning("skipping unrecognized flat file %s", f.name)
            continue
        syndrome = _PREFIX_UPPER.get(m.group(1).upper())
        if syndrome is None:
            log.warning("unknown syndrome code in %s", f.name)
            continue
        samples.append(ImageSample(str(f), SYNDROME_NAMES.index(syndrome),
                                   syndrome))

    if not samples:
        raise ValueError(f"no recognized images under {image_dir}")
    return samples


# -- class balance -------------------------------------------------------

def class_counts(samples: Sequence[ImageSample],
                 num_classes: int = len(SYNDROME_NAMES)) -> np.ndarray:
    counts = np.zeros((num_classes,), np.int64)
    for s in samples:
        counts[s.label] += 1
    return counts


def class_weights(samples: Sequence[ImageSample],
                  num_classes: int = len(SYNDROME_NAMES)) -> np.ndarray:
    """Inverse-frequency weights: total / (num_classes * count)."""
    counts = class_counts(samples, num_classes).astype(np.float64)
    total = counts.sum()
    w = np.where(counts > 0, total / (num_classes * np.maximum(counts, 1)),
                 0.0)
    return w.astype(np.float32)


def sample_weights(samples: Sequence[ImageSample],
                   num_classes: int = len(SYNDROME_NAMES)) -> np.ndarray:
    cw = class_weights(samples, num_classes)
    return np.array([cw[s.label] for s in samples], np.float32)


class WeightedSampler:
    """Seeded replacement sampler over per-sample weights."""

    def __init__(self, weights: np.ndarray, num_samples: Optional[int] = None,
                 rng: Optional[np.random.Generator] = None):
        self.p = np.asarray(weights, np.float64)
        self.p = self.p / self.p.sum()
        self.num_samples = (num_samples if num_samples is not None
                            else len(weights))
        self.rng = rng if rng is not None else np.random.default_rng(0)

    def sample_epoch(self) -> np.ndarray:
        return self.rng.choice(len(self.p), size=self.num_samples,
                               replace=True, p=self.p)


# -- splits ---------------------------------------------------------------

def ratio_split(
    samples: Sequence[ImageSample],
    train_ratio: float = 0.70,
    val_ratio: float = 0.15,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[List[ImageSample], List[ImageSample], List[ImageSample]]:
    """Seeded shuffle split into train/val/test."""
    rng = rng if rng is not None else np.random.default_rng(42)
    idx = rng.permutation(len(samples))
    n_train = int(len(samples) * train_ratio)
    n_val = int(len(samples) * val_ratio)

    def take(sl):
        return [samples[i] for i in sl]

    return (take(idx[:n_train]), take(idx[n_train:n_train + n_val]),
            take(idx[n_train + n_val:]))


def stratified_split(
    samples: Sequence[ImageSample],
    val_fraction: float = 0.15,
    min_val_per_class: int = 1,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[List[ImageSample], List[ImageSample]]:
    """Per-class split guaranteeing >= min_val_per_class validation
    samples."""
    rng = rng if rng is not None else np.random.default_rng(42)
    by_class: Dict[int, List[ImageSample]] = defaultdict(list)
    for s in samples:
        by_class[s.label].append(s)
    train: List[ImageSample] = []
    val: List[ImageSample] = []
    for label in sorted(by_class):
        group = by_class[label]
        idx = rng.permutation(len(group))
        n_val = max(min_val_per_class, int(round(len(group) * val_fraction)))
        n_val = min(n_val, max(1, len(group) - 1))
        val.extend(group[i] for i in idx[:n_val])
        train.extend(group[i] for i in idx[n_val:])
    return train, val


def leakage_aware_split(
    samples: Sequence[ImageSample],
    val_fraction: float = 0.15,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[List[ImageSample], List[ImageSample]]:
    """Group augmented variants by base image; whole groups go to one
    side. Stratified per class over groups, >= 1 val group per class when
    a class has >= 2 groups."""
    rng = rng if rng is not None else np.random.default_rng(42)
    groups: Dict[Tuple[int, str], List[ImageSample]] = defaultdict(list)
    for s in samples:
        groups[(s.label, s.base_id)].append(s)
    by_class: Dict[int, List[List[ImageSample]]] = defaultdict(list)
    for (label, _), grp in sorted(groups.items(), key=lambda kv: kv[0]):
        by_class[label].append(grp)
    train: List[ImageSample] = []
    val: List[ImageSample] = []
    for label in sorted(by_class):
        grps = by_class[label]
        idx = rng.permutation(len(grps))
        n_val_groups = (max(1, int(round(len(grps) * val_fraction)))
                        if len(grps) >= 2 else 0)
        for j, gi in enumerate(idx):
            (val if j < n_val_groups else train).extend(grps[gi])
    return train, val


# -- host decode ----------------------------------------------------------

def configure_face_detection(cfg) -> None:
    """The JAX package installs a face detector here when
    `data.use_face_detection` is on; the port has none yet."""
    d = cfg.data if hasattr(cfg, "data") else cfg
    if getattr(d, "use_face_detection", False):
        raise NotImplementedError(
            "data.use_face_detection (the MTCNN / heuristic face crop) is "
            "not ported to the torch package")


def load_image_uint8(path: str, size: int = 256) -> np.ndarray:
    """Decode to RGB uint8 [size, size, 3] (bilinear resize when the file
    has another size); a gray placeholder when decoding fails."""
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


def load_corpus_arrays(
    samples: Sequence[ImageSample], size: int = 256
) -> Tuple[np.ndarray, np.ndarray]:
    """Decode a whole (small) corpus to a stacked uint8 array + labels."""
    imgs = np.stack([load_image_uint8(s.path, size) for s in samples])
    labels = np.array([s.label for s in samples], np.int32)
    return imgs, labels
