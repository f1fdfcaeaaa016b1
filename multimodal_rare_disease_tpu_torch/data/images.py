"""Image corpus scanning, splits, class balance and host decode of the
torch package: its own copy of the JAX package's `data/images.py`.

- both corpus layouts: flat `SYN_<CODE>_NNN.png` files and
  folder-per-syndrome;
- class counts, inverse-frequency class weights total / (C · count),
  per-sample weights and a seeded weighted sampler;
- the seeded 70/15/15 ratio split, the per-class stratified split with
  at least one validation sample, and the leakage-aware split that keeps
  a photo's `_augNN` / `_orig` variants on one side;
- decode to fixed-size RGB uint8, a gray placeholder for a corrupt file;
- the optional face crop (`data.use_face_detection`): a registered
  detector (MTCNN from an npz, on the caller's device, or the heuristic
  blob detector) gives a box, which is cut out with a 20% margin before
  the image is staged.

PIL is imported only where a file is decoded, so a host that is given
arrays need not have it: the resize to the staging size is
`resize_bilinear_u8`, a numpy copy of PIL's `Image.BILINEAR` for uint8
RGB that gives PIL's bytes.
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


# -- PIL's bilinear resize in numpy -------------------------------------

_PRECISION_BITS = 22  # PIL's fixed point for 8-bit images (Resample.c)


def _pil_bilinear_weights(in_size: int, out_size: int) -> np.ndarray:
    """PIL's `precompute_coeffs` + `normalize_coeffs_8bpc` for the
    bilinear filter: the [out, in] taps in 22-bit fixed point (as
    float64, exact). Support max(in/out, 1) per output pixel, triangle
    weights normalized in double by their running sum."""
    scale = in_size / out_size
    fscale = max(scale, 1.0)
    kk = np.zeros((out_size, in_size), np.float64)
    for o in range(out_size):
        center = (o + 0.5) * scale
        xmin = max(int(center - fscale + 0.5), 0)
        xmax = min(int(center + fscale + 0.5), in_size)
        x = np.arange(xmin, xmax)
        k = np.maximum(0.0, 1.0 - np.abs((x - center + 0.5)
                                         * (1.0 / fscale)))
        total = np.cumsum(k)[-1] if len(k) else 0.0  # C's sequential sum
        kk[o, xmin:xmax] = k / total if total != 0.0 else k
    return np.trunc(kk * (1 << _PRECISION_BITS) + 0.5)


def _pil_pass(x: np.ndarray, kk: np.ndarray) -> np.ndarray:
    """One pass over the last axis: the products (< 2^31, exact in
    float64) summed from 1 << 21, shifted right by 22, clipped."""
    acc = x.astype(np.float64) @ kk.T + (1 << (_PRECISION_BITS - 1))
    return np.clip(np.floor(acc / (1 << _PRECISION_BITS)), 0,
                   255).astype(np.uint8)


def resize_bilinear_u8(arr: np.ndarray, height: int,
                       width: int) -> np.ndarray:
    """uint8 [H, W, C] → [height, width, C], byte for byte what
    `Image.fromarray(arr).resize((width, height), Image.BILINEAR)` gives:
    the horizontal pass, then the vertical one, with a uint8 image in
    between."""
    h, w = arr.shape[:2]
    out = arr
    if width != w:
        out = np.moveaxis(_pil_pass(np.moveaxis(out, 1, -1),
                                    _pil_bilinear_weights(w, width)), -1, 1)
    if height != h:
        out = np.moveaxis(_pil_pass(np.moveaxis(out, 0, -1),
                                    _pil_bilinear_weights(h, height)), -1, 0)
    return np.ascontiguousarray(out)


# -- face-detection hook -------------------------------------------------
#
# A detector is any callable mapping an RGB uint8 array to a (top, left,
# height, width) crop box or None (the JAX package's hook, after the
# reference's optional MTCNN FaceDetector). A detector that raises leaves
# the full frame, as in the JAX package, and is counted in
# FACE_DETECTOR_FAILURES, so that a device error cannot pass as "no
# face" unnoticed.

_FACE_DETECTOR = None
FACE_DETECTOR_FAILURES = 0


def set_face_detector(detector) -> None:
    """Install a face detector: callable(np.uint8 [H,W,3]) ->
    (top, left, height, width) or None. Pass None to disable."""
    global _FACE_DETECTOR
    _FACE_DETECTOR = detector


def configure_face_detection(cfg, device="cuda") -> None:
    """Install (or clear) the face-detection hook from config
    (`data.use_face_detection` / `data.face_detector` /
    `data.mtcnn_weights`); an MTCNN detector's nets run on `device`, the
    card unless the caller asks for the CPU. Called by the data pipeline
    at corpus load."""
    d = cfg.data if hasattr(cfg, "data") else cfg
    if not getattr(d, "use_face_detection", False):
        set_face_detector(None)
        return
    from multimodal_rare_disease_tpu_torch.models.mtcnn import (
        build_face_detector,
    )

    set_face_detector(build_face_detector(
        getattr(d, "face_detector", "auto"),
        getattr(d, "mtcnn_weights", ""), device=device))


def _face_crop(arr: np.ndarray) -> np.ndarray:
    """Apply the registered detector with a 20% margin, like the
    reference's FaceDetector.detect_and_crop (fallback: the full
    frame)."""
    global FACE_DETECTOR_FAILURES
    if _FACE_DETECTOR is None:
        return arr
    try:
        box = _FACE_DETECTOR(arr)
    except Exception as e:  # noqa: BLE001 — detector failure = resize path
        FACE_DETECTOR_FAILURES += 1
        log.warning("face detector failed (%s); using full frame", e)
        return arr
    if box is None:
        return arr
    top, left, h, w = (int(v) for v in box)
    m_h, m_w = int(h * 0.2), int(w * 0.2)
    y0 = max(0, top - m_h)
    x0 = max(0, left - m_w)
    y1 = min(arr.shape[0], top + h + m_h)
    x1 = min(arr.shape[1], left + w + m_w)
    if y1 <= y0 or x1 <= x0:
        return arr
    return arr[y0:y1, x0:x1]


def stage_uint8(arr: np.ndarray, size: int = 256) -> np.ndarray:
    """A decoded RGB uint8 image → [size, size, 3]: the face crop when a
    detector is installed, then PIL's bilinear resize."""
    if _FACE_DETECTOR is not None:
        arr = _face_crop(arr)
    if arr.shape[:2] != (size, size):
        arr = resize_bilinear_u8(arr, size, size)
    if arr.shape != (size, size, 3):
        raise ValueError(f"bad shape {arr.shape}")
    return arr


# -- host decode ----------------------------------------------------------

def load_image_uint8(path: str, size: int = 256) -> np.ndarray:
    """Decode to RGB uint8 [size, size, 3]; the face crop when a detector
    is installed (see set_face_detector), PIL's bilinear resize; a gray
    placeholder when decoding fails."""
    from PIL import Image

    try:
        with Image.open(path) as im:
            arr = np.asarray(im.convert("RGB"), np.uint8)
        return stage_uint8(arr, size)
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
