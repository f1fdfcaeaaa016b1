"""Host-side data pipeline: corpus → fixed-shape batches. The torch
package's own copy (numpy only) of the JAX package's
`train/pipeline.py`, giving the same batches for the same seed and
corpus, key for key and byte for byte.

- the decoded corpus lives in host RAM as one uint8 array at the 256-px
  staging size; the model's preprocess resamples it on the device;
- clinical text variants are pre-generated per (class, level) into a
  tokenized pool, so a batch's text is an integer gather;
- every batch has the same static shapes; the final val batch is padded
  and carries a `valid` mask, so metrics stay exact;
- in the device-resident mode the whole decoded corpus and the text pool
  are copied to the device once (`device_corpus`), and each step's batch
  is only index arrays (`train_index_batches`, `val_index_batches`).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, Mapping, Optional, Sequence

import numpy as np

from multimodal_rare_disease_tpu_torch.config import (
    SYNDROME_NAMES,
    Config,
    find_image_dir,
)
from multimodal_rare_disease_tpu_torch.data.clinical_text import (
    ClinicalTextAugmenter,
    load_clinical_descriptions,
)
from multimodal_rare_disease_tpu_torch.data.images import (
    ImageSample,
    WeightedSampler,
    class_weights,
    configure_face_detection,
    leakage_aware_split,
    load_corpus_arrays,
    sample_weights,
    scan_image_corpus,
    stage_uint8,
    stratified_split,
)
from multimodal_rare_disease_tpu_torch.data.tokenizer import (
    BertWordPieceTokenizer,
    get_tokenizer,
)
from multimodal_rare_disease_tpu_torch.utils.rng import RngStreams

STAGING_SIZE = 256  # host decode size; the device crops/resizes
TEXT_POOL_VARIANTS = 16  # pre-generated text variants per (class, level)
NUM_TEXT_LEVELS = 4


@dataclass
class TextPool:
    """Tokenized text variants: ids/mask [C, L, V, T]."""

    ids: np.ndarray
    mask: np.ndarray

    def gather(self, labels: np.ndarray, levels: np.ndarray,
               variants: np.ndarray):
        return (self.ids[labels, levels, variants],
                self.mask[labels, levels, variants])


def build_text_pool(
    cfg: Config,
    tokenizer: BertWordPieceTokenizer,
    rng: np.random.Generator,
    descriptions: Optional[dict] = None,
) -> TextPool:
    desc = descriptions or load_clinical_descriptions(cfg)
    aug = ClinicalTextAugmenter(desc, rng)
    t = cfg.data.max_text_length
    c, n_lvl, n_var = len(SYNDROME_NAMES), NUM_TEXT_LEVELS, TEXT_POOL_VARIANTS
    ids = np.zeros((c, n_lvl, n_var, t), np.int32)
    mask = np.zeros((c, n_lvl, n_var, t), np.int32)
    for ci, name in enumerate(SYNDROME_NAMES):
        for lvl in range(n_lvl):
            for v in range(n_var):
                i, m, _ = tokenizer.encode(aug.augment(name, lvl), t)
                ids[ci, lvl, v] = i
                mask[ci, lvl, v] = m
    return TextPool(ids, mask)


class DataPipeline:
    """Train/val batch source for one mode over the image corpus."""

    def __init__(
        self,
        cfg: Config,
        mode: str = "multimodal",
        rngs: Optional[RngStreams] = None,
        image_dir: Optional[str] = None,
        tokenizer: Optional[BertWordPieceTokenizer] = None,
        samples: Optional[Sequence[ImageSample]] = None,
        decoded: Optional[Mapping[str, np.ndarray]] = None,
        device="cuda",
    ):
        """`decoded`: each sample's decoded RGB uint8 image by its path,
        used in place of reading the files (an in-memory corpus, e.g.
        `data/synthetic.py`'s arrays); it takes the face crop and the
        resize to STAGING_SIZE as a decoded file does. `device`: where
        an MTCNN face detector's nets run (`data.use_face_detection`)."""
        self.cfg = cfg
        self.mode = mode
        self.rngs = rngs or RngStreams(cfg.seed)

        if samples is None:
            d = image_dir or find_image_dir(cfg)
            if d is None:
                raise FileNotFoundError(
                    "no image directory found in data roots")
            samples = scan_image_corpus(d)
        samples = list(samples)

        # leakage-aware when the corpus contains augmented variants
        has_aug = any(s.base_id != Path(s.path).stem for s in samples)
        split = leakage_aware_split if has_aug else stratified_split
        self.train_samples, self.val_samples = split(
            samples, cfg.data.val_ratio, rng=self.rngs.host("split"))

        if mode == "text_only":
            # labels only: the images would never be used
            self.train_images = np.zeros((0,), np.uint8)
            self.val_images = np.zeros((0,), np.uint8)
            self.train_labels = np.asarray(
                [s.label for s in self.train_samples], np.int32)
            self.val_labels = np.asarray(
                [s.label for s in self.val_samples], np.int32)
        elif decoded is not None:
            configure_face_detection(cfg, device)

            def arrays(split):
                return (np.stack([stage_uint8(decoded[s.path], STAGING_SIZE)
                                  for s in split]),
                        np.asarray([s.label for s in split], np.int32))

            self.train_images, self.train_labels = arrays(self.train_samples)
            self.val_images, self.val_labels = arrays(self.val_samples)
        else:
            configure_face_detection(cfg, device)
            self.train_images, self.train_labels = load_corpus_arrays(
                self.train_samples, STAGING_SIZE)
            self.val_images, self.val_labels = load_corpus_arrays(
                self.val_samples, STAGING_SIZE)

        self.class_weights = class_weights(self.train_samples)
        self._sampler = WeightedSampler(
            sample_weights(self.train_samples),
            num_samples=(len(self.train_samples)
                         * max(1, cfg.data.augmentation_factor)),
            rng=self.rngs.host("sampler"),
        ) if cfg.data.use_weighted_sampling else None

        if mode in ("multimodal", "text_only"):
            self.tokenizer = tokenizer or get_tokenizer()
            self.text_pool = build_text_pool(cfg, self.tokenizer,
                                             self.rngs.host("text_aug"))
        else:
            self.tokenizer = None
            self.text_pool = None

        self._text_rng = self.rngs.host("text_pick")

    # -- helpers -----------------------------------------------------------

    @property
    def steps_per_epoch(self) -> int:
        """Train batches yielded per epoch: floor(draws / batch_size), as
        the iterators drop the ragged tail."""
        n = (len(self.train_samples)
             * max(1, self.cfg.data.augmentation_factor))
        b = self.cfg.training.batch_size
        if n < b:
            raise ValueError(
                f"epoch draw ({n} = {len(self.train_samples)} samples x "
                f"augmentation_factor) is smaller than batch_size ({b}); "
                "reduce training.batch_size or raise "
                "data.augmentation_factor")
        return n // b

    def _indices_for_epoch(self) -> np.ndarray:
        factor = max(1, self.cfg.data.augmentation_factor)
        if self._sampler is not None:
            return self._sampler.sample_epoch()
        idx = np.concatenate([
            self.rngs.host("shuffle").permutation(len(self.train_samples))
            for _ in range(factor)])
        return idx[:len(self.train_samples) * factor]

    def _text_indices(self, rows: np.ndarray, train: bool
                      ) -> tuple[np.ndarray, np.ndarray]:
        """(levels, variants) into the text pool for these corpus rows: a
        random (level, variant) per train item, the full clinical
        description (0, 0) at val."""
        n = len(rows)
        if train:
            return (self._text_rng.integers(0, NUM_TEXT_LEVELS, n),
                    self._text_rng.integers(0, TEXT_POOL_VARIANTS, n))
        return np.zeros(n, np.int64), np.zeros(n, np.int64)

    def _attach_text(self, batch: Dict[str, np.ndarray], rows: np.ndarray,
                     labels: np.ndarray, train: bool) -> None:
        if self.text_pool is None:
            return
        levels, variants = self._text_indices(rows, train)
        ids, mask = self.text_pool.gather(labels, levels, variants)
        batch["input_ids"] = ids
        batch["attention_mask"] = mask

    # -- device-resident corpus (index batches) -----------------------------

    def device_corpus(self) -> Dict[str, np.ndarray]:
        corpus: Dict[str, np.ndarray] = {
            "train_labels": self.train_labels.astype(np.int32),
            "val_labels": self.val_labels.astype(np.int32),
        }
        if self.mode != "text_only":
            corpus["train_images"] = self.train_images
            corpus["val_images"] = self.val_images
        if self.text_pool is not None:
            corpus["pool_ids"] = self.text_pool.ids
            corpus["pool_mask"] = self.text_pool.mask
        return corpus

    def train_index_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        b = self.cfg.training.batch_size
        idx = self._indices_for_epoch()
        for s in range(len(idx) // b):
            rows = idx[s * b:(s + 1) * b].astype(np.int32)
            out = {"rows": rows}
            if self.text_pool is not None:
                levels, variants = self._text_indices(rows, train=True)
                out["levels"] = levels.astype(np.int32)
                out["variants"] = variants.astype(np.int32)
            yield out

    def val_index_batches(self, batch_size: Optional[int] = None
                          ) -> Iterator[Dict[str, np.ndarray]]:
        b = batch_size or self.cfg.evaluation.eval_batch_size
        n = len(self.val_samples)
        for s in range(0, n, b):
            rows = np.arange(s, min(s + b, n), dtype=np.int32)
            pad = b - len(rows)
            valid = np.ones(len(rows), np.float32)
            if pad:
                rows = np.concatenate([rows, np.zeros(pad, np.int32)])
                valid = np.concatenate([valid, np.zeros(pad, np.float32)])
            out = {"rows": rows, "valid": valid}
            if self.text_pool is not None:
                levels, variants = self._text_indices(rows, train=False)
                out["levels"] = levels.astype(np.int32)
                out["variants"] = variants.astype(np.int32)
            yield out

    # -- batch iterators ---------------------------------------------------

    def train_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        b = self.cfg.training.batch_size
        idx = self._indices_for_epoch()
        for s in range(len(idx) // b):
            rows = idx[s * b:(s + 1) * b]
            labels = self.train_labels[rows]
            batch: Dict[str, np.ndarray] = {"labels": labels,
                                            "valid": np.ones(b, np.float32)}
            if self.mode != "text_only":
                batch["images"] = self.train_images[rows]
            self._attach_text(batch, rows, labels, train=True)
            yield batch

    def val_batches(self, batch_size: Optional[int] = None
                    ) -> Iterator[Dict[str, np.ndarray]]:
        b = batch_size or self.cfg.evaluation.eval_batch_size
        n = len(self.val_samples)
        for s in range(0, n, b):
            rows = np.arange(s, min(s + b, n))
            pad = b - len(rows)
            labels = self.val_labels[rows]
            valid = np.ones(len(rows), np.float32)
            if pad:
                rows = np.concatenate([rows, np.zeros(pad, np.int64)])
                labels = np.concatenate([labels, np.zeros(pad, np.int32)])
                valid = np.concatenate([valid, np.zeros(pad, np.float32)])
            batch: Dict[str, np.ndarray] = {"labels": labels, "valid": valid}
            if self.mode != "text_only":
                batch["images"] = self.val_images[rows]
            self._attach_text(batch, rows, labels, train=False)
            yield batch
