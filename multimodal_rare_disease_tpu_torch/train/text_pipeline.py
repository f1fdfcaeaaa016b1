"""Text-corpus pipeline: FGDD patient phenotype texts (or any
(texts, labels) set) → fixed-shape batches. The torch package's own copy
of `multimodal_rare_disease_tpu/train/text_pipeline.py` (numpy only),
giving the same batches for the same seed and corpus.

Capability parity with the reference's real-data path
(`src/train.py:628-873`): FGDD.csv's one-hot HP:* phenotype columns
become "Patient presents with: …" narratives labeled by the top-10 most
frequent diseases; here they feed the same unified Trainer in text_only
mode (and optionally multimodal mode via the reference's cycle-pairing of
texts onto corpus images — a documented non-semantic pairing,
`src/train.py:797-811`).
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Sequence

import numpy as np

from multimodal_rare_disease_tpu_torch.config import SYNDROME_NAMES, Config
from multimodal_rare_disease_tpu_torch.data.tokenizer import (
    BertWordPieceTokenizer,
    build_wordpiece_vocab,
)
from multimodal_rare_disease_tpu_torch.train.pipeline import (
    DataPipeline,
    TextPool,
)
from multimodal_rare_disease_tpu_torch.utils.rng import RngStreams


class TextDataPipeline:
    """Trainer-compatible pipeline over (texts, labels)."""

    def __init__(
        self,
        cfg: Config,
        texts: Sequence[str],
        labels: Sequence[int],
        class_names: Optional[Sequence[str]] = None,
        tokenizer: Optional[BertWordPieceTokenizer] = None,
        rngs: Optional[RngStreams] = None,
        val_fraction: Optional[float] = None,
    ):
        assert len(texts) == len(labels)
        self.cfg = cfg
        self.rngs = rngs or RngStreams(cfg.seed)
        self.class_names = list(class_names) if class_names else None
        num_classes = cfg.classifier.num_classes

        self.tokenizer = tokenizer or BertWordPieceTokenizer(
            build_wordpiece_vocab(texts, vocab_size=8192))

        T = cfg.data.max_text_length
        ids, mask, _ = self.tokenizer.encode_batch(list(texts), T)
        labels = np.asarray(labels, np.int32)

        # stratified split
        rng = self.rngs.host("split")
        vf = val_fraction if val_fraction is not None else cfg.data.val_ratio
        train_idx, val_idx = [], []
        for c in range(num_classes):
            rows = np.nonzero(labels == c)[0]
            if len(rows) == 0:
                continue
            perm = rng.permutation(len(rows))
            n_val = max(1, int(round(len(rows) * vf))) if len(rows) > 1 else 0
            val_idx.extend(rows[perm[:n_val]])
            train_idx.extend(rows[perm[n_val:]])
        self.train_idx = np.asarray(sorted(train_idx))
        self.val_idx = np.asarray(sorted(val_idx))

        self.ids, self.mask, self.labels = ids, mask, labels

        counts = np.bincount(labels[self.train_idx], minlength=num_classes)
        total = counts.sum()
        self.class_weights = np.where(
            counts > 0, total / (num_classes * np.maximum(counts, 1)), 0.0
        ).astype(np.float32)

        self._sampler_rng = self.rngs.host("sampler")

    @property
    def train_samples(self) -> np.ndarray:  # Trainer logging parity
        return self.train_idx

    @property
    def val_samples(self) -> np.ndarray:
        return self.val_idx

    @property
    def steps_per_epoch(self) -> int:
        B = self.cfg.training.batch_size
        n = len(self.train_idx) * max(1, self.cfg.data.augmentation_factor)
        return max(1, n // B)

    def train_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        B = self.cfg.training.batch_size
        n_draw = len(self.train_idx) * max(1, self.cfg.data.augmentation_factor)
        if self.cfg.data.use_weighted_sampling:
            w = self.class_weights[self.labels[self.train_idx]]
            p = w / w.sum()
            order = self._sampler_rng.choice(len(self.train_idx),
                                             size=n_draw, replace=True, p=p)
        else:
            order = self._sampler_rng.permutation(
                np.tile(np.arange(len(self.train_idx)),
                        max(1, self.cfg.data.augmentation_factor)))[:n_draw]
        rows = self.train_idx[order]
        for s in range(len(rows) // B):
            sl = rows[s * B:(s + 1) * B]
            yield {
                "input_ids": self.ids[sl],
                "attention_mask": self.mask[sl],
                "labels": self.labels[sl],
                "valid": np.ones(B, np.float32),
            }

    def val_batches(self, batch_size: Optional[int] = None
                    ) -> Iterator[Dict[str, np.ndarray]]:
        B = batch_size or self.cfg.evaluation.eval_batch_size
        rows = self.val_idx
        for s in range(0, len(rows), B):
            sl = rows[s:s + B]
            pad = B - len(sl)
            valid = np.ones(len(sl), np.float32)
            if pad:
                sl = np.concatenate([sl, np.zeros(pad, np.int64)])
                valid = np.concatenate([valid, np.zeros(pad, np.float32)])
            yield {
                "input_ids": self.ids[sl],
                "attention_mask": self.mask[sl],
                "labels": self.labels[sl],
                "valid": valid,
            }


def fgdd_text_pipeline(cfg: Config, fgdd_dir: Optional[str] = None,
                       top_k_diseases: int = 10) -> TextDataPipeline:
    """Build the FGDD text_only pipeline (ref `src/train.py:628-710`)."""
    from multimodal_rare_disease_tpu_torch.data.parsers import load_fgdd

    data = load_fgdd(cfg, fgdd_dir=fgdd_dir, top_k_diseases=top_k_diseases)
    if data is None:
        raise FileNotFoundError("FGDD corpus not found in data roots")
    return TextDataPipeline(cfg, data["texts"], data["labels"],
                            class_names=data["disease_names"])


class FgddPairedPipeline(DataPipeline):
    """Image DataPipeline with the FGDD per-sample text channel.

    The FGDD→multimodal cycle-pairing (ref `src/train.py:797-811`):
    labels come from the images; texts cycle through the FGDD corpus by
    original scan position (i mod n_texts) — a documented non-semantic
    pairing (the FGDD diseases and the 10 image syndromes do not
    overlap). The text pool is [C, 1, n_texts, T] with the class axis
    broadcast (text choice is independent of the image label), and the
    `_text_indices` hook makes the trainer's on-device
    pool[labels, levels, variants] gather pick variants = pos mod N.
    """

    def __init__(self, cfg: Config, texts: Sequence[str],
                 image_dir: str, samples):
        tok = BertWordPieceTokenizer(build_wordpiece_vocab(list(texts), 8192))
        orig_pos = {s.path: i for i, s in enumerate(samples)}
        super().__init__(cfg, mode="multimodal", image_dir=image_dir,
                         tokenizer=tok, samples=samples)

        T = cfg.data.max_text_length
        ids, mask, _ = tok.encode_batch(list(texts), T)
        self.fgdd_n_texts = n = len(texts)
        C = len(SYNDROME_NAMES)
        self.text_pool = TextPool(
            np.broadcast_to(ids[None, None].astype(np.int32),
                            (C, 1, n, T)).copy(),
            np.broadcast_to(mask[None, None].astype(np.int32),
                            (C, 1, n, T)).copy())
        self._train_tidx = np.asarray(
            [orig_pos[s.path] % n for s in self.train_samples], np.int32)
        self._val_tidx = np.asarray(
            [orig_pos[s.path] % n for s in self.val_samples], np.int32)

    def _text_indices(self, rows, train):
        tidx = self._train_tidx if train else self._val_tidx
        # val rows may be 0-padded; 0 is always in range
        return (np.zeros(len(rows), np.int64),
                tidx[np.asarray(rows, np.int64)])


def fgdd_multimodal_pipeline(cfg: Config, fgdd_dir: Optional[str] = None,
                             image_dir: Optional[str] = None,
                             top_k_diseases: int = 10) -> FgddPairedPipeline:
    """Build the FGDD→multimodal cycle-pairing pipeline (see
    `FgddPairedPipeline`)."""
    from multimodal_rare_disease_tpu_torch.config import find_image_dir
    from multimodal_rare_disease_tpu_torch.data.images import scan_image_corpus
    from multimodal_rare_disease_tpu_torch.data.parsers import load_fgdd

    data = load_fgdd(cfg, fgdd_dir=fgdd_dir, top_k_diseases=top_k_diseases)
    if data is None:
        raise FileNotFoundError("FGDD corpus not found in data roots")

    d = image_dir or find_image_dir(cfg)
    if d is None:
        raise FileNotFoundError("no image directory found in data roots")
    samples = list(scan_image_corpus(d))
    return FgddPairedPipeline(cfg, list(data["texts"]), d, samples)
