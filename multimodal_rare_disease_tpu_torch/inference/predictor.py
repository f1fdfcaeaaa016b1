"""Batch predictor with the JSON contract: the counterpart of
`multimodal_rare_disease_tpu/inference/predictor.py` on one device, for
the three modes (multimodal, image_only, text_only), with the optional
embeddings in each result.

A request is padded to a batch bucket (1, 8, 32, 256), its texts are
tokenized with the port's WordPiece tokenizer (`data/tokenizer.py`, a
copy of the JAX package's) and cut to the
smallest length bucket (32, 64, 128, 256) that fits, and, for batches of
8 or more whose packed token count beats the bucket by 15%, packed
several to a row (inference/packing.py). Images are staged as uint8 at
256 px and go through the device-side eval preprocess
(ops/preprocess.py): the resample + normalize when `image_size` differs
from 256, the fused uint8 normalize kernel (K4) when it is 256. The
model computes in `cfg.training.compute_dtype` (bf16 by default), as the
JAX `create_model` builds it: the weights are cast to it once, at
construction; under `text_encoder.quantized_inference` the BERT products'
int8 codes are made from the f32 weights first (models/quant.py). It runs on the card unless the caller passes
`device="cpu"`; without a card it raises.

Over a rank mesh (`mesh=`, parallel/mesh.py; every rank builds the
predictor and calls `predict_batch` with the same requests) the BERT
tower is Megatron-sharded over the model axis (`parallel/tp.py`) and the
batch is split over the data axis, as the JAX predictor's `mesh=`: the
bucket rounds to the data axis (1 is skipped on 8-way data), each rank
prepares, packs and runs its contiguous slice of the padded batch (the
packed documents are independent under the block-diagonal mask, so
this computes the JAX global pack's values), and the probabilities come
back to every rank in order.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from multimodal_rare_disease_tpu_torch.config import (
    SYNDROME_NAMES,
    Config,
    resolve_config,
)
from multimodal_rare_disease_tpu_torch.data.tokenizer import (
    BertWordPieceTokenizer,
    get_tokenizer,
)
from multimodal_rare_disease_tpu_torch.inference.packing import (
    pack_texts,
    packing_wins,
)
from multimodal_rare_disease_tpu_torch.models.classifier import (
    create_model,
    resolve_device,
)
from multimodal_rare_disease_tpu_torch.models.quant import prepare_quantized
from multimodal_rare_disease_tpu_torch.ops.preprocess import eval_preprocess
from multimodal_rare_disease_tpu_torch.parallel.collectives import all_gather

ImageLike = Union[str, Path, np.ndarray]

# host decode size; the device resamples + crops to cfg.data.image_size
STAGING_SIZE = 256
_BATCH_BUCKETS = (1, 8, 32, 256)
_LENGTH_BUCKETS = (32, 64, 128, 256)


class MultimodalPredictor:
    """Serves the prediction JSON contract from a port model."""

    def __init__(self, cfg: Config, model: torch.nn.Module,
                 device="cuda", mode: str = "multimodal",
                 tokenizer: Optional[BertWordPieceTokenizer] = None,
                 class_names: Optional[Sequence[str]] = None,
                 length_bucketing: bool = True, mesh=None):
        """`model`: whole; on a `mesh` it is sharded here, and the
        device is the mesh rank's."""
        if mode not in ("multimodal", "image_only", "text_only"):
            raise ValueError(f"Unknown mode: {mode!r}")
        self.cfg = cfg
        self.mode = mode
        self.mesh = mesh
        self._data_size = 1
        if mesh is not None:
            from multimodal_rare_disease_tpu_torch.parallel.tp import (
                shard_model,
            )

            shard_model(model, mesh)
            device = mesh.device
            self._data_size = mesh.axis("data").size
        self.device = resolve_device(device)
        self.dtype = getattr(torch, cfg.training.compute_dtype)
        # int8 codes from the f32 weights, before the cast rounds them
        prepare_quantized(model.to(device=self.device))
        self.model = model.to(dtype=self.dtype).eval()
        self.length_bucketing = length_bucketing
        self.class_names = list(class_names or SYNDROME_NAMES)
        self.tokenizer = (tokenizer if mode == "image_only"
                          else tokenizer or get_tokenizer())
        # forwards taken by each path (observability; chip_smoke.py)
        self.packed_calls = 0
        self.classic_calls = 0

    # -- input preparation -------------------------------------------------

    def _prep_images(self, images: Sequence[ImageLike], n: int) -> np.ndarray:
        arrs = []
        for im in images:
            if isinstance(im, (str, Path)):
                # PIL only for paths: a serving host need not have it
                from multimodal_rare_disease_tpu_torch.data.images import (
                    load_image_uint8,
                )

                arrs.append(load_image_uint8(str(im), STAGING_SIZE))
                continue
            a = np.asarray(im)
            if a.dtype != np.uint8:
                a = np.clip(a, 0, 255).astype(np.uint8)
            if a.shape[:2] != (STAGING_SIZE, STAGING_SIZE):
                from PIL import Image

                a = np.asarray(Image.fromarray(a).resize(
                    (STAGING_SIZE, STAGING_SIZE), Image.BILINEAR))
            arrs.append(a)
        while len(arrs) < n:
            arrs.append(np.zeros_like(arrs[0]))
        return np.stack(arrs)

    def _prep_texts(self, texts: Sequence[str], n: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
        t = self.cfg.data.max_text_length
        ids, mask, _ = self.tokenizer.encode_batch(list(texts), t)
        if self.length_bucketing:
            longest = int(mask.sum(axis=1).max())
            bucket = next((b for b in _LENGTH_BUCKETS if longest <= b < t), t)
            ids, mask = ids[:, :bucket], mask[:, :bucket]
        if len(texts) < n:
            pad = n - len(texts)
            ids = np.concatenate([ids, np.tile(ids[-1:], (pad, 1))])
            mask = np.concatenate([mask, np.tile(mask[-1:], (pad, 1))])
        return ids, mask

    def _bucket(self, n: int) -> int:
        # a batch split over the data axis needs a bucket it divides
        d = self._data_size
        for b in _BATCH_BUCKETS:
            if n <= b and b % d == 0:
                return b
        # no listed bucket fits n and divides the axis: a multiple of
        # lcm(8, d), equal 8-aligned slices; one rank keeps 256's steps
        step = _BATCH_BUCKETS[-1] if d == 1 else math.lcm(8, d)
        return -(-max(n, 1) // step) * step

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if t.dtype == torch.int32:
            t = t.long()
        return t.to(self.device)

    # -- prediction --------------------------------------------------------

    def predict(self, image: Optional[ImageLike] = None,
                text: Optional[str] = None, top_k: int = 5,
                return_embeddings: bool = False) -> Dict[str, Any]:
        """Single-sample prediction returning the JSON contract."""
        return self.predict_batch(
            [image] if image is not None else None,
            [text] if text is not None else None, top_k=top_k,
            return_embeddings=return_embeddings)[0]

    def _packed_inputs(self, ids: np.ndarray, mask: np.ndarray):
        """The packed forward's text arrays, or None when packing does
        not win (the JAX predictor's decision and padding: rows to a
        multiple of 32 above 32, query slots to a power of two)."""
        lens = mask.sum(axis=1)
        cap = max(256, -(-int(lens.max()) // 128) * 128)
        if not packing_wins(lens, ids.shape[1], capacity=cap):
            return None
        pb = pack_texts(ids, mask, capacity=cap, row_multiple=8)
        r = pb.input_ids.shape[0]
        pad_r = (r if r <= 32 else -(-r // 32) * 32) - r
        p = pb.query_positions.shape[1]
        p2 = 1 << max(0, p - 1).bit_length()
        rows = ((0, pad_r), (0, 0))
        return (np.pad(pb.input_ids, rows), np.pad(pb.position_ids, rows),
                np.pad(pb.segment_ids, rows),
                np.pad(pb.query_positions, ((0, pad_r), (0, p2 - p))),
                pb.doc_row, pb.doc_slot)

    def _forward(self, images, texts, rows: int, bucket: int,
                 return_embeddings: bool) -> Dict[str, torch.Tensor]:
        """The model's outputs for `rows` rows: the requests, padded;
        packed when the whole batch's `bucket` is 8 or more and packing
        wins on these rows."""
        x = ids = mask = None
        if self.mode != "text_only":
            arrs = (self._prep_images(images, rows) if len(images) else
                    np.zeros((rows, STAGING_SIZE, STAGING_SIZE, 3), np.uint8))
            x = eval_preprocess(self._dev(arrs), self.cfg, dtype=self.dtype)
        if self.mode != "image_only":
            ids, mask = self._prep_texts(texts, rows)
        packed = (self._packed_inputs(ids, mask)
                  if self.mode == "multimodal" and not return_embeddings
                  and self.length_bucketing and bucket >= 8 else None)
        if packed is not None:
            self.packed_calls += 1
            return self.model.packed_forward(
                x, *(self._dev(a) for a in packed))
        self.classic_calls += 1
        text = () if ids is None else (self._dev(ids), self._dev(mask))
        args = text if x is None else (x,) + text
        return self.model(*args, return_embeddings=return_embeddings)

    @torch.inference_mode()
    def predict_batch(self, images: Optional[Sequence[ImageLike]] = None,
                      texts: Optional[Sequence[str]] = None, top_k: int = 5,
                      return_embeddings: bool = False
                      ) -> List[Dict[str, Any]]:
        """The JSON contract per sample; with `return_embeddings` each
        result also holds `embeddings` ({image, text, fused} as the mode
        has them, as lists)."""
        n = len(images) if images is not None else len(texts)
        b = self._bucket(n)
        if self.mode != "text_only" and images is None:
            raise ValueError(f"mode {self.mode} requires images")
        if self.mode != "image_only" and texts is None:
            raise ValueError(f"mode {self.mode} requires texts")
        rows = b
        if self._data_size > 1:
            # this rank's slice of the padded batch: pad images are
            # zeros, pad texts copies of the last, as the whole batch's
            mine = self.mesh.rows(b)
            rows = mine.stop - mine.start
            real = slice(min(mine.start, n), min(mine.stop, n))
            if images is not None:
                images = list(images[real])
            if texts is not None:
                texts = list(texts[real]) or [texts[-1]]
        out = self._forward(images, texts, rows, b, return_embeddings)
        keys = ["probs"] + [f"{key}_embedding" for key in
                            ("image", "text", "fused")
                            if return_embeddings and f"{key}_embedding" in out]
        # every rank's rows, in order
        out = {k: all_gather(out[k].float(), self.mesh.axis("data")
                             if self._data_size > 1 else None).cpu().numpy()
               for k in keys}
        probs = out["probs"][:n]
        results = [self._format_single(probs[i], top_k) for i in range(n)]
        if return_embeddings:
            embs = {key: out[f"{key}_embedding"]
                    for key in ("image", "text", "fused")
                    if f"{key}_embedding" in out}
            for i, r in enumerate(results):
                r["embeddings"] = {k: e[i].tolist() for k, e in embs.items()}
        return results

    def _format_single(self, probs: np.ndarray, top_k: int) -> Dict[str, Any]:
        def name(i):
            return (self.class_names[i] if i < len(self.class_names)
                    else f"Class_{i}")

        order = np.argsort(probs)[::-1][:top_k]
        predictions = [
            {"syndrome": name(i), "class_id": int(i),
             "confidence": float(probs[i]),
             "probability_percent": float(probs[i] * 100.0)}
            for i in order
        ]
        return {
            "predictions": predictions,
            "top_prediction": predictions[0] if predictions else None,
            "all_probabilities": {name(i): float(probs[i])
                                  for i in range(len(probs))},
        }

    # -- reporting ---------------------------------------------------------

    def format_report(self, result: Dict[str, Any],
                      patient_id: str = "N/A") -> str:
        """Clinical-report text rendering."""
        top = result["top_prediction"]
        lines = [
            "=" * 64,
            "RARE DISEASE DIAGNOSIS REPORT",
            "=" * 64,
            f"Patient ID: {patient_id}",
            "",
            "TOP PREDICTION:",
            f"  {top['syndrome']}",
            f"  Confidence: {top['confidence']:.4f} "
            f"({top['probability_percent']:.1f}%)",
            "",
            "DIFFERENTIAL DIAGNOSIS:",
        ]
        for i, p in enumerate(result["predictions"], 1):
            bar = "#" * int(round(p["confidence"] * 40))
            lines.append(f"  {i}. {p['syndrome']:<36} "
                         f"{p['probability_percent']:5.1f}% {bar}")
        lines += ["", "NOTE: Automated screening output; requires "
                  "confirmation by a clinical geneticist.", "=" * 64]
        return "\n".join(lines)


def load_predictor(checkpoint_path: str | Path, device="cuda",
                   mode: Optional[str] = None,
                   cfg: Optional[Config] = None,
                   tokenizer: Optional[BertWordPieceTokenizer] = None,
                   mesh=None) -> MultimodalPredictor:
    """Build a predictor from a port checkpoint directory
    (utils/checkpoint.py); the config and, unless `mode` is given, the
    mode come from its meta. The model is built on the CPU, loaded, and
    moved to `device` (the card unless the caller asks for the CPU), or
    sharded onto `mesh` and moved to the rank's device."""
    from multimodal_rare_disease_tpu_torch.utils.checkpoint import (
        load_checkpoint,
    )

    state, meta = load_checkpoint(checkpoint_path)
    if cfg is None:
        cfg = (Config.from_dict(meta["config"]) if "config" in meta
               else resolve_config())
    mode = mode or meta.get("mode", "multimodal")
    if tokenizer is None and meta.get("vocab"):
        tokenizer = BertWordPieceTokenizer(
            {t: i for i, t in enumerate(meta["vocab"])})
    model = create_model(cfg, mode=mode, device="cpu", seed=None)
    model.load_state_dict(state, strict=True)
    return MultimodalPredictor(cfg, model, device, mode=mode,
                               tokenizer=tokenizer,
                               class_names=meta.get("class_names"),
                               mesh=mesh)
