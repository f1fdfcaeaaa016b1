"""Classification head and the assembled models: the counterpart of
`multimodal_rare_disease_tpu/models/classifier.py` — the multimodal
model (`forward`, `packed_forward`, and the Grad-CAM / attention-map
entry points), the image-only and text-only baselines, and
`create_model` over the three modes, for inference or for training.
`module.train()` is the JAX `train=True`: dropout (from the generator
`layers.set_dropout_generator` gives), batch-statistics BatchNorm, and
no kernel in the text tower.

flax's `nn.gelu` is the tanh approximation, so the head's 'gelu' is too.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_rare_disease_tpu_torch.models.bert import create_text_encoder
from multimodal_rare_disease_tpu_torch.models.cnn_encoder import (
    create_cnn_encoder,
)
from multimodal_rare_disease_tpu_torch.models.fusion import (
    create_fusion_module,
)
from multimodal_rare_disease_tpu_torch.models.layers import (
    Dropout,
    Linear,
    init_weights,
)
from multimodal_rare_disease_tpu_torch.models.quant import prepare_quantized

_ACTIVATIONS = {
    "relu": F.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "leaky_relu": lambda x: F.leaky_relu(x, negative_slope=0.01),
}
# HF BertModel's initializer_range, as the JAX BERT tower's init
_BERT_INIT_STD = 0.02


class ClassificationHead(nn.Module):
    def __init__(self, in_dim: int, hidden_dims: Sequence[int],
                 num_classes: int, device, activation: str = "relu",
                 dropout: float = 0.0):
        super().__init__()
        self.act = _ACTIVATIONS[activation]
        self.dropout = Dropout(dropout)
        self.num_hidden = len(hidden_dims)
        for i, h in enumerate(hidden_dims):
            self.add_module(f"hidden{i}", Linear(in_dim, h, device=device))
            in_dim = h
        self.logits = Linear(in_dim, num_classes, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_hidden):
            x = self.dropout(self.act(getattr(self, f"hidden{i}")(x)))
        return self.logits(x).float()


class MultimodalClassifier(nn.Module):
    """Image [B, H, W, 3] normalized NHWC + text ids → logits / probs."""

    def __init__(self, cfg, device, attend_over_tokens: bool = False):
        super().__init__()
        self.attend_over_tokens = attend_over_tokens
        self.cnn_encoder = create_cnn_encoder(cfg.cnn_encoder, device)
        self.text_encoder = create_text_encoder(cfg.text_encoder, device)
        self.fusion = create_fusion_module(
            cfg.fusion, cfg.cnn_encoder.embedding_dim,
            cfg.text_encoder.hidden_size, device,
            attend_over_tokens=attend_over_tokens)
        self.head = _head(cfg, cfg.fusion.hidden_dim, device)

    def _text(self, input_ids, attention_mask):
        """(text embedding, the BERT tokens for token-level fusion or
        None)."""
        if not self.attend_over_tokens:
            return self.text_encoder(input_ids, attention_mask), None
        emb, out = self.text_encoder(input_ids, attention_mask,
                                     output_hidden_states=True)
        return emb, out["last_hidden_state"]

    def forward(self, images: torch.Tensor, input_ids: torch.Tensor,
                attention_mask: torch.Tensor,
                return_embeddings: bool = False,
                return_attention: bool = False) -> Dict[str, Any]:
        """Classic rows: input_ids / attention_mask [B, T]."""
        image_emb = self.cnn_encoder(images)
        text_emb, text_tokens = self._text(input_ids, attention_mask)
        fused, attention_info = self.fusion(
            image_emb, text_emb, text_tokens=text_tokens,
            text_mask=attention_mask)
        logits = self.head(fused)
        out: Dict[str, Any] = {"logits": logits,
                               "probs": torch.softmax(logits, dim=-1)}
        if return_embeddings:
            out["image_embedding"] = image_emb
            out["text_embedding"] = text_emb
            out["fused_embedding"] = fused
        if return_attention:
            out["attention_info"] = attention_info
        return out

    def packed_forward(self, images: torch.Tensor, input_ids: torch.Tensor,
                       position_ids: torch.Tensor, segment_ids: torch.Tensor,
                       query_positions: torch.Tensor, doc_row: torch.Tensor,
                       doc_slot: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Sequence-packed text (inference/packing.py): rows [R, C],
        query_positions [R, P]; document i's embedding sits at
        (doc_row[i], doc_slot[i]) of the encoder's [R, P, H] output. Not
        with attend_over_tokens, which needs each document's tokens."""
        txt = self.text_encoder(input_ids, None, position_ids=position_ids,
                                segment_ids=segment_ids,
                                query_positions=query_positions)
        fused, _ = self.fusion(self.cnn_encoder(images),
                               txt[doc_row, doc_slot])
        logits = self.head(fused)
        return {"logits": logits, "probs": torch.softmax(logits, dim=-1)}

    def image_feature_maps(self, images: torch.Tensor
                           ) -> Dict[str, torch.Tensor]:
        """The backbone's stage feature maps [B, h, w, C], for Grad-CAM."""
        return self.cnn_encoder.backbone_features(images)[1]

    def logits_from_image_features(self, feature_map: torch.Tensor,
                                   input_ids: torch.Tensor,
                                   attention_mask: torch.Tensor
                                   ) -> torch.Tensor:
        """The model's tail from a captured last-stage feature map, so
        that autograd gives d(logits)/d(feature_map), Grad-CAM's
        gradient. The text tower runs without autograd: its output does
        not depend on the map, and its kernels have no backward."""
        image_emb = self.cnn_encoder.embed_from_feature_map(feature_map)
        with torch.no_grad():
            text_emb, text_tokens = self._text(input_ids, attention_mask)
        fused, _ = self.fusion(image_emb, text_emb, text_tokens=text_tokens,
                               text_mask=attention_mask)
        return self.head(fused)

    def text_attentions(self, input_ids: torch.Tensor,
                        attention_mask: torch.Tensor
                        ) -> Tuple[torch.Tensor, ...]:
        """Per-layer BERT attention maps [B, heads, T, T]."""
        _, out = self.text_encoder(input_ids, attention_mask,
                                   output_attentions=True)
        return out["attentions"]


class ImageOnlyClassifier(nn.Module):
    """Unimodal image baseline: CNN encoder → head."""

    def __init__(self, cfg, device):
        super().__init__()
        self.cnn_encoder = create_cnn_encoder(cfg.cnn_encoder, device)
        self.head = _head(cfg, cfg.cnn_encoder.embedding_dim, device)

    def forward(self, images: torch.Tensor, return_embeddings: bool = False
                ) -> Dict[str, torch.Tensor]:
        emb = self.cnn_encoder(images)
        logits = self.head(emb)
        out = {"logits": logits, "probs": torch.softmax(logits, dim=-1)}
        if return_embeddings:
            out["image_embedding"] = emb
        return out

    def image_feature_maps(self, images: torch.Tensor
                           ) -> Dict[str, torch.Tensor]:
        return self.cnn_encoder.backbone_features(images)[1]

    def logits_from_image_features(self, feature_map: torch.Tensor
                                   ) -> torch.Tensor:
        return self.head(self.cnn_encoder.embed_from_feature_map(
            feature_map))


class TextOnlyClassifier(nn.Module):
    """Unimodal text baseline: BERT text encoder → head."""

    def __init__(self, cfg, device):
        super().__init__()
        self.text_encoder = create_text_encoder(cfg.text_encoder, device)
        self.head = _head(cfg, cfg.text_encoder.hidden_size, device)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                return_embeddings: bool = False) -> Dict[str, torch.Tensor]:
        emb = self.text_encoder(input_ids, attention_mask)
        logits = self.head(emb)
        out = {"logits": logits, "probs": torch.softmax(logits, dim=-1)}
        if return_embeddings:
            out["text_embedding"] = emb
        return out


def _head(cfg, in_dim: int, device) -> ClassificationHead:
    c = cfg.classifier
    return ClassificationHead(in_dim, tuple(c.hidden_dims), c.num_classes,
                              device, activation=c.activation,
                              dropout=c.dropout)


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: the card unless the caller
    asks for the CPU. A CUDA device without a card raises; nothing falls
    back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but no CUDA device is available; "
            f"pass device='cpu' to run on the CPU")
    return device


def create_model(cfg, mode: str = "multimodal", device="cuda",
                 dtype: torch.dtype = torch.float32,
                 seed: Optional[int] = 0,
                 attend_over_tokens: bool = False,
                 trainable: bool = False) -> nn.Module:
    """Build the model of `mode` ('multimodal', 'image_only' or
    'text_only') on `device` (the card unless the caller asks for the
    CPU) in `dtype`, in inference mode. `seed` fills the weights from
    torch.Generator().manual_seed(seed) (the same weights on every
    device); `seed=None` leaves them uninitialized, for a state dict to
    be loaded on top. `trainable=True` builds it for training instead:
    parameters in `cfg.training.param_dtype` (f32 masters), train mode,
    and `requires_grad` set by the freeze rules (`train/freeze.py`).
    Under `text_encoder.quantized_inference` a seeded inference model cast
    to a lower precision quantizes its BERT products from the f32 weights
    first (`models/quant.py::prepare_quantized`)."""
    device = resolve_device(device)
    if mode == "multimodal":
        model = MultimodalClassifier(cfg, device,
                                     attend_over_tokens=attend_over_tokens)
    elif mode == "image_only":
        model = ImageOnlyClassifier(cfg, device)
    elif mode == "text_only":
        model = TextOnlyClassifier(cfg, device)
    else:
        raise ValueError(f"Unknown mode: {mode!r}")
    if seed is not None:
        gen = torch.Generator().manual_seed(seed)
        for name, part in model.named_children():
            if name == "text_encoder":
                init_weights(part.bert, gen, std=_BERT_INIT_STD)
                if part.projection is not None:
                    init_weights(part.projection, gen)
            else:
                init_weights(part, gen)
    if trainable:
        from multimodal_rare_disease_tpu_torch.train.freeze import (
            apply_freeze,
        )

        model.to(dtype=getattr(torch, cfg.training.param_dtype)).train()
        apply_freeze(cfg, model)
        return model
    if seed is not None and dtype != torch.float32:
        prepare_quantized(model)
    return model.to(dtype=dtype).eval().requires_grad_(False)
