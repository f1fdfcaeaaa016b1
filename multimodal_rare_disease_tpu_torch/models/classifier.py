"""Classification head and the assembled multimodal model: the
counterpart of `multimodal_rare_disease_tpu/models/classifier.py`
(`mode="multimodal"`; the image-only and text-only models are not
ported yet).

flax's `nn.gelu` is the tanh approximation, so the head's 'gelu' is too.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

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
    Linear,
    init_weights,
)

_ACTIVATIONS = {
    "relu": F.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "leaky_relu": lambda x: F.leaky_relu(x, negative_slope=0.01),
}
# HF BertModel's initializer_range, as the JAX BERT tower's init
_BERT_INIT_STD = 0.02


class ClassificationHead(nn.Module):
    def __init__(self, in_dim: int, hidden_dims: Sequence[int],
                 num_classes: int, device, activation: str = "relu"):
        super().__init__()
        self.act = _ACTIVATIONS[activation]
        self.num_hidden = len(hidden_dims)
        for i, h in enumerate(hidden_dims):
            self.add_module(f"hidden{i}", Linear(in_dim, h, device=device))
            in_dim = h
        self.logits = Linear(in_dim, num_classes, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_hidden):
            x = self.act(getattr(self, f"hidden{i}")(x))
        return self.logits(x).float()


class MultimodalClassifier(nn.Module):
    """Image [B, H, W, 3] normalized NHWC + text ids → logits / probs."""

    def __init__(self, cfg, device):
        super().__init__()
        self.cnn_encoder = create_cnn_encoder(cfg.cnn_encoder, device)
        self.text_encoder = create_text_encoder(cfg.text_encoder, device)
        self.fusion = create_fusion_module(
            cfg.fusion, cfg.cnn_encoder.embedding_dim,
            cfg.text_encoder.hidden_size, device)
        c = cfg.classifier
        self.head = ClassificationHead(cfg.fusion.hidden_dim,
                                       tuple(c.hidden_dims), c.num_classes,
                                       device, activation=c.activation)

    def _tail(self, image_emb: torch.Tensor, text_emb: torch.Tensor
              ) -> Dict[str, torch.Tensor]:
        fused, _ = self.fusion(image_emb, text_emb)
        logits = self.head(fused)
        return {"logits": logits, "probs": torch.softmax(logits, dim=-1)}

    def forward(self, images: torch.Tensor, input_ids: torch.Tensor,
                attention_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Classic rows: input_ids / attention_mask [B, T]."""
        return self._tail(self.cnn_encoder(images),
                          self.text_encoder(input_ids, attention_mask))

    def packed_forward(self, images: torch.Tensor, input_ids: torch.Tensor,
                       position_ids: torch.Tensor, segment_ids: torch.Tensor,
                       query_positions: torch.Tensor, doc_row: torch.Tensor,
                       doc_slot: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Sequence-packed text (inference/packing.py): rows [R, C],
        query_positions [R, P]; document i's embedding sits at
        (doc_row[i], doc_slot[i]) of the encoder's [R, P, H] output."""
        txt = self.text_encoder(input_ids, None, position_ids=position_ids,
                                segment_ids=segment_ids,
                                query_positions=query_positions)
        return self._tail(self.cnn_encoder(images), txt[doc_row, doc_slot])


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
                 seed: Optional[int] = 0) -> MultimodalClassifier:
    """Build the model on `device` (the card unless the caller asks for
    the CPU) in `dtype`, in inference mode. `seed` fills the weights
    from torch.Generator().manual_seed(seed) (the same weights on every
    device); `seed=None` leaves them uninitialized, for a state dict to
    be loaded on top."""
    if mode != "multimodal":
        raise NotImplementedError(
            f"mode {mode!r} is not ported to the torch package "
            f"(multimodal only)")
    model = MultimodalClassifier(cfg, resolve_device(device))
    if seed is not None:
        gen = torch.Generator().manual_seed(seed)
        init_weights(model.cnn_encoder, gen)
        init_weights(model.text_encoder.bert, gen, std=_BERT_INIT_STD)
        if model.text_encoder.projection is not None:
            init_weights(model.text_encoder.projection, gen)
        init_weights(model.fusion, gen)
        init_weights(model.head, gen)
    return model.to(dtype=dtype).eval().requires_grad_(False)
