"""Attention-based explainability: the counterpart of
`multimodal_rare_disease_tpu/explain/attention.py`.

- text_token_attention: per-token attention received from [CLS] in a
  BERT layer (the last by default), averaged over heads, special tokens
  left out and the rest renormalized;
- cross_modal_attention_summary: the fusion module's image→text and
  text→image attention weights per head (with `attend_over_tokens`, the
  image→text map is over the text tokens and is labelled with them).

The plot functions import matplotlib inside the call.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from multimodal_rare_disease_tpu_torch.config import Config
from multimodal_rare_disease_tpu_torch.data.tokenizer import (
    SPECIAL_TOKENS,
    BertWordPieceTokenizer,
)


def text_token_attention(
    cfg: Config,
    model: torch.nn.Module,
    tokenizer: BertWordPieceTokenizer,
    text: str,
    layer: int = -1,
) -> List[Tuple[str, float]]:
    """→ [(token, weight)] for the real tokens of `text` at
    `cfg.data.max_text_length`: the CLS row of the layer's attention,
    averaged over heads and renormalized. `model` is a multimodal model
    on its device (a predictor's `.model`)."""
    ids, mask, _ = tokenizer.encode(text, cfg.data.max_text_length)
    dev = next(model.parameters()).device
    with torch.inference_mode():
        attns = model.text_attentions(
            torch.from_numpy(np.asarray(ids)).long()[None].to(dev),
            torch.from_numpy(np.asarray(mask)).long()[None].to(dev))
    a = attns[layer][0].float().cpu().numpy()  # [heads, T, T]
    cls_row = a.mean(0)[0]                      # [T] attention from CLS
    tokens = tokenizer.convert_ids_to_tokens(ids)
    n = int(np.asarray(mask).sum())
    pairs = [(tok, float(w)) for tok, w in zip(tokens[:n], cls_row[:n])
             if tok not in SPECIAL_TOKENS]
    total = sum(w for _, w in pairs) or 1.0
    return [(t, w / total) for t, w in pairs]


def cross_modal_attention_summary(
    attention_info: Dict[str, torch.Tensor],
    tokenizer: Optional[BertWordPieceTokenizer] = None,
    input_ids: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """The fusion attention maps of the first batch element:
    {image_to_text: [heads, S], text_to_image: [heads, S'], [tokens]}."""
    def first(key):
        return np.asarray(torch.as_tensor(attention_info[key])[0]
                          .float().cpu())  # [heads, 1, S]

    out: Dict[str, np.ndarray] = {
        "image_to_text": first("image_to_text_attention")[:, 0, :],
        "text_to_image": first("text_to_image_attention")[:, 0, :],
    }
    if tokenizer is not None and input_ids is not None:
        ids = np.asarray(input_ids).reshape(-1)
        if out["image_to_text"].shape[-1] == len(ids):
            out["tokens"] = np.array(
                tokenizer.convert_ids_to_tokens(ids.tolist()))
    return out


def plot_text_attention(pairs: Sequence[Tuple[str, float]], path,
                        top_k: int = 25) -> None:
    """Horizontal bar chart of token attention weights."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pairs = sorted(pairs, key=lambda p: -p[1])[:top_k][::-1]
    fig, ax = plt.subplots(figsize=(7, max(3, 0.3 * len(pairs))))
    ax.barh(range(len(pairs)), [p[1] for p in pairs])
    ax.set_yticks(range(len(pairs)))
    ax.set_yticklabels([p[0] for p in pairs], fontsize=8)
    ax.set_xlabel("CLS attention (normalized)")
    ax.set_title("Text token attention")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def plot_cross_modal_attention(summary: Dict[str, np.ndarray], path) -> None:
    """Per-head maps of the fusion attention weights."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(11, 4))
    axes[0].imshow(summary["image_to_text"], aspect="auto", cmap="viridis")
    axes[0].set_title("image → text attention")
    axes[0].set_ylabel("head")
    axes[0].set_xlabel("key position")
    axes[1].imshow(summary["text_to_image"], aspect="auto", cmap="viridis")
    axes[1].set_title("text → image attention")
    axes[1].set_xlabel("key position")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
