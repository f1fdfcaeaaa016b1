"""Grad-CAM over the last conv stage of the image encoder: the
counterpart of `multimodal_rare_disease_tpu/explain/gradcam.py`.

The backbone runs once, without autograd, to capture the feature map A
named by `explainability.gradcam_layer` ("stage4" by default: the
ResNet's last stage; EfficientNet-B0 needs "head", and a map the tail
cannot take raises ValueError, where the JAX package fails in its
tail). A is then made a leaf that requires grad, the model's tail
(pool → projection → [fusion] → head) runs from it, and
`torch.autograd.grad` of the one-hot class score gives dscore/dA (the
JAX package's `jax.vjp`). α = GAP(dscore/dA); CAM = ReLU(Σ_c α_c · A_c),
min-max normalized per image. In the multimodal tail the text tower
runs under `torch.no_grad()` (`logits_from_image_features`): its output
does not depend on A, and its kernels have no backward. The CAM's own
arithmetic is done in f32 from the model's A and gradient.

`gradcam_heatmap` and `overlay_heatmap` import PIL and matplotlib inside
the call.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from multimodal_rare_disease_tpu_torch.config import Config
from multimodal_rare_disease_tpu_torch.ops.preprocess import eval_preprocess


def cam_from_gradients(fmap: torch.Tensor, grad: torch.Tensor
                       ) -> torch.Tensor:
    """A [B, h, w, C] and dscore/dA → the normalized CAM [B, h, w] (f32)."""
    fmap, grad = fmap.float(), grad.float()
    alpha = grad.mean(dim=(1, 2), keepdim=True)           # GAP weights
    cam = torch.relu((alpha * fmap).sum(dim=-1))          # [B, h, w]
    lo = cam.amin(dim=(1, 2), keepdim=True)
    hi = cam.amax(dim=(1, 2), keepdim=True)
    return (cam - lo) / torch.clamp(hi - lo, min=1e-8)


class GradCAM:
    """Grad-CAM for the image-only and multimodal models. `model` is a
    port model of `mode` on its device in its compute dtype (a
    predictor's `.model`)."""

    def __init__(self, cfg: Config, model: torch.nn.Module,
                 mode: str = "image_only"):
        if mode not in ("image_only", "multimodal"):
            raise ValueError(f"Grad-CAM needs an image model, not {mode!r}")
        self.cfg = cfg
        self.model = model
        self.mode = mode
        p = next(model.parameters())
        self.device, self.dtype = p.device, p.dtype

    def gradients(self, images_u8: np.ndarray,
                  input_ids: Optional[np.ndarray] = None,
                  attention_mask: Optional[np.ndarray] = None,
                  class_idx: Optional[np.ndarray] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """→ (A [B, h, w, C], dscore/dA, logits [B, K]) on the model's
        device; the score is the logit of `class_idx`, by default the
        class the same forward predicts."""
        images = torch.from_numpy(np.require(images_u8, np.uint8, "CW")).to(
            self.device)
        x = eval_preprocess(images, self.cfg, dtype=self.dtype)
        with torch.no_grad():
            feats = self.model.image_feature_maps(x)
        layer = self.cfg.explainability.gradcam_layer
        layer = layer if layer in feats else sorted(feats)[-1]
        fmap = feats[layer]
        tail_in = self.model.cnn_encoder.proj1.in_features
        if fmap.shape[-1] != tail_in:
            # the JAX layer choice, which fails here too (its tail raises
            # a parameter shape error): EfficientNet's "stage4" is an
            # 80-channel map, and the tail pools the 1,280-channel "head"
            raise ValueError(
                f"Grad-CAM layer {layer!r} is a {fmap.shape[-1]}-channel "
                f"map, but the model's tail takes {tail_in} channels; set "
                f"explainability.gradcam_layer="
                f"\"{self.model.cnn_encoder.gradcam_layer}\"")
        fmap = fmap.detach().requires_grad_(True)
        with torch.enable_grad():
            if self.mode == "multimodal":
                if input_ids is None:
                    b = images.shape[0]
                    input_ids = np.zeros((b, 1), np.int64)
                    attention_mask = np.ones((b, 1), np.int64)
                logits = self.model.logits_from_image_features(
                    fmap, *(torch.from_numpy(np.asarray(a)).long().to(
                        self.device) for a in (input_ids, attention_mask)))
            else:
                logits = self.model.logits_from_image_features(fmap)
            target = (logits.argmax(dim=-1) if class_idx is None else
                      torch.as_tensor(class_idx, device=self.device).long())
            onehot = F.one_hot(target, logits.shape[-1]).to(logits.dtype)
            (grad,) = torch.autograd.grad(logits, fmap, grad_outputs=onehot)
        return fmap.detach(), grad, logits.detach()

    def __call__(self, images_u8: np.ndarray,
                 input_ids: Optional[np.ndarray] = None,
                 attention_mask: Optional[np.ndarray] = None,
                 class_idx: Optional[np.ndarray] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """uint8 images [B, S, S, 3] (+ the text for the multimodal model)
        → (cam [B, h, w] in [0, 1], logits [B, K]). class_idx defaults
        to the predicted class (argmax)."""
        fmap, grad, logits = self.gradients(images_u8, input_ids,
                                            attention_mask, class_idx)
        return (cam_from_gradients(fmap, grad).cpu().numpy(),
                logits.float().cpu().numpy())


def gradcam_heatmap(cam: np.ndarray, out_size: int = 224) -> np.ndarray:
    """Upsample a [h, w] CAM to [out_size, out_size] (bilinear)."""
    from PIL import Image

    im = Image.fromarray((np.asarray(cam) * 255).astype(np.uint8))
    return np.asarray(im.resize((out_size, out_size), Image.BILINEAR),
                      np.float32) / 255.0


def overlay_heatmap(image_u8: np.ndarray, cam: np.ndarray,
                    alpha: float = 0.45) -> np.ndarray:
    """Blend a CAM over an RGB uint8 image using a jet colormap."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.cm as cm

    h, w = image_u8.shape[:2]
    heat = gradcam_heatmap(cam, h) if cam.shape[:2] != (h, w) else cam
    colored = cm.jet(heat)[..., :3]
    out = (1 - alpha) * (image_u8.astype(np.float32) / 255.0) + alpha * colored
    return (np.clip(out, 0, 1) * 255).astype(np.uint8)
