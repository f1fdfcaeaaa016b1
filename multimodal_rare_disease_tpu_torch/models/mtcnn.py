"""MTCNN face detection: the counterpart of
`multimodal_rare_disease_tpu/models/mtcnn.py`.

A three-stage cascade of small convnets (P-Net, fully convolutional,
over an image pyramid; R-Net over 24x24 crops; O-Net over 48x48 crops)
with per-stage thresholds, box regression and NMS, as facenet-pytorch's
`detect_face`.

- The nets are torch modules with the flax names (`conv1`, `prelu1`, ...,
  `dense4`, `dense5_1`, ...) under one `MTCNN` container (`pnet`, `rnet`,
  `onet`), so the JAX parameter tree loads through
  `models/convert.py::state_dict_from_jax` with `strict=True`. Their
  input and output are NHWC like the JAX modules'; inside they convolve
  NCHW and flatten in (N, H, W, C) order before the dense layers, as the
  JAX modules do.
- The nets and the bilinear resizes that feed them (the port's
  antialiased `_axis_weights`, which matches `jax.image.resize(...,
  "linear")`) run on the detector's device, the card unless the caller
  asks for the CPU. The cascade's bookkeeping (pyramid scales, NMS,
  boxes) stays on the host in numpy, as in the JAX package. The JAX
  package pads each stage's batch to a power of two for its compiled
  shapes; eager torch needs no padding, and the rows do not interact.
- `convert_mtcnn` takes facenet-pytorch state dicts (OIHW convolutions;
  dense layers that flatten in facenet's (N, W, H, C) order, unpermuted
  here to (N, H, W, C)); `save_mtcnn_npz` / `load_mtcnn_npz` read and
  write the JAX package's npz layout (`pnet/conv1/kernel` in HWIO, ...),
  so one file serves both packages.

No weights ship with the repository: without an npz the data layer uses
`heuristic_face_box`, a background-subtraction blob detector.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from multimodal_rare_disease_tpu_torch.models.classifier import (
    resolve_device,
)
from multimodal_rare_disease_tpu_torch.models.convert import (
    state_dict_from_jax,
)
from multimodal_rare_disease_tpu_torch.models.layers import (
    Conv2d,
    Linear,
    init_weights,
)
from multimodal_rare_disease_tpu_torch.ops.preprocess import _axis_weights

StateDict = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# the nets
# ---------------------------------------------------------------------------


class PReLU(nn.Module):
    """Per-channel PReLU over dim 1, max(x, 0) + alpha·min(x, 0) as the
    JAX module computes it; the leaf keeps flax's name `alpha`."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.alpha = nn.Parameter(torch.empty(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.alpha.view([1, -1] + [1] * (x.ndim - 2))
        return torch.clamp_min(x, 0.0) + a * torch.clamp_max(x, 0.0)


def _ceil_pool(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """Max pool with torch's ceil_mode=True over NCHW, done as the JAX
    module does it: the right and bottom padded with -inf to cover."""
    h, w = x.shape[2], x.shape[3]
    ph = max(0, (-(h - window) % stride) if h > window else window - h)
    pw = max(0, (-(w - window) % stride) if w > window else window - w)
    if ph or pw:
        x = F.pad(x, (0, pw, 0, ph), value=float("-inf"))
    return F.max_pool2d(x, window, stride)


def _flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class PNet(nn.Module):
    """Proposal net: fully convolutional, 12x12 receptive field, stride 2.
    [N, H, W, 3] → (prob [N, h, w, 2], reg [N, h, w, 4])."""

    def __init__(self, device=None):
        super().__init__()
        self.conv1 = Conv2d(3, 10, 3, device=device)
        self.prelu1 = PReLU(10, device)
        self.conv2 = Conv2d(10, 16, 3, device=device)
        self.prelu2 = PReLU(16, device)
        self.conv3 = Conv2d(16, 32, 3, device=device)
        self.prelu3 = PReLU(32, device)
        self.conv4_1 = Conv2d(32, 2, 1, device=device)
        self.conv4_2 = Conv2d(32, 4, 1, device=device)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = x.permute(0, 3, 1, 2)
        x = _ceil_pool(self.prelu1(self.conv1(x)), 2, 2)
        x = self.prelu2(self.conv2(x))
        x = self.prelu3(self.conv3(x))
        prob = F.softmax(self.conv4_1(x).permute(0, 2, 3, 1), dim=-1)
        return prob, self.conv4_2(x).permute(0, 2, 3, 1)


class RNet(nn.Module):
    """Refinement net over 24x24 crops → (prob [N, 2], reg [N, 4])."""

    def __init__(self, device=None):
        super().__init__()
        self.conv1 = Conv2d(3, 28, 3, device=device)
        self.prelu1 = PReLU(28, device)
        self.conv2 = Conv2d(28, 48, 3, device=device)
        self.prelu2 = PReLU(48, device)
        self.conv3 = Conv2d(48, 64, 2, device=device)
        self.prelu3 = PReLU(64, device)
        self.dense4 = Linear(576, 128, device=device)
        self.prelu4 = PReLU(128, device)
        self.dense5_1 = Linear(128, 2, device=device)
        self.dense5_2 = Linear(128, 4, device=device)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = x.permute(0, 3, 1, 2)
        x = _ceil_pool(self.prelu1(self.conv1(x)), 3, 2)
        x = _ceil_pool(self.prelu2(self.conv2(x)), 3, 2)
        x = _flatten_nhwc(self.prelu3(self.conv3(x)))
        x = self.prelu4(self.dense4(x))
        return F.softmax(self.dense5_1(x), dim=-1), self.dense5_2(x)


class ONet(nn.Module):
    """Output net over 48x48 crops → (prob [N, 2], reg [N, 4],
    landmarks [N, 10])."""

    def __init__(self, device=None):
        super().__init__()
        self.conv1 = Conv2d(3, 32, 3, device=device)
        self.prelu1 = PReLU(32, device)
        self.conv2 = Conv2d(32, 64, 3, device=device)
        self.prelu2 = PReLU(64, device)
        self.conv3 = Conv2d(64, 64, 3, device=device)
        self.prelu3 = PReLU(64, device)
        self.conv4 = Conv2d(64, 128, 2, device=device)
        self.prelu4 = PReLU(128, device)
        self.dense5 = Linear(1152, 256, device=device)
        self.prelu5 = PReLU(256, device)
        self.dense6_1 = Linear(256, 2, device=device)
        self.dense6_2 = Linear(256, 4, device=device)
        self.dense6_3 = Linear(256, 10, device=device)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = x.permute(0, 3, 1, 2)
        x = _ceil_pool(self.prelu1(self.conv1(x)), 3, 2)
        x = _ceil_pool(self.prelu2(self.conv2(x)), 3, 2)
        x = _ceil_pool(self.prelu3(self.conv3(x)), 2, 2)
        x = _flatten_nhwc(self.prelu4(self.conv4(x)))
        x = self.prelu5(self.dense5(x))
        return (F.softmax(self.dense6_1(x), dim=-1), self.dense6_2(x),
                self.dense6_3(x))


class MTCNN(nn.Module):
    """The three nets under the JAX tree's top-level names."""

    def __init__(self, device=None):
        super().__init__()
        self.pnet = PNet(device)
        self.rnet = RNet(device)
        self.onet = ONet(device)


def init_mtcnn_params(seed: int = 0) -> StateDict:
    """A seeded random state dict of the three nets: lecun-normal kernels
    from torch.Generator().manual_seed(seed), zero biases, PReLU alpha
    0.25 (flax's initializers, as the JAX `init_mtcnn_params`)."""
    nets = MTCNN(device="cpu")
    init_weights(nets, torch.Generator().manual_seed(seed))
    for m in nets.modules():
        if isinstance(m, PReLU):
            nn.init.constant_(m.alpha, 0.25)
    return nets.state_dict()


# ---------------------------------------------------------------------------
# facenet-pytorch weights and the shared npz
# ---------------------------------------------------------------------------


def _f32(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def _facenet_dense(w, spatial: Optional[Tuple[int, int, int]]):
    """A facenet Linear weight [out, in]; `spatial=(H, W, C)` unpermutes
    its (N, W, H, C)-order flatten into the (N, H, W, C) order the nets
    flatten in."""
    w = np.asarray(_f32(w))
    if spatial is not None:
        h, wd, c = spatial
        w = (w.reshape(-1, wd, h, c).transpose(0, 2, 1, 3)
             .reshape(w.shape[0], -1))
    return _f32(w)


_LAYERS = {
    "pnet": ("conv1", "prelu1", "conv2", "prelu2", "conv3", "prelu3",
             "conv4_1", "conv4_2"),
    "rnet": ("conv1", "prelu1", "conv2", "prelu2", "conv3", "prelu3",
             "dense4", "prelu4", "dense5_1", "dense5_2"),
    "onet": ("conv1", "prelu1", "conv2", "prelu2", "conv3", "prelu3",
             "conv4", "prelu4", "dense5", "prelu5", "dense6_1", "dense6_2",
             "dense6_3"),
}
# the dense layers after a feature map, with the map's (H, W, C)
_DENSE_SPATIAL = {("rnet", "dense4"): (3, 3, 64),
                  ("onet", "dense5"): (3, 3, 128)}


def convert_mtcnn(pnet_sd: Mapping, rnet_sd: Mapping,
                  onet_sd: Mapping) -> StateDict:
    """facenet-pytorch PNet / RNet / ONet state dicts (tensors or arrays,
    e.g. `torch.load(..., map_location='cpu')`) → the `MTCNN` state
    dict. facenet's convolutions are already OIHW; its PReLU weights
    ([C], or [C, 1, 1]) become `alpha`."""
    out: StateDict = {}
    for net, sd in (("pnet", pnet_sd), ("rnet", rnet_sd), ("onet", onet_sd)):
        for layer in _LAYERS[net]:
            w = sd[f"{layer}.weight"]
            if layer.startswith("prelu"):
                out[f"{net}.{layer}.alpha"] = _f32(w).reshape(-1)
                continue
            if layer.startswith("dense"):
                w = _facenet_dense(w, _DENSE_SPATIAL.get((net, layer)))
            out[f"{net}.{layer}.weight"] = _f32(w)
            out[f"{net}.{layer}.bias"] = _f32(sd[f"{layer}.bias"])
    return out


def save_mtcnn_npz(params: Mapping[str, torch.Tensor], path: str) -> None:
    """Write the state dict in the JAX package's npz layout: keys
    `net/layer/leaf`, convolution kernels HWIO, dense kernels [in, out]."""
    flat = {}
    for key in sorted(params):
        net, layer, leaf = key.split(".")
        a = params[key].detach().cpu().numpy()
        if leaf == "weight":
            leaf = "kernel"
            a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
        flat[f"{net}/{layer}/{leaf}"] = np.ascontiguousarray(a)
    np.savez(path, **flat)


def load_mtcnn_npz(path: str) -> StateDict:
    """An npz in the JAX package's layout → the `MTCNN` state dict."""
    tree: Dict = {}
    with np.load(path) as data:
        for key in data.files:
            node = tree
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return state_dict_from_jax(tree)


# ---------------------------------------------------------------------------
# the cascade: host bookkeeping in numpy, nets and resizes on the device
# ---------------------------------------------------------------------------


def _nms(boxes: np.ndarray, scores: np.ndarray, thresh: float,
         mode: str = "union") -> np.ndarray:
    """Greedy NMS; mode 'min' divides overlap by the smaller area."""
    if len(boxes) == 0:
        return np.empty((0,), np.int64)
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    area = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size:
        i = order[0]
        keep.append(i)
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        inter = (np.maximum(0.0, xx2 - xx1 + 1)
                 * np.maximum(0.0, yy2 - yy1 + 1))
        if mode == "min":
            ovr = inter / np.minimum(area[i], area[order[1:]])
        else:
            ovr = inter / (area[i] + area[order[1:]] - inter)
        order = order[1:][ovr <= thresh]
    return np.asarray(keep, np.int64)


def _rerec(boxes: np.ndarray) -> np.ndarray:
    """Square-up boxes around their centers (facenet `rerec`)."""
    out = boxes.copy()
    w = boxes[:, 2] - boxes[:, 0]
    h = boxes[:, 3] - boxes[:, 1]
    side = np.maximum(w, h)
    out[:, 0] = boxes[:, 0] + w * 0.5 - side * 0.5
    out[:, 1] = boxes[:, 1] + h * 0.5 - side * 0.5
    out[:, 2] = out[:, 0] + side
    out[:, 3] = out[:, 1] + side
    return out


def _apply_reg(boxes: np.ndarray, reg: np.ndarray) -> np.ndarray:
    w = (boxes[:, 2] - boxes[:, 0] + 1)[:, None]
    h = (boxes[:, 3] - boxes[:, 1] + 1)[:, None]
    return boxes[:, :4] + reg * np.concatenate([w, h, w, h], axis=1)


def _resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """[N, H, W, C] f32 → [N, out_h, out_w, C]: `jax.image.resize(...,
    'linear')`, antialiased when it shrinks, as two products with the
    port's `_axis_weights` (the same weights for every image)."""
    n, h, w, _ = x.shape

    def weights(in_size, out_size):
        s = in_size / out_size
        one = torch.ones(1, device=x.device)
        return _axis_weights(one * s, one * (0.5 * s - 0.5), out_size,
                             in_size, filter_width=max(s, 1.0))[0]

    x = torch.einsum("oh,bhwc->bowc", weights(h, out_h), x)
    return torch.einsum("pw,bowc->bopc", weights(w, out_w), x)


def _crop_resize(img: np.ndarray, boxes: np.ndarray, size: int,
                 device: torch.device) -> torch.Tensor:
    """Crop (clamped, zero-padded) boxes and resize each to [size, size]
    → [N, size, size, 3] on `device`; boxes of one shape resize as one
    batch."""
    H, W = img.shape[:2]
    out = torch.zeros((len(boxes), size, size, 3), device=device)
    patches: Dict[Tuple[int, int], list] = {}
    for i, (x1, y1, x2, y2) in enumerate(boxes[:, :4].astype(np.int64)):
        cx1, cy1 = max(0, x1), max(0, y1)
        cx2, cy2 = min(W, x2 + 1), min(H, y2 + 1)
        if cx2 <= cx1 or cy2 <= cy1:
            continue
        patch = np.zeros((y2 - y1 + 1, x2 - x1 + 1, 3), np.float32)
        patch[cy1 - y1:cy2 - y1, cx1 - x1:cx2 - x1] = img[cy1:cy2, cx1:cx2]
        patches.setdefault(patch.shape[:2], []).append((i, patch))
    for group in patches.values():
        idx = torch.tensor([i for i, _ in group], device=device)
        batch = torch.from_numpy(np.stack([p for _, p in group])).to(device)
        out[idx] = _resize(batch, size, size)
    return out


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.float().cpu().numpy()


@torch.inference_mode()
def detect_faces(
    nets: MTCNN,
    img_u8: np.ndarray,
    min_face_size: int = 20,
    thresholds: Sequence[float] = (0.6, 0.7, 0.7),
    factor: float = 0.709,
    max_candidates: int = 256,
) -> Tuple[np.ndarray, np.ndarray]:
    """The MTCNN cascade over one RGB uint8 image with the nets on their
    device. Returns (boxes [N, 4] float (x1, y1, x2, y2), probs [N]),
    possibly empty; the JAX `detect_faces` step for step."""
    dev = next(nets.parameters()).device
    img = (img_u8.astype(np.float32) - 127.5) * (1.0 / 128.0)
    H, W = img.shape[:2]
    img_dev = torch.from_numpy(img).to(dev)[None]

    # -- stage 1: P-Net over the pyramid
    m = 12.0 / min_face_size
    min_dim = min(H, W) * m
    scales = []
    while min_dim >= 12:
        scales.append(m)
        m *= factor
        min_dim *= factor
    all_boxes = []
    for scale in scales:
        hs, ws = int(np.ceil(H * scale)), int(np.ceil(W * scale))
        prob, reg = nets.pnet(_resize(img_dev, hs, ws))
        prob = _to_numpy(prob)[0, ..., 1]
        reg = _to_numpy(reg)[0]
        ys, xs = np.where(prob > thresholds[0])
        if ys.size == 0:
            continue
        score = prob[ys, xs]
        r = reg[ys, xs]
        stride, cell = 2.0, 12.0
        x1 = np.floor((stride * xs + 1) / scale)
        y1 = np.floor((stride * ys + 1) / scale)
        x2 = np.floor((stride * xs + cell) / scale)
        y2 = np.floor((stride * ys + cell) / scale)
        boxes = np.stack([x1, y1, x2, y2], axis=1)
        keep = _nms(boxes, score, 0.5)
        all_boxes.append(np.concatenate(
            [boxes[keep], score[keep, None], r[keep]], axis=1))
    if not all_boxes:
        return np.empty((0, 4)), np.empty((0,))
    total = np.concatenate(all_boxes, axis=0)
    keep = _nms(total[:, :4], total[:, 4], 0.7)
    total = total[keep][:max_candidates]
    boxes = _rerec(_apply_reg(total[:, :4], total[:, 5:9]))

    # -- stage 2: R-Net
    prob, reg = nets.rnet(_crop_resize(img, np.floor(boxes), 24, dev))
    prob, reg = _to_numpy(prob)[:, 1], _to_numpy(reg)
    sel = prob > thresholds[1]
    if not sel.any():
        return np.empty((0, 4)), np.empty((0,))
    boxes, prob, reg = boxes[sel], prob[sel], reg[sel]
    keep = _nms(boxes, prob, 0.7)
    boxes = _rerec(_apply_reg(boxes[keep], reg[keep]))

    # -- stage 3: O-Net
    oprob, oreg, _ = nets.onet(_crop_resize(img, np.floor(boxes), 48, dev))
    oprob, oreg = _to_numpy(oprob)[:, 1], _to_numpy(oreg)
    sel = oprob > thresholds[2]
    if not sel.any():
        return np.empty((0, 4)), np.empty((0,))
    boxes = _apply_reg(boxes[sel], oreg[sel])
    prob = oprob[sel]
    keep = _nms(boxes, prob, 0.7, mode="min")
    return boxes[keep], prob[keep]


# ---------------------------------------------------------------------------
# detector callables for the data-layer hook
# ---------------------------------------------------------------------------


def heuristic_face_box(arr: np.ndarray
                       ) -> Optional[Tuple[int, int, int, int]]:
    """Weights-free fallback detector: largest foreground blob by
    color distance from the border (background) median. Reliable on
    portrait-style imagery (one subject, roughly uniform background)
    like the synthetic StyleGAN3 corpus; returns None when no
    coherent foreground region exists."""
    from scipy import ndimage

    f = arr.astype(np.float32) / 255.0
    border = np.concatenate(
        [f[0], f[-1], f[:, 0], f[:, -1]], axis=0)
    bg = np.median(border.reshape(-1, 3), axis=0)
    dist = np.sqrt(((f - bg) ** 2).sum(axis=-1))
    mask = dist > max(0.18, float(dist.mean()) * 1.1)
    if not mask.any():
        return None
    lab, n = ndimage.label(mask)
    sizes = ndimage.sum(mask, lab, index=range(1, n + 1))
    k = int(np.argmax(sizes)) + 1
    if sizes[k - 1] < 0.02 * mask.size:
        return None
    ys, xs = np.nonzero(lab == k)
    top, left = int(ys.min()), int(xs.min())
    return (top, left, int(ys.max()) - top + 1, int(xs.max()) - left + 1)


class MTCNNDetector:
    """Hook-compatible detector: callable(uint8 [H, W, 3]) → (top, left,
    height, width) or None, picking the highest-probability face like
    facenet's `select_largest=False` path. The nets live on `device`, the
    card unless the caller asks for the CPU."""

    def __init__(self, params: Mapping[str, torch.Tensor],
                 min_face_size: int = 20,
                 thresholds: Sequence[float] = (0.6, 0.7, 0.7),
                 factor: float = 0.709, device="cuda"):
        self.device = resolve_device(device)
        self.nets = MTCNN(device="cpu")
        self.nets.load_state_dict(dict(params), strict=True)
        self.nets.to(self.device).eval()
        self.min_face_size = min_face_size
        self.thresholds = tuple(thresholds)
        self.factor = factor

    def __call__(self, arr: np.ndarray
                 ) -> Optional[Tuple[int, int, int, int]]:
        boxes, probs = detect_faces(
            self.nets, arr, self.min_face_size, self.thresholds,
            self.factor)
        if len(boxes) == 0:
            return None
        x1, y1, x2, y2 = boxes[int(np.argmax(probs))]
        x1, y1 = max(0, int(round(x1))), max(0, int(round(y1)))
        x2 = min(arr.shape[1] - 1, int(round(x2)))
        y2 = min(arr.shape[0] - 1, int(round(y2)))
        if x2 <= x1 or y2 <= y1:
            return None
        return (y1, x1, y2 - y1 + 1, x2 - x1 + 1)


def build_face_detector(kind: str = "auto", weights_path: str = "",
                        device="cuda"):
    """Factory for the data-layer hook.

    kind: 'mtcnn' (needs `weights_path`, an npz in the JAX package's
    layout; the nets run on `device`), 'heuristic' (the weights-free
    blob detector, on the host), or 'auto' (mtcnn when the weights
    exist, else heuristic).
    """
    if kind in ("auto", "mtcnn") and weights_path \
            and os.path.exists(weights_path):
        return MTCNNDetector(load_mtcnn_npz(weights_path), device=device)
    if kind == "mtcnn":
        raise FileNotFoundError(
            f"MTCNN weights not found at {weights_path!r}; convert "
            "facenet-pytorch state_dicts with convert_mtcnn + "
            "save_mtcnn_npz, or use kind='heuristic'")
    return heuristic_face_box
