"""Learned class-conditional generative backend (conv VAE): the
counterpart of `multimodal_rare_disease_tpu/data/generative.py`.

A small class-conditional convolutional VAE trained on the image corpus,
behind the `SyntheticImageGenerator` API of `data/synthetic.py`, at the
JAX widths: 64-px images, latent 64, width 32. The whole corpus is one
batch on the device (the card unless the caller asks for the CPU); one
Adam step per epoch with optax's `cosine_decay_schedule(lr, num_epochs)`;
the reparameterization noise comes from an explicit `torch.Generator`.

The modules carry the flax names, so a JAX parameter tree loads through
`models/convert.py::state_dict_from_jax`. flax's `ConvTranspose`
(padding SAME, kernel HWIO, not flipped) is a torch transposed
convolution with padding 1 whose kernel is flipped in both spatial axes
and laid out (I, O, H, W): the bridge's generic HWIO → OIHW rule gives
(O, I, H, W), so `ConvTranspose` keeps that layout and flips and
transposes it in its forward.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from multimodal_rare_disease_tpu_torch.config import (
    PREFIX_TO_SYNDROME,
    SYNDROME_NAMES,
)
from multimodal_rare_disease_tpu_torch.data.images import resize_bilinear_u8
from multimodal_rare_disease_tpu_torch.models.classifier import (
    resolve_device,
)
from multimodal_rare_disease_tpu_torch.models.layers import (
    Conv2d,
    Embedding,
    Linear,
    init_weights,
)
from multimodal_rare_disease_tpu_torch.ops.preprocess import (
    separable_resample,
)

_SYNDROME_TO_PREFIX = {v: k for k, v in PREFIX_TO_SYNDROME.items()}

TRAIN_SIZE = 64  # VAE training/generation resolution (upsampled on save)


class ConvTranspose(nn.Module):
    """flax `nn.ConvTranspose(features, (4, 4), strides=(2, 2))` (padding
    SAME: the output is twice the input). `weight` is the flax kernel in
    the bridge's OIHW layout."""

    def __init__(self, in_ch: int, out_ch: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, 4, 4,
                                               device=device))
        self.bias = nn.Parameter(torch.empty(out_ch, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.flip(2, 3).transpose(0, 1)
        return F.conv_transpose2d(x, w, self.bias, stride=2, padding=1)


class ConvVAE(nn.Module):
    """Class-conditional conv VAE for [64, 64, 3] images in [0, 1]
    (NHWC in and out, as the JAX module)."""

    def __init__(self, latent_dim: int = 64, num_classes: int = 10,
                 width: int = 32, device=None):
        super().__init__()
        self.latent_dim = latent_dim
        self.width = width
        w = width
        # flax Conv (4, 4) / 2, padding SAME: 1 on each side at even sizes
        self.enc0 = Conv2d(3, w, 4, 2, 1, device=device)           # 32
        self.enc1 = Conv2d(w, w * 2, 4, 2, 1, device=device)       # 16
        self.enc2 = Conv2d(w * 2, w * 4, 4, 2, 1, device=device)   # 8
        self.enc3 = Conv2d(w * 4, w * 8, 4, 2, 1, device=device)   # 4
        self.enc_out = Linear(4 * 4 * w * 8, 2 * latent_dim, device=device)
        self.cls_embed = Embedding(num_classes, latent_dim, device=device)
        self.dec_in = Linear(latent_dim, 4 * 4 * w * 8, device=device)
        self.dec0 = ConvTranspose(w * 8, w * 4, device)
        self.dec1 = ConvTranspose(w * 4, w * 2, device)
        self.dec2 = ConvTranspose(w * 2, w, device)
        self.dec3 = ConvTranspose(w, 3, device)

    def encode(self, x: torch.Tensor, labels: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        h = x.permute(0, 3, 1, 2)
        for conv in (self.enc0, self.enc1, self.enc2, self.enc3):
            h = F.relu(conv(h))
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)  # NHWC flatten
        mu, logvar = self.enc_out(h).chunk(2, dim=-1)
        return mu, logvar.clamp(-8.0, 8.0)

    def decode(self, z: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        zc = z + self.cls_embed(labels)
        h = self.dec_in(zc).reshape(-1, 4, 4, self.width * 8)
        h = h.permute(0, 3, 1, 2)
        decs = (self.dec0, self.dec1, self.dec2, self.dec3)
        for i, deconv in enumerate(decs):
            h = deconv(h)
            if i < len(decs) - 1:
                h = F.relu(h)
        return torch.sigmoid(h).permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor, labels: torch.Tensor,
                eps: torch.Tensor):
        """(recon, mu, logvar) with the reparameterization noise `eps`
        [N, latent_dim] given by the caller."""
        mu, logvar = self.encode(x, labels)
        z = mu + torch.exp(0.5 * logvar) * eps
        return self.decode(z, labels), mu, logvar


def init_vae(model: ConvVAE, gen: torch.Generator) -> ConvVAE:
    """Seeded weights from `gen` (a CPU generator): lecun-normal kernels
    and zero biases as flax's defaults, the class embedding N(0, 1/latent)
    (flax's variance-scaled embedding init)."""
    init_weights(model, gen)
    with torch.no_grad():
        model.cls_embed.weight.copy_(
            torch.randn(model.cls_embed.weight.shape, generator=gen)
            / math.sqrt(model.latent_dim))
        for m in model.modules():
            if isinstance(m, ConvTranspose):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               / math.sqrt(fan_in))
                m.bias.zero_()
    return model


def vae_loss(model: ConvVAE, x: torch.Tensor, y: torch.Tensor,
             eps: torch.Tensor, kl_weight: float = 1e-3):
    """(loss, reconstruction, KL): the summed squared error per image and
    the KL to N(0, 1), each averaged over the batch."""
    recon, mu, logvar = model(x, y, eps)
    rec = ((recon - x) ** 2).sum(dim=(1, 2, 3)).mean()
    kl = (-0.5 * (1 + logvar - mu ** 2 - torch.exp(logvar)).sum(-1)).mean()
    return rec + kl_weight * kl, rec, kl


def cosine_decay(lr: float, step: int, decay_steps: int) -> float:
    """optax.cosine_decay_schedule(lr, decay_steps) at `step` (alpha 0)."""
    frac = min(step, decay_steps) / decay_steps
    return lr * 0.5 * (1.0 + math.cos(math.pi * frac))


def vae_step(model: ConvVAE, opt: torch.optim.Adam, x: torch.Tensor,
             y: torch.Tensor, eps: torch.Tensor, lr: float,
             kl_weight: float = 1e-3) -> torch.Tensor:
    """One Adam step at learning rate `lr` on the batch, with the noise
    `eps`; returns the loss before the step."""
    for group in opt.param_groups:
        group["lr"] = lr
    opt.zero_grad(set_to_none=True)
    loss = vae_loss(model, x, y, eps, kl_weight)[0]
    loss.backward()
    opt.step()
    return loss.detach()


def corpus_tensor(images_uint8: np.ndarray, device) -> torch.Tensor:
    """uint8 [N, S, S, 3] → f32 [N, 64, 64, 3] in [0, 1] on `device`;
    another size goes through the port's antialiased resample, as the JAX
    package's `jax.image.resize(..., "bilinear")`."""
    x = torch.from_numpy(np.asarray(images_uint8)).to(device)
    x = x.to(torch.float32) / 255.0
    s = x.shape[1]
    if s != TRAIN_SIZE:
        scale = s / TRAIN_SIZE
        sc = torch.full((x.shape[0],), scale, device=x.device)
        sh = torch.full((x.shape[0],), 0.5 * scale - 0.5, device=x.device)
        x = separable_resample(x, sc, sh, sc, sh, TRAIN_SIZE,
                               filter_width=max(scale, 1.0))
    return x


def train_vae(
    images_uint8: np.ndarray,   # [N, S, S, 3]
    labels: np.ndarray,         # [N]
    num_epochs: int = 400,
    latent_dim: int = 64,
    kl_weight: float = 1e-3,
    lr: float = 2e-3,
    seed: int = 0,
    device="cuda",
) -> Tuple[ConvVAE, float]:
    """Train the VAE on a (tiny) corpus → (model on `device`, the last
    epoch's loss). The whole corpus is one batch; one step per epoch; the
    weights and the noise are seeded from `seed`."""
    dev = resolve_device(device)
    n_classes = int(labels.max()) + 1 if len(labels) else 1
    model = init_vae(ConvVAE(latent_dim=latent_dim,
                             num_classes=max(n_classes, 10), device="cpu"),
                     torch.Generator().manual_seed(seed)).to(dev)
    x = corpus_tensor(images_uint8, dev)
    y = torch.as_tensor(np.asarray(labels), dtype=torch.int64, device=dev)
    noise = torch.Generator(dev).manual_seed(seed)
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    loss = torch.zeros(())
    for e in range(num_epochs):
        eps = torch.randn((x.shape[0], latent_dim), generator=noise,
                          device=dev)
        loss = vae_step(model, opt, x, y, eps,
                        cosine_decay(lr, e, num_epochs), kl_weight)
    return model.eval(), float(loss)


class VAEImageGenerator:
    """`SyntheticImageGenerator`-compatible learned backend.

    generate(class_idx, sample_idx) → uint8 [image_size, image_size, 3];
    truncation_psi scales the latent prior (StyleGAN truncation analogue).
    The latent comes from numpy's seeded generator, as in the JAX package;
    the 64-px decode is resized with PIL's bilinear filter (in numpy).
    """

    def __init__(self, model: ConvVAE, image_size: int = 256,
                 seed: int = 42, truncation_psi: float = 0.7):
        self.model = model.eval()
        self.image_size = image_size
        self.seed = seed
        self.truncation_psi = truncation_psi

    @classmethod
    def train_on_corpus(cls, image_dir: Optional[str] = None,
                        image_size: int = 256, seed: int = 42,
                        num_epochs: int = 400, device="cuda",
                        **kw) -> "VAEImageGenerator":
        from multimodal_rare_disease_tpu_torch.config import (
            find_image_dir,
            get_config,
        )
        from multimodal_rare_disease_tpu_torch.data.images import (
            load_corpus_arrays,
            scan_image_corpus,
        )

        d = image_dir or find_image_dir(get_config())
        if d is None:
            raise FileNotFoundError("no image corpus for VAE training")
        samples = list(scan_image_corpus(d))
        imgs, labels = load_corpus_arrays(samples, TRAIN_SIZE)
        model, _ = train_vae(imgs, labels, num_epochs=num_epochs,
                             seed=seed, device=device, **kw)
        return cls(model, image_size=image_size, seed=seed)

    @torch.inference_mode()
    def generate(self, class_idx: int, sample_idx: int = 0) -> np.ndarray:
        rng = np.random.default_rng(
            self.seed * 1_000_003 + class_idx * 1009 + sample_idx)
        dev = next(self.model.parameters()).device
        z = torch.from_numpy(rng.normal(
            0, self.truncation_psi, (1, self.model.latent_dim)).astype(
            np.float32)).to(dev)
        y = torch.tensor([class_idx], device=dev)
        img = self.model.decode(z, y)[0].float().cpu().numpy()
        u8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        if self.image_size != u8.shape[0]:
            u8 = resize_bilinear_u8(u8, self.image_size, self.image_size)
        return u8

    def generate_for_syndrome(self, syndrome: str, num: int
                              ) -> List[np.ndarray]:
        idx = SYNDROME_NAMES.index(syndrome)
        return [self.generate(idx, i) for i in range(num)]

    def generate_dataset(
        self,
        outdir: str | Path,
        num_per_class: int = 5,
        syndromes: Optional[Sequence[str]] = None,
        flat: bool = True,
    ) -> Dict[str, List[str]]:
        from PIL import Image

        outdir = Path(outdir)
        outdir.mkdir(parents=True, exist_ok=True)
        written: Dict[str, List[str]] = {}
        for name in (syndromes or SYNDROME_NAMES):
            code = _SYNDROME_TO_PREFIX[name]
            cls = SYNDROME_NAMES.index(name)
            paths = []
            target = outdir if flat else outdir / f"SYN_{code}"
            target.mkdir(parents=True, exist_ok=True)
            for i in range(num_per_class):
                arr = self.generate(cls, i)
                p = target / f"SYN_{code}_{i + 1:03d}.png"
                Image.fromarray(arr).save(p)
                paths.append(str(p))
            written[name] = paths
        return written
