"""The single-device forward and the multi-rank dry run of the torch
package: the counterpart of `__graft_entry__.py`.

entry()             → (forward, (model, images, ids, mask)): the forward
                      of the flagship multimodal model (ResNet-50 +
                      BERT-base + cross-modal attention fusion) on one
                      device, the card unless the caller asks for the CPU.
dryrun_multichip(n) → the multi-rank dry run (`parallel/dryrun.py`).

    python -m multimodal_rare_disease_tpu_torch.entry [N] [--device cpu]

runs `dryrun_multichip(N)`, 8 ranks by default, as `python
__graft_entry__.py` runs the JAX one.

The inputs are the JAX entry's: the same `default_rng(0)` draws in the
same order and dtypes. The weights are the seeded torch init of
`create_model`, which stands in for `model.init(jax.random.key(0))`; a
caller that wants the JAX weights loads them through
`models/convert.py::state_dict_from_jax`. On the default config the
forward takes the 256 → 224 resample (not K4) and, in each of the 12
BERT layers, K1: 11 times at B·T rows and once at the B CLS rows of the
CLS-only last layer.
"""

from __future__ import annotations

import numpy as np
import torch

from multimodal_rare_disease_tpu_torch.config import resolve_config
from multimodal_rare_disease_tpu_torch.models.classifier import (
    create_model,
    resolve_device,
)
from multimodal_rare_disease_tpu_torch.ops.preprocess import eval_preprocess
from multimodal_rare_disease_tpu_torch.parallel.dryrun import (
    dryrun_multichip,
    main,
)

__all__ = ["entry", "dryrun_multichip"]


def entry(device="cuda"):
    cfg = resolve_config("default")  # 224 px, 128-token flagship dims
    device = resolve_device(device)
    model = create_model(cfg, "multimodal", device,
                         dtype=getattr(torch, cfg.training.compute_dtype),
                         seed=0)

    b, s, t = 8, 256, cfg.data.max_text_length
    rng = np.random.default_rng(0)
    images = torch.from_numpy(
        rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8)).to(device)
    ids = torch.from_numpy(rng.integers(0, cfg.text_encoder.vocab_size,
                                        (b, t), dtype=np.int32)).to(device)
    mask = torch.ones((b, t), dtype=torch.int32, device=device)

    def forward(model, images_u8, input_ids, attention_mask):
        # the compute dtype is the model's: bf16 for entry()'s model, f32
        # for an f32 copy
        dtype = next(model.parameters()).dtype
        with torch.inference_mode():
            x = eval_preprocess(images_u8, cfg, dtype=dtype)
            return model(x, input_ids, attention_mask)["probs"]

    return forward, (model, images, ids, mask)


if __name__ == "__main__":
    raise SystemExit(main())
