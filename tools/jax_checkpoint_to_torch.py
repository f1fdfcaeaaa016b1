#!/usr/bin/env python3
"""Convert a checkpoint of the JAX package (an orbax directory written by
`multimodal_rare_disease_tpu/utils/checkpoint.py`) into a checkpoint of
the torch package that `multimodal_rare_disease_tpu_torch.inference.
predictor.load_predictor` opens:

    python tools/jax_checkpoint_to_torch.py JAX_CHECKPOINT_DIR OUT_DIR

It needs both packages (JAX and orbax to read, torch to write), so it
lives outside both. The parameters and BatchNorm statistics map through
`multimodal_rare_disease_tpu_torch/models/convert.py::state_dict_from_jax`
and are loaded into the port's model of the checkpoint's config and mode
with `strict=True` before they are written, so a tree the port cannot
hold fails here. The meta (config, mode, vocab, class names, training
record) is kept; the optimizer state is not converted.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def convert_checkpoint(src: str, out: str) -> Path:
    import jax

    from multimodal_rare_disease_tpu.utils.checkpoint import load_checkpoint
    from multimodal_rare_disease_tpu_torch.config import Config, resolve_config
    from multimodal_rare_disease_tpu_torch.models.classifier import (
        create_model,
    )
    from multimodal_rare_disease_tpu_torch.models.convert import (
        state_dict_from_jax,
    )
    from multimodal_rare_disease_tpu_torch.utils.checkpoint import (
        save_checkpoint,
    )

    params, batch_stats, meta = load_checkpoint(src)
    state = state_dict_from_jax(jax.device_get(params),
                                jax.device_get(batch_stats))
    meta = {k: v for k, v in meta.items() if not k.startswith("_")}
    cfg = (Config.from_dict(meta["config"]) if "config" in meta
           else resolve_config())
    model = create_model(cfg, mode=meta.get("mode", "multimodal"),
                         device="cpu", seed=None)
    model.load_state_dict(state, strict=True)
    return save_checkpoint(out, state, meta)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="JAX (orbax) checkpoint -> torch package checkpoint")
    parser.add_argument("src", help="checkpoint directory of the JAX package")
    parser.add_argument("out", help="output directory")
    args = parser.parse_args(argv)
    print(f"wrote {convert_checkpoint(args.src, args.out)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
