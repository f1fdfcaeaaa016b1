"""The multi-rank dry run: the counterpart of `__graft_entry__.py`'s
`dryrun_multichip`.

    python -m multimodal_rare_disease_tpu_torch.parallel.dryrun [N] \
        [--device cuda|cpu] [--backend gloo|nccl]

Spawns N ranks (8 by default; parallel/distributed.py) and, at the JAX
dry run's small multimodal config (2 BERT layers of 64, ResNet stages
(1, 1, 1, 1), batch 2N), runs one train step and one eval step on an
N x 1 mesh and, N even, on an (N/2) x 2 mesh (the BERT tower
Megatron-sharded), whose losses must agree within 1e-3, then the
sharded predict of the last mesh's weights over the same batch. The
ranks share the cards there are (gloo) unless `--backend nccl` gives
each its own.
"""

from __future__ import annotations

import argparse
import math
import time
from typing import Any, Dict

import numpy as np
import torch

from multimodal_rare_disease_tpu_torch.parallel.distributed import run_ranks

DRYRUN_OVERRIDES = {
    "data.image_size": 64,
    "data.max_text_length": 16,
    "text_encoder.max_length": 16,
    "text_encoder.num_layers": 2,
    "text_encoder.num_heads": 2,
    "text_encoder.hidden_size": 64,
    "text_encoder.intermediate_size": 128,
    "text_encoder.vocab_size": 512,
    "text_encoder.freeze_layers": 1,
    "cnn_encoder.embedding_dim": 64,
    "cnn_encoder.freeze_stages": 1,
    "cnn_encoder.stage_sizes": (1, 1, 1, 1),
    "fusion.text_proj_dim": 64,
    "fusion.hidden_dim": 64,
    "fusion.num_attention_heads": 2,
    "training.compute_dtype": "float32",
}


def dryrun_shapes(n: int):
    """The meshes of the dry run: n x 1, and (n/2) x 2 for even n."""
    return [(n, 1)] + ([(n // 2, 2)] if n % 2 == 0 else [])


def _rank(rank: int, world: int, device: str) -> Dict[str, Any]:
    from multimodal_rare_disease_tpu_torch.config import resolve_config
    from multimodal_rare_disease_tpu_torch.data.tokenizer import (
        get_tokenizer,
    )
    from multimodal_rare_disease_tpu_torch.inference.predictor import (
        MultimodalPredictor,
    )
    from multimodal_rare_disease_tpu_torch.models.classifier import (
        create_model,
    )
    from multimodal_rare_disease_tpu_torch.parallel.mesh import (
        create_mesh,
        rank_devices,
    )
    from multimodal_rare_disease_tpu_torch.parallel.tp import (
        gather_state_dict,
    )
    from multimodal_rare_disease_tpu_torch.train.pipeline import STAGING_SIZE
    from multimodal_rare_disease_tpu_torch.train.trainer import Trainer

    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    cfg = resolve_config("multimodal", {
        **DRYRUN_OVERRIDES, "training.batch_size": 2 * world,
        "evaluation.eval_batch_size": 2 * world})
    b, t = cfg.training.batch_size, cfg.data.max_text_length
    rng = np.random.default_rng(0)
    host = {
        "labels": rng.integers(0, 10, b),
        "valid": np.ones(b, np.float32),
        "images": rng.integers(0, 256, (b, STAGING_SIZE, STAGING_SIZE, 3),
                               ).astype(np.uint8),
        "input_ids": rng.integers(0, 512, (b, t)),
        "attention_mask": np.ones((b, t), np.int64),
    }
    out: Dict[str, Any] = {"losses": {}, "times": {}}
    devices = rank_devices(world, device)
    for d, m in dryrun_shapes(world):
        t0 = time.perf_counter()
        mesh = create_mesh(cfg, data_axis=d, model_axis=m, devices=devices)
        trainer = Trainer(cfg, "multimodal", device=mesh.device, mesh=mesh)
        trainer.init_state()
        batch = {k: torch.from_numpy(v).to(mesh.device)
                 for k, v in host.items()}
        loss = float(trainer.train_step(batch, 1e-3)["loss"])
        if not math.isfinite(loss):
            raise AssertionError(f"non-finite loss {loss} on {mesh.shape}")
        qkv = trainer.model.text_encoder.bert.layer0.attention.qkv.weight
        if qkv.shape[0] != 3 * cfg.text_encoder.hidden_size // m:
            raise AssertionError(f"qkv {tuple(qkv.shape)} is not split "
                                 f"over model={m}")
        count = float(trainer.eval_step(batch)["count"])
        if count != b:
            raise AssertionError(f"eval counted {count} of {b}")
        out["losses"][f"{d}x{m}"] = loss
        out["times"][f"{d}x{m}"] = time.perf_counter() - t0
    # serving over the last mesh, from its trained weights
    t0 = time.perf_counter()
    model = create_model(cfg, device="cpu", seed=None)
    model.load_state_dict(gather_state_dict(trainer.model, mesh))
    tok = get_tokenizer(corpus=["clinical description of a rare disease "
                                "syndrome with facial features"],
                        vocab_size=min(cfg.text_encoder.vocab_size, 512))
    predictor = MultimodalPredictor(cfg, model, mesh=mesh, tokenizer=tok)
    results = predictor.predict_batch(
        images=list(host["images"]),
        texts=["facial features of a rare syndrome"] * b)
    top = results[0]["top_prediction"]["confidence"]
    if len(results) != b or not 0.0 <= top <= 1.0:
        raise AssertionError(f"sharded predict gave {len(results)} rows, "
                             f"top {top}")
    out["predict"] = {"rows": len(results), "top": top,
                      "mesh": mesh.shape,
                      "seconds": time.perf_counter() - t0}
    return out


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     backend: str = "gloo", timeout_s: float = 600.0
                     ) -> Dict[str, Any]:
    """The dry run on `n_devices` ranks on `device` (the card unless the
    caller asks for the CPU); → rank 0's losses, times and predict."""
    t0 = time.perf_counter()
    res = run_ranks(_rank, n_devices, backend=backend, args=(device,),
                    timeout_s=timeout_s)[0]
    losses = list(res["losses"].values())
    if len(losses) > 1 and abs(losses[1] - losses[0]) >= 1e-3:
        raise AssertionError(f"the meshes' losses differ: {res['losses']}")
    for shape, loss in res["losses"].items():
        print(f"dryrun_multichip({n_devices}): train+eval step OK, "
              f"loss={loss:.4f}, mesh={shape}", flush=True)
    p = res["predict"]
    print(f"dryrun_multichip({n_devices}): sharded predict OK, "
          f"batch={p['rows']}, mesh={p['mesh']} | "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return res


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("n", type=int, nargs="?", default=8)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--backend", default="gloo", choices=["gloo", "nccl"])
    args = parser.parse_args(argv)
    dryrun_multichip(args.n, args.device, args.backend)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
