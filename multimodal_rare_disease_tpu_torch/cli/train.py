"""Training CLI of the torch package, with the JAX `cli/train.py`'s flags
(`--device` in place of `--platform`):

  --mode multimodal   ≈ run_multimodal_training.py (multimodal preset)
  --mode image_only   ≈ run_training.py / src/train_small_data.py
  --mode text_only    ≈ src/train.py --mode text_only
  --smoke-test        ≈ src/train.py --smoke_test (synthetic corpus,
                        2 epochs, reduced model)

    python -m multimodal_rare_disease_tpu_torch.cli.train --smoke-test \\
        --device cpu

Prints the same JSON summary as the JAX command. `--data fgdd` trains on
the FGDD patient phenotype texts (`<data root>/FGDD/FGDD.csv` or
`<data root>/FGDD/FGDD/FGDD.csv`, names from `FGDD/Raw data/phenotype.csv`):
`--mode text_only` on the texts and their diseases, `--mode multimodal`
on the image corpus with the texts cycled onto its images (labels from
the images), as the JAX command does.

`--mesh DPxTP` trains over a rank mesh (parallel/mesh.py): the command
starts DP x TP ranks itself (torch.multiprocessing), each builds the same
pipeline from the seed and the Trainer steps on the global batch split
over the data axis, the BERT tower Megatron-sharded over the model axis;
rank 0 writes the checkpoints and prints the summary. `--backend gloo`
lets the ranks share one card, or run on the CPU with `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import tempfile

from multimodal_rare_disease_tpu_torch.cli._common import (
    add_config_args,
    add_mesh_args,
    build_config,
    parse_mesh,
    setup_logging,
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Train the rare-disease diagnosis model (PyTorch)")
    parser.add_argument("--mode", default="multimodal",
                        choices=["multimodal", "image_only", "text_only"])
    parser.add_argument("--image-dir", default=None,
                        help="image corpus directory (default: search data roots)")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--augmentation-factor", type=int, default=None)
    parser.add_argument("--checkpoint-dir", default=None)
    parser.add_argument("--smoke-test", action="store_true",
                        help="2-epoch run on a synthetic corpus with a "
                             "reduced model (no data required)")
    parser.add_argument("--data", default="images",
                        choices=["images", "fgdd"],
                        help="images: facial-image corpus; fgdd: FGDD "
                             "patient phenotype texts (text_only mode)")
    parser.add_argument("--resume", action="store_true",
                        help="continue from the last checkpoint for this mode")
    add_config_args(parser)
    add_mesh_args(parser, "train")
    args = parser.parse_args(argv)
    setup_logging()
    if args.data == "fgdd" and args.mode == "image_only":
        parser.error("--data fgdd supports --mode text_only or "
                     "multimodal (see PARITY.md)")

    from multimodal_rare_disease_tpu_torch.models.classifier import (
        resolve_device,
    )

    device = resolve_device(args.device)

    extra = {}
    if args.epochs is not None:
        # keep the LR schedule horizon in sync with the actual run length
        extra["training.num_epochs"] = args.epochs
    if args.batch_size is not None:
        extra["training.batch_size"] = args.batch_size
    if args.lr is not None:
        extra["training.learning_rate"] = args.lr
    if args.augmentation_factor is not None:
        extra["data.augmentation_factor"] = args.augmentation_factor
    if args.checkpoint_dir is not None:
        extra["training.checkpoint_dir"] = args.checkpoint_dir

    image_dir = args.image_dir
    epochs = args.epochs
    if args.smoke_test:
        extra.update({
            "data.image_size": 64,
            "data.max_text_length": 32,
            "data.augmentation_factor": 1,
            "text_encoder.num_layers": 2,
            "text_encoder.num_heads": 2,
            "text_encoder.hidden_size": 64,
            "text_encoder.intermediate_size": 128,
            "text_encoder.max_length": 32,
            "fusion.text_proj_dim": 64,
            "fusion.hidden_dim": 64,
            "cnn_encoder.embedding_dim": 64,
            "training.batch_size": 8,
            "training.compute_dtype": "float32",
            "training.warmup_epochs": 0,
        })
        epochs = epochs or 2
        if image_dir is None:
            from multimodal_rare_disease_tpu_torch.data.synthetic import (
                generate_synthetic_for_training,
            )

            image_dir = tempfile.mkdtemp(prefix="mmrd_smoke_")
            generate_synthetic_for_training(image_dir, num_per_class=4,
                                            image_size=64)

    cfg = build_config(args, args.mode, extra)
    if not args.mesh:
        summary = _train(args, cfg, image_dir, epochs, device)
    else:
        from multimodal_rare_disease_tpu_torch.parallel import distributed

        data_axis, model_axis = parse_mesh(parser, args.mesh)
        world = data_axis * model_axis
        init = distributed.file_init_method()
        run = (args, cfg, image_dir, epochs, data_axis, model_axis)
        procs = [distributed.spawn_rank(_rank, r, world, init, args.backend,
                                        args=run) for r in range(1, world)]
        try:
            distributed.maybe_initialize(init, world, 0, args.backend)
            summary = _rank(0, world, *run)
        finally:
            distributed.shutdown()
            distributed.stop(procs, grace_s=60.0)
    print(json.dumps(summary, indent=2))
    return 0


def _rank(rank: int, world: int, args, cfg, image_dir, epochs,
          data_axis: int, model_axis: int) -> dict:
    """One rank of `--mesh`: its place in the mesh, then the run."""
    from multimodal_rare_disease_tpu_torch.parallel.mesh import (
        create_mesh,
        rank_devices,
    )

    mesh = create_mesh(cfg, data_axis=data_axis, model_axis=model_axis,
                       devices=rank_devices(world, args.device))
    return _train(args, cfg, image_dir, epochs, mesh.device, mesh=mesh)


def _train(args, cfg, image_dir, epochs, device, mesh=None) -> dict:
    from multimodal_rare_disease_tpu_torch.train.pipeline import DataPipeline
    from multimodal_rare_disease_tpu_torch.train.trainer import Trainer

    if args.data == "fgdd":
        if args.mode == "text_only":
            from multimodal_rare_disease_tpu_torch.train.text_pipeline import (
                fgdd_text_pipeline,
            )

            pipeline = fgdd_text_pipeline(cfg)
        else:
            # the reference's cycle-pairing of FGDD texts onto corpus
            # images, labels from the images (`src/train.py:797-811`)
            from multimodal_rare_disease_tpu_torch.train.text_pipeline import (
                fgdd_multimodal_pipeline,
            )

            print("note: FGDD multimodal pairing cycles unrelated texts "
                  "onto corpus images (labels from images) — reference-"
                  "parity behavior, see PARITY.md")
            pipeline = fgdd_multimodal_pipeline(cfg, image_dir=image_dir)
    else:
        pipeline = DataPipeline(cfg, mode=args.mode, image_dir=image_dir,
                                device=device)
    trainer = Trainer(cfg, mode=args.mode, pipeline=pipeline,
                      workdir=cfg.training.checkpoint_dir, device=device,
                      mesh=mesh)
    if args.resume:
        from multimodal_rare_disease_tpu_torch.utils.checkpoint import (
            checkpoint_exists,
            role_path,
        )

        last = role_path(trainer.workdir, args.mode, "last")
        if checkpoint_exists(last):
            trainer.load(last)
            print(f"resuming from {last} "
                  f"(epoch {len(trainer.history['train_loss'])})")
    result = trainer.train(num_epochs=epochs)
    summary = {
        "mode": args.mode,
        "epochs_run": len(result["history"]["train_loss"]),
        "best_metric": result["best_metric"],
        "final_train_loss": result["history"]["train_loss"][-1],
        "final_val_acc": result["history"]["val_acc"][-1],
        "total_time_sec": round(result["total_time"], 2),
        "skipped_steps": result["skipped_steps"],
        "checkpoint_dir": str(trainer.workdir),
    }
    if mesh is not None:
        summary["mesh"] = mesh.shape
    return summary


if __name__ == "__main__":
    raise SystemExit(main())
