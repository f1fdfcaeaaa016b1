"""Evaluation CLI of the torch package: scores one or more checkpoints on
a split of the image corpus, writes each mode's artifacts
(`evaluation/evaluator.py`), compares the models, and with --stats runs
the chi-square / McNemar validation over their prediction dumps.

  python -m multimodal_rare_disease_tpu_torch.cli.evaluate \\
      --checkpoint ckpt/multimodal --checkpoint ckpt/image_only --stats
"""

from __future__ import annotations

import argparse
import json

from multimodal_rare_disease_tpu_torch.cli._common import (
    add_device_arg,
    setup_logging,
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Evaluate a trained model")
    parser.add_argument("--checkpoint", required=True, action="append",
                        help="checkpoint dir; repeat to compare models")
    parser.add_argument("--mode", default=None, action="append",
                        help="mode per checkpoint (default: from meta)")
    parser.add_argument("--image-dir", default=None)
    parser.add_argument("--results-dir", default=None)
    parser.add_argument("--split", default="val",
                        choices=["val", "train", "all"])
    parser.add_argument("--stats", action="store_true",
                        help="run chi-square/McNemar after evaluating "
                             "multiple checkpoints")
    add_device_arg(parser)
    args = parser.parse_args(argv)
    setup_logging()

    from multimodal_rare_disease_tpu_torch.evaluation import (
        Evaluator,
        compare_models,
    )
    from multimodal_rare_disease_tpu_torch.inference.predictor import (
        load_predictor,
    )
    from multimodal_rare_disease_tpu_torch.train.pipeline import DataPipeline

    metrics_by_mode = {}
    results_dir = args.results_dir
    for i, ckpt in enumerate(args.checkpoint):
        mode = args.mode[i] if args.mode and i < len(args.mode) else None
        predictor = load_predictor(ckpt, args.device, mode=mode)
        cfg = predictor.cfg
        if results_dir is None:
            results_dir = cfg.evaluation.results_dir
        pipeline = DataPipeline(cfg, mode=predictor.mode,
                                image_dir=args.image_dir,
                                tokenizer=predictor.tokenizer)
        if args.split == "val":
            batches = pipeline.val_batches()
        elif args.split == "train":
            batches = pipeline.train_batches()
        else:
            def _all(p=pipeline):
                yield from p.val_batches()
                yield from p.train_batches()
            batches = _all()

        ev = Evaluator(cfg, predictor.model, mode=predictor.mode)
        metrics = ev.save_results(ev.collect_predictions(batches),
                                  results_dir)
        metrics_by_mode[predictor.mode] = metrics
        print(f"[{predictor.mode}] accuracy={metrics['accuracy']:.4f} "
              f"f1_macro={metrics['f1_macro']:.4f} "
              f"n={metrics['num_samples']}")

    if len(metrics_by_mode) > 1:
        print()
        print(compare_models(metrics_by_mode, results_dir))

    if args.stats:
        from multimodal_rare_disease_tpu_torch.evaluation.stats import (
            hypothesis_conclusion,
            run_statistical_validation,
        )

        results = run_statistical_validation(results_dir)
        if results is None:
            print("stats: need >=2 modes' prediction dumps")
        else:
            print(hypothesis_conclusion(results))

    print(json.dumps({m: {"accuracy": v["accuracy"],
                          "f1_macro": v["f1_macro"]}
                      for m, v in metrics_by_mode.items()}, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
