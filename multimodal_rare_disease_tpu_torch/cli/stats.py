"""Statistical validation CLI of the torch package: chi-square, McNemar
and bootstrap CIs over the `*_predictions.npz` dumps that cli.evaluate
writes, or with --demo over synthetic predictions at known accuracies
(multimodal 85%, image 75%, text 70%, n=500). It runs on the host only;
`--device` is accepted for symmetry with the other CLIs."""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from multimodal_rare_disease_tpu_torch.cli._common import add_device_arg


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Chi-square / McNemar / bootstrap validation of "
                    "multimodal vs unimodal predictions")
    parser.add_argument("--results-dir", default="results")
    parser.add_argument("--n-bootstrap", type=int, default=1000)
    parser.add_argument("--demo", action="store_true",
                        help="run on synthetic predictions at known "
                             "accuracies (multimodal 85%%, image 75%%, "
                             "text 70%%, n=500)")
    add_device_arg(parser)
    args = parser.parse_args(argv)

    from multimodal_rare_disease_tpu_torch.evaluation.stats import (
        compare_multimodal_vs_unimodal,
        hypothesis_conclusion,
        make_demo_predictions,
        run_statistical_validation,
    )

    if args.demo:
        preds, labels = make_demo_predictions(n=500)
        results = compare_multimodal_vs_unimodal(preds, labels,
                                                 args.n_bootstrap)
    else:
        results = run_statistical_validation(args.results_dir,
                                             args.n_bootstrap)
        if results is None:
            print(f"no prediction dumps (*_predictions.npz) found in "
                  f"{args.results_dir}; run cli.evaluate first or use "
                  f"--demo")
            return 1

    for name, ci in results["confidence_intervals"].items():
        print(f"{name:<12} acc={ci['accuracy']:.3f} "
              f"[{ci['ci_lower']:.3f}, {ci['ci_upper']:.3f}]")
    print()
    for pair, v in results["pairwise"].items():
        print(f"{pair}: chi2 p={v['chi_square']['p_value']:.4f}  "
              f"mcnemar p={v['mcnemar']['p_value']:.4f} "
              f"({v['mcnemar']['method']})")
    print()
    print(hypothesis_conclusion(results))

    if args.demo:
        out = Path(args.results_dir)
        out.mkdir(parents=True, exist_ok=True)
        with open(out / "statistical_results.json", "w") as f:
            json.dump(results, f, indent=2, default=float)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
