"""Statistical validation: chi-square, McNemar, bootstrap CIs. The torch
package's own copy (numpy + scipy) of the JAX package's
`evaluation/stats.py`, pinned equal to it by the tests.

- chi_square_test: 2x2 contingency of per-sample correctness between two
  models;
- mcnemar_test: exact binomial when discordant pairs < 25, else the
  continuity-corrected chi-square;
- bootstrap_confidence_interval: percentile CI over resampled accuracy;
- compare_multimodal_vs_unimodal: all-pairs comparison + summary, over
  the `{mode}_predictions.npz` dumps that `evaluation/evaluator.py`
  writes;
- hypothesis_conclusion: the H0/H1 text (p < 0.05).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
from scipy import stats as sps


def chi_square_test(preds_a: np.ndarray, preds_b: np.ndarray,
                    labels: np.ndarray) -> Dict[str, float]:
    """Chi-square on the 2x2 correctness contingency of two models."""
    a_correct = (np.asarray(preds_a) == np.asarray(labels))
    b_correct = (np.asarray(preds_b) == np.asarray(labels))
    table = np.array([
        [np.sum(a_correct & b_correct), np.sum(a_correct & ~b_correct)],
        [np.sum(~a_correct & b_correct), np.sum(~a_correct & ~b_correct)],
    ], dtype=np.float64)
    if table.min() == 0 and (table == 0).sum() > 1:
        chi2, p = 0.0, 1.0
        dof = 1
    else:
        # guard: chi2_contingency fails on zero rows/cols
        try:
            chi2, p, dof, _ = sps.chi2_contingency(table, correction=True)
        except ValueError:
            chi2, p, dof = 0.0, 1.0, 1
    return {
        "chi2_statistic": float(chi2),
        "p_value": float(p),
        "dof": int(dof),
        "contingency_table": table.tolist(),
        "accuracy_a": float(a_correct.mean()),
        "accuracy_b": float(b_correct.mean()),
        "significant": bool(p < 0.05),
    }


def mcnemar_test(preds_a: np.ndarray, preds_b: np.ndarray,
                 labels: np.ndarray) -> Dict[str, float]:
    """McNemar's test on discordant pairs (direct implementation)."""
    a_correct = (np.asarray(preds_a) == np.asarray(labels))
    b_correct = (np.asarray(preds_b) == np.asarray(labels))
    n01 = int(np.sum(a_correct & ~b_correct))  # a right, b wrong
    n10 = int(np.sum(~a_correct & b_correct))  # a wrong, b right
    n_discordant = n01 + n10
    if n_discordant == 0:
        stat, p, method = 0.0, 1.0, "exact"
    elif n_discordant < 25:
        # exact binomial: P(X <= min | n, 0.5) two-sided
        k = min(n01, n10)
        p = float(min(1.0, 2.0 * sps.binom.cdf(k, n_discordant, 0.5)))
        stat = float(k)
        method = "exact"
    else:
        stat = (abs(n01 - n10) - 1) ** 2 / n_discordant
        p = float(sps.chi2.sf(stat, df=1))
        method = "chi2"
    return {
        "statistic": float(stat),
        "p_value": float(p),
        "method": method,
        "n01": n01,
        "n10": n10,
        "n_discordant": n_discordant,
        "significant": bool(p < 0.05),
    }


def bootstrap_confidence_interval(
    preds: np.ndarray,
    labels: np.ndarray,
    n_bootstrap: int = 1000,
    confidence: float = 0.95,
    rng: Optional[np.random.Generator] = None,
) -> Dict[str, float]:
    """Percentile bootstrap CI on accuracy."""
    rng = rng or np.random.default_rng(42)
    preds = np.asarray(preds)
    labels = np.asarray(labels)
    n = len(labels)
    accs = np.empty(n_bootstrap)
    for i in range(n_bootstrap):
        idx = rng.integers(0, n, n)
        accs[i] = np.mean(preds[idx] == labels[idx])
    alpha = (1 - confidence) / 2
    return {
        "accuracy": float(np.mean(preds == labels)),
        "ci_lower": float(np.quantile(accs, alpha)),
        "ci_upper": float(np.quantile(accs, 1 - alpha)),
        "confidence": confidence,
        "n_bootstrap": n_bootstrap,
    }


def compare_multimodal_vs_unimodal(
    predictions: Dict[str, np.ndarray],
    labels: np.ndarray,
    n_bootstrap: int = 1000,
) -> Dict[str, dict]:
    """All-pairs chi-square + McNemar + per-model bootstrap CIs.

    predictions: {model_name: pred_array}.
    """
    names = list(predictions)
    results: Dict[str, dict] = {"pairwise": {}, "confidence_intervals": {},
                                "summary": {}}
    for name in names:
        results["confidence_intervals"][name] = bootstrap_confidence_interval(
            predictions[name], labels, n_bootstrap)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            key = f"{a}_vs_{b}"
            results["pairwise"][key] = {
                "chi_square": chi_square_test(predictions[a], predictions[b],
                                              labels),
                "mcnemar": mcnemar_test(predictions[a], predictions[b], labels),
            }
    accs = {n: float(np.mean(predictions[n] == labels)) for n in names}
    best = max(accs, key=accs.get)
    results["summary"] = {
        "accuracies": accs,
        "best_model": best,
        "significant_pairs": [
            k for k, v in results["pairwise"].items()
            if v["mcnemar"]["significant"]
        ],
    }
    return results


def hypothesis_conclusion(results: Dict[str, dict],
                          multimodal_name: str = "multimodal") -> str:
    """H0/H1 textual conclusion."""
    lines = ["=" * 70, "STATISTICAL HYPOTHESIS TEST", "=" * 70,
             "H0: multimodal fusion does NOT significantly improve accuracy",
             "H1: multimodal fusion DOES significantly improve accuracy", ""]
    any_sig = False
    for key, v in results.get("pairwise", {}).items():
        if multimodal_name in key:
            p = v["mcnemar"]["p_value"]
            sig = v["mcnemar"]["significant"]
            any_sig |= sig
            lines.append(f"  {key}: McNemar p={p:.4f} "
                         f"({'significant' if sig else 'not significant'})")
    lines.append("")
    if any_sig:
        lines.append("Conclusion: REJECT H0 (p < 0.05) — the multimodal model "
                     "shows a statistically significant improvement.")
    else:
        lines.append("Conclusion: FAIL TO REJECT H0 — no statistically "
                     "significant improvement detected.")
    lines.append("=" * 70)
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# npz exchange format (evaluation/evaluator.py writes the dumps)
# ---------------------------------------------------------------------------

def load_predictions_npz(results_dir: str | Path,
                         modes: Sequence[str] = ("multimodal", "image_only",
                                                 "text_only")
                         ) -> Tuple[Dict[str, np.ndarray], Optional[np.ndarray]]:
    preds: Dict[str, np.ndarray] = {}
    labels = None
    for mode in modes:
        p = Path(results_dir) / f"{mode}_predictions.npz"
        if p.exists():
            data = np.load(p)
            preds[mode] = data["predictions"]
            labels = data["labels"]
    return preds, labels


def run_statistical_validation(results_dir: str | Path,
                               n_bootstrap: int = 1000) -> Optional[dict]:
    """Load npz dumps, run comparisons, write statistical_results.json."""
    preds, labels = load_predictions_npz(results_dir)
    if len(preds) < 2 or labels is None:
        return None
    results = compare_multimodal_vs_unimodal(preds, labels, n_bootstrap)
    out = Path(results_dir) / "statistical_results.json"
    with open(out, "w", encoding="utf-8") as f:
        json.dump(results, f, indent=2, default=float)
    return results


def make_demo_predictions(
    n: int = 500, num_classes: int = 10,
    accuracies: Dict[str, float] = None,
    seed: int = 42,
) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Synthetic oracle (the stats CLI's --demo): fabricate predictions at
    known accuracies (default multimodal 85% / image 75% / text 70%)."""
    accuracies = accuracies or {"multimodal": 0.85, "image_only": 0.75,
                                "text_only": 0.70}
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, n)
    preds = {}
    for name, acc in accuracies.items():
        correct = rng.random(n) < acc
        wrong = (labels + rng.integers(1, num_classes, n)) % num_classes
        preds[name] = np.where(correct, labels, wrong)
    return preds, labels
