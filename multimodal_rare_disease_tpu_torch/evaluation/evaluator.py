"""Evaluation: predictions, metrics, artifacts. The counterpart of
`multimodal_rare_disease_tpu/evaluation/evaluator.py`.

- `Evaluator.collect_predictions`: the model's forward under
  `torch.inference_mode()` over the port's eval preprocess, batch by
  batch, with the padding rows of a final batch dropped by its `valid`
  mask;
- `compute_metrics`: accuracy, macro / weighted precision, recall and
  F1 (zero_division 0), per-class metrics, the confusion matrix and the
  one-vs-rest ROC-AUC, in numpy and scipy. It gives the JAX Evaluator's
  dict, which sklearn computes there, key for key; where sklearn raises
  (ROC-AUC over a label set with some classes missing, whose score
  columns no longer sum to 1), the key is left out, as there;
- `save_results`: `{mode}_metrics.json`, the classification report text
  (sklearn's layout), `{mode}_predictions.npz` (the exchange format of
  `evaluation/stats.py`), the three plots and `evaluation_results.json`;
- `compare_models`: a table, `model_comparison.json` and a bar plot.

The plots import matplotlib inside the call, so a host without it can
collect predictions and compute every metric.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch
from scipy import stats as sps

from multimodal_rare_disease_tpu_torch.config import SYNDROME_NAMES, Config
from multimodal_rare_disease_tpu_torch.ops.preprocess import eval_preprocess

log = logging.getLogger(__name__)


def _short_names(names: Iterable[str]) -> List[str]:
    out = []
    for n in names:
        n = n.replace(" Syndrome", "")
        out.append(n if len(n) <= 14 else n[:12] + "…")
    return out


# -- metrics (numpy / scipy, the definitions sklearn uses) ----------------

def confusion_matrix(y: np.ndarray, yhat: np.ndarray, num_classes: int
                     ) -> np.ndarray:
    """cm[i, j] = #(y == i and yhat == j) over labels 0..num_classes-1."""
    keep = (y >= 0) & (y < num_classes) & (yhat >= 0) & (yhat < num_classes)
    cm = np.zeros((num_classes, num_classes), np.int64)
    np.add.at(cm, (y[keep], yhat[keep]), 1)
    return cm


def _prf(y: np.ndarray, yhat: np.ndarray, labels: np.ndarray):
    """Per-label precision, recall, F1 (0 where undefined) and support."""
    tp = np.array([np.sum((y == c) & (yhat == c)) for c in labels])
    pred = np.array([np.sum(yhat == c) for c in labels])
    true = np.array([np.sum(y == c) for c in labels])

    def divide(num, den):
        return np.where(den == 0, 0.0, num / np.where(den == 0, 1, den))

    return (divide(tp, pred), divide(tp, true),
            divide(2.0 * tp, (true + pred).astype(np.float64)), true)


def _averages(y, yhat, labels):
    """(macro, weighted) (precision, recall, F1) over `labels`."""
    p, r, f1, support = _prf(y, yhat, labels)
    macro = tuple(float(np.average(v)) for v in (p, r, f1))
    weighted = tuple(float(np.average(v, weights=support))
                     for v in (p, r, f1))
    return macro, weighted


def _binary_auc(positive: np.ndarray, score: np.ndarray) -> float:
    """ROC-AUC by rank statistics (Mann-Whitney U, ties counted half)."""
    ranks = sps.rankdata(score)
    n_pos = int(positive.sum())
    n_neg = len(positive) - n_pos
    return float((ranks[positive].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


def roc_auc_ovr(y: np.ndarray, probs: np.ndarray) -> Optional[float]:
    """Macro one-vs-rest ROC-AUC over the classes present in y, or None
    where sklearn's `roc_auc_score` (called as the JAX Evaluator calls it,
    on the present classes' columns when some are missing) raises: fewer
    than three score columns, or rows that do not sum to 1."""
    present = np.unique(y)
    if len(present) < 2:
        return None
    score = probs if len(present) == probs.shape[1] else probs[:, present]
    if score.shape[1] <= 2 or not np.allclose(1, score.sum(axis=1)):
        return None
    return float(np.average([_binary_auc(y == c, score[:, j])
                             for j, c in enumerate(present)]))


def compute_metrics(collected: Dict[str, np.ndarray],
                    class_names: Optional[List[str]] = None) -> Dict:
    """The JAX Evaluator's metric dict from {labels, predictions,
    probabilities}."""
    class_names = list(class_names or SYNDROME_NAMES)
    y = np.asarray(collected["labels"])
    yhat = np.asarray(collected["predictions"])
    probs = np.asarray(collected["probabilities"])
    num_classes = probs.shape[1]

    # sklearn's averages run over the labels in y or yhat
    (pm, rm, fm), (pw, rw, fw) = _averages(y, yhat,
                                            np.union1d(y, yhat))
    result: Dict = {
        "accuracy": float(np.mean(y == yhat)),
        "precision_macro": pm, "recall_macro": rm, "f1_macro": fm,
        "precision_weighted": pw, "recall_weighted": rw, "f1_weighted": fw,
        "num_samples": int(len(y)),
    }
    p, r, f1, support = _prf(y, yhat, np.arange(num_classes))
    result["per_class"] = {
        name: {"precision": float(p[i]), "recall": float(r[i]),
               "f1": float(f1[i]), "support": int(support[i])}
        for i, name in enumerate(class_names[:num_classes])}
    auc = roc_auc_ovr(y, probs)
    if auc is not None:
        result["roc_auc_ovr"] = auc
    else:
        log.warning("roc_auc skipped: degenerate label set")
    result["confusion_matrix"] = confusion_matrix(y, yhat,
                                                  num_classes).tolist()
    return result


def classification_report(y: np.ndarray, yhat: np.ndarray, num_classes: int,
                          target_names: List[str], digits: int = 2) -> str:
    """sklearn's `classification_report(y, yhat, labels=range(C),
    target_names=..., zero_division=0)` text."""
    labels = np.arange(num_classes)
    p, r, f1, s = _prf(y, yhat, labels)
    headers = ["precision", "recall", "f1-score", "support"]
    width = max(max(len(n) for n in target_names), len("weighted avg"),
                digits)
    head_fmt = "{:>{width}s} " + " {:>9}" * len(headers)
    row_fmt = "{:>{width}s} " + " {:>9.{digits}f}" * 3 + " {:>9}\n"
    report = head_fmt.format("", *headers, width=width) + "\n\n"
    for row in zip(target_names, p, r, f1, s):
        report += row_fmt.format(*row, width=width, digits=digits)
    report += "\n"
    # every label is listed, so the micro average is the accuracy
    report += ("{:>{width}s} " + " {:>9.{digits}}" * 2 + " {:>9.{digits}f}"
               + " {:>9}\n").format("accuracy", "", "", float(np.mean(
                   y == yhat)), np.sum(s), width=width, digits=digits)
    (pm, rm, fm), (pw, rw, fw) = _averages(y, yhat, labels)
    report += row_fmt.format("macro avg", pm, rm, fm, np.sum(s),
                             width=width, digits=digits)
    report += row_fmt.format("weighted avg", pw, rw, fw, np.sum(s),
                             width=width, digits=digits)
    return report


class Evaluator:
    """Collect predictions from the model's forward and compute the full
    metric / artifact suite. `model` is a port model of `mode` on its
    device in its compute dtype (a predictor's `.model`, which under
    `quantized_inference` holds the int8 codes of its f32 weights)."""

    def __init__(self, cfg: Config, model: torch.nn.Module,
                 mode: str = "multimodal",
                 class_names: Optional[List[str]] = None):
        self.cfg = cfg
        self.model = model
        self.mode = mode
        self.class_names = list(class_names or SYNDROME_NAMES)
        p = next(model.parameters())
        self.device, self.dtype = p.device, p.dtype

    @torch.inference_mode()
    def _forward(self, batch: Dict[str, np.ndarray]) -> torch.Tensor:
        def dev(key):
            t = torch.from_numpy(np.ascontiguousarray(batch[key]))
            return t.to(self.device, torch.long if key != "images"
                        else torch.uint8)

        args = []
        if self.mode != "text_only":
            args.append(eval_preprocess(dev("images"), self.cfg,
                                        dtype=self.dtype))
        if self.mode != "image_only":
            args += [dev("input_ids"), dev("attention_mask")]
        return self.model(*args)["probs"]

    def collect_predictions(self, batches) -> Dict[str, np.ndarray]:
        """batches: iterable of dicts with 'labels', 'valid' and the
        mode's inputs (uint8 'images' [B, S, S, 3], 'input_ids' /
        'attention_mask' [B, T]) → {predictions, labels, probabilities}."""
        all_probs, all_labels = [], []
        for batch in batches:
            probs = self._forward(batch).float().cpu().numpy()
            valid = batch.get("valid", np.ones(len(probs), np.float32)) > 0
            all_probs.append(probs[valid])
            all_labels.append(np.asarray(batch["labels"])[valid])
        probs = np.concatenate(all_probs)
        labels = np.concatenate(all_labels)
        return {
            "predictions": probs.argmax(-1).astype(np.int64),
            "labels": labels.astype(np.int64),
            "probabilities": probs.astype(np.float32),
        }

    def compute_metrics(self, collected: Dict[str, np.ndarray]) -> Dict:
        return compute_metrics(collected, self.class_names)

    # -- plots -------------------------------------------------------------

    def plot_confusion_matrix(self, collected, path: str | Path,
                              normalize: bool = True) -> None:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        num_classes = collected["probabilities"].shape[1]
        cm = confusion_matrix(collected["labels"], collected["predictions"],
                              num_classes).astype(np.float64)
        if normalize:
            rows = cm.sum(1, keepdims=True)
            cm = np.divide(cm, rows, out=np.zeros_like(cm), where=rows > 0)
        names = _short_names(self.class_names[:num_classes])
        fig, ax = plt.subplots(figsize=(10, 8))
        im = ax.imshow(cm, cmap="Blues")
        fig.colorbar(im, ax=ax)
        fmt = "{:.2f}" if normalize else "{:.0f}"
        for i in range(num_classes):
            for j in range(num_classes):
                ax.text(j, i, fmt.format(cm[i, j]), ha="center",
                        va="center", fontsize=7,
                        color="white" if cm[i, j] > cm.max() / 2 else "black")
        ax.set_xticks(range(num_classes))
        ax.set_xticklabels(names, rotation=45, ha="right", fontsize=8)
        ax.set_yticks(range(num_classes))
        ax.set_yticklabels(names, fontsize=8)
        ax.set_xlabel("Predicted")
        ax.set_ylabel("True")
        ax.set_title(f"Confusion Matrix ({self.mode})")
        fig.tight_layout()
        fig.savefig(path, dpi=120)
        plt.close(fig)

    def plot_roc_curves(self, collected, path: str | Path) -> None:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        y = collected["labels"]
        probs = collected["probabilities"]
        fig, ax = plt.subplots(figsize=(10, 8))
        for i in range(probs.shape[1]):
            pos = y == i
            if pos.sum() == 0 or pos.all():
                continue
            # the curve through every distinct threshold, highest first
            order = np.argsort(-probs[:, i], kind="stable")
            s, hit = probs[order, i], pos[order]
            last = np.r_[np.flatnonzero(np.diff(s)), len(s) - 1]
            tpr = np.r_[0.0, np.cumsum(hit)[last] / pos.sum()]
            fpr = np.r_[0.0, np.cumsum(~hit)[last] / (~pos).sum()]
            ax.plot(fpr, tpr,
                    label=f"{_short_names([self.class_names[i]])[0]} "
                          f"(AUC {_binary_auc(pos, probs[:, i]):.2f})")
        ax.plot([0, 1], [0, 1], "k--", lw=0.8)
        ax.set_xlabel("False positive rate")
        ax.set_ylabel("True positive rate")
        ax.set_title(f"Per-class ROC ({self.mode})")
        ax.legend(fontsize=8, loc="lower right")
        fig.tight_layout()
        fig.savefig(path, dpi=120)
        plt.close(fig)

    def plot_per_class_metrics(self, metrics: Dict, path: str | Path) -> None:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        per_class = metrics["per_class"]
        names = _short_names(per_class.keys())
        x = np.arange(len(names))
        width = 0.27
        fig, ax = plt.subplots(figsize=(12, 5))
        for off, key in zip((-width, 0, width), ("precision", "recall", "f1")):
            ax.bar(x + off, [v[key] for v in per_class.values()], width,
                   label=key)
        ax.set_xticks(x)
        ax.set_xticklabels(names, rotation=45, ha="right", fontsize=8)
        ax.set_ylim(0, 1.05)
        ax.legend()
        ax.set_title(f"Per-class metrics ({self.mode})")
        fig.tight_layout()
        fig.savefig(path, dpi=120)
        plt.close(fig)

    # -- artifacts ---------------------------------------------------------

    def save_results(self, collected: Dict[str, np.ndarray],
                     results_dir: Optional[str | Path] = None) -> Dict:
        """Write the full artifact set; returns the metrics dict."""
        results_dir = Path(results_dir or self.cfg.evaluation.results_dir)
        results_dir.mkdir(parents=True, exist_ok=True)
        metrics = self.compute_metrics(collected)
        with open(results_dir / f"{self.mode}_metrics.json", "w",
                  encoding="utf-8") as f:
            json.dump(metrics, f, indent=2)

        report = classification_report(
            collected["labels"], collected["predictions"],
            collected["probabilities"].shape[1], self.class_names)
        (results_dir / f"{self.mode}_classification_report.txt").write_text(
            report, encoding="utf-8")
        np.savez(results_dir / f"{self.mode}_predictions.npz",
                 predictions=collected["predictions"],
                 labels=collected["labels"],
                 probabilities=collected["probabilities"])
        self.plot_confusion_matrix(
            collected, results_dir / f"{self.mode}_confusion_matrix.png")
        self.plot_roc_curves(collected,
                             results_dir / f"{self.mode}_roc_curves.png")
        self.plot_per_class_metrics(
            metrics, results_dir / f"{self.mode}_per_class_metrics.png")

        # the reference's results/evaluation_results.json schema
        legacy = {
            "accuracy": metrics["accuracy"],
            "macro_precision": metrics["precision_macro"],
            "macro_recall": metrics["recall_macro"],
            "macro_f1": metrics["f1_macro"],
            "total_samples": metrics["num_samples"],
            "per_class": metrics["per_class"],
        }
        with open(results_dir / "evaluation_results.json", "w",
                  encoding="utf-8") as f:
            json.dump(legacy, f, indent=2)
        return metrics


def compare_models(metrics_by_mode: Dict[str, Dict],
                   results_dir: Optional[str | Path] = None) -> str:
    """Comparison table; with `results_dir`, also
    `model_comparison.json` and a bar plot."""
    keys = ["accuracy", "precision_macro", "recall_macro", "f1_macro"]
    header = f"{'model':<14}" + "".join(f"{k:<18}" for k in keys)
    lines = [header, "-" * len(header)]
    for mode, m in metrics_by_mode.items():
        lines.append(f"{mode:<14}" + "".join(
            f"{m.get(k, float('nan')):<18.4f}" for k in keys))
    table = "\n".join(lines)

    if results_dir is not None:
        results_dir = Path(results_dir)
        results_dir.mkdir(parents=True, exist_ok=True)
        with open(results_dir / "model_comparison.json", "w",
                  encoding="utf-8") as f:
            json.dump(metrics_by_mode, f, indent=2)

        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        x = np.arange(len(keys))
        width = 0.8 / max(1, len(metrics_by_mode))
        fig, ax = plt.subplots(figsize=(9, 5))
        for i, (mode, m) in enumerate(metrics_by_mode.items()):
            ax.bar(x + i * width, [m.get(k, 0) for k in keys], width,
                   label=mode)
        ax.set_xticks(x + width * (len(metrics_by_mode) - 1) / 2)
        ax.set_xticklabels(keys)
        ax.set_ylim(0, 1.05)
        ax.legend()
        ax.set_title("Model comparison")
        fig.tight_layout()
        fig.savefig(results_dir / "model_comparison.png", dpi=120)
        plt.close(fig)
    return table
