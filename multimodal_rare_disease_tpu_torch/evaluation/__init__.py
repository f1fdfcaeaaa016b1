"""Evaluation and statistics of the torch package."""

from multimodal_rare_disease_tpu_torch.evaluation.evaluator import (  # noqa: F401
    Evaluator,
    compare_models,
    compute_metrics,
)
from multimodal_rare_disease_tpu_torch.evaluation.stats import (  # noqa: F401
    bootstrap_confidence_interval,
    chi_square_test,
    compare_multimodal_vs_unimodal,
    mcnemar_test,
)
