"""Explainability of the torch package: Grad-CAM and attention maps."""

from multimodal_rare_disease_tpu_torch.explain.attention import (  # noqa: F401
    cross_modal_attention_summary,
    text_token_attention,
)
from multimodal_rare_disease_tpu_torch.explain.gradcam import (  # noqa: F401
    GradCAM,
    cam_from_gradients,
    gradcam_heatmap,
    overlay_heatmap,
)
