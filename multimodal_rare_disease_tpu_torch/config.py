"""Configuration of the torch package: its own copy of the JAX package's
`multimodal_rare_disease_tpu/config.py`, which it may not import.

One immutable dataclass tree with the same sections, fields, defaults
and presets, resolved once per run by `resolve_config(preset, overrides)`
with dotted-path overrides. `tests/test_torch_host_copies.py` holds every
preset equal to the JAX package's as a dict. One difference: the data
search roots are the repository's `data/` only (the JAX package also
names an absolute fallback corpus directory outside the repository).

The text-encoder knobs keep the JAX names. In the port `fused_ffn`
selects the hand-written FFN kernel (K1/K2, `kernels/ffn.py`) and
`fused_attn_out` the attention-output kernel (K3, `kernels/attn_out.py`);
`pre_layernorm` takes the pre-LN layers, which run no kernel, as in the
JAX dispatch; `quantized_inference` runs the BERT tower's four big
products in int8 at inference (`models/quant.py`; K1-K3 then stay off,
as the JAX gates `not q8`), and `flat_residual` keeps its residual
stream [B·T, H] between the layers (the same values). As with the JAX
CLIs' `--set`, a value is read with `ast.literal_eval`: write `True` /
`False` (the word `false` stays a non-empty string, which is true).
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field, fields, replace
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple

BASE_DIR = Path(__file__).resolve().parent.parent
DATA_DIR = BASE_DIR / "data"
RESULTS_DIR = BASE_DIR / "results"
CHECKPOINTS_DIR = BASE_DIR / "checkpoints"

# Canonical label order for the 10 rare syndromes.
SYNDROME_NAMES: Tuple[str, ...] = (
    "Cornelia de Lange Syndrome",
    "Williams-Beuren Syndrome",
    "Noonan Syndrome",
    "Kabuki Syndrome",
    "KBG Syndrome",
    "Angelman Syndrome",
    "Rubinstein-Taybi Syndrome",
    "Smith-Magenis Syndrome",
    "Nicolaides-Baraitser Syndrome",
    "22q11.2 Deletion Syndrome",
)

# Flat-layout filename prefixes (SYN_<code>_NNN.png) → syndrome name.
PREFIX_TO_SYNDROME: Dict[str, str] = {
    "CdLS": "Cornelia de Lange Syndrome",
    "WBS": "Williams-Beuren Syndrome",
    "NS": "Noonan Syndrome",
    "KS": "Kabuki Syndrome",
    "KBG": "KBG Syndrome",
    "AS": "Angelman Syndrome",
    "RSTS": "Rubinstein-Taybi Syndrome",
    "SMS": "Smith-Magenis Syndrome",
    "NBS": "Nicolaides-Baraitser Syndrome",
    "22Q": "22q11.2 Deletion Syndrome",
}

# Folder names (underscore, hyphen and human-readable forms, and the
# flat-layout codes) → syndrome.
FOLDER_TO_SYNDROME: Dict[str, str] = {}
for _name in SYNDROME_NAMES:
    FOLDER_TO_SYNDROME[_name] = _name
    FOLDER_TO_SYNDROME[_name.replace(" ", "_")] = _name
    FOLDER_TO_SYNDROME[_name.replace(" ", "-")] = _name
for _code, _name in PREFIX_TO_SYNDROME.items():
    FOLDER_TO_SYNDROME[f"SYN_{_code}"] = _name
    FOLDER_TO_SYNDROME[_code] = _name


def syndrome_index(name: str) -> int:
    return SYNDROME_NAMES.index(name)


@dataclass(frozen=True)
class DataConfig:
    image_size: int = 224
    image_channels: int = 3

    max_text_length: int = 128
    text_model_name: str = "dmis-lab/biobert-base-cased-v1.2"

    # search roots for the corpus; the first existing path wins
    data_dirs: Tuple[str, ...] = (str(DATA_DIR),)
    image_subdirs: Tuple[str, ...] = (
        "images_augmented",
        "images_organized",
        "images",
    )
    clinical_descriptions: str = "syndrome_clinical_descriptions.json"
    phenotype_metadata: str = "phenotype_metadata.csv"

    orphadata_diseases: str = "orphadata/orphadata_diseases.xml"
    orphadata_phenotypes: str = "orphadata/orphadata_phenotypes.xml"
    orphadata_genes: str = "orphadata/orphadata_genes.xml"
    hpo_ontology: str = "hpo/hp.obo"
    hpo_annotations: str = "hpo/phenotype.hpoa"
    fgdd_dir: str = "FGDD"

    train_ratio: float = 0.70
    val_ratio: float = 0.15
    test_ratio: float = 0.15

    augment_images: bool = True
    augmentation_factor: int = 1
    geometry_mode: str = "separable"  # 'separable' | 'gather'
    # deterministic eval geometry (ops/preprocess.eval_resample_params):
    # 'resize_crop' = Resize(image_size+10) + CenterCrop; 'resize'
    eval_transform: str = "resize_crop"
    horizontal_flip_prob: float = 0.5
    rotation_degrees: float = 15.0
    online_rotation: bool = True
    brightness_factor: float = 0.2
    contrast_factor: float = 0.2
    saturation_factor: float = 0.2
    hue_factor: float = 0.1
    crop_scale_min: float = 0.8
    random_erasing_prob: float = 0.0
    gaussian_blur_prob: float = 0.0
    gaussian_noise_std: float = 0.0
    perspective_prob: float = 0.0
    perspective_distortion: float = 0.2
    clahe_prob: float = 0.0
    elastic_prob: float = 0.0
    coarse_dropout_prob: float = 0.0
    coarse_dropout_holes: int = 8
    mixup_alpha: float = 0.0

    use_weighted_sampling: bool = True

    use_face_detection: bool = False
    face_detector: str = "auto"  # 'auto' | 'heuristic' | 'mtcnn'
    mtcnn_weights: str = ""

    prefetch_batches: int = 2


@dataclass(frozen=True)
class CNNEncoderConfig:
    backbone: str = "resnet50"  # resnet50 | efficientnet_b0
    pretrained: bool = False
    embedding_dim: int = 512
    freeze_backbone: bool = False
    freeze_stages: int = 0
    dropout: float = 0.5
    # ResNet blocks per stage; None = the canonical ResNet-50 (3, 4, 6, 3)
    stage_sizes: Optional[Tuple[int, int, int, int]] = None


@dataclass(frozen=True)
class TextEncoderConfig:
    """A BERT-base-compatible transformer."""

    model_name: str = "dmis-lab/biobert-base-cased-v1.2"
    vocab_size: int = 28996
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    embedding_dim: int = 768
    max_length: int = 128
    freeze_embeddings: bool = False
    freeze_layers: int = 0
    dropout: float = 0.1
    use_pooler_output: bool = False  # CLS token when False
    # fused FFN sublayer LN(x + gelu(x@w1+b1)@w2 + b2) at inference
    fused_ffn: bool = True
    # fused attention-output sublayer LN(x + ctx@wo + bo) at inference
    fused_attn_out: bool = False
    # W8A8 int8 BERT products at inference (models/quant.py)
    quantized_inference: bool = False
    pre_layernorm: bool = False
    # the residual stream [B*T, H] between the BERT layers (same values)
    flat_residual: bool = False


@dataclass(frozen=True)
class FusionConfig:
    fusion_type: str = "attention"  # concatenation | attention | gated
    hidden_dim: int = 512
    num_attention_heads: int = 8
    dropout: float = 0.3
    use_residual: bool = True
    image_proj_dim: int = 512
    text_proj_dim: int = 768


@dataclass(frozen=True)
class ClassifierConfig:
    hidden_dims: Tuple[int, ...] = (256, 128)
    num_classes: int = 10
    dropout: float = 0.5
    activation: str = "relu"  # relu | gelu | leaky_relu


@dataclass(frozen=True)
class TrainingConfig:
    batch_size: int = 8
    num_epochs: int = 50
    learning_rate: float = 5e-5
    weight_decay: float = 0.05

    optimizer: str = "adamw"  # adam | adamw | sgd
    scheduler: str = "cosine"  # cosine | warm_restarts | step | plateau | constant
    warmup_epochs: int = 5
    restart_period_epochs: int = 10
    restart_mult: int = 2

    label_smoothing: float = 0.1
    lr_decay_factor: float = 0.1
    lr_decay_epochs: Tuple[int, ...] = (30, 60, 90)
    plateau_patience: int = 5

    lr_mult_cnn: float = 1.0
    lr_mult_text: float = 1.0
    lr_mult_fusion: float = 1.0
    lr_mult_classifier: float = 1.0

    early_stopping: bool = True
    patience: int = 15
    min_delta: float = 1e-3
    best_metric: str = "val_loss"  # "val_loss" | "val_acc"

    save_best_only: bool = False
    save_checkpoints: bool = True
    checkpoint_every_epochs: int = 1
    checkpoint_dir: str = str(CHECKPOINTS_DIR)

    # bf16 compute over f32 parameters; the predictor casts the model to
    # compute_dtype once, at construction
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"

    gradient_clip_val: float = 1.0
    use_class_weights: bool = True
    device_corpus_budget_gb: float = 4.0
    nan_guard: bool = True
    debug_nans: bool = False
    profile_dir: str = ""
    profile_epoch: int = 1

    seed: int = 42
    log_every_steps: int = 10


@dataclass(frozen=True)
class EvaluationConfig:
    metrics: Tuple[str, ...] = (
        "accuracy",
        "precision",
        "recall",
        "f1",
        "confusion_matrix",
        "roc_auc",
    )
    per_class_metrics: bool = True
    save_predictions: bool = True
    results_dir: str = str(RESULTS_DIR)
    eval_batch_size: int = 16


@dataclass(frozen=True)
class ExplainabilityConfig:
    use_gradcam: bool = True
    gradcam_layer: str = "stage4"
    use_attention_viz: bool = True
    save_visualizations: bool = True
    num_samples_to_visualize: int = 10


@dataclass(frozen=True)
class MeshConfig:
    data_axis: int = -1
    model_axis: int = 1
    axis_names: Tuple[str, ...] = ("data", "model")
    allow_cpu_fallback: bool = True


@dataclass(frozen=True)
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    cnn_encoder: CNNEncoderConfig = field(default_factory=CNNEncoderConfig)
    text_encoder: TextEncoderConfig = field(default_factory=TextEncoderConfig)
    fusion: FusionConfig = field(default_factory=FusionConfig)
    classifier: ClassifierConfig = field(default_factory=ClassifierConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    evaluation: EvaluationConfig = field(default_factory=EvaluationConfig)
    explainability: ExplainabilityConfig = field(
        default_factory=ExplainabilityConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    syndrome_names: Tuple[str, ...] = SYNDROME_NAMES
    seed: int = 42

    @property
    def num_classes(self) -> int:
        return self.classifier.num_classes

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, default=str)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "Config":
        kwargs: Dict[str, Any] = {}
        for f in fields(cls):
            if f.name not in d:
                continue
            v = d[f.name]
            sub = _SECTIONS.get(f.name)
            if sub is not None and isinstance(v, Mapping):
                kwargs[f.name] = _dataclass_from_dict(sub, v)
            elif f.name == "syndrome_names":
                kwargs[f.name] = tuple(v)
            else:
                kwargs[f.name] = v
        return cls(**kwargs)


_SECTIONS: Dict[str, type] = {
    "data": DataConfig,
    "cnn_encoder": CNNEncoderConfig,
    "text_encoder": TextEncoderConfig,
    "fusion": FusionConfig,
    "classifier": ClassifierConfig,
    "training": TrainingConfig,
    "evaluation": EvaluationConfig,
    "explainability": ExplainabilityConfig,
    "mesh": MeshConfig,
}


def _dataclass_from_dict(cls: type, d: Mapping[str, Any]):
    kwargs = {}
    for f in fields(cls):
        if f.name in d:
            v = d[f.name]
            if isinstance(v, list):
                v = tuple(v)
            kwargs[f.name] = v
    return cls(**kwargs)


def _apply_overrides(cfg: Config, overrides: Mapping[str, Any]) -> Config:
    """Apply dotted-path overrides like {"training.learning_rate": 2e-5}."""
    for key, value in overrides.items():
        parts = key.split(".")
        if len(parts) == 1:
            if not hasattr(cfg, parts[0]):
                raise KeyError(f"Unknown config key: {key}")
            cfg = replace(cfg, **{parts[0]: value})
        elif len(parts) == 2:
            section_name, field_name = parts
            section = getattr(cfg, section_name)
            if not hasattr(section, field_name):
                raise KeyError(f"Unknown config key: {key}")
            if isinstance(value, list):
                value = tuple(value)
            cfg = replace(cfg, **{section_name: replace(
                section, **{field_name: value})})
        else:
            raise KeyError(f"Config keys nest at most one level: {key}")
    return cfg


# Named overlays over the single schema (the same presets as the JAX
# package's config).
MULTIMODAL_PRESET: Dict[str, Any] = {
    "data.max_text_length": 256,
    "data.augmentation_factor": 10,
    "text_encoder.max_length": 256,
    "text_encoder.freeze_layers": 6,
    "cnn_encoder.freeze_stages": 3,
    "training.batch_size": 8,
    "training.num_epochs": 60,
    "training.learning_rate": 2e-5,
    "training.lr_mult_cnn": 0.1,
    "training.lr_mult_text": 0.5,
    "training.scheduler": "warm_restarts",
    "training.best_metric": "val_acc",
    "training.label_smoothing": 0.1,
    "training.weight_decay": 0.01,
}

SMALL_DATA_PRESET: Dict[str, Any] = {
    "data.augmentation_factor": 20,
    "cnn_encoder.freeze_stages": 3,
    "cnn_encoder.dropout": 0.6,
    "classifier.dropout": 0.6,
    "training.batch_size": 8,
    "training.num_epochs": 50,
    "training.learning_rate": 1e-4,
    "training.label_smoothing": 0.12,
    "training.scheduler": "warm_restarts",
    "training.best_metric": "val_acc",
}

EFFICIENTNET_CLINICALBERT_PRESET: Dict[str, Any] = {
    **MULTIMODAL_PRESET,
    "cnn_encoder.backbone": "efficientnet_b0",
    "text_encoder.model_name": "emilyalsentzer/Bio_ClinicalBERT",
    "data.text_model_name": "emilyalsentzer/Bio_ClinicalBERT",
    "data.random_erasing_prob": 0.25,
    "data.gaussian_blur_prob": 0.2,
}

FROM_SCRATCH_PRESET: Dict[str, Any] = {
    "data.max_text_length": 128,
    "data.augmentation_factor": 10,
    "text_encoder.max_length": 128,
    "text_encoder.num_layers": 6,
    "training.batch_size": 16,
    "training.num_epochs": 60,
    "training.learning_rate": 3e-4,
    "training.warmup_epochs": 3,
    "training.scheduler": "cosine",
    "training.best_metric": "val_acc",
    "training.weight_decay": 0.01,
    "training.checkpoint_every_epochs": 20,
}

FROM_SCRATCH_FULLSIZE_PRESET: Dict[str, Any] = {
    "data.max_text_length": 128,
    "data.augmentation_factor": 10,
    "text_encoder.max_length": 128,
    "training.batch_size": 16,
    "training.num_epochs": 150,
    "training.learning_rate": 1e-5,
    "training.warmup_epochs": 3,
    "training.scheduler": "cosine",
    "training.early_stopping": False,
    "training.best_metric": "val_acc",
    "training.weight_decay": 0.01,
    "training.checkpoint_every_epochs": 25,
}

PRESETS: Dict[str, Dict[str, Any]] = {
    "default": {},
    "multimodal": MULTIMODAL_PRESET,
    "small_data": SMALL_DATA_PRESET,
    "efficientnet_clinicalbert": EFFICIENTNET_CLINICALBERT_PRESET,
    "from_scratch": FROM_SCRATCH_PRESET,
    "from_scratch_fullsize": FROM_SCRATCH_FULLSIZE_PRESET,
}


def resolve_config(
    preset: str = "default",
    overrides: Optional[Mapping[str, Any]] = None,
    **kw_overrides: Any,
) -> Config:
    """Defaults → preset overlay → explicit overrides (dotted paths with
    '.' or '__' separators)."""
    if preset not in PRESETS:
        raise KeyError(
            f"Unknown preset {preset!r}; available: {sorted(PRESETS)}")
    cfg = _apply_overrides(Config(), PRESETS[preset])
    merged: Dict[str, Any] = dict(overrides or {})
    for k, v in kw_overrides.items():
        merged[k.replace("__", ".")] = v
    return _apply_overrides(cfg, merged)


_default_config: Optional[Config] = None


def get_config() -> Config:
    """Default config instance (immutable; use resolve_config for runs)."""
    global _default_config
    if _default_config is None:
        _default_config = Config()
    return _default_config


def find_data_file(cfg: Config, relpath: str) -> Optional[Path]:
    """Resolve a data file against the configured search roots."""
    for root in cfg.data.data_dirs:
        p = Path(root) / relpath
        if p.exists():
            return p
    return None


def find_image_dir(cfg: Config) -> Optional[Path]:
    """First existing image directory across roots × preferred subdirs."""
    for sub in cfg.data.image_subdirs:
        for root in cfg.data.data_dirs:
            p = Path(root) / sub
            if p.is_dir():
                return p
    return None


def ensure_dirs(cfg: Config) -> None:
    os.makedirs(cfg.training.checkpoint_dir, exist_ok=True)
    os.makedirs(cfg.evaluation.results_dir, exist_ok=True)
