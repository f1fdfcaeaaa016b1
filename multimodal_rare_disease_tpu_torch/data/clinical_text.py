"""Clinical text assets: the torch package's own copy of the JAX
package's `data/clinical_text.py`.

- `load_clinical_descriptions`: `syndrome_clinical_descriptions.json`
  from the data roots, else the built-in descriptions below;
- `ClinicalTextAugmenter`: 4 template levels driven by an explicit numpy
  Generator;
- `default_tokenizer_corpus`: the texts the default WordPiece vocab is
  built from when no corpus is present.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from multimodal_rare_disease_tpu_torch.config import Config, find_data_file

# Minimal built-in fallback descriptions (framework-authored summaries of
# well-known phenotypes; used only when no descriptions JSON is present).
_BUILTIN_FEATURES: Dict[str, List[str]] = {
    "Cornelia de Lange Syndrome": [
        "synophrys", "long eyelashes", "thin downturned lips", "long philtrum",
        "low-set ears", "small upturned nose", "micrognathia", "hirsutism",
    ],
    "Williams-Beuren Syndrome": [
        "periorbital fullness", "stellate iris pattern", "short nose",
        "full nasal tip", "wide mouth", "full lips", "small chin",
    ],
    "Noonan Syndrome": [
        "hypertelorism", "downslanting palpebral fissures", "ptosis",
        "low-set posteriorly rotated ears", "short webbed neck",
        "deeply grooved philtrum",
    ],
    "Kabuki Syndrome": [
        "long palpebral fissures", "eversion of lower eyelids",
        "arched eyebrows", "broad depressed nasal tip", "large prominent ears",
    ],
    "KBG Syndrome": [
        "macrodontia of upper central incisors", "triangular face",
        "brachycephaly", "wide eyebrows", "prominent nasal bridge",
        "thin upper lip",
    ],
    "Angelman Syndrome": [
        "microcephaly", "wide smiling mouth", "widely spaced teeth",
        "prominent chin", "deep-set eyes", "frequent laughter",
    ],
    "Rubinstein-Taybi Syndrome": [
        "downslanting palpebral fissures", "beaked nose",
        "columella below the nares", "grimacing smile", "highly arched eyebrows",
        "broad thumbs",
    ],
    "Smith-Magenis Syndrome": [
        "broad square face", "deep-set eyes", "midface hypoplasia",
        "tented upper lip", "everted upper lip", "prognathism with age",
    ],
    "Nicolaides-Baraitser Syndrome": [
        "sparse hair", "coarse facial features", "thick anteverted alae nasi",
        "long philtrum", "wide mouth", "prominent interphalangeal joints",
    ],
    "22q11.2 Deletion Syndrome": [
        "long face", "malar flatness", "hooded eyelids", "bulbous nasal tip",
        "small low-set ears", "asymmetric crying facies",
    ],
}


def _builtin_descriptions() -> Dict[str, Dict]:
    out = {}
    for name, feats in _BUILTIN_FEATURES.items():
        out[name] = {
            "clinical_description": (
                f"{name} is a rare genetic disorder with a recognizable facial "
                f"gestalt. Characteristic features include {', '.join(feats[:4])}, "
                f"together with {', '.join(feats[4:])}. Patients typically show "
                f"developmental differences requiring multidisciplinary care."
            ),
            "hpo_terms": [],
            "key_facial_features": list(feats),
        }
    return out


def load_clinical_descriptions(
    cfg: Config, path: Optional[str] = None
) -> Dict[str, Dict]:
    """Load the descriptions JSON from an explicit path or the data roots,
    falling back to built-ins (warn-and-continue, matching the reference's
    graceful-degradation stance)."""
    p = Path(path) if path else find_data_file(cfg, cfg.data.clinical_descriptions)
    if p is not None and Path(p).exists():
        with open(p, encoding="utf-8") as f:
            return json.load(f)
    return _builtin_descriptions()


class ClinicalTextAugmenter:
    """Template-based clinical text augmentation (4 levels).

    Level 0: full clinical description.
    Level 1: facial-feature focus (sample ≤5 features).
    Level 2: medical-report style (sample ≤6 features, split 3/3).
    Level 3+: random template over 3..7 sampled features.
    """

    def __init__(self, descriptions: Dict[str, Dict],
                 rng: Optional[np.random.Generator] = None):
        self.descriptions = descriptions
        self.rng = rng if rng is not None else np.random.default_rng(0)

    def _sample(self, items: List[str], k: int) -> List[str]:
        k = min(k, len(items))
        idx = self.rng.choice(len(items), size=k, replace=False)
        return [items[i] for i in idx]

    def augment(self, syndrome_name: str, augment_level: int = 0) -> str:
        if syndrome_name not in self.descriptions:
            return f"Patient presents with features consistent with {syndrome_name}."
        info = self.descriptions[syndrome_name]
        full = info.get("clinical_description", "")
        feats = list(info.get("key_facial_features", []))

        if augment_level == 0 or not feats:
            return full

        if augment_level == 1:
            sel = self._sample(feats, 5)
            return (
                f"Facial dysmorphism assessment reveals: {', '.join(sel)}. "
                f"Clinical presentation consistent with {syndrome_name}."
            )

        if augment_level == 2:
            sel = self._sample(feats, 6)
            return (
                f"Physical examination findings: The patient demonstrates "
                f"characteristic facial features including {', '.join(sel[:3])}. "
                f"Additional findings include {', '.join(sel[3:])}. "
                f"Differential diagnosis includes {syndrome_name}."
            )

        k = int(self.rng.integers(3, min(7, len(feats)) + 1))
        sel = self._sample(feats, k)
        templates = [
            f"Key phenotypic features observed: {', '.join(sel)}.",
            f"Craniofacial examination shows: {'; '.join(sel)}.",
            f"Notable dysmorphic features: {', '.join(sel)}. "
            f"Pattern suggests {syndrome_name}.",
        ]
        return templates[int(self.rng.integers(0, len(templates)))]

    def random_level(self, max_level: int = 3) -> int:
        return int(self.rng.integers(0, max_level + 1))


def default_tokenizer_corpus(cfg: Config) -> List[str]:
    """Corpus for hermetic vocab construction: all clinical descriptions,
    every augmentation template output shape, syndrome names, and generic
    clinical filler so unseen report text still tokenizes into subwords."""
    desc = load_clinical_descriptions(cfg)
    texts: List[str] = []
    for name, info in desc.items():
        texts.append(name)
        texts.append(info.get("clinical_description", ""))
        feats = info.get("key_facial_features", [])
        texts.append(", ".join(feats))
        texts.append("; ".join(feats))
        for t in info.get("hpo_terms", []):
            texts.append(t)
    texts.extend(
        [
            "Patient presents with features consistent with the syndrome.",
            "Facial dysmorphism assessment reveals clinical presentation.",
            "Physical examination findings: the patient demonstrates "
            "characteristic facial features. Additional findings include "
            "differential diagnosis.",
            "Key phenotypic features observed. Craniofacial examination shows "
            "notable dysmorphic features. Pattern suggests diagnosis.",
            "Patient diagnosed with rare genetic disorder. Clinical features "
            "include: developmental delay, intellectual disability, seizures, "
            "hypotonia, short stature, microcephaly, hypertelorism. "
            "Associated genes: variant, deletion, duplication, mutation.",
        ]
    )
    return [t for t in texts if t]
