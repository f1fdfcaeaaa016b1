"""Corpus parsers: Orphadata XML, HPO OBO/HPOA, FGDD patient tables. The
torch package's own copy of `multimodal_rare_disease_tpu/data/parsers.py`
(the Orphadata and HPO parsers and the syndrome → narrative mapping
line for line), giving the same dicts, texts and labels for the same
files.

`load_fgdd` reads the tables with the standard `csv` module, where the
JAX package uses pandas (the card's machine has no pandas). The pandas
semantics that the result depends on are made explicit (`_Column`):

- a cell that pandas reads as missing (empty, "NA", "nan", ...) is
  dropped from the disease counts and stringifies as "nan";
- each column is typed as pandas types it over the whole file: int,
  float (numbers with a gap or a decimal point) or text; a number
  stringifies as pandas prints it ("12", or "12.0" in a float column),
  and in a row of a table whose every column is numeric and one of
  them float, every number prints as a float (the row `iterrows`
  gives);
- a one-hot cell is "present" when it equals 1 in a numeric column
  (1 or 1.0), or is the text "1" in a text column;
- a phenotype name that pandas would read as missing maps to "nan".
"""

from __future__ import annotations

import csv
import logging
import re
import xml.etree.ElementTree as ET
from collections import Counter
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from multimodal_rare_disease_tpu_torch.config import (
    SYNDROME_NAMES,
    Config,
    find_data_file,
)

log = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Orphadata
# ---------------------------------------------------------------------------

class OrphadataParser:
    """Orphadata XML → disease/phenotype/gene dicts + clinical narratives.

    Narrative format (identical information layout to ref :188-232):
    "Patient diagnosed with <name>. <definition> Clinical features
    include: <top-10 HPO terms>. Associated genes: <top-5 symbols>."
    """

    def __init__(self, diseases_file, phenotypes_file, genes_file=None):
        self.diseases: Dict[str, Dict] = {}
        self.phenotypes: Dict[str, List[Dict]] = {}
        self.genes: Dict[str, List[Dict]] = {}

        for path, fn in ((diseases_file, self._parse_diseases),
                         (phenotypes_file, self._parse_phenotypes),
                         (genes_file, self._parse_genes)):
            if path is None:
                continue
            p = Path(path)
            if not p.exists():
                log.warning("Orphadata file not found: %s", p)
                continue
            try:
                fn(p)
            except Exception as e:  # noqa: BLE001
                log.warning("failed to parse %s: %s", p, e)

    def _parse_diseases(self, path: Path) -> None:
        root = ET.parse(path).getroot()
        for disorder in root.iter("Disorder"):
            code = _text(disorder, ".//OrphaCode")
            name = _text(disorder, ".//Name")
            definition = ""
            summary = disorder.find(".//SummaryInformation")
            if summary is not None:
                definition = _text(summary, ".//Definition") or ""
            if code and name:
                self.diseases[code] = {"name": name, "definition": definition,
                                       "phenotypes": [], "genes": []}
        log.info("parsed %d Orphadata diseases", len(self.diseases))

    def _parse_phenotypes(self, path: Path) -> None:
        root = ET.parse(path).getroot()
        for disorder in root.iter("Disorder"):
            code = _text(disorder, ".//OrphaCode")
            if not code:
                continue
            plist = []
            for assoc in disorder.iter("HPODisorderAssociation"):
                hpo = assoc.find(".//HPO")
                if hpo is not None:
                    hid = _text(hpo, ".//HPOId")
                    term = _text(hpo, ".//HPOTerm")
                    if hid and term:
                        plist.append({"hpo_id": hid, "term": term})
            self.phenotypes[code] = plist
        log.info("parsed phenotypes for %d diseases", len(self.phenotypes))

    def _parse_genes(self, path: Path) -> None:
        root = ET.parse(path).getroot()
        for disorder in root.iter("Disorder"):
            code = _text(disorder, ".//OrphaCode")
            if not code:
                continue
            glist = []
            for assoc in disorder.iter("DisorderGeneAssociation"):
                gene = assoc.find(".//Gene")
                if gene is not None:
                    sym = _text(gene, ".//Symbol")
                    gname = _text(gene, ".//Name") or ""
                    if sym:
                        glist.append({"symbol": sym, "name": gname})
            self.genes[code] = glist
        log.info("parsed genes for %d diseases", len(self.genes))

    def get_disease_narrative(self, orpha_code: str) -> str:
        if orpha_code not in self.diseases:
            return ""
        d = self.diseases[orpha_code]
        parts = [f"Patient diagnosed with {d['name']}."]
        if d["definition"]:
            parts.append(d["definition"])
        phen = self.phenotypes.get(orpha_code, [])
        if phen:
            terms = [p["term"] for p in phen[:10]]
            parts.append(f"Clinical features include: {', '.join(terms)}.")
        genes = self.genes.get(orpha_code, [])
        if genes:
            syms = [g["symbol"] for g in genes[:5]]
            parts.append(f"Associated genes: {', '.join(syms)}.")
        return " ".join(parts)

    def get_all_narratives(self) -> Dict[str, str]:
        return {c: self.get_disease_narrative(c) for c in self.diseases}

    def find_disease_by_name(self, query: str) -> Optional[str]:
        """Case-insensitive substring match → orpha code."""
        q = query.lower()
        for code, d in self.diseases.items():
            name = d["name"].lower()
            if q in name or name in q:
                return code
        return None


def _text(elem, xpath: str) -> Optional[str]:
    e = elem.find(xpath)
    return e.text if e is not None else None


# ---------------------------------------------------------------------------
# HPO
# ---------------------------------------------------------------------------

@dataclass
class HPOTerm:
    term_id: str
    name: str = ""
    definition: str = ""
    parents: List[str] = field(default_factory=list)


class HPOParser:
    """hp.obo term stanzas + phenotype.hpoa annotations (ref :235-351)."""

    def __init__(self, obo_file=None, annotations_file=None):
        self.terms: Dict[str, HPOTerm] = {}
        self.annotations: Dict[str, List[str]] = {}  # disease_id → hpo ids
        if obo_file and Path(obo_file).exists():
            self._parse_obo(Path(obo_file))
        elif obo_file:
            log.warning("HPO obo not found: %s", obo_file)
        if annotations_file and Path(annotations_file).exists():
            self._parse_hpoa(Path(annotations_file))
        elif annotations_file:
            log.warning("HPO annotations not found: %s", annotations_file)

    def _parse_obo(self, path: Path) -> None:
        current: Optional[HPOTerm] = None
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line == "[Term]":
                    current = None
                elif line.startswith("id: HP:"):
                    current = HPOTerm(term_id=line[4:])
                    self.terms[current.term_id] = current
                elif current is not None:
                    if line.startswith("name: "):
                        current.name = line[6:]
                    elif line.startswith("def: "):
                        m = re.match(r'def: "(.*)" \[', line)
                        current.definition = m.group(1) if m else line[5:]
                    elif line.startswith("is_a: "):
                        current.parents.append(line[6:].split(" !")[0].strip())
        log.info("parsed %d HPO terms", len(self.terms))

    def _parse_hpoa(self, path: Path) -> None:
        with open(path, encoding="utf-8") as f:
            for line in f:
                if line.startswith("#") or not line.strip():
                    continue
                fields = line.rstrip("\n").split("\t")
                if len(fields) < 4:
                    continue
                disease_id, hpo_id = fields[0], fields[3]
                if hpo_id.startswith("HP:"):
                    self.annotations.setdefault(disease_id, []).append(hpo_id)
        log.info("parsed annotations for %d diseases", len(self.annotations))

    def get_term_name(self, hpo_id: str) -> str:
        t = self.terms.get(hpo_id)
        return t.name if t else hpo_id

    def generate_phenotype_text(self, hpo_ids: List[str],
                                max_terms: int = 15) -> str:
        """HPO ids → "Patient presents with: ..." narrative (ref :332-351)."""
        names = [self.get_term_name(h) for h in hpo_ids[:max_terms]]
        names = [n for n in names if n]
        if not names:
            return "No phenotypic information available."
        return f"Patient presents with: {', '.join(names)}."


# ---------------------------------------------------------------------------
# FGDD patient tables
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# FGDD patient tables, without pandas
# ---------------------------------------------------------------------------

# the cells pandas.read_csv reads as missing by default
_NA_VALUES = frozenset((
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"))
_INT_RE = re.compile(r"[+-]?\d+")
_FLOAT_RE = re.compile(r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?"
                       r"|[+-]?(inf|Inf|INF|infinity|Infinity)")


class _Column:
    """One column of a table as pandas types it: 'int', 'float' or
    'str', from every cell of the column."""

    def __init__(self, cells: Sequence[str]):
        present = [c for c in cells if c not in _NA_VALUES]
        if present and all(_INT_RE.fullmatch(c) for c in present) \
                and len(present) == len(cells):
            self.kind = "int"
        elif all(_FLOAT_RE.fullmatch(c) for c in present):
            self.kind = "float"      # an empty or all-missing column too
        else:
            self.kind = "str"
        self.cells = cells

    def missing(self, i: int) -> bool:
        return self.cells[i] in _NA_VALUES

    def text(self, i: int, as_float: bool = False) -> str:
        """The cell as `str()` of the value pandas holds for it."""
        c = self.cells[i]
        if self.missing(i):
            return "nan"
        if self.kind == "int" and not as_float:
            return str(int(c))
        if self.kind in ("int", "float"):
            return str(float(c))
        return c

    def is_one(self, i: int) -> bool:
        """pandas' `v == 1 or v == "1"` on the cell's value."""
        if self.kind == "str":
            return self.cells[i] == "1"
        return not self.missing(i) and float(self.cells[i]) == 1.0


def _read_table(path: Path, usecols: Optional[int] = None):
    """header, {column name: _Column} of a CSV file."""
    with open(path, newline="", encoding="utf-8") as f:
        rows = list(csv.reader(f))
    header = rows[0][:usecols] if usecols else rows[0]
    body = [r + [""] * (len(header) - len(r)) for r in rows[1:] if r]
    cols = {h: _Column([r[j] for r in body]) for j, h in enumerate(header)}
    return header, cols, len(body)


def load_fgdd(
    cfg: Config,
    fgdd_dir: Optional[str] = None,
    top_k_diseases: int = 10,
) -> Optional[Dict]:
    """FGDD.csv (one-hot HP:* phenotype columns) + phenotype.csv names →
    per-patient clinical texts and labels over the top-K most frequent
    diseases (semantics of `src/train.py:628-710`).

    Returns {texts, labels, disease_names, patient_ids} or None when the
    corpus is absent.
    """
    root = Path(fgdd_dir) if fgdd_dir else find_data_file(cfg, cfg.data.fgdd_dir)
    if root is None or not Path(root).exists():
        log.warning("FGDD corpus not found")
        return None
    root = Path(root)

    fgdd_csv = None
    for cand in (root / "FGDD" / "FGDD.csv", root / "FGDD.csv"):
        if cand.exists():
            fgdd_csv = cand
            break
    if fgdd_csv is None:
        log.warning("FGDD.csv not found under %s", root)
        return None

    header, cols, n_rows = _read_table(fgdd_csv)

    # phenotype id → human-readable name
    name_map: Dict[str, str] = {}
    phen_csv = root / "Raw data" / "phenotype.csv"
    if phen_csv.exists():
        p_header, p_cols, p_rows = _read_table(phen_csv, usecols=2)
        pid, name = (p_cols[h] for h in p_header[:2])
        name_map = {pid.text(i): name.text(i) for i in range(p_rows)}

    hp_cols = [c for c in header if c.startswith("HP:")]

    disease_col = next((c for c in ("Disease_name", "Disease_id", "disease")
                        if c in cols), None)
    if disease_col is None:
        log.warning("no disease column in FGDD.csv; labeling unavailable")
        return None

    dis = cols[disease_col]
    counts = Counter(dis.text(i) for i in range(n_rows) if not dis.missing(i))
    top = [d for d, _ in counts.most_common(top_k_diseases)]
    disease_to_label = {d: i for i, d in enumerate(top)}

    # a row of an all-numeric table with a float column holds floats only
    kinds = {c.kind for c in cols.values()}
    row_float = kinds <= {"int", "float"} and "float" in kinds
    pid_col = cols.get("patient_id")

    texts: List[str] = []
    labels: List[int] = []
    patient_ids: List[str] = []
    for row_idx in range(n_rows):
        disease = dis.text(row_idx, as_float=row_float)
        if disease not in disease_to_label:
            continue
        present = [h for h in hp_cols if cols[h].is_one(row_idx)]
        names = [name_map.get(h, h) for h in present[:15]]
        if names:
            text = f"Patient presents with: {', '.join(names)}."
        else:
            text = "No phenotypic information available."
        texts.append(text)
        labels.append(disease_to_label[disease])
        patient_ids.append(pid_col.text(row_idx, as_float=row_float)
                           if pid_col is not None else str(row_idx))

    log.info("FGDD: %d patients over top-%d diseases", len(texts), len(top))
    return {"texts": texts, "labels": labels, "disease_names": top,
            "patient_ids": patient_ids}


# ---------------------------------------------------------------------------
# syndrome → narrative mapping
# ---------------------------------------------------------------------------

def create_syndrome_text_mapping(
    cfg: Config,
    orphadata: Optional[OrphadataParser] = None,
) -> Dict[str, str]:
    """Map each of the 10 syndromes to a clinical narrative: Orphadata
    substring match when available, else the clinical-descriptions JSON,
    else a fallback template (ref :497-537)."""
    from multimodal_rare_disease_tpu_torch.data.clinical_text import (
        load_clinical_descriptions,
    )

    if orphadata is None:
        orphadata = OrphadataParser(
            find_data_file(cfg, cfg.data.orphadata_diseases),
            find_data_file(cfg, cfg.data.orphadata_phenotypes),
            find_data_file(cfg, cfg.data.orphadata_genes),
        )
    descriptions = load_clinical_descriptions(cfg)

    mapping: Dict[str, str] = {}
    for name in SYNDROME_NAMES:
        code = orphadata.find_disease_by_name(name) if orphadata.diseases \
            else None
        if code:
            mapping[name] = orphadata.get_disease_narrative(code)
        elif name in descriptions:
            mapping[name] = descriptions[name]["clinical_description"]
        else:
            mapping[name] = (f"Patient presents with features consistent "
                             f"with {name}.")
    return mapping
