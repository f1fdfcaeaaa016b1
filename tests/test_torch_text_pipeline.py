"""The FGDD text pipelines of the torch package (train/text_pipeline.py
over data/parsers.py) against the JAX package's, on a synthetic FGDD
corpus (FGDD.csv with one-hot HP:* columns over ~10 diseases, and
Raw data/phenotype.csv) and a synthetic image corpus written under
tmp_path: `load_fgdd`, `TextDataPipeline` (split, class weights, every
batch), `fgdd_text_pipeline`, the FGDD → multimodal cycle pairing, the
Orphadata and HPO parsers, and `cli/train.py --data fgdd` on the CPU.
Texts, labels and token ids are held exactly."""

import json

import numpy as np
import pytest

from multimodal_rare_disease_tpu.config import resolve_config as jax_config
from multimodal_rare_disease_tpu.data import parsers as jparsers
from multimodal_rare_disease_tpu.train import text_pipeline as jtp
from multimodal_rare_disease_tpu_torch.cli import train as train_cli
from multimodal_rare_disease_tpu_torch.config import resolve_config
from multimodal_rare_disease_tpu_torch.data import parsers as tparsers
from multimodal_rare_disease_tpu_torch.data.synthetic import (
    generate_synthetic_for_training,
)
from multimodal_rare_disease_tpu_torch.train import text_pipeline as ttp
from multimodal_rare_disease_tpu_torch.utils.checkpoint import role_path

N_HP = 24
DISEASES = [f"Syndrome {c}" for c in "ABCDEFGHIJKL"]   # 12: top-10 cut


def write_fgdd(root, n=90, seed=0, nested=True, names=True):
    """A seeded FGDD corpus under `root`: FGDD.csv (patient_id,
    Disease_name, Disease_id and N_HP one-hot HP:* columns; diseases
    drawn with skewed frequencies) and Raw data/phenotype.csv. Returns
    the FGDD directory to pass as `fgdd_dir`."""
    rng = np.random.default_rng(seed)
    fgdd = root / "FGDD"
    csv_dir = fgdd / "FGDD" if nested else fgdd
    csv_dir.mkdir(parents=True, exist_ok=True)
    hp = [f"HP:{1000 + 7 * j:07d}" for j in range(N_HP)]
    weights = np.linspace(2.0, 0.5, len(DISEASES))
    lines = [",".join(["patient_id", "Disease_name", "Disease_id"] + hp)]
    for i in range(n):
        d = int(rng.choice(len(DISEASES), p=weights / weights.sum()))
        onehot = (rng.uniform(size=N_HP) < 0.25).astype(int)
        lines.append(",".join([str(100 + i), DISEASES[d], str(500 + d)]
                              + [str(v) for v in onehot]))
    (csv_dir / "FGDD.csv").write_text("\n".join(lines) + "\n")
    if names:
        raw = fgdd / "Raw data"
        raw.mkdir(exist_ok=True)
        rows = ["phenotype_id,phenotype_name,extra"] + [
            f"{h},Phenotype term {j},x" for j, h in enumerate(hp[:-3])]
        (raw / "phenotype.csv").write_text("\n".join(rows) + "\n")
    return fgdd


def cfg_pair(**over):
    over = {"data.max_text_length": 32, "training.batch_size": 4,
            "evaluation.eval_batch_size": 4, **over}
    return resolve_config("default", over), jax_config("default", over)


def test_load_fgdd_equals_jax(tmp_path):
    fgdd = write_fgdd(tmp_path)
    cfg, jcfg = cfg_pair()
    got = tparsers.load_fgdd(cfg, fgdd_dir=str(fgdd))
    want = jparsers.load_fgdd(jcfg, fgdd_dir=str(fgdd))
    assert got == want
    assert len(got["disease_names"]) == 10 and len(got["texts"]) > 60
    assert any(t.startswith("Patient presents with: Phenotype term")
               for t in got["texts"])
    # the top-3 cut, and the layout without the nested FGDD/ directory
    flat = write_fgdd(tmp_path / "flat", nested=False, names=False)
    for k in (3, 10):
        assert tparsers.load_fgdd(cfg, str(flat), k) == \
            jparsers.load_fgdd(jcfg, str(flat), k)
    assert tparsers.load_fgdd(cfg, str(tmp_path / "absent")) is None


def _batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("weighted", [True, False])
def test_fgdd_text_pipeline_equals_jax(tmp_path, weighted):
    fgdd = write_fgdd(tmp_path, seed=1)
    cfg, jcfg = cfg_pair(**{"data.use_weighted_sampling": weighted})
    got = ttp.fgdd_text_pipeline(cfg, fgdd_dir=str(fgdd))
    want = jtp.fgdd_text_pipeline(jcfg, fgdd_dir=str(fgdd))
    assert got.tokenizer.vocab == want.tokenizer.vocab
    assert got.class_names == want.class_names
    np.testing.assert_array_equal(got.train_idx, want.train_idx)
    np.testing.assert_array_equal(got.val_idx, want.val_idx)
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.class_weights, want.class_weights)
    assert got.steps_per_epoch == want.steps_per_epoch
    for _ in range(2):                       # two epochs of sampler draws
        _batches_equal(got.train_batches(), want.train_batches())
    _batches_equal(got.val_batches(), want.val_batches())
    _batches_equal(got.val_batches(3), want.val_batches(3))


def test_text_data_pipeline_over_given_texts_equals_jax():
    texts = [f"Patient presents with: finding {i % 7} and sign {i % 3}."
             for i in range(40)]
    labels = [i % 5 for i in range(40)]
    cfg, jcfg = cfg_pair(**{"data.augmentation_factor": 2})
    got = ttp.TextDataPipeline(cfg, texts, labels, val_fraction=0.25)
    want = jtp.TextDataPipeline(jcfg, texts, labels, val_fraction=0.25)
    assert len(got.val_samples) == len(want.val_samples) == 10
    _batches_equal(got.train_batches(), want.train_batches())
    _batches_equal(got.val_batches(), want.val_batches())


def _image_corpus(tmp_path):
    d = tmp_path / "images"
    generate_synthetic_for_training(d, num_per_class=3, image_size=32)
    from multimodal_rare_disease_tpu_torch.data.images import (
        scan_image_corpus,
    )
    return d, list(scan_image_corpus(d))


def test_fgdd_multimodal_pairing_equals_jax(tmp_path):
    fgdd = write_fgdd(tmp_path, n=25, seed=2)
    image_dir, _ = _image_corpus(tmp_path)
    cfg, jcfg = cfg_pair()
    got = ttp.fgdd_multimodal_pipeline(cfg, fgdd_dir=str(fgdd),
                                       image_dir=str(image_dir))
    want = jtp.fgdd_multimodal_pipeline(jcfg, fgdd_dir=str(fgdd),
                                        image_dir=str(image_dir))
    assert got.fgdd_n_texts == want.fgdd_n_texts
    np.testing.assert_array_equal(got.text_pool.ids, want.text_pool.ids)
    np.testing.assert_array_equal(got._train_tidx, want._train_tidx)
    np.testing.assert_array_equal(got._val_tidx, want._val_tidx)
    _batches_equal(got.train_batches(), want.train_batches())
    _batches_equal(got.val_batches(), want.val_batches())
    _batches_equal(got.train_index_batches(), want.train_index_batches())
    # the pairing: a sample's text is the FGDD text at its scan position
    # mod the number of texts, whatever its label
    b = next(got.val_batches())
    rows = np.arange(len(b["labels"]))
    ids = got.text_pool.ids[0, 0, got._val_tidx[rows]]
    np.testing.assert_array_equal(b["input_ids"], ids)


def test_orphadata_and_hpo_parsers_equal_jax(tmp_path):
    diseases = tmp_path / "d.xml"
    diseases.write_text(
        "<JDBOR><DisorderList>"
        "<Disorder><OrphaCode>904</OrphaCode><Name>Williams syndrome</Name>"
        "<SummaryInformation><Definition>A rare disorder.</Definition>"
        "</SummaryInformation></Disorder>"
        "<Disorder><OrphaCode>567</OrphaCode>"
        "<Name>22q11.2 deletion syndrome</Name></Disorder>"
        "<Disorder><OrphaCode>1</OrphaCode></Disorder>"
        "</DisorderList></JDBOR>")
    phen = tmp_path / "p.xml"
    phen.write_text(
        "<JDBOR><Disorder><OrphaCode>904</OrphaCode>"
        + "".join(f"<HPODisorderAssociation><HPO><HPOId>HP:{i:07d}</HPOId>"
                  f"<HPOTerm>Term {i}</HPOTerm></HPO>"
                  "</HPODisorderAssociation>" for i in range(12))
        + "</Disorder></JDBOR>")
    genes = tmp_path / "g.xml"
    genes.write_text(
        "<JDBOR><Disorder><OrphaCode>904</OrphaCode>"
        + "".join(f"<DisorderGeneAssociation><Gene><Symbol>G{i}</Symbol>"
                  f"<Name>gene {i}</Name></Gene></DisorderGeneAssociation>"
                  for i in range(7))
        + "</Disorder></JDBOR>")
    bad = tmp_path / "bad.xml"
    bad.write_text("<not xml")
    args = (str(diseases), str(phen), str(genes))
    a, b = tparsers.OrphadataParser(*args), jparsers.OrphadataParser(*args)
    assert (a.diseases, a.phenotypes, a.genes) == \
        (b.diseases, b.phenotypes, b.genes)
    assert a.get_all_narratives() == b.get_all_narratives()
    assert "Associated genes: G0, G1, G2, G3, G4." in \
        a.get_disease_narrative("904")
    for q in ("williams", "22Q11.2 deletion syndrome extra", "none"):
        assert a.find_disease_by_name(q) == b.find_disease_by_name(q)
    for args in ((str(bad), str(tmp_path / "missing.xml"), None),):
        assert tparsers.OrphadataParser(*args).diseases == \
            jparsers.OrphadataParser(*args).diseases == {}

    obo = tmp_path / "hp.obo"
    obo.write_text(
        "format-version: 1.2\n\n[Term]\nid: HP:0000001\nname: All\n\n"
        "[Term]\nid: HP:0000118\nname: Phenotypic abnormality\n"
        'def: "A phenotypic abnormality." [HPO:probinson]\n'
        "is_a: HP:0000001 ! All\n\n[Typedef]\nid: part_of\nname: part\n")
    hpoa = tmp_path / "phenotype.hpoa"
    hpoa.write_text("#description\nOMIM:1\tX\t\tHP:0000118\n"
                    "OMIM:1\tX\t\tHP:0000001\nOMIM:2\tY\nbad line\n")
    a = tparsers.HPOParser(str(obo), str(hpoa))
    b = jparsers.HPOParser(str(obo), str(hpoa))
    assert {k: vars(v) for k, v in a.terms.items()} == \
        {k: vars(v) for k, v in b.terms.items()}
    assert a.annotations == b.annotations
    assert a.terms["HP:0000118"].parents == ["HP:0000001"]
    for ids in (["HP:0000118", "HP:9"], []):
        assert a.generate_phenotype_text(ids) == \
            b.generate_phenotype_text(ids)

    cfg, jcfg = cfg_pair()
    orpha = tparsers.OrphadataParser(*map(str, (diseases, phen, genes)))
    jorpha = jparsers.OrphadataParser(*map(str, (diseases, phen, genes)))
    got = tparsers.create_syndrome_text_mapping(cfg, orpha)
    assert got == jparsers.create_syndrome_text_mapping(jcfg, jorpha)
    # the substring match: "22q11.2 deletion syndrome" is in the name
    assert got["22q11.2 Deletion Syndrome"].startswith(
        "Patient diagnosed with 22q11.2 deletion syndrome.")


SMALL = ["--set", "text_encoder.num_layers=2", "--set",
         "text_encoder.num_heads=2", "--set", "text_encoder.hidden_size=32",
         "--set", "text_encoder.intermediate_size=64", "--set",
         "data.max_text_length=32", "--set", "text_encoder.max_length=32",
         "--set", "training.compute_dtype='float32'", "--set",
         "training.batch_size=8", "--set", "training.warmup_epochs=0"]


def test_train_cli_trains_on_fgdd_text_only(tmp_path, capsys):
    write_fgdd(tmp_path / "root", n=60, seed=3)
    args = ["--data", "fgdd", "--mode", "text_only", "--device", "cpu",
            "--epochs", "2", "--checkpoint-dir", str(tmp_path / "ck"),
            "--set", f"data.data_dirs=[{str(tmp_path / 'root')!r}]"] + SMALL
    assert train_cli.main(args) == 0
    out = capsys.readouterr().out
    summary = json.loads(out[out.index("{"):])
    assert summary["mode"] == "text_only" and summary["epochs_run"] == 2
    assert np.isfinite(summary["final_train_loss"])
    meta = json.loads((role_path(tmp_path / "ck", "text_only", "last")
                       / "meta.json").read_text())
    assert meta["class_names"] == jparsers.load_fgdd(
        jax_config("default"), str(tmp_path / "root" / "FGDD"))[
        "disease_names"]


def test_train_cli_trains_on_fgdd_multimodal_and_refuses_image_only(
        tmp_path, capsys):
    write_fgdd(tmp_path / "root", n=20, seed=4)
    image_dir, _ = _image_corpus(tmp_path)
    common = ["--data", "fgdd", "--device", "cpu", "--epochs", "1",
              "--checkpoint-dir", str(tmp_path / "ck"),
              "--set", f"data.data_dirs=[{str(tmp_path / 'root')!r}]",
              "--image-dir", str(image_dir)] + SMALL + [
        "--set", "data.image_size=32", "--set",
        "cnn_encoder.stage_sizes=(1, 1, 1, 1)", "--set",
        "cnn_encoder.embedding_dim=32", "--set", "fusion.hidden_dim=32",
        "--set", "fusion.text_proj_dim=32", "--set",
        "data.augmentation_factor=1"]
    assert train_cli.main(["--mode", "multimodal"] + common) == 0
    out = capsys.readouterr().out
    assert "cycles unrelated texts" in out
    summary = json.loads(out[out.index("{"):])
    assert summary["mode"] == "multimodal" and summary["epochs_run"] == 1
    with pytest.raises(SystemExit):
        train_cli.main(["--mode", "image_only"] + common)
