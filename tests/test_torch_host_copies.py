"""The torch package's own copies of the JAX package's host modules
(config, tokenizer with its C++ core, clinical text, the image corpus
code, the host RNG streams, the statistics, the LR schedules and early
stopping, the freeze rules, the synthetic corpus) against the
originals, the corpus parsers (`load_fgdd` read without pandas, case by
case where pandas' semantics matter) and the text pipeline's module,
and a scan of the port's imports: no module of the port, and not
chip_smoke.py, imports jax, the JAX package, sklearn or pandas."""

import ast
from pathlib import Path

import numpy as np
import pytest

from multimodal_rare_disease_tpu import config as jcfg
from multimodal_rare_disease_tpu.data import clinical_text as jtext
from multimodal_rare_disease_tpu.data import images as jimages
from multimodal_rare_disease_tpu.data import synthetic as jsynth
from multimodal_rare_disease_tpu.data import tokenizer as jtok
from multimodal_rare_disease_tpu.evaluation import stats as jstats
from multimodal_rare_disease_tpu.train import freeze as jfreeze
from multimodal_rare_disease_tpu.train import schedules as jsched
from multimodal_rare_disease_tpu.utils import rng as jrng
from multimodal_rare_disease_tpu_torch import config as tcfg
from multimodal_rare_disease_tpu_torch.data import clinical_text as ttext
from multimodal_rare_disease_tpu_torch.data import images as timages
from multimodal_rare_disease_tpu_torch.data import synthetic as tsynth
from multimodal_rare_disease_tpu_torch.data import tokenizer as ttok
from multimodal_rare_disease_tpu_torch.evaluation import stats as tstats
from multimodal_rare_disease_tpu_torch.train import freeze as tfreeze
from multimodal_rare_disease_tpu_torch.train import schedules as tsched
from multimodal_rare_disease_tpu_torch.utils import rng as trng

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "multimodal_rare_disease_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "multimodal_rare_disease_tpu", "sklearn", "pandas")


@pytest.mark.parametrize("preset", sorted(jcfg.PRESETS))
def test_resolve_config_equals_jax_for_every_preset(preset):
    assert sorted(tcfg.PRESETS) == sorted(jcfg.PRESETS)
    got = tcfg.resolve_config(preset).to_dict()
    want = jcfg.resolve_config(preset).to_dict()
    # the one difference: the port searches the repository's data/ only,
    # without the JAX package's absolute fallback corpus directory
    got_dirs = got["data"].pop("data_dirs")
    want_dirs = want["data"].pop("data_dirs")
    assert got_dirs == want_dirs[:1] == (str(REPO / "data"),)
    assert got == want


def test_config_round_trips_and_overrides_like_jax():
    over = {"text_encoder.fused_attn_out": True, "data.image_size": 256,
            "classifier.hidden_dims": [64]}
    a = tcfg.resolve_config("multimodal", over, training__batch_size=4)
    b = jcfg.resolve_config("multimodal", over, training__batch_size=4)
    assert a.text_encoder == tcfg.TextEncoderConfig(
        **vars(b.text_encoder))
    assert tcfg.Config.from_dict(b.to_dict()).to_dict() == b.to_dict()
    assert tcfg.Config.from_dict(a.to_dict()) == a
    assert tcfg.SYNDROME_NAMES == jcfg.SYNDROME_NAMES
    with pytest.raises(KeyError):
        tcfg.resolve_config("default", {"text_encoder.no_such_knob": 1})


def _texts():
    descs = ttext._builtin_descriptions()
    assert descs == jtext._builtin_descriptions()
    aug = ttext.ClinicalTextAugmenter(descs, rng=np.random.default_rng(0))
    jaug = jtext.ClinicalTextAugmenter(descs, rng=np.random.default_rng(0))
    augmented = [aug.augment(n, lvl) for n in tcfg.SYNDROME_NAMES
                 for lvl in range(4)]
    assert augmented == [jaug.augment(n, lvl) for n in jcfg.SYNDROME_NAMES
                         for lvl in range(4)]
    return ([d["clinical_description"] for d in descs.values()] + augmented
            + ["", "   ", "Hypertelorism; ptosis (bilateral)!? -- 22q11.2",
               "a\tb\nc\rd", "x" * 150,
               "naïve café — résumé", "東京 clinic", "ß NBSP​"])


@pytest.mark.parametrize("max_length", [16, 128])
def test_tokenizer_ids_and_masks_equal_jax(max_length):
    tok, jt = ttok.get_tokenizer(), jtok.get_tokenizer()
    assert tok.vocab == jt.vocab
    assert ttext.default_tokenizer_corpus(tcfg.get_config()) == \
        jtext.default_tokenizer_corpus(jcfg.get_config())
    texts = _texts()
    ascii_texts = [t for t in texts if t.isascii()]
    for batch in (texts, ascii_texts):  # mixed: Python path; ASCII: C++
        got = tok.encode_batch(batch, max_length)
        want = jt.encode_batch(batch, max_length)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for t in texts:
        assert tok.tokenize(t) == jt.tokenize(t)


def test_native_tokenizer_builds_into_the_ignored_build_dir():
    from multimodal_rare_disease_tpu_torch import native

    path = native.library_path("wordpiece")
    assert path.parent.parent == REPO / "build" / "native"
    assert not list(PORT.glob("native/*.so"))
    if native.wordpiece_lib() is not None:
        assert path.is_file()


def test_load_image_uint8_equals_jax(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(1)
    for name, size in (("a.png", (256, 256)), ("b.png", (300, 200))):
        Image.fromarray(rng.integers(0, 256, size[::-1] + (3,),
                                     dtype=np.uint8)).save(tmp_path / name)
        for s in (256, 64):
            np.testing.assert_array_equal(
                timages.load_image_uint8(str(tmp_path / name), s),
                jimages.load_image_uint8(str(tmp_path / name), s))
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not an image")
    np.testing.assert_array_equal(timages.load_image_uint8(str(bad), 32),
                                  np.full((32, 32, 3), 128, np.uint8))


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_and_chip_smoke_import_neither_jax_nor_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 30
    assert {"evaluation/evaluator.py", "evaluation/stats.py",
            "explain/gradcam.py", "explain/attention.py",
            "train/pipeline.py", "utils/rng.py", "cli/evaluate.py",
            "cli/explain.py", "train/trainer.py", "train/state.py",
            "train/freeze.py", "train/schedules.py", "ops/rotate.py",
            "data/synthetic.py", "cli/train.py", "data/parsers.py",
            "train/text_pipeline.py", "models/efficientnet.py",
            "models/mtcnn.py", "data/generative.py",
            "data/offline_augment.py", "utils/profiling.py",
            "cli/convert_weights.py", "cli/verify_setup.py",
            "cli/generate_synthetic.py", "cli/augment_data.py",
            "cli/reorganize.py"} <= {
        str(f.relative_to(PORT)) for f in PORT.rglob("*.py")}
    bad = {f"{f.relative_to(REPO)}: {m}" for f in files
           for m in _imports(f) if m.split(".")[0] in FORBIDDEN}
    assert not bad, sorted(bad)


def test_port_imports_pil_only_inside_functions():
    """The card's machine has no PIL: no module of the port, and not
    chip_smoke.py, imports it when the module is imported."""
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    bad = []
    for f in files:
        tree = ast.parse(f.read_text(), str(f))
        for node in tree.body:
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            bad += [f"{f.relative_to(REPO)}: {n}" for n in names
                    if n.split(".")[0] == "PIL"]
    assert not bad, bad


def test_syndrome_maps_and_find_image_dir_equal_jax(tmp_path):
    assert tcfg.PREFIX_TO_SYNDROME == jcfg.PREFIX_TO_SYNDROME
    assert tcfg.FOLDER_TO_SYNDROME == jcfg.FOLDER_TO_SYNDROME
    over = {"data.data_dirs": (str(tmp_path / "a"), str(tmp_path / "b"))}
    for made in ([], ["b/images"], ["b/images", "a/images_organized"]):
        for sub in made:
            (tmp_path / sub).mkdir(parents=True, exist_ok=True)
        assert tcfg.find_image_dir(tcfg.resolve_config("default", over)) \
            == jcfg.find_image_dir(jcfg.resolve_config("default", over))


def _write_corpus(root, rng, flat=True):
    """Synthetic PNGs in the flat layout, or class folders with _orig /
    _augNN variants of each photo."""
    from PIL import Image

    codes = list(jcfg.PREFIX_TO_SYNDROME)
    for c, code in enumerate(codes):
        for i in range(2 + c % 3):
            px = rng.integers(0, 256, (20 + c, 24, 3), dtype=np.uint8)
            if flat:
                Image.fromarray(px).save(root / f"SYN_{code}_{i:03d}.png")
                continue
            d = root / jcfg.SYNDROME_NAMES[c].replace(" ", "_")
            d.mkdir(exist_ok=True)
            for suffix in ("orig", "aug00", "aug01"):
                Image.fromarray(px).save(d / f"p{i}_{suffix}.png")
    (root / "README.png").write_bytes(b"not a corpus file")


@pytest.mark.parametrize("flat", [True, False], ids=["flat", "folders"])
def test_image_corpus_code_equals_jax(tmp_path, flat):
    _write_corpus(tmp_path, np.random.default_rng(3), flat)
    samples = timages.scan_image_corpus(tmp_path)
    jsamples = jimages.scan_image_corpus(tmp_path)
    assert [(s.path, s.label, s.syndrome, s.base_id) for s in samples] == \
        [(s.path, s.label, s.syndrome, s.base_id) for s in jsamples]
    np.testing.assert_array_equal(timages.class_counts(samples),
                                  jimages.class_counts(jsamples))
    np.testing.assert_array_equal(timages.class_weights(samples),
                                  jimages.class_weights(jsamples))
    np.testing.assert_array_equal(timages.sample_weights(samples),
                                  jimages.sample_weights(jsamples))
    w = timages.sample_weights(samples)
    np.testing.assert_array_equal(
        timages.WeightedSampler(w, 50, np.random.default_rng(4))
        .sample_epoch(),
        jimages.WeightedSampler(w, 50, np.random.default_rng(4))
        .sample_epoch())

    def paths(*splits):
        return [[s.path for s in split] for split in splits]

    for seed in (0, 42):
        assert paths(*timages.ratio_split(
            samples, rng=np.random.default_rng(seed))) == paths(
            *jimages.ratio_split(jsamples, rng=np.random.default_rng(seed)))
        for fn in ("stratified_split", "leakage_aware_split"):
            assert paths(*getattr(timages, fn)(
                samples, 0.3, rng=np.random.default_rng(seed))) == paths(
                *getattr(jimages, fn)(jsamples, 0.3,
                                      rng=np.random.default_rng(seed)))
    imgs, labels = timages.load_corpus_arrays(samples[:5], 64)
    jimgs, jlabels = jimages.load_corpus_arrays(jsamples[:5], 64)
    np.testing.assert_array_equal(imgs, jimgs)
    np.testing.assert_array_equal(labels, jlabels)
    assert labels.dtype == jlabels.dtype == np.int32


def test_host_rng_streams_equal_jax():
    for name in ("split", "sampler", "text_aug", "text_pick", "shuffle",
                 "naïve"):
        assert trng._stable_hash(name) == jrng._stable_hash(name)
    for seed in (0, 42):
        a, b = trng.RngStreams(seed), jrng.RngStreams(seed)
        for name in ("split", "sampler", "split"):
            np.testing.assert_array_equal(a.host(name).integers(0, 1 << 30,
                                                                 8),
                                          b.host(name).integers(0, 1 << 30,
                                                                8))
        assert a.host("split") is a.host("split")


def _demo():
    preds, labels = jstats.make_demo_predictions(n=300, seed=5)
    tpreds, tlabels = tstats.make_demo_predictions(n=300, seed=5)
    assert preds.keys() == tpreds.keys()
    for k in preds:
        np.testing.assert_array_equal(preds[k], tpreds[k])
    np.testing.assert_array_equal(labels, tlabels)
    return preds, labels


def test_stats_equal_jax(tmp_path):
    preds, labels = _demo()
    a, b = preds["multimodal"], preds["text_only"]
    for fn in ("chi_square_test", "mcnemar_test"):
        assert getattr(tstats, fn)(a, b, labels) == \
            getattr(jstats, fn)(a, b, labels)
    # McNemar's exact branch (< 25 discordant pairs) and the degenerate
    # tables of the chi-square
    few = a.copy()
    few[:10] = labels[:10]
    for x, y in ((a, few), (a, a), (labels, labels)):
        for fn in ("chi_square_test", "mcnemar_test"):
            assert getattr(tstats, fn)(x, y, labels) == \
                getattr(jstats, fn)(x, y, labels)
    assert tstats.bootstrap_confidence_interval(a, labels, 200) == \
        jstats.bootstrap_confidence_interval(a, labels, 200)
    got = tstats.compare_multimodal_vs_unimodal(preds, labels, 100)
    assert got == jstats.compare_multimodal_vs_unimodal(preds, labels, 100)
    assert tstats.hypothesis_conclusion(got) == \
        jstats.hypothesis_conclusion(got)
    for mode, p in preds.items():
        np.savez(tmp_path / f"{mode}_predictions.npz", predictions=p,
                 labels=labels, probabilities=np.zeros((len(p), 10)))
    assert tstats.run_statistical_validation(tmp_path, 50) == \
        jstats.run_statistical_validation(tmp_path, 50)
    assert tstats.load_predictions_npz(tmp_path / "none") == ({}, None)


@pytest.mark.parametrize("scheduler", ["constant", "cosine", "warm_restarts",
                                       "step", "plateau"])
def test_schedules_and_early_stopping_equal_jax(scheduler):
    over = {"training.scheduler": scheduler, "training.warmup_epochs": 2,
            "training.num_epochs": 12, "training.lr_decay_epochs": (3, 7),
            "training.restart_period_epochs": 2,
            "training.plateau_patience": 1}
    spe = 5
    a = tsched.make_schedule(tcfg.resolve_config("default", over).training,
                             spe)
    b = jsched.make_schedule(jcfg.resolve_config("default", over).training,
                             spe)
    val = [1.0, 0.9, 0.95, 0.97, 0.99, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0, 1.1]
    for epoch, v in enumerate(val):
        for s in range(epoch * spe, (epoch + 1) * spe):
            assert a(s) == b(s), (scheduler, s)
        a.on_validation(v)
        b.on_validation(v)
    for mode in ("min", "max"):
        ea = tsched.EarlyStopping(patience=2, min_delta=0.05, mode=mode)
        eb = jsched.EarlyStopping(patience=2, min_delta=0.05, mode=mode)
        for v in val:
            assert ea.update(v) == eb.update(v)
            assert (ea.should_stop, ea.best, ea.counter) == \
                (eb.should_stop, eb.best, eb.counter)


# the freeze rules' reach at small widths: 8 BERT layers, so that
# freeze_layers 6 leaves some trained
_FREEZE_WIDTHS = {"text_encoder.num_layers": 8, "text_encoder.num_heads": 2,
                  "text_encoder.hidden_size": 32,
                  "text_encoder.intermediate_size": 64,
                  "text_encoder.vocab_size": 64,
                  "cnn_encoder.stage_sizes": (1, 1, 1, 1),
                  "cnn_encoder.embedding_dim": 16, "fusion.hidden_dim": 16,
                  "fusion.num_attention_heads": 2,
                  "classifier.hidden_dims": (16,), "data.image_size": 32}
_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight",
         "bias": "bias"}


@pytest.mark.parametrize("preset", sorted(jcfg.PRESETS))
def test_freeze_rules_and_multipliers_equal_jax_for_every_preset(preset):
    import jax
    import jax.numpy as jnp

    from multimodal_rare_disease_tpu.models import create_model as jmodel
    from multimodal_rare_disease_tpu_torch.models.classifier import (
        create_model,
    )

    over = dict(_FREEZE_WIDTHS)
    jc = jcfg.resolve_config(preset, over)
    tc = tcfg.resolve_config(preset, over)
    args = (jnp.zeros((1, 32, 32, 3)), jnp.ones((1, 8), jnp.int32),
            jnp.ones((1, 8), jnp.int32))
    params = jax.eval_shape(lambda: jmodel(jc).init(
        jax.random.key(0), *args, train=False))["params"]
    mask = jax.tree_util.tree_leaves_with_path(
        jfreeze.trainable_mask(jc, params))
    mults = dict(jax.tree_util.tree_leaves_with_path(
        jfreeze.lr_multipliers(jc, params)))
    want = {}
    for path, trainable in mask:
        names = [p.key for p in path]
        name = ".".join(names[:-1] + [_LEAF[names[-1]]])
        want[name] = (trainable, float(mults[path]))
    assert any(not t for t, _ in want.values()) == bool(
        jc.cnn_encoder.freeze_stages or jc.text_encoder.freeze_layers)
    # the JAX tree holds each multiplier as an f32 scalar
    got = {n: (tfreeze.is_trainable(tc, n),
               float(np.float32(tfreeze.lr_multiplier(tc, n))))
           for n in want}
    assert got == want
    model = create_model(tc, device="meta", seed=None, trainable=True)
    assert {n: p.requires_grad for n, p in model.named_parameters()} == \
        {n: t for n, (t, _) in want.items()}
    assert tfreeze.count_params(model) == (
        sum(p.numel() for p in model.parameters()),
        sum(p.numel() for p in model.parameters() if p.requires_grad))


def test_synthetic_generator_equals_jax(tmp_path):
    a = tsynth.SyntheticImageGenerator(image_size=48, seed=3)
    b = jsynth.SyntheticImageGenerator(image_size=48, seed=3)
    for c in range(10):
        for i in range(2):
            np.testing.assert_array_equal(a.generate(c, i), b.generate(c, i))
    got = tsynth.generate_synthetic_for_training(tmp_path / "t", 2, 32)
    want = jsynth.generate_synthetic_for_training(tmp_path / "j", 2, 32)
    assert {k: [Path(p).name for p in v] for k, v in got.items()} == \
        {k: [Path(p).name for p in v] for k, v in want.items()}
    for k in got:
        for p, q in zip(got[k], want[k]):
            assert Path(p).read_bytes() == Path(q).read_bytes()


def _fgdd(tmp_path, fgdd_rows, phenotype_rows=None):
    """An FGDD corpus of the given CSV lines under tmp_path."""
    root = tmp_path / "FGDD"
    root.mkdir(parents=True, exist_ok=True)
    (root / "FGDD.csv").write_text("\n".join(fgdd_rows) + "\n")
    if phenotype_rows is not None:
        (root / "Raw data").mkdir(exist_ok=True)
        (root / "Raw data" / "phenotype.csv").write_text(
            "\n".join(phenotype_rows) + "\n")
    return str(root)


# each case: FGDD.csv lines (and phenotype.csv lines) where the csv
# reading must reproduce a pandas semantics the result depends on
_FGDD_CASES = {
    # empty and "NA" disease cells are missing: out of the counts, and
    # their rows stringify as "nan", matching no disease
    "missing-disease": (
        ["patient_id,Disease_name,HP:1,HP:2,note",
         "1,Alpha,1,0,a", "2,,1,1,b", "3,NA,0,1,c", "4,Beta,1,1,d",
         "5,Alpha,0,0,e", "6,nan,1,0,f"], None),
    # one-hot cells: 1 and 1.0 in numeric columns are present; in a text
    # column only the text "1" is
    "one-hot": (
        ["patient_id,Disease_name,HP:1,HP:2,HP:3,HP:4",
         "1,Alpha,1,1.0,1,yes", "2,Beta,0,0.0,1.0,1", "3,Alpha,1,,1,no",
         "4,Beta,01,1.00,x,1"],
        ["id,name", "HP:1,Face", "HP:2,Eyes", "HP:4,Ears"]),
    # patient_id with a gap is a float column: "12.0", and "nan"
    "patient-id-gap": (
        ["patient_id,Disease_name,HP:1", "12,Alpha,1", ",Beta,1",
         "14,Alpha,0"], None),
    # no patient_id column: the row index
    "no-patient-id": (
        ["Disease_name,HP:1,HP:2", "Alpha,1,0", "Beta,0,1", "Gamma,1,1",
         "Alpha,1,1"], None),
    # a numeric Disease_id beside a text column: "5"
    "numeric-disease-id": (
        ["patient_id,Disease_id,HP:1,note", "1,5,1,a", "2,5,0,b",
         "3,6,1,c"], None),
    # an all-numeric table with a float column: iterrows gives float
    # rows, so a row's "5.0" never matches the counts' "5" (no patients)
    "all-numeric-float-row": (
        ["patient_id,Disease_id,HP:1", "1,5,1", "2,5,", "3,6,1"], None),
    # quoted fields with commas, a short row, a blank line
    "csv-quoting": (
        ['patient_id,Disease_name,HP:1,HP:2', '1,"Alpha, type 1",1,0',
         '2,"Alpha, type 1",0', '', '3,Beta,1,1'],
        ['id,name', 'HP:1,"Face, long"', 'HP:2,Eyes']),
}


@pytest.mark.parametrize("case", sorted(_FGDD_CASES))
def test_load_fgdd_reads_like_pandas(tmp_path, case):
    from multimodal_rare_disease_tpu.data import parsers as jparsers
    from multimodal_rare_disease_tpu_torch.data import parsers as tparsers

    rows, phen = _FGDD_CASES[case]
    fgdd = _fgdd(tmp_path, rows, phen)
    got = tparsers.load_fgdd(tcfg.get_config(), fgdd_dir=fgdd)
    want = jparsers.load_fgdd(jcfg.get_config(), fgdd_dir=fgdd)
    assert got == want
    if case == "all-numeric-float-row":
        assert got["texts"] == [] and got["disease_names"] == ["5", "6"]
    if case == "patient-id-gap":
        assert got["patient_ids"] == ["12.0", "nan", "14.0"]


def test_load_fgdd_maps_a_missing_phenotype_name_to_nan(tmp_path):
    # pandas before 3.0 stringified a missing name as "nan"; pandas 3
    # keeps it missing and the JAX function then fails joining the names,
    # so the port keeps the earlier "nan" (ROADMAP D11)
    from multimodal_rare_disease_tpu_torch.data import parsers as tparsers

    fgdd = _fgdd(tmp_path, ["patient_id,Disease_name,HP:1,HP:2",
                            "1,Alpha,1,1"], ["id,name", "HP:1,", "HP:2,NA"])
    got = tparsers.load_fgdd(tcfg.get_config(), fgdd_dir=fgdd)
    assert got["texts"] == ["Patient presents with: nan, nan."]


def test_parsers_and_text_pipeline_keep_the_jax_code():
    # the copies differ from the originals only in their imports, their
    # module docstrings and the csv reading of load_fgdd
    import inspect

    from multimodal_rare_disease_tpu.data import parsers as jparsers
    from multimodal_rare_disease_tpu.train import text_pipeline as jtp
    from multimodal_rare_disease_tpu_torch.data import parsers as tparsers
    from multimodal_rare_disease_tpu_torch.train import text_pipeline as ttp

    for name in ("OrphadataParser", "HPOTerm", "HPOParser", "_text"):
        assert inspect.getsource(getattr(tparsers, name)) == \
            inspect.getsource(getattr(jparsers, name)), name
    assert inspect.getsource(tparsers.create_syndrome_text_mapping).replace(
        "_torch", "") == inspect.getsource(
        jparsers.create_syndrome_text_mapping)
    for name in ("TextDataPipeline", "fgdd_text_pipeline",
                 "FgddPairedPipeline", "fgdd_multimodal_pipeline"):
        assert inspect.getsource(getattr(ttp, name)).replace(
            "_torch", "") == inspect.getsource(getattr(jtp, name)), name
