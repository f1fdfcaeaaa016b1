"""The torch package's own copies of the JAX package's host modules
(config, tokenizer with its C++ core, clinical text, image decode)
against the originals, and a scan of the port's imports: no module of
the port, and not chip_smoke.py, imports jax or the JAX package."""

import ast
from pathlib import Path

import numpy as np
import pytest

from multimodal_rare_disease_tpu import config as jcfg
from multimodal_rare_disease_tpu.data import clinical_text as jtext
from multimodal_rare_disease_tpu.data import images as jimages
from multimodal_rare_disease_tpu.data import tokenizer as jtok
from multimodal_rare_disease_tpu_torch import config as tcfg
from multimodal_rare_disease_tpu_torch.data import clinical_text as ttext
from multimodal_rare_disease_tpu_torch.data import images as timages
from multimodal_rare_disease_tpu_torch.data import tokenizer as ttok

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "multimodal_rare_disease_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "multimodal_rare_disease_tpu")


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
    assert len(files) > 20
    bad = {f"{f.relative_to(REPO)}: {m}" for f in files
           for m in _imports(f) if m.split(".")[0] in FORBIDDEN}
    assert not bad, sorted(bad)
