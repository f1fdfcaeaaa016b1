"""The torch package's offline corpus tools (`data/offline_augment.py`,
`cli/augment_data.py`, `cli/reorganize.py`) against the JAX package's on
the CPU: the same files, byte for byte, for the same corpus and seed."""

from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from multimodal_rare_disease_tpu.cli import augment_data as jax_augment_cli
from multimodal_rare_disease_tpu.cli import reorganize as jax_reorganize_cli
from multimodal_rare_disease_tpu.data import offline_augment as jaug
from multimodal_rare_disease_tpu_torch.cli import augment_data, reorganize
from multimodal_rare_disease_tpu_torch.data import offline_augment as taug
from multimodal_rare_disease_tpu_torch.data.images import scan_image_corpus
from multimodal_rare_disease_tpu_torch.data.synthetic import (
    generate_synthetic_for_training,
)


def _files(root: Path):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.fixture
def corpus(tmp_path):
    src = tmp_path / "src"
    generate_synthetic_for_training(src, num_per_class=1, image_size=40)
    return src


@pytest.mark.parametrize("name", sorted(jaug.AUGMENTATION_TYPES))
def test_each_augmentation_equals_jax(name):
    im = Image.fromarray(np.random.default_rng(0).integers(
        0, 256, (48, 40, 3), dtype=np.uint8))
    got = taug.augment_image(im, name, np.random.default_rng(1))
    want = jaug.augment_image(im, name, np.random.default_rng(1))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert got.size == im.size


def test_unknown_augmentation_raises():
    im = Image.new("RGB", (8, 8))
    with pytest.raises(KeyError):
        taug.augment_image(im, "nope", np.random.default_rng(0))


def test_augment_data_cli_writes_the_jax_files(tmp_path, corpus, capsys):
    args = ["--src", str(corpus), "--num", "3", "--seed", "5"]
    assert augment_data.main(args + ["--out", str(tmp_path / "p")]) == 0
    assert jax_augment_cli.main(args + ["--out", str(tmp_path / "j")]) == 0
    got, want = _files(tmp_path / "p"), _files(tmp_path / "j")
    assert len(got) == 10 * (1 + 3)
    assert got == want
    samples = scan_image_corpus(tmp_path / "p")
    assert len({s.base_id for s in samples}) == 10


@pytest.mark.parametrize("move", [False, True])
def test_reorganize_cli_equals_jax(tmp_path, corpus, capsys, move):
    a, b = tmp_path / "a", tmp_path / "b"
    for d in (a, b):
        generate_synthetic_for_training(d, num_per_class=2, image_size=32)
    extra = ["--move"] if move else []
    assert reorganize.main(["--src", str(a), "--out", str(tmp_path / "p"),
                            *extra]) == 0
    assert jax_reorganize_cli.main(["--src", str(b), "--out",
                                    str(tmp_path / "j"), *extra]) == 0
    assert _files(tmp_path / "p") == _files(tmp_path / "j")
    assert len(_files(tmp_path / "p")) == 20
    assert (not any(a.iterdir())) == move
    counts = taug.reorganize_images(tmp_path / "p", tmp_path / "again")
    assert counts == jaug.reorganize_images(tmp_path / "p",
                                            tmp_path / "again_j")
