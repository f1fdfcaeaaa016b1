"""The torch package's CLIs (predict, evaluate, stats, explain) with
`--device cpu`, each beside its JAX counterpart with `--platform cpu` on
checkpoints of the same weights and the same synthetic PNG corpus: the
same artifact file names, JSON keys and, where the two compute the same
thing, the same values."""

import json

import numpy as np
import pytest

from multimodal_rare_disease_tpu.cli import evaluate as jax_evaluate
from multimodal_rare_disease_tpu.cli import explain as jax_explain
from multimodal_rare_disease_tpu.cli import predict as jax_predict
from multimodal_rare_disease_tpu.cli import stats as jax_stats
from multimodal_rare_disease_tpu.cli._common import (
    build_config as jax_build_config,
)
from multimodal_rare_disease_tpu.utils.checkpoint import (
    save_checkpoint as jax_save,
)
from multimodal_rare_disease_tpu_torch.cli import evaluate, explain, predict
from multimodal_rare_disease_tpu_torch.cli import stats as port_stats
from multimodal_rare_disease_tpu_torch.cli._common import (
    add_config_args,
    build_config,
)
from multimodal_rare_disease_tpu_torch.utils.checkpoint import (
    save_checkpoint,
)

from tests.test_torch_evaluation import assert_same, model_pair
from tests.test_torch_host_copies import _write_corpus

TEXT = "Patient presents with hypertelorism and a wide mouth with full lips"


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A synthetic corpus under <root>/images (the config's data root)
    and, per mode, a JAX and a port checkpoint of the same weights."""
    root = tmp_path_factory.mktemp("cli")
    (root / "images").mkdir()
    _write_corpus(root / "images", np.random.default_rng(21), flat=True)
    over = {"data.data_dirs": (str(root),)}
    ckpts = {}
    for i, mode in enumerate(("multimodal", "image_only")):
        jcfg, _, v, cfg, tm = model_pair(mode, 30 + i, **over)
        jax_save(root / f"jax_{mode}", v["params"], v.get("batch_stats", {}),
                 0, meta={"config": jcfg.to_dict(), "mode": mode})
        save_checkpoint(root / f"port_{mode}", tm.state_dict(),
                        meta={"config": cfg.to_dict(), "mode": mode})
        ckpts[mode] = (str(root / f"jax_{mode}"), str(root / f"port_{mode}"))
    return root, ckpts


@pytest.fixture(autouse=True)
def no_jax_compile_cache(monkeypatch):
    # the JAX CLIs would otherwise write a compilation cache under $HOME
    monkeypatch.setenv("MRD_NO_COMPILE_CACHE", "1")


def keys(tree):
    """The nested key structure of a JSON value."""
    if isinstance(tree, dict):
        return {k: keys(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [keys(v) for v in tree[:1]]
    return type(tree).__name__


def test_evaluate_with_stats_writes_the_jax_artifacts(setup, tmp_path,
                                                      capsys):
    root, ckpts = setup

    def args(side, out):
        """--checkpoint per mode (side 0: JAX, 1: port), the corpus,
        --stats and the results dir."""
        return [a for mode in ("multimodal", "image_only")
                for a in ("--checkpoint", ckpts[mode][side])] + [
            "--image-dir", str(root / "images"), "--stats",
            "--results-dir", str(tmp_path / out)]

    assert evaluate.main(args(1, "p") + ["--device", "cpu"]) == 0
    port_out = capsys.readouterr().out
    assert jax_evaluate.main(args(0, "j") + ["--platform", "cpu"]) == 0
    jax_out = capsys.readouterr().out
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert "statistical_results.json" in names
    assert "model_comparison.json" in names
    assert sorted(p.name for p in (tmp_path / "p").iterdir()) == names
    for name in names:
        if name.endswith(".json"):
            got = json.loads((tmp_path / "p" / name).read_text())
            want = json.loads((tmp_path / "j" / name).read_text())
            assert keys(got) == keys(want), name
            # the same weights, the same predictions: the same metrics
            assert_same(got, want, name)
    # the summary JSON that ends the output, and the stats conclusion
    tail = port_out[port_out.rindex("\n{"):]
    assert json.loads(tail) == json.loads(jax_out[jax_out.rindex("\n{"):])
    assert "STATISTICAL HYPOTHESIS TEST" in port_out


def test_stats_demo_equals_jax(tmp_path, capsys):
    assert port_stats.main(["--demo", "--results-dir", str(tmp_path / "p"),
                            "--n-bootstrap", "200", "--device", "cpu"]) == 0
    port_out = capsys.readouterr().out
    assert jax_stats.main(["--demo", "--results-dir", str(tmp_path / "j"),
                           "--n-bootstrap", "200", "--platform", "cpu"]) == 0
    assert port_out == capsys.readouterr().out
    name = "statistical_results.json"
    assert json.loads((tmp_path / "p" / name).read_text()) == \
        json.loads((tmp_path / "j" / name).read_text())
    assert port_stats.main(["--results-dir", str(tmp_path / "empty")]) == 1


@pytest.mark.parametrize("mode", ["multimodal", "image_only"])
def test_explain_writes_the_jax_artifacts(setup, tmp_path, capsys, mode):
    root, ckpts = setup
    image = sorted((root / "images").iterdir())[0]
    single = ["--image", str(image), "--text", TEXT]
    for args in (single, ["--batch"]):
        assert explain.main(["--checkpoint", ckpts[mode][1], "--outdir",
                             str(tmp_path / "p"), "--device", "cpu"]
                            + args) == 0
        assert jax_explain.main(["--checkpoint", ckpts[mode][0], "--outdir",
                                 str(tmp_path / "j"), "--platform", "cpu"]
                                + args) == 0
        capsys.readouterr()
        names = sorted(p.name for p in (tmp_path / "j").iterdir())
        assert sorted(p.name for p in (tmp_path / "p").iterdir()) == names
        got = json.loads((tmp_path / "p" / "index.json").read_text())
        want = json.loads((tmp_path / "j" / "index.json").read_text())
        assert len(got) == len(want) == (1 if args is single else 10)
        for g, w in zip(got, want):
            assert keys(g) == keys(w)
            assert g["predicted_class"] == w["predicted_class"]
            if "top_tokens" in w:
                assert [t for t, _ in g["top_tokens"]] == \
                    [t for t, _ in w["top_tokens"]]
                np.testing.assert_allclose(
                    [x for _, x in g["top_tokens"]],
                    [x for _, x in w["top_tokens"]], atol=1e-5)
    assert (mode == "multimodal") == any("cross_modal" in n for n in names)


@pytest.mark.parametrize("mode,extra", [
    ("multimodal", ["--report"]), ("image_only", ["--embeddings"])])
def test_predict_prints_the_jax_json_contract(setup, tmp_path, capsys, mode,
                                              extra):
    root, ckpts = setup
    image = str(sorted((root / "images").iterdir())[3])
    args = ["--image", image, "--text", TEXT] + extra
    assert predict.main(["--checkpoint", ckpts[mode][1], "--device", "cpu",
                         "--output", str(tmp_path / "p.json")] + args) == 0
    port_out = capsys.readouterr().out
    assert jax_predict.main(["--checkpoint", ckpts[mode][0], "--platform",
                             "cpu", "--output", str(tmp_path / "j.json")]
                            + args) == 0
    jax_out = capsys.readouterr().out
    got = json.loads((tmp_path / "p.json").read_text())
    want = json.loads((tmp_path / "j.json").read_text())
    assert keys(got) == keys(want)
    assert [p["syndrome"] for p in got["predictions"]] == \
        [p["syndrome"] for p in want["predictions"]]
    np.testing.assert_allclose(list(got["all_probabilities"].values()),
                               list(want["all_probabilities"].values()),
                               atol=1e-5)
    if "--embeddings" in extra:
        np.testing.assert_allclose(got["embeddings"]["image"],
                                   want["embeddings"]["image"], atol=1e-4)
    if "--report" in extra:
        assert port_out.splitlines()[:4] == jax_out.splitlines()[:4]
        assert "DIFFERENTIAL DIAGNOSIS:" in port_out


def test_config_flags_resolve_like_jax():
    import argparse

    parser = argparse.ArgumentParser()
    add_config_args(parser)
    args = parser.parse_args(["--set", "training.batch_size=3",
                              "--set", "fusion.fusion_type=gated"])
    assert args.device == "cuda"
    for mode in ("multimodal", "image_only", "text_only"):
        got = build_config(args, mode).to_dict()
        want = jax_build_config(args, mode).to_dict()
        got["data"].pop("data_dirs")
        want["data"].pop("data_dirs")
        assert got == want
    with pytest.raises(SystemExit):
        build_config(parser.parse_args(["--set", "novalue"]), "multimodal")
