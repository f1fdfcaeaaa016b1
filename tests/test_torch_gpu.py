"""The torch package's CUDA kernels on the card: K1 and K2 (the fused
FFN sublayer with and without its input LayerNorm), K3 (the fused
attention-output sublayer) and K4 (the fused uint8 normalize), each
against its plain version; the launch counts of the BERT layers, the
predictor, the Evaluator, Grad-CAM and the attention maps (also on
EfficientNet-B0, and under pre-LN, which launches none); the kernels'
refusal of inputs that autograd tracks; and the train side of the
efficientnet_clinicalbert preset on the card (EfficientNet in f32, the
augmentation extras, a step that keeps the frozen parameters); the
MTCNN nets on the card against the CPU, a face-cropped B=256 predict
with its K1 launches, and a VAE step on the card against the CPU. Every
test here is marked `gpu` and skips without a CUDA device; the file
imports neither jax nor the JAX package, so it runs on a machine that
has only torch:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(`--noconftest`: tests/conftest.py configures jax for the CPU tier)."""

import contextlib

import numpy as np
import pytest
import torch

from multimodal_rare_disease_tpu_torch.kernels import attn_out as k3
from multimodal_rare_disease_tpu_torch.kernels import ffn as kffn
from multimodal_rare_disease_tpu_torch.kernels import image as k4

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


# bf16 outputs of LayerNorm scale, |y| < 8 for these inputs: an element
# may land one bf16 ulp apart (1.6e-2 at |y| in [2, 4), 3.1e-2 in [4, 8))
# where the two versions' f32 sums, taken in another order, round x, the
# GELU chunk or y the other way. Max: the JAX kernel tests' bf16 bound.
# Mean: such flips are rare (an H100 read 3e-7 to 3.3e-6 for K1); 1e-4 is
# 1/78 of an ulp at |y| in [1, 2).
_MAX_ATOL, _MEAN_ATOL = 5e-2, 1e-4


def _rng_tensor(rng, dev):
    def t(shape, scale, offset=0.0, dtype=torch.float32):
        a = (offset + rng.normal(size=shape) * scale).astype(np.float32)
        return torch.from_numpy(a).to(dev, dtype)
    return t


def _ffn_inputs(m, dev, seed=0, h=768, f=3072, vec_dtype=torch.float32):
    """z, (w1, w2) and the six vectors: biases and shifts at the scale of
    the signal and LayerNorm scales at 1 +- 0.25, so that each term moves
    the output far past the tolerances."""
    t = _rng_tensor(np.random.default_rng(seed), dev)
    bf = torch.bfloat16
    z = t((m, h), 1.0, dtype=bf)
    w = (t((h, f), 0.05, dtype=bf), t((f, h), 0.05, dtype=bf))
    vec = dict(b1=t((f,), 0.5, dtype=vec_dtype),
               b2=t((h,), 0.5, dtype=vec_dtype),
               gamma=t((h,), 0.25, 1.0, dtype=vec_dtype),
               beta=t((h,), 0.5, dtype=vec_dtype),
               pre_gamma=t((h,), 0.25, 1.0, dtype=vec_dtype),
               pre_beta=t((h,), 0.5, dtype=vec_dtype))
    return z, w, vec


def _ffn(fn, z, w, v, input_ln=True):
    ln0 = (dict(pre_gamma=v["pre_gamma"], pre_beta=v["pre_beta"])
           if input_ln else {})
    if fn is kffn.ffn_ln_plain:
        ln0["input_ln"] = input_ln
    out = fn(z, w[0], v["b1"], w[1], v["b2"], v["gamma"], v["beta"], **ln0)
    torch.cuda.synchronize()
    return out.float()


def _attn_inputs(m, dev, seed=0, h=768, vec_dtype=torch.float32):
    """ctx, x, wo and (bo, gamma, beta) at the scales of _ffn_inputs."""
    t = _rng_tensor(np.random.default_rng(seed), dev)
    bf = torch.bfloat16
    return (t((m, h), 1.0, dtype=bf), t((m, h), 1.0, dtype=bf),
            t((h, h), 0.05, dtype=bf),
            dict(bo=t((h,), 0.5, dtype=vec_dtype),
                 gamma=t((h,), 0.25, 1.0, dtype=vec_dtype),
                 beta=t((h,), 0.5, dtype=vec_dtype)))


def _attn(fn, ctx, x, wo, v):
    out = fn(ctx, x, wo, v["bo"], v["gamma"], v["beta"])
    torch.cuda.synchronize()
    return out.float()


def _diff(got, want):
    d = (got - want).abs()
    return d.max().item(), d.mean().item()


def _neutral(name, v):
    return torch.ones_like(v) if "gamma" in name else torch.zeros_like(v)


def _ffn_counts():
    return kffn.LAUNCHES_K1, kffn.LAUNCHES_K2, kffn.PLAIN_ON_CUDA


# the single request (1, then the length bucket 64), a ragged tile, the
# CLS-only last layer at B=256 (1,024 CLS rows), a mid size and the packed
# batch: the split-F path below 132 tiles, the whole-F path at 16,384
@pytest.mark.parametrize("vec_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 37, 64, 1024, 4096, 16384])
@pytest.mark.parametrize("input_ln", [True, False], ids=["k1", "k2"])
def test_ffn_kernel_matches_plain(cuda, m, vec_dtype, input_ln):
    z, w, vec = _ffn_inputs(m, cuda, seed=m, vec_dtype=vec_dtype)
    before = _ffn_counts()
    got = _ffn(kffn.fused_ffn_ln, z, w, vec, input_ln)
    want = _ffn(kffn.ffn_ln_plain, z, w, vec, input_ln)
    if not input_ln and vec_dtype == torch.float32:
        # K2 reads bf16 vectors only: f32 ones take the counted gate
        assert _ffn_counts() == (before[0], before[1], before[2] + 1)
        assert torch.equal(got, want)
        return
    assert _ffn_counts() == (before[0] + input_ln,
                             before[1] + (not input_ln), before[2])
    worst, mean = _diff(got, want)
    assert worst <= _MAX_ATOL and mean <= _MEAN_ATOL, (worst, mean)


@pytest.mark.parametrize("m", [1024, 16384], ids=["split", "tiled"])
@pytest.mark.parametrize("input_ln", [True, False], ids=["k1", "k2"])
def test_ffn_kernel_is_deterministic(cuda, m, input_ln):
    # the split path sums its partials in slice order and takes no atomics;
    # both paths give the same bits on every launch
    z, w, vec = _ffn_inputs(m, cuda, seed=9, vec_dtype=torch.bfloat16)
    first = _ffn(kffn.fused_ffn_ln, z, w, vec, input_ln)
    again = _ffn(kffn.fused_ffn_ln, z, w, vec, input_ln)
    plan = kffn.ffn_plan(m, 3072, torch.cuda.get_device_properties(
        cuda).multi_processor_count)
    assert (plan.slices > 1) == (m == 1024)
    assert torch.equal(first, again)


@pytest.mark.parametrize("name,input_ln", [
    (n, True) for n in ("b1", "b2", "gamma", "beta", "pre_gamma",
                        "pre_beta")] + [
    (n, False) for n in ("b1", "b2", "gamma", "beta")])
def test_ffn_check_fails_a_kernel_that_drops_a_vector(cuda, name, input_ln):
    # the kernel given the vector's neutral value stands for a kernel that
    # leaves the term out; the plain version gets the real vector (bf16
    # for K2, the only vectors it reads)
    z, w, vec = _ffn_inputs(256, cuda, seed=7, vec_dtype=(
        torch.float32 if input_ln else torch.bfloat16))
    before = _ffn_counts()
    dropped = {**vec, name: _neutral(name, vec[name])}
    worst, mean = _diff(_ffn(kffn.fused_ffn_ln, z, w, dropped, input_ln),
                        _ffn(kffn.ffn_ln_plain, z, w, vec, input_ln))
    assert _ffn_counts() == (before[0] + input_ln,
                             before[1] + (not input_ln), before[2])
    assert worst > _MAX_ATOL and mean > _MEAN_ATOL, (worst, mean)


# the single request (1, then the length bucket 64), a ragged tile, the
# 1,024 CLS rows, a mid size and the packed batch: the split-K path below
# 132 tiles, the tiled path at 16,384
@pytest.mark.parametrize("vec_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 37, 64, 1024, 4096, 16384])
def test_attn_out_kernel_matches_plain(cuda, m, vec_dtype):
    ctx, x, wo, vec = _attn_inputs(m, cuda, seed=m, vec_dtype=vec_dtype)
    before = (k3.LAUNCHES, k3.PLAIN_ON_CUDA)
    got = _attn(k3.fused_attn_out_ln, ctx, x, wo, vec)
    want = _attn(k3.attn_out_ln_plain, ctx, x, wo, vec)
    if vec_dtype == torch.float32:
        # K3 reads bf16 vectors only: f32 ones take the counted gate
        assert (k3.LAUNCHES, k3.PLAIN_ON_CUDA) == (before[0], before[1] + 1)
        assert torch.equal(got, want)
        return
    assert (k3.LAUNCHES, k3.PLAIN_ON_CUDA) == (before[0] + 1, before[1])
    worst, mean = _diff(got, want)
    assert worst <= _MAX_ATOL and mean <= _MEAN_ATOL, (worst, mean)


@pytest.mark.parametrize("m", [64, 16384], ids=["split", "tiled"])
def test_attn_out_kernel_is_deterministic(cuda, m):
    # the split path sums its partials in slice order and takes no atomics;
    # both paths give the same bits on every launch
    ctx, x, wo, vec = _attn_inputs(m, cuda, seed=9, vec_dtype=torch.bfloat16)
    first = _attn(k3.fused_attn_out_ln, ctx, x, wo, vec)
    again = _attn(k3.fused_attn_out_ln, ctx, x, wo, vec)
    plan = k3.attn_out_plan(m, torch.cuda.get_device_properties(
        cuda).multi_processor_count)
    assert (plan.slices > 1) == (m == 64)
    assert torch.equal(first, again)


@pytest.mark.parametrize("name", ["bo", "gamma", "beta", "x"])
def test_attn_out_check_fails_a_kernel_that_drops_a_term(cuda, name):
    # neutral bo / gamma / beta, or a zero residual x, stand for a kernel
    # that leaves the term out
    ctx, x, wo, vec = _attn_inputs(256, cuda, seed=8, vec_dtype=torch.bfloat16)
    want = _attn(k3.attn_out_ln_plain, ctx, x, wo, vec)
    before = k3.LAUNCHES
    if name == "x":
        got = _attn(k3.fused_attn_out_ln, ctx, torch.zeros_like(x), wo, vec)
    else:
        got = _attn(k3.fused_attn_out_ln, ctx, x, wo,
                    {**vec, name: _neutral(name, vec[name])})
    assert k3.LAUNCHES == before + 1
    worst, mean = _diff(got, want)
    assert worst > _MAX_ATOL and mean > _MEAN_ATOL, (worst, mean)


@pytest.mark.parametrize("shape", [(8, 256, 256, 3), (3, 37, 41, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_normalize_kernel_matches_plain(cuda, shape, dtype):
    u = torch.from_numpy(np.random.default_rng(sum(shape)).integers(
        0, 256, shape, dtype=np.uint8)).to(cuda)
    before = k4.LAUNCHES
    got = k4.fused_normalize_u8(u, dtype)
    torch.cuda.synchronize()
    assert k4.LAUNCHES == before + 1 and got.dtype == dtype
    # the kernel rounds the product and the sum as the plain version does:
    # f32 equal within one rounding; bf16 within one ulp at |y| < 4
    worst, mean = _diff(got.float(), k4.normalize_u8_plain(u, dtype).float())
    atol = 1e-5 if dtype == torch.float32 else 1.6e-2
    assert worst <= atol and mean <= 1e-4, (worst, mean)


def _predictor(cuda, **over):
    from multimodal_rare_disease_tpu_torch.config import resolve_config
    from multimodal_rare_disease_tpu_torch.inference.predictor import (
        MultimodalPredictor,
    )
    from multimodal_rare_disease_tpu_torch.models.classifier import (
        create_model,
    )

    cfg = resolve_config("default", {"text_encoder.num_layers": 2,
                                     "cnn_encoder.stage_sizes": (1, 1, 1, 1),
                                     "data.image_size": 64, **over})
    return MultimodalPredictor(cfg, create_model(cfg, device="cpu"), cuda)


def _counts():
    return (kffn.LAUNCHES_K1, kffn.LAUNCHES_K2, k3.LAUNCHES, k4.LAUNCHES,
            kffn.PLAIN_ON_CUDA, k3.PLAIN_ON_CUDA, k4.PLAIN_ON_CUDA)


def _run(pred):
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (256, 256, 3), dtype=np.uint8)
            for _ in range(3)]
    before = _counts()
    out = pred.predict_batch(imgs, ["short text", "a longer clinical "
                                    "description of the face", "x"])
    torch.cuda.synchronize()
    assert len(out) == 3 and all(np.isfinite(
        list(r["all_probabilities"].values())).all() for r in out)
    return tuple(a - b for a, b in zip(_counts(), before))


def test_bert_layers_launch_the_kernel(cuda):
    # the default configuration: K1 in both layers, nothing else
    assert _run(_predictor(cuda)) == (2, 0, 0, 0, 0, 0, 0)


def test_slice_configuration_launches_k3_k2_k1_k4(cuda):
    # fused_attn_out with images at image_size: K3 and K2 in the first
    # layer, K1 in the CLS-only last one, K4 for the images
    pred = _predictor(cuda, **{"text_encoder.fused_attn_out": True,
                               "data.image_size": 256})
    assert _run(pred) == (1, 1, 1, 1, 0, 0, 0)


def test_kernels_raise_instead_of_cutting_the_graph(cuda):
    # no backward: a launch on inputs autograd tracks raises; the same
    # call without grad mode, or on inputs that need none, launches
    z, w, vec = _ffn_inputs(64, cuda, vec_dtype=torch.bfloat16)
    ctx, x, wo, v3 = _attn_inputs(64, cuda, vec_dtype=torch.bfloat16)
    z.requires_grad_(True)
    ctx.requires_grad_(True)
    before = (_ffn_counts(), k3.LAUNCHES)
    with pytest.raises(RuntimeError, match="no backward"):
        kffn.fused_ffn_ln(z, w[0], vec["b1"], w[1], vec["b2"],
                          vec["gamma"], vec["beta"])
    with pytest.raises(RuntimeError, match="no backward"):
        k3.fused_attn_out_ln(ctx, x, wo, v3["bo"], v3["gamma"], v3["beta"])
    assert (_ffn_counts(), k3.LAUNCHES) == before
    with torch.no_grad():
        _ffn(kffn.fused_ffn_ln, z, w, vec, input_ln=False)
        _attn(k3.fused_attn_out_ln, ctx, x, wo, v3)
    assert k3.LAUNCHES == before[1] + 1
    assert _ffn_counts()[1] == before[0][1] + 1


def _small_cfg(**over):
    """BERT-base width (the kernels' H = 768) at 2 layers, a one-block
    ResNet, 64-px images, 32-token texts, batches of 4, bf16."""
    from multimodal_rare_disease_tpu_torch.config import resolve_config

    return resolve_config("default", {
        "text_encoder.num_layers": 2, "cnn_encoder.stage_sizes": (1, 1, 1, 1),
        "data.image_size": 64, "data.max_text_length": 32,
        "evaluation.eval_batch_size": 4, **over})


def _eval_batches(cfg, n_batches=2, seed=0):
    from multimodal_rare_disease_tpu_torch.data.tokenizer import (
        get_tokenizer,
    )
    from multimodal_rare_disease_tpu_torch.train.pipeline import (
        build_text_pool,
    )

    rng = np.random.default_rng(seed)
    pool = build_text_pool(cfg, get_tokenizer(), np.random.default_rng(1))
    b = cfg.evaluation.eval_batch_size
    out = []
    for _ in range(n_batches):
        labels = rng.integers(0, 10, b)
        ids, mask = pool.gather(labels, np.zeros(b, int), np.zeros(b, int))
        out.append({"images": rng.integers(0, 256, (b, 256, 256, 3),
                                           dtype=np.uint8),
                    "labels": labels, "valid": np.ones(b, np.float32),
                    "input_ids": ids, "attention_mask": mask})
    return out


@contextlib.contextmanager
def _all_plain():
    """Every kernel forced off: the on-card reference."""
    for mod in (kffn, k3, k4):
        mod.FORCE_PLAIN = True
    try:
        yield
    finally:
        for mod in (kffn, k3, k4):
            mod.FORCE_PLAIN = False


def _model(cfg, mode, cuda):
    from multimodal_rare_disease_tpu_torch.models.classifier import (
        create_model,
    )

    return create_model(cfg, mode=mode, device="cpu").to(cuda,
                                                          torch.bfloat16)


@pytest.mark.parametrize("mode,over,want", [
    ("multimodal", {}, (2, 0, 0, 0)),
    ("text_only", {}, (2, 0, 0, 0)),
    ("image_only", {}, (0, 0, 0, 0)),
    # layer 0: K3 then K2; the CLS-only last layer: K1; the images: K4
    ("multimodal", {"text_encoder.fused_attn_out": True,
                    "data.image_size": 256}, (1, 1, 1, 1))],
    ids=["multimodal", "text_only", "image_only", "fused"])
def test_evaluator_launches_per_batch(cuda, mode, over, want):
    from multimodal_rare_disease_tpu_torch.evaluation import (
        Evaluator,
        compute_metrics,
    )

    cfg = _small_cfg(**over)
    ev = Evaluator(cfg, _model(cfg, mode, cuda), mode=mode)
    batches = _eval_batches(cfg)
    before = _counts()
    got = ev.collect_predictions(batches)
    torch.cuda.synchronize()
    counts = tuple(a - b for a, b in zip(_counts(), before))
    assert counts == tuple(2 * w for w in want) + (0, 0, 0)
    probs = got["probabilities"]
    assert probs.shape == (8, 10) and np.isfinite(probs).all()
    np.testing.assert_allclose(probs.sum(1), 1.0, atol=1e-3)
    with _all_plain():
        plain = ev.collect_predictions(batches)["probabilities"]
    # chip_smoke.py's fixed kernel-vs-plain probability limit
    assert np.abs(probs - plain).max() <= 2.5e-3
    assert set(compute_metrics(got)) >= {"accuracy", "per_class",
                                         "confusion_matrix"}


@pytest.mark.parametrize("mode", ["image_only", "multimodal"])
def test_gradcam_on_the_card(cuda, mode):
    from multimodal_rare_disease_tpu_torch.explain import GradCAM

    cfg = _small_cfg(**{"data.image_size": 224})
    batch = _eval_batches(cfg, 1)[0]
    text = ((batch["input_ids"], batch["attention_mask"])
            if mode == "multimodal" else ())
    before = _counts()
    cam, logits = GradCAM(cfg, _model(cfg, mode, cuda), mode=mode)(
        batch["images"], *text)
    torch.cuda.synchronize()
    counts = tuple(a - b for a, b in zip(_counts(), before))
    # the multimodal tail re-runs the text tower (no grad): K1 per layer
    assert counts == ((2 if mode == "multimodal" else 0), 0, 0, 0, 0, 0, 0)
    assert cam.shape == (4, 7, 7) and np.isfinite(cam).all()
    assert cam.min() >= 0.0 and cam.max() <= 1.0
    assert logits.shape == (4, 10) and np.isfinite(logits).all()


def test_text_attentions_turn_k3_off_and_keep_k1(cuda):
    from multimodal_rare_disease_tpu_torch.data.tokenizer import (
        get_tokenizer,
    )

    cfg = _small_cfg(**{"text_encoder.fused_attn_out": True})
    model = _model(cfg, "multimodal", cuda)
    ids, mask, _ = get_tokenizer().encode(
        "Patient presents with hypertelorism and a wide mouth", 128)
    before = _counts()
    with torch.inference_mode():
        attns = model.text_attentions(
            torch.from_numpy(ids).long()[None].to(cuda),
            torch.from_numpy(mask).long()[None].to(cuda))
    torch.cuda.synchronize()
    counts = tuple(a - b for a, b in zip(_counts(), before))
    assert counts == (2, 0, 0, 0, 0, 0, 0)
    assert len(attns) == 2 and attns[0].shape == (1, 12, 128, 128)
    rows = torch.stack(attns).float().sum(-1)
    assert (rows - 1).abs().max().item() <= 1e-3


def test_full_width_train_step_launches_no_kernel(cuda):
    """One train step of the full-width model (ResNet-50, BERT-base,
    bf16 over f32 masters) on the card: no kernel launch and nothing sent
    to a plain version, a finite loss, every trainable parameter moved;
    then the model's validation pass launches K1 per layer."""
    from multimodal_rare_disease_tpu_torch.config import resolve_config
    from multimodal_rare_disease_tpu_torch.train.trainer import Trainer

    cfg = resolve_config("default")
    tr = Trainer(cfg, "multimodal", device=cuda)
    rng = np.random.default_rng(0)
    b, t = cfg.training.batch_size, cfg.data.max_text_length
    batch = {"images": torch.from_numpy(rng.integers(
                 0, 256, (b, 256, 256, 3), dtype=np.uint8)).to(cuda),
             "labels": torch.arange(b, device=cuda) % 10,
             "input_ids": torch.from_numpy(rng.integers(
                 1, 900, (b, t))).to(cuda),
             "attention_mask": torch.ones(b, t, dtype=torch.long,
                                          device=cuda)}
    before_w = {n: p.detach().clone()
                for n, p in tr.model.named_parameters()}
    before = _counts()
    m = tr.train_step(batch, 1e-4)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_counts(), before)) == (0,) * 7
    assert m["skipped"] == 0 and torch.isfinite(m["loss"])
    # every parameter moves but five biases that start at 0 and whose
    # gradient is exactly 0, so that neither the update nor the decay
    # moves them: the pooled cross-attentions' query and key biases (over
    # one key the softmax is 1 whatever the scores) and the pooler's (its
    # output is not used with use_pooler_output off)
    still = {n for n, p in tr.model.named_parameters()
             if torch.equal(p, before_w[n])}
    assert still == {f"fusion.{a}_attention.{k}_proj.bias"
                     for a in ("image_to_text", "text_to_image")
                     for k in ("query", "key")} | {
        "text_encoder.bert.pooler.bias"}
    assert all(p.dtype == torch.float32 and torch.isfinite(p).all()
               for p in tr.model.parameters())
    tr.sync_eval_model()
    before = _counts()
    tr.eval_step({**batch, "valid": torch.ones(b, device=cuda)})
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_counts(), before)) == (
        cfg.text_encoder.num_layers, 0, 0, 0, 0, 0, 0)


def test_batch_norm_running_variance_is_the_biased_one_on_the_card(cuda):
    from multimodal_rare_disease_tpu_torch.models.layers import BatchNorm

    bn = BatchNorm(64, 1e-5, cuda)
    for t, v in ((bn.weight, 1.0), (bn.bias, 0.0), (bn.running_mean, 0.0),
                 (bn.running_var, 1.0)):
        torch.nn.init.constant_(t, v)
    bn.train()
    g = torch.Generator(device=cuda).manual_seed(0)
    # 2 x 3 x 3 = 18 values per channel: unbiased = 18/17 x biased
    x = (torch.randn(2, 64, 3, 3, generator=g, device=cuda) * 2.0 + 0.5) \
        .to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    y = bn(x)
    assert y.dtype == torch.bfloat16
    xf = x.float()
    mean = xf.mean((0, 2, 3))
    biased = (xf * xf).mean((0, 2, 3)) - mean * mean
    torch.testing.assert_close(bn.running_mean, 0.1 * mean, atol=1e-6,
                               rtol=1e-5)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * biased,
                               atol=1e-5, rtol=1e-5)
    unbiased = xf.var((0, 2, 3), unbiased=True)
    assert (0.9 + 0.1 * unbiased - bn.running_var).abs().min() > 1e-3


def test_efficientnet_preset_launches_k1_in_every_layer(cuda):
    # the efficientnet_clinicalbert backbone under the default dispatch
    pred = _predictor(cuda, **{"cnn_encoder.backbone": "efficientnet_b0"})
    assert _run(pred) == (2, 0, 0, 0, 0, 0, 0)


@pytest.mark.parametrize("fused_attn_out", [False, True])
def test_pre_ln_launches_no_kernel(cuda, fused_attn_out):
    # the JAX dispatch turns K1 and K3 off under pre-LN; K4 stays off too
    # at 64 px (the resample runs)
    pred = _predictor(cuda, **{"text_encoder.pre_layernorm": True,
                               "text_encoder.fused_attn_out":
                                   fused_attn_out})
    assert _run(pred) == (0,) * 7


def test_efficientnet_f32_on_the_card_matches_the_cpu(cuda):
    from multimodal_rare_disease_tpu_torch.models.efficientnet import (
        EfficientNetB0Encoder,
    )
    from multimodal_rare_disease_tpu_torch.models.layers import init_weights

    net = EfficientNetB0Encoder("cpu")
    init_weights(net, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(4, 224, 224, 3)).astype(np.float32))
    with torch.no_grad():
        want, wf = net(x, return_features=True)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            got, gf = net.to(cuda)(x.to(cuda), return_features=True)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    # f32 through ~50 convolutions: cuDNN may take Winograd or FFT
    # algorithms, whose round-off is above a direct sum's
    assert (got.cpu() - want).abs().max().item() <= 1e-3
    assert gf["head"].shape == (4, 7, 7, 1280)
    assert (gf["stage4"].cpu() - wf["stage4"]).abs().max().item() <= 1e-3


def test_augmentation_extras_on_the_card_match_the_cpu(cuda):
    """Each extra at one set of draws, f32, card against CPU tensors, at
    chip_smoke.py's tolerances (its phase 11 runs them at 256 images)."""
    from multimodal_rare_disease_tpu_torch.config import resolve_config
    from multimodal_rare_disease_tpu_torch.ops import preprocess as pre

    cfg = resolve_config("default", {
        "data.image_size": 64, "data.gaussian_blur_prob": 0.5,
        "data.gaussian_noise_std": 0.05, "data.random_erasing_prob": 0.5,
        "data.perspective_prob": 0.5, "data.clahe_prob": 0.5,
        "data.elastic_prob": 0.5, "data.coarse_dropout_prob": 0.5,
        "data.geometry_mode": "gather"})
    rng = np.random.default_rng(3)
    u8 = torch.from_numpy(rng.integers(0, 256, (8, 80, 80, 3),
                                       dtype=np.uint8))
    p = pre.draw_train_params(8, cfg, torch.Generator().manual_seed(4))
    p_card = {k: v.to(cuda) for k, v in p.items()}
    cpu = pre.train_preprocess_apply(u8, p, cfg)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card = pre.train_preprocess_apply(u8.to(cuda), p_card, cfg)
        x = torch.from_numpy(rng.uniform(0, 1, (8, 64, 64, 3)).astype(
            np.float32))
        for fn, atol in ((pre.clahe_batch_tiled, 1e-5),
                         (pre.clahe_batch, 1e-5),
                         (pre.gaussian_blur, 1e-6)):
            err = (fn(x.to(cuda)).cpu() - fn(x)).abs().max().item()
            assert err <= atol, (fn.__name__, err)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    # the whole stack: the perspective's solve bounds it (1e-3 on [0, 1],
    # / the smallest ImageNet std after normalization)
    err = (card.cpu() - cpu).abs()
    assert err.max().item() <= 1e-3 / 0.224 and err.mean().item() <= 1e-4


def test_preset_train_step_keeps_the_frozen_parameters(cuda):
    from multimodal_rare_disease_tpu_torch.config import resolve_config
    from multimodal_rare_disease_tpu_torch.train.trainer import Trainer

    cfg = resolve_config("efficientnet_clinicalbert", {
        "text_encoder.num_layers": 8, "data.max_text_length": 32})
    tr = Trainer(cfg, "multimodal", device=cuda)
    rng = np.random.default_rng(5)
    b, t = cfg.training.batch_size, cfg.data.max_text_length
    batch = {"images": torch.from_numpy(rng.integers(
                 0, 256, (b, 256, 256, 3), dtype=np.uint8)).to(cuda),
             "labels": torch.arange(b, device=cuda) % 10,
             "input_ids": torch.from_numpy(rng.integers(
                 1, 900, (b, t))).to(cuda),
             "attention_mask": torch.ones(b, t, dtype=torch.long,
                                          device=cuda)}
    start = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    before = _counts()
    m = tr.train_step(batch, 1e-4)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_counts(), before)) == (0,) * 7
    assert m["skipped"] == 0 and torch.isfinite(m["loss"])
    frozen = {n for n, p in tr.model.named_parameters()
              if not p.requires_grad}
    assert any(n.startswith("cnn_encoder.backbone.stage3_") for n in frozen)
    assert any(".layer5." in n for n in frozen)
    assert not any(".layer6." in n or "stage4_" in n for n in frozen)
    params = dict(tr.model.named_parameters())
    assert all(torch.equal(params[n], start[n]) for n in frozen)
    # every trainable parameter moves but the five zero-gradient biases
    # of test_full_width_train_step_launches_no_kernel
    still = {n for n in params
             if n not in frozen and torch.equal(params[n], start[n])}
    assert still == {f"fusion.{a}_attention.{k}_proj.bias"
                     for a in ("image_to_text", "text_to_image")
                     for k in ("query", "key")} | {
        "text_encoder.bert.pooler.bias"}


# -- face detection, the face-cropped predict and the VAE (chip_smoke.py
# phase 12 runs them at 256 images) ----------------------------------------

@contextlib.contextmanager
def _no_tf32():
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


@pytest.mark.parametrize("net,shape", [
    ("pnet", (1, 154, 154, 3)), ("pnet", (2, 13, 17, 3)),
    ("rnet", (64, 24, 24, 3)), ("onet", (64, 48, 48, 3))])
def test_mtcnn_nets_on_the_card_match_the_cpu(cuda, net, shape):
    """f32, TF32 off, at chip_smoke.py's MTCNN_NET_ATOL."""
    from chip_smoke import MTCNN_NET_ATOL, mtcnn_weights
    from multimodal_rare_disease_tpu_torch.models.mtcnn import MTCNN

    nets = MTCNN(device="cpu")
    nets.load_state_dict(mtcnn_weights(), strict=True)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=shape).astype(np.float32))
    with torch.no_grad():
        want = getattr(nets.eval(), net)(x)
        with _no_tf32():
            got = getattr(nets.to(cuda), net)(x.to(cuda))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert (g.cpu() - w).abs().max().item() <= MTCNN_NET_ATOL


def test_face_cropped_predict_launches_k1_per_layer(cuda):
    """MTCNN crops on the card, staged by the numpy bilinear, through
    the full-width default model at B=256: K1 at the packed rows in
    layers 0-10 and at the rows' query slots in the CLS-only last one."""
    from chip_smoke import mtcnn_weights
    from multimodal_rare_disease_tpu_torch.config import resolve_config
    from multimodal_rare_disease_tpu_torch.data import images as dimages
    from multimodal_rare_disease_tpu_torch.data.synthetic import (
        SyntheticImageGenerator,
    )
    from multimodal_rare_disease_tpu_torch.inference.predictor import (
        MultimodalPredictor,
    )
    from multimodal_rare_disease_tpu_torch.inference.seeded_batch import (
        seeded_requests,
    )
    from multimodal_rare_disease_tpu_torch.models import bert
    from multimodal_rare_disease_tpu_torch.models.classifier import (
        create_model,
    )
    from multimodal_rare_disease_tpu_torch.models.mtcnn import MTCNNDetector

    synth = SyntheticImageGenerator(256, seed=12)
    faces = [synth.generate(c, 0) for c in range(10)]
    failures = dimages.FACE_DETECTOR_FAILURES
    dimages.set_face_detector(MTCNNDetector(mtcnn_weights(), device=cuda))
    try:
        crops = [dimages.stage_uint8(f, 256) for f in faces]
    finally:
        dimages.set_face_detector(None)
    assert dimages.FACE_DETECTOR_FAILURES == failures
    assert sum(not np.array_equal(a, b) for a, b in zip(crops, faces)) >= 5
    _, texts = seeded_requests(256, seed=0)
    images = [crops[i % len(crops)] for i in range(256)]
    cfg = resolve_config("default")
    pred = MultimodalPredictor(cfg, create_model(cfg, device="cpu", seed=0),
                               cuda)
    rows, wrapper = [], bert.fused_ffn_ln

    def rec(x, *a, **kw):
        rows.append(x.shape[0])
        return wrapper(x, *a, **kw)

    bert.fused_ffn_ln = rec
    try:
        before = _counts()
        out = pred.predict_batch(images, texts)
        torch.cuda.synchronize()
        got = tuple(a - b for a, b in zip(_counts(), before))
    finally:
        bert.fused_ffn_ln = wrapper
    assert got == (12, 0, 0, 0, 0, 0, 0)
    ids, mask = pred._prep_texts(texts, 256)
    packed = pred._packed_inputs(ids, mask)
    assert rows == [packed[0].size] * 11 + [packed[3].size]
    assert all(np.isfinite(list(r["all_probabilities"].values())).all()
               for r in out)


def test_vae_step_on_the_card_matches_the_cpu(cuda):
    """One f32 Adam step with explicit noise, TF32 off, at chip_smoke.py's
    tolerances (phase 12)."""
    from chip_smoke import VAE_LOSS_RTOL, VAE_PARAM_ATOL, VAE_STEP_LR
    from multimodal_rare_disease_tpu_torch.data import generative as g

    imgs = np.random.default_rng(0).integers(0, 256, (20, 64, 64, 3),
                                             dtype=np.uint8)
    labels = np.repeat(np.arange(10), 2)
    eps = torch.randn((20, 64), generator=torch.Generator().manual_seed(1))
    out = []
    with _no_tf32():
        for where in (cuda, torch.device("cpu")):
            m = g.init_vae(g.ConvVAE(device="cpu"),
                           torch.Generator().manual_seed(2)).to(where)
            opt = torch.optim.Adam(m.parameters(), lr=VAE_STEP_LR)
            loss = g.vae_step(m, opt, g.corpus_tensor(imgs, where),
                              torch.from_numpy(labels).to(where),
                              eps.to(where), VAE_STEP_LR)
            out.append((float(loss), {k: v.detach().cpu()
                                      for k, v in m.state_dict().items()}))
    (l_card, sd_card), (l_cpu, sd_cpu) = out
    assert abs(l_card - l_cpu) <= VAE_LOSS_RTOL * l_cpu
    for k in sd_cpu:
        assert (sd_card[k] - sd_cpu[k]).abs().max().item() <= VAE_PARAM_ATOL
