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
with its K1 launches, a VAE step on the card against the CPU, the
sharded predict of two gloo ranks sharing the card, and the int8
products (`models/quant.py`) on the card bit-equal to the CPU, with a
quantized BERT layer that launches no kernel, `entry.py`'s
`entry()` with its K1 launches, the f32 forms of K1-K3 (an f32
model's kernels) against their plain versions with TF32 off, with an
f32 model's predict launching them, and the forms of K1-K3 built for
BERT-large's H = 1,024, the compact BERTs' 512, 256 and 128, MiniLM's 384
and for 640 and 896 in bf16 and f32 (the `test_width_*` tests, their ids
naming the width: `h1024`, `h512`, ...), with a predict at each width
launching them and K1/K2 at intermediate widths other than 4H at every
built width; K3-f32's pass over whole rows (`-k f32narrow`) and K1-f32's
and K2-f32's one-pass form at 128 and 256 (`-k f32ffnrows`), forced and
left to the rule, each with the dropped terms its check must refuse, and
K3's overlapped forms at 128 and 640 (`-k overlap`), forced and left to
the rule, bit for bit the one-block form's, with the dropped terms.
Every test here
is marked `gpu` and skips without a CUDA device; the file imports
neither jax nor the JAX package, so it runs on a machine that has only
torch:

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


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)], ids=["2x1", "1x2"])
def test_two_ranks_sharing_the_card_predict_as_one_device(cuda, shape,
                                                         tmp_path):
    """Two ranks on cuda:0 over gloo (NCCL refuses two ranks on one
    device), with a one-layer BERT tower at the kernel's width: each rank
    runs K1 once per forward on its rows (under 1x2 on W1 and W2
    gathered over the model axis), and the probabilities every rank
    gathers equal the single-device predictor's within chip_smoke.py's
    kernels-off limit (the ranks pack their own rows)."""
    from chip_smoke import PROB_ATOL_PLAIN
    from multimodal_rare_disease_tpu_torch.config import resolve_config
    from multimodal_rare_disease_tpu_torch.data.tokenizer import (
        get_tokenizer,
    )
    from multimodal_rare_disease_tpu_torch.models.classifier import (
        create_model,
    )
    from multimodal_rare_disease_tpu_torch.inference.predictor import (
        MultimodalPredictor,
    )
    from multimodal_rare_disease_tpu_torch.inference.seeded_batch import (
        seeded_requests,
    )
    from multimodal_rare_disease_tpu_torch.parallel.distributed import (
        run_ranks,
    )
    import _torch_parallel_workers as workers

    over = {"text_encoder.num_layers": 1, "data.image_size": 64,
            "cnn_encoder.stage_sizes": (1, 1, 1, 1)}
    cfg = resolve_config("default", over)
    tok = get_tokenizer()
    images, texts = seeded_requests(16, seed=0)
    single = MultimodalPredictor(cfg, create_model(cfg, device="cpu",
                                                   seed=0), cuda,
                                 tokenizer=tok)
    res = single.predict_batch(images, texts)
    want = np.array([[r["all_probabilities"][k]
                      for k in sorted(r["all_probabilities"])] for r in res])
    outs = run_ranks(workers.predict_rank, 2, backend="gloo",
                     args=(over, None, dict(tok.vocab), images, texts,
                           (shape,), "cuda:0"),
                     timeout_s=300, init_dir=str(tmp_path))
    key = f"{shape[0]}x{shape[1]}"
    for o in outs:
        probs, _, packed, classic, qkv, k1 = o[key]
        np.testing.assert_allclose(probs, want, atol=PROB_ATOL_PLAIN)
        assert qkv == (3 * 768 // shape[1], 768)
        assert k1 == 1 and packed + classic == 1


@pytest.mark.parametrize("m", [1, 16, 17, 300])
@pytest.mark.parametrize("k,n", [(768, 2304), (3072, 768)])
def test_int8_products_on_the_card_equal_the_cpu(cuda, k, n, m):
    from multimodal_rare_disease_tpu_torch.models import quant

    gen = torch.Generator().manual_seed(k + m)
    w = torch.randn((n, k), generator=gen) * 0.02
    x = torch.randn((m, k), generator=gen).to(torch.bfloat16)
    outs = []
    for dev in (torch.device("cpu"), cuda):
        codes, scale = quant.quantize_weight(w.to(dev).t())
        outs.append((codes.cpu(), scale.cpu(), quant.quant_linear(
            x.to(dev), codes, scale, None, torch.float32).cpu()))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_quantized_bert_layer_launches_no_kernel(cuda):
    from multimodal_rare_disease_tpu_torch.config import resolve_config
    from multimodal_rare_disease_tpu_torch.models import quant
    from multimodal_rare_disease_tpu_torch.models.bert import (
        create_text_encoder,
    )
    from multimodal_rare_disease_tpu_torch.models.layers import init_weights

    cfg = resolve_config("default", {
        "text_encoder.num_layers": 2,
        "text_encoder.quantized_inference": True,
        "text_encoder.flat_residual": True}).text_encoder
    enc = create_text_encoder(cfg, cuda)
    init_weights(enc, torch.Generator().manual_seed(0), std=0.02)
    quant.prepare_quantized(enc)
    enc = enc.to(torch.bfloat16).eval()
    ids = torch.randint(1, 1000, (4, 32), device=cuda)
    mask = torch.ones_like(ids)
    kffn.LAUNCHES_K1 = kffn.LAUNCHES_K2 = k3.LAUNCHES = 0
    padded = quant.PADDED_CALLS
    with torch.inference_mode():
        out = enc(ids, mask)
    torch.cuda.synchronize()
    assert out.shape == (4, 768) and torch.isfinite(out.float()).all()
    assert (kffn.LAUNCHES_K1, kffn.LAUNCHES_K2, k3.LAUNCHES) == (0, 0, 0)
    # the CLS-only last layer's attention output and FFN: 4 rows, padded
    assert quant.PADDED_CALLS - padded == 3


def test_entry_launches_k1_per_layer(cuda):
    """`entry()` on the card: the default config's forward at B=8, T=128
    takes the resample (no K4) and K1 in every BERT layer, 11 times at
    the 1,024 token rows and once at the 8 CLS rows of the CLS-only last
    layer; its probabilities within chip_smoke.py's kernel-vs-plain
    limit of every kernel forced off."""
    from multimodal_rare_disease_tpu_torch.entry import entry
    from multimodal_rare_disease_tpu_torch.models import bert

    forward, (model, images, ids, mask) = entry()
    assert images.is_cuda and next(model.parameters()).is_cuda
    rows, wrapper = [], bert.fused_ffn_ln

    def rec(x, *a, **kw):
        rows.append(x.shape[0])
        return wrapper(x, *a, **kw)

    bert.fused_ffn_ln = rec
    try:
        before = _counts()
        probs = forward(model, images, ids, mask)
        torch.cuda.synchronize()
        got = tuple(a - b for a, b in zip(_counts(), before))
    finally:
        bert.fused_ffn_ln = wrapper
    assert got == (12, 0, 0, 0, 0, 0, 0)
    assert rows == [1024] * 11 + [8]
    assert probs.shape == (8, 10) and torch.isfinite(probs).all()
    with _all_plain():
        plain = forward(model, images, ids, mask)
    assert (probs - plain).abs().max().item() <= 2.5e-3


# the f32 kernels against their plain versions, TF32 off: f32 products
# (three TF32 products in K1-f32 and K2-f32) summed in another order, then
# LayerNorm (an H100 read up to 1.9e-5 max, 9.3e-7 mean); the plain
# version with TF32 operands read 1.7e-3-3.2e-3 max and 1.8e-4-3.1e-4
# mean, which these limits refuse (chip_smoke.py's ROW_F32_ATOL /
# ROW_F32_MEAN_ATOL)
_F32_MAX_ATOL, _F32_MEAN_ATOL = 1e-4, 1e-5


@contextlib.contextmanager
def _tf32(on):
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _f32_counts():
    return (kffn.LAUNCHES_K1_F32, kffn.LAUNCHES_K2_F32, k3.LAUNCHES_F32,
            kffn.PLAIN_ON_CUDA, k3.PLAIN_ON_CUDA)


def _f32_ffn_inputs(m, dev, seed):
    t = _rng_tensor(np.random.default_rng(seed), dev)
    z, w = t((m, 768), 1.0), (t((768, 3072), 0.05), t((3072, 768), 0.05))
    vec = dict(b1=t((3072,), 0.5), b2=t((768,), 0.5),
               gamma=t((768,), 0.25, 1.0), beta=t((768,), 0.5),
               pre_gamma=t((768,), 0.25, 1.0), pre_beta=t((768,), 0.5))
    return z, w, vec


# the single request (1, then its length bucket 64), a ragged tile, the
# 1,024 CLS rows (the second product split), a mid size, the packed batch
# (whole k loops) and a ragged tile of the 128-row GEMMs past it
@pytest.mark.parametrize("m", [1, 37, 64, 1024, 4096, 16384, 16385])
@pytest.mark.parametrize("input_ln", [True, False], ids=["k1", "k2"])
def test_f32_ffn_kernel_matches_plain(cuda, m, input_ln):
    z, w, vec = _f32_ffn_inputs(m, cuda, seed=m)
    before = _f32_counts()
    with _tf32(False):
        got = _ffn(kffn.fused_ffn_ln, z, w, vec, input_ln)
        want = _ffn(kffn.ffn_ln_plain, z, w, vec, input_ln)
    assert _f32_counts() == (before[0] + input_ln, before[1] + (not input_ln),
                             *before[2:])
    worst, mean = _diff(got, want)
    assert worst <= _F32_MAX_ATOL and mean <= _F32_MEAN_ATOL, (worst, mean)


def _f32_attn_inputs(m, dev, seed):
    t = _rng_tensor(np.random.default_rng(seed), dev)
    ctx, x, wo = t((m, 768), 1.0), t((m, 768), 1.0), t((768, 768), 0.05)
    vec = dict(bo=t((768,), 0.5), gamma=t((768,), 0.25, 1.0),
               beta=t((768,), 0.5))
    return ctx, x, wo, vec


# the single request (1, then its length bucket 64: the k loop in 3
# slices), a ragged tile, the 1,024 CLS rows (2 slices), the packed batch
# (one slice) and a ragged 128-row tile past it
@pytest.mark.parametrize("m", [1, 37, 64, 1024, 16384, 16385])
def test_f32_attn_out_kernel_matches_plain(cuda, m):
    ctx, x, wo, vec = _f32_attn_inputs(m, cuda, seed=m)
    before = _f32_counts()
    with _tf32(False):
        got = _attn(k3.fused_attn_out_ln, ctx, x, wo, vec)
        want = _attn(k3.attn_out_ln_plain, ctx, x, wo, vec)
    assert _f32_counts() == (*before[:2], before[2] + 1, *before[3:])
    worst, mean = _diff(got, want)
    assert worst <= _F32_MAX_ATOL and mean <= _F32_MEAN_ATOL, (worst, mean)


@pytest.mark.parametrize("m", [64, 16384], ids=["split", "tiled"])
def test_f32_attn_out_kernel_is_deterministic(cuda, m):
    # the split path sums its partials in slice order and takes no atomics;
    # both paths give the same bits on every launch
    ctx, x, wo, vec = _f32_attn_inputs(m, cuda, seed=9)
    first = _attn(k3.fused_attn_out_ln, ctx, x, wo, vec)
    again = _attn(k3.fused_attn_out_ln, ctx, x, wo, vec)
    plan = k3.attn_out_plan_f32(m, torch.cuda.get_device_properties(
        cuda).multi_processor_count)
    assert (plan.slices > 1) == (m == 64)
    assert torch.equal(first, again)


@pytest.mark.parametrize("name", ["bo", "gamma", "beta", "x"])
def test_f32_attn_out_check_fails_a_kernel_that_drops_a_term(cuda, name):
    # neutral bo / gamma / beta, or a zero residual x, stand for an f32
    # kernel that leaves the term out: the f32 limits must refuse it
    ctx, x, wo, vec = _f32_attn_inputs(256, cuda, seed=8)
    with _tf32(False):
        want = _attn(k3.attn_out_ln_plain, ctx, x, wo, vec)
        before = _f32_counts()
        if name == "x":
            got = _attn(k3.fused_attn_out_ln, ctx, torch.zeros_like(x), wo,
                        vec)
        else:
            got = _attn(k3.fused_attn_out_ln, ctx, x, wo,
                        {**vec, name: _neutral(name, vec[name])})
    assert _f32_counts() == (*before[:2], before[2] + 1, *before[3:])
    worst, mean = _diff(got, want)
    assert worst > _F32_MAX_ATOL and mean > _F32_MEAN_ATOL, (worst, mean)


def test_f32_limits_refuse_tf32_operands(cuda):
    # the plain version with its operands rounded to TF32 in the kernel's
    # place: the f32 limits must tell it from the f32 kernel
    z, w, vec = _f32_ffn_inputs(4096, cuda, seed=5)
    with _tf32(False):
        want = _ffn(kffn.ffn_ln_plain, z, w, vec)
    with _tf32(True):
        worst, mean = _diff(_ffn(kffn.ffn_ln_plain, z, w, vec), want)
    assert worst > _F32_MAX_ATOL and mean > _F32_MEAN_ATOL, (worst, mean)


@pytest.mark.parametrize("fused_attn_out", [False, True],
                         ids=["default", "fused_attn_out"])
def test_f32_predict_launches_the_f32_kernels(cuda, fused_attn_out):
    """An f32 model (training.compute_dtype=float32) at full width,
    predict_batch at B=8: K1-f32 in all 12 layers, or K3-f32 and K2-f32 in
    layers 0-10 and K1-f32 in the CLS-only last one (K4 for the images at
    image_size), no bf16 kernel and nothing on the plain gate; within
    1e-4 of every kernel forced off."""
    from multimodal_rare_disease_tpu_torch.config import resolve_config
    from multimodal_rare_disease_tpu_torch.inference.predictor import (
        MultimodalPredictor,
    )
    from multimodal_rare_disease_tpu_torch.inference.seeded_batch import (
        seeded_requests,
    )
    from multimodal_rare_disease_tpu_torch.models.classifier import (
        create_model,
    )

    over = ({"text_encoder.fused_attn_out": True, "data.image_size": 256}
            if fused_attn_out else {})
    cfg = resolve_config("default", {**over,
                                     "training.compute_dtype": "float32"})
    pred = MultimodalPredictor(cfg, create_model(cfg, device="cpu", seed=0),
                               cuda)
    images, texts = seeded_requests(8, seed=0)
    before = (_counts(), _f32_counts())
    with _tf32(False):
        res = pred.predict_batch(images, texts)
        torch.cuda.synchronize()
        got = (tuple(a - b for a, b in zip(_counts(), before[0])),
               tuple(a - b for a, b in zip(_f32_counts(), before[1])))
        with _all_plain():
            ref = pred.predict_batch(images, texts)
    if fused_attn_out:
        assert got == ((0, 0, 0, 1, 0, 0, 0), (1, 11, 11, 0, 0))
    else:
        assert got == ((0, 0, 0, 0, 0, 0, 0), (12, 0, 0, 0, 0))
    probs = np.array([list(r["all_probabilities"].values()) for r in res])
    plain = np.array([list(r["all_probabilities"].values()) for r in ref])
    assert np.isfinite(probs).all() and np.abs(probs - plain).max() <= 1e-4


# ---- the widths built besides 768: BERT-large's H = 1,024, the compact
# BERTs' 512, 256 and 128 (google-research/bert's BERT-Medium, -Mini and
# -Tiny), MiniLM's 384 (microsoft/MiniLM-L12-H384), 640 and 896, and
# 1,152, 1,280, 1,408 and 1,536 (microsoft/deberta-v2-xlarge's width),
# each with F = 4H: the forms of K1-K3 built for each width, in bf16 and
# f32, held to the limits of the H = 768 cases (the tests' ids name the
# width: `h1024`, `h512`, `h256`, `h128`, `h384`, `h640`, `h896`, `h1152`,
# `h1280`, `h1408`, `h1536`)

_WIDTHS = {1024: 4096, 512: 2048, 256: 1024, 128: 512, 384: 1536, 640: 2560,
           896: 3584, 1152: 4608, 1280: 5120, 1408: 5632, 1536: 6144}
_by_width = pytest.mark.parametrize("h", list(_WIDTHS),
                                    ids=[f"h{h}" for h in _WIDTHS])


def _width_counts(h):
    """K1, K2, K3, K1-f32, K2-f32 and K3-f32 launches at width h, and the
    two modules' plain-on-CUDA counts."""
    sfx = "" if h == 768 else f"_{h}"
    return (getattr(kffn, f"LAUNCHES_K1{sfx}"),
            getattr(kffn, f"LAUNCHES_K2{sfx}"), getattr(k3, f"LAUNCHES{sfx}"),
            getattr(kffn, f"LAUNCHES_K1_F32{sfx}"),
            getattr(kffn, f"LAUNCHES_K2_F32{sfx}"),
            getattr(k3, f"LAUNCHES_F32{sfx}"), kffn.PLAIN_ON_CUDA,
            k3.PLAIN_ON_CUDA)


def _width_inputs(m, dev, seed, dtype, h, f):
    """z (also x), ctx, (w1, w2), wo and the vectors, all in `dtype` (the
    model's), at the scales of _ffn_inputs."""
    t = _rng_tensor(np.random.default_rng(seed), dev)
    vec = dict(b1=t((f,), 0.5, dtype=dtype), b2=t((h,), 0.5, dtype=dtype),
               gamma=t((h,), 0.25, 1.0, dtype=dtype),
               beta=t((h,), 0.5, dtype=dtype),
               pre_gamma=t((h,), 0.25, 1.0, dtype=dtype),
               pre_beta=t((h,), 0.5, dtype=dtype))
    return (t((m, h), 1.0, dtype=dtype), t((m, h), 1.0, dtype=dtype),
            (t((h, f), 0.05, dtype=dtype), t((f, h), 0.05, dtype=dtype)),
            t((h, h), 0.05, dtype=dtype), vec)


def _limits(dtype):
    return ((_MAX_ATOL, _MEAN_ATOL) if dtype == torch.bfloat16
            else (_F32_MAX_ATOL, _F32_MEAN_ATOL))


def _check_ffn(cuda, h, f, dtype, input_ln, m, seed):
    """K1 (input_ln) or K2 at width h and intermediate width f against its
    plain version: one launch of that form and nothing else, within the
    limits of its dtype."""
    z, _, w, _, vec = _width_inputs(m, cuda, seed, dtype, h, f)
    before = _width_counts(h)
    with _tf32(False):
        got = _ffn(kffn.fused_ffn_ln, z, w, vec, input_ln)
        want = _ffn(kffn.ffn_ln_plain, z, w, vec, input_ln)
    moved = tuple(a - b for a, b in zip(_width_counts(h), before))
    slot = (0 if input_ln else 1) + (3 if dtype == torch.float32 else 0)
    assert moved == tuple(int(i == slot) for i in range(8))
    worst, mean = _diff(got, want)
    tol = _limits(dtype)
    assert worst <= tol[0] and mean <= tol[1], (worst, mean)


# the single request (1, then its length bucket 64: the split paths), a
# ragged 64-row tile, the 1,024 CLS rows, the packed batch and a ragged tile
# past it
_WIDTH_ROWS = [1, 37, 64, 1024, 16384, 16385]


@pytest.mark.parametrize("m", _WIDTH_ROWS)
@pytest.mark.parametrize("input_ln", [True, False], ids=["k1", "k2"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@_by_width
def test_width_ffn_kernel_matches_plain(cuda, h, dtype, input_ln, m):
    _check_ffn(cuda, h, _WIDTHS[h], dtype, input_ln, m, m + input_ln)


# the pair forms at odd counts: 17 row tiles (1,088 rows, F split in
# slices), the 257 of a ragged tile past the packed batch, and an odd
# number of F chunks (F = 4H - 64), which at 896 and 1,024 gives the
# pair's first block one chunk more than the second (the blocks take turns
# at chunks), and at a single request's 64 rows leaves slices of one chunk,
# where the second block has none
_PAIR_ODD = [(1088, 0), (16385, 0), (16385, 64), (64, 64)]


@pytest.mark.parametrize("m,less", _PAIR_ODD,
                         ids=[f"m{m}-f{'4h' if not d else '4h-64'}"
                              for m, d in _PAIR_ODD])
@pytest.mark.parametrize("input_ln", [True, False], ids=["k1", "k2"])
@pytest.mark.parametrize("h", [1024, 1536], ids=["h1024", "h1536"])
def test_pair_ffn_kernel_at_odd_tile_and_chunk_counts(cuda, h, input_ln, m,
                                                      less):
    _check_ffn(cuda, h, 4 * h - less, torch.bfloat16, input_ln, m,
               3 * m + less + input_ln)


# the one-block forms below 768 at odd counts: an odd number of F chunks
# (F = 4H - 64) in one slice (16,385 rows, 257 tiles) and in slices (1,088
# rows, 17 tiles; 65, 127 and 129 rows, one and two tiles), which reuse
# stage 1's products slots and the GELU chunk buffers an odd number of
# times; and F = 4H at the odd tile counts. Each launch twice, with the
# same bits both times (no atomics).
_NARROW_ODD = [(16385, 64), (1088, 64), (65, 64), (127, 64), (129, 64),
               (65, 0), (127, 0), (129, 0), (1088, 0)]


@pytest.mark.parametrize("m,less", _NARROW_ODD,
                         ids=[f"m{m}-f{'4h' if not d else '4h-64'}"
                              for m, d in _NARROW_ODD])
@pytest.mark.parametrize("input_ln", [True, False], ids=["k1", "k2"])
@pytest.mark.parametrize("h", [128, 256, 384, 512, 640],
                         ids=["h128", "h256", "h384", "h512", "h640"])
def test_narrow_ffn_kernel_at_odd_tile_and_chunk_counts(cuda, h, input_ln, m,
                                                        less):
    _check_ffn(cuda, h, 4 * h - less, torch.bfloat16, input_ln, m,
               5 * m + less + input_ln)
    z, _, w, _, vec = _width_inputs(m, cuda, 5 * m + less + input_ln,
                                    torch.bfloat16, h, 4 * h - less)
    first = _ffn(kffn.fused_ffn_ln, z, w, vec, input_ln)
    assert torch.equal(first, _ffn(kffn.fused_ffn_ln, z, w, vec, input_ln))


# F other than 4H at every built width, 768 included: the gates take any F
# in chunks of 64 (bf16) or tiles of 128 (f32). One chunk; 24 chunks; 47
# chunks, which only 1 or 47 slices divide (47 at a single request's 64
# rows); f32 12 column tiles of h . W1
_OTHER_F = [(torch.bfloat16, 64), (torch.bfloat16, 1536),
            (torch.bfloat16, 3008), (torch.float32, 1536)]


@pytest.mark.parametrize("m", [64, 16384])
@pytest.mark.parametrize("input_ln", [True, False], ids=["k1", "k2"])
@pytest.mark.parametrize("dtype,f", _OTHER_F,
                         ids=[f"{'bf16' if d == torch.bfloat16 else 'f32'}"
                              f"-f{f}" for d, f in _OTHER_F])
@pytest.mark.parametrize("h", [128, 256, 384, 512, 640, 768, 896, 1024,
                               1152, 1280, 1408, 1536],
                         ids=["h128", "h256", "h384", "h512", "h640", "h768",
                              "h896", "h1024", "h1152", "h1280", "h1408",
                              "h1536"])
def test_width_ffn_kernel_at_other_intermediate_widths(cuda, h, dtype, f,
                                                       input_ln, m):
    _check_ffn(cuda, h, f, dtype, input_ln, m, 7 * m + f + input_ln)


@pytest.mark.parametrize("m", _WIDTH_ROWS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@_by_width
def test_width_attn_out_kernel_matches_plain(cuda, h, dtype, m):
    x, ctx, _, wo, vec = _width_inputs(m, cuda, 100 + m, dtype, h,
                                       _WIDTHS[h])
    v3 = dict(bo=vec["b2"], gamma=vec["gamma"], beta=vec["beta"])
    before = _width_counts(h)
    with _tf32(False):
        got = _attn(k3.fused_attn_out_ln, ctx, x, wo, v3)
        want = _attn(k3.attn_out_ln_plain, ctx, x, wo, v3)
    moved = tuple(a - b for a, b in zip(_width_counts(h), before))
    slot = 2 if dtype == torch.bfloat16 else 5
    assert moved == tuple(int(i == slot) for i in range(8))
    worst, mean = _diff(got, want)
    tol = _limits(dtype)
    assert worst <= tol[0] and mean <= tol[1], (worst, mean)


@pytest.mark.parametrize("m", [1024, 16384], ids=["split", "whole"])
@_by_width
def test_width_kernels_are_deterministic(cuda, h, m):
    # the pairs at 1,024 and 896 add a row's four LayerNorm partials over
    # distributed shared memory in one order, a single block its two; the
    # split paths store f32 partials that split_reduce sums in slice
    # order; no atomics: the same bits on every launch
    f = _WIDTHS[h]
    z, ctx, w, wo, vec = _width_inputs(m, cuda, 9, torch.bfloat16, h, f)
    v3 = dict(bo=vec["b2"], gamma=vec["gamma"], beta=vec["beta"])
    for input_ln in (True, False):
        first = _ffn(kffn.fused_ffn_ln, z, w, vec, input_ln)
        assert torch.equal(first, _ffn(kffn.fused_ffn_ln, z, w, vec,
                                       input_ln))
    first = _attn(k3.fused_attn_out_ln, ctx, z, wo, v3)
    assert torch.equal(first, _attn(k3.fused_attn_out_ln, ctx, z, wo, v3))
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert (kffn.ffn_plan(m, f, n_sm, h).slices > 1) == (m == 1024)


@pytest.mark.parametrize("name", ["b1", "b2", "gamma", "beta", "pre_gamma",
                                  "pre_beta"])
@_by_width
def test_width_check_fails_a_kernel_that_drops_a_vector(cuda, h, name):
    # LN2 (at 1,024 the pair's, over distributed shared memory) carries
    # every term
    z, _, w, _, vec = _width_inputs(256, cuda, 7, torch.bfloat16, h,
                                    _WIDTHS[h])
    dropped = {**vec, name: _neutral(name, vec[name])}
    worst, mean = _diff(_ffn(kffn.fused_ffn_ln, z, w, dropped),
                        _ffn(kffn.ffn_ln_plain, z, w, vec))
    assert worst > _MAX_ATOL and mean > _MEAN_ATOL, (worst, mean)


@pytest.mark.parametrize("fused_attn_out", [False, True],
                         ids=["default", "fused_attn_out"])
@_by_width
def test_width_predict_launches_the_width_kernels(cuda, h, fused_attn_out):
    """A model at width h (heads of 64, F = 4H; 2 layers here, BERT-Tiny's
    full depth at 128) in bf16, predict_batch at B=8: K1 at width h in
    both layers, or K3 and K2 in layer 0 and K1 in the CLS-only last one
    (K4 for the images at image_size), no H = 768 kernel and nothing on
    the plain gate; within phase 4's 2.5e-3 of every kernel forced
    off."""
    from multimodal_rare_disease_tpu_torch.config import resolve_config
    from multimodal_rare_disease_tpu_torch.inference.predictor import (
        MultimodalPredictor,
    )
    from multimodal_rare_disease_tpu_torch.inference.seeded_batch import (
        seeded_requests,
    )
    from multimodal_rare_disease_tpu_torch.models.classifier import (
        create_model,
    )

    over = ({"text_encoder.fused_attn_out": True, "data.image_size": 256}
            if fused_attn_out else {})
    cfg = resolve_config("default", {
        **over, "text_encoder.hidden_size": h,
        "text_encoder.num_layers": 2, "text_encoder.num_heads": h // 64,
        "text_encoder.intermediate_size": _WIDTHS[h],
        "text_encoder.max_position_embeddings": 512})
    pred = MultimodalPredictor(cfg, create_model(cfg, device="cpu", seed=0),
                               cuda)
    images, texts = seeded_requests(8, seed=0)
    before = (_counts(), _width_counts(h))
    res = pred.predict_batch(images, texts)
    torch.cuda.synchronize()
    got = (tuple(a - b for a, b in zip(_counts(), before[0])),
           tuple(a - b for a, b in zip(_width_counts(h), before[1])))
    with _all_plain():
        ref = pred.predict_batch(images, texts)
    if fused_attn_out:
        assert got == ((0, 0, 0, 1, 0, 0, 0), (1, 1, 1, 0, 0, 0, 0, 0))
    else:
        assert got == ((0,) * 7, (2, 0, 0, 0, 0, 0, 0, 0))
    probs = np.array([list(r["all_probabilities"].values()) for r in res])
    plain = np.array([list(r["all_probabilities"].values()) for r in ref])
    assert np.isfinite(probs).all() and np.abs(probs - plain).max() <= 2.5e-3


# K3's cluster forms (H = 896-1,536). At the packed batch the whole k loop
# runs on the persistent clusters of four (a block: 128 rows by a quarter
# of the columns): 16,384 rows, a ragged last tile, and 64 x 257 rows,
# whose last group of 128 has a 64-row tile past M; 8,448 rows, where the
# launch may take the pair instead (fewer waves); a single request's 64
# rows take the pair's split path. Each launch twice, with the same bits (the
# row statistics are summed over the cluster in one order, no atomics).
_CLUSTER_WIDTHS = [896, 1024, 1152, 1280, 1408, 1536]
_by_cluster_width = pytest.mark.parametrize(
    "h", _CLUSTER_WIDTHS, ids=[f"h{h}" for h in _CLUSTER_WIDTHS])


@pytest.mark.parametrize("m", [16384, 16384 - 37, 64 * 257, 8448, 64])
@_by_cluster_width
def test_cluster_attn_out_kernel_matches_plain(cuda, h, m):
    x, ctx, _, wo, vec = _width_inputs(m, cuda, 300 + m, torch.bfloat16, h,
                                       _WIDTHS[h])
    v3 = dict(bo=vec["b2"], gamma=vec["gamma"], beta=vec["beta"])
    before = _width_counts(h)
    got = _attn(k3.fused_attn_out_ln, ctx, x, wo, v3)
    again = _attn(k3.fused_attn_out_ln, ctx, x, wo, v3)
    want = _attn(k3.attn_out_ln_plain, ctx, x, wo, v3)
    moved = tuple(a - b for a, b in zip(_width_counts(h), before))
    assert moved == (0, 0, 2, 0, 0, 0, 0, 0)
    assert torch.equal(got, again)
    worst, mean = _diff(got, want)
    assert worst <= _MAX_ATOL and mean <= _MEAN_ATOL, (worst, mean)
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert (k3.attn_out_plan(m, n_sm, h).slices > 1) == (m == 64)


@pytest.mark.parametrize("name", ["bo", "gamma", "beta", "x"])
@_by_cluster_width
def test_cluster_attn_out_check_fails_a_kernel_that_drops_a_term(cuda, h,
                                                                 name):
    # the packed batch's 16,384 rows, 128 groups of 128 over the resident
    # clusters of four (each walks four or five); a neutral bo / gamma /
    # beta, or a zero residual x, stands for a kernel that leaves the term
    # out
    x, ctx, _, wo, vec = _width_inputs(16384, cuda, 11, torch.bfloat16, h,
                                       _WIDTHS[h])
    v3 = dict(bo=vec["b2"], gamma=vec["gamma"], beta=vec["beta"])
    want = _attn(k3.attn_out_ln_plain, ctx, x, wo, v3)
    if name == "x":
        got = _attn(k3.fused_attn_out_ln, ctx, torch.zeros_like(x), wo, v3)
    else:
        got = _attn(k3.fused_attn_out_ln, ctx, x, wo,
                    {**v3, name: _neutral(name, v3[name])})
    worst, mean = _diff(got, want)
    assert worst > _MAX_ATOL and mean > _MEAN_ATOL, (worst, mean)


# K3-f32's narrow forms (H = 128-640). Where the plan leaves the k loop
# whole, a call is one pass over whole rows: persistent clusters of H / 128
# blocks, each block 128 rows by 128 columns, the LayerNorm's row sums
# exchanged over distributed shared memory (csrc/attn_out_rows_f32.cuh):
# the packed batch's 16,384 rows, a ragged last tile (16,347), 33 row tiles
# (4,224: two rounds at 640; the three-launch form at 512, whose one wave
# of tiles beats two rounds of clusters there), an Evaluator batch (2,048;
# the three-launch form at 512, whose plan splits the k loop there) and a
# single request's 64 rows (the three-launch form at 512 and 640). Each
# launch twice, with the same bits (the blocks' partials are added in rank
# order; no atomics).
_NARROW_WIDTHS = [128, 256, 384, 512, 640]
_by_narrow_width = pytest.mark.parametrize(
    "h", _NARROW_WIDTHS, ids=[f"f32narrow-h{h}" for h in _NARROW_WIDTHS])


@pytest.mark.parametrize("m", [16384, 16347, 4224, 2048, 64])
@_by_narrow_width
def test_f32_narrow_attn_out_kernel_matches_plain(cuda, h, m):
    x, ctx, _, wo, vec = _width_inputs(m, cuda, 500 + m, torch.float32, h,
                                       _WIDTHS[h])
    v3 = dict(bo=vec["b2"], gamma=vec["gamma"], beta=vec["beta"])
    before = _width_counts(h)
    with _tf32(False):
        got = _attn(k3.fused_attn_out_ln, ctx, x, wo, v3)
        again = _attn(k3.fused_attn_out_ln, ctx, x, wo, v3)
        want = _attn(k3.attn_out_ln_plain, ctx, x, wo, v3)
    moved = tuple(a - b for a, b in zip(_width_counts(h), before))
    assert moved == (0, 0, 0, 0, 0, 2, 0, 0)
    assert torch.equal(got, again)
    worst, mean = _diff(got, want)
    assert worst <= _F32_MAX_ATOL and mean <= _F32_MEAN_ATOL, (worst, mean)
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    resident = k3.f32_rows_clusters(cuda, h)
    assert resident >= 1
    assert k3.attn_out_plan_f32(m, n_sm, h, resident).rows == (
        h <= 384 or m >= 16347 or (h == 640 and m >= 2048))


@pytest.mark.parametrize("name", ["bo", "gamma", "beta", "x"])
@_by_narrow_width
def test_f32_narrow_check_fails_a_kernel_that_drops_a_term(cuda, h, name):
    # the packed batch's 128 row tiles over the resident clusters; a
    # neutral bo / gamma / beta, or a zero residual x, stands for a kernel
    # that leaves the term out: the f32 limits must refuse it
    x, ctx, _, wo, vec = _width_inputs(16384, cuda, 13, torch.float32, h,
                                       _WIDTHS[h])
    v3 = dict(bo=vec["b2"], gamma=vec["gamma"], beta=vec["beta"])
    with _tf32(False):
        want = _attn(k3.attn_out_ln_plain, ctx, x, wo, v3)
        if name == "x":
            got = _attn(k3.fused_attn_out_ln, ctx, torch.zeros_like(x), wo,
                        v3)
        else:
            got = _attn(k3.fused_attn_out_ln, ctx, x, wo,
                        {**v3, name: _neutral(name, v3[name])})
    worst, mean = _diff(got, want)
    assert worst > _F32_MAX_ATOL and mean > _F32_MEAN_ATOL, (worst, mean)


@pytest.mark.parametrize("left_out", [0, -1], ids=["first", "last"])
@pytest.mark.parametrize("h", _NARROW_WIDTHS[1:],
                         ids=[f"f32narrow-h{h}" for h in _NARROW_WIDTHS[1:]])
def test_f32_narrow_check_fails_a_block_left_out_of_the_exchange(cuda, h,
                                                                 left_out):
    # the pre-LayerNorm rows, summed in f32 by torch, normalized with row
    # statistics that miss one block's 128 columns, as a cluster whose
    # exchange left a peer's partials out would, held against the kernel:
    # the f32 limits must refuse it
    x, ctx, _, wo, vec = _width_inputs(16384, cuda, 17, torch.float32, h,
                                       _WIDTHS[h])
    v3 = dict(bo=vec["b2"], gamma=vec["gamma"], beta=vec["beta"])
    with _tf32(False):
        got = _attn(k3.fused_attn_out_ln, ctx, x, wo, v3)
        z = ctx @ wo + v3["bo"] + x
    cols = torch.ones(h, dtype=torch.bool, device=cuda)
    block = (h // 128 + left_out) % (h // 128)
    cols[128 * block:128 * (block + 1)] = False
    mu = z[:, cols].sum(1, keepdim=True) / h
    var = ((z - mu)[:, cols] ** 2).sum(1, keepdim=True) / h
    wrong = (z - mu) * torch.rsqrt(var + 1e-12) * v3["gamma"] + v3["beta"]
    worst, mean = _diff(wrong, got)
    assert worst > _F32_MAX_ATOL and mean > _F32_MEAN_ATOL, (worst, mean)


# K1-f32's and K2-f32's one-pass form (H = 128 and 256): one block per row
# tile of 128 that keeps h on the chip (csrc/ffn_rows_f32.cuh). Forced
# (kffn.FORCE_F32_ROWS) at every row count, and left to the rule, which
# takes it for the packed batch and past it: a single request (1, then its
# length bucket 64), the 1,024 CLS rows, the packed batch, a ragged tile
# past it and 64 x 257 rows. Each launch twice, with the same bits (no
# atomics).
_FFN_ROWS_WIDTHS = [128, 256]
_FFN_ROWS_M = [1, 64, 1024, 16384, 16385, 64 * 257]


@contextlib.contextmanager
def _ffn_rows_forced(forced):
    old = kffn.FORCE_F32_ROWS
    kffn.FORCE_F32_ROWS = forced
    try:
        yield
    finally:
        kffn.FORCE_F32_ROWS = old


@pytest.mark.parametrize("form", ["forced", "rule"])
@pytest.mark.parametrize("m", _FFN_ROWS_M)
@pytest.mark.parametrize("h", _FFN_ROWS_WIDTHS,
                         ids=[f"f32ffnrows-h{h}" for h in _FFN_ROWS_WIDTHS])
@pytest.mark.parametrize("input_ln", [True, False], ids=["k1", "k2"])
def test_f32_ffn_rows_kernel_matches_plain(cuda, input_ln, h, m, form):
    z, _, w, _, vec = _width_inputs(m, cuda, 700 + m, torch.float32, h,
                                    _WIDTHS[h])
    before = _width_counts(h)
    with _tf32(False), _ffn_rows_forced(True if form == "forced" else None):
        got = _ffn(kffn.fused_ffn_ln, z, w, vec, input_ln)
        again = _ffn(kffn.fused_ffn_ln, z, w, vec, input_ln)
        want = _ffn(kffn.ffn_ln_plain, z, w, vec, input_ln)
    moved = tuple(a - b for a, b in zip(_width_counts(h), before))
    assert moved == (0, 0, 0, 2 * input_ln, 2 * (not input_ln), 0, 0, 0)
    assert torch.equal(got, again)
    worst, mean = _diff(got, want)
    assert worst <= _F32_MAX_ATOL and mean <= _F32_MEAN_ATOL, (worst, mean)
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert kffn.ffn_plan_f32(m, _WIDTHS[h], n_sm, h).rows == (m >= 16384)


_FFN_ROWS_DROPS = [(True, n) for n in ("b2", "gamma", "beta", "ln0",
                                         "cross")] + \
    [(False, n) for n in ("b2", "gamma", "beta", "cross")]


@pytest.mark.parametrize("input_ln,name", _FFN_ROWS_DROPS,
                         ids=[f"{'k1' if k else 'k2'}-{n}"
                              for k, n in _FFN_ROWS_DROPS])
@pytest.mark.parametrize("h", _FFN_ROWS_WIDTHS,
                         ids=[f"f32ffnrows-h{h}" for h in _FFN_ROWS_WIDTHS])
def test_f32_ffn_rows_check_fails_a_kernel_that_drops_a_term(
        cuda, h, input_ln, name):
    # the packed batch in the one-pass form; a neutral b2 / gamma / beta,
    # K1 held to the plain K1 with its input LayerNorm left out (the
    # kernel's K2 on the same rows), or the TF32 product that drops the
    # 3xTF32 cross terms (the plain version with TF32 on) stands for a
    # kernel that leaves the term out: the f32 limits must refuse it
    z, _, w, _, vec = _width_inputs(16384, cuda, 19, torch.float32, h,
                                    _WIDTHS[h])
    with _ffn_rows_forced(True):
        with _tf32(False):
            want = _ffn(kffn.ffn_ln_plain, z, w, vec, input_ln)
            if name == "ln0":
                got = _ffn(kffn.fused_ffn_ln, z, w, vec, False)
            elif name != "cross":
                got = _ffn(kffn.fused_ffn_ln, z, w,
                           {**vec, name: _neutral(name, vec[name])},
                           input_ln)
        if name == "cross":
            with _tf32(True):
                got = _ffn(kffn.ffn_ln_plain, z, w, vec, input_ln)
    worst, mean = _diff(got, want)
    assert worst > _F32_MAX_ATOL and mean > _F32_MEAN_ATOL, (worst, mean)


# K3's overlapped form at 640 and tile form at 128
# (csrc/attn_out_ln_overlap.cu): at 640 persistent clusters of two blocks
# of 128 rows by 320 columns on n160 Wo tiles, at 128 one block per 64-row
# tile with x loaded up front, three blocks an SM. At 640 forced
# (k3.FORCE_OVERLAP) at every row count, and left to the rule, which takes
# it where the plan leaves the k loop whole (from 7,553 rows) and keeps
# the one-block form's split path below; at 128 the tile form at every
# row count, the width's only form. The counts: a single request (1, then
# its length bucket 64), 37 rows, the 1,024 CLS rows, 4,096, 8,448, the
# packed batch and a ragged tile past it. Each launch twice, with the same
# bits, and, at 640 where the one-block form runs the whole k loop too
# (7,553 rows up), its bits (each element's k16 steps in the same order,
# the row sums added as there).
_OVERLAP_WIDTHS = [128, 640]
_OVERLAP_M = [1, 37, 64, 1024, 4096, 8448, 16384, 16385]
_OVERLAP_CASES = [(h, m, form) for h in _OVERLAP_WIDTHS for m in _OVERLAP_M
                  for form in (("forced", "rule") if h == 640 else ("rule",))]


@contextlib.contextmanager
def _overlap_forced(forced):
    old = k3.FORCE_OVERLAP
    k3.FORCE_OVERLAP = forced
    try:
        yield
    finally:
        k3.FORCE_OVERLAP = old


@pytest.mark.parametrize("h,m,form", _OVERLAP_CASES,
                         ids=[f"overlap-h{h}-{m}-{form}"
                              for h, m, form in _OVERLAP_CASES])
def test_overlap_attn_out_kernel_matches_plain(cuda, h, m, form):
    x, ctx, _, wo, vec = _width_inputs(m, cuda, 900 + m, torch.bfloat16, h,
                                       _WIDTHS[h])
    v3 = dict(bo=vec["b2"], gamma=vec["gamma"], beta=vec["beta"])
    before, calls = _width_counts(h), k3.OVERLAP_CALLS
    with _overlap_forced(True if form == "forced" else None):
        got = _attn(k3.fused_attn_out_ln, ctx, x, wo, v3)
        again = _attn(k3.fused_attn_out_ln, ctx, x, wo, v3)
    moved = tuple(a - b for a, b in zip(_width_counts(h), before))
    assert moved == (0, 0, 2, 0, 0, 0, 0, 0)
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    slices = k3.attn_out_plan(m, n_sm, h).slices
    taken = h == 128 or form == "forced" or k3.overlap_form(h, slices)
    assert taken == (h == 128 or form == "forced" or m >= 8448)
    assert k3.OVERLAP_CALLS - calls == (2 if taken else 0)
    assert torch.equal(got, again)
    if h == 640 and slices == 1:  # the one-block form's whole k loop
        with _overlap_forced(False):
            parent = _attn(k3.fused_attn_out_ln, ctx, x, wo, v3)
        assert torch.equal(got, parent)
    worst, mean = _diff(got, _attn(k3.attn_out_ln_plain, ctx, x, wo, v3))
    assert worst <= _MAX_ATOL and mean <= _MEAN_ATOL, (worst, mean)


@pytest.mark.parametrize("name", ["bo", "gamma", "beta", "x"])
@pytest.mark.parametrize("h", _OVERLAP_WIDTHS,
                         ids=[f"overlap-h{h}" for h in _OVERLAP_WIDTHS])
def test_overlap_check_fails_a_kernel_that_drops_a_term(cuda, h, name):
    # the packed batch in the overlapped form (at 640 its 128 groups of
    # 128 rows over the resident clusters of two, two rounds); a neutral bo
    # / gamma / beta, or a zero residual x, stands for a kernel that leaves
    # the term out
    x, ctx, _, wo, vec = _width_inputs(16384, cuda, 23, torch.bfloat16, h,
                                       _WIDTHS[h])
    v3 = dict(bo=vec["b2"], gamma=vec["gamma"], beta=vec["beta"])
    want = _attn(k3.attn_out_ln_plain, ctx, x, wo, v3)
    calls = k3.OVERLAP_CALLS
    if name == "x":
        got = _attn(k3.fused_attn_out_ln, ctx, torch.zeros_like(x), wo, v3)
    else:
        got = _attn(k3.fused_attn_out_ln, ctx, x, wo,
                    {**v3, name: _neutral(name, v3[name])})
    assert k3.OVERLAP_CALLS == calls + 1
    worst, mean = _diff(got, want)
    assert worst > _MAX_ATOL and mean > _MEAN_ATOL, (worst, mean)
