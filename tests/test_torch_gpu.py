"""The torch package's CUDA kernels on the card. Every test here is
marked `gpu` and skips without a CUDA device; the file imports no jax,
so it runs on a machine that has only torch:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(`--noconftest`: tests/conftest.py configures jax for the CPU tier)."""

import numpy as np
import pytest
import torch

from multimodal_rare_disease_tpu_torch.kernels import ffn as k1

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


_VECTORS = ("b1", "b2", "gamma", "beta", "pre_gamma", "pre_beta")
# bf16 outputs of LayerNorm scale, |y| < 8 for these inputs: an element
# may land one bf16 ulp apart (1.6e-2 at |y| in [2, 4), 3.1e-2 in [4, 8))
# where the two versions' f32 sums, taken in another order, round x, the
# GELU chunk or y the other way. Max: the JAX kernel test's bf16 bound.
# Mean: such flips are rare (an H100 read 3e-7 to 3.3e-6); 1e-4 is 1/78
# of an ulp at |y| in [1, 2).
_MAX_ATOL, _MEAN_ATOL = 5e-2, 1e-4


def _inputs(m, dev, seed=0, h=768, f=3072, vec_dtype=torch.float32):
    """z, (w1, w2) and the six vectors: biases and shifts at the scale of
    the signal and LayerNorm scales at 1 +- 0.25, so that each term moves
    the output far past the tolerances."""
    rng = np.random.default_rng(seed)

    def t(shape, scale, offset=0.0, dtype=vec_dtype):
        a = (offset + rng.normal(size=shape) * scale).astype(np.float32)
        return torch.from_numpy(a).to(dev, dtype)

    bf = torch.bfloat16
    z = t((m, h), 1.0, dtype=bf)
    w = (t((h, f), 0.05, dtype=bf), t((f, h), 0.05, dtype=bf))
    vec = dict(b1=t((f,), 0.5), b2=t((h,), 0.5), gamma=t((h,), 0.25, 1.0),
               beta=t((h,), 0.5), pre_gamma=t((h,), 0.25, 1.0),
               pre_beta=t((h,), 0.5))
    return z, w, vec


def _ffn(fn, z, w, v):
    out = fn(z, w[0], v["b1"], w[1], v["b2"], v["gamma"], v["beta"],
             pre_gamma=v["pre_gamma"], pre_beta=v["pre_beta"])
    torch.cuda.synchronize()
    return out.float()


def _diff(got, want):
    d = (got - want).abs()
    return d.max().item(), d.mean().item()


@pytest.mark.parametrize("vec_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 37, 4096])
def test_ffn_kernel_matches_plain(cuda, m, vec_dtype):
    z, w, vec = _inputs(m, cuda, seed=m, vec_dtype=vec_dtype)
    before = k1.LAUNCHES
    got = _ffn(k1.fused_ffn_ln, z, w, vec)
    assert k1.LAUNCHES == before + 1
    worst, mean = _diff(got, _ffn(k1.ffn_ln_plain, z, w, vec))
    assert worst <= _MAX_ATOL and mean <= _MEAN_ATOL, (worst, mean)


@pytest.mark.parametrize("name", _VECTORS)
def test_ffn_check_fails_a_kernel_that_drops_a_vector(cuda, name):
    # the kernel given the vector's neutral value stands for a kernel that
    # leaves the term out; the plain version gets the real vector
    z, w, vec = _inputs(256, cuda, seed=7)
    v = vec[name]
    neutral = torch.ones_like(v) if "gamma" in name else torch.zeros_like(v)
    worst, mean = _diff(_ffn(k1.fused_ffn_ln, z, w, {**vec, name: neutral}),
                        _ffn(k1.ffn_ln_plain, z, w, vec))
    assert worst > _MAX_ATOL and mean > _MEAN_ATOL, (worst, mean)


def test_bert_layers_launch_the_kernel(cuda):
    from multimodal_rare_disease_tpu.config import resolve_config
    from multimodal_rare_disease_tpu_torch.inference.predictor import (
        MultimodalPredictor,
    )
    from multimodal_rare_disease_tpu_torch.models.classifier import (
        create_model,
    )

    cfg = resolve_config("default", {"text_encoder.num_layers": 2,
                                     "cnn_encoder.stage_sizes": (1, 1, 1, 1),
                                     "data.image_size": 64})
    pred = MultimodalPredictor(cfg, create_model(cfg, device="cpu"), cuda)
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (256, 256, 3), dtype=np.uint8)
            for _ in range(3)]
    before, plain = k1.LAUNCHES, k1.PLAIN_ON_CUDA
    out = pred.predict_batch(imgs, ["short text", "a longer clinical "
                                    "description of the face", "x"])
    torch.cuda.synchronize()
    assert k1.LAUNCHES - before == 2 and k1.PLAIN_ON_CUDA == plain
    assert len(out) == 3 and all(np.isfinite(
        list(r["all_probabilities"].values())).all() for r in out)
