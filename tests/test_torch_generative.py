"""The torch package's conv VAE (`data/generative.py`) and
`cli/generate_synthetic.py` against the JAX package's on the CPU: the
forward with explicit noise on the JAX weights (1e-5), one Adam step of
the JAX training loop (loss, first moments, parameters), the corpus
resize, the cosine schedule, a short training whose loss falls, and the
generator API and CLI."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_rare_disease_tpu.data import generative as jg
from multimodal_rare_disease_tpu_torch.cli import generate_synthetic
from multimodal_rare_disease_tpu_torch.data import generative as tg
from multimodal_rare_disease_tpu_torch.data.images import scan_image_corpus
from multimodal_rare_disease_tpu_torch.models.convert import (
    state_dict_from_jax,
)

ATOL = 1e-5  # f32 on the CPU, same weights, inputs and noise


def _corpus(n_per_class=2, size=64, seed=0):
    """Per-class mean colours plus noise, as tests/test_generative.py."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(40, 220, (10, 3))
    labels = np.repeat(np.arange(10), n_per_class)
    imgs = np.clip(means[labels][:, None, None, :]
                   + rng.normal(0, 10, (len(labels), size, size, 3)), 0,
                   255).astype(np.uint8)
    return imgs, labels, means


def _pair(seed=0):
    """The JAX VAE's params and the port's VAE on the same weights."""
    model = jg.ConvVAE(latent_dim=64, num_classes=10)
    key = jax.random.key(seed)
    x = jnp.zeros((1, 64, 64, 3))
    params = model.init(key, x, jnp.zeros((1,), jnp.int32), key)["params"]
    vae = tg.ConvVAE(device="cpu")
    vae.load_state_dict(state_dict_from_jax(jax.device_get(params)),
                        strict=True)
    return model, params, vae


def test_forward_with_explicit_noise_matches_jax():
    model, params, vae = _pair(1)
    imgs, labels, _ = _corpus()
    x = imgs.astype(np.float32) / 255.0
    key = jax.random.key(7)
    want = model.apply({"params": params}, jnp.asarray(x),
                       jnp.asarray(labels), key)
    eps = np.array(jax.random.normal(key, (len(labels), 64)))
    with torch.no_grad():
        got = vae(torch.from_numpy(x), torch.from_numpy(labels),
                  torch.from_numpy(eps))
    for g, w in zip(got, want):  # recon, mu, logvar
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0)


def test_one_train_step_matches_jax():
    """One step of the JAX loop (loss, grads, optax.adam over
    cosine_decay_schedule) against `vae_step` from the same weights and
    noise. Adam's first update is lr·g/(|g| + eps): gradients that
    differ by round-off move a parameter by up to 2·lr (ROADMAP D7), so
    the step runs at lr 4e-6, and the first moments (0.1·g) carry the
    gradient comparison for the decoder, each within 1e-4 of its largest
    (f32 sums of up to 20·64·64 products taken in another order: about
    eps·sqrt(81,920) = 1.7e-5 of the summed magnitudes). Below the decoder, one of the
    655,360 pre-activations of enc1 sits at round-off distance from 0
    and its ReLU takes the other branch in the port than in XLA (and
    than in float64), which moves the encoder's moments by up to 0.4% of
    their largest (ROADMAP D15); the step's parameters hold there."""
    lr, epochs, kl_weight = 4e-6, 400, 1e-3
    model, params, vae = _pair(2)
    imgs, labels, _ = _corpus(seed=3)
    x = jnp.asarray(imgs, jnp.float32) / 255.0
    y = jnp.asarray(labels, jnp.int32)
    key = jax.random.key(9)

    def loss_fn(p):
        recon, mu, logvar = model.apply({"params": p}, x, y, key)
        rec = jnp.mean(jnp.sum((recon - x) ** 2, axis=(1, 2, 3)))
        kl = jnp.mean(-0.5 * jnp.sum(
            1 + logvar - mu ** 2 - jnp.exp(logvar), axis=-1))
        return rec + kl_weight * kl

    tx = optax.adam(optax.cosine_decay_schedule(lr, epochs))
    opt_state = tx.init(params)
    loss, grads = jax.value_and_grad(loss_fn)(params)
    updates, opt_state = tx.update(grads, opt_state, params)
    new_params = optax.apply_updates(params, updates)

    opt = torch.optim.Adam(vae.parameters(), lr=lr)
    eps = torch.from_numpy(np.array(jax.random.normal(key, (20, 64))))
    got_loss = tg.vae_step(vae, opt, tg.corpus_tensor(imgs, "cpu"),
                           torch.from_numpy(labels), eps,
                           tg.cosine_decay(lr, 0, epochs), kl_weight)
    assert abs(float(got_loss) - float(loss)) <= 1e-6 * float(loss)
    want_sd = state_dict_from_jax(jax.device_get(new_params))
    mu_sd = state_dict_from_jax(jax.device_get(opt_state[0].mu))
    for name, p in vae.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   want_sd[name].numpy(), atol=ATOL, rtol=0)
        if name.startswith(("dec", "cls_embed")):
            want_m = mu_sd[name].numpy()
            np.testing.assert_allclose(opt.state[p]["exp_avg"].numpy(),
                                       want_m,
                                       atol=1e-4 * np.abs(want_m).max(),
                                       rtol=0)


def test_corpus_resize_matches_jax_image_resize():
    imgs, _, _ = _corpus(1, size=80, seed=4)
    want = jax.image.resize(jnp.asarray(imgs, jnp.float32) / 255.0,
                            (10, 64, 64, 3), "bilinear")
    np.testing.assert_allclose(tg.corpus_tensor(imgs, "cpu").numpy(),
                               np.asarray(want), atol=ATOL, rtol=0)


def test_cosine_decay_equals_optax():
    """optax evaluates the schedule in f32: within a few f32 ulps of lr
    (1 + cos cancels near the end of the decay)."""
    sched = optax.cosine_decay_schedule(2e-3, 400)
    for step in (0, 1, 57, 200, 399, 400, 450):
        assert tg.cosine_decay(2e-3, step, 400) == pytest.approx(
            float(sched(step)), rel=1e-6, abs=1e-9)


def test_train_vae_loss_falls_and_generates(tmp_path):
    """30 epochs over one image per class at lr 4e-3: the loss falls
    below 0.8 of the first epoch's (0.71 on this corpus)."""
    imgs, labels, _ = _corpus(n_per_class=1, seed=5)
    _, loss0 = tg.train_vae(imgs, labels, num_epochs=1, seed=1, lr=4e-3,
                            device="cpu")
    model, loss = tg.train_vae(imgs, labels, num_epochs=30, seed=1,
                               lr=4e-3, device="cpu")
    assert np.isfinite(loss) and loss < 0.8 * loss0
    # seeded: the same run gives the same weights
    a, b = (tg.train_vae(imgs, labels, num_epochs=3, seed=2,
                         device="cpu")[0] for _ in range(2))
    assert all(torch.equal(x, y) for x, y in
               zip(a.state_dict().values(), b.state_dict().values()))
    gen = tg.VAEImageGenerator(model, image_size=96, seed=3)
    a = gen.generate(0, 0)
    assert a.shape == (96, 96, 3) and a.dtype == np.uint8
    np.testing.assert_array_equal(a, gen.generate(0, 0))
    assert len(gen.generate_for_syndrome(
        "Angelman Syndrome", 2)) == 2
    written = gen.generate_dataset(tmp_path, num_per_class=1)
    assert sum(len(v) for v in written.values()) == 10
    assert len(scan_image_corpus(tmp_path)) == 10


def test_generate_matches_jax_on_the_same_weights():
    """The decode of the seeded latent, resized to 96 px by the numpy
    bilinear (JAX: PIL): uint8 within one step of rounding."""
    model, params, vae = _pair(6)
    jgen = jg.VAEImageGenerator(model, params, image_size=96, seed=4)
    tgen = tg.VAEImageGenerator(vae, image_size=96, seed=4)
    for cls, i in ((0, 0), (7, 3)):
        d = np.abs(tgen.generate(cls, i).astype(int)
                   - jgen.generate(cls, i).astype(int))
        assert d.max() <= 1 and d.mean() < 0.01


@pytest.mark.parametrize("backend", ["procedural", "vae"])
def test_generate_synthetic_cli(tmp_path, capsys, backend):
    from multimodal_rare_disease_tpu.cli import generate_synthetic as jcli

    args = ["--num", "1", "--size", "48", "--seed", "3"]
    if backend == "vae":
        src = tmp_path / "src"
        assert generate_synthetic.main(["--outdir", str(src), "--num", "1",
                                        "--size", "64", "--device",
                                        "cpu"]) == 0
        args += ["--backend", "vae", "--image-dir", str(src), "--epochs",
                 "3"]
    out = tmp_path / "out"
    assert generate_synthetic.main(["--outdir", str(out), *args,
                                    "--device", "cpu"]) == 0
    assert len(scan_image_corpus(out)) == 10
    if backend == "procedural":  # the same files as the JAX CLI's
        assert jcli.main(["--outdir", str(tmp_path / "j"), *args,
                          "--platform", "cpu"]) == 0
        for p in sorted(out.iterdir()):
            assert p.read_bytes() == (tmp_path / "j" / p.name).read_bytes()
    elif not torch.cuda.is_available():  # the card by default, no fallback
        with pytest.raises(RuntimeError, match="no CUDA device"):
            generate_synthetic.main(["--outdir", str(tmp_path / "x"), *args])
