"""Int8 serving (`text_encoder.quantized_inference`, models/quant.py) of
the torch package against the JAX package on the CPU: the quantize
functions and the int8 product bit for bit, the padded-rows path, the
quantized BERT tower (its int8 activation codes layer by layer, then its
outputs) on the classic, CLS-only and packed forwards and with hidden
states and attention maps, the parameter tree and train mode, the codes
of a bf16 predictor and of the Trainer's bf16 validation copy against
the JAX quantization of the f32 masters, and the multimodal predictor
in f32 and bf16."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_rare_disease_tpu.models import quant as jquant
from tests.test_torch_bert import _batch, _cfg, _pair, _t
from tests.test_torch_predictor import _SMALL, _requests
from tests.test_torch_predictor import _pair as _predictor_pair
from multimodal_rare_disease_tpu_torch.config import resolve_config
from multimodal_rare_disease_tpu_torch.inference.packing import pack_texts
from multimodal_rare_disease_tpu_torch.inference.predictor import (
    MultimodalPredictor,
)
from multimodal_rare_disease_tpu_torch.models import quant
from multimodal_rare_disease_tpu_torch.models import bert as tbert
from multimodal_rare_disease_tpu_torch.models.classifier import create_model
from multimodal_rare_disease_tpu_torch.models.layers import (
    set_dropout_generator,
)

# f32 on the CPU, same weights and inputs: the int8 codes agree (counted
# first), so what is left is the float work around them in another
# summation order. A forward that silently skipped quantization reads
# ~3e-3 from the JAX quantized one at this width (ROADMAP D24).
ATOL = 1e-5
# the JAX sharded-predict test's limits (tests/test_predict_sharded.py)
P_ATOL, P_RTOL = 2e-5, 2e-4
# bf16: the JAX limits hold in f32 only. On these requests the port's
# unquantized bf16 predictor reads 1.2e-3 (n=1) and 3.4e-3 (n=12) from
# the JAX one, bf16 rounding in another order in the image tower, fusion
# and head (ROADMAP O1, D25), and the quantized pair 1.2e-3 / 2.5e-3 (the
# bf16 cases below compute both); the limit is the larger reading with
# half again of margin. The int8 codes are held bit for bit on their own.
BF16_ATOL = 5e-3
Q8 = {"text_encoder.quantized_inference": True}

# three product shapes: a qkv block, one request's FFN output row, and a
# ragged FFN intermediate
SHAPES = ((64, 768, 2304), (1, 3072, 768), (300, 768, 3072))


def _bf16_rounded(a):
    return np.array(jnp.asarray(a).astype(jnp.bfloat16)
                    .astype(jnp.float32))


@pytest.mark.parametrize("rounded", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_quantize_and_int8_matmul_are_bit_equal_to_jax(m, k, n, rounded):
    rng = np.random.default_rng(m + k)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) * 0.02).astype(np.float32)
    if rounded:
        x, w = _bf16_rounded(x), _bf16_rounded(w)
    jwq, jsw = jquant._quantize_weight(jnp.asarray(w))
    jxq, jsx = jquant._quantize_act(jnp.asarray(x))
    twq, tsw = quant.quantize_weight(torch.from_numpy(w))
    txq, tsx = quant.quantize_act(torch.from_numpy(x))
    assert twq.dtype == txq.dtype == torch.int8
    assert tsw.shape == (n,) and tsx.shape == (m, 1)
    np.testing.assert_array_equal(twq.numpy(), np.asarray(jwq))
    np.testing.assert_array_equal(txq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(tsw.numpy(), np.asarray(jsw))
    np.testing.assert_array_equal(tsx.numpy(), np.asarray(jsx))
    got = quant.int8_matmul(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jquant.int8_matmul(jnp.asarray(x),
                                                   jnp.asarray(w))))


@pytest.mark.parametrize("m", [1, 7, 16])
def test_padded_rows_are_bit_equal_to_unpadded(m):
    # the card's path (fewer rows than _int_mm takes), forced on the CPU
    rng = np.random.default_rng(m)
    x = torch.from_numpy(rng.normal(size=(m, 768)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(768, 2304)) * 0.02)
                         .astype(np.float32))
    xq, _ = quant.quantize_act(x)
    wq, _ = quant.quantize_weight(w)
    calls, rows = quant.PADDED_CALLS, quant.PADDED_ROWS
    padded = quant.int_mm(xq, wq, min_rows=quant.CUDA_MIN_ROWS)
    assert (quant.PADDED_CALLS - calls, quant.PADDED_ROWS - rows) == \
        (1, quant.CUDA_MIN_ROWS - m)
    plain = quant.int_mm(xq, wq)
    assert quant.PADDED_CALLS - calls == 1  # the CPU pads nothing
    assert padded.dtype == torch.int32 and padded.shape == (m, 2304)
    assert torch.equal(padded, plain)
    assert torch.equal(plain, xq.int() @ wq.int())


class _Codes:
    """Records every int8 activation code array of a forward, in call
    order, on both sides: the JAX `_quantize_act` and the port's
    `quantize_act`."""

    def __init__(self, monkeypatch):
        self.jax, self.port = [], []
        jfn, tfn = jquant._quantize_act, quant.quantize_act

        def jrec(x):
            q, s = jfn(x)
            self.jax.append(np.asarray(q))
            return q, s

        def trec(x, axis=None):
            q, s = tfn(x, axis)
            self.port.append(q.numpy().copy())
            return q, s

        monkeypatch.setattr(jquant, "_quantize_act", jrec)
        monkeypatch.setattr(quant, "quantize_act", trec)

    def flips(self):
        """The products' code arrays compared in order: (arrays, elements
        whose code differs)."""
        assert len(self.jax) == len(self.port) > 0
        flips = 0
        for j, t in zip(self.jax, self.port):
            assert j.shape == t.shape
            flips += int((j != t).sum())
        return len(self.jax), flips


def _q8_pair(seed, **over):
    # H=128 / F=256, 2 layers: every product of the JAX layer quantized
    return _pair(_cfg(hidden=128, ffn=256, **Q8, **over), seed=seed)


@pytest.mark.parametrize("forward", ["cls-only", "full", "packed",
                                     "hidden-and-attentions"])
def test_quantized_encoder_matches_jax(monkeypatch, forward):
    jenc, v, tenc = _q8_pair(41)
    codes = _Codes(monkeypatch)
    rng = np.random.default_rng(42)
    if forward == "packed":
        ids, mask = _batch(rng, 7, 40, lo=10)
        pb = pack_texts(ids, mask, capacity=128)
        kw = dict(position_ids=pb.position_ids, segment_ids=pb.segment_ids,
                  query_positions=pb.query_positions)
        jargs = (jnp.asarray(pb.input_ids), None)
        targs = (_t(pb.input_ids), None)
        jkw = {k: jnp.asarray(a) for k, a in kw.items()}
        tkw = {k: _t(a) for k, a in kw.items()}
    else:
        ids, mask = _batch(rng, 4, 16)
        jargs = (jnp.asarray(ids), jnp.asarray(mask))
        targs = (_t(ids), _t(mask))
        jkw, tkw = {}, {}
    if forward == "hidden-and-attentions":
        jkw = tkw = {"output_hidden_states": True, "output_attentions": True}
    if forward == "full":
        jout = jenc.apply(v, *jargs, method=lambda m, *a: m.bert(
            *a, cls_only_final=False))
        with torch.no_grad():
            tout = tenc.bert(*targs, cls_only_final=False)
    else:
        jout = jenc.apply(v, *jargs, method=lambda m, *a, **k: m.bert(
            *a, cls_only_final=True, **k), **jkw)
        with torch.no_grad():
            tout = tenc.bert(*targs, cls_only_final=True, **tkw)
    # 4 products per layer, 2 layers, each side's codes in the same order
    n, flips = codes.flips()
    assert (n, flips) == (8, 0)
    keys = ("cls", "pooler_output", "last_hidden_state")
    if forward == "hidden-and-attentions":
        keys += ("hidden_states", "attentions")
    for key in keys:
        got, want = tout[key], jout[key]
        if isinstance(got, tuple):
            assert len(got) == len(want)
        else:
            got, want = (got,), (want,)
        for g, w in zip(got, want):
            assert g.shape == w.shape, key
            g, w = g.numpy(), np.asarray(w)
            if forward == "packed" and key == "cls":
                docs = (pb.doc_row, pb.doc_slot)
                g, w = g[docs], w[docs]
            np.testing.assert_allclose(g, w, atol=ATOL, err_msg=key)


def test_quantization_moves_the_encoder_beyond_the_tolerance():
    # the tolerance tells a quantized forward from a float one
    _, _, q8 = _q8_pair(43)
    fl = tbert.create_text_encoder(_cfg(hidden=128, ffn=256).text_encoder,
                                   "cpu").eval()
    fl.load_state_dict(q8.state_dict())
    ids, mask = _batch(np.random.default_rng(44), 4, 16)
    with torch.no_grad():
        d = (q8(_t(ids), _t(mask)) - fl(_t(ids), _t(mask))).abs().max()
    assert float(d) > 100 * ATOL


def test_flag_keeps_the_parameter_tree_and_train_mode():
    on = tbert.create_text_encoder(_cfg(**Q8).text_encoder, "cpu")
    off = tbert.create_text_encoder(_cfg().text_encoder, "cpu")
    assert {k: v.shape for k, v in on.state_dict().items()} == \
        {k: v.shape for k, v in off.state_dict().items()}
    assert len(quant.quant_layers(on)) == 8 and not quant.quant_layers(off)
    gen = torch.Generator().manual_seed(0)
    for p in off.parameters():
        with torch.no_grad():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    on.load_state_dict(off.state_dict())
    ids, mask = _batch(np.random.default_rng(45), 3, 16)
    outs = []
    for enc in (on, off):
        enc.train()
        set_dropout_generator(enc, torch.Generator().manual_seed(1))
        out = enc(_t(ids), _t(mask))
        out.square().sum().backward()
        outs.append((out.detach(), enc.bert.layer0.intermediate.weight.grad))
    # train mode runs the float path whatever the flag says
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def _jax_codes(kernel):
    """The JAX quantization of one f32 master kernel (any DenseGeneral
    layout) as [K, N] codes and [N] scales."""
    k = np.asarray(kernel, np.float32)
    if k.ndim == 4:          # qkv [H, 3, h, d]
        k2 = k.reshape(k.shape[0], -1)
    elif k.ndim == 3:        # attention output [h, d, H]
        k2 = k.reshape(-1, k.shape[-1])
    else:
        k2 = k
    q, s = jquant._quantize_weight(jnp.asarray(k2))
    return np.asarray(q), np.asarray(s)


_PRODUCTS = (("attention.qkv", ("attention", "qkv")),
             ("attention.output", ("attention", "output")),
             ("intermediate", ("intermediate",)),
             ("output", ("output",)))


def _assert_codes_are_jax_masters(model, jparams, n_layers):
    for i in range(n_layers):
        jl = jparams["text_encoder"]["bert"][f"layer{i}"]
        for name, path in _PRODUCTS:
            m = model.text_encoder.bert.get_submodule(f"layer{i}.{name}")
            leaf = jl
            for p in path:
                leaf = leaf[p]
            q, s = _jax_codes(leaf["kernel"])
            assert m.codes is not None, name
            scale, bias = m.master_bits.view(torch.float32)
            np.testing.assert_array_equal(m.codes.t().cpu().numpy(), q)
            np.testing.assert_array_equal(scale.cpu().numpy(), s)
            np.testing.assert_array_equal(
                bias.cpu().numpy(),
                np.asarray(leaf["bias"], np.float32).reshape(-1))


def test_bf16_predictor_codes_are_the_jax_quantization_of_f32_masters():
    over = {**_SMALL, **Q8, "training.compute_dtype": "bfloat16"}
    _, tp, v = _predictor_pair(over)
    w = tp.model.text_encoder.bert.layer0.intermediate.weight
    assert w.dtype == torch.bfloat16
    _assert_codes_are_jax_masters(tp.model, v["params"], 1)
    # the trap: the serving copy's rounded weights quantize otherwise
    rounded, _ = quant.quantize_weight(w.t())
    cached = tp.model.text_encoder.bert.layer0.intermediate.codes.t()
    assert (rounded != cached).any()


def test_trainer_validation_copy_is_quantized_from_the_f32_masters(
        tmp_path):
    from multimodal_rare_disease_tpu_torch.train.trainer import Trainer

    cfg = resolve_config("default", {**_SMALL, **Q8,
                                     "training.compute_dtype": "bfloat16"})
    tr = Trainer(cfg, "multimodal", device="cpu", workdir=str(tmp_path))
    tr.init_state()
    with torch.no_grad():  # masters that bf16 rounds
        for p in tr.model.text_encoder.parameters():
            p.add_(torch.randn(p.shape, generator=torch.Generator()
                               .manual_seed(p.numel())) * 1e-3)
    tr.sync_eval_model()
    ev, master = tr.eval_model.text_encoder.bert, tr.model.text_encoder.bert
    assert ev.layer0.output.weight.dtype == torch.bfloat16
    for name, m in quant.quant_layers(ev):
        w = master.get_submodule(name).weight.detach()
        codes, scale = quant.quantize_weight(w.t())
        assert torch.equal(m.codes.t(), codes), name
        assert torch.equal(m.master_bits[0].view(torch.float32), scale)


def _pair_distance(over, images, texts):
    """max|dprob| of the port's predictor from the JAX one, the port's
    results, and its (packed, classic) calls."""
    jp, tp, _ = _predictor_pair(over)
    got = tp.predict_batch(images, texts)
    want = jp.predict_batch(images, texts)
    for g, r in zip(got, want):
        assert g["top_prediction"]["class_id"] == \
            r["top_prediction"]["class_id"]
    d = max(abs(g["all_probabilities"][k] - v) for g, r in zip(got, want)
            for k, v in r["all_probabilities"].items())
    return d, got, want, (tp.packed_calls, tp.classic_calls)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,path", [(1, "classic"), (12, "packed")])
def test_quantized_predictor_matches_jax(n, path, dtype):
    images, texts = _requests(n, seed=3)
    d, got, want, calls = _pair_distance(
        {**_SMALL, **Q8, "training.compute_dtype": dtype}, images, texts)
    assert calls == ((1, 0) if path == "packed" else (0, 1))
    if dtype == "float32":
        for g, r in zip(got, want):
            np.testing.assert_allclose(
                list(g["all_probabilities"].values()),
                list(r["all_probabilities"].values()), atol=P_ATOL,
                rtol=P_RTOL)
        return
    # bf16: the unquantized pair is itself beyond the JAX limits, and
    # both pairs lie within BF16_ATOL
    d_float = _pair_distance({**_SMALL, "training.compute_dtype": dtype},
                             images, texts)[0]
    assert d_float > P_ATOL
    assert d <= BF16_ATOL and d_float <= BF16_ATOL


def test_create_model_quantizes_before_the_cast():
    cfg = resolve_config("default", {**_SMALL, **Q8})
    f32 = create_model(cfg, device="cpu", seed=0)
    # f32 weights need no cache: they quantize to the same codes per call
    assert all(m.codes is None for _, m in quant.quant_layers(f32))
    bf = create_model(cfg, device="cpu", seed=0, dtype=torch.bfloat16)
    assert quant.prepare_quantized(f32) == len(quant.quant_layers(f32)) > 0
    for (name, a), (_, b) in zip(quant.quant_layers(f32),
                                 quant.quant_layers(bf)):
        assert torch.equal(a.codes, b.codes), name
        assert torch.equal(a.master_bits, b.master_bits), name
    # a loaded state dict clears the cache; the predictor fills it again
    m = create_model(cfg, device="cpu", seed=None)
    m.load_state_dict(f32.state_dict())
    assert all(q.codes is None for _, q in quant.quant_layers(m))
    p = MultimodalPredictor(cfg, m, "cpu")
    for (_, a), (_, b) in zip(quant.quant_layers(f32),
                              quant.quant_layers(p.model)):
        assert torch.equal(a.codes, b.codes)


# -- the entry points on a checkpoint with both flags on ---------------------

FLAGS = {**Q8, "text_encoder.flat_residual": True}


@pytest.fixture(scope="module")
def flagged(tmp_path_factory):
    """A synthetic corpus and a JAX and a port multimodal checkpoint of
    the same weights, with quantized_inference and flat_residual on."""
    from multimodal_rare_disease_tpu.utils.checkpoint import (
        save_checkpoint as jax_save,
    )
    from multimodal_rare_disease_tpu_torch.utils.checkpoint import (
        save_checkpoint,
    )
    from tests.test_torch_evaluation import model_pair
    from tests.test_torch_host_copies import _write_corpus

    root = tmp_path_factory.mktemp("q8cli")
    (root / "images").mkdir()
    _write_corpus(root / "images", np.random.default_rng(61), flat=True)
    jcfg, _, v, cfg, tm = model_pair(
        "multimodal", 62, **{"data.data_dirs": (str(root),), **FLAGS})
    assert cfg.text_encoder.quantized_inference and \
        cfg.text_encoder.flat_residual
    jax_save(root / "jax", v["params"], v["batch_stats"], 0,
             meta={"config": jcfg.to_dict(), "mode": "multimodal"})
    save_checkpoint(root / "port", tm.state_dict(),
                    meta={"config": cfg.to_dict(), "mode": "multimodal"})
    return root


@pytest.fixture
def no_jax_compile_cache(monkeypatch):
    monkeypatch.setenv("MRD_NO_COMPILE_CACHE", "1")


def _json(path):
    import json

    return json.loads(path.read_text())


def test_predict_evaluate_and_explain_clis_match_jax(
        flagged, tmp_path, capsys, no_jax_compile_cache):
    from multimodal_rare_disease_tpu.cli import evaluate as jax_evaluate
    from multimodal_rare_disease_tpu.cli import explain as jax_explain
    from multimodal_rare_disease_tpu.cli import predict as jax_predict
    from multimodal_rare_disease_tpu_torch.cli import (
        evaluate,
        explain,
        predict,
    )
    from tests.test_torch_evaluation import assert_same

    root = flagged
    image = str(sorted((root / "images").iterdir())[2])
    text = "Patient presents with hypertelorism and a wide mouth"
    one = ["--image", image, "--text", text]
    assert predict.main(["--checkpoint", str(root / "port"), "--device",
                         "cpu", "--output", str(tmp_path / "p.json")]
                        + one) == 0
    assert jax_predict.main(["--checkpoint", str(root / "jax"),
                             "--platform", "cpu", "--output",
                             str(tmp_path / "j.json")] + one) == 0
    got, want = _json(tmp_path / "p.json"), _json(tmp_path / "j.json")
    np.testing.assert_allclose(list(got["all_probabilities"].values()),
                               list(want["all_probabilities"].values()),
                               atol=ATOL)

    def eval_args(ckpt, out):
        return ["--checkpoint", str(root / ckpt), "--image-dir",
                str(root / "images"), "--results-dir", str(tmp_path / out)]

    assert evaluate.main(eval_args("port", "ep") + ["--device", "cpu"]) == 0
    assert jax_evaluate.main(eval_args("jax", "ej")
                             + ["--platform", "cpu"]) == 0
    name = "multimodal_metrics.json"
    assert_same(_json(tmp_path / "ep" / name), _json(tmp_path / "ej" / name))

    assert explain.main(["--checkpoint", str(root / "port"), "--outdir",
                         str(tmp_path / "xp"), "--device", "cpu"] + one) == 0
    assert jax_explain.main(["--checkpoint", str(root / "jax"), "--outdir",
                             str(tmp_path / "xj"), "--platform", "cpu"]
                            + one) == 0
    capsys.readouterr()
    gx, wx = (_json(tmp_path / d / "index.json") for d in ("xp", "xj"))
    assert [g["predicted_class"] for g in gx] == \
        [w["predicted_class"] for w in wx]


def test_serve_answers_from_a_flagged_checkpoint(flagged):
    # cli/serve.py's single-device path: load_predictor, the MicroBatcher
    # and the HTTP handler
    import base64
    import io
    import json
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    from multimodal_rare_disease_tpu_torch.cli.serve import (
        MicroBatcher,
        make_handler,
    )
    from multimodal_rare_disease_tpu_torch.inference.predictor import (
        load_predictor,
    )

    pred = load_predictor(flagged / "port", "cpu")
    assert len(quant.quant_layers(pred.model)) == 8
    assert all(m.codes is not None for _, m in quant.quant_layers(pred.model))
    text = "Patient presents with a broad forehead and short stature"
    batcher = MicroBatcher(pred, window_ms=20.0)
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(batcher))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        from PIL import Image

        img = np.random.default_rng(63).integers(0, 256, (64, 64, 3),
                                                 np.uint8)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        body = json.dumps({"image": base64.b64encode(buf.getvalue())
                           .decode(), "text": text, "top_k": 3}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}/predict", data=body,
            headers={"Content-Type": "application/json"})
        answer = json.load(urllib.request.urlopen(req, timeout=60))
    finally:
        srv.shutdown()
        srv.server_close()
        batcher.close()
    want = pred.predict(img, text, top_k=3)
    assert [p["class_id"] for p in answer["predictions"]] == \
        [p["class_id"] for p in want["predictions"]]
    np.testing.assert_allclose(
        list(answer["all_probabilities"].values()),
        list(want["all_probabilities"].values()), atol=1e-6)


def test_train_cli_with_both_flags(tmp_path):
    from multimodal_rare_disease_tpu_torch.cli import train
    from multimodal_rare_disease_tpu_torch.inference.predictor import (
        load_predictor,
    )

    assert train.main(["--smoke-test", "--device", "cpu",
                       "--checkpoint-dir", str(tmp_path),
                       "--set", "text_encoder.quantized_inference=True",
                       "--set", "text_encoder.flat_residual=True"]) == 0
    pred = load_predictor(tmp_path / "multimodal_best", "cpu")
    te = pred.cfg.text_encoder
    assert te.quantized_inference is True and te.flat_residual is True
    assert pred.model.text_encoder.bert.flat_residual
    res = pred.predict(np.zeros((64, 64, 3), np.uint8), "short stature")
    assert np.isfinite(list(res["all_probabilities"].values())).all()


def test_serve_mesh_on_a_flagged_checkpoint(tmp_path):
    """`cli/serve.py --mesh 1x2 --backend gloo` on the CPU over a text_only
    checkpoint with both flags: the row-parallel int8 products take their
    maxima and int32 sums over the model axis, and the answers equal the
    one-process predictor's."""
    import os
    import signal
    import socket
    import subprocess
    import sys
    import time
    from pathlib import Path

    from multimodal_rare_disease_tpu_torch.inference.predictor import (
        load_predictor,
    )
    from multimodal_rare_disease_tpu_torch.utils.checkpoint import (
        save_checkpoint,
    )
    from tests.test_torch_parallel import _post

    cfg = resolve_config("default", {
        "text_encoder.num_layers": 2, "text_encoder.num_heads": 2,
        "text_encoder.hidden_size": 32,
        "text_encoder.intermediate_size": 64, **FLAGS})
    ckpt = tmp_path / "ckpt"
    save_checkpoint(ckpt, create_model(cfg, "text_only", "cpu",
                                       seed=0).state_dict(),
                    meta={"config": cfg.to_dict(), "mode": "text_only"})
    texts = ["short stature and developmental delay", "macroglossia"]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    url = f"http://127.0.0.1:{port}"
    proc = subprocess.Popen(
        [sys.executable, "-m", "multimodal_rare_disease_tpu_torch.cli.serve",
         "--checkpoint", str(ckpt), "--mesh", "1x2", "--backend", "gloo",
         "--device", "cpu", "--port", str(port)],
        cwd=Path(__file__).resolve().parent.parent, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, env={**os.environ, "TMPDIR": str(tmp_path)},
        start_new_session=True)
    try:
        deadline = time.monotonic() + 120
        while True:
            assert proc.poll() is None, proc.stdout.read().decode()
            try:
                health = _post(url + "/healthz")
                break
            except OSError:
                assert time.monotonic() < deadline, "the server did not start"
                time.sleep(0.5)
        assert health["mesh"] == {"data": 1, "model": 2}
        answers = [_post(url + "/predict", {"text": t}) for t in texts]
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            rc = proc.wait()
    assert rc == 0
    one = load_predictor(ckpt, "cpu")
    for got, text in zip(answers, texts):
        want = one.predict(text=text)
        assert got["top_prediction"]["syndrome"] == \
            want["top_prediction"]["syndrome"]
        for k, v in want["all_probabilities"].items():
            assert abs(got["all_probabilities"][k] - v) < 1e-6
