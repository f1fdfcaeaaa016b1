"""The torch package's rank mesh against the JAX package's device mesh:
`create_mesh`'s shape rules and errors, `shard_batch`'s slices (against
the JAX placement on the virtual 8-device CPU mesh), `tp_spec` on every
leaf of the default model (each rank's share of each parameter, mapped
through the weight bridge, against the JAX PartitionSpec's), the
collectives on 2 and 4 gloo ranks, the `--mesh` parsing of
`cli/serve.py`, and the Trainer's refusal of a mesh larger than its
world, as the JAX Trainer's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_rare_disease_tpu.cli import serve as jax_serve
from multimodal_rare_disease_tpu.config import resolve_config as jax_config
from multimodal_rare_disease_tpu.models import create_model as jax_model
from multimodal_rare_disease_tpu.parallel.mesh import (
    create_mesh as jax_create_mesh,
)
from multimodal_rare_disease_tpu.parallel.mesh import (
    shard_batch as jax_shard_batch,
)
from multimodal_rare_disease_tpu.parallel.tp import _path_names
from multimodal_rare_disease_tpu.parallel.tp import tp_spec as jax_tp_spec
from multimodal_rare_disease_tpu_torch.cli import serve
from multimodal_rare_disease_tpu_torch.config import resolve_config
from multimodal_rare_disease_tpu_torch.models.classifier import create_model
from multimodal_rare_disease_tpu_torch.models.convert import (
    state_dict_from_jax,
)
from multimodal_rare_disease_tpu_torch.parallel.distributed import (
    file_init_method,
    is_primary,
    maybe_initialize,
    run_ranks,
)
from multimodal_rare_disease_tpu_torch.parallel.dryrun import (
    dryrun_multichip,
)
from multimodal_rare_disease_tpu_torch.parallel.mesh import (
    Axis,
    Mesh,
    batch_sharding,
    create_mesh,
    data_axis_size,
    mesh_shape,
    param_sharding,
    replicated_sharding,
    shard_batch,
)
from multimodal_rare_disease_tpu_torch.parallel.tp import (
    model_specs,
    shard_tensor,
    tp_spec,
    unshard,
)
from multimodal_rare_disease_tpu_torch.train.trainer import Trainer
# the ranks' functions, by the module name that spawned ranks import
# (pytest puts tests/ on the path)
import _torch_parallel_workers as workers

# (data_axis, model_axis) requests, valid and not, on 1-8 devices
REQUESTS = [(-1, 1), (-1, 2), (-1, 4), (-1, 3), (8, 1), (4, 2), (2, 2),
            (2, 4), (1, 8), (3, 3), (16, 1), (2, 0), (1, 1)]


def _jax_shape(n, d, m):
    try:
        mesh = jax_create_mesh(data_axis=d, model_axis=m,
                               devices=jax.devices()[:n])
        return (mesh.shape["data"], mesh.shape["model"])
    except ValueError as e:
        return str(e)


def _port_shape(n, d, m):
    try:
        return mesh_shape(n, d, m)
    except ValueError as e:
        return str(e)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_mesh_shape_rules_and_errors_equal_jax(n):
    for d, m in REQUESTS:
        assert _port_shape(n, d, m) == _jax_shape(n, d, m), (n, d, m)


def test_create_mesh_in_one_process_is_1x1_and_calls_no_collective():
    mesh = create_mesh(devices=["cpu"])
    assert mesh.shape == {"data": 1, "model": 1}
    assert all(ax.group is None and ax.size == 1
               for ax in mesh.axes.values())
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        create_mesh(data_axis=2, devices=["cpu"])
    with pytest.raises(ValueError, match="2 devices named for a world of 1"):
        create_mesh(devices=["cpu", "cpu"])


def _fake_mesh(data_rank, d):
    """A mesh as rank `data_rank` of a d-way data axis sees it (no
    process group: shard_batch only slices)."""
    axes = {"data": Axis(None, data_rank, d), "model": Axis(None, 0, 1),
            "world": Axis(None, data_rank, d)}
    return Mesh(d, 1, data_rank, torch.device("cpu"), axes)


@pytest.mark.parametrize("d", [2, 4, 8])
def test_shard_batch_slices_like_the_jax_placement(d):
    batch = {"x": np.arange(32, dtype=np.float32).reshape(16, 2),
             "y": np.arange(16, dtype=np.int32), "s": np.float32(3.0)}
    jax_mesh = jax_create_mesh(data_axis=d, model_axis=1,
                               devices=jax.devices()[:d])
    placed = jax_shard_batch(jax_mesh, batch)
    for k in ("x", "y"):
        shards = sorted(placed[k].addressable_shards,
                        key=lambda s: s.index[0].start)
        for r, sh in enumerate(shards):
            got = shard_batch(_fake_mesh(r, d), batch)[k]
            np.testing.assert_array_equal(got.numpy(), np.asarray(sh.data))
    assert float(shard_batch(_fake_mesh(1, d), batch)["s"]) == 3.0
    mesh = _fake_mesh(0, d)
    assert data_axis_size(mesh) == d
    assert batch_sharding(mesh).axis == "data"
    assert replicated_sharding(mesh).axis is None
    assert param_sharding(mesh, {"w": 0}) == {"w": replicated_sharding(mesh)}
    with pytest.raises(ValueError):
        jax_shard_batch(jax_mesh, {"x": np.zeros((d + 1, 2))})
    with pytest.raises(ValueError, match="do not split evenly"):
        shard_batch(_fake_mesh(0, d), {"x": np.zeros((d + 1, 2))})


@pytest.fixture(scope="module")
def default_leaves():
    """Every leaf of the default model, JAX (path, shape) from its
    abstract init, and the port model's parameter shapes (meta tensors)."""
    jcfg = jax_config("default")
    jm = jax_model(jcfg, mode="multimodal")
    s = jcfg.data.image_size
    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.key(0), jnp.zeros((1, s, s, 3)),
                        jnp.zeros((1, 8), jnp.int32),
                        jnp.ones((1, 8), jnp.int32), train=False))
    leaves = jax.tree_util.tree_leaves_with_path(shapes["params"])
    model = create_model(resolve_config("default"), device="meta",
                         seed=None)
    return leaves, model


def _port_name(path, shape):
    """The port's name of a JAX leaf, by the weight bridge."""
    (name,) = state_dict_from_jax(_nest(_path_names(path), np.zeros(
        (1,) * len(shape), np.int8)))
    return name


def _nest(names, leaf):
    tree = leaf
    for n in reversed(names):
        tree = {n: tree}
    return tree


def _jax_owner(shape, spec, m):
    """Which rank holds each element under a JAX PartitionSpec (-1: all)."""
    owner = np.full(shape, -1, np.int8)
    for axis, name in enumerate(tuple(spec)):
        if name == "model":
            idx = np.repeat(np.arange(m, dtype=np.int8), shape[axis] // m)
            owner = np.broadcast_to(np.expand_dims(
                idx, [a for a in range(len(shape)) if a != axis]),
                shape).copy()
    return owner


def _port_owner(shape, split, m):
    owner = torch.full(shape, -1, dtype=torch.int8)
    if split is None:
        return owner
    idx = torch.arange(owner.numel()).view(shape)
    for r in range(m):
        owner.view(-1)[shard_tensor(idx, split, r, m).reshape(-1)] = r
    return owner


@pytest.mark.parametrize("m", [2, 8])
def test_tp_spec_equals_jax_on_every_leaf_of_the_default_model(
        default_leaves, m):
    """m=2 splits the attention and the FFN leaves; m=8 only the FFN ones
    (12 heads do not split 8 ways)."""
    leaves, model = default_leaves
    heads = jax_config("default").text_encoder.num_heads
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    specs = model_specs(model, m)
    seen = split = 0
    for path, leaf in leaves:
        names = ("params",) + _path_names(path)
        jspec = jax_tp_spec(names, leaf.shape, m)
        name = _port_name(path, leaf.shape)
        port = tp_spec(name, shapes[name], m, heads)
        assert specs.get(name) == port, name
        seen += 1
        if port is None and jspec == jax.sharding.PartitionSpec():
            continue
        split += 1
        want = state_dict_from_jax(_nest(_path_names(path), _jax_owner(
            leaf.shape, jspec, m)))[name]
        got = _port_owner(shapes[name], port, m)
        assert torch.equal(got, want), name
    assert seen == len(shapes)
    assert split == 12 * (6 if m == 2 else 3)


def test_shard_and_unshard_round_trip():
    full = torch.arange(3 * 8 * 5).view(24, 5)  # [3H, H], H=8, 4 heads
    split = tp_spec("x.layer0.attention.qkv.weight", (24, 5), 2, 4)
    parts = [shard_tensor(full, split, r, 2) for r in range(2)]
    assert parts[0].shape == (12, 5)
    # rank 0 holds heads 0-1 of q, of k and of v
    np.testing.assert_array_equal(parts[0][:, 0].numpy() // 5,
                                  [0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 19])
    assert torch.equal(unshard(torch.stack(parts), split), full)


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_on_gloo_ranks(world, tmp_path):
    outs = run_ranks(workers.collectives_rank, world, backend="gloo",
                     timeout_s=120, init_dir=str(tmp_path))
    x = [np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * r
         for r in range(world)]
    w = np.array([1.0, 2.0, 3.0])
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["gather0"], np.concatenate(x, 0))
        np.testing.assert_array_equal(o["gather1"], np.concatenate(x, -1))
        np.testing.assert_array_equal(
            o["sum_bf16"], np.full(3, sum(0.5 + q for q in range(world))))
        assert o["broadcast"] == (["a", "b"], [[7, 7], [7, 7]])
        total_w = w * sum(q + 1 for q in range(world))
        # the sum's gradient is the sum of the ranks' upstream gradients;
        # the model-axis reduce passes this rank's; the copy sums them
        np.testing.assert_allclose(o["grads"]["sum"], total_w)
        np.testing.assert_allclose(o["grads"]["reduce"], w * (r + 1))
        np.testing.assert_allclose(o["grads"]["copy"], total_w)
        assert o["rows"] == slice(4 * r, 4 * r + 4)


@pytest.mark.parametrize("spec, want", [
    ("4x2", None), ("4", None), ("4xa", "expected DPxTP"),
    ("x2", "expected DPxTP")])
def test_serve_mesh_parsing_equals_jax(spec, want, capsys, tmp_path):
    from multimodal_rare_disease_tpu_torch.cli._common import parse_mesh

    if want is None:
        import argparse

        dp, _, tp = spec.partition("x")
        assert parse_mesh(argparse.ArgumentParser(), spec) == (
            int(dp), int(tp or 1))
        return
    errors = []
    for main, extra in ((serve.main, ["--device", "cpu"]),
                        (jax_serve.main, ["--platform", "cpu"])):
        with pytest.raises(SystemExit) as e:
            main(["--checkpoint", str(tmp_path), "--mesh", spec] + extra)
        assert e.value.code == 2
        errors.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errors[0].split(": error: ")[1] == errors[1].split(": error: ")[1]
    assert want in errors[0]


def test_trainer_model_axis_beyond_the_world_raises_as_jax():
    """The mesh of `cfg.mesh` over one process: a model axis of 2 needs
    two ranks (the JAX Trainer builds its mesh from the config too)."""
    over = {"mesh.model_axis": 2}
    with pytest.raises(ValueError) as port:
        Trainer(resolve_config("default", over), "text_only", device="cpu")
    with pytest.raises(ValueError) as ref:
        jax_create_mesh(jax_config("default", over),
                        devices=jax.devices()[:1])
    assert str(port.value) == str(ref.value)


def test_maybe_initialize_needs_a_named_backend_and_is_a_no_op_alone(
        tmp_path):
    assert not maybe_initialize()  # one process: nothing to set up
    assert is_primary() and not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="name it, 'nccl'"):
        maybe_initialize(file_init_method(str(tmp_path)), 2, 0)
    assert not torch.distributed.is_initialized()


def test_dryrun_multichip_on_two_cpu_ranks():
    res = dryrun_multichip(2, device="cpu", backend="gloo", timeout_s=180)
    assert set(res["losses"]) == {"2x1", "1x2"}
    assert abs(res["losses"]["2x1"] - res["losses"]["1x2"]) < 1e-5
    assert res["predict"]["rows"] == 4
    assert res["predict"]["mesh"] == {"data": 1, "model": 2}


def test_a_follower_fault_fails_the_serving_world(tmp_path):
    """A batch that fails on a follower alone ends that rank with its
    error, and the world fails, instead of leaving rank 0 waiting in a
    collective the follower never joins."""
    with pytest.raises(RuntimeError, match="follower fault on rank 1"):
        run_ranks(workers.serve_fault_rank, 2, backend="gloo",
                  timeout_s=60, init_dir=str(tmp_path))


def test_mesh_leader_refuses_bad_input_and_stops_after_a_fault():
    """Rank 0 refuses what the followers would, before it broadcasts; a
    batch that fails after its broadcast marks the mesh out of step, and
    the watcher stops the server when that happens or a follower dies."""
    import threading

    calls = []

    class Predictor:
        mode, device = "text_only", torch.device("cpu")
        mesh = create_mesh(devices=[torch.device("cpu")])

        def predict_batch(self, images=None, texts=None, top_k=5):
            calls.append(texts)
            raise MemoryError("rank 0 out of memory")

    class Server:
        def __init__(self):
            self.down = threading.Event()

        def shutdown(self):
            self.down.set()

    leader = serve.MeshLeader(Predictor(), ping_s=3600.0)
    with pytest.raises(ValueError, match="text must be a string"):
        leader.predict_batch(texts=["fine", 5])
    with pytest.raises(ValueError, match="decoded uint8"):
        leader.predict_batch(images=[np.zeros((4, 4), np.uint8)])
    assert calls == [] and not leader.failed.is_set()
    with pytest.raises(MemoryError):
        leader.predict_batch(texts=["fine"])
    assert leader.failed.is_set()
    with pytest.raises(RuntimeError, match="out of step"):
        leader.predict_batch(texts=["again"])
    assert calls == [["fine"]]
    server = Server()
    serve._watch_ranks([], leader, server, poll_s=0.01)
    assert server.down.is_set()

    class Proc:
        exitcode = 1

    leader = serve.MeshLeader(Predictor(), ping_s=3600.0)
    server = Server()
    serve._watch_ranks([Proc()], leader, server, poll_s=0.01)
    assert server.down.is_set() and leader.failed.is_set()
    leader.close()  # sends nothing to ranks that are not listening


def _post(url, body=None):
    import json
    import urllib.request

    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_serve_mesh_answers_as_one_process(tmp_path):
    """`cli/serve.py --mesh 2x1 --backend gloo` on the CPU: rank 0 serves
    HTTP and broadcasts each micro-batch, /healthz reports the mesh, the
    answers equal the one-process predictor's, and SIGTERM stops every
    rank with exit code 0."""
    import os
    import signal
    import socket
    import subprocess
    import sys
    import time
    from concurrent.futures import ThreadPoolExecutor
    from pathlib import Path

    from multimodal_rare_disease_tpu_torch.inference.predictor import (
        load_predictor,
    )
    from multimodal_rare_disease_tpu_torch.utils.checkpoint import (
        save_checkpoint,
    )

    cfg = resolve_config("default", {
        "text_encoder.num_layers": 2, "text_encoder.num_heads": 2,
        "text_encoder.hidden_size": 32,
        "text_encoder.intermediate_size": 64})
    ckpt = tmp_path / "ckpt"
    save_checkpoint(ckpt, create_model(cfg, "text_only", "cpu",
                                       seed=0).state_dict(),
                    meta={"config": cfg.to_dict(), "mode": "text_only"})
    texts = ["short stature and developmental delay", "macroglossia",
             "upslanting palpebral fissures and a single palmar crease",
             "elfin facies with supravalvular aortic stenosis"]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    url = f"http://127.0.0.1:{port}"
    repo = Path(__file__).resolve().parent.parent
    proc = subprocess.Popen(
        [sys.executable, "-m", "multimodal_rare_disease_tpu_torch.cli.serve",
         "--checkpoint", str(ckpt), "--mesh", "2x1", "--backend", "gloo",
         "--device", "cpu", "--port", str(port), "--window-ms", "50"],
        cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env={**os.environ, "TMPDIR": str(tmp_path)},
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
        assert health["mesh"] == {"data": 2, "model": 1}
        with ThreadPoolExecutor(3) as ex:
            answers = list(ex.map(lambda t: _post(url + "/predict", {
                "text": t, "top_k": 3}), texts[:3]))
        answers.append(_post(url + "/predict", {"text": texts[3]}))
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            rc = proc.wait()
    assert rc == 0
    want = load_predictor(ckpt, "cpu").predict_batch(texts=texts)
    for got, w in zip(answers, want):
        assert got["top_prediction"]["syndrome"] == \
            w["top_prediction"]["syndrome"]
        for k, v in w["all_probabilities"].items():
            assert abs(got["all_probabilities"][k] - v) < 1e-5
