"""The torch package's MTCNN (`models/mtcnn.py`) against the JAX
package's on the CPU: the three nets on the same weights and inputs
(1e-5), `convert_mtcnn` through the weight bridge (bit-equal), the npz
shared by both packages, the cascade on tests/test_face.py's portrait
with the score biases raised so that every stage keeps candidates, the
heuristic detector (equal), and the detector factory."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_rare_disease_tpu.models import mtcnn as jm
from multimodal_rare_disease_tpu_torch.models import mtcnn as tm
from multimodal_rare_disease_tpu_torch.models.convert import (
    state_dict_from_jax,
)

from test_face import _face_image, _fake_state_dicts

NET_ATOL = 1e-5


def _jax_params(seed=0, raised=False):
    """The JAX `init_mtcnn_params` tree as numpy; `raised` lifts the face
    score's bias of each stage (P-Net 1.0, R-Net and O-Net 1.5) so that
    random nets keep candidates through all three thresholds."""
    p = jax.tree_util.tree_map(
        np.asarray, jax.device_get(jm.init_mtcnn_params(jax.random.key(seed))))
    if raised:
        for net, layer, b in (("pnet", "conv4_1", 1.0),
                              ("rnet", "dense5_1", 1.5),
                              ("onet", "dense6_1", 1.5)):
            p[net][layer]["bias"] = np.array([0.0, b], np.float32)
    return p


def _nets(state_dict):
    nets = tm.MTCNN(device="cpu")
    nets.load_state_dict(state_dict, strict=True)
    return nets.eval()


@pytest.mark.parametrize("net,shape", [
    ("pnet", (2, 12, 12, 3)), ("pnet", (1, 100, 60, 3)),
    ("pnet", (1, 155, 154, 3)), ("pnet", (1, 13, 17, 3)),
    ("rnet", (3, 24, 24, 3)), ("onet", (3, 48, 48, 3))])
def test_nets_match_jax(net, shape):
    """Every output of each net on the JAX weights through the bridge,
    at the pyramid's odd and even map sizes (the ceil-mode pools)."""
    p = _jax_params(1)
    nets = _nets(state_dict_from_jax(p))
    x = np.random.default_rng(2).normal(0, 1, shape).astype(np.float32)
    mod = {"pnet": jm.PNet(), "rnet": jm.RNet(), "onet": jm.ONet()}[net]
    want = mod.apply({"params": p[net]}, jnp.asarray(x))
    with torch.no_grad():
        got = getattr(nets, net)(torch.from_numpy(x))
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=NET_ATOL,
                                   rtol=0)


def test_ceil_pool_equals_torch_ceil_mode():
    """The -inf padding equals max_pool2d(ceil_mode=True) at every map
    size the three nets meet (P-Net's pyramid from 12 px up, R-Net's 22
    and 9, O-Net's 46, 21 and 8)."""
    x = torch.randn(1, 2, 160, 160)
    for k, s in ((2, 2), (3, 2)):
        for n in range(k + 1, 160):
            np.testing.assert_array_equal(
                tm._ceil_pool(x[..., :n, :n - 1], k, s).numpy(),
                torch.nn.functional.max_pool2d(x[..., :n, :n - 1], k, s,
                                               ceil_mode=True).numpy())


def test_convert_mtcnn_equals_jax_through_the_bridge():
    """facenet state dicts → the port's state dict equals the JAX
    converter's tree through `state_dict_from_jax`, bit for bit (the
    (N, W, H, C) flatten of the dense layers unpermuted the same way)."""
    pnet, rnet, onet = _fake_state_dicts(np.random.default_rng(0))
    got = tm.convert_mtcnn(pnet, rnet, onet)
    want = state_dict_from_jax(jax.device_get(jm.convert_mtcnn(pnet, rnet,
                                                               onet)))
    assert got.keys() == want.keys() == tm.MTCNN().state_dict().keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # torch tensors in, as torch.load gives them
    as_torch = [{k: torch.from_numpy(v) for k, v in sd.items()}
                for sd in (pnet, rnet, onet)]
    again = tm.convert_mtcnn(*as_torch)
    assert all(torch.equal(again[k], want[k]) for k in want)
    _nets(got)  # loads with strict=True


def test_converted_rnet_matches_jax_on_facenet_weights():
    """The converted R-Net against the JAX R-Net on the JAX conversion of
    the same facenet weights (tests/test_face.py holds the JAX side
    against a numpy emulation of facenet's NCHW net)."""
    pnet, rnet, onet = _fake_state_dicts(np.random.default_rng(3))
    nets = _nets(tm.convert_mtcnn(pnet, rnet, onet))
    params = jm.convert_mtcnn(pnet, rnet, onet)
    x = np.random.default_rng(4).normal(0, 1, (2, 24, 24, 3)).astype(
        np.float32)
    want = jm.RNet().apply({"params": params["rnet"]}, jnp.asarray(x))
    with torch.no_grad():
        got = nets.rnet(torch.from_numpy(x))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=NET_ATOL,
                                   rtol=0)


def test_npz_serves_both_packages(tmp_path):
    """An npz written by either package loads in the other to the same
    weights."""
    p = _jax_params(2)
    jpath = str(tmp_path / "jax.npz")
    jm.save_mtcnn_npz(p, jpath)
    sd, want = tm.load_mtcnn_npz(jpath), state_dict_from_jax(p)
    assert sd.keys() == want.keys()
    assert all(torch.equal(sd[k], want[k]) for k in want)

    tpath = str(tmp_path / "torch.npz")
    sd3 = tm.init_mtcnn_params(seed=3)
    tm.save_mtcnn_npz(sd3, tpath)
    with np.load(tpath) as t, np.load(jpath) as j:
        assert sorted(t.files) == sorted(j.files)
        assert all(t[k].shape == j[k].shape for k in j.files)
    again = state_dict_from_jax(jm.load_mtcnn_npz(tpath))
    assert again.keys() == sd3.keys()
    assert all(torch.equal(again[k], sd3[k]) for k in sd3)


def test_init_mtcnn_params_is_seeded():
    a, b, c = (tm.init_mtcnn_params(seed=s) for s in (0, 0, 1))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["pnet.conv1.weight"], c["pnet.conv1.weight"])
    assert float(a["rnet.prelu4.alpha"].unique()) == 0.25
    assert not a["onet.dense5.bias"].any()


def test_detect_faces_matches_jax():
    """The whole cascade on the 128-px portrait at min_face_size 40 (as
    tests/test_face.py runs it), every stage keeping candidates: the same
    boxes within 1e-3 px and the same probabilities within NET_ATOL. The pyramid's resize (the port's `_axis_weights` against
    jax.image.resize) and the nets differ by round-off only, so the
    cascade takes the same decisions; a flip (a floor or a threshold
    crossed by round-off) would change a box by a pixel or more."""
    box_atol = 1e-3
    p = _jax_params(0, raised=True)
    img = _face_image(128)
    want_boxes, want_probs = jm.detect_faces(p, img, min_face_size=40)
    boxes, probs = tm.detect_faces(_nets(state_dict_from_jax(p)), img,
                                   min_face_size=40)
    assert len(want_boxes) > 10  # candidates survived all three stages
    assert boxes.shape == want_boxes.shape
    np.testing.assert_allclose(boxes, want_boxes, atol=box_atol, rtol=0)
    np.testing.assert_allclose(probs, want_probs, atol=NET_ATOL, rtol=0)
    # and the detector's pick
    det = tm.MTCNNDetector(state_dict_from_jax(p), min_face_size=40,
                           device="cpu")
    assert det(img) == jm.MTCNNDetector(p, min_face_size=40)(img)


def test_detect_faces_none_at_high_thresholds():
    sd = tm.init_mtcnn_params(seed=0)
    boxes, probs = tm.detect_faces(_nets(sd), _face_image(64),
                                   thresholds=(1.0, 1.0, 1.0))
    assert boxes.shape == (0, 4) and probs.shape == (0,)
    assert tm.MTCNNDetector(sd, thresholds=(1.0, 1.0, 1.0),
                            device="cpu")(_face_image(64)) is None


@pytest.mark.parametrize("case", ["portrait", "offcenter", "uniform",
                                  "noise"])
def test_heuristic_face_box_equals_jax(case):
    rng = np.random.default_rng(7)
    img = {"portrait": _face_image(),
           "offcenter": _face_image(200, cy=60, cx=140, ry=40, rx=30),
           "uniform": np.full((96, 96, 3), 77, np.uint8),
           "noise": rng.integers(0, 256, (80, 90, 3), dtype=np.uint8)}[case]
    assert tm.heuristic_face_box(img) == jm.heuristic_face_box(img)


def test_build_face_detector(tmp_path):
    assert tm.build_face_detector("heuristic") is tm.heuristic_face_box
    assert tm.build_face_detector("auto", "") is tm.heuristic_face_box
    with pytest.raises(FileNotFoundError):
        tm.build_face_detector("mtcnn", str(tmp_path / "missing.npz"))
    path = str(tmp_path / "w.npz")
    tm.save_mtcnn_npz(tm.init_mtcnn_params(0), path)
    det = tm.build_face_detector("auto", path, device="cpu")
    assert isinstance(det, tm.MTCNNDetector)
    assert det.device == torch.device("cpu")


def test_mtcnn_detector_needs_a_card_or_cpu(tmp_path):
    """The nets default to the card; without one the detector raises
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    path = str(tmp_path / "w.npz")
    tm.save_mtcnn_npz(tm.init_mtcnn_params(0), path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.build_face_detector("mtcnn", path)
