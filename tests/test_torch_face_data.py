"""The torch package's face crop in the data layer and its numpy copy of
PIL's bilinear resize, against PIL and the JAX package on the CPU:
`resize_bilinear_u8` equals `Image.resize(..., BILINEAR)` byte for byte
over a grid of sizes; `load_image_uint8` and `DataPipeline` with
`data.use_face_detection=True` (the heuristic detector, and MTCNN from an
npz shared by both packages) give the JAX package's uint8 corpus, from
files and, in the port, from decoded arrays as well; a detector that
raises leaves the full frame and is counted."""

import jax
import numpy as np
import pytest
from PIL import Image

from multimodal_rare_disease_tpu.config import resolve_config as jresolve
from multimodal_rare_disease_tpu.data import images as jimages
from multimodal_rare_disease_tpu.models import mtcnn as jm
from multimodal_rare_disease_tpu.train.pipeline import (
    DataPipeline as JaxPipeline,
)
from multimodal_rare_disease_tpu_torch.config import resolve_config
from multimodal_rare_disease_tpu_torch.data import images as timages
from multimodal_rare_disease_tpu_torch.train.pipeline import DataPipeline

from test_face import _face_image

# (in height, in width) -> (out height, out width): up and down, odd
# sizes, one axis only, large shrink factors, 1 px
SIZES = [((31, 45), (24, 24)), ((45, 31), (256, 256)),
         ((512, 512), (256, 256)), ((256, 256), (224, 224)),
         ((100, 73), (64, 200)), ((7, 300), (256, 13)),
         ((256, 256), (256, 100)), ((150, 120), (256, 256)),
         ((1, 1), (5, 5)), ((300, 299), (97, 256)),
         ((512, 512), (24, 24)), ((400, 37), (13, 200)),
         ((257, 255), (256, 256)), ((64, 64), (64, 64))]


@pytest.mark.parametrize("shape_in,shape_out", SIZES,
                         ids=[f"{a[0]}x{a[1]}-{b[0]}x{b[1]}" for a, b in SIZES])
def test_resize_bilinear_u8_equals_pil(shape_in, shape_out):
    rng = np.random.default_rng(sum(shape_in) + sum(shape_out))
    arr = rng.integers(0, 256, shape_in + (3,), dtype=np.uint8)
    # smooth content too, where the rounding of the weights decides
    ramp = np.linspace(0, 255, shape_in[0] * shape_in[1] * 3).reshape(
        shape_in + (3,)).astype(np.uint8)
    for a in (arr, ramp):
        want = np.asarray(Image.fromarray(a).resize(shape_out[::-1],
                                                    Image.BILINEAR))
        got = timages.resize_bilinear_u8(a, *shape_out)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.fixture
def mtcnn_npz(tmp_path):
    """The JAX package's seeded MTCNN weights, score biases raised so that
    the cascade finds a face on the portraits, in the shared npz."""
    p = jax.tree_util.tree_map(
        np.asarray, jax.device_get(jm.init_mtcnn_params(jax.random.key(0))))
    for net, layer, b in (("pnet", "conv4_1", 1.0), ("rnet", "dense5_1", 1.5),
                          ("onet", "dense6_1", 1.5)):
        p[net][layer]["bias"] = np.array([0.0, b], np.float32)
    path = str(tmp_path / "mtcnn.npz")
    jm.save_mtcnn_npz(p, path)
    return path


def _portraits(root, sizes=((80, 80), (90, 72), (64, 64))):
    """A few portrait PNGs in the flat layout, at other sizes than the
    staging size."""
    root.mkdir(exist_ok=True)
    paths = []
    for i, (h, w) in enumerate(sizes):
        img = _face_image(max(h, w), cy=h // 2, cx=w // 2, ry=h // 3,
                          rx=w // 4, seed=i)[:h, :w]
        p = root / f"SYN_KS_{i:03d}.png"
        Image.fromarray(img).save(p)
        paths.append(str(p))
    return paths


def _face_cfgs(kind, weights=""):
    over = {"data.use_face_detection": True, "data.face_detector": kind,
            "data.mtcnn_weights": weights}
    return resolve_config("multimodal", over), jresolve("multimodal", over)


@pytest.mark.parametrize("kind", ["heuristic", "mtcnn"])
def test_load_image_uint8_with_face_crop_equals_jax(tmp_path, kind,
                                                    mtcnn_npz):
    """MTCNN's cascade on these 64-90 px portraits is held against JAX
    in tests/test_torch_mtcnn.py; here its boxes give the same crops."""
    paths = _portraits(tmp_path / "corpus")
    tcfg, jcfg = _face_cfgs(kind, mtcnn_npz)
    timages.configure_face_detection(tcfg, device="cpu")
    jimages.configure_face_detection(jcfg)
    try:
        for p in paths:
            full = np.asarray(Image.open(p).convert("RGB"))
            got = timages.load_image_uint8(p, 224)
            np.testing.assert_array_equal(got,
                                          jimages.load_image_uint8(p, 224))
            assert got.shape == (224, 224, 3)
            # the crop took effect: not the plain resize of the frame
            assert not np.array_equal(
                got, timages.resize_bilinear_u8(full, 224, 224))
    finally:
        timages.set_face_detector(None)
        jimages.set_face_detector(None)


def test_face_detection_off_clears_the_hook():
    timages.set_face_detector(lambda a: (0, 0, 4, 4))
    timages.configure_face_detection(resolve_config("multimodal"))
    assert timages._FACE_DETECTOR is None


def test_failing_detector_leaves_the_frame_and_is_counted(tmp_path):
    (p,) = _portraits(tmp_path / "c", sizes=((128, 128),))

    def broken(arr):
        raise RuntimeError("device lost")

    plain = timages.load_image_uint8(p, 64)
    before = timages.FACE_DETECTOR_FAILURES
    timages.set_face_detector(broken)
    try:
        np.testing.assert_array_equal(timages.load_image_uint8(p, 64), plain)
        np.testing.assert_array_equal(
            timages.stage_uint8(np.asarray(Image.open(p).convert("RGB")), 64),
            plain)
    finally:
        timages.set_face_detector(None)
    assert timages.FACE_DETECTOR_FAILURES == before + 2


@pytest.mark.parametrize("kind", ["heuristic", "mtcnn"])
def test_pipeline_with_face_detection_equals_jax(tmp_path, kind, mtcnn_npz):
    """`DataPipeline` with use_face_detection: the port's corpus from the
    files equals the JAX pipeline's, and the port's `decoded` branch
    (in-memory arrays) gives the same corpus."""
    root = tmp_path / "corpus"
    _portraits(root, sizes=((80, 80), (90, 72), (64, 64), (72, 72),
                            (70, 84), (66, 66)))
    tcfg, jcfg = _face_cfgs(kind, mtcnn_npz)
    try:
        jp = JaxPipeline(jcfg, "image_only", image_dir=str(root))
        tp = DataPipeline(tcfg, "image_only", image_dir=str(root),
                          device="cpu")
        samples = timages.scan_image_corpus(root)
        decoded = {s.path: np.asarray(Image.open(s.path).convert("RGB"))
                   for s in samples}
        dp = DataPipeline(tcfg, "image_only", samples=samples,
                          decoded=decoded, device="cpu")
    finally:
        timages.set_face_detector(None)
        jimages.set_face_detector(None)
    plain = DataPipeline(resolve_config("multimodal"), "image_only",
                         image_dir=str(root), device="cpu")
    for split in ("train_images", "val_images"):
        want = getattr(jp, split)
        assert want.shape[1:] == (256, 256, 3)
        np.testing.assert_array_equal(getattr(tp, split), want)
        np.testing.assert_array_equal(getattr(dp, split), want)
        assert not np.array_equal(getattr(plain, split), want)
