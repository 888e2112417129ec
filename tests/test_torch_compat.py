"""PyTorch port, the dlib-compatible API (``frp_tpu_torch.compat``) on the
CPU: tests/test_compat.py's four cases on the port's shim with the fake
engine; the port's shim on the port's CPU engine against the JAX shim on the
JAX engine (seed 0), both at tests/test_torch_engine.py's KW: locations
within 1 px, encodings within 1e-4, the same distances' verdicts; and the
shim's own engine, which means the card and raises without one."""

import numpy as np
import pytest
import torch

from frp_tpu.compat import face_recognition as jfr
from frp_tpu.config import load_config as j_load_config
from frp_tpu.engine.pipeline import RecognitionEngine as JEngine
from frp_tpu.train.synthetic import make_scene

from frp_tpu_torch.compat import face_recognition as fr
from frp_tpu_torch.config import load_config
from frp_tpu_torch.engine.pipeline import RecognitionEngine
from tests.test_torch_api import _port_fake

KW = dict(det_size=128, max_faces_per_frame=4, pre_nms_topk=64,
          det_conf_threshold=0.3, compute_dtype="float32")


@pytest.fixture(autouse=True)
def _two_threads():
    """The suite runs its files in parallel worker processes: two intra-op
    threads a test keep those from oversubscribing the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fake_engine():
    eng = _port_fake()
    fr.set_engine(eng)
    yield eng
    fr.set_engine(None)  # don't leak into other tests


# --- tests/test_compat.py on the port -------------------------------------------------

def test_face_locations_dlib_ordering(fake_engine):
    img = np.full((80, 80, 3), 120, np.uint8)
    # FakeEngine box is (x1=10, y1=10, x2=50, y2=50) -> dlib (t, r, b, l)
    assert fr.face_locations(img) == [(10, 50, 50, 10)]


def test_face_encodings_and_distance(fake_engine):
    img = np.full((80, 80, 3), 120, np.uint8)
    encs = fr.face_encodings(img)
    assert len(encs) == 1 and encs[0].shape == (128,)
    same = fr.face_encodings(img)[0]
    np.testing.assert_allclose(fr.face_distance([encs[0]], same), [0.0], atol=1e-6)
    other = fr.face_encodings(np.full((80, 80, 3), 77, np.uint8))[0]
    d = fr.face_distance([encs[0], other], same)
    assert d.shape == (2,) and d[1] > 0.5
    assert fr.compare_faces([encs[0], other], same, tolerance=0.6) == [True, False]


def test_face_landmarks_names(fake_engine):
    lms = fr.face_landmarks(np.full((80, 80, 3), 120, np.uint8))
    assert set(lms[0]) == {"left_eye", "right_eye", "nose_tip", "mouth_left", "mouth_right"}


def test_known_locations_filter(fake_engine):
    img = np.full((80, 80, 3), 120, np.uint8)
    encs = fr.face_encodings(img, known_face_locations=[(10, 50, 50, 10)])
    assert len(encs) == 1
    assert fr.face_distance([], encs[0]).shape == (0,)


def test_load_image_file_equals_jax(tmp_path):
    import cv2

    img = make_scene(96, np.random.default_rng(1), max_faces=2)[0]
    path = str(tmp_path / "x.png")
    cv2.imwrite(path, np.ascontiguousarray(img[..., ::-1]))
    got = fr.load_image_file(path)
    assert np.array_equal(got, img) and np.array_equal(got, jfr.load_image_file(path))
    with pytest.raises(FileNotFoundError):
        fr.load_image_file(str(tmp_path / "missing.png"))


def test_lazy_engine_means_the_card(monkeypatch):
    """With no engine set, the first call builds RecognitionEngine() on the
    card: without CUDA it raises and does not fall back to the CPU."""
    fr.set_engine(None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fr.face_locations(np.full((32, 32, 3), 100, np.uint8))
    assert fr._engine is None


# --- the port's shim on the port's engine against the JAX shim -------------------------

@pytest.fixture(scope="module")
def shims():
    torch.set_num_threads(2)
    jeng = JEngine(j_load_config(**KW), seed=0)
    teng = RecognitionEngine(load_config(**KW), device="cpu")
    jfr.set_engine(jeng)
    fr.set_engine(teng)
    yield
    jfr.set_engine(None)
    fr.set_engine(None)


def _images():
    """Portraits at the det square and letterboxed (wider, taller): the shim
    takes any geometry."""
    out = []
    for seed, pad in ((3, None), (8, ((0, 0), (40, 40), (0, 0))), (11, ((30, 30), (0, 0), (0, 0)))):
        img = make_scene(128, np.random.default_rng(seed), max_faces=1, portrait=True)[0]
        out.append(np.pad(img, pad, constant_values=60) if pad else img)
    return out


def test_compat_on_real_engines_equals_jax(shims):
    images = _images()
    jenc, tenc = [], []
    for img in images:
        jl, tl = jfr.face_locations(img), fr.face_locations(img)
        assert len(jl) == len(tl) == 1
        assert np.abs(np.subtract(jl, tl)).max() <= 1
        je, te = jfr.face_encodings(img), fr.face_encodings(img)
        assert len(je) == len(te) == 1 and te[0].dtype == np.float64
        assert np.abs(je[0] - te[0]).max() <= 1e-4
        jk, tk = jfr.face_encodings(img, jl), fr.face_encodings(img, tl)
        assert np.abs(jk[0] - tk[0]).max() <= 1e-4
        jm, tm = jfr.face_landmarks(img)[0], fr.face_landmarks(img)[0]
        assert jm.keys() == tm.keys()
        for name in jm:
            assert np.abs(np.subtract(jm[name], tm[name])).max() <= 1e-2, name
        jenc.append(je[0])
        tenc.append(te[0])
    for i in range(len(images)):
        jd, td = jfr.face_distance(jenc, jenc[i]), fr.face_distance(tenc, tenc[i])
        assert np.abs(jd - td).max() <= 1e-4
        for tol in (0.1, 0.6, 1.0):
            assert jfr.compare_faces(jenc, jenc[i], tol) == fr.compare_faces(tenc, tenc[i], tol)
    # the same functions on the same vectors: the same values
    assert np.array_equal(fr.face_distance(jenc, jenc[0]), jfr.face_distance(jenc, jenc[0]))


def test_compat_no_face_gives_empty_lists(shims):
    noise = np.random.default_rng(0).integers(0, 255, (128, 128, 3), dtype=np.uint8)
    assert jfr.face_locations(noise) == fr.face_locations(noise) == []
    assert fr.face_encodings(noise) == [] and fr.face_landmarks(noise) == []
