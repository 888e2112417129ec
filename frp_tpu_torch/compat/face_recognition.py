"""Drop-in replacement for the ``face_recognition`` (dlib) API on the port's
engine (port of ``frp_tpu/compat/face_recognition.py``).

The reference calls exactly these entry points (SURVEY.md section 2.3):
``load_image_file``, ``face_locations`` (dlib (top, right, bottom, left)
ordering), ``face_encodings`` (128-d), ``face_distance`` (euclidean),
``compare_faces`` (tolerance 0.6). Code written against that API runs
unchanged with

    from frp_tpu_torch.compat import face_recognition

backed by the shared engine: one passed to ``set_engine``, else a
``RecognitionEngine()`` built at the first call, on the card (it raises
where there is none). Semantics notes:
  * embeddings are our L2-normalized MobileFaceNet 128-d vectors — the same
    euclidean-distance/threshold *semantics* as dlib (distance in [0, 2],
    0.6 accept), not bitwise dlib geometry (see ops/matching docstring);
  * ``model=`` / ``num_jitters`` / upsample args are accepted and ignored
    (detection is RetinaFace either way);
  * only valid detection slots become faces (``encode_image`` masks by
    ``valid``), so no empty slot's match reaches a caller.
"""

from __future__ import annotations

import threading

import numpy as np

_engine = None
_lock = threading.Lock()


def _get_engine():
    global _engine
    with _lock:
        if _engine is None:
            from frp_tpu_torch.engine.pipeline import RecognitionEngine

            _engine = RecognitionEngine()
        return _engine


def set_engine(engine) -> None:
    """Share an existing engine (e.g. the AppContext's) with this shim."""
    global _engine
    with _lock:
        _engine = engine


def load_image_file(path, mode: str = "RGB") -> np.ndarray:
    try:
        import cv2

        bgr = cv2.imread(str(path), cv2.IMREAD_COLOR)
        if bgr is None:
            raise FileNotFoundError(path)
        return np.ascontiguousarray(bgr[..., ::-1])
    except ImportError:
        from PIL import Image

        return np.asarray(Image.open(path).convert(mode))


def _detect(image: np.ndarray) -> list[dict]:
    return _get_engine().encode_image(np.ascontiguousarray(image, np.uint8))


def face_locations(image, number_of_times_to_upsample: int = 1, model: str = "hog"):
    """[(top, right, bottom, left)] — dlib's ordering, kept for parity."""
    out = []
    for face in _detect(image):
        x1, y1, x2, y2 = (int(round(float(v))) for v in face["box"])
        out.append((y1, x2, y2, x1))
    return out


def face_encodings(
    image,
    known_face_locations=None,
    num_jitters: int = 1,
    model: str = "small",
):
    """[np.ndarray(128)] in detection order. known_face_locations filters the
    detections to the requested boxes (nearest-center match)."""
    faces = _detect(image)
    if known_face_locations:
        chosen = []
        for (top, right, bottom, left) in known_face_locations:
            cy, cx = (top + bottom) / 2, (left + right) / 2
            best = min(
                faces,
                key=lambda f: (((f["box"][1] + f["box"][3]) / 2 - cy) ** 2
                               + ((f["box"][0] + f["box"][2]) / 2 - cx) ** 2),
                default=None,
            )
            if best is not None:
                chosen.append(best)
        faces = chosen
    return [np.asarray(f["embedding"], np.float64) for f in faces]


def face_landmarks(image, face_locations_list=None, model: str = "small"):
    """5-point landmarks as {'left_eye', 'right_eye', 'nose_tip',
    'mouth_left', 'mouth_right'} (dlib's small model exposes 5 points too)."""
    names = ["left_eye", "right_eye", "nose_tip", "mouth_left", "mouth_right"]
    out = []
    for face in _detect(image):
        pts = np.asarray(face["landmarks"], np.float64).reshape(5, 2)
        out.append(
            {name: [(float(x), float(y))] for name, (x, y) in zip(names, pts)}
        )
    return out


def face_distance(face_encodings_list, face_to_compare) -> np.ndarray:
    """Euclidean distances — identical formula to dlib's face_distance."""
    if len(face_encodings_list) == 0:
        return np.empty((0,))
    arr = np.asarray(face_encodings_list, np.float64)
    return np.linalg.norm(arr - np.asarray(face_to_compare, np.float64), axis=1)


def compare_faces(known_face_encodings, face_encoding_to_check, tolerance: float = 0.6):
    return list(face_distance(known_face_encodings, face_encoding_to_check) <= tolerance)
