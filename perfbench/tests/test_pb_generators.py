"""The copied generators are deterministic by seed and give the program's
bench the same bytes; the seeded weights fit the engine's tree; the
reference's letterbox meets the program's within 1 of rounding."""

import json
import os

import numpy as np
import pytest

from perfbench.scene import Scene, gallery
from perfbench.stream import batch_ticks
from perfbench.weights import draw, iresnet_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _scene_params(traffic="stream", **over):
    with open(os.path.join(ROOT, f"perfbench/traffic/{traffic}.json")) as f:
        return dict(json.load(f)["scene"], **over)


@pytest.mark.parametrize("static_faces", [11, 0])
def test_scene_is_a_function_of_the_seed(static_faces):
    p = _scene_params(cameras=2, static_faces=static_faces)
    a, b, c = (Scene(np.random.default_rng(s), p) for s in (2**33 + 1, 2**33 + 1, 2**33 + 2))
    assert all(np.array_equal(x, y) for x, y in zip(a.cams, b.cams))
    assert not all(np.array_equal(x, y) for x, y in zip(a.cams, c.cams))
    for t in range(11):
        assert a.advance() == b.advance()
        assert all(np.array_equal(a.cams[i], a.frame_at(i, t)) for i in range(2))


def test_scene_is_the_program_bench_scene():
    from frp_tpu_torch.bench import Scene as BenchScene

    # the bench's parameters: its 8-position walk and its faces of 150-240 px half-size
    ours = Scene(np.random.default_rng(7), _scene_params(cameras=2, walker_path=list(range(8)),
                                                         face_half_size=[150, 240]))
    theirs = BenchScene(np.random.default_rng(7), cameras=2)
    for _ in range(3):
        assert ours.advance() == theirs.advance()
    assert all(np.array_equal(x, y) for x, y in zip(ours.cams, theirs.cams))


def test_a_scene_without_static_faces_holds_the_walker_alone():
    s = Scene(np.random.default_rng(3), _scene_params(cameras=1, static_faces=0))
    lo, hi = _scene_params()["background"]
    base = s.bases[0]
    outside = np.ones(base.shape[:2], bool)
    outside[s.y0: s.y0 + s.p["sprite"], s.x0: s.x0 + s.p["sprite"]] = False
    assert base[outside].min() >= lo and base[outside].max() < hi


def test_every_slot_of_a_batch_differs_from_the_batch_before():
    """The stream's walkers are in another place in each slot of batch k + 1
    than of batch k, so every batch ships a delta and is a new input."""
    with open(os.path.join(ROOT, "perfbench/traffic/stream.json")) as f:
        tr = json.load(f)
    s = Scene(np.random.default_rng(4), dict(tr["scene"], cameras=1))
    ticks = tr["ticks_per_batch"]
    for k in range(1, 2 * s.period + 1):
        now, after = batch_ticks(k, ticks), batch_ticks(k + 1, ticks)
        assert all(s.phase(a) != s.phase(b) for a, b in zip(now, after)), k
    assert not np.array_equal(s.frame_at(0, now[0]), s.frame_at(0, after[0]))


@pytest.mark.parametrize("scale", [1.0, 0.665931])
def test_gallery_is_unit_seeded_and_enrols_at_the_distances(scale):
    g = gallery(np.random.default_rng(9), 100, 512)
    np.testing.assert_allclose(np.linalg.norm(g, axis=1), 1.0, rtol=1e-6)
    assert np.array_equal(g, gallery(np.random.default_rng(9), 100, 512))
    anchors = np.random.default_rng(1).normal(size=(5, 512))
    anchors /= np.linalg.norm(anchors, axis=1, keepdims=True)
    dists = [0.35, 0.45, 0.6, 0.75, 0.9]  # at least |1 - scale|, the nearest a unit entry gets
    e = gallery(np.random.default_rng(9), 100, 512, anchors, dists, scale)
    np.testing.assert_allclose(np.linalg.norm(e, axis=1), 1.0, rtol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(scale * anchors - e[:5], axis=1), dists, atol=1e-6)
    assert np.linalg.norm(scale * anchors[:, None] - e[None, 5:], axis=-1).min() > 1.0


def test_seeded_weights_fit_the_engine_tree():
    from frp_tpu_torch.models.iresnet import init_iresnet
    from frp_tpu_torch.models.params import flatten_params

    leaves = iresnet_leaves("iresnet18", 512)
    want = flatten_params(init_iresnet(0, "iresnet18", 512))
    assert set(leaves) == set(want)
    assert all(tuple(np.shape(want[k])) == leaves[k][0] for k in want)
    a, b, c = draw(leaves, 2**40 + 3, "cpu"), draw(leaves, 2**40 + 3, "cpu"), draw(leaves, 5, "cpu")
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["fc/w"], c["fc/w"])
    assert all(a[k].min() > 0 for k in a if k.endswith(("/var", "/gamma", "/alpha")))


def test_reference_letterbox_meets_the_program_encoder():
    from frp_tpu_torch.engine.batching import LetterboxCache
    from perfbench.check import frame_off
    from perfbench.reference.pipeline import letterbox_i420

    s = Scene(np.random.default_rng(11), _scene_params(cameras=1))
    cache = LetterboxCache(640, 368)
    for t in range(4):
        bands = s.advance()
        got = cache.update(s.cams[0], None if t == 0 else bands[0])
    want = letterbox_i420(s.frame_at(0, 3), 640, 368)
    assert frame_off(got, want) == 0
    assert frame_off(got, letterbox_i420(s.frame_at(0, 2), 640, 368)) > 0
