"""The port's offline trainers and the scenes they render against the JAX
package: worldmap/vocabulary.py's train_vocabulary and save_vocabulary,
ops/pattern_train.py, and io/synthetic.py's BlobScene, StructuredScene,
make_structured_texture, true_correspondence, multi_loop_trajectory and
render_frames_cached.

Tolerances: train_vocabulary's words and IDF exactly equal to the
reference's (clustered descriptors with ties; 64 words, 3 iterations, with
and without document ids; kernel 5's plain twin on the CPU); a vocabulary
saved by either package loads in the other bit for bit; every render,
texture, correspondence and trajectory exactly equal; the corpus of
matched keypoints (_corpus_pairs on 3 scenes) equal in its blurred images
and keypoints, its angles within 1e-5 rad (the two extractors' angle
arithmetic); learn_pattern exactly equal given one corpus in both packages.
"""

import dataclasses

import numpy as np
import pytest
import torch

from orb_slam2_annotate_tpu.geometry import CameraModel
from orb_slam2_annotate_tpu.io import synthetic as jsyn
from orb_slam2_annotate_tpu.ops import pattern_train as jpt
from orb_slam2_annotate_tpu.worldmap import vocabulary as jvoc
from orb_slam2_annotate_tpu_torch.geometry.camera import CameraModel as TCam
from orb_slam2_annotate_tpu_torch.io import synthetic as tsyn
from orb_slam2_annotate_tpu_torch.ops import pattern_train as tpt
from orb_slam2_annotate_tpu_torch.worldmap import vocabulary as tvoc

torch.set_num_threads(1)

ARGS = dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
CAM, TCAM = CameraModel.create(**ARGS), TCam.create(**ARGS)


def clustered_descriptors(M=1500, n_centres=40, flips=24, seed=0):
    """[M, 16] uint32: copies of n_centres random codes with `flips` random
    bits flipped, some rows repeated (ties in the assignment), and image ids."""
    rng = np.random.RandomState(seed)
    centres = rng.randint(0, 2**32, (n_centres, 16), dtype=np.uint64).astype(np.uint32)
    bits = np.unpackbits(centres.view(np.uint8), axis=1, bitorder="little")[rng.randint(0, n_centres, M)]
    for row in bits:
        row[rng.choice(512, flips, replace=False)] ^= 1
    d = np.packbits(bits, axis=1, bitorder="little").view(np.uint32)
    n = min(100, M // 2)
    d[M // 2:M // 2 + n] = d[:n]
    return d, rng.randint(0, 12, M)


@pytest.mark.parametrize("with_docs", [True, False])
def test_train_vocabulary_matches_reference(with_docs):
    descs, docs = clustered_descriptors()
    docs = docs if with_docs else None
    ref = jvoc.train_vocabulary(descs, n_words=64, iters=3, seed=5, doc_ids=docs)
    out = tvoc.train_vocabulary(descs, n_words=64, iters=3, seed=5, doc_ids=docs, device="cpu")
    assert out.words.dtype == torch.int32 and tuple(out.words.shape) == (64, 16)
    np.testing.assert_array_equal(out.words.numpy().view(np.uint32), np.asarray(ref.words))
    np.testing.assert_array_equal(out.idf.numpy(), np.asarray(ref.idf))
    if with_docs:
        assert (out.idf.numpy() > 0).any()
    # the words it learned are the clusters': most descriptors sit near one
    w = tvoc.assign_words(out, torch.from_numpy(descs.view(np.int32)), torch.ones(len(descs),
                                                                                   dtype=torch.bool))
    assert w.min() >= 0


def test_train_vocabulary_takes_int32_tensors_and_more_words_than_descriptors():
    descs, _ = clustered_descriptors(M=50, seed=1)
    ref = jvoc.train_vocabulary(descs, n_words=64, iters=2, seed=0)
    out = tvoc.train_vocabulary(torch.from_numpy(descs.view(np.int32)), n_words=64, iters=2,
                                seed=0, device="cpu")
    np.testing.assert_array_equal(out.words.numpy().view(np.uint32), np.asarray(ref.words))


def test_vocabulary_files_load_across_packages(tmp_path):
    descs, docs = clustered_descriptors(M=400, seed=2)
    port = tvoc.train_vocabulary(descs, n_words=32, iters=2, doc_ids=docs, device="cpu")
    tvoc.save_vocabulary(str(tmp_path / "port.npz"), port)
    loaded = jvoc.load_vocabulary(str(tmp_path / "port.npz"))
    assert np.asarray(loaded.words).dtype == np.uint32
    np.testing.assert_array_equal(np.asarray(loaded.words), port.words.numpy().view(np.uint32))
    np.testing.assert_array_equal(np.asarray(loaded.idf), port.idf.numpy())
    ref = jvoc.train_vocabulary(descs, n_words=32, iters=2, doc_ids=docs)
    jvoc.save_vocabulary(str(tmp_path / "ref.npz"), ref)
    back = tvoc.load_vocabulary(str(tmp_path / "ref.npz"))
    np.testing.assert_array_equal(back.words.numpy().view(np.uint32), np.asarray(ref.words))
    np.testing.assert_array_equal(back.idf.numpy(), np.asarray(ref.idf))
    with open(tmp_path / "port.npz", "rb") as a, open(tmp_path / "ref.npz", "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("scene", ["blob", "structured"])
def test_new_scenes_render_as_the_reference(scene):
    make = {"blob": lambda m: m.BlobScene(n_blobs=400, seed=3),
            "structured": lambda m: m.StructuredScene(seed=4, tex_size=256)}[scene]
    js, ts = make(jsyn), make(tsyn)
    for R, t in jsyn.orbit_trajectory(30, step=0.05)[::10]:
        (ji, jd), (ti, td) = js.render(CAM, R, t, h=240, w=320), ts.render(TCAM, R, t, h=240, w=320)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(td, jd)
        assert (jd > 0).any()


def test_textures_correspondences_and_trajectories_match_reference():
    np.testing.assert_array_equal(tsyn.make_structured_texture(np.random.RandomState(9), 200),
                                  jsyn.make_structured_texture(np.random.RandomState(9), 200))
    for (Rj, tj), (Rt, tt) in zip(jsyn.multi_loop_trajectory(50, laps=2.0, r0=1.0, dr=0.2),
                                  tsyn.multi_loop_trajectory(50, laps=2.0, r0=1.0, dr=0.2)):
        np.testing.assert_array_equal(Rt, Rj)
        np.testing.assert_array_equal(tt, tj)
    scene = jsyn.PlaneScene(seed=1)
    (Ra, ta), (Rb, tb) = jsyn.orbit_trajectory(4, step=0.06)[0], jsyn.orbit_trajectory(4, step=0.06)[3]
    _, dep = scene.render(CAM, Ra, ta, h=240, w=320)
    xy = np.random.RandomState(0).uniform([0, 0], [320, 240], (500, 2)).astype(np.float32)
    for a, b in zip(tsyn.true_correspondence(TCAM, Ra, ta, Rb, tb, dep, xy),
                    jsyn.true_correspondence(CAM, Ra, ta, Rb, tb, dep, xy)):
        np.testing.assert_array_equal(a, b)


def test_render_frames_cached_matches_reference(tmp_path):
    poses = jsyn.orbit_trajectory(3, step=0.05)
    ref = jsyn.render_frames_cached(jsyn.PlaneScene(seed=1), CAM, poses, 240, 320, "plane1",
                                    with_depth=True, cache_dir=str(tmp_path / "jax"))
    for _ in range(2):            # rendered, then read back from the cache
        out = tsyn.render_frames_cached(tsyn.PlaneScene(seed=1), TCAM, poses, 240, 320, "plane1",
                                        with_depth=True, cache_dir=str(tmp_path / "port"))
        np.testing.assert_array_equal(out[0], ref[0])
        np.testing.assert_array_equal(out[1], ref[1])
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        sorted(p.name for p in (tmp_path / "jax").iterdir())


def test_corpus_pairs_match_reference():
    ref = jpt._corpus_pairs(n_scenes=3, kps_per_scene=30)
    out = tpt._corpus_pairs(n_scenes=3, kps_per_scene=30, device="cpu")
    assert len(out) == len(ref) > 60
    for a, b in zip(out, ref):
        for k in range(4):                       # blurred images, keypoints
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
        for k in (4, 5):                         # angles
            assert abs(float(a[k]) - float(b[k])) <= 1e-5


def test_learn_pattern_matches_reference(monkeypatch):
    rng = np.random.RandomState(2)
    imgs = [rng.uniform(0, 255, (48, 48)) for _ in range(6)]
    corpus = [(imgs[k % 6], imgs[(k + 1) % 6], rng.uniform(16, 32, 2), rng.uniform(16, 32, 2),
               rng.uniform(-np.pi, np.pi), rng.uniform(-np.pi, np.pi)) for k in range(60)]
    monkeypatch.setattr(jpt, "_corpus_pairs", lambda: corpus)
    monkeypatch.setattr(tpt, "_corpus_pairs", lambda device: corpus)
    kw = dict(n_bits=48, n_candidates=800, seed=3, verbose=False)
    ref = jpt.learn_pattern(**kw)
    out = tpt.learn_pattern(**kw, device="cpu")
    assert out.shape == (48, 4) and out.dtype == np.int32
    np.testing.assert_array_equal(out, ref)
