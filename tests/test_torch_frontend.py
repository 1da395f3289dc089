"""Parity of the port's front end (pyramid, FAST + NMS, selection, patches,
IC angle, steered BRIEF, extraction) with the JAX package, at 320x240,
512 features, 4 levels, on a PlaneScene frame.

Tolerances: given the same level images, the FAST score, is_hi, NMS,
selected xy / resp / valid and the patches are exactly equal.  Pyramid
and blur agree within 1e-3 on the 0-255 scale (summation order), also as
the padded [L,H0,W0] stacks of kernel 1's frame-wide twin, whose padding is
exactly 0.  IC angles
agree within 1e-4 rad; at least 99.5% of valid keypoints share the angle
bin, and every keypoint whose bin agrees has a bit-identical descriptor.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_annotate_tpu.geometry import CameraModel
from orb_slam2_annotate_tpu.io import synthetic
from orb_slam2_annotate_tpu.ops import extractor as jext
from orb_slam2_annotate_tpu.ops import fast as jfast
from orb_slam2_annotate_tpu.ops import orb as jorb
from orb_slam2_annotate_tpu.ops import pyramid as jpyr
from orb_slam2_annotate_tpu.ops import select as jsel
from orb_slam2_annotate_tpu_torch.kernels import fast_nms as tk1
from orb_slam2_annotate_tpu_torch.kernels import orb_describe as tk2
from orb_slam2_annotate_tpu_torch.ops import extractor as text
from orb_slam2_annotate_tpu_torch.ops import fast as tfast
from orb_slam2_annotate_tpu_torch.ops import orb as torb
from orb_slam2_annotate_tpu_torch.ops import pyramid as tpyr
from orb_slam2_annotate_tpu_torch.ops import select as tsel

CAM = CameraModel.create(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
CFG_J = jext.ExtractorConfig(n_features=512, n_levels=4)
CFG_T = text.ExtractorConfig(n_features=512, n_levels=4)


@pytest.fixture(scope="module")
def image():
    poses = synthetic.orbit_trajectory(3, step=0.06)
    img, _ = synthetic.PlaneScene(seed=1).render(CAM, *poses[2], h=240, w=320)
    return img.astype(np.float32)


@pytest.fixture(scope="module")
def jax_levels(image):
    return [np.asarray(lv) for lv in jpyr.build_pyramid(jnp.asarray(image), 4, 1.2)]


def T(a):
    return torch.from_numpy(np.array(a))


def test_pyramid_and_blur(image, jax_levels):
    levels = tpyr.build_pyramid(T(image), 4, 1.2)
    assert [tuple(lv.shape) for lv in levels] == [lv.shape for lv in jax_levels]
    for lt, lj in zip(levels, jax_levels):
        np.testing.assert_allclose(lt.numpy(), lj, atol=1e-3)
        np.testing.assert_allclose(tpyr.gaussian_blur(T(lj)).numpy(),
                                   np.asarray(jpyr.gaussian_blur(jnp.asarray(lj))), atol=1e-3)
    assert tpyr.features_per_level(512, 4, 1.2) == jpyr.features_per_level(512, 4, 1.2)


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_fast_nms_select_exact(jax_levels, level):
    lj = jax_levels[level]
    s_j, hi_j = jfast.fast_score_map(jnp.asarray(lj), 7.0, 20.0)
    s_t, hi_t = tfast.fast_score_map(T(lj), 7.0, 20.0)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(hi_t.numpy(), np.asarray(hi_j))
    n_j = np.asarray(jfast.nms3x3(s_j))
    np.testing.assert_array_equal(tfast.nms3x3(s_t).numpy(), n_j)
    # the kernel's plain per-level step = score -> NMS -> EDGE margin
    h, w = lj.shape
    yy, xx = np.mgrid[0:h, 0:w]
    ok = (yy >= 19) & (yy < h - 19) & (xx >= 19) & (xx < w - 19)
    score_j = np.where(ok, n_j, 0.0)
    score_t, hi_w = tk1.fast_nms_plain(T(lj), 7.0, 20.0, 19)
    np.testing.assert_array_equal(score_t.numpy(), score_j)
    np.testing.assert_array_equal(hi_w.numpy(), np.asarray(hi_j))
    budget = jpyr.features_per_level(512, 4, 1.2)[level]
    ref = jsel.select_keypoints(jnp.asarray(score_j), hi_j, budget)
    got = tsel.select_keypoints(score_t, hi_w, budget)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _level_keypoints(jax_levels):
    """Selected keypoints of every level from the JAX path (level coords)."""
    budgets = jpyr.features_per_level(512, 4, 1.2)
    parts = [jext._select_level(jnp.asarray(lv), b, CFG_J, l)
             for l, (lv, b) in enumerate(zip(jax_levels, budgets))]
    return [np.concatenate([np.asarray(p[i]) for p in parts]) for i in range(4)]


def test_patches_angles_descriptors(jax_levels):
    xy, _, octv, valid = _level_keypoints(jax_levels)
    H0, W0 = jax_levels[0].shape
    hw = tuple(lv.shape for lv in jax_levels)
    pad = lambda ims: np.stack([np.pad(im, ((0, H0 - im.shape[0]), (0, W0 - im.shape[1])))
                                for im in ims])
    pyr3 = pad(jax_levels)
    pyr3b = pad([np.asarray(jpyr.gaussian_blur(jnp.asarray(lv))) for lv in jax_levels])
    tab_j = jorb.tables()
    tab_t = torb.OrbTables()
    assert tab_t.brief_half == jorb.BRIEF_HALF
    np.testing.assert_array_equal(tab_t.rot_offsets.numpy(), jorb.ROT_OFFSETS)
    p_j = jorb.keypoint_patches(jnp.asarray(pyr3), jnp.asarray(xy), jnp.asarray(octv), hw)
    hw_t = torch.tensor(hw)
    p_t = torb.keypoint_patches(T(pyr3), T(xy), T(octv).long(), hw_t)
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))
    pb_j = jorb.keypoint_patches(jnp.asarray(pyr3b), jnp.asarray(xy), jnp.asarray(octv), hw,
                                 half=jorb.BRIEF_HALF)
    ang_j = np.asarray(jorb.ic_angles_patches(p_j, jnp.asarray(valid), tab_j))
    desc_j = np.asarray(jorb.brief_descriptors_patches(pb_j, jnp.asarray(ang_j), jnp.asarray(valid),
                                                       tab_j)).view(np.int32)
    ang_t, desc_t = tk2.describe_keypoints_plain(T(pyr3), T(pyr3b), hw_t.to(torch.int32), T(xy),
                                                 T(octv), T(valid), tab_t)
    np.testing.assert_allclose(ang_t.numpy(), ang_j, atol=1e-4)
    same = (torb.angle_bins(ang_t) == torb.angle_bins(T(ang_j))).numpy()
    assert same[valid].mean() >= 0.995
    np.testing.assert_array_equal(desc_t.numpy()[same], desc_j[same])
    # descriptors from the JAX angles are bit-identical everywhere
    d2 = torb.brief_descriptors_patches(T(np.asarray(pb_j)), T(ang_j), T(valid), tab_t)
    np.testing.assert_array_equal(d2.numpy(), desc_j)


def test_extract_end_to_end(image):
    fj = jext.extract(jnp.asarray(image), CFG_J)
    ft = text.extract(T(image), torb.OrbTables(), CFG_T)
    same_kp = ((ft.xy.numpy() == np.asarray(fj.xy)).all(1)
               & (ft.octave.numpy() == np.asarray(fj.octave)))
    assert same_kp.mean() >= 0.99
    d_j = np.asarray(fj.desc).view(np.int32)
    ok = same_kp & (torb.angle_bins(ft.angle) == torb.angle_bins(T(np.asarray(fj.angle)))).numpy()
    assert ok.mean() >= 0.98
    np.testing.assert_array_equal(ft.desc.numpy()[ok], d_j[ok])
    np.testing.assert_array_equal(ft.valid.numpy()[same_kp], np.asarray(fj.valid)[same_kp])


@pytest.fixture(scope="module")
def frame_stacks(image):
    lt = tpyr.level_tables(240, 320, 4, 1.2, "cpu")
    return lt, tk1.fast_nms_frame_plain(T(image), lt, 7.0, 20.0, 19)


def test_level_tables_are_the_resize_bands():
    """The per-output taps rebuild ``resize_weights`` exactly; level 0 is the identity."""
    lt = tpyr.level_tables(240, 320, 4, 1.2, "cpu")
    for l, ((h, w), (ty, tx)) in enumerate(zip(lt.shapes, lt.taps)):
        for n_in, n_out, first, taps, t in ((240, h, lt.row_first, lt.row_w, ty),
                                            (320, w, lt.col_first, lt.col_w, tx)):
            dense = np.zeros((n_in, n_out), np.float32)
            for o in range(n_out):
                for k in range(t):
                    i = int(first[l, o]) + k
                    if i < n_in:
                        dense[i, o] = taps[l, o, k]
            want = np.eye(n_in, dtype=np.float32) if l == 0 else tpyr.resize_weights(n_in, n_out)
            np.testing.assert_array_equal(dense, want)
            assert not taps[l, n_out:].any()


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_frame_twin_levels_and_blur(jax_levels, frame_stacks, level):
    """Kernel 1's frame-wide twin: each level and its blur against JAX's
    build_pyramid / gaussian_blur.  Levels 1-3 end inside the padded stack,
    so their blur must reflect at the level's own border, and every stack
    is 0 beyond the level."""
    lt, stacks = frame_stacks
    pyr3, blur = stacks[0], stacks[1]
    lj = jax_levels[level]
    h, w = lj.shape
    assert lt.shapes[level] == (h, w) and tuple(lt.level_hw[level].tolist()) == (h, w)
    np.testing.assert_allclose(pyr3[level, :h, :w].numpy(), lj, atol=1e-3)
    np.testing.assert_allclose(blur[level, :h, :w].numpy(),
                               np.asarray(jpyr.gaussian_blur(jnp.asarray(lj))), atol=1e-3)
    for st in stacks:
        outside = st[level].clone()
        outside[:h, :w] = 0
        assert not outside.any()


@pytest.fixture(scope="module")
def stacks_from_jax_levels(jax_levels):
    H0, W0 = jax_levels[0].shape
    pyr3 = np.stack([np.pad(lv, ((0, H0 - lv.shape[0]), (0, W0 - lv.shape[1])))
                     for lv in jax_levels])
    lt = tpyr.level_tables(H0, W0, 4, 1.2, "cpu")
    return tk1.detect_stack_plain(T(pyr3), lt, 7.0, 20.0, 19)


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_frame_twin_fast_exact_given_levels(jax_levels, stacks_from_jax_levels, level):
    """Given JAX's levels, the twin's score and is_hi stacks equal JAX's
    FAST score + NMS + EDGE margin exactly, and its blur stack is within
    1e-3 of JAX's blur of each level."""
    blur, score, is_hi = stacks_from_jax_levels
    lj = jax_levels[level]
    h, w = lj.shape
    s_j, hi_j = jfast.fast_score_map(jnp.asarray(lj), 7.0, 20.0)
    yy, xx = np.mgrid[0:h, 0:w]
    ok = (yy >= 19) & (yy < h - 19) & (xx >= 19) & (xx < w - 19)
    np.testing.assert_array_equal(score[level, :h, :w].numpy(),
                                  np.where(ok, np.asarray(jfast.nms3x3(s_j)), 0.0))
    np.testing.assert_array_equal(is_hi[level, :h, :w].numpy(), np.asarray(hi_j))
    np.testing.assert_allclose(blur[level, :h, :w].numpy(),
                               np.asarray(jpyr.gaussian_blur(jnp.asarray(lj))), atol=1e-3)
