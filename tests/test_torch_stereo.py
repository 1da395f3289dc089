"""The port's stereo path against the JAX package: kernel 9's plain twin
(row-band match, SAD refinement, disparity, depth, the median gate), the
stereo frame, and the System on tests/test_e2e_stereo.py's cell.

The reference's intermediates (best, bestd, ok) are recomputed from the
JAX frame's own inputs with the JAX package's pieces (its extraction,
hamming_pairwise, argmin, _sad_subpixel_refine and median), the lines of
``_make_frame_stereo`` after its extractions; the recomposition agrees with
``make_frame_stereo`` itself on >= 98% of the rows at the tolerances below
(the jitted program extracts a few descriptors differently).

Tolerances: given the JAX features, best, bestd and ok are exactly equal,
ur within 1e-4 px and depth within 1e-5 relative (on float images the SAD
sums round in another order); ``_sad_subpixel_refine`` alone on integer
images exactly; the median gate's both branches exactly.  The port's own
``make_frame_stereo`` (its own extraction) agrees on every row whose match
(best, bestd) is the reference's, at the same tolerances, and on >= 99% of
the rows.  The Systems both reach OK; the port tracks >= 80% of frames,
its keyframe count within +-2 of the reference's, an SE3-aligned ATE of the
returned poses <= max(1.5 x ATE_jax, ATE_jax + 0.01 m) and < 0.12 m, and a
path length within 15% of the truth.  RANSAC draws differ, so the runs are
compared by outcome.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_annotate_tpu.geometry import CameraModel
from orb_slam2_annotate_tpu.geometry import camera as jcam
from orb_slam2_annotate_tpu.io import evaluation as jeval
from orb_slam2_annotate_tpu.io import synthetic as jsyn
from orb_slam2_annotate_tpu.ops import extractor as jext
from orb_slam2_annotate_tpu.ops import hamming as jham
from orb_slam2_annotate_tpu.ops import matching as jmatch
from orb_slam2_annotate_tpu.ops import orb as jorb
from orb_slam2_annotate_tpu.ops import pyramid as jpyr
from orb_slam2_annotate_tpu.pipeline import SlamConfig, System
from orb_slam2_annotate_tpu.pipeline import frame as jfr
from orb_slam2_annotate_tpu_torch import convert
from orb_slam2_annotate_tpu_torch.geometry.camera import CameraModel as TCam
from orb_slam2_annotate_tpu_torch.kernels import stereo as k9
from orb_slam2_annotate_tpu_torch.ops import extractor as text
from orb_slam2_annotate_tpu_torch.ops import orb as torb
from orb_slam2_annotate_tpu_torch.ops import pyramid as tpyr
from orb_slam2_annotate_tpu_torch.pipeline import SlamConfig as TSlamConfig
from orb_slam2_annotate_tpu_torch.pipeline import System as TSystem
from orb_slam2_annotate_tpu_torch.pipeline import frame as tfr

torch.set_num_threads(1)

BASELINE = 0.35          # tests/test_stereo_frame.py's rig
ARGS = dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0, bf=250.0 * BASELINE, width=320, height=240)
CAM = CameraModel.create(**ARGS)
TCAM = TCam.create(**ARGS)
CFG_J = jext.ExtractorConfig(n_features=512, n_levels=4)
CFG_T = text.ExtractorConfig(n_features=512, n_levels=4)
TH = (jmatch.TH_HIGH + jmatch.TH_LOW) // 2


def nd(x):
    return {k: np.asarray(v) for k, v in x._asdict().items()}


def jax_stereo(fl, fr, img_l, img_r, cam, scales):
    """The reference's _make_frame_stereo after its two extractions, with
    its own pieces: (ur, depth, best, bestd, ok, x_und) as numpy."""
    xy_und = jcam.undistort_pixels(cam, fl.xy)
    row_r = 2.0 * scales[fr.octave]
    dy = jnp.abs(fl.xy[:, 1][:, None] - fr.xy[:, 1][None, :])
    disp = fl.xy[:, 0][:, None] - fr.xy[:, 0][None, :]
    cand = ((dy <= row_r[None, :]) & (disp >= 0.0) & (disp <= cam.fx) & fl.valid[:, None]
            & fr.valid[None, :] & (jnp.abs(fl.octave[:, None] - fr.octave[None, :]) <= 1))
    dm = jnp.where(cand, jham.hamming_pairwise(fl.desc, fr.desc), 2048)
    best = jnp.argmin(dm, axis=1)
    bestd = jnp.take_along_axis(dm, best[:, None], axis=1)[:, 0]
    ok = bestd < TH
    ur = jfr._sad_subpixel_refine(img_l, img_r, fl.xy, fr.xy[best], fr.xy[best, 0])
    disparity = xy_und[:, 0] - ur
    ok &= (disparity > 0.1) & (disparity < cam.fx)
    depth = jnp.where(ok, cam.bf / jnp.maximum(disparity, 0.1), 0.0)
    med = jnp.nan_to_num(jnp.median(jnp.where(ok, bestd, jnp.nan).astype(jnp.float32)), nan=80.0)
    ok &= bestd.astype(jnp.float32) <= 2.1 * med
    out = (jnp.where(ok, ur, -1.0), jnp.where(ok, depth, 0.0), best, bestd, ok, xy_und[:, 0])
    return tuple(np.array(a) for a in out)


def twin(fl, fr, img_l, img_r, x_und, cam=TCAM, levels=4):
    """Kernel 9's plain twin on the JAX features."""
    a, b = ({k: np.array(v) for k, v in f._asdict().items()} for f in (fl, fr))
    t = lambda name, v: convert._to_torch(name, v, "cpu")
    out = k9.stereo_match(t("xy", a["xy"]), t("octave", a["octave"]), t("valid", a["valid"]),
                          t("desc", a["desc"]), t("xy", b["xy"]), t("octave", b["octave"]),
                          t("valid", b["valid"]), t("desc", b["desc"]), torch.from_numpy(x_und),
                          torch.from_numpy(np.asarray(img_l, np.float32)),
                          torch.from_numpy(np.asarray(img_r, np.float32)),
                          tpyr.level_scales(levels), cam.fx, cam.bf, TH)
    return tuple(o.numpy() for o in out)


def assert_stereo(got, ref, rows=slice(None)):
    """(ur, depth, best, bestd, ok): integers exact, ur 1e-4 px, depth 1e-5 rel."""
    for k, name in ((2, "best"), (3, "bestd"), (4, "ok")):
        np.testing.assert_array_equal(got[k][rows], ref[k][rows], err_msg=name)
    np.testing.assert_allclose(got[0][rows], ref[0][rows], atol=1e-4, rtol=0, err_msg="ur")
    np.testing.assert_allclose(got[1][rows], ref[1][rows], atol=0, rtol=1e-5, err_msg="depth")


@pytest.fixture(scope="module")
def pair():
    """tests/test_stereo_frame.py's pair: PlaneScene seed 3, the right camera
    BASELINE along +x, float images."""
    scene = jsyn.PlaneScene(seed=3)
    R = np.eye(3, dtype=np.float32)
    img_l, _ = scene.render(CAM, R, np.zeros(3, np.float32), h=240, w=320)
    img_r, _ = scene.render(CAM, R, np.array([-BASELINE, 0, 0], np.float32), h=240, w=320)
    il, ir = jnp.asarray(img_l), jnp.asarray(img_r)
    fl, fr = jext.extract(il, CFG_J, jorb.tables()), jext.extract(ir, CFG_J, jorb.tables())
    ref = jax_stereo(fl, fr, il, ir, CAM, jpyr.level_scales(4, 1.2))
    return img_l, img_r, fl, fr, ref


def test_recomposition_is_the_reference_frame(pair):
    # make_frame_stereo extracts inside one jitted program, whose fusion
    # rounds a few descriptors apart from the eager extraction's: 507 of the
    # 512 rows agree (2 differ in acceptance, 3 in the matched keypoint)
    img_l, img_r, _, _, ref = pair
    frame = nd(jfr.make_frame_stereo(jnp.asarray(img_l), jnp.asarray(img_r), CAM, CFG_J))
    same = (((frame["depth"] > 0) == ref[4]) & (np.abs(frame["ur"] - ref[0]) <= 1e-4)
            & np.isclose(frame["depth"], ref[1], atol=0, rtol=1e-5))
    assert same.mean() >= 0.98, same.mean()


def test_twin_matches_reference_intermediates(pair):
    img_l, img_r, fl, fr, ref = pair
    got = twin(fl, fr, img_l, img_r, ref[5])
    assert got[4].sum() > 100 and (~got[4]).any()       # matches, and the median gate is dead
    assert_stereo(got, ref)


def test_make_frame_stereo_agrees(pair):
    img_l, img_r, fl, fr, ref = pair
    f = tfr.make_frame_stereo(torch.from_numpy(img_l), torch.from_numpy(img_r), TCAM,
                              torb.OrbTables(), CFG_T)
    got_ur, got_depth = f.ur.numpy(), f.depth.numpy()
    # the port's own features: its match where it picked the reference's
    fl_t = text.extract(torch.from_numpy(img_l), torb.OrbTables(), CFG_T)
    np.testing.assert_array_equal(fl_t.xy.numpy(), np.asarray(fl.xy))
    same = (np.abs(got_ur - ref[0]) <= 1e-4) & np.isclose(got_depth, ref[1], atol=0, rtol=1e-5)
    assert same.mean() >= 0.99, same.mean()
    np.testing.assert_allclose(f.xy[:, 0].numpy(), ref[5], atol=1e-4, rtol=0)
    assert (got_depth > 0).sum() > 100


def test_sad_refine_edges_halves_and_flat_patch():
    rng = np.random.RandomState(4)
    h, w = 48, 64
    img_l = rng.randint(0, 256, (h, w)).astype(np.float32)
    img_r = np.roll(img_l, -3, axis=1) + rng.randint(0, 3, (h, w)).astype(np.float32)
    img_l[30:46, 40:60] = 77.0                                   # a flat patch in both
    img_r[30:46, 37:60] = 77.0
    xy_l = np.array([[10.5, 12.5], [11.5, 13.5], [0.0, 0.0], [63.0, 47.0], [2.5, 46.5],
                     [50.0, 38.0], [30.25, 20.75], [62.5, 0.5]], np.float32)
    xy_r = xy_l - np.array([3.0, 0.0], np.float32)
    xy_r[3] = [60.5, 46.5]
    ref = np.asarray(jfr._sad_subpixel_refine(jnp.asarray(img_l), jnp.asarray(img_r),
                                              jnp.asarray(xy_l), jnp.asarray(xy_r),
                                              jnp.asarray(xy_r[:, 0])))
    got = k9.sad_subpixel_refine(torch.from_numpy(img_l), torch.from_numpy(img_r),
                                 torch.from_numpy(xy_l), torch.from_numpy(xy_r),
                                 torch.from_numpy(xy_r[:, 0])).numpy()
    np.testing.assert_array_equal(got, ref)
    # the flat patch: nine equal sums, the first minimum clipped to slide 1,
    # denom clamped to 1e-6, delta 0
    assert got[5] == xy_r[5, 0] - 3.0


def small_frame(dists, valid_last=True):
    """Four left keypoints on their own rows, each matching its right
    keypoint 5 px left at the given Hamming distance; the right image is
    the left one shifted by 5 px."""
    rng = np.random.RandomState(7)
    h, w, n = 48, 96, len(dists)
    img_l = rng.randint(0, 256, (h, w)).astype(np.float32)
    img_r = np.roll(img_l, -5, axis=1)
    xy_l = np.stack([40.0 + 7 * np.arange(n), 8.0 + 9 * np.arange(n)], 1).astype(np.float32)
    xy_r = xy_l - np.array([5.0, 0.0], np.float32)
    bits = rng.randint(0, 2, (n, 512)).astype(bool)
    flip = np.zeros((n, 512), bool)
    for i, d in enumerate(dists):
        flip[i, rng.permutation(512)[:d]] = True
    pack = lambda b: np.packbits(b.reshape(n, 16, 32)[:, :, ::-1], axis=2,
                                 bitorder="big").view(">u4").astype(np.uint32).reshape(n, 16)
    valid = np.ones(n, bool)
    valid[-1] = valid_last
    f = lambda xy, desc, v: jext.Features(xy=jnp.asarray(xy), response=jnp.ones(n),
                                          octave=jnp.zeros(n, jnp.int32), angle=jnp.zeros(n),
                                          desc=jnp.asarray(desc), valid=jnp.asarray(v))
    return (img_l, img_r, f(xy_l, pack(bits), valid),
            f(xy_r, pack(bits ^ flip), np.ones(n, bool)))


@pytest.mark.parametrize("dists, valid_last, kept", [
    ((10, 12, 14, 100), True, (True, True, True, False)),    # all ok: median 13, 100 dropped
    ((10, 12, 100, 9), False, (True, True, True, False)),    # one row not ok: 80, 100 kept
], ids=["all rows ok, even N", "a row not ok"])
def test_median_gate_both_branches(dists, valid_last, kept):
    img_l, img_r, fl, fr, = small_frame(dists, valid_last)
    assert np.array_equal(np.asarray(jham.hamming_pairwise(fl.desc, fr.desc)).diagonal(), dists)
    ref = jax_stereo(fl, fr, jnp.asarray(img_l), jnp.asarray(img_r), CAM, jpyr.level_scales(4, 1.2))
    got = twin(fl, fr, img_l, img_r, ref[5])
    assert_stereo(got, ref)
    np.testing.assert_array_equal(got[4], kept)


def test_median_gate_at_80_drops_rows_above_168():
    """With a row not accepted the median is NaN, then 80: accepted rows above
    2.1 x 80 = 168 go, which only a threshold above 169 lets through."""
    ok = np.array([True, True, True, True, False])
    bestd = np.array([10, 168, 169, 300, 2048], np.int32)
    med = jnp.nan_to_num(jnp.median(jnp.where(ok, bestd, jnp.nan).astype(jnp.float32)), nan=80.0)
    ref = np.asarray(jnp.asarray(ok) & (jnp.asarray(bestd).astype(jnp.float32) <= 2.1 * med))
    got = k9.median_gate(torch.from_numpy(ok), torch.from_numpy(bestd)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, [True, True, False, False, False])


def test_system_matches_jax_system():
    """tests/test_e2e_stereo.py:33-46: PlaneScene seed 5, 24 frames, a 0.3 m
    baseline, loop closing off; uint8 pairs."""
    b, n_frames = 0.3, 24
    args = dict(ARGS, bf=250.0 * b)
    cam, tcam = CameraModel.create(**args), TCam.create(**args)
    scene = jsyn.PlaneScene(seed=5)
    poses = jsyn.orbit_trajectory(n_frames, step=0.05)
    sizes = dict(sensor="stereo", n_features=512, n_levels=4, max_kf=64, max_mp=8192,
                 max_frames_between_kf=6, th_depth=100.0, enable_loop_closing=False)
    ref = System(cam, SlamConfig(**sizes))
    port = TSystem(tcam, TSlamConfig(**sizes), device="cpu")
    u8 = lambda im: np.clip(im, 0, 255).astype(np.uint8)
    live = {"ref": {}, "port": {}}
    for k, (R, t) in enumerate(poses):
        il = u8(scene.render(cam, R, t, h=240, w=320)[0])
        ir = u8(scene.render(cam, R, np.asarray(t, np.float32) - np.array([b, 0, 0], np.float32),
                             h=240, w=320)[0])
        for name, slam in (("ref", ref), ("port", port)):
            T = slam.track_stereo(il, ir, k / 30.0)
            if T is not None:
                live[name][k] = np.asarray(T)
    assert ref.state == "OK" and port.state == "OK"

    def outcome(poses_live):
        est = np.stack([-T[:3, :3].T @ T[:3, 3] for T in poses_live.values()]).astype(np.float64)
        gt = np.stack([-poses[k][0].T @ poses[k][1] for k in poses_live]).astype(np.float64)
        path = lambda c: float(np.linalg.norm(np.diff(c, axis=0), axis=1).sum())
        return jeval.ate_rmse(est, gt, with_scale=False)[0], path(est) / path(gt)

    ate_j, _ = outcome(live["ref"])
    ate_t, path_ratio = outcome(live["port"])
    assert len(live["port"]) >= 0.8 * n_frames, (len(live["port"]), len(live["ref"]))
    assert abs(port.n_keyframes - ref.n_keyframes) <= 2, (port.n_keyframes, ref.n_keyframes)
    assert port.n_mappoints > 200
    assert ate_t <= max(1.5 * ate_j, ate_j + 0.01) and ate_t < 0.12, (ate_t, ate_j)
    assert abs(path_ratio - 1.0) < 0.15, path_ratio


def band_case(name):
    """(xy_l, oct_l, xy_r, oct_r, H) for kernel 9's band test: 512 x 512
    keypoints at 8 levels, the right ones near the left rows."""
    rng = np.random.RandomState(11)
    n, H = 512, 480
    xy_l = np.stack([rng.uniform(0, 640, n), rng.uniform(0, H, n)], 1)
    oct_l = rng.randint(0, 8, n)
    xy_r = xy_l + np.stack([-rng.uniform(0, 40, n), rng.uniform(-12, 12, n)], 1)
    oct_r = rng.randint(0, 8, n)
    if name == "rows exactly a tolerance apart":
        tol = 2.0 * np.asarray(tpyr.level_scales(8, 1.2).numpy(), np.float32)[oct_r]
        xy_r[:, 1] = np.float32(xy_l[:, 1]) + np.where(rng.rand(n) < 0.5, tol, -tol)
    elif name == "the top octave":
        oct_l[:] = 7
        oct_r[:] = rng.randint(6, 8, n)
    elif name == "rows at 0, H - 1 and outside the image":
        edge = np.array([0.0, H - 1.0, -0.5, -7.9, H - 0.01, H + 3.5, -1e30, 1e30, np.inf, -np.inf])
        xy_l[:, 1] = edge[rng.randint(0, len(edge), n)]
        xy_r[:, 1] = xy_l[:, 1] + rng.uniform(-8, 8, n)
    elif name == "a tall image: bands of more than 4 rows":
        H = 20000
        xy_l[:, 1] = rng.uniform(0, H, n)
        xy_r[:, 1] = xy_l[:, 1] + rng.uniform(-8, 8, n)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    i = lambda a: torch.from_numpy(np.asarray(a, np.int32))
    return f(xy_l), i(oct_l), f(xy_r), i(oct_r), H


@pytest.mark.parametrize("name", ["random", "rows exactly a tolerance apart", "the top octave",
                                  "rows at 0, H - 1 and outside the image",
                                  "a tall image: bands of more than 4 rows"])
def test_stereo_bands_hold_every_candidate(name):
    """Kernel 9 gates a left row only against the right keypoints in the
    bands within R of its own: every candidate of the twin's gate must lie
    there (the band arithmetic is kernels/stereo.py stereo_bands, the
    kernel's integer arithmetic in torch)."""
    xy_l, oct_l, xy_r, oct_r, H = band_case(name)
    scales = tpyr.level_scales(8, 1.2)
    ones = lambda n: torch.ones(n, dtype=torch.bool)
    cand = k9.stereo_candidates(xy_l, oct_l, ones(len(xy_l)), xy_r, oct_r, ones(len(xy_r)),
                                scales, 500.0)
    b_l, b_r, R = k9.stereo_bands(xy_l[:, 1], xy_r[:, 1], scales, H)
    visited = (b_l[:, None] - b_r[None, :]).abs() <= R
    assert int(cand.sum()) > 100
    assert not bool((cand & ~visited).any())
    if H == 480 and not name.startswith("rows at"):
        assert R == 2 and float(visited.float().mean()) < 0.1     # bands of 4 rows, 5 visited
    if name.startswith("rows exactly"):
        dy = (xy_l[:, 1, None] - xy_r[None, :, 1]).abs()
        tol = 2.0 * scales[oct_r.long()]
        assert int((cand & (dy == tol[None, :])).sum()) > 10      # candidates right at the edge


def test_stereo_bands_radius_edges():
    """R from the largest tolerance: NaN ignored, at least 0, every band at
    1e9 or more."""
    y = torch.zeros(3)
    assert k9.stereo_bands(y, y, torch.tensor([1.0, 1.2]), 480)[2] == 1     # floor(2.4) + 1 = 3
    assert k9.stereo_bands(y, y, torch.tensor([1.0, 2.0]), 480)[2] == 2     # 4 + 1 = 5 rows
    assert k9.stereo_bands(y, y, torch.tensor([float("nan"), -3.0]), 480)[2] == 1
    assert k9.stereo_bands(y, y, torch.tensor([float("inf")]), 480)[2] == 120
    assert k9.stereo_bands(y, y, torch.tensor([1.0]), 8192)[2] == 1         # bands of 8 rows
    b = k9.stereo_bands(torch.tensor([0.0, 3.99, 4.0, 479.9, 480.0, -0.1, float("nan")]), y,
                        torch.tensor([1.0]), 480)[0]
    assert b.tolist() == [0, 0, 1, 119, 119, 0, 0]


def stereo_inputs(n=8, m=6, h=12, w=16, dev="cpu"):
    z = lambda *s, dtype=torch.float32: torch.zeros(s, dtype=dtype, device=dev)
    return [z(n, 2), z(n, dtype=torch.int32), z(n, dtype=torch.bool), z(n, 16, dtype=torch.int32),
            z(m, 2), z(m, dtype=torch.int32), z(m, dtype=torch.bool), z(m, 16, dtype=torch.int32),
            z(n), z(h, w), z(h, w), z(4)]


def misaligned(t, by):
    """t's values in a buffer that starts `by` elements past an aligned one."""
    buf = torch.zeros(t.numel() + by, dtype=t.dtype)
    return buf[by:].view(t.shape)


STEREO_BAD = {
    "dtype": (3, lambda t: t.to(torch.int64), TypeError),
    "shape": (8, lambda t: t[:-1], ValueError),
    "non-contiguous": (0, lambda t: torch.zeros(2, t.shape[0])[0:1].expand(2, -1).t(), ValueError),
    "wrong device": (10, lambda t: t.to("meta"), ValueError),
    "misaligned descriptors": (7, lambda t: misaligned(t, 1), ValueError),
    "misaligned xy_r": (4, lambda t: misaligned(t, 1), ValueError),
    "no right keypoint": (None, None, ValueError),
}


@pytest.mark.parametrize("bad", list(STEREO_BAD))
def test_stereo_check_inputs_raises(bad):
    """Each bad input to kernel 9's fused checks raises, on CPU tensors."""
    k, edit, err = STEREO_BAD[bad]
    args = stereo_inputs(m=0) if k is None else stereo_inputs()
    dev = torch.device("cpu")
    assert k9.check_inputs(*stereo_inputs(), 159, dev)[:5] == (8, 6, 12, 16, 4)
    if k is not None:
        args[k] = edit(args[k])
        if bad == "non-contiguous":
            assert args[k].shape == (8, 2) and not args[k].is_contiguous()
    with pytest.raises(err):
        k9.check_inputs(*args, 159, dev)


def test_stereo_check_inputs_holds_right_keypoints_to_shared_memory():
    """Kernel 9 stages 24 B a right keypoint beside its fixed shared memory:
    check_inputs takes max_right_keypoints(H, L) of them and refuses one
    more, on CPU tensors (8999 at VGA and 8 levels)."""
    dev = torch.device("cpu")
    m = k9.max_right_keypoints(12, 4)
    assert k9.FIXED_SMEM == 15936 and k9.max_right_keypoints(480, 8) == 8999
    rest = k9.FIXED_SMEM + 4 * (3 + 1) + 4 * 4      # 3 bands of 4 rows, 4 levels
    assert 24 * m + rest <= k9.SMEM_PER_CTA < 24 * (m + 1) + rest
    assert k9.check_inputs(*stereo_inputs(m=m), 159, dev)[1] == m
    with pytest.raises(ValueError, match="max_right_keypoints"):
        k9.check_inputs(*stereo_inputs(m=m + 1), 159, dev)
