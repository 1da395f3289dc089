"""Parity of the port's Hamming distance, masked matcher, the four searches
and the rotation-histogram check with the JAX package.  All outputs are
integers or masks and must be exactly equal.  The gated matcher's plain twin
is held to JAX's ``match_masked`` on masks that JAX's own ``window_mask`` /
``octave_mask`` / ``search_for_triangulation`` build, one problem at a time,
while the port runs the problems batched."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_annotate_tpu.geometry import CameraModel
from orb_slam2_annotate_tpu.io import synthetic
from orb_slam2_annotate_tpu.ops import extractor as jext
from orb_slam2_annotate_tpu.ops import hamming as jham
from orb_slam2_annotate_tpu.ops import matching as jm
from orb_slam2_annotate_tpu.pipeline import local_mapping as jlm
from orb_slam2_annotate_tpu_torch.geometry.camera import CameraModel as TCam
from orb_slam2_annotate_tpu_torch.kernels import hamming as tk3
from orb_slam2_annotate_tpu_torch.ops import hamming as tham
from orb_slam2_annotate_tpu_torch.ops import matching as tm
from orb_slam2_annotate_tpu_torch.pipeline import local_mapping as tlm
from orb_slam2_annotate_tpu_torch.pipeline import tracking as ttk

RNG = np.random.RandomState(3)
CAM = CameraModel.create(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)


def T(a):
    a = np.array(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def eq(a_torch, b_jax):
    b = np.asarray(b_jax)
    np.testing.assert_array_equal(a_torch.numpy(), b.view(np.int32) if b.dtype == np.uint32 else b)


def planted_descriptors(n1=96, n2=64):
    """desc1 rows are noisy copies of desc2 rows, with duplicate columns
    (ties in the row argmin) and duplicate rows (two rows claiming one column)."""
    d2 = RNG.randint(0, 2**32, size=(n2, 16), dtype=np.uint64).astype(np.uint32)
    d2[5] = d2[4]                       # tie between columns 4 and 5
    d2[9] = d2[8]
    src = RNG.randint(0, n2, n1)
    d1 = d2[src].copy()
    flips = RNG.rand(n1, 16, 32) < 0.15
    d1 ^= (flips * (1 << np.arange(32, dtype=np.uint64))).sum(-1).astype(np.uint32)
    d1[1] = d1[0]                        # duplicate rows: same best column
    d1[2] = d2[4]                        # exact tie between columns 4 and 5
    d1[3] = d2[8]
    return d1, d2


def test_hamming_pairwise_and_bit_order():
    d1, d2 = planted_descriptors()
    eq(tham.hamming_pairwise(T(d1), T(d2)), jham.hamming_pairwise(jnp.asarray(d1), jnp.asarray(d2)))
    # the distinctive descriptor of two points observed in the 32 rows of
    # d1[:32] and the 17 rows of d2[:17]: least median of JAX's distances
    kf_desc = np.stack([d1[:32], d2[:32]])
    obs_kf = np.repeat(np.arange(2, dtype=np.int32)[:, None], 32, 1)
    obs_ft = np.tile(np.arange(32, dtype=np.int32), (2, 1))
    cnt = np.array([32, 17], np.int32)
    desc, best = tk3.distinctive_descriptors(T(kf_desc), T(obs_kf), T(obs_ft), T(cnt))
    for q, c in enumerate(cnt):
        rows = jnp.asarray(kf_desc[q, :c])
        med = np.sort(np.asarray(jham.hamming_pairwise(rows, rows)), 1)[:, (c - 1) // 2]
        assert int(best[q]) == int(np.argmin(med))
        eq(desc[q], kf_desc[q, np.argmin(med)])
    words = np.zeros((6, 16), np.uint32)
    words[:, 15] = [0, 1, 0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0xAAAAAAAA]
    zero = np.zeros((1, 16), np.uint32)
    eq(tham.hamming_pairwise(T(words), T(zero))[:, 0], [0, 1, 1, 32, 31, 16])


@pytest.mark.parametrize("mutual", [False, True])
@pytest.mark.parametrize("max_dist,ratio", [(jm.TH_LOW, 1.0), (jm.TH_HIGH, 0.9), (512, 0.7)])
def test_match_masked(mutual, max_dist, ratio):
    d1, d2 = planted_descriptors()
    mask = RNG.rand(96, 64) < 0.7
    mask[0:4] = True
    mask[10] = False                     # a row with no candidate
    ref = jm.match_masked(jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(mask), max_dist, ratio, mutual)
    got = tm.match_masked(T(d1), T(d2), T(mask), max_dist, ratio, mutual)
    eq(got.idx, ref.idx)
    eq(got.dist, ref.dist)


def test_rotation_consistency():
    a1 = RNG.uniform(-np.pi, np.pi, 300).astype(np.float32)
    offs = np.where(RNG.rand(300) < 0.6, 0.4, np.where(RNG.rand(300) < 0.5, -1.0, 2.0))
    a2 = (a1 + offs + RNG.randn(300) * 0.02).astype(np.float32)
    matched = RNG.rand(300) < 0.8
    ref = jm.rotation_consistency(jnp.asarray(a1), jnp.asarray(a2), jnp.asarray(matched))
    eq(tm.rotation_consistency(T(a1), T(a2), T(matched)), ref)


def _frames():
    poses = synthetic.orbit_trajectory(4, step=0.06)
    scene = synthetic.PlaneScene(seed=1)
    cfg = jext.ExtractorConfig(n_features=512, n_levels=4)
    out = []
    for k in (0, 3):
        img, _ = scene.render(CAM, *poses[k], h=240, w=320)
        out.append(jext.extract(jnp.asarray(img), cfg))
    return out, poses


@pytest.fixture(scope="module")
def two_frames():
    (fa, fb), poses = _frames()

    def torch_frame(f):
        return tlm.Frame(xy=T(f.xy), xy_raw=T(f.xy), ur=torch.full((512,), -1.0),
                         depth=torch.zeros(512), octave=T(f.octave), angle=T(f.angle),
                         response=T(f.response), desc=T(f.desc), valid=T(f.valid))

    return fa, fb, torch_frame(fa), torch_frame(fb), poses


def test_search_for_initialization(two_frames):
    fa, fb, ta, tb, _ = two_frames
    ref = jm.search_for_initialization(fa, fb, window=100.0)
    got = tm.search_for_initialization(ta, tb, window=100.0)
    assert int(np.sum(np.asarray(ref.idx) >= 0)) > 20
    eq(got.idx, ref.idx)
    eq(got.dist, ref.dist)


def test_search_frame_to_frame_and_map_points(two_frames):
    fa, fb, ta, tb, _ = two_frames
    proj = (np.asarray(fa.xy) + [-4.0, 0.5]).astype(np.float32)
    pvalid = np.asarray(fa.valid) & (RNG.rand(512) < 0.9)
    radius = (15.0 * 1.2 ** np.asarray(fa.octave)).astype(np.float32)
    ref = jm.search_frame_to_frame(fb, fa, jnp.asarray(proj), jnp.asarray(pvalid), fa.octave,
                                   jnp.asarray(radius))
    got = tm.search_frame_to_frame(tb, ta, T(proj), T(pvalid), ta.octave, T(radius))
    assert int(np.sum(np.asarray(ref.idx) >= 0)) > 20
    eq(got.idx, ref.idx)
    eq(got.dist, ref.dist)
    ref = jm.search_map_points(fa.desc, jnp.asarray(pvalid), jnp.asarray(proj), fa.octave,
                               jnp.asarray(radius / 3), fb, ratio=0.8, max_dist=jm.TH_HIGH)
    got = tm.search_map_points(ta.desc, T(pvalid), T(proj), ta.octave, T(radius / 3), tb,
                               ratio=0.8, max_dist=tm.TH_HIGH)
    eq(got.idx, ref.idx)
    eq(got.dist, ref.dist)


def test_search_for_triangulation(two_frames):
    fa, fb, ta, tb, poses = two_frames
    (R1, t1), (R2, t2) = poses[0], poses[3]
    F12 = np.asarray(jlm._fundamental_between(CAM, jnp.asarray(R1), jnp.asarray(t1),
                                              jnp.asarray(R2), jnp.asarray(t2)))
    tcam = TCam.create(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
    F12_t = tlm._fundamental_between(tcam, T(R1), T(t1), T(R2), T(t2))
    np.testing.assert_allclose(F12_t.numpy(), F12, rtol=1e-4, atol=1e-9)
    inv_s2 = np.asarray(jlm._inv_sigma2(jnp.arange(8)))
    np.testing.assert_array_equal(ttk.inv_sigma2(torch.arange(8)).numpy(), inv_s2)
    ex1 = RNG.rand(512) < 0.2
    ex2 = RNG.rand(512) < 0.2
    ref = jm.search_for_triangulation(fa, fb, jnp.asarray(F12), jnp.asarray(inv_s2),
                                      jnp.asarray(inv_s2), jnp.asarray(ex1), jnp.asarray(ex2))
    got = tm.search_for_triangulation(ta, tb, T(F12), T(inv_s2), T(inv_s2), T(ex1), T(ex2))
    assert int(np.sum(np.asarray(ref.idx) >= 0)) > 10
    eq(got.idx, ref.idx)
    eq(got.dist, ref.dist)


def _gate_case(kind, n_batch=3):
    """B problems sharing desc2 (as relocalization shares the frame's
    descriptors): per problem a planted desc1, row validity, projections,
    radii and predicted octaves.  Returns the port's arguments and, per
    problem, the JAX candidate mask."""
    d1s, rvs, pxys, rads, poks = [], [], [], [], []
    d1, d2 = planted_descriptors()
    rng = np.random.RandomState(11)
    xy2 = rng.uniform(0, 200, (64, 2)).astype(np.float32)
    oct2 = rng.randint(0, 4, 64).astype(np.int32)
    cv = rng.rand(64) < 0.9
    cv[[4, 5, 8, 9]] = True                 # keep the tied columns
    true_col = np.asarray(jham.hamming_pairwise(jnp.asarray(d1), jnp.asarray(d2))).argmin(1)
    for b in range(n_batch):
        rows = np.roll(np.arange(96), 7 * b)
        rows[:4] = [0, 1, 2, 3]             # the duplicate / tie rows in every problem
        d1s.append(d1[rows])
        rv = rng.rand(96) < 0.85
        rv[:4] = True
        rv[10] = False                      # a row with no candidate
        rvs.append(rv)
        pxys.append((xy2[true_col[rows]] + rng.randn(96, 2) * 20).astype(np.float32))
        r = rng.uniform(5, 60, 96).astype(np.float32)
        r[:4] = 1000.0
        rads.append(r)
        po = np.clip(oct2[true_col[rows]] + rng.randint(-1, 2, 96), 0, 3).astype(np.int32)
        po[:4] = oct2[4]
        poks.append(po)
    d1b, rvb, pxyb, radb, pob = map(np.stack, (d1s, rvs, pxys, rads, poks))
    masks = []
    for b in range(n_batch):
        m = np.asarray(jnp.asarray(rvb[b])[:, None] & jnp.asarray(cv)[None, :])
        if kind.startswith("window"):
            m = m & np.asarray(jm.window_mask(jnp.asarray(pxyb[b]), jnp.asarray(xy2),
                                              jnp.asarray(radb[b])))
        if kind == "window_octave":
            m = m & np.asarray(jm.octave_mask(jnp.asarray(pob[b]), jnp.asarray(oct2), -1, 1))
        if kind == "mask":
            m = m & (rng.rand(96, 64) < 0.7)
        masks.append(m)
    if kind == "none":
        gate = None
    elif kind == "mask":
        gate = tk3.MaskGate(T(np.stack(masks)))
    else:
        gate = tk3.WindowGate(T(pxyb), T(radb), T(xy2), *((T(pob), T(oct2), -1, 1)
                                                          if kind == "window_octave" else ()))
    return (T(d1b), T(d2), T(rvb), T(cv), gate), (d1b, d2, masks)


@pytest.mark.parametrize("mutual", [False, True])
@pytest.mark.parametrize("kind", ["none", "window", "window_octave", "mask"])
def test_gated_batched_match_vs_jax(kind, mutual):
    (d1, d2, rv, cv, gate), (d1b, d2n, masks) = _gate_case(kind)
    got = tm.match_gated(d1, d2, rv, cv, jm.TH_HIGH, 0.9, mutual, gate)
    assert got.idx.shape == (3, 96)
    for b, m in enumerate(masks):
        ref = jm.match_masked(jnp.asarray(d1b[b]), jnp.asarray(d2n), jnp.asarray(m), jm.TH_HIGH,
                              0.9, mutual)
        assert int(np.sum(np.asarray(ref.idx) >= 0)) > 5
        eq(got.idx[b], ref.idx)
        eq(got.dist[b], ref.dist)


def test_rotation_consistency_batched_equals_per_row():
    a1 = RNG.uniform(-np.pi, np.pi, (5, 200)).astype(np.float32)
    offs = np.where(RNG.rand(5, 200) < 0.6, 0.4, np.where(RNG.rand(5, 200) < 0.5, -1.0, 2.0))
    a2 = (a1 + offs * RNG.rand(5, 1) + RNG.randn(5, 200) * 0.02).astype(np.float32)
    matched = RNG.rand(5, 200) < 0.8
    got = tm.rotation_consistency(T(a1), T(a2), T(matched))
    for b in range(5):
        row = tm.rotation_consistency(T(a1[b]), T(a2[b]), T(matched[b]))
        assert torch.equal(got[b], row)
        eq(row, jm.rotation_consistency(jnp.asarray(a1[b]), jnp.asarray(a2[b]),
                                        jnp.asarray(matched[b])))


def test_search_for_triangulation_batched(two_frames):
    """Three neighbours in one call (F12 and exclude2 per problem, the new
    keyframe's arrays shared) against JAX's search, one neighbour at a time."""
    fa, fb, ta, tb, poses = two_frames
    inv_s2 = np.asarray(jlm._inv_sigma2(jnp.arange(8)))
    ex1 = RNG.rand(512) < 0.2
    ex2 = RNG.rand(3, 512) < 0.2
    F12 = np.stack([np.asarray(jlm._fundamental_between(
        CAM, jnp.asarray(poses[0][0]), jnp.asarray(poses[0][1]), jnp.asarray(poses[k][0]),
        jnp.asarray(poses[k][1]))) for k in (3, 2, 1)])
    tb3 = tlm.Frame(**{f: (v.expand(3, *v.shape).contiguous() if f != "response" else v)
                       for f, v in vars(tb).items()})
    got = tm.search_for_triangulation(ta, tb3, T(F12), T(inv_s2), T(inv_s2), T(ex1), T(ex2))
    assert got.idx.shape == (3, 512)
    for b in range(3):
        ref = jm.search_for_triangulation(fa, fb, jnp.asarray(F12[b]), jnp.asarray(inv_s2),
                                          jnp.asarray(inv_s2), jnp.asarray(ex1),
                                          jnp.asarray(ex2[b]))
        assert int(np.sum(np.asarray(ref.idx) >= 0)) > 10
        eq(got.idx[b], ref.idx)
        eq(got.dist[b], ref.dist)
